"""The port's BERT (``bagua_tpu_torch.models.bert``) against the JAX package.

Parameters come from flax's init and cross with ``params_from_jax``; ids,
masks and labels are made with numpy.  A small BERT (2 layers, hidden 32, 4
heads, FFN 64, vocab 100, 16 positions).

Tolerances, each with its reason:

- LayerNorm within 1e-6 (f32 statistics summed in another order).
- f32: MLM logits and the QA model's within 1e-5, the loss within rtol
  1e-6, every gradient within 1e-5 of its leaf's largest JAX value (f32
  matmuls summed in another order, through two layers).
- bf16 compute: the tensor-parallel layers' parameters and products are
  bf16 in both packages, and JAX's GELU rounds each of its bf16 operations
  where torch's rounds once; logits within 4 bf16 rounding steps (4 x 2^-8)
  of their largest value, the loss within rtol 1e-3, every gradient within
  2^-5 of its leaf's largest JAX value (each of the two layers' roundings
  moves a gradient by about 2^-8 of its scale) plus 1e-6 (the key
  projection's bias has a gradient of zero in exact arithmetic, softmax
  ignoring a shift common to every key, and holds rounding noise of about
  1e-8 in both packages).
- The sequence-parallel and tensor-parallel runs (ring attention, the tp
  collectives) against the single-device port within 1e-5, the gradients
  within 1e-5 of their leaf's largest value (blockwise online softmax
  against the one-block softmax, f32).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bagua_tpu.models import bert as jb

from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.models import bert as tb
from bagua_tpu_torch.utils import tree_flatten_with_names, tree_leaves, tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
             max_position_embeddings=16)
B, T = 4, 16
BF16_STEP = 2.0 ** -8
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def jax_squad():
    spec = importlib.util.spec_from_file_location("jax_squad_example",
                                                  os.path.join(REPO, "examples", "squad", "main.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def flax_params(model, *args):
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0), *args)["params"])


def mlm_batch(seed=0, vocab=100):
    rng = np.random.RandomState(seed)
    return rng.randint(0, vocab, (B, T)).astype(np.int32), rng.randint(0, vocab, (B, T)).astype(np.int32)


def padding_mask(seed, b, t, low):
    """Key-padding masks with lengths drawn in ``[low, t]``."""
    lengths = np.random.RandomState(seed).randint(low, t + 1, b)
    return np.arange(t)[None, :] < lengths[:, None]


def leaf_grads(loss_fn, params, batch):
    leaves = tree_map(lambda t: t.clone().requires_grad_(), params)
    loss = loss_fn(leaves, batch)
    loss.backward()
    return float(loss.detach()), [t.grad for t in tree_leaves(leaves)]


def test_layer_norm_matches_flax():
    import flax.linen as nn

    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 24) * 4 + 2).astype(np.float32)
    scale, bias = rng.randn(24).astype(np.float32), rng.randn(24).astype(np.float32)
    ln = nn.LayerNorm(epsilon=1e-12)
    for xin in (jnp.asarray(x), jnp.asarray(x).astype(jnp.bfloat16)):
        want = ln.apply({"params": {"scale": scale, "bias": bias}}, xin)
        tin = torch.from_numpy(np.array(xin.astype(jnp.float32))).to(
            torch.bfloat16 if xin.dtype == jnp.bfloat16 else torch.float32)
        got = tb.LayerNorm(24, 1e-12, "cpu")({"scale": torch.from_numpy(scale)[None],
                                              "bias": torch.from_numpy(bias)[None]}, tin[None])[0]
        assert got.dtype == torch.float32 and want.dtype == jnp.float32  # bf16 in, f32 out
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_configs_and_parameter_tree():
    big = tb.bert_large_config()
    assert (big.vocab_size, big.hidden_size, big.num_layers, big.num_heads, big.intermediate_size,
            big.max_position_embeddings, big.layer_norm_eps) == (30522, 1024, 24, 16, 4096, 512, 1e-12)
    base = tb.bert_base_config()
    assert (base.hidden_size, base.num_layers, base.num_heads, base.intermediate_size) == (768, 12, 12, 3072)
    with pytest.raises(ValueError, match="divide by num_heads"):
        tb.BertConfig(hidden_size=30, num_heads=4)
    # flax's names, shapes and types, at both compute types
    for jdt, tdt in DTYPES.values():
        jp = params_from_jax(flax_params(jb.BertForPreTraining(jb.BertConfig(**SMALL, compute_dtype=jdt)),
                                         jnp.zeros((2, T), jnp.int32)))
        _, tp = tb.init_bert(tb.BertConfig(**SMALL, compute_dtype=tdt), torch.Generator().manual_seed(0), "cpu")
        assert [(n, t.shape, t.dtype) for n, t in tree_flatten_with_names(tp)] == \
            [(n, t.shape, t.dtype) for n, t in tree_flatten_with_names(jp)]
    # token-type embeddings exist only when asked for, as flax makes them
    ids = jnp.zeros((2, T), jnp.int32)
    jp = params_from_jax(flax_params(jb.BertModel(jb.BertConfig(**SMALL)), ids, ids))
    tm = tb.BertModel(tb.BertConfig(**SMALL), device="cpu", token_types=True)
    assert sorted(n for n, _ in tm.named_parameters() if "token_type" in n) == \
        ["token_type_embeddings.embedding"]
    assert [n for n, _ in tree_flatten_with_names(jp)] == \
        [n for n, _ in tree_flatten_with_names(tb.module_params(tm))]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_pretraining_forward_and_grads_match_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    jmodel = jb.BertForPreTraining(jb.BertConfig(**SMALL, compute_dtype=jdt))
    jp = flax_params(jmodel, jnp.zeros((2, T), jnp.int32))
    model = tb.BertForPreTraining(tb.BertConfig(**SMALL, compute_dtype=tdt), device="cpu")
    tp = params_from_jax(jp)
    ids, labels = mlm_batch()
    want = np.asarray(jmodel.apply({"params": jp}, jnp.asarray(ids)))
    got = model(tb.one_rank(tp), torch.from_numpy(ids)[None])[0].detach()
    assert got.dtype == torch.float32
    tol = 1e-5 if dtype == "f32" else 4 * BF16_STEP * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)

    jloss, jgrads = jax.value_and_grad(jb.mlm_loss_fn(jmodel))(jp, (jnp.asarray(ids), jnp.asarray(labels)))
    loss, grads = leaf_grads(tb.mlm_loss_fn(model), tp, (torch.from_numpy(ids), torch.from_numpy(labels)))
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-6 if dtype == "f32" else 1e-3)
    for (name, _), g, w in zip(tree_flatten_with_names(tp), grads, jax.tree.leaves(jgrads)):
        w = np.asarray(w, np.float32)
        assert g.dtype == tp_dtype(tp, name)
        scale = np.abs(w).max()
        bound = 1e-5 * max(scale, 1.0) if dtype == "f32" else 2.0 ** -5 * scale + 1e-6
        assert np.abs(g.float().numpy() - w).max() <= bound, name


def tp_dtype(tree, name):
    return dict(tree_flatten_with_names(tree))[name].dtype


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_question_answering_forward_and_grads_match_jax(dtype):
    from bagua_tpu_torch.examples import squad as tsq

    jsq = jax_squad()
    jdt, tdt = DTYPES[dtype]
    jmodel = jsq.BertForQuestionAnswering(jb.BertConfig(**SMALL, compute_dtype=jdt))
    jp = flax_params(jmodel, jnp.zeros((2, T), jnp.int32))
    model = tsq.BertForQuestionAnswering(tb.BertConfig(**SMALL, compute_dtype=tdt), device="cpu")
    tp = params_from_jax(jp)
    batch = jsq.synthetic_squad(np.random.RandomState(0), B, T, SMALL["vocab_size"])
    ws, we = jmodel.apply({"params": jp}, jnp.asarray(batch[0]), attention_mask=jnp.asarray(batch[1]))
    gs, ge = model(tb.one_rank(tp), torch.from_numpy(batch[0])[None],
                   attention_mask=torch.from_numpy(batch[1])[None])
    for g, w in ((gs, ws), (ge, we)):
        w = np.asarray(w)
        tol = 1e-5 if dtype == "f32" else 4 * BF16_STEP * np.abs(w).max()
        np.testing.assert_allclose(g[0].detach().numpy(), w, rtol=0, atol=tol)
    jloss, jgrads = jax.value_and_grad(jsq.qa_loss_fn(jmodel))(jp, tuple(map(jnp.asarray, batch)))
    loss, grads = leaf_grads(tsq.qa_loss_fn(model), tp, tuple(map(torch.from_numpy, batch)))
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-6 if dtype == "f32" else 1e-3)
    for (name, _), g, w in zip(tree_flatten_with_names(tp), grads, jax.tree.leaves(jgrads)):
        w = np.asarray(w, np.float32)
        scale = np.abs(w).max()
        bound = 1e-5 * max(scale, 1.0) if dtype == "f32" else 2.0 ** -5 * scale + 1e-6
        assert np.abs(g.float().numpy() - w).max() <= bound, name


def test_loss_under_vmap_equals_the_stacked_model():
    """The engine's form (one rank's loss under ``vmap``, a rank axis of one
    added inside) against the stacked model called on all ranks at once:
    ranks with different parameters and batches, bitwise."""
    cfg = tb.BertConfig(**SMALL)
    gen = torch.Generator().manual_seed(1)
    model = tb.BertForPreTraining(cfg, device="cpu", generator=gen)
    stacked = tree_map(lambda p: torch.stack([p, p + 0.01 * torch.randn(p.shape, generator=gen)]),
                       tb.module_params(model))
    ids, labels = (torch.from_numpy(a).reshape(2, 2, T) for a in mlm_batch(3))
    got = torch.func.vmap(tb.mlm_loss_fn(model))(stacked, (ids, labels))
    logp = torch.log_softmax(model(stacked, ids), dim=-1)
    want = -torch.gather(logp, -1, labels[..., None].long()).mean(dim=(1, 2, 3))
    assert torch.equal(got, want)


def _shard_for_tp(params, r, tp, heads, hidden):
    """tp rank r's slice of every tensor-parallel leaf (heads contiguous),
    as ``tests/test_parallel.py`` slices the flax tree."""
    hd = hidden // heads

    def slice_leaf(name, arr):
        if "['qkv']" in name:
            if name.endswith("['kernel']"):
                k3 = arr.reshape(arr.shape[0], 3, heads, hd)
                return k3[:, :, r * (heads // tp):(r + 1) * (heads // tp)].reshape(arr.shape[0], -1)
            return arr.reshape(3, heads, hd)[:, r * (heads // tp):(r + 1) * (heads // tp)].reshape(-1)
        if "['out']['kernel']" in name or ("RowParallelDense_0" in name and name.endswith("['kernel']")):
            rows = arr.shape[0] // tp
            return arr[r * rows:(r + 1) * rows]
        if "ColumnParallelDense_0" in name:
            cols = arr.shape[-1] // tp
            return arr[..., r * cols:(r + 1) * cols]
        return arr

    names = [n for n, _ in tree_flatten_with_names(params)]
    from bagua_tpu_torch.utils import tree_unflatten
    return tree_unflatten(params, [slice_leaf(n, a) for n, a in zip(names, tree_leaves(params))])


@pytest.mark.parametrize("tp, sp", [(2, 2), (1, 4)], ids=["tp2-sp2", "sp4"])
def test_parallel_consistency_with_padding(tp, sp):
    """tp x sp over a 4-rank group (tp = inter, sp = intra; the JAX
    package's ``test_bert_forward_shapes_and_parallel_consistency`` at 2 x
    2) against the single-device model with the assembled weights, with a
    key-padding mask whose short rows leave whole blocks padded; forward
    and the gradient of every parameter, and the single-device model
    against JAX's."""
    cfg0 = jb.BertConfig(**SMALL)
    jmodel = jb.BertModel(cfg0)
    ids = np.random.RandomState(3).randint(0, SMALL["vocab_size"], (2, T)).astype(np.int32)
    mask = padding_mask(4, 2, T, low=T // sp)
    mask[0, T // sp:] = False  # sequence 0 keeps one block of keys only
    jp = flax_params(jmodel, jnp.asarray(ids))
    want = np.asarray(jmodel.apply({"params": jp}, jnp.asarray(ids), attention_mask=jnp.asarray(mask)))

    model0 = tb.BertModel(tb.BertConfig(**SMALL), device="cpu")
    p0 = tree_map(lambda t: t.clone().requires_grad_(), params_from_jax(jp))
    ref = model0(tb.one_rank(p0), torch.from_numpy(ids)[None], attention_mask=torch.from_numpy(mask)[None])[0]
    np.testing.assert_allclose(ref.detach().numpy(), want, rtol=0, atol=1e-5)
    cot = torch.from_numpy(np.random.RandomState(5).randn(*want.shape).astype(np.float32))
    (ref * cot).sum().backward()

    group = BaguaProcessGroup([torch.device("cpu")] * 4, intra_size=sp)
    cfg = tb.BertConfig(**SMALL, tp_size=tp, tp_axis="inter", sp_axis="intra")
    model = tb.BertModel(cfg, group, device="cpu")
    heads, hidden = SMALL["num_heads"], SMALL["hidden_size"]
    per_rank = [_shard_for_tp(jp, r // sp, tp, heads, hidden) for r in range(4)]
    stacked = tree_map(lambda *xs: torch.from_numpy(np.stack(xs)).requires_grad_(), *per_rank)
    t = T // sp
    block = lambda a: torch.from_numpy(np.stack([a[:, (r % sp) * t:(r % sp + 1) * t] for r in range(4)]))  # noqa: E731
    out = model(stacked, block(ids), attention_mask=block(mask))
    for r in range(4):
        s = r % sp
        np.testing.assert_allclose(out[r].detach().numpy(), ref[:, s * t:(s + 1) * t].detach().numpy(),
                                   rtol=0, atol=1e-5)
    # each tp rank's loss counts once: the tp replicas' outputs are summed
    # over the sp ranks of one tp index only
    (out * block(cot.numpy())).reshape(tp, sp, *out.shape[1:])[0].sum().backward()
    for (name, g0), leaf in zip(tree_flatten_with_names(p0), tree_leaves(stacked)):
        got = _assemble(name, leaf.grad, tp, sp, heads, hidden)
        want_g = g0.grad.numpy()
        np.testing.assert_allclose(got, want_g, rtol=0, atol=1e-5 * max(1.0, np.abs(want_g).max()),
                                   err_msg=name)


def _assemble(name, grad, tp, sp, heads, hidden):
    """The full-model gradient of a leaf from the stacked one: summed over
    the sp ranks, then the tp shards put back together, or, for a leaf every
    tp rank holds, summed over them too (each copy carries the gradient
    through its own shard of the heads and the MLP)."""
    g = grad.reshape(tp, sp, *grad.shape[1:]).sum(1).numpy()
    hd = hidden // heads
    if "['qkv']" in name:
        if name.endswith("['kernel']"):
            parts = [x.reshape(x.shape[0], 3, heads // tp, hd) for x in g]
            return np.concatenate(parts, axis=2).reshape(g.shape[1], -1)
        return np.concatenate([x.reshape(3, heads // tp, hd) for x in g], axis=1).reshape(-1)
    if "['out']['kernel']" in name or ("RowParallelDense_0" in name and name.endswith("['kernel']")):
        return np.concatenate(list(g), axis=0)
    if "ColumnParallelDense_0" in name:
        return np.concatenate(list(g), axis=-1)
    return g.sum(0)
