"""The port's GPT (``bagua_tpu_torch.models.gpt``) against the JAX package.

Parameters come from flax's init and cross with ``params_from_jax``; ids
are made with numpy.  The single-device cases use a small GPT (2 layers,
hidden 32, 4 heads, vocab 64, 16 positions); the sequence-parallel replays
are ``tests/test_models_trainer.py``'s (sp 4, 4 tokens a rank, vocab 32,
hidden 16, 4 heads), run on a ``[cpu] * 4`` group with sp on ``"intra"``
and against JAX's ``shard_map`` over 4 simulated devices.

Tolerances, each with its reason:

- f32: logits within 1e-5, the loss within rtol 1e-6, every gradient
  within 1e-5 of its leaf's largest JAX value (f32 matmuls summed in
  another order, through two layers).
- bf16 compute, the BERT tests' bound: the tensor-parallel layers'
  parameters and products are bf16 in both packages and JAX's GELU rounds
  each of its bf16 operations where torch's rounds once; logits within 4
  bf16 steps (4 x 2^-8) of their largest value, the loss within rtol 1e-3,
  every gradient within 2^-5 of its leaf's largest JAX value plus 1e-6 (the
  key projection's bias has a zero gradient in exact arithmetic).
- The sequence-parallel and tensor-parallel models against the port's
  local model and against JAX's within 1e-5 (blockwise online softmax
  against one softmax, f32), gradients within 1e-5 of their leaf's largest
  value; the JAX replays' own bound is 5e-3.
- The contiguous causal ring alone: the output within 1e-6 of JAX's (the
  same plain expressions, where JAX skips a block from a rank's future and
  the port merges it as an exact identity), the gradients within 3e-4 (the
  flash tests' bound: JAX's jnp path differentiates through the max shift,
  the port's backward holds it constant); rank 0 at sp 2, whose second
  block is wholly masked, equals the one-block result exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from bagua_tpu.models import gpt as jg
from bagua_tpu.parallel import ring_attention as jra

from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.examples.llama_pretrain import replicate
from bagua_tpu_torch.models import gpt as tg
from bagua_tpu_torch.parallel import ring_attention as tra
from bagua_tpu_torch.utils import tree_flatten_with_names, tree_leaves, tree_map

SMALL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, max_position_embeddings=16)
B, T = 2, 16
BF16_STEP = 2.0 ** -8
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
SP, T_LOCAL = 4, 4
REPLAY = dict(vocab_size=32, hidden_size=16, num_heads=4, num_layers=2, max_position_embeddings=SP * T_LOCAL)


def flax_params(model, ids):
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"])


def cpu_group(n, intra=None):
    return BaguaProcessGroup([torch.device("cpu")] * n, intra_size=intra or n)


def port_model(cfg, group=None):
    return tg.GPTModel(cfg, group, device="cpu")


def leaf_grads(loss_fn, params, ids):
    """Per-rank losses and each stacked leaf's gradient of their sum."""
    leaves = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    losses = loss_fn(leaves, ids)
    losses.sum().backward()
    return losses.detach(), [leaf.grad for leaf in tree_leaves(leaves)]


def ids_for(seed, vocab, shape):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(np.int32)


def test_params_tree_and_init_match_flax():
    """Names, shapes and dtypes as flax's tree (the tensor-parallel layers
    in the compute type), and flax's initializers in distribution."""
    kw = dict(SMALL, vocab_size=512, hidden_size=128)
    for jdt, tdt in DTYPES.values():
        want = flax_params(jg.GPTModel(jg.GPTConfig(**kw, compute_dtype=jdt)), np.zeros((1, 8), np.int32))
        _, got = tg.init_gpt(tg.GPTConfig(**kw, compute_dtype=tdt), torch.Generator().manual_seed(0), "cpu")
        names = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
        flat = tree_flatten_with_names(got)
        assert [n for n, _ in flat] == names
        for (name, g), w in zip(flat, jax.tree.leaves(want)):
            assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == w.dtype.name, name
            if name.endswith("['scale']"):
                assert torch.equal(g, torch.ones_like(g)), name
            elif name.endswith("['bias']"):
                assert not g.any(), name
            elif g.numel() > 1000:
                assert abs(float(g.float().std()) / float(np.std(w.astype(np.float32))) - 1) < 0.05, name


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_loss_and_grads_match_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    jmodel = jg.GPTModel(jg.GPTConfig(**SMALL, compute_dtype=jdt))
    ids = ids_for(0, SMALL["vocab_size"], (B, T))
    jp = flax_params(jmodel, ids)
    want = np.asarray(jmodel.apply({"params": jp}, jnp.asarray(ids)))
    model = port_model(tg.GPTConfig(**SMALL, compute_dtype=tdt))
    tp = replicate(params_from_jax(jp), 1)
    got = model(tp, torch.from_numpy(ids)[None])[0].detach()
    assert got.dtype == torch.float32 and got.shape == (B, T, SMALL["vocab_size"])
    tol = 1e-5 if dtype == "f32" else 4 * BF16_STEP * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)

    jloss, jgrads = jax.value_and_grad(jg.lm_loss_fn(jmodel))(jp, jnp.asarray(ids))
    loss, grads = leaf_grads(tg.lm_loss_fn(model), tp, torch.from_numpy(ids)[None])
    np.testing.assert_allclose(float(loss[0]), float(jloss), rtol=1e-6 if dtype == "f32" else 1e-3)
    for (name, leaf), g, w in zip(tree_flatten_with_names(tp), grads, jax.tree.leaves(jgrads)):
        w = np.asarray(w, np.float32)
        assert g.dtype == leaf.dtype, name
        scale = np.abs(w).max()
        bound = 1e-5 * max(scale, 1.0) if dtype == "f32" else 2.0 ** -5 * scale + 1e-6
        assert np.abs(g[0].float().numpy() - w).max() <= bound, name
    with pytest.raises(ValueError, match="max_position_embeddings"):
        model(tp, torch.zeros((1, 1, T + 1), dtype=torch.long))


# ---------------------------------------------------------------------------
# Sequence parallel: the replays of tests/test_models_trainer.py
# ---------------------------------------------------------------------------


def jax_sp_logits(cfg, params, ids):
    mesh = Mesh(np.array(jax.devices()[:SP]), ("sp",))
    model = jg.GPTModel(cfg)
    fn = jax.jit(jax.shard_map(lambda ii: model.apply({"params": params}, ii), mesh=mesh,
                               in_specs=P(None, "sp"), out_specs=P(None, "sp"), check_vma=False))
    return np.asarray(fn(jnp.asarray(ids)))


def port_sp_logits(layout, params, ids):
    """The port at sp 4 on ``ids`` (already in the layout's order), with
    the gradients of the summed per-rank LM losses; logits back to ``(B,
    T, vocab)`` in that order."""
    group = cpu_group(SP)
    model = port_model(tg.GPTConfig(**REPLAY, sp_axis="intra", sp_layout=layout), group)
    tp = replicate(params_from_jax(params), SP)
    shards = torch.from_numpy(ids).reshape(ids.shape[0], SP, T_LOCAL).transpose(0, 1)
    logits = model(tp, shards).detach()
    losses, grads = leaf_grads(tg.lm_loss_fn(model), tp, shards)
    return logits.transpose(0, 1).reshape(ids.shape[0], SP * T_LOCAL, -1).numpy(), losses, grads


def local_port(params, ids):
    model = port_model(tg.GPTConfig(**REPLAY))
    return model(replicate(params_from_jax(params), 1), torch.from_numpy(ids)[None])[0].detach().numpy()


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_gpt_causal_sp_matches_local(layout):
    """GPT with the sp 4 ring (contiguous, and zigzag on permuted ids with
    the output permuted back) equals the local model on the whole sequence,
    tied head included; in both packages, and the port's equals JAX's."""
    Tg = SP * T_LOCAL
    ids = ids_for(0 if layout == "contiguous" else 1, REPLAY["vocab_size"], (2, Tg))
    params = flax_params(jg.GPTModel(jg.GPTConfig(**REPLAY)), ids)
    ref = np.asarray(jg.GPTModel(jg.GPTConfig(**REPLAY)).apply({"params": params}, jnp.asarray(ids)))
    order = jra.zigzag_order(Tg, SP) if layout == "zigzag" else np.arange(Tg)
    inv = np.argsort(order)
    want = jax_sp_logits(jg.GPTConfig(**REPLAY, sp_axis="sp", sp_layout=layout), params, ids[:, order])[:, inv]
    got, _, _ = port_sp_logits(layout, params, ids[:, order])
    got = got[:, inv]
    np.testing.assert_allclose(want, ref, rtol=5e-3, atol=5e-3)  # the JAX replay's own check
    np.testing.assert_allclose(got, local_port(params, ids), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gpt_zigzag_lm_loss_masks_seam():
    """Under zigzag the seam pair is out of each rank's LM loss: per-rank
    losses equal the oracle from the local logits with those positions
    dropped, and JAX's per-rank losses."""
    Tg = SP * T_LOCAL
    ids = ids_for(2, REPLAY["vocab_size"], (2, Tg))
    cfg_sp = jg.GPTConfig(**dict(REPLAY, num_layers=1), sp_axis="sp", sp_layout="zigzag")
    params = flax_params(jg.GPTModel(dataclasses.replace(cfg_sp, sp_axis=None, sp_layout="contiguous")), ids)
    order = jra.zigzag_order(Tg, SP)
    zids = ids[:, order]
    mesh = Mesh(np.array(jax.devices()[:SP]), ("sp",))
    loss_fn = jg.lm_loss_fn(jg.GPTModel(cfg_sp))
    want = np.asarray(jax.jit(jax.shard_map(lambda ii: loss_fn(params, ii)[None], mesh=mesh,
                                            in_specs=P(None, "sp"), out_specs=P("sp"),
                                            check_vma=False))(jnp.asarray(zids)))

    group = cpu_group(SP)
    model = port_model(tg.GPTConfig(**dict(REPLAY, num_layers=1), sp_axis="intra", sp_layout="zigzag"), group)
    shards = torch.from_numpy(zids).reshape(2, SP, T_LOCAL).transpose(0, 1)
    got = tg.lm_loss_fn(model)(replicate(params_from_jax(params), SP), shards).detach().numpy()

    local = port_model(tg.GPTConfig(**dict(REPLAY, num_layers=1)))
    logits = local(replicate(params_from_jax(params), 1), torch.from_numpy(ids)[None])[0][:, order]
    for r in range(SP):
        lo, hi = r * T_LOCAL, (r + 1) * T_LOCAL
        logp = torch.log_softmax(logits[:, lo:hi - 1], dim=-1)
        nll = -torch.gather(logp, -1, torch.from_numpy(zids[:, lo + 1:hi, None]).long())[..., 0]
        keep = torch.arange(T_LOCAL - 1) != (T_LOCAL // 2 - 1)
        expect = float((nll * keep).sum().detach()) / (2 * (T_LOCAL - 2))
        np.testing.assert_allclose(got[r], expect, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_gpt_sp_grads_match_local():
    """The gradients of the summed per-rank losses at sp 4 (contiguous):
    each rank's copy of a parameter takes the part of the gradient its own
    tokens carry (its K/V reach the other ranks' losses through the ring's
    backward), so the copies sum to the local model's gradient of the sum
    of the per-block mean losses."""
    Tg = SP * T_LOCAL
    ids = ids_for(3, REPLAY["vocab_size"], (2, Tg))
    params = flax_params(jg.GPTModel(jg.GPTConfig(**REPLAY)), ids)
    _, losses, grads = port_sp_logits("contiguous", params, ids)

    model = port_model(tg.GPTConfig(**REPLAY))
    leaves = tree_map(lambda t: t.detach().clone().requires_grad_(), replicate(params_from_jax(params), 1))
    logits = model(leaves, torch.from_numpy(ids)[None])[0]
    total = 0.0
    for r in range(SP):  # each rank's loss: its block's next-token NLL
        lo, hi = r * T_LOCAL, (r + 1) * T_LOCAL
        logp = torch.log_softmax(logits[:, lo:hi - 1], dim=-1)
        total = total - torch.gather(logp, -1, torch.from_numpy(ids[:, lo + 1:hi, None]).long()).mean()
    total.backward()
    np.testing.assert_allclose(float(losses.sum()), float(total.detach()), rtol=1e-5)
    for (name, _), g, w in zip(tree_flatten_with_names(leaves), grads, tree_leaves(leaves)):
        scale = float(w.grad.abs().max())
        assert float((g.sum(0) - w.grad[0]).abs().max()) <= 1e-5 * max(scale, 1.0), name


# ---------------------------------------------------------------------------
# Tensor parallel
# ---------------------------------------------------------------------------


def test_gpt_tp2_matches_jax():
    """tp 2: logits (replicated over tp) and each rank's gradient of the
    LM loss against JAX under ``shard_map`` (the transpose of ``psum``
    brings both ranks' cotangents back, as the port's sum of their losses
    does), and the logits against the port's tp 1 model on the same
    (replicated) shards."""
    TP = 2
    jcfg = jg.GPTConfig(**SMALL, tp_size=TP, tp_axis="tp")
    ids = ids_for(4, SMALL["vocab_size"], (B, T))
    params = flax_params(jg.GPTModel(jcfg), ids)  # the local (1 / tp) shapes
    mesh = Mesh(np.array(jax.devices()[:TP]), ("tp",))
    jmodel = jg.GPTModel(jcfg)
    loss_fn = jg.lm_loss_fn(jmodel)

    def local(p, ii):
        loss, grads = jax.value_and_grad(loss_fn)(p, ii)
        return jmodel.apply({"params": p}, ii)[None], loss[None], jax.tree.map(lambda g: g[None], grads)

    want, jloss, jgrads = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P(), P()),
                                                out_specs=(P("tp"), P("tp"), P("tp")),
                                                check_vma=False))(params, jnp.asarray(ids))
    group = cpu_group(TP)
    model = port_model(tg.GPTConfig(**SMALL, tp_size=TP, tp_axis="intra"), group)
    tp = replicate(params_from_jax(params), TP)
    ids_t = torch.from_numpy(ids)[None].expand(TP, B, T)
    got = model(tp, ids_t).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    losses, grads = leaf_grads(tg.lm_loss_fn(model), tp, ids_t)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jloss), rtol=1e-6)
    for (name, _), g, w in zip(tree_flatten_with_names(tp), grads, jax.tree.leaves(jgrads)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * max(np.abs(w).max(), 1.0), name


# ---------------------------------------------------------------------------
# The contiguous causal ring, where JAX skips the blocks from a rank's future
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sp", [2, 4])
def test_contiguous_causal_ring_matches_jax(sp):
    rng = np.random.RandomState(10 + sp)
    Bq, Tq, h, d = 2, 8 * sp, 2, 8
    q, k, v = (rng.randn(Bq, Tq, h, d).astype(np.float32) for _ in range(3))
    cot = rng.randn(Bq, Tq, h, d).astype(np.float32)

    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))

    def ring(qq, kk, vv):
        return jra.ring_attention(qq, kk, vv, axis_name="sp", causal=True, layout="contiguous")

    fwd = jax.shard_map(ring, mesh=mesh, in_specs=(P(None, "sp"),) * 3, out_specs=P(None, "sp"),
                        check_vma=False)
    args = tuple(map(jnp.asarray, (q, k, v)))
    want = np.asarray(jax.jit(fwd)(*args))
    jgrads = jax.jit(jax.grad(lambda *a: jnp.sum(fwd(*a) * cot), argnums=(0, 1, 2)))(*args)

    group = cpu_group(sp)

    def shard(x):
        return torch.from_numpy(x).reshape(Bq, sp, Tq // sp, h, d).transpose(0, 1).contiguous()

    def unshard(t):
        return t.detach().transpose(0, 1).reshape(Bq, Tq, h, d).numpy()

    qs, ks, vs = (shard(x).requires_grad_() for x in (q, k, v))
    y = tra.ring_attention(qs, ks, vs, group, "intra", causal=True, layout="contiguous")
    (y * shard(cot)).sum().backward()
    np.testing.assert_allclose(unshard(y), want, rtol=1e-6, atol=1e-6)
    for name, g, w in zip(("dq", "dk", "dv"), (qs.grad, ks.grad, vs.grad), jgrads):
        np.testing.assert_allclose(unshard(g), np.asarray(w), rtol=3e-4, atol=3e-4, err_msg=name)
    # rank 0 sees only its own block: every later block is wholly masked
    # for it, and merging one is an exact identity
    alone = tra.ring_attention(qs[:1].detach(), ks[:1].detach(), vs[:1].detach(), None, causal=True)
    assert torch.equal(y[0].detach(), alone[0])
