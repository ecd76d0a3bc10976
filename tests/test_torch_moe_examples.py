"""The MoE twins (``bagua_tpu_torch.examples.moe`` and
``bagua_tpu_torch.examples.bench_moe``) against the JAX package's
``examples/moe/main.py`` and ``bench_moe.py``, on the CPU.

The flax models below are the JAX scripts' own (they define theirs inside
``main``), with flax's initial weights crossing by ``params_from_jax``.
Tolerances, each with its reason:

- the moe example's model, 3 steps of the engine on the 8-rank group (ep
  8, per-rank experts, ``gradient_allreduce`` + Adam 1e-3, experts outside
  the exchange) against the JAX engine, k 1 and 2: Adam divides by the
  gradient's own scale, so an element whose gradient is rounding noise can
  move by up to a step (lr) either way; every element within 3 lr, all
  but 5% within 3 lr x 1e-3, and the starting parameters must miss that;
- the bench model (2 layers, hidden 64, vocab 256, 16 tokens): f32 logits
  within 1e-5 of their scale and gradients within 1e-5 of their leaf's
  largest value; bf16 as the BERT tests hold bf16: logits within 4 bf16
  steps (4 x 2^-8) of their scale, the loss within rtol 1e-3, and every
  gradient within 2^-5 of its leaf's largest JAX value plus 1e-6.  The
  routing and the experts' ReLUs are discrete, so the bf16 run first
  asserts that both packages take the same decisions: equal dispatch masks
  in every block and equal ReLU patterns in every expert (the seed keeps
  clear of near-ties).  Two references are not JAX's bf16 gradient leaf
  as it stands.  XLA:CPU sums a bf16 Dense's bias cotangent over the
  tokens one bf16 add at a time (about 1% of the sum off at 64 terms,
  where one rounding is 0.2%), so those biases are held to the exact sum
  of JAX's own per-token cotangent, read at each Dense's output.  The key
  projection's bias has a zero gradient in exact arithmetic (softmax
  ignores a shift common to every key) and holds bf16 rounding noise of
  about 2e-4 in both packages, so it is held within 2^-5 of the key
  kernel's largest gradient.
"""

import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bagua_tpu.algorithms.gradient_allreduce import GradientAllReduceAlgorithm as JaxGAR
from bagua_tpu.communication import ALL_AXES as JAX_ALL_AXES
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP
from bagua_tpu.parallel.moe import MoE as JMoE

from bagua_tpu_torch.algorithms import GradientAllReduceAlgorithm
from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.convert import params_from_jax, stacked_params_from_jax
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.examples import bench_moe, moe
from bagua_tpu_torch.models.llama import module_params
from bagua_tpu_torch.utils import dotted_leaves, tree_flatten_with_names, tree_leaves, tree_unflatten

N, LR, STEPS = 8, 1e-3, 3
FLIPPED_SHARE = 0.05
BF16_STEP = 2.0 ** -8


class FlaxMoEExample(nn.Module):
    """``examples/moe/main.py``'s ``Model``, with its k."""

    num_experts: int
    n: int
    k: int = 1

    @nn.compact
    def __call__(self, x):
        h = jax.nn.relu(nn.Dense(64)(x))
        h, l_aux = JMoE(hidden_size=128, num_experts=self.num_experts, k=self.k, capacity_factor=2.0,
                        ep_size=self.n, ep_axis=JAX_ALL_AXES)(h)
        return nn.Dense(10)(h), l_aux


def example_batches(steps, n=N):
    """The JAX example's synthetic prototypes and batches."""
    rng = np.random.RandomState(0)
    protos = rng.rand(10, 32).astype(np.float32)
    out = []
    for _ in range(steps):
        y = rng.randint(0, 10, size=64 * n)
        x = protos[y] + 0.2 * rng.randn(64 * n, 32).astype(np.float32)
        out.append((x.astype(np.float32), y.astype(np.int32)))
    return out


def tiers(got, want, loose, tight):
    d = np.concatenate([np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64)).ravel()
                        for g, w in zip(got, want)])
    return d.max() <= loose and (d > tight).mean() <= FLIPPED_SHARE


@pytest.mark.parametrize("k", [1, 2])
def test_moe_example_steps_match_the_jax_engine(group, k):
    model = FlaxMoEExample(N, N, k)
    x0 = jnp.zeros((4, 32))
    per_rank = [model.init(jax.random.PRNGKey(r), x0)["params"] for r in range(N)]
    merged = [jax.tree_util.tree_map_with_path(
        lambda path, b, pr: pr if "experts" in jax.tree_util.keystr(path) else b, per_rank[0], p)
        for p in per_rank]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *merged)

    def loss_fn(params, batch):  # the JAX example's own
        x, y = batch
        logits, l_aux = model.apply({"params": params}, x)
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None], axis=1)) + 0.01 * l_aux

    batches = example_batches(STEPS)
    jddp = JaxDDP(loss_fn, optax.adam(LR), JaxGAR(), process_group=group,
                  dp_filter=lambda name: "experts" not in name)
    jstate = jddp.init(stacked_params=stacked)
    for x, y in batches:
        jstate, jlosses = jddp.train_step(jstate, (jnp.asarray(x), jnp.asarray(y)))

    tgroup = BaguaProcessGroup([torch.device("cpu")] * N, intra_size=4)
    tmodel = moe.Model(tgroup, N, k, device="cpu")
    assert [n for n, _ in tree_flatten_with_names(module_params(tmodel))] == \
        [n for n, _ in tree_flatten_with_names(jax.tree.map(np.asarray, merged[0]))]
    ddp = DistributedDataParallel(moe.loss_fn(tmodel), lambda ps: torch.optim.Adam(ps, lr=LR),
                                  GradientAllReduceAlgorithm(), tgroup, dp_filter=lambda name: "experts" not in name)
    state = ddp.init(stacked_params=stacked_params_from_jax([jax.tree.map(np.asarray, m) for m in merged]))
    for x, y in batches:
        state, losses = ddp.train_step(state, (torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-4)
    got = [t.numpy() for t in tree_leaves(state.params)]
    want = jax.tree.leaves(jax.tree.map(np.asarray, jstate.params))
    assert tiers(got, want, STEPS * LR, STEPS * LR * 1e-3)
    assert not tiers(jax.tree.leaves(stacked), want, STEPS * LR, STEPS * LR * 1e-3)


def test_moe_example_main_keeps_experts_apart(capsys):
    loss, params = moe.main(["--device", "cpu", "--ranks", "4", "--intra-size", "2", "--steps", "11"])
    out = capsys.readouterr().out
    assert np.isfinite(loss) and "step 0: loss" in out and "step 10: loss" in out and "final loss" in out
    for name, leaf in tree_flatten_with_names(params):
        same = [torch.equal(leaf[0], leaf[r]) for r in range(1, 4)]
        assert (not all(same)) if "experts" in name else all(same), name


def flax_bench_model(hidden, layers, vocab, dtype):
    """``bench_moe.py``'s ``Model`` at the given widths."""

    class Block(nn.Module):
        @nn.compact
        def __call__(self, x):
            h = nn.LayerNorm(dtype=dtype)(x)
            x = x + nn.SelfAttention(num_heads=8, dtype=dtype, deterministic=True)(h)
            h = nn.LayerNorm(dtype=dtype)(x)
            moe_out, l_aux = JMoE(hidden_size=hidden, num_experts=8, k=2, capacity_factor=1.25, ep_size=1,
                                  ep_axis=JAX_ALL_AXES)(h)
            return x + moe_out, l_aux

    class Model(nn.Module):
        @nn.compact
        def __call__(self, tokens):
            x = nn.Embed(vocab, hidden, dtype=dtype)(tokens)
            aux = 0.0
            for _ in range(layers):
                x, l_aux = Block()(x)
                aux = aux + l_aux
            logits = nn.Dense(vocab, dtype=dtype)(nn.LayerNorm(dtype=dtype)(x))
            return logits.astype(jnp.float32), aux / layers

    return Model()


def jloss_fn_of(jmodel):
    def jloss_fn(params, batch):  # bench_moe.py's
        tk, tg = batch
        logits, l_aux = jmodel.apply({"params": params}, tk)
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), tg[..., None], axis=-1)) + 0.01 * l_aux

    return jloss_fn


SMALL = dict(hidden=64, layers=2, vocab=256)
SEQ, BATCH = 16, 4
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def test_flax_softmax_matches_jax():
    """The bench twin's attention softmax against ``jax.nn.softmax`` in
    bf16 on the same scores: the forward bitwise; the backward within 2^-5
    of the largest input gradient (both differentiate the same ops, and
    XLA:CPU sums the row's bf16 products one bf16 add at a time where
    torch accumulates in f32; measured 2^-6)."""
    rng = np.random.RandomState(0)
    x = (3 * rng.randn(2, 8, SEQ, SEQ)).astype(np.float32)
    g = rng.randn(2, 8, SEQ, SEQ).astype(np.float32)
    want, vjp = jax.vjp(jax.nn.softmax, jnp.asarray(x, jnp.bfloat16))
    want_dx = np.asarray(vjp(jnp.asarray(g, jnp.bfloat16))[0], np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    got = bench_moe._flax_softmax(xt)
    got.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert np.array_equal(got.detach().float().numpy(), np.asarray(want, np.float32))
    assert np.abs(xt.grad.float().numpy() - want_dx).max() <= 2.0 ** -5 * np.abs(want_dx).max()


def flax_path(name):
    """A port leaf name (``['Block_0']['LayerNorm_0']['bias']``) as a flax
    module path and the leaf's own name."""
    parts = name.strip("[]'").split("']['")
    return "/".join(parts[:-1]), parts[-1]


def jax_bf16_record(jmodel, jp, batch):
    """Each block's dispatch mask and its experts' input in JAX's model,
    and the exact bias gradient of every bf16 Dense with a bias (the f64
    sum of the cotangent at its output), by module path."""
    seen, masks, hidden = {}, [], []

    def bf16_dense(module):
        return isinstance(module, (nn.Dense, nn.DenseGeneral)) and module.dtype == jnp.bfloat16 \
            and module.use_bias

    def run(params, taps):
        def interceptor(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            path = "/".join(context.module.path)
            if context.method_name != "__call__":
                return out
            if bf16_dense(context.module):
                seen[path] = out.shape
                out = out + taps[path] if path in taps else out
            elif path.endswith("/gate"):
                masks.append(out.dispatch_mask)
            elif path.endswith("/experts"):
                hidden.append(args[0])
            return out

        with nn.intercept_methods(interceptor):
            return jloss_fn_of(jmodel)(params, batch)

    run(jp, {})  # concrete masks and experts' inputs, and the taps' shapes
    got_masks, got_hidden = [np.asarray(m, bool) for m in masks], [np.asarray(h, np.float64) for h in hidden]
    taps = {path: jnp.zeros(shape, jnp.bfloat16) for path, shape in seen.items()}
    cts = jax.grad(run, argnums=1)(jp, taps)
    bias_grads = {}
    for path, ct in cts.items():
        keep = 2 if path.endswith(("query", "key", "value")) else 1  # DenseGeneral's (heads, head_dim)
        ct = np.asarray(ct, np.float64)
        bias_grads[path] = ct.reshape(-1, *ct.shape[ct.ndim - keep:]).sum(0)
    return got_masks, got_hidden, bias_grads


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bench_model_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, SMALL["vocab"], (BATCH, SEQ)).astype(np.int32)
    targets = rng.randint(0, SMALL["vocab"], (BATCH, SEQ)).astype(np.int32)
    jmodel = flax_bench_model(SMALL["hidden"], SMALL["layers"], SMALL["vocab"], jdt)
    jp = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(tokens[:1]))["params"])
    jbatch = (jnp.asarray(tokens), jnp.asarray(targets))

    want_logits, want_aux = jmodel.apply({"params": jp}, jnp.asarray(tokens))
    jloss, jgrads = jax.value_and_grad(jloss_fn_of(jmodel))(jp, jbatch)

    model = bench_moe.Model(**SMALL, dtype=tdt, device="cpu")
    assert [(n, tuple(t.shape)) for n, t in tree_flatten_with_names(module_params(model))] == \
        [(n, tuple(a.shape)) for n, a in tree_flatten_with_names(jp)]
    masks, hidden = [], []
    for name, module in model.named_modules():
        if name.endswith("moe_layer.gate"):
            module.register_forward_hook(lambda m, args, out: masks.append(out.dispatch_mask.detach()))
        elif name.endswith("moe_layer.experts"):
            module.register_forward_hook(lambda m, args, out: hidden.append(args[0].detach()))
    tp = params_from_jax(jp)
    leaves = [leaf.requires_grad_(True) for leaf in tree_leaves(tp)]
    tree = tree_unflatten(tp, leaves)
    logits, aux = torch.func.functional_call(model, dotted_leaves(tree), (torch.from_numpy(tokens),))
    assert logits.dtype == torch.float32
    want_logits = np.asarray(want_logits)
    scale = np.abs(want_logits).max()
    tol = 1e-5 * scale if dtype == "f32" else 4 * BF16_STEP * scale
    assert np.abs(logits.detach().numpy() - want_logits).max() <= tol
    np.testing.assert_allclose(float(aux.detach()), float(want_aux), rtol=1e-6 if dtype == "f32" else 1e-3)
    masks.clear(), hidden.clear()
    loss = bench_moe.loss_fn(model)(tree, (torch.from_numpy(tokens), torch.from_numpy(targets)))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6 if dtype == "f32" else 1e-3)
    loss.backward()
    names = [name for name, _ in tree_flatten_with_names(tp)]
    if dtype == "f32":
        for name, leaf, w in zip(names, leaves, jax.tree.leaves(jgrads)):
            w = np.asarray(w, np.float64)
            assert np.abs(leaf.grad.double().numpy() - w).max() <= 1e-5 * max(np.abs(w).max(), 1.0), name
        return

    jmasks, jhidden, bias_grads = jax_bf16_record(jmodel, jp, jbatch)
    assert len(masks) == len(jmasks) == SMALL["layers"] == len(hidden) == len(jhidden)
    for got, want in zip(masks, jmasks):  # the same routing decisions
        assert np.array_equal(got.numpy(), want)
    jleaf = dict(zip(names, jax.tree.leaves(jgrads)))
    weights = dict(tree_flatten_with_names(jp))
    for block, got, want in zip(range(SMALL["layers"]), hidden, jhidden):  # the same ReLU patterns
        prefix = f"['Block_{block}']['MoE_0']['moe_layer']['experts']['VmapDense_0']"
        kernel, bias = (np.asarray(weights[f"{prefix}['{k}']"], np.float64) for k in ("kernel", "bias"))
        pre = [np.einsum("eti,eio->eto", x, kernel) + bias[:, None] for x in (got.double().numpy(), want)]
        assert np.array_equal(pre[0] > 0, pre[1] > 0)
    assert len(bias_grads) == 4 * SMALL["layers"] + 1  # q, k, v, out a block, and the logits' Dense
    for name, leaf in zip(names, leaves):
        path, kind = flax_path(name)
        w = np.asarray(jleaf[name], np.float64)
        want = bias_grads[path] if kind == "bias" and path in bias_grads else w
        bound = 2.0 ** -5 * np.abs(w).max() + 1e-6
        if path.endswith("SelfAttention_0/key") and kind == "bias":  # zero in exact arithmetic
            bound = 2.0 ** -5 * np.abs(np.asarray(jleaf[name.replace("'bias'", "'kernel'")])).max()
        assert np.abs(leaf.grad.double().numpy() - want).max() <= bound, name


def test_bench_moe_main_prints_both_lines(capsys):
    result = bench_moe.main(["--device", "cpu", "--ranks", "2", "--hidden", "64", "--layers", "2",
                             "--vocab", "256", "--seq", "16", "--batch", "2"])
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [line["metric"] for line in lines] == ["moe_fused_a2a_step_ms", "moe_samples_per_sec_per_chip"]
    assert lines[0]["a2a_chunks"] == 4 and lines[0]["ep_size"] == 2 and lines[0]["provisional"]
    assert lines[1]["config"].startswith("SMOKE") and lines[1]["value"] > 0
    assert result.steps == 12 and torch.isfinite(result.losses).all()
    for leaf in tree_leaves(result.state.params):  # ep 1: every leaf in the exchange
        assert torch.equal(leaf[0], leaf[1])


def test_bench_model_full_width_parameter_count():
    """The JAX bench's model has 50,471,936 parameters at its widths."""
    model = bench_moe.Model(device="meta")
    assert sum(p.numel() for p in model.parameters()) == 50_471_936
