"""The port's Llama model and its sequence-parallel training step against
the JAX package.

Parameters come from flax's init and cross with ``params_from_jax``; ids are
made with numpy.  The sequence-parallel cases run an 8-rank group
(``[cpu] * 8``, ``intra_size=4``: dp = inter = 2, sp = intra = 4, zigzag)
against JAX's ``shard_map`` on a ``("dp", "sp") = (2, 4)`` mesh.  The
tensor-parallel cases run four ranks at tp 2, as the example maps them
(dp 2 x tp 2: dp = inter, tp = intra; tp 2 x sp 2: tp = inter, sp = intra),
against JAX on a ``("dp", "tp", "sp")`` mesh.

Tolerances, each with its reason: RoPE and RMSNorm within 1e-6 (elementwise
f32; sin, cos and rsqrt may differ in the last bit); logits and losses
within 1e-4 (f32 matmuls summed in another order, through two layers);
parameters after 3 SGD steps within 1e-5; after 3 AdamW steps every
element within 3 lr (Adam moves each element by about lr a step, whatever
its gradient's size), and all but 1% of them within 1e-5 (a gradient near
zero turns rounding noise into a full-size step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from bagua_tpu.models import llama as jl
from bagua_tpu.parallel.ring_attention import zigzag_order as jax_zigzag_order

from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.examples import llama_pretrain as ex
from bagua_tpu_torch.models import llama as tl
from bagua_tpu_torch.utils import tree_flatten_with_names, tree_leaves, tree_map

DP, SP = 2, 4
B, T = 4, 32  # global batch and sequence: 2 sequences and 8 tokens per rank
LOGIT_TOL = 1e-4
STEPS, LR = 3, 3e-3

SMALL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
             intermediate_size=48, max_position_embeddings=T)


def jax_cfg(**kw):
    return jl.LlamaConfig(**{**SMALL, **kw})


def torch_cfg(**kw):
    return tl.LlamaConfig(**{**SMALL, **kw})


def flax_params(cfg, t):
    params = jl.LlamaModel(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, t), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def stacked(params, size):
    return ex.replicate(params_from_jax(params), size)


def test_apply_rope_and_rmsnorm_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 10, 3, 8).astype(np.float32)
    pos = rng.randint(0, 4096, size=10)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # interleaved pairs: (x0, x1) rotate together, not (x0, x_{d/2})
    one = torch.zeros(1, 1, 1, 8)
    one[..., 0] = 1.0
    turned = tl.apply_rope(one, torch.tensor([1]), 10000.0)
    assert turned[..., 1] != 0 and turned[..., 4] == 0
    # stacked: (R, b, t, h, d) with one position row per rank
    xs = torch.from_numpy(np.stack([x, x]))
    ps = torch.from_numpy(np.stack([pos, pos + 7]))
    both = tl.apply_rope(xs, ps, 10000.0)
    assert torch.equal(both[0], got)
    np.testing.assert_allclose(both[1].numpy(), np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos + 7), 1e4)),
                               rtol=1e-6, atol=1e-6)

    h = rng.randn(3, 5, 16).astype(np.float32) * 3
    scale = rng.rand(16).astype(np.float32) + 0.5
    want = jl.RMSNorm(1e-5).apply({"params": {"scale": scale}}, jnp.asarray(h))
    got = tl.RMSNorm(16, 1e-5, device="cpu")({"scale": torch.from_numpy(scale)[None]},
                                              torch.from_numpy(h)[None])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", [dict(hidden_size=30), dict(hidden_size=36, num_heads=4),
                                 dict(num_kv_heads=3), dict(tp_size=3), dict()])
def test_config_validation_matches_jax(bad):
    errors = []
    for make in (jax_cfg, torch_cfg):
        try:
            make(**bad)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]
    assert (errors[0] is None) == (not bad)


def test_params_tree_and_init_match_flax():
    """Names, shapes, dtypes as flax's tree, and flax's initializers in
    distribution: each leaf's mean and deviation within a few percent of
    flax's draw of the same shape (ones for the norms)."""
    cfg_kw = dict(vocab_size=512, hidden_size=128, intermediate_size=192, num_heads=4, num_kv_heads=2)
    want = flax_params(jax_cfg(**cfg_kw), 8)
    _, got = tl.init_llama(torch_cfg(**cfg_kw), torch.Generator().manual_seed(0), device="cpu")
    names_want = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    flat = tree_flatten_with_names(got)
    assert [n for n, _ in flat] == names_want
    for (name, g), w in zip(flat, jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        if name.endswith("['scale']"):
            assert torch.equal(g, torch.ones_like(g)), name
            continue
        assert abs(float(g.std()) / float(w.std()) - 1) < 0.05, name
        assert abs(float(g.mean())) < 0.05 * float(w.std()) + 1e-3, name


def test_single_device_logits_match_flax():
    """sp_axis=None, R = 1: the single-device model from converted flax
    parameters (local attention oracle, GQA repeated)."""
    cfg = jax_cfg()
    params = flax_params(cfg, T)
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    want = np.asarray(jax.jit(jl.LlamaModel(cfg).apply)({"params": params}, jnp.asarray(ids)))
    model, _ = tl.init_llama(torch_cfg(), device="cpu")
    got = model(stacked(params, 1), torch.from_numpy(ids)[None].long())
    assert got.shape == (1, B, T, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got[0].detach().numpy(), want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        model(stacked(params, 1), torch.zeros((1, 1, T + 1), dtype=torch.long))


# ---------------------------------------------------------------------------
# Sequence parallel (dp 2 x sp 4, zigzag)
# ---------------------------------------------------------------------------


def sp_setup():
    jcfg = jax_cfg(sp_axis="sp", sp_layout="zigzag")
    tcfg = torch_cfg(sp_axis="intra", sp_layout="zigzag")
    group = BaguaProcessGroup([torch.device("cpu")] * (DP * SP), intra_size=SP)
    params = flax_params(jcfg, T // SP)
    rng = np.random.RandomState(2)
    x = rng.randint(0, SMALL["vocab_size"], size=(B, T))[:, jax_zigzag_order(T, SP)].astype(np.int32)
    ids = [x] * STEPS  # one batch again and again: the loss must fall
    mesh = Mesh(np.array(jax.devices()[:DP * SP]).reshape(DP, SP), ("dp", "sp"))
    return jcfg, tcfg, group, params, ids, mesh


def test_zigzag_logits_match_jax():
    jcfg, tcfg, group, params, ids, mesh = sp_setup()
    model = jl.LlamaModel(jcfg)
    fwd = jax.jit(jax.shard_map(lambda p, x: model.apply({"params": p}, x), mesh=mesh,
                                in_specs=(P(), P("dp", "sp")), out_specs=P("dp", "sp"),
                                check_vma=False))
    want = np.asarray(fwd(params, jnp.asarray(ids[0])))
    tmodel, _ = tl.init_llama(tcfg, device="cpu", group=group)
    got = tmodel(stacked(params, group.size), ex.shard_ids(ids[0], group)).detach().numpy()
    got = got.reshape(DP, SP, B // DP, T // SP, -1).swapaxes(1, 2).reshape(B, T, -1)
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def jax_train(jcfg, params, ids, mesh, opt):
    """The example's ``local_step``, rebuilt: ``value_and_grad`` -> pmean
    over ("dp", "sp") -> optax; returns each step's mean loss and the final
    parameters."""
    loss_fn = jl.llama_loss_fn(jl.LlamaModel(jcfg))

    def local_step(p, s, x):
        loss, grads = jax.value_and_grad(loss_fn)(p, x)
        grads = jax.tree.map(lambda g: jax.lax.pmean(g, ("dp", "sp")), grads)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, jax.lax.pmean(loss, ("dp", "sp"))

    step = jax.jit(jax.shard_map(local_step, mesh=mesh, in_specs=(P(), P(), P("dp", "sp")),
                                 out_specs=(P(), P(), P()), check_vma=False))
    state, losses = opt.init(params), []
    for x in ids:
        params, state, loss = step(params, state, jnp.asarray(x))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params)


def port_train(tcfg, group, params, ids, make_opt, axes=None):
    """The port's ``train_step`` on the example's layout ``axes``
    (``mesh_axes``; by default dp = inter, sp = intra); returns each step's
    mean loss and the final parameters, after checking that every rank holds
    the same bits (tp ranks are replicas, as in JAX)."""
    axes = axes or ex.mesh_axes(group.inter_size, 1, group.intra_size)
    model, _ = tl.init_llama(tcfg, device="cpu", group=group)
    sp = stacked(params, group.size)
    opt = make_opt(tree_leaves(sp))
    loss_fn = tl.llama_loss_fn(model)
    losses = [ex.train_step(sp, opt, ex.shard_ids(x, group, None, axes["dp_axis"], axes["sp_axis"]),
                            loss_fn, group, axes["avg_axis"]) for x in ids]
    for leaf in tree_leaves(sp):
        assert all(torch.equal(leaf[0], leaf[r]) for r in range(1, group.size))
    return [float(l[0]) for l in losses], tree_map(lambda t: t[0].detach().numpy(), sp)


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_train_steps_match_jax(optimizer):
    """3 steps of the port's ``train_step`` against the JAX example's
    ``local_step`` from the same parameters and zigzag ids."""
    jcfg, tcfg, group, params, ids, mesh = sp_setup()
    if optimizer == "sgd":
        jopt, make_opt = optax.sgd(LR * 100), lambda ps: torch.optim.SGD(ps, lr=LR * 100)
    else:
        jopt = optax.adamw(LR)
        make_opt = lambda ps: torch.optim.AdamW(ps, lr=LR, weight_decay=ex.WEIGHT_DECAY)  # noqa: E731
    want_losses, want = jax_train(jcfg, params, ids, mesh, jopt)
    got_losses, got = port_train(tcfg, group, params, ids, make_opt)
    np.testing.assert_allclose(got_losses, want_losses, rtol=LOGIT_TOL, atol=0)
    assert got_losses[-1] < got_losses[0]
    diffs = np.concatenate([np.abs(g - w).ravel() for g, w in zip(tree_leaves(got), jax.tree.leaves(want))])
    if optimizer == "sgd":
        assert diffs.max() <= 1e-5, diffs.max()
    else:
        assert diffs.max() <= STEPS * LR, diffs.max()
        assert (diffs > 1e-5).mean() <= 0.01, (diffs > 1e-5).mean()


def test_example_main_runs_on_cpu(capsys):
    """The example's layouts run, its three-axis default (dp 2 x tp 2 x sp
    2) among them, on the named mesh; a legacy ``(inter, intra)`` group
    holds two live axes (``mesh_axes`` raises for three), and a
    ``MeshSpec`` whose size is not the group's raises."""
    ex.main(["--device", "cpu", "--dp", "2", "--tp", "1", "--sp", "2", "--steps", "2", "--batch", "4"])
    assert "final:" in capsys.readouterr().out
    ex.main(["--device", "cpu", "--dp", "1", "--tp", "2", "--sp", "2", "--steps", "2", "--batch", "4"])
    assert "final:" in capsys.readouterr().out
    ex.main(["--device", "cpu", "--dp", "2", "--tp", "2", "--sp", "2", "--steps", "1"])
    assert "final:" in capsys.readouterr().out
    with pytest.raises(ValueError, match="mesh_spec"):
        ex.mesh_axes(2, 2, 2)
    with pytest.raises(ValueError, match="needs 8 devices, got 4"):
        BaguaProcessGroup([torch.device("cpu")] * 4, mesh_spec=ex.mesh_spec(2, 2, 2))


def jax_example_main(argv, monkeypatch):
    """The JAX example's hand-scheduled ``main()`` under ``argv``: its
    printed losses, and its initial and final parameters (the jitted step's
    first inputs and last outputs)."""
    import importlib.util
    import os
    import sys

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "llama_pretrain", "main.py")
    spec = importlib.util.spec_from_file_location("jax_llama_pretrain_example", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    calls, jit = [], jax.jit

    def recording_jit(fun, *a, **kw):
        compiled = jit(fun, *a, **kw)

        def call(*args):
            out = compiled(*args)
            calls.append((args[0], out))
            return out

        return call

    monkeypatch.setattr(jax, "jit", recording_jit)
    monkeypatch.setattr(sys, "argv", ["main.py"] + argv)
    module.main()
    monkeypatch.setattr(jax, "jit", jit)
    losses = [float(out[2]) for _, out in calls]
    return losses, jax.tree.map(np.asarray, calls[0][0]), jax.tree.map(np.asarray, calls[-1][1][0])


def test_three_axis_default_matches_jax_example(monkeypatch):
    """The twin's hand-scheduled mode at the example's default, dp 2 x tp 2
    x sp 2 (zigzag ring, Row ``psum`` over tp, the average over dp and sp),
    3 AdamW steps from the example's initial parameters against its
    ``main()``: losses within LOGIT_TOL, every element of every rank's
    parameters within 3 lr of JAX's and all but 1% within 1e-5 (AdamW's
    rule above)."""
    argv = ["--steps", str(STEPS)]
    want_losses, initial, want = jax_example_main(argv, monkeypatch)
    args = ex.parse_args(argv + ["--device", "cpu"])
    assert (args.dp, args.tp, args.sp) == (2, 2, 2)
    got_losses, got = ex.run(args, torch.device("cpu"), params=params_from_jax(initial))
    np.testing.assert_allclose(got_losses, want_losses, rtol=LOGIT_TOL, atol=0)
    assert got_losses[-1] < got_losses[0]
    moved = max(float(np.abs(w - i).max()) for w, i in zip(jax.tree.leaves(want), jax.tree.leaves(initial)))
    assert moved > LR
    for r in range(8):  # every rank, tp ranks included, holds JAX's one tree
        diffs = np.concatenate([np.abs(g[r].detach().numpy() - w).ravel()
                                for g, w in zip(tree_leaves(got), jax.tree.leaves(want))])
        assert diffs.max() <= STEPS * LR, diffs.max()
        assert (diffs > 1e-5).mean() <= 0.01, (diffs > 1e-5).mean()


# ---------------------------------------------------------------------------
# Tensor parallel (dp 2 x tp 2, tp 2 x sp 2)
# ---------------------------------------------------------------------------

#: (dp, tp, sp) layouts of four ranks, as the example maps them
TP_LAYOUTS = {"dp2-tp2": (2, 2, 1), "tp2-sp2": (1, 2, 2)}


def tp_setup(dp, tp, sp):
    axes = ex.mesh_axes(dp, tp, sp)
    jcfg = jax_cfg(tp_size=tp, tp_axis="tp", sp_axis="sp" if sp > 1 else None,
                   sp_layout="zigzag" if sp > 1 else "contiguous")
    tcfg = torch_cfg(tp_size=tp, tp_axis=axes["tp_axis"], sp_axis=axes["sp_axis"],
                     sp_layout=jcfg.sp_layout)
    group = BaguaProcessGroup([torch.device("cpu")] * (dp * tp * sp), intra_size=axes["intra_size"])
    params = flax_params(jcfg, T // sp)  # the local (1 / tp) shapes, as the example inits
    rng = np.random.RandomState(3)
    x = rng.randint(0, SMALL["vocab_size"], size=(B, T))
    if sp > 1:
        x = x[:, jax_zigzag_order(T, sp)]
    mesh = Mesh(np.array(jax.devices()[:dp * tp * sp]).reshape(dp, tp, sp), ("dp", "tp", "sp"))
    return jcfg, tcfg, group, axes, params, [x.astype(np.int32)] * STEPS, mesh


@pytest.mark.parametrize("layout,optimizer", [("dp2-tp2", "sgd"), ("tp2-sp2", "sgd"),
                                              ("tp2-sp2", "adamw")])
def test_tensor_parallel_train_steps_match_jax(layout, optimizer):
    """3 steps of the port's ``train_step`` at tp 2 against the JAX example's
    ``local_step`` on a ``("dp", "tp", "sp")`` mesh: the Row projections'
    ``psum`` (whose transpose brings both tp ranks' cotangents, 2x a
    rank's own) and the average over dp and sp only.  SGD at lr 0.3 shows a
    gradient off by a factor in the parameters."""
    jcfg, tcfg, group, axes, params, ids, mesh = tp_setup(*TP_LAYOUTS[layout])
    if optimizer == "sgd":
        jopt, make_opt = optax.sgd(LR * 100), lambda ps: torch.optim.SGD(ps, lr=LR * 100)
    else:
        jopt = optax.adamw(LR)
        make_opt = lambda ps: torch.optim.AdamW(ps, lr=LR, weight_decay=ex.WEIGHT_DECAY)  # noqa: E731
    want_losses, want = jax_train(jcfg, params, ids, mesh, jopt)
    got_losses, got = port_train(tcfg, group, params, ids, make_opt, axes)
    np.testing.assert_allclose(got_losses, want_losses, rtol=LOGIT_TOL, atol=0)
    assert got_losses[-1] < got_losses[0]
    diffs = np.concatenate([np.abs(g - w).ravel() for g, w in zip(tree_leaves(got), jax.tree.leaves(want))])
    if optimizer == "sgd":
        assert diffs.max() <= 1e-5, diffs.max()
    else:
        assert diffs.max() <= STEPS * LR, diffs.max()
        assert (diffs > 1e-5).mean() <= 0.01, (diffs > 1e-5).mean()
