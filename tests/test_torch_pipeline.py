"""The port's pipeline schedules against the JAX package's, case by case of
``tests/test_pipeline.py``, on the same numpy-seeded stages and data.

The JAX side runs ``shard_map`` over 4 of the simulated devices (``("pp",)``
mesh).  The port runs a 4-rank CPU group with the pipeline on ``"intra"``
(and, where a case says so, an 8-rank group with the pipeline on
``"inter"``: two pipelines side by side), every leaf rank-stacked.  Both are
held to the sequential program, and to each other.

Tolerances, all f32: losses within rtol 2e-4, gradients within rtol 2e-3
and atol 1e-4 (the JAX tests' bounds: f32 sums in another order through
four stages); the port's own sequential oracle and its schedules agree far
tighter, and the remat and ``V = 1`` cases are held bitwise where the
port computes the very same operations.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from bagua_tpu.parallel import pipeline as jp

from bagua_tpu_torch.communication import BaguaProcessGroup, ReduceOp, allreduce
from bagua_tpu_torch.parallel import pipeline as tp_
from bagua_tpu_torch.utils import tree_map

STAGES = 4
MICRO = 6
MB, DIM = 3, 8
LOSS_RTOL = 2e-4
GRAD_TOL = dict(rtol=2e-3, atol=1e-4)


def make_stage_params(seed):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(DIM, DIM) * 0.5).astype(np.float32),
            "b": (rng.randn(DIM) * 0.1).astype(np.float32)}


def _data(seed, n_micro=MICRO, out=DIM):
    rng = np.random.RandomState(seed)
    return rng.randn(n_micro, MB, DIM).astype(np.float32), rng.randn(n_micro, MB, out).astype(np.float32)


# -- JAX side (tests/test_pipeline.py's programs) ----------------------------


def j_stage(params, x):
    return jax.nn.tanh(x @ params["w"] + params["b"])


def j_mse(y, t):
    return jnp.mean((y - t) ** 2)


def j_stacked(stages):
    return jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *stages)


def j_shard(fn, in_specs, out_specs, *args):
    mesh = Mesh(np.array(jax.devices()[:STAGES]), ("pp",))
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                                 check_vma=False))(*args)


def mine(p):
    return jax.tree.map(lambda q: q[0], p)


# -- port side ---------------------------------------------------------------


def t_stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"][:, None, :])


def t_mse(y, t):
    return ((y - t) ** 2).mean(dim=tuple(range(1, y.dim())))


def pp_group(axis):
    """4 pipeline ranks on ``axis``: ``[cpu] * 4`` on intra, or ``[cpu] * 8``
    with intra 2 (two pipelines of 4 on inter)."""
    if axis == "intra":
        return BaguaProcessGroup([torch.device("cpu")] * STAGES, intra_size=STAGES)
    return BaguaProcessGroup([torch.device("cpu")] * 2 * STAGES, intra_size=2)


def stage_of(group, axis):
    """Each rank's stage: its index on the pipeline axis."""
    r = torch.arange(group.size)
    return r % group.intra_size if axis == "intra" else r // group.intra_size


def t_stacked(stages, group, axis, grad=True):
    rows = stage_of(group, axis)
    tree = {k: torch.from_numpy(np.stack([s[k] for s in stages]))[rows] for k in stages[0]}
    return tree_map(lambda t: t.clone().requires_grad_(grad), tree)


def every_rank(x, group):
    return torch.from_numpy(x)[None].expand(group.size, *x.shape).contiguous()


def t_sequential(stages, micro):
    """The sequential program in torch (R = 1): each microbatch through the
    stages in order."""
    out = []
    for m in range(micro.shape[0]):
        x = torch.from_numpy(micro[m])[None]
        for p in stages:
            x = t_stage({k: v[None] for k, v in p.items()}, x)
        out.append(x[0])
    return torch.stack(out)


def oracle_loss_and_grads(stages, micro, target, loss=t_mse, head=None):
    leaves = [{k: torch.from_numpy(v).requires_grad_() for k, v in s.items()} for s in stages]
    out = t_sequential(leaves, micro)
    if head is None:
        val = torch.stack([loss(out[m][None], torch.from_numpy(target[m])[None])[0]
                           for m in range(out.shape[0])]).mean()
    else:
        val = head(out, target)
    val.backward()
    return float(val.detach()), [{k: v.grad.numpy() for k, v in s.items()} for s in leaves]


def check_stage_grads(got, want, group, axis, what=""):
    rows = stage_of(group, axis)
    for r in range(group.size):
        for key in ("w", "b"):
            np.testing.assert_allclose(got[key][r].detach().numpy(), want[int(rows[r])][key],
                                       **GRAD_TOL, err_msg=f"{what} rank {r} {key}")


# -- the cases ---------------------------------------------------------------


def test_pipeline_matches_sequential():
    stages = [make_stage_params(s) for s in range(STAGES)]
    micro = np.random.RandomState(42).randn(MICRO, MB, DIM).astype(np.float32)
    expect = t_sequential([{k: torch.from_numpy(v) for k, v in s.items()} for s in stages], micro).numpy()

    want = np.asarray(j_shard(lambda p, mb: jp.pipeline_apply(j_stage, mine(p), mb, axis_name="pp"),
                              (P("pp"), P()), P(), j_stacked(stages), jnp.asarray(micro)))
    group = pp_group("intra")
    got = tp_.pipeline_apply(t_stage, t_stacked(stages, group, "intra", grad=False),
                             every_rank(micro, group), group, "intra")
    assert got.shape == (STAGES, MICRO, MB, DIM)
    for r in range(STAGES):  # broadcast to every pipeline rank
        np.testing.assert_allclose(got[r].numpy(), expect, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("axis", ["intra", "inter"])
def test_pipeline_gradients(axis):
    """The gradient of a loss on the broadcast outputs, summed over every
    rank (each computes the same), is the sequential program's: the
    ``1 / n_stages`` of the broadcast's backward undoes the sum."""
    stages = [make_stage_params(10 + s) for s in range(STAGES)]
    rng = np.random.RandomState(7)
    micro = rng.randn(MICRO, MB, DIM).astype(np.float32)
    target = rng.randn(MICRO, MB, DIM).astype(np.float32)

    def j_local(p, mb):
        return jnp.mean((jp.pipeline_apply(j_stage, mine(p), mb, axis_name="pp") - target) ** 2)

    jgot = j_shard(lambda p, mb: jax.grad(j_local)(p, mb), (P("pp"), P()), P("pp"),
                   j_stacked(stages), jnp.asarray(micro))
    want = [{k: np.asarray(jgot[k][s]) for k in ("w", "b")} for s in range(STAGES)]
    _, oracle = oracle_loss_and_grads(stages, micro, target)
    group = pp_group(axis)
    params = t_stacked(stages, group, axis)
    out = tp_.pipeline_apply(t_stage, params, every_rank(micro, group), group, axis)
    ((out - torch.from_numpy(target)) ** 2).mean(dim=(1, 2, 3)).sum().backward()
    grads = {k: v.grad for k, v in params.items()}
    check_stage_grads(grads, oracle, group, axis, "vs the sequential program")
    check_stage_grads(grads, want, group, axis, "vs JAX")


def test_pipeline_single_stage_fallbacks():
    """No pipeline axis (no group): ``pipeline_apply`` maps the stage over
    the microbatches, and 1F1B is the plain gradient of the mean loss."""
    stage = make_stage_params(0)
    micro = np.random.RandomState(0).randn(4, MB, DIM).astype(np.float32)
    want = np.asarray(jp.pipeline_apply(j_stage, stage, jnp.asarray(micro), axis_name="pp"))
    params = {k: torch.from_numpy(v)[None] for k, v in stage.items()}
    got = tp_.pipeline_apply(t_stage, params, torch.from_numpy(micro)[None])
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-6)

    stage = make_stage_params(50)
    micro, target = _data(51, 4)
    jloss, jgrads = jp.pipeline_train_1f1b(j_stage, stage, jnp.asarray(micro), jnp.asarray(target),
                                           j_mse, "pp")
    params = {k: torch.from_numpy(v)[None] for k, v in stage.items()}
    loss, grads = tp_.pipeline_train_1f1b(t_stage, params, torch.from_numpy(micro)[None],
                                          torch.from_numpy(target)[None], t_mse)
    np.testing.assert_allclose(float(loss[0]), float(jloss), rtol=1e-5)
    for key in ("w", "b"):
        np.testing.assert_allclose(grads[key][0].numpy(), np.asarray(jgrads[key]), rtol=1e-4, atol=1e-7)


def test_pipeline_loss_scalar_only():
    """``pipeline_loss`` equals the loss on the sequential outputs on every
    rank, and its gradients match, with no broadcast of the activations."""
    stages = [make_stage_params(20 + s) for s in range(STAGES)]
    micro, target = _data(21)

    def j_local(p, mb):
        return jp.pipeline_loss(j_stage, mine(p), mb, jnp.asarray(target), j_mse, axis_name="pp")

    jloss = float(j_shard(j_local, (P("pp"), P()), P(), j_stacked(stages), jnp.asarray(micro)))
    jgot = j_shard(lambda p, mb: jax.grad(j_local)(p, mb), (P("pp"), P()), P("pp"),
                   j_stacked(stages), jnp.asarray(micro))
    want_loss, oracle = oracle_loss_and_grads(stages, micro, target)
    group = pp_group("intra")
    params = t_stacked(stages, group, "intra")
    loss = tp_.pipeline_loss(t_stage, params, every_rank(micro, group), every_rank(target, group),
                             t_mse, group, "intra")
    assert loss.shape == (STAGES,)
    np.testing.assert_allclose(loss.detach().numpy(), [want_loss] * STAGES, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss[0].detach()), jloss, rtol=LOSS_RTOL)
    loss.sum().backward()
    grads = {k: v.grad for k, v in params.items()}
    check_stage_grads(grads, oracle, group, "intra")
    check_stage_grads(grads, [{k: np.asarray(jgot[k][s]) for k in ("w", "b")} for s in range(STAGES)],
                      group, "intra")


@pytest.mark.parametrize("axis", ["intra", "inter"])
def test_1f1b_matches_sequential_oracle(axis):
    stages = [make_stage_params(30 + s) for s in range(STAGES)]
    micro, target = _data(31)

    def j_local(p, mb):
        loss, grads = jp.pipeline_train_1f1b(j_stage, mine(p), mb, jnp.asarray(target), j_mse,
                                             axis_name="pp")
        return loss, jax.tree.map(lambda g: g[None], grads)

    jloss, jgrads = j_shard(j_local, (P("pp"), P()), (P(), P("pp")), j_stacked(stages), jnp.asarray(micro))
    want_loss, oracle = oracle_loss_and_grads(stages, micro, target)
    group = pp_group(axis)
    loss, grads = tp_.pipeline_train_1f1b(t_stage, t_stacked(stages, group, axis, grad=False),
                                          every_rank(micro, group), every_rank(target, group), t_mse,
                                          group, axis)
    np.testing.assert_allclose(loss.numpy(), [want_loss] * group.size, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss[0]), float(jloss), rtol=LOSS_RTOL)
    check_stage_grads(grads, oracle, group, axis, "vs the sequential program")
    check_stage_grads(grads, [{k: np.asarray(jgrads[k][s]) for k in ("w", "b")} for s in range(STAGES)],
                      group, axis, "vs JAX")


def test_1f1b_extended_head_and_input_grads():
    """``loss_params`` (an LM head inside the loss) and the input
    cotangents (for an embedding outside the pipeline): both come back on
    one rank each, recovered by a sum over the pipeline axis."""
    stages = [make_stage_params(70 + s) for s in range(STAGES)]
    micro, _ = _data(71)
    rng = np.random.RandomState(72)
    head = {"v": rng.randn(DIM, 2).astype(np.float32)}
    target = rng.randn(MICRO, MB, 2).astype(np.float32)

    def j_head_loss(hp, y, t):
        return jnp.mean((y @ hp["v"] - t) ** 2)

    def j_local(p, hp, mb):
        loss, grads = jp.pipeline_train_1f1b(j_stage, mine(p), mb, jnp.asarray(target), j_head_loss,
                                             axis_name="pp", loss_params=hp, with_input_grads=True)
        g_head = jax.tree.map(lambda g: jax.lax.psum(g, "pp"), grads.loss_params)
        return loss, jax.tree.map(lambda g: g[None], grads.stage), g_head, jax.lax.psum(grads.inputs, "pp")

    jloss, jstage, jhead, jmicro = j_shard(j_local, (P("pp"), P(), P()), (P(), P("pp"), P(), P()),
                                           j_stacked(stages), jax.tree.map(jnp.asarray, head),
                                           jnp.asarray(micro))

    # the sequential oracle with the head and the input as leaves too
    leaves = [{k: torch.from_numpy(v).requires_grad_() for k, v in s.items()} for s in stages]
    hv = torch.from_numpy(head["v"]).requires_grad_()
    mbs = torch.from_numpy(micro).requires_grad_()
    out = []
    for m in range(MICRO):
        x = mbs[m][None]
        for p in leaves:
            x = t_stage({k: v[None] for k, v in p.items()}, x)
        out.append(((x[0] @ hv - torch.from_numpy(target[m])) ** 2).mean())
    oracle = torch.stack(out).mean()
    oracle.backward()

    group = pp_group("intra")

    def t_head_loss(hp, y, t):
        return ((y @ hp["v"] - t) ** 2).mean(dim=(1, 2))

    loss, grads = tp_.pipeline_train_1f1b(
        t_stage, t_stacked(stages, group, "intra", grad=False), every_rank(micro, group),
        every_rank(target, group), t_head_loss, group, "intra",
        loss_params={"v": every_rank(head["v"], group)}, with_input_grads=True)
    assert isinstance(grads, tp_.PipelineGrads)
    g_head = allreduce(grads.loss_params["v"], ReduceOp.SUM, group, "intra")
    g_micro = allreduce(grads.inputs, ReduceOp.SUM, group, "intra")
    np.testing.assert_allclose(float(loss[0]), float(oracle), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss[0]), float(jloss), rtol=LOSS_RTOL)
    for r in range(STAGES):
        np.testing.assert_allclose(g_head[r].numpy(), hv.grad.numpy(), **GRAD_TOL)
        np.testing.assert_allclose(g_micro[r].numpy(), mbs.grad.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(g_head[0].numpy(), np.asarray(jhead["v"]), **GRAD_TOL)
    np.testing.assert_allclose(g_micro[0].numpy(), np.asarray(jmicro), **GRAD_TOL)
    # real on one rank each, zeros elsewhere
    assert not grads.loss_params["v"][:STAGES - 1].any() and not grads.inputs[1:].any()
    check_stage_grads(grads.stage, [{k: v.grad.numpy() for k, v in s.items()} for s in leaves], group, "intra")
    check_stage_grads(grads.stage, [{k: np.asarray(jstage[k][s]) for k in ("w", "b")}
                                    for s in range(STAGES)], group, "intra")


def test_gpipe_remat_same_values():
    """``remat=True`` changes what autograd keeps, not the values: the
    gradients are the same bits (JAX: within rtol 1e-5)."""
    stages = [make_stage_params(60 + s) for s in range(STAGES)]
    micro, target = _data(61)
    group = pp_group("intra")

    def port(remat):
        params = t_stacked(stages, group, "intra")
        tp_.pipeline_loss(t_stage, params, every_rank(micro, group), every_rank(target, group), t_mse,
                          group, "intra", remat=remat).sum().backward()
        return {k: v.grad for k, v in params.items()}

    def jax_grads(remat):
        def local(p, mb):
            return jax.grad(lambda q: jp.pipeline_loss(j_stage, q, mb, jnp.asarray(target), j_mse,
                                                       axis_name="pp", remat=remat))(mine(p))

        return j_shard(local, (P("pp"), P()), P("pp"), j_stacked(stages), jnp.asarray(micro))

    a, b = port(False), port(True)
    for key in ("w", "b"):
        assert torch.equal(a[key], b[key]), key
    ja, jb = jax_grads(False), jax_grads(True)
    for key in ("w", "b"):
        np.testing.assert_allclose(np.asarray(ja[key]), np.asarray(jb[key]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(b[key].numpy(), np.asarray(jb[key]).reshape(b[key].shape), **GRAD_TOL)


def _interleaved_setup(V, seed_base, data_seed, n_micro=8):
    chunks = [make_stage_params(seed_base + j) for j in range(V * STAGES)]
    rng = np.random.RandomState(data_seed)
    micro = rng.randn(n_micro, MB, DIM).astype(np.float32)
    target = rng.randn(n_micro, MB, DIM).astype(np.float32)
    # rank r's chunks: [chunk r, chunk STAGES + r, ...]
    per_rank = [{k: np.stack([chunks[v * STAGES + r][k] for v in range(V)]) for k in ("w", "b")}
                for r in range(STAGES)]
    return chunks, micro, target, per_rank


def test_interleaved_matches_sequential_oracle():
    """V = 2 over 4 ranks equals the 8 global stages in order, loss and
    every chunk's gradient."""
    V = 2
    chunks, micro, target, per_rank = _interleaved_setup(V, 100, 3)
    want_loss, oracle = oracle_loss_and_grads(chunks, micro, target)

    def j_local(p, mb, tg):
        return jp.pipeline_loss_interleaved(j_stage, mine(p), mb, tg, j_mse, axis_name="pp")

    jloss, jgrads = j_shard(jax.value_and_grad(j_local), (P("pp"), P(), P()), (P(), P("pp")),
                            j_stacked(per_rank), jnp.asarray(micro), jnp.asarray(target))
    group = pp_group("intra")
    params = {k: torch.from_numpy(np.stack([p[k] for p in per_rank])).requires_grad_() for k in ("w", "b")}
    loss = tp_.pipeline_loss_interleaved(t_stage, params, every_rank(micro, group),
                                         every_rank(target, group), t_mse, group, "intra")
    np.testing.assert_allclose(loss.detach().numpy(), [want_loss] * STAGES, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss[0].detach()), float(jloss), rtol=LOSS_RTOL)
    loss.sum().backward()
    for r in range(STAGES):
        for v in range(V):
            np.testing.assert_allclose(params["w"].grad[r, v].numpy(), oracle[v * STAGES + r]["w"],
                                       rtol=2e-3, atol=2e-5)
            np.testing.assert_allclose(params["w"].grad[r, v].numpy(), np.asarray(jgrads["w"][r, v]),
                                       rtol=2e-3, atol=2e-5)


def test_interleaved_v1_equals_gpipe():
    """V = 1 is the GPipe schedule: the same bits in the port (JAX: within
    rtol 1e-6)."""
    stages = [make_stage_params(40 + s) for s in range(STAGES)]
    rng = np.random.RandomState(5)
    micro = rng.randn(8, MB, DIM).astype(np.float32)
    target = rng.randn(8, MB, DIM).astype(np.float32)
    group = pp_group("intra")
    params = t_stacked(stages, group, "intra", grad=False)
    args = (every_rank(micro, group), every_rank(target, group), t_mse, group, "intra")
    inter = tp_.pipeline_loss_interleaved(t_stage, tree_map(lambda p: p[:, None], params), *args)
    gpipe = tp_.pipeline_loss(t_stage, params, *args)
    assert torch.equal(inter, gpipe)

    def run(use_interleaved):
        def local(p, mb, tg):
            if use_interleaved:
                return jp.pipeline_loss_interleaved(j_stage, jax.tree.map(lambda q: q[None], mine(p)), mb,
                                                    tg, j_mse, axis_name="pp")
            return jp.pipeline_loss(j_stage, mine(p), mb, tg, j_mse, axis_name="pp")

        return float(j_shard(local, (P("pp"), P(), P()), P(), j_stacked(stages), jnp.asarray(micro),
                             jnp.asarray(target)))

    np.testing.assert_allclose(run(True), run(False), rtol=1e-6)
    np.testing.assert_allclose(float(inter[0]), run(True), rtol=LOSS_RTOL)


def test_interleaved_micro_divisibility():
    stages = [make_stage_params(60 + s) for s in range(STAGES)]
    group = pp_group("intra")
    params = tree_map(lambda p: p[:, None], t_stacked(stages, group, "intra", grad=False))
    zeros = torch.zeros((STAGES, 6, MB, DIM))  # 6 % 4 != 0
    with pytest.raises(ValueError, match="divisible"):
        tp_.pipeline_loss_interleaved(t_stage, params, zeros, zeros, t_mse, group, "intra")

    def local(p, mb, tg):
        return jp.pipeline_loss_interleaved(j_stage, jax.tree.map(lambda q: q[0][None], p), mb, tg, j_mse,
                                            axis_name="pp")

    with pytest.raises(ValueError, match="divisible"):
        j_shard(local, (P("pp"), P(), P()), P(), j_stacked(stages), jnp.zeros((6, MB, DIM)),
                jnp.zeros((6, MB, DIM)))


def test_1f1b_nonfinite_placeholder_grad_stays_finite():
    """A loss whose gradient is NaN at the zero placeholder an inactive tick
    feeds it (the norm, d|y|/dy = y / |y|): the schedule selects, never
    multiplies, so the gradients stay finite and equal the oracle's."""
    stages = [make_stage_params(80 + s) for s in range(STAGES)]
    micro, target = _data(81)

    def t_norm_loss(y, t):
        return torch.sqrt((y ** 2).sum(dim=(1, 2))) + t_mse(y, t)

    # at y = 0 its gradient is 0 / 0
    y0 = torch.zeros(1, MB, DIM, requires_grad=True)
    t_norm_loss(y0, torch.zeros(1, MB, DIM)).sum().backward()
    assert torch.isnan(y0.grad).all()

    want_loss, oracle = oracle_loss_and_grads(stages, micro, target, loss=t_norm_loss)
    group = pp_group("intra")
    loss, grads = tp_.pipeline_train_1f1b(t_stage, t_stacked(stages, group, "intra", grad=False),
                                          every_rank(micro, group), every_rank(target, group),
                                          t_norm_loss, group, "intra")
    assert all(torch.isfinite(g).all() for g in grads.values())
    np.testing.assert_allclose(loss.numpy(), [want_loss] * STAGES, rtol=LOSS_RTOL)
    check_stage_grads(grads, oracle, group, "intra")


def test_1f1b_keeps_no_graph_across_ticks():
    """Every tensor a stage call makes is freed by the next tick (no graph
    outlives its tick, and the forward keeps none), the results carry no
    graph, and with 4x the microbatches no more of them are alive at once."""
    stages = [make_stage_params(90 + s) for s in range(STAGES)]
    group = pp_group("intra")

    def run(n_micro):
        micro, target = _data(91, n_micro)
        made, peak = [], [0]

        def stage(params, x):
            h = x @ params["w"] + params["b"][:, None, :]
            y = torch.tanh(h)
            made.extend([weakref.ref(h), weakref.ref(y)])
            gc.collect()
            peak[0] = max(peak[0], sum(r() is not None for r in made))
            return y

        params = t_stacked(stages, group, "intra", grad=True)
        loss, grads = tp_.pipeline_train_1f1b(stage, params, every_rank(micro, group),
                                              every_rank(target, group), t_mse, group, "intra")
        assert loss.grad_fn is None and all(g.grad_fn is None for g in grads.values())
        assert all(p.grad is None for p in params.values())  # nothing accumulated into the leaves
        del loss, grads
        gc.collect()
        assert all(r() is None for r in made), "a stage call's tensor outlived the schedule"
        return peak[0]

    small, large = run(4), run(16)
    assert small == large and small <= 6, (small, large)
