"""The port's stale-sync (bounded-staleness gradient allreduce) against the
JAX package, on an 8-rank CPU group (``intra_size=4``).

The fixture is the JAX package's own (``tests/test_stale.py``): the MLP
[10, 8, 3], 32 samples a step from ``RandomState(seed)``, τ 2 with rank 2
under the directive.  Tolerances:

- the stage (``transform_gradients`` on the same gradients and state)
  bitwise against the JAX stage run rank by rank;
- engine runs within ``F32_TOL`` (rtol 1e-5, atol 1e-6) of the JAX
  engine's: the two backwards sum their products in other orders;
- the numpy oracle of the replay algebra within the reference's rtol 2e-4,
  atol 1e-5;
- τ=0 bitwise the port's ``gradient_allreduce`` (with overlap), as the
  reference pins it against its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from bagua_tpu.algorithms.base import StepContext as JaxStepContext
from bagua_tpu.algorithms.gradient_allreduce import GradientAllReduceAlgorithm as JaxGradientAllReduce
from bagua_tpu.algorithms.stale import StaleSyncAlgorithm as JaxStale
from bagua_tpu.communication import ALL_AXES
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP
from bagua_tpu.models import mlp as jax_mlp

from bagua_tpu_torch.algorithms import GradientAllReduceAlgorithm, StaleSyncAlgorithm, build_algorithm
from bagua_tpu_torch.algorithms.base import StepContext
from bagua_tpu_torch.bucket import BucketPlan
from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.models import mlp
from bagua_tpu_torch.utils import tree_leaves

N = 8
N_STEPS = 6
LR = 0.05
DIM_IN, DIM_OUT = 10, 3
TAU = 2
STALE_RANK = 2
F32_TOL = dict(rtol=1e-5, atol=1e-6)
ORACLE_TOL = dict(rtol=2e-4, atol=1e-5)


@pytest.fixture()
def tgroup():
    return BaguaProcessGroup([torch.device("cpu")] * N, intra_size=4)


def make_problem(seed=0):
    params = jax.tree.map(np.asarray, jax_mlp.init_mlp(jax.random.PRNGKey(seed), [DIM_IN, 8, DIM_OUT]))
    rng = np.random.RandomState(seed)
    xs = rng.randn(N_STEPS, N * 4, DIM_IN).astype(np.float32)
    ys = rng.randn(N_STEPS, N * 4, DIM_OUT).astype(np.float32)
    return params, xs, ys


def port_ddp(tgroup, tau=0, overlap=False, lr=LR, momentum=0.0, bucket=1 << 62, algo=None):
    return DistributedDataParallel(
        mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=lr, momentum=momentum),
        algo or StaleSyncAlgorithm(staleness_tau=tau), tgroup, bucket_size_bytes=bucket, overlap=overlap)


def jax_ddp(group, tau=0, lr=LR, bucket=1 << 62):
    return JaxDDP(jax_mlp.mse_loss, optax.sgd(lr), JaxStale(staleness_tau=tau), process_group=group,
                  bucket_size_bytes=bucket, overlap=False)


def tbatch(xs, ys, i):
    return torch.from_numpy(xs[i]), torch.from_numpy(ys[i])


def counters(state):
    return np.asarray(state.algo_state["staleness"])


def test_stale_tau0_bitwise_matches_gradient_allreduce(tgroup):
    """τ=0 is off: the port's stale run equals its ``gradient_allreduce``
    run with overlap on, bit for bit, after 6 steps of SGD momentum."""
    params, xs, ys = make_problem(seed=11)

    def run(algo):
        ddp = DistributedDataParallel(mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
                                      algo, tgroup, bucket_size_bytes=1 << 12, overlap="auto")
        state = ddp.init(params_from_jax(params))
        for i in range(N_STEPS):
            state, _ = ddp.train_step(state, tbatch(xs, ys, i))
        assert ddp.overlap_enabled
        return tree_leaves(state.params)

    got = run(StaleSyncAlgorithm(staleness_tau=0))
    ref = run(build_algorithm("gradient_allreduce"))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _stage_inputs(seed):
    """Per-rank flat gradients and a replay state where every rank differs:
    the stacked numpy arrays and the plan of one bucket."""
    params, _, _ = make_problem(seed)
    rng = np.random.RandomState(seed + 100)
    tparams = params_from_jax(params)
    plan = BucketPlan.from_tree(tparams, 1 << 62, align_elems=N)
    numel = plan.specs[0].numel
    grads = jax.tree.map(lambda a: rng.randn(N, *a.shape).astype(np.float32), params)
    stale = rng.randn(N, numel).astype(np.float32)
    resid = (0.1 * rng.randn(N, numel)).astype(np.float32)
    staleness = np.array([0, 1, 2, 0, 3, 1, 0, 2], np.int32)
    directive = np.array([1, 1, 1, 0, 1, 0, 0, 1], np.int32)
    return params, plan, grads, stale, resid, staleness, directive


@pytest.mark.parametrize("hierarchical", [False, True], ids=["flat", "hier"])
def test_stale_stage_matches_jax_bitwise(group, tgroup, hierarchical):
    """``transform_gradients`` at τ 2 on the same gradients and replay
    state (ranks replaying, fresh, at and past the bound): the gradients,
    ``stale``, ``residual`` and the counters, bit for bit."""
    params, plan, grads, stale, resid, staleness, directive = _stage_inputs(3 + hierarchical)
    jimpl = JaxStale(staleness_tau=TAU, hierarchical=hierarchical).reify(group)
    jplan = jimpl.tensors_to_buckets(params, 1 << 62)
    jimpl.bind_plan(jplan)

    def body(*a):
        g = jax.tree.unflatten(treedef, a[:-4])
        st = {"stale": (a[-4],), "residual": (a[-3],), "staleness": a[-2], "directive": a[-1]}
        ctx = JaxStepContext(group=group, step=jnp.int32(0), plan=jplan)
        g2, _, st2 = jimpl.transform_gradients(g, params, st, ctx)
        return g2, st2["stale"][0], st2["residual"][0], st2["staleness"]

    leaves, treedef = jax.tree.flatten(grads)
    f = jax.jit(group.shard_map(lambda *v: jax.tree.map(lambda t: t[None], body(*[x[0] for x in v])),
                                in_specs=P(ALL_AXES), out_specs=P(ALL_AXES)))
    jout = jax.tree.map(np.asarray, f(*[jnp.asarray(x) for x in (*leaves, stale, resid, staleness, directive)]))

    impl = StaleSyncAlgorithm(staleness_tau=TAU, hierarchical=hierarchical).reify(tgroup)
    impl.bind_plan(plan)
    state = {"stale": (torch.from_numpy(stale),), "residual": (torch.from_numpy(resid),),
             "staleness": torch.from_numpy(staleness), "directive": torch.from_numpy(directive)}
    g2, _, st2 = impl.transform_gradients(params_from_jax(grads), None, state, StepContext(tgroup, 0, plan))
    for got, want in zip(tree_leaves(g2), jax.tree.leaves(jout[0])):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(st2["stale"][0].numpy(), jout[1])
    np.testing.assert_array_equal(st2["residual"][0].numpy(), jout[2])
    np.testing.assert_array_equal(st2["staleness"].numpy(), jout[3])
    np.testing.assert_array_equal(st2["staleness"].numpy(), [1, 2, 0, 0, 0, 0, 0, 0])


def test_stale_replay_matches_jax_and_oracle(group, tgroup):
    """τ=2 with rank 2 under a directive from step 0: every rank's
    parameters within F32_TOL of the JAX engine's, and within the
    reference's tolerance of the replay algebra in numpy (the init-zero
    payload on the first stale round included); the counters agree."""
    params, xs, ys = make_problem(seed=1)
    jddp = jax_ddp(group, tau=TAU)
    jstate = jddp.apply_degradation_directive(jddp.init(params), (STALE_RANK,))
    ddp = port_ddp(tgroup, tau=TAU)
    state = ddp.apply_degradation_directive(ddp.init(params_from_jax(params)), (STALE_RANK,))
    for i in range(N_STEPS):
        jstate, _ = jddp.train_step(jstate, (jnp.asarray(xs[i]), jnp.asarray(ys[i])))
        state, _ = ddp.train_step(state, tbatch(xs, ys, i))
    for got, want in zip(tree_leaves(state.params), jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_array_equal(counters(state), np.asarray(jstate.algo_state["staleness"]))

    # the numpy oracle on the flat bucket
    tparams = params_from_jax(params)
    plan = BucketPlan.from_tree(tparams, 1 << 62, align_elems=N)

    def grad(flat, x, y):
        p = {k: {kk: vv.detach().requires_grad_(True) for kk, vv in v.items()}
             for k, v in plan.debucketize([torch.from_numpy(flat)]).items()}
        mlp.mse_loss(p, (torch.from_numpy(x), torch.from_numpy(y))).backward()
        return plan.bucketize({k: {kk: vv.grad for kk, vv in v.items()} for k, v in p.items()})[0].numpy()

    w = plan.bucketize(tparams)[0].numpy().astype(np.float64)
    stale = np.zeros((N, w.shape[0]))
    resid = np.zeros((N, w.shape[0]))
    cnt = np.zeros(N, np.int64)
    for step in range(N_STEPS):
        x, y = xs[step].reshape(N, -1, DIM_IN), ys[step].reshape(N, -1, DIM_OUT)
        g = np.stack([grad(w.astype(np.float32), x[r], y[r]) for r in range(N)]).astype(np.float64)
        contrib = np.empty_like(g)
        for r in range(N):
            use = r == STALE_RANK and cnt[r] < TAU
            contrib[r] = stale[r] if use else g[r] + resid[r]
            if not use:
                stale[r] = g[r]
            cnt[r] = cnt[r] + 1 if use else 0
        resid = resid + g - contrib
        w = w - LR * contrib.mean(axis=0)
    got = ddp.plan.bucketize(ddp.params_unstacked(state, 0))[0].numpy()
    np.testing.assert_allclose(got, w, **ORACLE_TOL)
    assert counters(state)[STALE_RANK] == cnt[STALE_RANK]


def test_staleness_bound_forces_fresh_exchange(group, tgroup):
    """A rank held under a directive forever still exchanges every τ+1
    rounds: its counter cycles 1, 2, 0, ... as the JAX engine's does, the
    other ranks' stay 0."""
    params, xs, ys = make_problem(seed=2)
    jddp = jax_ddp(group, tau=TAU)
    jstate = jddp.apply_degradation_directive(jddp.init(params), (STALE_RANK,))
    ddp = port_ddp(tgroup, tau=TAU)
    state = ddp.apply_degradation_directive(ddp.init(params_from_jax(params)), (STALE_RANK,))
    seen, jseen = [], []
    for step in range(7):
        i = step % N_STEPS
        state, _ = ddp.train_step(state, tbatch(xs, ys, i))
        jstate, _ = jddp.train_step(jstate, (jnp.asarray(xs[i]), jnp.asarray(ys[i])))
        c = counters(state)
        seen.append(int(c[STALE_RANK]))
        jseen.append(int(np.asarray(jstate.algo_state["staleness"])[STALE_RANK]))
        assert c[STALE_RANK] <= TAU and (np.delete(c, STALE_RANK) == 0).all(), c
    assert seen == jseen == [1, 2, 0, 1, 2, 0, 1]


def test_directive_flip_swaps_the_leaf_only(tgroup):
    """The directive is a ``(size,)`` int32 tensor of the state: a flip
    returns a state whose other tensors are the very same objects."""
    params, xs, ys = make_problem(seed=3)
    ddp = port_ddp(tgroup, tau=TAU)
    state, _ = ddp.train_step(ddp.init(params_from_jax(params)), tbatch(xs, ys, 0))
    flipped = ddp.apply_degradation_directive(state, (STALE_RANK, 5))
    assert flipped.optimizer is state.optimizer and flipped.step == state.step
    assert all(a is b for a, b in zip(tree_leaves(flipped.params), tree_leaves(state.params)))
    for key in ("stale", "residual", "staleness"):
        assert all(a is b for a, b in zip(tree_leaves(flipped.algo_state[key]), tree_leaves(state.algo_state[key])))
    d = flipped.algo_state["directive"]
    assert d.dtype == torch.int32 and d.tolist() == [0, 0, 1, 0, 0, 1, 0, 0]
    cleared = ddp.apply_degradation_directive(flipped, ())
    assert cleared.algo_state["directive"].tolist() == [0] * N
    cleared, _ = ddp.train_step(cleared, tbatch(xs, ys, 1))
    assert (counters(cleared) == 0).all()


def _error(fn):
    with pytest.raises(Exception) as info:
        fn()
    return info.type, str(info.value)


def test_directive_validates_ranks_and_knob(group, tgroup):
    """The same exceptions, with the same messages, as the JAX engine."""
    params, _, _ = make_problem(seed=4)
    ddp, jddp = port_ddp(tgroup, tau=TAU), jax_ddp(group, tau=TAU)
    state, jstate = ddp.init(params_from_jax(params)), jddp.init(params)
    assert _error(lambda: ddp.apply_degradation_directive(state, (N,))) == \
        _error(lambda: jddp.apply_degradation_directive(jstate, (N,))) == (ValueError, f"rank {N} out of range "
                                                                          f"for world size {N}")
    plain = port_ddp(tgroup, algo=GradientAllReduceAlgorithm())
    jplain = JaxDDP(jax_mlp.mse_loss, optax.sgd(LR), JaxGradientAllReduce(), process_group=group)
    pstate, jpstate = plain.init(params_from_jax(params)), jplain.init(params)
    for call in (lambda d, s: d.apply_degradation_directive(s, (0,)),
                 lambda d, s: d.apply_staleness(2, reason="planner"),
                 lambda d, s: d.reset_staleness_state(s)):
        got, want = _error(lambda: call(plain, pstate)), _error(lambda: call(jplain, jpstate))
        assert got[0] is want[0] is AttributeError and "no staleness knob" in got[1]
        assert got == want
    with pytest.raises(ValueError, match="switch reason"):
        ddp.apply_staleness(1, reason="operator")


def test_apply_staleness_switch(tgroup):
    """τ 0 -> 2: True, then False for the same τ; a negative τ raises; the
    plan's source follows the reason; the next steps run the new gate."""
    params, xs, ys = make_problem(seed=5)
    ddp = port_ddp(tgroup, tau=0)
    state = ddp.apply_degradation_directive(ddp.init(params_from_jax(params)), (STALE_RANK,))
    state, _ = ddp.train_step(state, tbatch(xs, ys, 0))
    assert (counters(state) == 0).all()  # τ=0: the state passes untouched
    assert ddp.apply_staleness(TAU, reason="health:straggler") is True
    assert ddp.impl.staleness_tau == TAU and ddp._plan_source == "health"
    assert ddp.apply_staleness(TAU, reason="planner") is False
    with pytest.raises(ValueError, match=">= 0"):
        ddp.apply_staleness(-1, reason="planner")
    state, _ = ddp.train_step(state, tbatch(xs, ys, 1))
    assert counters(state)[STALE_RANK] == 1


def test_reset_staleness_state_reprimes_replay(group, tgroup):
    """After a reset every counter is τ and every residual zero, as in the
    JAX engine; the next round is fresh."""
    params, xs, ys = make_problem(seed=6)
    ddp = port_ddp(tgroup, tau=TAU)
    state = ddp.apply_degradation_directive(ddp.init(params_from_jax(params)), (STALE_RANK,))
    for i in range(2):
        state, _ = ddp.train_step(state, tbatch(xs, ys, i))
    assert counters(state)[STALE_RANK] == 2
    assert state.algo_state["residual"][0].abs().max() > 0, "stale rounds must accrue residual"
    state = ddp.reset_staleness_state(state)
    assert (counters(state) == TAU).all() and counters(state).dtype == np.int32
    assert all(float(leaf.abs().max()) == 0 for leaf in state.algo_state["residual"])
    jddp = jax_ddp(group, tau=TAU)
    jstate = jddp.reset_staleness_state(jddp.init(params))
    np.testing.assert_array_equal(counters(state), np.asarray(jstate.algo_state["staleness"]))
    state, _ = ddp.train_step(state, tbatch(xs, ys, 2))
    assert counters(state)[STALE_RANK] == 0


def test_stale_refuses_wire_quantization(group, tgroup):
    impl, jimpl = StaleSyncAlgorithm(staleness_tau=TAU).reify(tgroup), JaxStale(staleness_tau=TAU).reify(group)
    assert _error(lambda: impl.set_bucket_precision(["int8"])) == \
        _error(lambda: jimpl.set_bucket_precision(["int8"]))
    assert _error(lambda: StaleSyncAlgorithm(staleness_tau=-1).reify(tgroup)) == \
        _error(lambda: JaxStale(staleness_tau=-1).reify(group))


def test_stale_overlap_is_the_monolithic_exchange(tgroup):
    """Overlap (``post_step``, taken by ``auto``) runs the monolithic stage
    on the multi-bucket plan: bit for bit the monolithic run; ``rebucket``
    refuses the replicas' layout."""
    params, xs, ys = make_problem(seed=9)

    def run(overlap):
        ddp = port_ddp(tgroup, tau=TAU, overlap=overlap, bucket=1 << 7)
        state = ddp.apply_degradation_directive(ddp.init(params_from_jax(params)), (STALE_RANK,))
        for i in range(N_STEPS):
            state, _ = ddp.train_step(state, tbatch(xs, ys, i))
        return ddp, state

    mono, mstate = run(False)
    ov, ostate = run("auto")
    cap = ov.impl.overlap_capability()
    assert ov.overlap_enabled and cap.mode == "post_step" and cap.auto and ov.plan.num_buckets > 1
    assert ov.exchange_counts == [0] * ov.plan.num_buckets
    for a, b in zip(tree_leaves(mstate.params), tree_leaves(ostate.params)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="keeps per-bucket state"):
        ov.rebucket(ov.plan)


def test_stale_convergence_tracks_bulk_sync(tgroup):
    """Bounded staleness stays a relaxation: τ=2 with one rank under the
    directive takes the loss down an order of magnitude and lands within 5%
    of bulk sync's final loss (the reference's bounds)."""
    params, _, _ = make_problem(seed=7)
    rng = np.random.RandomState(7)
    x = rng.randn(N * 4, DIM_IN).astype(np.float32)
    w_true = rng.randn(DIM_IN, DIM_OUT).astype(np.float32)
    batch = (torch.from_numpy(x), torch.from_numpy(x @ w_true))

    def run(tau, directive):
        ddp = port_ddp(tgroup, tau=tau, lr=0.02, bucket=None)
        state = ddp.init(params_from_jax(params))
        if directive:
            state = ddp.apply_degradation_directive(state, directive)
        losses = []
        for _ in range(40):
            state, loss = ddp.train_step(state, batch)
            losses.append(float(loss.mean()))
        return losses

    bulk, stale = run(0, ()), run(TAU, (STALE_RANK,))
    assert stale[-1] < 0.5 * stale[0], "stale-sync did not converge"
    assert abs(stale[-1] - bulk[-1]) < 0.05 * bulk[-1], (stale[-1], bulk[-1])
