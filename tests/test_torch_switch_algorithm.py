"""The port's ``switch_algorithm`` (moving a live run between
``gradient_allreduce``, ``zero`` and ``bytegrad``) against the JAX package,
on an 8-rank CPU group (``intra_size=4``).

The fixture is the JAX package's own (``tests/test_switch_algorithm.py``):
the MLP [10, 16, 4], 512-byte buckets, Adam at 1e-2, 16 samples a step from
``RandomState(seed)``, the switch after 3 steps, overlap on.  The
continuation contract: after a switch the run is bit for bit a fresh engine
of the new configuration started from the switched state; f32 ZeRO is bit
for bit the unsharded engine (``tests/test_torch_zero.py``), so a switch to
ZeRO also continues bitwise a run that never left ``gradient_allreduce``.
Against the JAX engine's switched run: losses and parameters within
``F32_TOL`` (rtol 1e-5, atol 1e-6).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bagua_tpu.algorithms.gradient_allreduce import GradientAllReduceAlgorithm as JaxGradientAllReduce
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP
from bagua_tpu.models import mlp as jax_mlp

from bagua_tpu_torch.algorithms import ByteGradAlgorithmImpl, GradientAllReduceAlgorithm, StaleSyncAlgorithm
from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.models import mlp
from bagua_tpu_torch.sharded import ZeroAlgorithm
from bagua_tpu_torch.sharded.updater import ShardedOptState
from bagua_tpu_torch.utils import tree_leaves

N = 8
LAYERS = [10, 16, 4]
STEPS = 8
SWITCH_AT = 3
BUCKET = 1 << 9
F32_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture()
def tgroup():
    return BaguaProcessGroup([torch.device("cpu")] * N, intra_size=4)


def jax_params(seed):
    return jax.tree.map(np.asarray, jax_mlp.init_mlp(jax.random.PRNGKey(seed), LAYERS))


def batches(steps=STEPS, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(16, LAYERS[0]).astype(np.float32), rng.randn(16, LAYERS[-1]).astype(np.float32))
            for _ in range(steps)]


def make(tgroup, algo, overlap=True):
    return DistributedDataParallel(mlp.mse_loss, lambda ps: torch.optim.Adam(ps, lr=1e-2), algo, tgroup,
                                   bucket_size_bytes=BUCKET, overlap=overlap)


def tb(b):
    return torch.from_numpy(b[0]), torch.from_numpy(b[1])


def fork(state):
    """A deep copy: the optimizer updates the parameters in place, so two
    engines continuing from one state each need their own (the copy keeps
    ZeRO's pending shards views of the copied rows)."""
    return copy.deepcopy(state)


def params_equal(a, b):
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)


def ranks_synchronized(state):
    for leaf in tree_leaves(state.params):
        assert all(torch.equal(leaf[0], leaf[r]) for r in range(1, N))


def fresh_like(tgroup, ddp, algo, seed):
    """A fresh engine of ``algo`` on ``ddp``'s exported plan."""
    fresh = make(tgroup, algo)
    fresh.init(params_from_jax(jax_params(seed)))
    assert fresh.adopt_plan_payload(ddp.export_plan_payload())
    fresh.clear_pending_reshard()
    return fresh


def test_switch_gar_zero_gar_losses_match_uninterrupted(group, tgroup):
    """gradient_allreduce -> zero -> gradient_allreduce with overlap on:
    the zero leg's losses equal a fresh zero engine's from the switch point
    bit for bit, the ranks stay equal, and every loss and the final
    parameters are within F32_TOL of the JAX engine's same round trip."""
    data = batches()
    ddp = make(tgroup, GradientAllReduceAlgorithm())
    state = ddp.init(params_from_jax(jax_params(0)))
    jddp = JaxDDP(jax_mlp.mse_loss, optax.adam(1e-2), JaxGradientAllReduce(), process_group=group,
                  bucket_size_bytes=BUCKET, overlap=True)
    jstate = jddp.init(jax_params(0))
    losses, jlosses = [], []

    def step(b):
        nonlocal state, jstate
        state, loss = ddp.train_step(state, tb(b))
        jstate, jloss = jddp.train_step(jstate, (jnp.asarray(b[0]), jnp.asarray(b[1])))
        losses.append(loss)
        jlosses.append(np.asarray(jloss))
        return loss

    for b in data[:SWITCH_AT]:
        step(b)
    state = ddp.switch_algorithm(state, "zero", reason="manual")
    jstate = jddp.switch_algorithm(jstate, "zero", reason="manual")
    assert ddp.impl.algo_name == "zero" and ddp._plan_source == "manual" and ddp.overlap_enabled
    ref = fresh_like(tgroup, ddp, ZeroAlgorithm(), 0)
    ref_state = fork(state)
    for b in data[SWITCH_AT:6]:
        loss = step(b)
        ref_state, rloss = ref.train_step(ref_state, tb(b))
        assert torch.equal(loss, rloss)
    params_equal(ddp.finalize_pending_updates(state), ref.finalize_pending_updates(ref_state))

    state = ddp.switch_algorithm(state, "gradient_allreduce", reason="planner")
    jstate = jddp.switch_algorithm(jstate, "gradient_allreduce", reason="planner")
    assert ddp.impl.algo_name == "gradient_allreduce" and ddp._sharded_updater is None
    for b in data[6:]:
        step(b)
    assert len(losses) == STEPS and state.step == STEPS
    assert all(torch.isfinite(loss).all() for loss in losses)
    ranks_synchronized(state)
    for got, want in zip(losses, jlosses):
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    for got, want in zip(tree_leaves(state.params), jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    ddp.shutdown()


def test_switch_to_zero_continuation_bitwise(tgroup):
    """gradient_allreduce -> zero after 3 steps: step for step the losses
    of a fresh zero engine fed the switched state, and at the end the
    parameters of a run that stayed on ``gradient_allreduce``, bit for bit:
    the scatter of Adam's state and the seeding of the rows and pending
    shards change no value."""
    data = batches(seed=3)
    ddp, stay = make(tgroup, GradientAllReduceAlgorithm()), make(tgroup, GradientAllReduceAlgorithm())
    state = ddp.init(params_from_jax(jax_params(1)))
    sstate = stay.init(params_from_jax(jax_params(1)))
    for b in data[:SWITCH_AT]:
        state, _ = ddp.train_step(state, tb(b))
        sstate, _ = stay.train_step(sstate, tb(b))
    state = ddp.switch_algorithm(state, "zero", reason="manual")
    assert isinstance(state.optimizer, ShardedOptState)
    fresh = fresh_like(tgroup, ddp, ZeroAlgorithm(), 1)
    fresh_state = fork(state)
    for b in data[SWITCH_AT:]:
        state, loss = ddp.train_step(state, tb(b))
        fresh_state, floss = fresh.train_step(fresh_state, tb(b))
        sstate, sloss = stay.train_step(sstate, tb(b))
        assert torch.equal(loss, floss) and torch.equal(loss, sloss)
    state = ddp.finalize_pending_updates(state)
    params_equal(state, fresh.finalize_pending_updates(fresh_state))
    params_equal(state, sstate)


def test_switch_from_zero_drains_pending(tgroup):
    """zero -> gradient_allreduce: the pending all-gather is finalized into
    the parameters before the remap, Adam's state is gathered whole (the
    optimizer state per rank back to N times ZeRO's), and the run goes on
    bitwise as one that never left ``gradient_allreduce``."""
    data = batches(seed=4)
    ddp, stay = make(tgroup, ZeroAlgorithm()), make(tgroup, GradientAllReduceAlgorithm())
    state = ddp.init(params_from_jax(jax_params(2)))
    sstate = stay.init(params_from_jax(jax_params(2)))
    for b in data[:SWITCH_AT]:
        state, _ = ddp.train_step(state, tb(b))
        sstate, _ = stay.train_step(sstate, tb(b))
    sharded_bytes = ddp.optimizer_state_bytes(state)
    expect = [t.clone() for t in tree_leaves(ddp.finalize_pending_updates(state).params)]
    version = ddp.plan_version
    state = ddp.switch_algorithm(state, "gradient_allreduce", reason="manual")
    assert ddp.plan_version == version + 1 and isinstance(state.optimizer, torch.optim.Adam)
    assert all(torch.equal(a, b) for a, b in zip(expect, tree_leaves(state.params)))
    held = [p for g in state.optimizer.param_groups for p in g["params"]]
    assert all(a is b for a, b in zip(held, tree_leaves(state.params)))
    full_bytes = ddp.optimizer_state_bytes(state)
    assert full_bytes == stay.optimizer_state_bytes(sstate) > sharded_bytes
    for b in data[SWITCH_AT:]:
        state, loss = ddp.train_step(state, tb(b))
        sstate, sloss = stay.train_step(sstate, tb(b))
        assert torch.equal(loss, sloss)
    params_equal(state, sstate)
    ranks_synchronized(state)


def test_switch_to_bytegrad_continues_fresh(tgroup):
    """gradient_allreduce -> bytegrad: residual-free, the optimizer rebuilt
    over the same tensors with the same state; the run equals a fresh
    ByteGrad engine's from the switched state, bit for bit."""
    data = batches(seed=5)
    ddp = make(tgroup, GradientAllReduceAlgorithm())
    state = ddp.init(params_from_jax(jax_params(3)))
    for b in data[:SWITCH_AT]:
        state, _ = ddp.train_step(state, tb(b))
    old_opt = state.optimizer
    state = ddp.switch_algorithm(state, "bytegrad", reason="manual", hierarchical=False)
    assert ddp.impl.algo_name == "bytegrad" and not ddp.impl.hierarchical
    assert state.optimizer is not old_opt and state.algo_state == ()
    fresh = make(tgroup, ByteGradAlgorithmImpl(tgroup, hierarchical=False))
    fresh.init(params_from_jax(jax_params(3)))
    fresh_state = fork(state)
    for b in data[SWITCH_AT:]:
        state, loss = ddp.train_step(state, tb(b))
        fresh_state, floss = fresh.train_step(fresh_state, tb(b))
        assert torch.equal(loss, floss)
    params_equal(state, fresh_state)
    ranks_synchronized(state)


def _error(fn):
    with pytest.raises(Exception) as info:
        fn()
    return info.type, str(info.value)


def test_switch_algorithm_guards(group, tgroup):
    """The guards raise what the JAX engine raises, with its messages; a
    switch to the running algorithm returns the same state object and
    keeps the plan version."""
    b = batches(1)[0]
    ddp = make(tgroup, GradientAllReduceAlgorithm())
    state, _ = ddp.train_step(ddp.init(params_from_jax(jax_params(4))), tb(b))
    jddp = JaxDDP(jax_mlp.mse_loss, optax.adam(1e-2), JaxGradientAllReduce(), process_group=group,
                  bucket_size_bytes=BUCKET, overlap=True)
    jstate, _ = jddp.train_step(jddp.init(jax_params(4)), (jnp.asarray(b[0]), jnp.asarray(b[1])))
    for target, reason in (("decentralized", "manual"), ("nonexistent_algo", "manual"), ("zero", "operator")):
        got = _error(lambda: ddp.switch_algorithm(state, target, reason=reason))
        assert got == _error(lambda: jddp.switch_algorithm(jstate, target, reason=reason)), got
    version = ddp.plan_version
    assert ddp.switch_algorithm(state, "gradient_allreduce", reason="manual") is state
    assert ddp.plan_version == version
    unset = make(tgroup, GradientAllReduceAlgorithm())
    with pytest.raises(ValueError, match="call init"):
        unset.switch_algorithm(state, "zero")
    off = make(tgroup, StaleSyncAlgorithm(staleness_tau=1))
    off.init(params_from_jax(jax_params(4)))
    with pytest.raises(ValueError, match="cannot switch a live gang OFF 'stale'"):
        off.switch_algorithm(state, "zero")


class _Failing(ByteGradAlgorithmImpl):
    """A switch target whose state cannot be built."""

    def init_state(self, params):
        raise RuntimeError("the target's state failed to build")


@pytest.mark.parametrize("source", ["gradient_allreduce", "zero"])
def test_switch_rolls_back_on_failing_target(tgroup, source):
    """A target that fails mid-switch leaves the engine on its previous
    algorithm, plan, updater and overlap knob (the plan version bumped, a
    version names one configuration), and the caller's state steps on as
    if nothing had happened."""
    data = batches(seed=9)
    algo = GradientAllReduceAlgorithm() if source == "gradient_allreduce" else ZeroAlgorithm()
    ddp, twin = make(tgroup, algo), make(tgroup, type(algo)())
    state = ddp.init(params_from_jax(jax_params(5)))
    tstate = twin.init(params_from_jax(jax_params(5)))
    state, _ = ddp.train_step(state, tb(data[0]))
    tstate, _ = twin.train_step(tstate, tb(data[0]))
    before = (ddp.impl, ddp.plan, ddp._sharded_updater, ddp.overlap, ddp.plan_version, ddp.exchange_counts)
    with pytest.raises(RuntimeError, match="failed to build"):
        ddp.switch_algorithm(state, _Failing(tgroup), reason="manual")
    assert (ddp.impl, ddp.plan, ddp._sharded_updater, ddp.overlap) == before[:4]
    assert ddp.plan_version == before[4] + 1 and ddp.exchange_counts is before[5]
    assert ddp.impl._bound_plan is ddp.plan and ddp.impl.overlap_hint == ddp.overlap_enabled
    for b in data[1:4]:
        state, loss = ddp.train_step(state, tb(b))
        tstate, tloss = twin.train_step(tstate, tb(b))
        assert torch.equal(loss, tloss)
    params_equal(ddp.finalize_pending_updates(state), twin.finalize_pending_updates(tstate))
