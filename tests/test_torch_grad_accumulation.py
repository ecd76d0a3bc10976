"""The port's gradient accumulation (``GradientAccumulation``, the
``no_sync`` analog) against the JAX package, on an 8-rank CPU group
(``intra_size=4``).

The fixture is the JAX package's own (``tests/test_grad_accumulation.py``):
the MLP [10, 16, 4], batches from ``RandomState(seed)``.  Tolerances: the
stage bitwise against the JAX stage run rank by rank; engine runs within
``F32_TOL`` (rtol 1e-5, atol 1e-6) of the JAX engine's; accumulation over
half batches against the full batches within the reference's rtol 2e-4,
atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from bagua_tpu.algorithms import Algorithm as JaxAlgorithm
from bagua_tpu.algorithms import GradientAccumulation as JaxGradientAccumulation
from bagua_tpu.algorithms.base import StepContext as JaxStepContext
from bagua_tpu.communication import ALL_AXES
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP
from bagua_tpu.models import mlp as jax_mlp

from bagua_tpu_torch.algorithms import (
    Algorithm,
    AlgorithmImpl,
    GradientAccumulation,
    GradientAccumulationImpl,
    build_algorithm,
)
from bagua_tpu_torch.algorithms.base import StepContext
from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.models import mlp
from bagua_tpu_torch.utils import tree_leaves

N = 8
LAYERS = [10, 16, 4]
F32_TOL = dict(rtol=1e-5, atol=1e-6)
CONCAT_TOL = dict(rtol=2e-4, atol=1e-6)


@pytest.fixture()
def tgroup():
    return BaguaProcessGroup([torch.device("cpu")] * N, intra_size=4)


def jax_params(seed):
    return jax.tree.map(np.asarray, jax_mlp.init_mlp(jax.random.PRNGKey(seed), LAYERS))


def batches(rng, n, rows):
    return [(rng.randn(rows, 10).astype(np.float32), rng.randn(rows, 4).astype(np.float32)) for _ in range(n)]


def adam(ps):
    return torch.optim.Adam(ps, lr=1e-2)


def run_port(tgroup, algo, params, data, optimizer=adam):
    ddp = DistributedDataParallel(mlp.mse_loss, optimizer, algo, tgroup)
    state = ddp.init(params_from_jax(params))
    for x, y in data:
        state, _ = ddp.train_step(state, (torch.from_numpy(x), torch.from_numpy(y)))
    return ddp, state


def test_accumulation_matches_concatenated_batches(group, tgroup):
    """every=2 over half batches against ``gradient_allreduce`` over the
    full batches (a mean loss: the accumulated mean is the full batch's
    gradient), Adam; and against the JAX engine's accumulation."""
    params = jax_params(0)
    full = batches(np.random.RandomState(0), 4, 32)
    halves = [h for x, y in full for h in ((x[:16], y[:16]), (x[16:], y[16:]))]
    _, ref = run_port(tgroup, build_algorithm("gradient_allreduce"), params, full)
    _, acc = run_port(tgroup, GradientAccumulation(build_algorithm("gradient_allreduce"), every=2), params, halves)
    jddp = JaxDDP(jax_mlp.mse_loss, optax.adam(1e-2),
                  JaxGradientAccumulation(JaxAlgorithm.init("gradient_allreduce"), every=2), process_group=group)
    jstate = jddp.init(params)
    for x, y in halves:
        jstate, _ = jddp.train_step(jstate, (jnp.asarray(x), jnp.asarray(y)))
    assert acc.step == 8
    for a, b, c in zip(tree_leaves(ref.params), tree_leaves(acc.params), jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **CONCAT_TOL)
        np.testing.assert_allclose(b.numpy(), np.asarray(c), **F32_TOL)


@pytest.mark.parametrize("boundary", [False, True], ids=["hold", "flush"])
def test_accumulation_stage_matches_jax_bitwise(group, tgroup, boundary):
    """``transform_gradients`` of ``GradientAccumulation(gradient_allreduce,
    every=3)`` on the same accumulator and gradients, off the boundary
    (step 0) and on it (step 2): the accumulator and, on the boundary, the
    exchanged mean, bit for bit."""
    params = jax_params(3)
    rng = np.random.RandomState(4)
    grads = jax.tree.map(lambda a: rng.randn(N, *a.shape).astype(np.float32), params)
    acc = jax.tree.map(lambda a: rng.randn(N, *a.shape).astype(np.float32), params)
    step = 2 if boundary else 0
    jimpl = JaxGradientAccumulation(JaxAlgorithm.init("gradient_allreduce"), every=3).reify(group)
    jplan = jimpl.tensors_to_buckets(params)
    jimpl.bind_plan(jplan)
    gl, treedef = jax.tree.flatten(grads)
    al = jax.tree.leaves(acc)
    k = len(gl)

    def body(*a):
        st = {"acc": jax.tree.unflatten(treedef, a[k:]), "inner": {}}
        ctx = JaxStepContext(group=group, step=jnp.int32(step), plan=jplan)
        g2, _, st2 = jimpl.transform_gradients(jax.tree.unflatten(treedef, a[:k]), params, st, ctx)
        return g2, st2["acc"]

    f = jax.jit(group.shard_map(lambda *v: jax.tree.map(lambda t: t[None], body(*[x[0] for x in v])),
                                in_specs=P(ALL_AXES), out_specs=P(ALL_AXES)))
    jg, jacc = jax.tree.map(np.asarray, f(*[jnp.asarray(x) for x in (*gl, *al)]))

    impl = GradientAccumulation(build_algorithm("gradient_allreduce"), every=3).reify(tgroup)
    tparams = params_from_jax(params)
    plan = impl.tensors_to_buckets(tparams)
    impl.bind_plan(plan)
    state = {"acc": params_from_jax(acc), "inner": {}}
    g2, _, st2 = impl.transform_gradients(params_from_jax(grads), tparams, state, StepContext(tgroup, step, plan))
    for got, want in zip(tree_leaves(st2["acc"]), jax.tree.leaves(jacc)):
        np.testing.assert_array_equal(got.numpy(), want)
    if boundary:
        assert all(float(t.abs().max()) == 0 for t in tree_leaves(st2["acc"]))
        for got, want in zip(tree_leaves(g2), jax.tree.leaves(jg)):
            np.testing.assert_array_equal(got.numpy(), want)


def test_no_update_off_boundary(tgroup):
    """GradientAccumulation(ByteGrad, every=4) with Adam: steps 0-2 leave
    the parameters and Adam's state (no count, no moment) bitwise as they
    were, the optimizer not even called; step 3 updates."""
    params = jax_params(1)
    ddp = DistributedDataParallel(mlp.mse_loss, adam, GradientAccumulation(build_algorithm("bytegrad"), every=4),
                                  tgroup)
    state = ddp.init(params_from_jax(params))
    x, y = batches(np.random.RandomState(1), 1, 16)[0]
    b = (torch.from_numpy(x), torch.from_numpy(y))
    before = [t.clone() for t in tree_leaves(state.params)]
    calls = []
    state.optimizer.register_step_pre_hook(lambda *a: calls.append(1))
    sd_before = state.optimizer.state_dict()
    for _ in range(3):
        state, _ = ddp.train_step(state, b)
    assert not calls and len(state.optimizer.state) == 0
    assert state.optimizer.state_dict() == sd_before
    assert all(torch.equal(a, t) for a, t in zip(before, tree_leaves(state.params)))
    assert all(t.grad is None for t in tree_leaves(state.params))
    state, _ = ddp.train_step(state, b)
    assert calls == [1]
    assert all(int(s["step"]) == 1 for s in state.optimizer.state.values())
    assert any(not torch.equal(a, t) for a, t in zip(before, tree_leaves(state.params)))


def test_accumulated_bytegrad_keeps_ranks_equal(tgroup):
    """ByteGrad's pipeline on the accumulated mean keeps the ranks bitwise
    equal, as the flat ByteGrad does; the accumulator is rank-stacked f32."""
    params = jax_params(2)
    ddp, state = run_port(tgroup, GradientAccumulation(build_algorithm("bytegrad"), every=2), params,
                          batches(np.random.RandomState(2), 6, 16), lambda ps: torch.optim.SGD(ps, lr=0.05))
    for leaf in tree_leaves(state.params):
        assert all(torch.equal(leaf[0], leaf[r]) for r in range(1, N))
    for a, p in zip(tree_leaves(state.algo_state["acc"]), tree_leaves(state.params)):
        assert a.dtype == torch.float32 and a.shape == p.shape


class _Recorder(AlgorithmImpl):
    """An inner algorithm that records the steps its stages and hooks see."""

    def __init__(self, group):
        super().__init__(group, hierarchical=True)
        self.seen = []
        self.holds_bucketized_state = True

    def on_step_start(self, params, state, ctx):
        self.seen.append(("start", ctx.step))
        return params, state

    def transform_gradients(self, grads, params, state, ctx):
        self.seen.append(("transform", ctx.step))
        return grads, params, state

    def on_step_end(self, params, state, ctx):
        self.seen.append(("end", ctx.step))
        return params, state

    def host_post_dispatch(self, state, step):
        self.seen.append(("post", step))

    def need_reset(self, step):
        return step == 1

    def step_variant(self, step):
        return f"v{step}"


def test_inner_sees_update_steps_and_delegation(tgroup):
    """The inner stages run on boundary steps only, with ``step // every``;
    the host hooks get the engine's step count over ``every``; what the
    engine reads is the inner algorithm's (``holds_bucketized_state``,
    ``hierarchical`` both ways, ``optimizer``, ``need_reset``,
    ``step_variant``)."""
    inner = _Recorder(tgroup)
    ddp = DistributedDataParallel(mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.1),
                                  GradientAccumulation(inner, every=3), tgroup)
    impl = ddp.impl
    assert isinstance(impl, GradientAccumulationImpl) and impl.holds_bucketized_state
    assert impl.hierarchical is True
    impl.hierarchical = False
    assert inner.hierarchical is False and impl.optimizer is None
    assert impl.need_reset(3) and not impl.need_reset(2) and impl.step_variant(7) == "v2"
    assert not ddp.overlap_enabled
    state = ddp.init(params_from_jax(jax_params(5)))
    x, y = batches(np.random.RandomState(5), 1, 16)[0]
    for _ in range(6):
        state, _ = ddp.train_step(state, (torch.from_numpy(x), torch.from_numpy(y)))
    stages = [s for s in inner.seen if s[0] != "post"]
    assert stages == [("start", 0), ("transform", 0), ("end", 0), ("start", 1), ("transform", 1), ("end", 1)]
    assert [s for s in inner.seen if s[0] == "post"] == [("post", k // 3) for k in range(1, 7)]
    with pytest.raises(ValueError, match="every must be >= 1"):
        GradientAccumulation(Algorithm.init("gradient_allreduce"), every=0).reify(tgroup)
    qadam = DistributedDataParallel(
        mlp.mse_loss, None, GradientAccumulation(build_algorithm("qadam", lr=0.25), every=2), tgroup)
    assert qadam.impl.optimizer.lr == 0.25
