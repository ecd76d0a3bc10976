"""The port's asynchronous model averaging against the JAX package, on an
8-rank CPU group (``intra_size=4``).

The fixture is the JAX package's own (``tests/test_async_model_average.py``):
the MLP [10, 8, 3], ranks started apart (rank r's copy ``base + r``), lr 0
where a test isolates the averaging from training.  Deterministic tests
drive one averaging cycle by hand (``_cycle``) with the thread parked; the
thread tests let it run for real.  Every test that can start the thread
waits at most ``DEADLINE_S`` for anything and calls ``shutdown()`` in
``finally``.  Tolerances: against the JAX engine within ``F32_TOL`` (rtol
1e-5, atol 1e-6); ranks averaged within the reference's 1e-5 of each
other (``p + (mean - p)`` is exact in value, not in bits).
"""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bagua_tpu.algorithms.async_model_average import AsyncModelAverageAlgorithm as JaxAsync
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP
from bagua_tpu.models import mlp as jax_mlp

from bagua_tpu_torch.algorithms import AsyncModelAverageAlgorithm, WALL_CLOCK_ALGORITHMS, build_algorithm
from bagua_tpu_torch.algorithms import async_model_average as amod
from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.convert import params_from_jax, stacked_params_from_jax
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.models import mlp
from bagua_tpu_torch.trainer import Trainer
from bagua_tpu_torch.utils import tree_flatten_with_names, tree_leaves, tree_map

N = 8
DIM_IN, DIM_OUT = 10, 3
PARKED = 10 ** 9  # sync_interval_ms long enough that the thread never fires
DEADLINE_S = 20.0
F32_TOL = dict(rtol=1e-5, atol=1e-6)
CLOSE = 1e-5


@pytest.fixture()
def tgroup():
    return BaguaProcessGroup([torch.device("cpu")] * N, intra_size=4)


def base_params(seed):
    return jax.tree.map(np.asarray, jax_mlp.init_mlp(jax.random.PRNGKey(seed), [DIM_IN, 8, DIM_OUT]))


def spread(base):
    """Per-rank copies ``base + r``: averaging's effect is unmistakable."""
    return [jax.tree.map(lambda a: (a + float(r)).astype(np.float32), base) for r in range(N)]


def make_data(n_steps, seed):
    rng = np.random.RandomState(seed)
    xs = rng.randn(n_steps, N * 4, DIM_IN).astype(np.float32)
    ys = rng.randn(n_steps, N * 4, DIM_OUT).astype(np.float32)
    return xs, ys


def make_ddp(tgroup, lr=0.05, sync_interval_ms=PARKED, warmup_steps=0):
    return DistributedDataParallel(
        mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=lr),
        AsyncModelAverageAlgorithm(sync_interval_ms=sync_interval_ms, warmup_steps=warmup_steps), tgroup)


def tb(xs, ys, i):
    return torch.from_numpy(xs[i]), torch.from_numpy(ys[i])


def max_spread(state) -> float:
    return max(float((t.amax(0) - t.amin(0)).abs().max()) for t in tree_leaves(state.params))


def ranks_equal(state) -> bool:
    return all(torch.equal(t[0], t[r]) for t in tree_leaves(state.params) for r in range(1, N))


def test_one_cycle_converges_ranks_to_mean(group, tgroup):
    """One manual cycle and its fold at the next step's start collapse the
    ranks to their mean at lr 0; the JAX engine's same run agrees within
    F32_TOL."""
    base = base_params(0)
    xs, ys = make_data(3, seed=1)
    ddp = make_ddp(tgroup, lr=0.0)
    state = ddp.init(stacked_params=stacked_params_from_jax(spread(base)))
    jddp = JaxDDP(jax_mlp.mse_loss, optax.sgd(0.0), JaxAsync(sync_interval_ms=PARKED), process_group=group)
    jstate = jddp.init(stacked_params=jax.tree.map(lambda *r: jnp.stack(r), *spread(base)))
    try:
        state, _ = ddp.train_step(state, tb(xs, ys, 0))
        jstate, _ = jddp.train_step(jstate, (jnp.asarray(xs[0]), jnp.asarray(ys[0])))
        assert not ranks_equal(state)
        ddp.impl._cycle()
        jddp.impl._cycle()
        state, _ = ddp.train_step(state, tb(xs, ys, 1))
        jstate, _ = jddp.train_step(jstate, (jnp.asarray(xs[1]), jnp.asarray(ys[1])))
        assert ddp.impl.folds_applied == jddp.impl.folds_applied == 1
        assert max_spread(state) < CLOSE
        w0 = tree_leaves(state.params)[0]
        want = np.mean([jax.tree.leaves(p)[0] for p in spread(base)], axis=0)
        np.testing.assert_allclose(w0[0].numpy(), want, rtol=1e-6)
        for got, jwant in zip(tree_leaves(state.params), jax.tree.leaves(jstate.params)):
            np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **F32_TOL)
    finally:
        ddp.shutdown()
        jddp.shutdown()


def test_dp_filter_keeps_filtered_leaves_out_of_the_average(tgroup):
    """With a ``dp_filter`` the averager averages the bucket plan's leaves
    only: ``averaged_names()`` is the plan's covered names, and after one
    manual cycle and its fold at lr 0 each averaged leaf equals the numpy
    mean over the ranks while each filtered leaf keeps every rank's own
    values, bit for bit."""
    base = base_params(0)
    xs, ys = make_data(2, seed=1)
    local = {"['layer0']['w']", "['layer1']['b']"}
    ddp = DistributedDataParallel(
        mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.0), AsyncModelAverageAlgorithm(sync_interval_ms=PARKED),
        tgroup, dp_filter=lambda name: name not in local)
    ranks = spread(base)
    state = ddp.init(stacked_params=stacked_params_from_jax(ranks))
    try:
        state, _ = ddp.train_step(state, tb(xs, ys, 0))
        assert sorted(ddp.impl.averaged_names()) == sorted(ddp.plan.covered())
        assert set(ddp.impl.averaged_names()) == {"['layer0']['b']", "['layer1']['w']"}
        ddp.impl._cycle()
        state, _ = ddp.train_step(state, tb(xs, ys, 1))
        assert ddp.impl.folds_applied == 1
        want = [np.stack([np.asarray(leaf) for leaf in leaves])
                for leaves in zip(*[jax.tree.leaves(p) for p in ranks])]
        for (name, got), stacked in zip(tree_flatten_with_names(state.params), want):
            if name in local:
                np.testing.assert_array_equal(got.numpy(), stacked)
            else:
                np.testing.assert_allclose(got.numpy(), np.broadcast_to(stacked.mean(0), stacked.shape),
                                           rtol=1e-6, atol=1e-6)
    finally:
        ddp.shutdown()


def test_background_thread_folds_while_training(tgroup):
    """The real thread averages while steps run, with the interpreter
    switching threads every microsecond: the ranks converge, a fold never
    lands twice (at lr 0 each rank mean is kept), and shutdown leaves no
    thread alive."""
    base = base_params(1)
    xs, ys = make_data(2, seed=2)
    ddp = make_ddp(tgroup, lr=0.0, sync_interval_ms=1)
    state = ddp.init(stacked_params=stacked_params_from_jax(spread(base)))
    mean0 = [t.mean(0) for t in tree_leaves(state.params)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        deadline, i = time.monotonic() + DEADLINE_S, 0
        while ddp.impl.folds_applied < 3 and time.monotonic() < deadline:
            state, _ = ddp.train_step(state, tb(xs, ys, i % 2))
            i += 1
        assert ddp.impl.folds_applied >= 3 and ddp.impl.folds_failed == 0, "background averager never folded"
        # a fold may have landed at the last step's start: one more step
        # carries no new spread at lr 0
        assert max_spread(state) < CLOSE
        for t, m in zip(tree_leaves(state.params), mean0):
            torch.testing.assert_close(t.mean(0), m, rtol=1e-6, atol=1e-5)
        thread = ddp.impl._thread
        assert thread is not None and thread.is_alive()
    finally:
        sys.setswitchinterval(interval)
        ddp.shutdown()
    assert not thread.is_alive() and ddp.impl._thread is None
    assert not [t for t in threading.enumerate() if t.name == "bagua-async-averager"]
    state, _ = ddp.train_step(state, tb(xs, ys, 0))  # no thread is started again
    assert ddp.impl._thread is None


def test_stale_generation_delta_is_dropped(tgroup):
    """A delta whose snapshot predates a fold is dropped, not folded: at lr
    0 folding it would re-invert the spread to its initial size."""
    base = base_params(4)
    xs, ys = make_data(3, seed=5)
    ddp = make_ddp(tgroup, lr=0.0)
    state = ddp.init(stacked_params=stacked_params_from_jax(spread(base)))
    try:
        state, _ = ddp.train_step(state, tb(xs, ys, 0))
        ddp.impl._cycle()
        gen, delta, done = ddp.impl._pending
        stale = (gen, tree_map(torch.clone, delta), done)
        state, _ = ddp.train_step(state, tb(xs, ys, 1))
        assert ddp.impl.folds_applied == 1 and max_spread(state) < CLOSE
        ddp.impl._pending, ddp.impl._pending_ready = stale, True
        state, _ = ddp.train_step(state, tb(xs, ys, 2))
        assert ddp.impl.folds_applied == 1, "stale delta was folded"
        assert ddp.impl._pending is None, "stale delta was not dropped"
        assert max_spread(state) < CLOSE, "stale fold re-inverted the rank spread"
    finally:
        ddp.shutdown()


def test_step_path_makes_no_backend_queries(tgroup, monkeypatch):
    """The fold reads only the ``_pending_ready`` bool: with the readiness
    probe made to raise, a delta not marked ready stays pending, and a
    ready one folds, neither calling the probe."""
    base = base_params(5)
    xs, ys = make_data(1, seed=6)
    ddp = make_ddp(tgroup, lr=0.0)
    state = ddp.init(stacked_params=stacked_params_from_jax(spread(base)))

    def probe(done):
        raise AssertionError("the step path queried the device")

    try:
        state, _ = ddp.train_step(state, tb(xs, ys, 0))
        ddp.impl._cycle()
        monkeypatch.setattr(ddp.impl, "_landed", probe)
        ddp.impl._pending_ready = False
        state, _ = ddp.train_step(state, tb(xs, ys, 0))
        assert ddp.impl._pending is not None and ddp.impl.folds_applied == 0
        ddp.impl._pending_ready = True
        state, _ = ddp.train_step(state, tb(xs, ys, 0))
        assert ddp.impl._pending is None and ddp.impl.folds_applied == 1
    finally:
        ddp.shutdown()


def test_abort_drains_and_resume_rearms(tgroup):
    base = base_params(3)
    xs, ys = make_data(3, seed=4)
    ddp = make_ddp(tgroup, lr=0.0)
    state = ddp.init(stacked_params=stacked_params_from_jax(spread(base)))
    try:
        state, _ = ddp.train_step(state, tb(xs, ys, 0))
        ddp.impl._cycle()
        assert ddp.impl._pending is not None
        ddp.abort()  # the pending delta is discarded
        assert ddp.impl._pending is None and not ddp.impl._orphans
        ddp.impl._cycle()  # a cycle while aborted publishes nothing
        assert ddp.impl._pending is None
        state, _ = ddp.train_step(state, tb(xs, ys, 1))
        assert ddp.impl.folds_applied == 0 and not ranks_equal(state)
        ddp.resume()
        ddp.impl._cycle()
        state, _ = ddp.train_step(state, tb(xs, ys, 2))
        assert ddp.impl.folds_applied == 1 and max_spread(state) < CLOSE
    finally:
        ddp.shutdown()


def test_warmup_gradient_allreduce(group, tgroup):
    """Warmup steps average the gradients: the ranks stay bitwise equal,
    within F32_TOL of the JAX engine's."""
    params = base_params(2)
    xs, ys = make_data(3, seed=3)
    ddp = make_ddp(tgroup, warmup_steps=100)
    jddp = JaxDDP(jax_mlp.mse_loss, optax.sgd(0.05), JaxAsync(sync_interval_ms=PARKED, warmup_steps=100),
                  process_group=group)
    state, jstate = ddp.init(params_from_jax(params)), jddp.init(params)
    try:
        for i in range(3):
            state, _ = ddp.train_step(state, tb(xs, ys, i))
            jstate, _ = jddp.train_step(jstate, (jnp.asarray(xs[i]), jnp.asarray(ys[i])))
        assert ranks_equal(state)
        for got, want in zip(tree_leaves(state.params), jax.tree.leaves(jstate.params)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    finally:
        ddp.shutdown()
        jddp.shutdown()


def test_registry_guards_and_trainer_close(group, tgroup):
    """``"async"`` is registered and wall-clock driven; another peer
    selection raises the JAX package's error; ``Trainer.close`` stops the
    thread; ``init`` refuses two trees, none, and a stacked tree of the
    wrong rank count."""
    assert "async" in WALL_CLOCK_ALGORITHMS
    assert isinstance(build_algorithm("async"), AsyncModelAverageAlgorithm)
    with pytest.raises(ValueError) as got:
        AsyncModelAverageAlgorithm(peer_selection_mode="shift_one").reify(tgroup)
    with pytest.raises(ValueError) as want:
        JaxAsync(peer_selection_mode="shift_one").reify(group)
    assert str(got.value) == str(want.value)
    trainer = Trainer(mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.0),
                      AsyncModelAverageAlgorithm(sync_interval_ms=PARKED), tgroup)
    params = params_from_jax(base_params(6))
    xs, ys = make_data(2, seed=7)
    try:
        state = trainer.fit(trainer.init_state(params), [tb(xs, ys, i) for i in range(2)], log_every=0)
        thread = trainer.ddp.impl._thread
        assert state.step == 2 and thread.is_alive()
    finally:
        trainer.close()
    thread.join(DEADLINE_S)
    assert not thread.is_alive()
    trainer.close()
    ddp = make_ddp(tgroup)
    with pytest.raises(ValueError, match="not both"):
        ddp.init(params, stacked_params=stacked_params_from_jax(spread(base_params(6))))
    with pytest.raises(ValueError, match="pass params or stacked_params"):
        ddp.init()
    with pytest.raises(ValueError, match="leading axis must be the group size"):
        ddp.init(stacked_params=params)
    assert amod.JOIN_TIMEOUT_S <= DEADLINE_S
