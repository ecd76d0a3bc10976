"""The port's decentralized SGD, full and low precision, against the JAX
package, on an 8-rank CPU group (``intra_size=4``).

Both packages take the same seeded numpy inputs and the same converted
parameters.  Stage by stage the port is bitwise: the collectives
``ppermute_apply`` and ``broadcast_inplace``, the ``shift_one`` schedule,
decentralized's weight exchange and low-precision decentralized's
``on_step_end`` (the codec's plain version follows jnp, and XLA's fused
multiply-adds in the weight difference are ``torch.add(..., alpha=)``).
Engine runs differ where the backward's products sum in another order:
decentralized within f32 rounding (rtol 1e-5, atol 1e-6, the JAX overlap
tests' bounds); low precision within quantization steps, since a gradient
one rounding away can flip a level of the compressed difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from bagua_tpu.algorithms.base import StepContext as JaxStepContext
from bagua_tpu.algorithms.decentralized import (
    DecentralizedAlgorithm as JaxDecentralized,
    LowPrecisionDecentralizedAlgorithm as JaxLowPrecision,
    _shift_one_perm as jax_shift_one_perm,
)
from bagua_tpu.communication import ALL_AXES
from bagua_tpu.communication import broadcast_inplace as jax_broadcast_inplace
from bagua_tpu.communication import ppermute_apply as jax_ppermute_apply
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP
from bagua_tpu.models import mlp as jax_mlp

from bagua_tpu_torch.algorithms import (
    DecentralizedAlgorithm,
    GradientAllReduceAlgorithm,
    LowPrecisionDecentralizedAlgorithm,
    build_algorithm,
)
from bagua_tpu_torch.algorithms import decentralized as dec
from bagua_tpu_torch.algorithms.base import StepContext
from bagua_tpu_torch.communication import BaguaProcessGroup, broadcast_inplace, ppermute_apply
from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.models import mlp
from bagua_tpu_torch.utils import tree_leaves

N = 8
LAYERS = [12, 16, 16, 4]
BUCKET = 512
LR, STEPS = 0.05, 4
F32_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture()
def tgroup():
    return BaguaProcessGroup([torch.device("cpu")] * N, intra_size=4)


def per_rank_jax(group, fn, *xs):
    """``fn`` on each rank's slices of the stacked numpy arrays ``xs``
    under the JAX group's ``shard_map``; the results stacked again."""
    f = jax.jit(group.shard_map(lambda *v: jax.tree.map(lambda t: t[None], fn(*[a[0] for a in v])),
                                in_specs=P(ALL_AXES), out_specs=P(ALL_AXES)))
    return jax.tree.map(np.asarray, f(*[jnp.asarray(x) for x in xs]))


def jax_params(seed=11):
    return jax_mlp.init_mlp(jax.random.PRNGKey(seed), LAYERS)


def batches(seed=0, steps=STEPS):
    rng = np.random.RandomState(seed)
    return [(rng.randn(32, LAYERS[0]).astype(np.float32), rng.randn(32, LAYERS[-1]).astype(np.float32))
            for _ in range(steps)]


# ---------------------------------------------------------------------------
# Collectives and the schedule, bitwise
# ---------------------------------------------------------------------------

PERMS = {
    None: [[(i, (i + 3) % 8) for i in range(8)], [(0, 5), (5, 0), (2, 7)], []],
    "inter": [[(0, 1), (1, 0)], [(1, 0)]],
    "intra": [[(0, 2), (2, 0), (1, 3), (3, 1)], [(3, 0), (0, 1)]],
}


@pytest.mark.parametrize("axis, perm", [(a, p) for a, ps in PERMS.items() for p in ps])
def test_ppermute_apply_matches_jax(group, tgroup, axis, perm):
    """Each destination receives its source's slice; a destination no
    pair names receives zeros, as ``lax.ppermute`` gives it."""
    x = np.random.RandomState(3).randn(8, 5, 3).astype(np.float32)
    got = ppermute_apply(torch.from_numpy(x), perm, tgroup, axis).numpy()
    want = per_rank_jax(group, lambda v: jax_ppermute_apply(v, perm, axis), x)
    np.testing.assert_array_equal(got, want)


def test_ppermute_apply_refuses_bad_pairs(tgroup):
    x = torch.zeros(8, 2)
    with pytest.raises(ValueError, match="twice"):
        ppermute_apply(x, [(0, 1), (2, 1)], tgroup)
    with pytest.raises(ValueError, match="outside"):
        ppermute_apply(x, [(0, 2)], tgroup, "inter")


@pytest.mark.parametrize("axis, src", [(None, 0), (None, 6), ("inter", 1), ("intra", 2)])
def test_broadcast_inplace_matches_jax(group, tgroup, axis, src):
    """The masked sum: a NaN on another rank stays out of the result, a -0
    at the source comes back as +0."""
    x = np.random.RandomState(4).randn(8, 6).astype(np.float32)
    x[:, 0] = -0.0
    x[(src + 1) % 4, 1] = np.nan
    got = broadcast_inplace(torch.from_numpy(x), src, tgroup, axis).numpy()
    want = per_rank_jax(group, lambda v: jax_broadcast_inplace(v, src, axis), x)
    assert not np.isnan(want).any()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_shift_one_perm_matches_jax():
    for n in range(2, 17):
        for step in range(20):
            assert dec._shift_one_perm(step, n) == jax_shift_one_perm(step, n)


# ---------------------------------------------------------------------------
# Stages, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode, hierarchical", [("all", False), ("all", True),
                                                ("shift_one", False), ("shift_one", True)])
def test_exchange_matches_jax_bitwise(group, tgroup, mode, hierarchical):
    """Decentralized's weight exchange on the same stacked flats, over four
    exchange rounds (``shift_one`` pairs differently in each)."""
    flat = np.random.RandomState(5).randn(8, 64).astype(np.float32) * np.logspace(-3, 3, 64, dtype=np.float32)
    kw = dict(hierarchical=hierarchical, peer_selection_mode=mode)
    jimpl = JaxDecentralized(**kw).reify(group)
    impl = DecentralizedAlgorithm(**kw).reify(tgroup)
    for comm_round in range(4):
        got = impl._exchange_flat(torch.from_numpy(flat), comm_round).numpy()
        want = per_rank_jax(group, lambda v: jimpl._exchange_flat(v, comm_round), flat)
        np.testing.assert_array_equal(got, want)


def _lp_inputs(seed):
    """Post-optimizer parameters and the three replicas, different on
    every rank, as numpy: (stacked params tree, weight, left, right)."""
    rng = np.random.RandomState(seed)
    tree = jax.tree.map(np.asarray, jax_params())
    params = jax.tree.map(lambda a: (a[None] + 0.01 * rng.randn(N, *a.shape)).astype(np.float32), tree)
    numel = -(-sum(a.size for a in jax.tree.leaves(tree)) // N) * N  # padded to the ranks
    reps = [(rng.randn(N, numel) * 0.05).astype(np.float32) for _ in range(3)]
    return tree, params, reps


@pytest.mark.parametrize("hierarchical", [False, True], ids=["flat", "hier"])
def test_low_precision_on_step_end_matches_jax_bitwise(group, tgroup, hierarchical):
    """On the same post-optimizer parameters and replicas: the parameters
    and all three replicas, bit for bit."""
    tree, params, (w, left, right) = _lp_inputs(6 + hierarchical)
    jimpl = JaxLowPrecision(hierarchical=hierarchical).reify(group)
    jplan = jimpl.tensors_to_buckets(tree)
    jimpl.bind_plan(jplan)
    assert jplan.num_buckets == 1 and jplan.specs[0].numel == w.shape[1]

    def body(p, w, left, right):
        ctx = JaxStepContext(group=group, step=jnp.int32(0), plan=jplan)
        p2, st = jimpl.on_step_end(p, {"weight": [w], "left": [left], "right": [right]}, ctx)
        return p2, st["weight"][0], st["left"][0], st["right"][0]

    leaves, treedef = jax.tree.flatten(params)
    jout = per_rank_jax(group, lambda *a: body(jax.tree.unflatten(treedef, a[:-3]), *a[-3:]), *leaves, w, left, right)

    impl = LowPrecisionDecentralizedAlgorithm(hierarchical=hierarchical).reify(tgroup)
    plan = impl.tensors_to_buckets(params_from_jax(tree))
    impl.bind_plan(plan)
    state = {k: [torch.from_numpy(a)] for k, a in zip(("weight", "left", "right"), (w, left, right))}
    p2, st = impl.on_step_end(params_from_jax(params), state, StepContext(tgroup, 0, plan))
    for got, want in zip(tree_leaves(p2), jax.tree.leaves(jout[0])):
        np.testing.assert_array_equal(got.numpy(), want)
    for i, key in enumerate(("weight", "left", "right")):
        np.testing.assert_array_equal(st[key][0].numpy(), jout[1 + i])


# ---------------------------------------------------------------------------
# The engine against the JAX engine
# ---------------------------------------------------------------------------


def run_jax(group, algo, overlap=False, data=None, bucket=BUCKET):
    ddp = JaxDDP(jax_mlp.mse_loss, optax.sgd(LR), algo, process_group=group, bucket_size_bytes=bucket,
                 overlap=overlap)
    state = ddp.init(jax_params())
    for x, y in data or batches():
        state, _ = ddp.train_step(state, (jnp.asarray(x), jnp.asarray(y)))
    return ddp, state


def port_engine(group, algo, overlap=False, optimizer=None, bucket=BUCKET):
    optimizer = optimizer or (lambda ps: torch.optim.SGD(ps, lr=LR))
    return DistributedDataParallel(mlp.mse_loss, optimizer, algo, group, bucket_size_bytes=bucket, overlap=overlap)


def run_port(group, algo, overlap=False, data=None, bucket=BUCKET):
    ddp = port_engine(group, algo, overlap, bucket=bucket)
    state = ddp.init(params_from_jax(jax.tree.map(np.asarray, jax_params())))
    for x, y in data or batches():
        state, losses = ddp.train_step(state, (torch.from_numpy(x), torch.from_numpy(y)))
    return ddp, state


def stacked_jax(state):
    return [np.asarray(leaf) for leaf in jax.tree.leaves(state.params)]


DECENTRALIZED = {
    "all-flat": dict(peer_selection_mode="all", hierarchical=False),
    "all-hier": dict(peer_selection_mode="all", hierarchical=True),
    "shift_one-flat": dict(peer_selection_mode="shift_one", hierarchical=False),
    "shift_one-hier": dict(peer_selection_mode="shift_one", hierarchical=True),
    "all-interval2": dict(peer_selection_mode="all", hierarchical=False, communication_interval=2),
    "shift_one-interval2": dict(peer_selection_mode="shift_one", hierarchical=False, communication_interval=2),
}


@pytest.mark.parametrize("case", list(DECENTRALIZED))
def test_decentralized_engine_matches_jax(group, tgroup, case):
    """STEPS steps of the MLP, every rank's parameters within f32 rounding
    of the JAX engine's; each rank's local step after the exchange leaves
    the ranks apart, in either mode."""
    kw = DECENTRALIZED[case]
    jddp, jstate = run_jax(group, JaxDecentralized(**kw))
    ddp, state = run_port(tgroup, DecentralizedAlgorithm(**kw))
    assert ddp.plan.num_buckets == jddp.plan.num_buckets == 1
    for got, want in zip(tree_leaves(state.params), stacked_jax(jstate)):
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    first = tree_leaves(state.params)[0]
    assert not torch.equal(first[0], first[1])


class _LevelRecorder:
    """Wraps the decentralized module's compress: the widest quantization
    level ((max - min) / 255 of a row) of every difference it compresses."""

    def __init__(self, monkeypatch):
        self.width = 0.0
        inner = dec.compress_minmax_uint8

        def compress(x):
            q, mm = inner(x)
            self.width = max(self.width, float((mm[:, 1] - mm[:, 0]).max()) / 255.0)
            return q, mm

        monkeypatch.setattr(dec, "compress_minmax_uint8", compress)


#: the share of elements that may lie beyond rounding: those a flipped
#: level moved
FLIPPED_SHARE = 0.05


def assert_within_levels(got, want, width):
    """Every element within STEPS x 3 levels of ``width`` (a flipped level
    at each replica's update, carried into the next step), and all but
    FLIPPED_SHARE of them within STEPS x a thousandth of a level (f32
    rounding, where no level flipped)."""
    d = np.concatenate([np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64)).ravel()
                        for g, w in zip(got, want)])
    loose, tight = STEPS * 3 * width, STEPS * 1e-3 * width
    assert d.max() <= loose and (d > tight).mean() <= FLIPPED_SHARE, (d.max(), loose, (d > tight).mean())


@pytest.mark.parametrize("hierarchical", [False, True], ids=["flat", "hier"])
def test_low_precision_engine_matches_jax(group, tgroup, monkeypatch, hierarchical):
    """STEPS steps against the JAX engine, within quantization steps of the
    widest difference the steps compress (:func:`assert_within_levels`);
    the starting parameters fail that check.  The parameters equal their
    own ``weight`` replica."""
    levels = _LevelRecorder(monkeypatch)
    jddp, jstate = run_jax(group, JaxLowPrecision(hierarchical=hierarchical))
    ddp, state = run_port(tgroup, LowPrecisionDecentralizedAlgorithm(hierarchical=hierarchical))
    assert levels.width > 0 and ddp.plan.num_buckets == 1
    got = [t.numpy() for t in tree_leaves(state.params)]
    assert_within_levels(got, stacked_jax(jstate), levels.width)
    start = [np.broadcast_to(a, (N, *a.shape)) for a in jax.tree.leaves(jax_params())]
    with pytest.raises(AssertionError):
        assert_within_levels(start, stacked_jax(jstate), levels.width)
    assert torch.equal(ddp.plan.bucketize(state.params)[0], state.algo_state["weight"][0])
    assert_within_levels([state.algo_state[k][0].numpy() for k in ("weight", "left", "right")],
                         [np.asarray(jstate.algo_state[k][0]) for k in ("weight", "left", "right")],
                         levels.width)


# ---------------------------------------------------------------------------
# The port's own: overlap, the knobs, the engine's parameter hand-over
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["all-hier", "shift_one-flat", "shift_one-interval2"])
def test_decentralized_overlap_equals_monolithic_bitwise(tgroup, case):
    """Weight mode: each bucket's weights exchanged from inside the
    backward, in ``backward_order()``, give the monolithic run's bits."""
    kw = DECENTRALIZED[case]
    mono, mstate = run_port(tgroup, DecentralizedAlgorithm(**kw), overlap=False)
    ov, ostate = run_port(tgroup, DecentralizedAlgorithm(**kw), overlap=True)
    assert mono.plan.num_buckets == 1 and ov.plan.num_buckets == 5
    assert ov.impl.overlap_capability().mode == "weight" and ov.overlap_enabled
    assert ov.exchange_counts == [STEPS] * 5 and ov.exchange_order == ov.plan.backward_order()
    for a, b in zip(tree_leaves(mstate.params), tree_leaves(ostate.params)):
        assert torch.equal(a, b)


def test_decentralized_overlap_matches_jax_overlap(group, tgroup):
    jddp, jstate = run_jax(group, JaxDecentralized(peer_selection_mode="shift_one", hierarchical=False),
                           overlap=True)
    ddp, state = run_port(tgroup, DecentralizedAlgorithm(peer_selection_mode="shift_one", hierarchical=False),
                          overlap=True)
    assert ddp.plan.num_buckets == jddp.plan.num_buckets == 5
    for got, want in zip(tree_leaves(state.params), stacked_jax(jstate)):
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_low_precision_overlap_close_not_bitwise(tgroup):
    """Per-bucket min/max quantize every element otherwise than the whole
    model's, and the trajectories part through the gradients: the runs
    agree within the JAX package's bound for this pair (rtol and atol 2e-2,
    ``tests/test_overlap_compressed.py:148-151``) and not bit for bit;
    ``"auto"`` keeps the monolithic step and ``rebucket`` refuses the
    replicas' layout."""
    mono, mstate = run_port(tgroup, LowPrecisionDecentralizedAlgorithm(), overlap=False)
    ov, ostate = run_port(tgroup, LowPrecisionDecentralizedAlgorithm(), overlap=True)
    assert mono.plan.num_buckets == 1 and ov.plan.num_buckets == 5 and ov.overlap_enabled
    assert ov.exchange_counts == [0] * 5  # post_step: the exchange runs after the optimizer
    a, b = (torch.cat([t.flatten() for t in tree_leaves(s.params)]) for s in (mstate, ostate))
    assert not torch.equal(a, b)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-2, atol=2e-2)

    auto = port_engine(tgroup, build_algorithm("low_precision_decentralized"), overlap="auto")
    cap = auto.impl.overlap_capability()
    assert not auto.overlap_enabled and cap.supported and not cap.auto and cap.mode == "post_step"
    assert "quantization granularity" in cap.reason
    auto.init(params_from_jax(jax.tree.map(np.asarray, jax_params())))
    assert auto.plan.num_buckets == 1
    with pytest.raises(ValueError, match="keeps per-bucket state"):
        auto.rebucket(auto.plan)


def test_fences_match_jax(group):
    """An odd number of ``shift_one`` peers raises at construction with the
    reference's message; gossip (``staleness_tau``) is not ported."""
    for devices, intra, hier in ((6, 2, True), (3, 1, False), (5, 5, False)):
        tg = BaguaProcessGroup([torch.device("cpu")] * devices, intra_size=intra)
        peers = devices // intra if hier else devices
        with pytest.raises(ValueError, match=f"exchanges across {peers} peers .*cannot be symmetrically "
                                             r"paired.*rs:71-79"):
            DecentralizedAlgorithm(hierarchical=hier, peer_selection_mode="shift_one").reify(tg)
    tg = BaguaProcessGroup([torch.device("cpu")] * 6, intra_size=6)
    DecentralizedAlgorithm(hierarchical=True, peer_selection_mode="shift_one").reify(tg)  # one node: no peers
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 4"):
        DecentralizedAlgorithm(staleness_tau=0).reify(tg)
    with pytest.raises(ValueError, match="unknown peer_selection_mode"):
        dec._exchange(torch.zeros(6, 2), 0, "ring", tg, None)


@pytest.mark.parametrize("name", ["decentralized", "low_precision_decentralized", "gradient_allreduce"])
def test_optimizer_steps_the_parameters_state_holds(tgroup, name):
    """After a step the optimizer's tensors are ``state.params``' leaves,
    and they hold the post-step values: the algorithm's new tensors were
    copied in, not left beside them."""
    algo = build_algorithm(name)
    ddp = port_engine(tgroup, algo, optimizer=lambda ps: torch.optim.SGD(ps, lr=LR, momentum=0.9))
    state = ddp.init(params_from_jax(jax.tree.map(np.asarray, jax_params())))
    x, y = batches()[0]
    before = [t.clone() for t in tree_leaves(state.params)]
    state2, _ = ddp.train_step(state, (torch.from_numpy(x), torch.from_numpy(y)))
    held = [p for g in state2.optimizer.param_groups for p in g["params"]]
    assert len(held) == len(tree_leaves(state2.params))
    assert all(a is b for a, b in zip(held, tree_leaves(state2.params)))
    assert all(a is b for a, b in zip(tree_leaves(state.params), tree_leaves(state2.params)))
    assert all(not torch.equal(a, b) for a, b in zip(before, tree_leaves(state2.params)))
    assert all(len(state2.optimizer.state[p]) for p in held)  # momentum for every one of them
    if name == "low_precision_decentralized":
        assert torch.equal(ddp.plan.bucketize(state2.params)[0], state2.algo_state["weight"][0])


def test_optimizer_none_needs_a_bundled_one(tgroup):
    for algo in (DecentralizedAlgorithm(), LowPrecisionDecentralizedAlgorithm(), GradientAllReduceAlgorithm()):
        with pytest.raises(ValueError, match="optimizer is required unless the algorithm bundles one"):
            DistributedDataParallel(mlp.mse_loss, None, algo, tgroup)
    ddp = DistributedDataParallel(mlp.mse_loss, None, build_algorithm("qadam", lr=0.25), tgroup)
    state = ddp.init(params_from_jax(jax.tree.map(np.asarray, jax_params())))
    assert isinstance(state.optimizer, torch.optim.SGD) and state.optimizer.defaults["lr"] == 0.25


def test_low_precision_state_is_rank_stacked(tgroup):
    impl = LowPrecisionDecentralizedAlgorithm().reify(tgroup)
    params = params_from_jax(jax.tree.map(np.asarray, jax_params()))
    impl.bind_plan(impl.tensors_to_buckets(params))
    state = impl.init_state(params)
    flat = impl._bound_plan.bucketize(params)[0]
    for key in ("weight", "left", "right"):
        (rep,) = state[key]
        assert rep.shape == (N, flat.numel()) and torch.equal(rep, flat.expand(N, -1))
