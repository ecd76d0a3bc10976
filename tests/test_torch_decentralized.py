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
from bagua_tpu_torch.utils import tree_leaves, tree_map

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
    reference's message; gossip (``staleness_tau``) raises as the JAX
    package does for a hierarchical exchange, an interval and a negative
    τ, and its knob only on an instance built with a τ."""
    for devices, intra, hier in ((6, 2, True), (3, 1, False), (5, 5, False)):
        tg = BaguaProcessGroup([torch.device("cpu")] * devices, intra_size=intra)
        peers = devices // intra if hier else devices
        with pytest.raises(ValueError, match=f"exchanges across {peers} peers .*cannot be symmetrically "
                                             r"paired.*rs:71-79"):
            DecentralizedAlgorithm(hierarchical=hier, peer_selection_mode="shift_one").reify(tg)
    tg = BaguaProcessGroup([torch.device("cpu")] * 6, intra_size=6)
    DecentralizedAlgorithm(hierarchical=True, peer_selection_mode="shift_one").reify(tg)  # one node: no peers
    for kw in (dict(hierarchical=True, staleness_tau=2), dict(hierarchical=False, staleness_tau=-1),
               dict(hierarchical=False, communication_interval=2, staleness_tau=2)):
        with pytest.raises(ValueError) as got:
            DecentralizedAlgorithm(**kw).reify(tg)
        with pytest.raises(ValueError) as want:
            JaxDecentralized(**kw).reify(group)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        DecentralizedAlgorithm(hierarchical=False).reify(tg).set_staleness_tau(2)
    with pytest.raises(ValueError) as want:
        JaxDecentralized(hierarchical=False).reify(group).set_staleness_tau(2)
    assert str(got.value) == str(want.value) and "staleness_tau" in str(got.value)
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


# ---------------------------------------------------------------------------
# Gossip: decentralized SGD with bounded staleness (staleness_tau)
# ---------------------------------------------------------------------------

G_STEPS, G_IN, G_OUT = 6, 10, 3
#: buckets of 128 bytes: the MLP's four leaves in four buckets under overlap
G_BUCKET = 1 << 7


def gossip_problem(seed):
    """The JAX package's fixture (``tests/test_decentralized.py``): the MLP
    [10, 8, 3] and 32 samples a step from ``RandomState(seed)``."""
    params = jax.tree.map(np.asarray, jax_mlp.init_mlp(jax.random.PRNGKey(seed), [G_IN, 8, G_OUT]))
    rng = np.random.RandomState(seed)
    xs = rng.randn(G_STEPS, N * 4, G_IN).astype(np.float32)
    ys = rng.randn(G_STEPS, N * 4, G_OUT).astype(np.float32)
    return params, xs, ys


def gossip_engines(group, tgroup, params, tau, mode="all", overlap=False, bucket=None, directive=()):
    """The JAX and the port engine with gossip decentralized SGD, their
    initial states, the directive applied to both when given."""
    kw = dict(hierarchical=False, peer_selection_mode=mode, staleness_tau=tau)
    jddp = JaxDDP(jax_mlp.mse_loss, optax.sgd(LR), JaxDecentralized(**kw), process_group=group,
                  bucket_size_bytes=bucket, overlap=overlap)
    ddp = DistributedDataParallel(mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=LR),
                                  DecentralizedAlgorithm(**kw), tgroup, bucket_size_bytes=bucket, overlap=overlap)
    jstate, state = jddp.init(params), ddp.init(params_from_jax(params))
    if tau is not None and directive:
        jstate = jddp.apply_degradation_directive(jstate, directive)
        state = ddp.apply_degradation_directive(state, directive)
    return jddp, jstate, ddp, state


def run_both(jddp, jstate, ddp, state, xs, ys, steps):
    for i in range(steps):
        jstate, _ = jddp.train_step(jstate, (jnp.asarray(xs[i % G_STEPS]), jnp.asarray(ys[i % G_STEPS])))
        state, _ = ddp.train_step(state, (torch.from_numpy(xs[i % G_STEPS]), torch.from_numpy(ys[i % G_STEPS])))
    return jstate, state


def test_gossip_tau0_bitwise_matches_plain_decentralized(group, tgroup):
    """τ=0 allocates the gossip state and gates nothing.  The JAX package's
    own comparison of τ=0 with τ=None (its test of this name) is
    reproduced first: on XLA:CPU the two differ by rounding (the
    ``jnp.where`` around the exchange fuses into other arithmetic), within
    F32_TOL.  The port's ``torch.where`` with an all-False gate is a copy,
    so its τ=0 run equals its τ=None run bit for bit, and each is within
    F32_TOL of the JAX engine's."""
    params, xs, ys = gossip_problem(6)
    jgot, got = run_both(*gossip_engines(group, tgroup, params, 0), xs, ys, 4)
    jref, ref = run_both(*gossip_engines(group, tgroup, params, None), xs, ys, 4)
    for a, b in zip(jax.tree.leaves(jgot.params), jax.tree.leaves(jref.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **F32_TOL)
    for a, b, c in zip(tree_leaves(got.params), tree_leaves(ref.params), jax.tree.leaves(jref.params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), **F32_TOL)


@pytest.mark.parametrize("mode", ["all", "shift_one"])
def test_gossip_stage_matches_jax_bitwise(group, tgroup, mode):
    """The monolithic gossip stage on the same per-rank weights and state
    (ranks replaying, fresh, at and past the bound, three rounds of the
    ``shift_one`` schedule): the weights, ``published`` and the counters,
    bit for bit."""
    params, _, _ = gossip_problem(4)
    rng = np.random.RandomState(8)
    stacked = jax.tree.map(lambda a: (a[None] + 0.1 * rng.randn(N, *a.shape)).astype(np.float32), params)
    kw = dict(hierarchical=False, peer_selection_mode=mode, staleness_tau=2)
    jimpl = JaxDecentralized(**kw).reify(group)
    jplan = jimpl.tensors_to_buckets(params)
    jimpl.bind_plan(jplan)
    impl = DecentralizedAlgorithm(**kw).reify(tgroup)
    plan = impl.tensors_to_buckets(params_from_jax(params))
    impl.bind_plan(plan)
    published = rng.randn(N, plan.specs[0].numel).astype(np.float32)
    staleness = np.array([0, 1, 2, 0, 3, 1, 0, 2], np.int32)
    directive = np.array([1, 1, 1, 0, 1, 0, 0, 1], np.int32)
    leaves, treedef = jax.tree.flatten(stacked)
    for step in range(3):
        def body(*a, step=step):
            st = {"published": (a[-3],), "staleness": a[-2], "directive": a[-1]}
            ctx = JaxStepContext(group=group, step=jnp.int32(step), plan=jplan)
            _, p2, st2 = jimpl.transform_gradients(None, jax.tree.unflatten(treedef, a[:-3]), st, ctx)
            return p2, st2["published"][0], st2["staleness"]

        jout = per_rank_jax(group, body, *leaves, published, staleness, directive)
        state = {"published": (torch.from_numpy(published),), "staleness": torch.from_numpy(staleness),
                 "directive": torch.from_numpy(directive)}
        _, p2, st2 = impl.transform_gradients(None, params_from_jax(stacked), state, StepContext(tgroup, step, plan))
        for got, want in zip(tree_leaves(p2), jax.tree.leaves(jout[0])):
            np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(st2["published"][0].numpy(), jout[1])
        np.testing.assert_array_equal(st2["staleness"].numpy(), jout[2])
    np.testing.assert_array_equal(st2["staleness"].numpy(), [1, 2, 0, 0, 0, 0, 0, 0])


@pytest.mark.parametrize("overlap", [False, True], ids=["mono", "overlap"])
def test_gossip_staleness_bound_forces_exchange(group, tgroup, overlap):
    """Rank 2 under a directive at τ 2: its counter cycles 1, 2, 0, 1, 2,
    0, 1 on both engines (monolithic and weight-mode overlap), the other
    ranks' stay 0, and the parameters stay within F32_TOL of the JAX
    engine's."""
    params, xs, ys = gossip_problem(7)
    jddp, jstate, ddp, state = gossip_engines(group, tgroup, params, 2, overlap=overlap,
                                              bucket=G_BUCKET if overlap else None, directive=(2,))
    seen, jseen = [], []
    for step in range(7):
        jstate, state = run_both(jddp, jstate, ddp, state, xs[step % G_STEPS:][:1], ys[step % G_STEPS:][:1], 1)
        c = state.algo_state["staleness"].numpy()
        seen.append(int(c[2]))
        jseen.append(int(np.asarray(jstate.algo_state["staleness"])[2]))
        assert c[2] <= 2 and (np.delete(c, 2) == 0).all(), c
    assert seen == jseen == [1, 2, 0, 1, 2, 0, 1]
    assert ddp.overlap_enabled is overlap and (ddp.plan.num_buckets > 1) is overlap
    for got, want in zip(tree_leaves(state.params), jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    for got, want in zip(state.algo_state["published"], jstate.algo_state["published"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def _flat_grad(plan, flat, x, y):
    """The MLP's gradient at the flat weights ``flat`` on one rank's batch,
    as a flat of ``plan``'s one bucket."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), plan.debucketize([torch.from_numpy(flat)]))
    mlp.mse_loss(p, (torch.from_numpy(x), torch.from_numpy(y))).backward()
    return plan.bucketize(tree_map(lambda t: t.grad, p))[0].numpy()


def test_gossip_stale_rank_keeps_local_weights(group, tgroup):
    """τ 1, rank 2 under the directive.  Step 0 is a replay round for rank
    2: it ships its published (initial) weights and keeps its own, plain
    local SGD; the healthy ranks average with that replica.  Step 1 the
    bound brings rank 2 back (counter 0).  Against the algebra within the
    reference's rtol 2e-4, atol 1e-5, against the JAX engine within
    F32_TOL."""
    params, xs, ys = gossip_problem(8)
    jddp, jstate, ddp, state = gossip_engines(group, tgroup, params, 1, directive=(2,))
    jstate, state = run_both(jddp, jstate, ddp, state, xs, ys, 1)
    plan = ddp.plan
    w0 = plan.bucketize(params_from_jax(params))[0].numpy()
    x, y = xs[0].reshape(N, -1, G_IN), ys[0].reshape(N, -1, G_OUT)
    oracle = dict(rtol=2e-4, atol=1e-5)
    got2 = plan.bucketize(ddp.params_unstacked(state, 2))[0].numpy()
    np.testing.assert_allclose(got2, w0 - LR * _flat_grad(plan, w0, x[2], y[2]), **oracle)
    got0 = plan.bucketize(ddp.params_unstacked(state, 0))[0].numpy()
    np.testing.assert_allclose(got0, w0 - LR * _flat_grad(plan, w0, x[0], y[0]), **oracle)
    for got, want in zip(tree_leaves(state.params), jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    jstate, state = run_both(jddp, jstate, ddp, state, xs[1:], ys[1:], 1)
    assert int(state.algo_state["staleness"][2]) == int(np.asarray(jstate.algo_state["staleness"])[2]) == 0


@pytest.mark.parametrize("mode", ["all", "shift_one"])
def test_gossip_overlap_equals_monolithic_bitwise(tgroup, mode):
    """Weight mode: each bucket's gossip round from inside the backward,
    its new published flat stashed for ``finalize_overlap``, gives the
    monolithic run's parameters, published replicas and counters bit for
    bit (rank 2 under the directive, τ 1); ``auto`` takes the overlap, and
    ``rebucket`` refuses the replicas' layout, where plain decentralized
    takes it."""
    params, xs, ys = gossip_problem(9)

    def run(overlap):
        ddp = DistributedDataParallel(
            mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=LR),
            DecentralizedAlgorithm(hierarchical=False, peer_selection_mode=mode, staleness_tau=1), tgroup,
            bucket_size_bytes=G_BUCKET, overlap=overlap)
        state = ddp.apply_degradation_directive(ddp.init(params_from_jax(params)), (2,))
        for i in range(G_STEPS):
            state, _ = ddp.train_step(state, (torch.from_numpy(xs[i]), torch.from_numpy(ys[i])))
        return ddp, state

    mono, mstate = run(False)
    ov, ostate = run("auto")
    assert mono.plan.num_buckets == 1 and ov.plan.num_buckets > 1 and ov.overlap_enabled
    assert ov.impl.overlap_capability().mode == "weight"
    assert ov.exchange_counts == [G_STEPS] * ov.plan.num_buckets
    for a, b in zip(tree_leaves(mstate.params), tree_leaves(ostate.params)):
        assert torch.equal(a, b)
    published = [plan.debucketize(list(st.algo_state["published"]), st.params)
                 for plan, st in ((mono.plan, mstate), (ov.plan, ostate))]
    for a, b in zip(*map(tree_leaves, published)):
        assert torch.equal(a, b)
    assert torch.equal(mstate.algo_state["staleness"], ostate.algo_state["staleness"])
    with pytest.raises(ValueError, match="keeps per-bucket state"):
        ov.rebucket(ov.plan)
    plain = port_engine(tgroup, DecentralizedAlgorithm(hierarchical=False))
    plain.init(params_from_jax(params))
    plain.rebucket(plain.plan)
