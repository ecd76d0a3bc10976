"""The port's ZeRO (``bagua_tpu_torch.sharded``) against the JAX package's,
on an 8-rank CPU group (``intra_size=4``).

The fixture is the JAX package's own (``tests/test_zero.py``): the MLP
``[10, 16, 4]`` (244 parameters) with 512-byte buckets, three f32 buckets,
the last ([layer1.b, layer1.w], 68 elements) padded to 72; 16 samples a
step from ``RandomState(1)``; a mid-training rebucket to 4 MiB (one
bucket).  Both sides start from the same flax parameters.

- Against the JAX ``ZeroAlgorithm`` engine: f32 within rtol 1e-5, atol
  1e-6 (the JAX overlap test's f32 tolerance; the two sum the ranks and
  run the optimizer in different orders), for SGD momentum and Adam,
  monolithic and overlap.  The quantized wires (ByteGrad, int8, int4) in
  two tiers: every element within STEPS x LR x k x the widest level the
  exchange meets, k the quantizations an element meets on its way (a level
  may flip at each where the two sides' gradients differ by rounding), one
  more for int4's residual; and all but FLIPPED_SHARE of the elements
  within STEPS x LR x a thousandth of that level (rounding, where no level
  flipped).  The loose tier alone would pass parameters that never moved
  (int4's level is wide), so the JAX run's own starting parameters are
  shown to fail the two tiers.  Never "the loss falls": the JAX fixture's
  loss does not fall over these steps in any variant (ROADMAP Queue 3).
- Against the port's own unsharded engines, bitwise: f32 ZeRO against
  ``gradient_allreduce``, ZeRO ByteGrad against flat ByteGrad; every
  operation is elementwise and in the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from bagua_tpu.algorithms.bytegrad import ByteGradAlgorithm as JaxByteGrad
from bagua_tpu.bucket import BucketPlan as JaxBucketPlan
from bagua_tpu.communication import ALL_AXES, reduce_scatter_inplace
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP
from bagua_tpu.models import mlp as jax_mlp
from bagua_tpu.sharded import ZeroAlgorithm as JaxZero
from bagua_tpu.sharded import layout as jax_layout

import bagua_tpu_torch
from bagua_tpu_torch.algorithms import (
    ByteGradAlgorithm,
    GradientAllReduceAlgorithm,
    build_algorithm,
)
from bagua_tpu_torch.bucket import BucketPlan
from bagua_tpu_torch.communication import BaguaProcessGroup, ReduceOp, allreduce
from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.models import mlp
from bagua_tpu_torch.sharded import ShardedOptimizerUpdater, ShardLayout, ZeroAlgorithm
from bagua_tpu_torch.sharded import layout
from bagua_tpu_torch.utils import tree_leaves

N = 8
ZLAYERS = [10, 16, 4]
BUCKET = 1 << 9
STEPS = 5
LR = 1e-2

#: the share of elements that may lie beyond rounding of the JAX run: those
#: a flipped level moved
FLIPPED_SHARE = 0.05

#: wire -> (port ZeRO kwargs, JAX ZeRO kwargs, quantizations an element meets)
WIRES = {
    "bytegrad": (dict(compression="bytegrad"), dict(compression="bytegrad"), 2),
    "int8": (dict(wire_precision="int8"), dict(wire_precision="int8"), N - 1),
    "int4": (dict(wire_precision="int4"), dict(wire_precision="int4"), N),
}


@pytest.fixture()
def tgroup():
    return BaguaProcessGroup([torch.device("cpu")] * N, intra_size=4)


@pytest.fixture(autouse=True)
def _small_ring_blocks(monkeypatch):
    """Blocks of 16 so that the buckets' ring shards span several."""
    monkeypatch.setenv("BAGUA_QR_BLOCK", "16")


def jax_params():
    return jax.tree.map(np.asarray, jax_mlp.init_mlp(jax.random.PRNGKey(0), ZLAYERS))


def zbatches(steps=STEPS):
    rng = np.random.RandomState(1)
    return [(rng.randn(16, ZLAYERS[0]).astype(np.float32), rng.randn(16, ZLAYERS[-1]).astype(np.float32))
            for _ in range(steps)]


def port_optimizer(name):
    if name == "adam":
        return lambda ps: torch.optim.Adam(ps, lr=LR)
    if name == "sgdm":
        return lambda ps: torch.optim.SGD(ps, lr=LR, momentum=0.9)
    return lambda ps: torch.optim.SGD(ps, lr=LR)


def jax_optimizer(name):
    if name == "adam":
        return optax.adam(LR)
    return optax.sgd(LR, momentum=0.9 if name == "sgdm" else None)


def run_port(group, algo, opt, overlap, steps=STEPS, rebucket_at=None, on_step=None):
    ddp = DistributedDataParallel(mlp.mse_loss, port_optimizer(opt), algo, group,
                                  bucket_size_bytes=BUCKET, overlap=overlap)
    params = params_from_jax(jax_params())
    state = ddp.init(params)
    for i, (x, y) in enumerate(zbatches(steps)):
        if i == rebucket_at:
            ddp.rebucket(BucketPlan.from_tree(params, 1 << 22, align_elems=N), reason="manual")
        if on_step is not None:
            on_step(ddp, state, (torch.from_numpy(x), torch.from_numpy(y)))
        state, _ = ddp.train_step(state, (torch.from_numpy(x), torch.from_numpy(y)))
    return ddp, ddp.finalize_pending_updates(state)


def run_jax(group, algo, opt, overlap):
    ddp = JaxDDP(jax_mlp.mse_loss, jax_optimizer(opt), algo, process_group=group,
                 bucket_size_bytes=BUCKET, overlap=overlap)
    state = ddp.init(jax_mlp.init_mlp(jax.random.PRNGKey(0), ZLAYERS))
    for x, y in zbatches():
        state, _ = ddp.train_step(state, (jnp.asarray(x), jnp.asarray(y)))
    state = ddp.finalize_pending_updates(state)
    return [np.asarray(leaf) for leaf in jax.tree.leaves(ddp.params_unstacked(state))]


def assert_ranks_synced(state):
    for leaf in tree_leaves(state.params):
        for r in range(1, N):
            assert torch.equal(leaf[0], leaf[r])


def assert_same(a_state, b_state):
    for a, b in zip(tree_leaves(a_state.params), tree_leaves(b_state.params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Against the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("overlap", [False, True], ids=["mono", "overlap"])
@pytest.mark.parametrize("opt", ["adam", "sgdm"])
def test_zero_f32_matches_jax(group, tgroup, opt, overlap):
    ddp, state = run_port(tgroup, ZeroAlgorithm(), opt, overlap)
    assert ddp.plan.num_buckets == 3 and [s.numel for s in ddp.plan.specs] == [16, 160, 72]
    if overlap:
        assert ddp.exchange_counts == [STEPS] * 3 and ddp.exchange_order == ddp.plan.backward_order()
    assert_ranks_synced(state)
    want = run_jax(group, JaxZero(), opt, overlap)
    for got, w in zip(tree_leaves(ddp.params_unstacked(state)), want):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=1e-6)


def level_width(wire, ddp, state, batch) -> float:
    """The widest level the exchange can meet this step, in units of the
    averaged gradient.  ByteGrad: over each rank's chunks and the chunks of
    their mean.  The ring: every partial sum lies within plus or minus the
    sum over ranks of each rank's largest |gradient + residual|, over the
    levels and the N ranks of the average."""
    state = ddp.finalize_pending_updates(state)  # this step's parameters
    _, grads = ddp._rank_grads(state.params, batch)
    resid = state.algo_state.get("qr_residual")
    width = 0.0
    for i, flat in enumerate(ddp.plan.bucketize(grads)):
        if wire == "bytegrad":
            for chunks in (flat.reshape(-1, flat.shape[1] // N), flat.mean(0).reshape(N, -1)):
                width = max(width, float((chunks.amax(1) - chunks.amin(1)).max()) / 255.0)
        else:
            if resid is not None:
                flat = flat + resid[i]
            levels = 255.0 if wire == "int8" else 15.0
            width = max(width, 2.0 * float(flat.abs().amax(1).sum()) / levels / N)
    return width


def within_tiers(got, want, tight, loose) -> bool:
    """Every element of ``got`` within ``loose`` of ``want``, and all but
    FLIPPED_SHARE of them within ``tight``."""
    d = np.concatenate([np.abs(np.asarray(g, np.float64) - w).ravel() for g, w in zip(got, want)])
    return bool(d.max() <= loose and (d > tight).sum() <= FLIPPED_SHARE * d.size)


@pytest.mark.parametrize("wire", list(WIRES))
def test_zero_quantized_matches_jax(group, tgroup, wire):
    """Plain SGD, so that a flipped level moves a parameter by LR x its
    width once; int8 with overlap (the engine's default), int4 monolithic
    (its residual refuses overlap); ranks bitwise equal after the final
    gather.  The parameters the JAX run started from fail the same check,
    so a port whose exchange froze them would too."""
    port_kw, jax_kw, k = WIRES[wire]
    widths = []
    ddp, state = run_port(tgroup, ZeroAlgorithm(**port_kw), "sgd", "auto",
                          on_step=lambda d, s, b: widths.append(level_width(wire, d, s, b)))
    assert ddp.overlap_enabled is (wire != "int4")
    assert_ranks_synced(state)
    if wire == "int4":
        resid = state.algo_state["qr_residual"]
        assert len(resid) == 3 and all(r.shape == (N, s.numel) for r, s in zip(resid, ddp.plan.specs))
        assert all(float(r.abs().max()) > 0 for r in resid)
    want = run_jax(group, JaxZero(**jax_kw), "sgd", wire != "int4")
    loose = STEPS * LR * (k + (wire == "int4")) * max(widths)
    tight = STEPS * LR * 1e-3 * max(widths)
    assert tight > 0
    got = [g.numpy() for g in tree_leaves(ddp.params_unstacked(state))]
    assert within_tiers(got, want, tight, loose)
    assert not within_tiers(jax.tree.leaves(jax_params()), want, tight, loose)


# ---------------------------------------------------------------------------
# Against the port's unsharded engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("overlap", [False, True], ids=["mono", "overlap"])
@pytest.mark.parametrize("opt", ["adam", "sgdm"])
def test_zero_f32_bitwise_matches_allreduce_engine(tgroup, opt, overlap):
    _, ref = run_port(tgroup, GradientAllReduceAlgorithm(), opt, False)
    ddp, got = run_port(tgroup, build_algorithm("zero"), opt, overlap)
    assert_same(got, ref)
    assert_ranks_synced(got)


@pytest.mark.parametrize("overlap", [False, True], ids=["mono", "overlap"])
def test_zero_bytegrad_bitwise_matches_flat_bytegrad(tgroup, overlap):
    """Each rank's reduced chunk, decompressed locally, is bitwise that row
    of flat ByteGrad's output (the twin of the JAX package's
    ``test_zero_bytegrad_bitwise_matches_monolithic``)."""
    _, ref = run_port(tgroup, ByteGradAlgorithm(hierarchical=False), "adam", False)
    _, got = run_port(tgroup, ZeroAlgorithm(compression="bytegrad"), "adam", overlap)
    assert_same(got, ref)


def test_zero_optimizer_state_bytes_per_rank(tgroup):
    """Per-rank optimizer state (Adam's moments) is about 1/n of the
    unsharded engine's; alignment padding is the only slack."""
    zd, zs = run_port(tgroup, ZeroAlgorithm(), "adam", False, steps=1)
    rd, rs = run_port(tgroup, GradientAllReduceAlgorithm(), "adam", False, steps=1)
    ratio = zd.optimizer_state_bytes(zs) / rd.optimizer_state_bytes(rs)
    assert ratio <= 1 / N + 0.05, ratio
    assert zd.optimizer_state_bytes(zs) == 2 * 4 * sum(s.numel for s in zd.plan.specs) // N


def test_zero_rebucket_midtraining_bitwise(tgroup):
    """A rebucket at step 2 (overlap on) migrates the optimizer's rows and
    state and the pending shards to the new layout value for value: the
    run is bitwise equal to an uninterrupted one.  The plan payload
    carries the shard geometry."""
    _, ref = run_port(tgroup, ZeroAlgorithm(), "adam", True)
    ddp, got = run_port(tgroup, ZeroAlgorithm(), "adam", True, rebucket_at=2)
    assert ddp.plan.num_buckets == 1 and ddp.plan_version == 1
    assert ddp._sharded_updater.layout.buckets[0].shard_numel * N >= 244
    assert ddp._pending_reshard is None
    assert_same(got, ref)
    payload = ddp.export_plan_payload()
    assert payload["shard"] == {"n_shards": N, "buckets": [{"numel": 248, "shard_numel": 31, "dtype": "f32"}]}
    assert payload["config"]["algorithm"] == "zero"


def test_zero_adopt_plan_payload_migrates(tgroup):
    """A plan payload adopted mid-training goes through rebucket: the next
    step migrates the state, and the run stays bitwise equal to one that
    never changed plans; ``clear_pending_reshard`` drops a queued
    migration."""
    _, ref = run_port(tgroup, ZeroAlgorithm(), "sgdm", False)
    src, _ = run_port(tgroup, ZeroAlgorithm(), "sgdm", False, steps=1, rebucket_at=0)

    def adopt(ddp, state, batch):
        if state.step == 2:
            assert ddp.adopt_plan_payload(src.export_plan_payload())
            assert ddp._pending_reshard is not None and ddp.plan.num_buckets == 1

    _, got = run_port(tgroup, ZeroAlgorithm(), "sgdm", False, on_step=adopt)
    assert_same(got, ref)
    ddp, _ = run_port(tgroup, ZeroAlgorithm(), "sgdm", False, steps=1)
    ddp.rebucket(BucketPlan.from_tree(params_from_jax(jax_params()), 1 << 22, align_elems=N))
    ddp.clear_pending_reshard()
    assert ddp._pending_reshard is None


@pytest.mark.parametrize("opt", ["adam", "sgdm"])
def test_gather_scatter_full_state(tgroup, opt):
    """``gather_full_state`` gives the unsharded engine's optimizer
    ``state_dict()`` bit for bit; ``scatter_full_state`` of that state,
    continued for a step, equals the sharded run continued for a step."""
    zd, zs = run_port(tgroup, ZeroAlgorithm(), opt, False)
    rd, rs = run_port(tgroup, GradientAllReduceAlgorithm(), opt, False)
    full = zd._sharded_updater.gather_full_state(zs.optimizer, zs.params)
    want = rs.optimizer.state_dict()
    assert full["param_groups"] == want["param_groups"]
    assert sorted(full["state"]) == sorted(want["state"]) == list(range(4))
    for i, st in want["state"].items():
        assert sorted(full["state"][i]) == sorted(st)
        for key, value in st.items():
            assert torch.equal(full["state"][i][key], value), (i, key)

    updater = zd._sharded_updater
    back = updater.scatter_full_state(want, rs.params)
    x, y = zbatches(STEPS + 1)[-1]
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    # the pending shards are views of each state's own rows
    b, _ = zd.train_step(type(zs)(rs.params, back, zd.impl.stash_updates(zs.algo_state, updater.pending(back)),
                                  zs.step), batch)
    a, _ = zd.train_step(zs, batch)
    assert_same(zd.finalize_pending_updates(a), zd.finalize_pending_updates(b))
    with pytest.raises(ValueError, match="missing 'momentum_buffer'|missing 'exp_avg'"):
        broken = {"state": {**want["state"], 3: {"step": want["state"][0].get("step", torch.tensor(1.0))}},
                  "param_groups": want["param_groups"]}
        zd._sharded_updater.scatter_full_state(broken, rs.params)


def test_uncovered_leaf_keeps_a_replicated_optimizer(tgroup):
    """A leaf no bucket covers is updated in place by an optimizer of its
    own, as the unsharded engine would; the covered ones only through the
    pending shards."""
    params = mlp.init_mlp(torch.Generator().manual_seed(3), ZLAYERS, device="cpu")
    stacked = {k: {n: t.unsqueeze(0).repeat(N, *[1] * t.dim()) for n, t in v.items()} for k, v in params.items()}
    decls = [d for b in BucketPlan.from_tree(params, BUCKET, N).declarations() for d in b]
    plan = BucketPlan.from_declarations([[d for d in decls if d.name != "['layer1']['w']"]], params, N)
    updater = ShardedOptimizerUpdater(port_optimizer("sgdm"), plan, tgroup)
    opt_state = updater.init(stacked)
    assert opt_state.local is not None and opt_state.rows[0].shape == (N, 23)
    grads = {k: {n: torch.full_like(t, 0.5) for n, t in v.items()} for k, v in stacked.items()}
    shards = updater._bucket_shards(grads)
    with pytest.raises(ValueError, match="uncovered leaves"):
        updater.update_shards(shards, stacked, updater.init(stacked))
    before = stacked["layer0"]["w"].clone()
    pending, _, out = updater.update_shards(shards, stacked, opt_state,
                                            local_grads={"['layer1']['w']": grads["layer1"]["w"]})
    assert out is stacked and torch.equal(stacked["layer0"]["w"], before)
    want = params["layer1"]["w"] - LR * 0.5
    assert torch.equal(stacked["layer1"]["w"], want.unsqueeze(0).expand(N, -1, -1))
    assert len(pending) == 1 and pending[0].shape == (N, 23)
    assert torch.equal(pending[0], updater._bucket_shards(stacked)[0].add(shards[0], alpha=-LR))


# ---------------------------------------------------------------------------
# Collectives, layout and errors against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axis", [None, "inter", "intra"])
@pytest.mark.parametrize("op", [ReduceOp.SUM, ReduceOp.AVG])
def test_reduce_scatter_matches_jax(group, tgroup, op, axis):
    """Against ``reduce_scatter_inplace`` under the JAX group's
    ``shard_map`` to f32 rounding (XLA sums in an order of its own), and
    bitwise each member's chunk of the port's allreduce."""
    x = np.random.RandomState(4).randn(8, 24, 3).astype(np.float32)
    got = bagua_tpu_torch.reduce_scatter(torch.from_numpy(x), op, tgroup, axis)
    f = jax.jit(group.shard_map(lambda v: reduce_scatter_inplace(v[0], op=op, axis=axis)[None],
                                in_specs=P(ALL_AXES), out_specs=P(ALL_AXES)))
    np.testing.assert_allclose(got.numpy(), np.asarray(f(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    n = {None: 8, "inter": 2, "intra": 4}[axis]
    full = allreduce(torch.from_numpy(x), op, tgroup, axis)
    member = bagua_tpu_torch.communication.rank_id(tgroup, axis)
    for r in range(8):
        assert torch.equal(got[r], full[r].reshape(n, 24 // n, 3)[member[r]])
    with pytest.raises(ValueError, match="does not divide"):
        bagua_tpu_torch.reduce_scatter(torch.zeros(8, 5), op, tgroup, axis if n > 1 else None)
    with pytest.raises(NotImplementedError, match="SUM and AVG"):
        bagua_tpu_torch.reduce_scatter(torch.zeros(8, 8), ReduceOp.MAX, tgroup)


def _layouts(bucket_bytes, n):
    jp = jax_params()
    tp = params_from_jax(jp)
    jplan = JaxBucketPlan.from_tree(jp, bucket_bytes, align_elems=n)
    plan = BucketPlan.from_tree(tp, bucket_bytes, align_elems=n)
    return jp, tp, jax_layout.ShardLayout.from_plan(jplan, n), ShardLayout.from_plan(plan, n)


def _geometry(lay):
    return (lay.n_shards, [(b.numel, b.shard_numel, b.dtype) for b in lay.buckets],
            [(s.name, s.numel, s.offset) for b in lay.buckets for s in b.slots],
            [(g.dtype, g.buckets, g.shard_total) for g in lay.groups])


def _equal_arrays(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_layout_matches_jax():
    """The geometry and every host-side resharding function give the JAX
    package's answers, bitwise, on the same numpy inputs: 3 buckets over 8
    shards -> 1 bucket over 8, and -> the same plan over 4 shards."""
    jp, tp, jlay, lay = _layouts(BUCKET, N)
    assert _geometry(lay) == _geometry(jlay)
    assert lay.payload() == jlay.payload()
    decls = [[{"name": s.name, "num_elements": s.numel, "dtype": b.dtype} for s in b.slots] for b in lay.buckets]
    for n in (N, 4):
        assert layout.ShardLayout.from_payload({"buckets": decls}, n).payload() == \
            jax_layout.ShardLayout.from_payload({"buckets": decls}, n).payload()
    values = layout.flat_tree_values(tp)
    jvalues = jax_layout.flat_tree_values(jp)
    assert list(values) == list(jvalues)
    for k in values:
        np.testing.assert_array_equal(values[k], jvalues[k])
    rows = layout.build_shard_rows(values, lay)
    _equal_arrays(rows, jax_layout.build_shard_rows(jvalues, jlay))
    _equal_arrays(layout.assemble_full_flats(rows, lay), jax_layout.assemble_full_flats(rows, jlay))
    rng = np.random.RandomState(5)
    flat = rng.randn(N, lay.groups[0].shard_total).astype(np.float32)
    for _, _, jnew, new in (_layouts(1 << 22, N), _layouts(BUCKET, 4)):
        _equal_arrays(layout.reshard_bucket_rows(rows, lay, new), jax_layout.reshard_bucket_rows(rows, jlay, jnew))
        _equal_arrays([layout.reshard_group_flat(flat, lay, new, "f32")],
                      [jax_layout.reshard_group_flat(flat, jlay, jnew, "f32")])
    with pytest.raises(ValueError, match="dtype group 'f16' missing"):
        layout.reshard_group_flat(flat, lay, lay, "f16")


def test_bf16_rides_as_bits():
    """numpy has no bfloat16: a bf16 bucket reshards as its bit pattern."""
    t = torch.randn(N, 9).to(torch.bfloat16)
    back = layout.to_device(layout.to_host(t), torch.bfloat16, "cpu")
    assert back.dtype == torch.bfloat16 and torch.equal(back.view(torch.int16), t.view(torch.int16))
    assert layout.np_dtype("bf16") == np.int16 and layout.np_dtype("f32") == np.float32


def test_errors_match_jax(group, tgroup):
    """The constructor's errors, and a plan whose buckets do not divide
    into the shard count, raise as in the JAX package."""
    for kw, match in ((dict(compression="fp16"), "zero compression must be None or 'bytegrad'"),
                      (dict(compression="bytegrad", wire_precision="int8"), "mutually exclusive"),
                      (dict(wire_precision="int2"), "wire_precision must be one of")):
        for algo, g in ((ZeroAlgorithm, tgroup), (JaxZero, group)):
            with pytest.raises(ValueError, match=match):
                algo(**kw).reify(g)
    tp = params_from_jax(jax_params())
    jp = jax_params()
    for lay_cls, plan in ((ShardLayout, BucketPlan.from_tree(tp, BUCKET, align_elems=4)),
                          (jax_layout.ShardLayout, JaxBucketPlan.from_tree(jp, BUCKET, align_elems=4))):
        with pytest.raises(ValueError, match="not divisible by 8 shards"):
            lay_cls.from_plan(plan, 8)


def test_registry_overlap_and_residual_restart(group, tgroup):
    """``build_algorithm("zero")`` takes every wire; overlap resolves as
    for the unsharded algorithms (int4 and ``"auto"`` hold per-bucket state:
    no overlap, no rebucket); int4 residuals restart at zero in a new
    layout."""
    resolved = {w: DistributedDataParallel(mlp.mse_loss, torch.optim.SGD, build_algorithm("zero", **kw), tgroup)
                .overlap_enabled for w, kw in {"f32": {}, "bytegrad": dict(compression="bytegrad"),
                                               "int8": dict(wire_precision="int8"),
                                               "int4": dict(wire_precision="int4"),
                                               "auto": dict(wire_precision="auto")}.items()}
    assert resolved == {"f32": True, "bytegrad": True, "int8": True, "int4": False, "auto": False}
    jax_resolved = {w: JaxDDP(jax_mlp.mse_loss, optax.sgd(LR), JaxZero(**kw), process_group=group).overlap_enabled
                    for w, kw in {"f32": {}, "int8": dict(wire_precision="int8"),
                                  "int4": dict(wire_precision="int4")}.items()}
    assert jax_resolved == {k: resolved[k] for k in jax_resolved}
    ddp, state = run_port(tgroup, ZeroAlgorithm(wire_precision="int4"), "sgd", False, steps=2)
    with pytest.raises(ValueError, match="per-bucket state"):
        ddp.rebucket(ddp.plan)
    old = ddp._sharded_updater.layout
    new = ShardLayout.from_plan(BucketPlan.from_tree(params_from_jax(jax_params()), 1 << 22, align_elems=N), N)
    moved = ddp.impl.reshard_host_state(state.algo_state, old, new)
    assert [tuple(r.shape) for r in moved["qr_residual"]] == [(N, 248)]
    assert not any(bool(r.any()) for r in moved["qr_residual"])
    assert [tuple(p.shape) for p in moved["pending"]] == [(N, 31)]

