"""The port's overlap mode (each bucket's exchange issued from inside the
backward pass) against its monolithic step and against the JAX engine's
overlap run, on an 8-rank CPU group (``intra_size=4``).

The MLP ``[12, 16, 16, 4]`` with 512-byte buckets has five buckets.  On
and off run the same one-pass backward and the same per-bucket
operations, so the port's two modes agree bit for bit; against the JAX
engine the tolerances are the JAX overlap test's (f32 rtol 1e-5, atol
1e-6; bf16 wire rtol 1e-2, atol 1e-3) and, for the quantized wires,
STEPS x LR x the widest level the exchange meets.  The census counts the
exchanges by wrapping ``impl.overlap_exchange`` on both sides: the
reference's own census test reads compiled HLO, where XLA:CPU merges the
buckets' all-reduces into one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bagua_tpu.algorithms.bytegrad import ByteGradAlgorithm as JaxByteGrad
from bagua_tpu.algorithms.gradient_allreduce import GradientAllReduceAlgorithm as JaxGAR
from bagua_tpu.bucket import BucketPlan as JaxBucketPlan
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP
from bagua_tpu.defs import TensorDeclaration as JaxDecl
from bagua_tpu.models import mlp as jax_mlp
from bagua_tpu.models.vgg import VGG as FlaxVGG

from bagua_tpu_torch.algorithms import (
    Algorithm,
    ByteGradAlgorithm,
    GradientAllReduceAlgorithm,
    GradientAllReduceAlgorithmImpl,
    build_algorithm,
)
from bagua_tpu_torch.algorithms.base import AlgorithmImpl
from bagua_tpu_torch.bucket import BucketPlan
from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.models import mlp
from bagua_tpu_torch.trainer import Trainer
from bagua_tpu_torch.utils import tree_leaves

LAYERS = [12, 16, 16, 4]
BUCKET = 512
LR, STEPS = 0.1, 3

#: wire -> (JAX algorithm kwargs, port algorithm kwargs), for gradient_allreduce
#: ("gar_*") or ByteGrad ("bytegrad_*")
WIRES = {
    "gar_tuple_f32": (dict(fuse="tuple"), dict(fuse="tuple")),
    "gar_flat_f32": (dict(fuse="flat"), dict(fuse="flat")),
    "gar_tuple_bf16": (dict(fuse="tuple", wire_dtype=jnp.bfloat16), dict(fuse="tuple", wire_dtype=torch.bfloat16)),
    "gar_flat_bf16": (dict(fuse="flat", wire_dtype=jnp.bfloat16), dict(fuse="flat", wire_dtype=torch.bfloat16)),
    "gar_int8_flat": (dict(wire_precision="int8"), dict(wire_precision="int8")),
    "gar_int8_hier": (dict(wire_precision="int8", hierarchical=True),
                      dict(wire_precision="int8", hierarchical=True)),
    "bytegrad_flat": (dict(hierarchical=False), dict(hierarchical=False)),
    "bytegrad_hier": (dict(hierarchical=True), dict(hierarchical=True)),
}


@pytest.fixture()
def tgroup():
    return BaguaProcessGroup([torch.device("cpu")] * 8, intra_size=4)


@pytest.fixture(autouse=True)
def _small_ring_blocks(monkeypatch):
    """Blocks of 16 so that the buckets' ring shards span several."""
    monkeypatch.setenv("BAGUA_QR_BLOCK", "16")


def port_algorithm(wire):
    kw = WIRES[wire][1]
    return ByteGradAlgorithm(**kw) if wire.startswith("bytegrad") else GradientAllReduceAlgorithm(**kw)


def jax_algorithm(wire):
    kw = WIRES[wire][0]
    return JaxByteGrad(**kw) if wire.startswith("bytegrad") else JaxGAR(**kw)


def batches(seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(32, LAYERS[0]).astype(np.float32), rng.randn(32, LAYERS[-1]).astype(np.float32))
            for _ in range(STEPS)]


def jax_params(seed=11):
    return jax_mlp.init_mlp(jax.random.PRNGKey(seed), LAYERS)


def port_engine(group, algorithm, overlap, loss=mlp.mse_loss, bucket=BUCKET):
    return DistributedDataParallel(loss, lambda ps: torch.optim.SGD(ps, lr=LR), algorithm, group,
                                   bucket_size_bytes=bucket, overlap=overlap)


def train_port(ddp, params, data, census=False):
    """STEPS steps; with ``census``, checks after each that the overlap
    exchanged every bucket once, in ``backward_order()``."""
    state = ddp.init(params)
    for i, (x, y) in enumerate(data):
        state, losses = ddp.train_step(state, (torch.from_numpy(x), torch.from_numpy(y)))
        if census:
            assert ddp.exchange_order == ddp.plan.backward_order()
            assert ddp.exchange_counts == [i + 1] * ddp.plan.num_buckets
    return state, losses


def level_width(wire, ddp, state, x, y) -> float:
    """The widest quantization level the wire meets this step, in units of
    the averaged gradient.  ByteGrad: over each rank's chunks and the chunks
    of their mean, cut for n = 8 (flat) and n = 2 (hierarchical).  The int8
    ring: every partial sum lies within plus or minus the sum over ranks of
    each rank's largest |gradient|, over 255 levels and the 8 ranks of the
    average."""
    _, grads = ddp._rank_grads(state.params, (torch.from_numpy(x), torch.from_numpy(y)))
    width = 0.0
    for flat in ddp.plan.bucketize(grads):
        if wire.startswith("bytegrad"):
            for n in (2, 8):
                for chunks in (flat.reshape(-1, flat.shape[1] // n), flat.mean(0).reshape(n, -1)):
                    width = max(width, float((chunks.amax(1) - chunks.amin(1)).max()) / 255.0)
        else:
            width = max(width, 2.0 * float(flat.abs().amax(1).sum()) / 255.0 / flat.shape[0])
    return width


@pytest.mark.parametrize("wire", list(WIRES))
def test_overlap_equals_monolithic_bitwise(tgroup, wire):
    """On and off run the same backward and the same per-bucket
    operations: the parameters and losses agree bit for bit."""
    params = params_from_jax(jax.tree.map(np.asarray, jax_params()))
    data = batches()
    finals = {}
    for overlap in (False, True):
        ddp = port_engine(tgroup, port_algorithm(wire), overlap)
        assert ddp.overlap_enabled is overlap and ddp.plan is None
        state, losses = train_port(ddp, params, data, census=overlap)
        assert ddp.plan.num_buckets == 5
        finals[overlap] = (tree_leaves(state.params), losses)
        if not overlap:
            assert ddp.exchange_order == [] and ddp.exchange_counts == [0] * 5
    assert torch.equal(finals[False][1], finals[True][1])
    for a, b in zip(finals[False][0], finals[True][0]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("wire", list(WIRES))
def test_overlap_matches_jax_with_census(group, tgroup, wire):
    """The port's overlap run against the JAX engine's, within the stated
    tolerance; both exchange each bucket once a step.  The port issues them
    in ``backward_order()``; JAX traces its backward rules while it
    transposes the wrapped forward, so its calls come in the reverse of the
    order it wrapped the buckets in: what the census can pin on that side
    is one call per bucket."""
    jp = jax_params()
    data = batches()
    ddp = JaxDDP(jax_mlp.mse_loss, optax.sgd(LR), jax_algorithm(wire), process_group=group,
                 bucket_size_bytes=BUCKET, overlap=True)
    calls = []
    exchange = ddp.impl.overlap_exchange
    ddp.impl.overlap_exchange = lambda bi, *a, **k: calls.append(bi) or exchange(bi, *a, **k)
    jstate = ddp.init(jp)
    for x, y in data:
        jstate, _ = ddp.train_step(jstate, (jnp.asarray(x), jnp.asarray(y)))
    assert sorted(calls) == list(range(ddp.plan.num_buckets))  # traced once: one call per bucket

    tddp = port_engine(tgroup, port_algorithm(wire), True)
    state = tddp.init(params_from_jax(jax.tree.map(np.asarray, jp)))
    assert tddp.plan.backward_order() == ddp.plan.backward_order()
    width = 0.0
    for i, (x, y) in enumerate(data):
        if not wire.startswith("gar_") or "int8" in wire:
            width = max(width, level_width(wire, tddp, state, x, y))
        state, _ = tddp.train_step(state, (torch.from_numpy(x), torch.from_numpy(y)))
        assert tddp.exchange_order == tddp.plan.backward_order()
        assert tddp.exchange_counts == [i + 1] * tddp.plan.num_buckets

    for leaf in tree_leaves(state.params):
        for r in range(1, 8):
            assert torch.equal(leaf[0], leaf[r])
    if "f32" in wire:
        tol = dict(rtol=1e-5, atol=1e-6)
    elif "bf16" in wire:
        tol = dict(rtol=1e-2, atol=1e-3)
    else:
        assert width > 0
        tol = dict(rtol=0, atol=STEPS * LR * width)
    for got, want in zip(tree_leaves(tddp.params_unstacked(state)), jax.tree.leaves(ddp.params_unstacked(jstate))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# Planning and payloads
# ---------------------------------------------------------------------------


def _layout(plan):
    return [(spec.numel, spec.dtype, [(s.name, tuple(s.shape), s.dtype, s.offset) for s in spec.slots])
            for spec in plan.specs]


def _small_vgg():
    model = FlaxVGG(num_classes=10, cfg=(8, "M", 16, "M"), classifier_width=32)
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3)))["params"])


@pytest.mark.parametrize("model", ["mlp", "vgg"])
def test_plan_ordering_and_declarations_match_jax(model):
    """``backward_order``, ``group_leaves`` (names per bucket, in slot
    order), ``declarations`` and ``from_declarations`` give the JAX
    package's answers on the same tree."""
    jp = jax.tree.map(np.asarray, jax_params()) if model == "mlp" else _small_vgg()
    tp = params_from_jax(jp)
    jplan = JaxBucketPlan.from_tree(jp, BUCKET, align_elems=8)
    plan = BucketPlan.from_tree(tp, BUCKET, align_elems=8)
    assert plan.num_buckets > 2
    assert plan.backward_order() == jplan.backward_order()
    assert [list(g) for g in plan.group_leaves(tp)] == [list(g) for g in jplan.group_leaves(jp)]
    for g, spec in zip(plan.group_leaves(tp), plan.specs):
        assert [tuple(t.shape) for t in g.values()] == [s.shape for s in spec.slots]
    assert [[(d.name, d.num_elements, d.dtype) for d in b] for b in plan.declarations()] == \
        [[(d.name, d.num_elements, d.dtype) for d in b] for b in jplan.declarations()]
    back = plan.ungroup_leaves(plan.group_leaves(tp))
    assert all(a is b for a, b in zip(tree_leaves(back), tree_leaves(tp)))
    # another assignment: the buckets merged pairwise, each slot list reversed
    decls = [d for b in plan.declarations() for d in b]
    merged = [decls[i:i + 3][::-1] for i in range(0, len(decls), 3)]
    got = BucketPlan.from_declarations(merged, tp, align_elems=8)
    want = JaxBucketPlan.from_declarations(
        [[JaxDecl(name=d.name, num_elements=d.num_elements, dtype=d.dtype) for d in b] for b in merged],
        jp, align_elems=8)
    assert _layout(got) == _layout(want)
    assert got.backward_order() == want.backward_order()
    with pytest.raises(ValueError, match="empty"):
        BucketPlan.from_declarations([[]], tp)


def test_plan_payload_round_trip(tgroup):
    """``export_plan_payload`` -> ``adopt_plan_payload`` restores the plan,
    the overlap knob, the per-bucket precisions and the plan's source; a
    payload written under another algorithm is refused."""
    params = mlp.init_mlp(torch.Generator().manual_seed(0), LAYERS, device="cpu")
    a = port_engine(tgroup, GradientAllReduceAlgorithm(), True)
    a.init(params)
    merged = [[d for b in a.plan.declarations()[:3] for d in b]] + a.plan.declarations()[3:]
    a.rebucket(BucketPlan.from_declarations(merged, params, align_elems=8), reason="autopilot:straggler")
    payload = a.export_plan_payload()
    assert payload["config"] == {"algorithm": "gradient_allreduce", "overlap": True, "source": "autopilot",
                                 "wire_precision": "f32", "bucket_precisions": ["f32"] * 3}
    b = port_engine(tgroup, GradientAllReduceAlgorithm(), False)
    b.init(params)
    assert b.adopt_plan_payload(payload)
    assert _layout(b.plan) == _layout(a.plan) and b.plan.num_buckets == 3
    assert b.overlap is True and b.overlap_enabled and b.plan_version == 1
    assert b.export_plan_payload()["config"]["source"] == "autopilot"
    assert not b.adopt_plan_payload({"buckets": []})
    with pytest.raises(ValueError, match="bytegrad"):
        port_engine(tgroup, ByteGradAlgorithm(), True).adopt_plan_payload(payload)

    c = port_engine(tgroup, GradientAllReduceAlgorithm(wire_precision="auto"), "auto")
    c.init(params)
    assert c.apply_precision_plan(["int8", "f32", "int4", "f32", "int8"], reason="manual")
    d = port_engine(tgroup, GradientAllReduceAlgorithm(wire_precision="auto"), "auto")
    d.init(params)
    assert d.adopt_plan_payload(c.export_plan_payload())
    assert d.impl.bucket_precisions(d.plan) == ["int8", "f32", "int4", "f32", "int8"]
    assert d.plan_version == 0 and not d.overlap_enabled


def test_rebucket_under_overlap(tgroup):
    """The next step's hooks follow the new plan: the bucket count changes,
    the exchanges follow it, and the parameters equal a monolithic run
    without the rebucket (the f32 exchange is elementwise)."""
    params = params_from_jax(jax.tree.map(np.asarray, jax_params()))
    data = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in batches(3)]
    ddp = port_engine(tgroup, GradientAllReduceAlgorithm(), True)
    state = ddp.init(params)
    state, _ = ddp.train_step(state, data[0])
    assert ddp.exchange_counts == [1] * 5
    with pytest.raises(ValueError, match="vocabulary"):
        ddp.rebucket(ddp.plan, reason="because")
    with pytest.raises(ValueError, match="detail suffix"):
        ddp.rebucket(ddp.plan, reason="health")
    ddp.rebucket(ddp.impl.tensors_to_buckets(params, 1024), reason="manual")
    assert ddp.plan.num_buckets == 3 and ddp.plan_version == 1
    for x in data[1:]:
        state, _ = ddp.train_step(state, x)
    assert ddp.exchange_counts == [2, 2, 2] and ddp.exchange_order == ddp.plan.backward_order() == [2, 1, 0]

    mono = port_engine(tgroup, GradientAllReduceAlgorithm(), False)
    mstate = mono.init(params)
    for x in data:
        mstate, _ = mono.train_step(mstate, x)
    for a, b in zip(tree_leaves(state.params), tree_leaves(mstate.params)):
        assert torch.equal(a, b)

    int4 = port_engine(tgroup, GradientAllReduceAlgorithm(wire_precision="int4"), "auto")
    int4.init(params)
    with pytest.raises(ValueError, match="per-bucket state"):
        int4.rebucket(int4.plan)


# ---------------------------------------------------------------------------
# The overlap knob
# ---------------------------------------------------------------------------


class _VariantSwitchingImpl(GradientAllReduceAlgorithmImpl):
    stable_step_variant = False


class _WeightModeImpl(AlgorithmImpl):
    """Weight mode: every bucket's weights come back as zeros."""

    supports_overlap = True
    overlap_mode = "weight"

    def overlap_exchange(self, bucket_idx, grads, ctx, params_leaves=None):
        return [torch.zeros_like(p) for p in params_leaves]


def _algorithm(impl_cls):
    algo = Algorithm()
    algo.reify = lambda group: impl_cls(group)
    return algo


def test_overlap_knob_guards(group, tgroup):
    """The knob's values, the named rejections and the ``"auto"``
    resolution, as the JAX engine resolves them."""
    with pytest.raises(ValueError, match="overlap must be True, False or 'auto'"):
        port_engine(tgroup, GradientAllReduceAlgorithm(), "yes")
    for kw in (dict(wire_precision="int4"), dict(wire_precision="auto")):
        with pytest.raises(ValueError, match="GradientAllReduceAlgorithmImpl keeps per-bucket state"):
            port_engine(tgroup, GradientAllReduceAlgorithm(**kw), True)
    with pytest.raises(ValueError, match="_VariantSwitchingImpl switches its step variant"):
        port_engine(tgroup, _algorithm(_VariantSwitchingImpl), True)
    with pytest.raises(ValueError, match="AlgorithmImpl does not implement overlap_exchange"):
        port_engine(tgroup, _algorithm(AlgorithmImpl), True)
    with pytest.raises(ValueError, match="fuse must be"):
        GradientAllReduceAlgorithm(fuse="concat").reify(tgroup)
    with pytest.raises(ValueError, match="mutually exclusive"):
        GradientAllReduceAlgorithm(wire_precision="int8", wire_dtype=torch.bfloat16).reify(tgroup)

    resolved = {name: port_engine(tgroup, algo, "auto").overlap_enabled for name, algo in {
        "f32": GradientAllReduceAlgorithm(), "bf16": GradientAllReduceAlgorithm(wire_dtype=torch.bfloat16),
        "int8": GradientAllReduceAlgorithm(wire_precision="int8"),
        "int4": GradientAllReduceAlgorithm(wire_precision="int4"),
        "auto": GradientAllReduceAlgorithm(wire_precision="auto"),
        "bytegrad": ByteGradAlgorithm(), "variant": _algorithm(_VariantSwitchingImpl)}.items()}
    assert resolved == {"f32": True, "bf16": True, "int8": True, "int4": False, "auto": False,
                        "bytegrad": True, "variant": False}
    jax_resolved = {name: JaxDDP(jax_mlp.mse_loss, optax.sgd(LR), algo, process_group=group).overlap_enabled for name, algo in {
        "f32": JaxGAR(), "int8": JaxGAR(wire_precision="int8"), "int4": JaxGAR(wire_precision="int4"),
        "auto": JaxGAR(wire_precision="auto"), "bytegrad": JaxByteGrad()}.items()}
    assert jax_resolved == {k: resolved[k] for k in jax_resolved}
    trainer = Trainer(mlp.mse_loss, torch.optim.SGD, ByteGradAlgorithm(), tgroup, bucket_size_bytes=BUCKET)
    assert trainer.ddp.overlap_enabled and trainer.ddp.bucket_size_bytes == BUCKET
    assert not Trainer(mlp.mse_loss, torch.optim.SGD, ByteGradAlgorithm(), tgroup, overlap=False).ddp.overlap_enabled

    # weight mode: the exchanged weights are what the optimizer steps, with
    # the gradients taken at the weights before the exchange
    weight = port_engine(tgroup, _algorithm(_WeightModeImpl), True)
    state = weight.init(mlp.init_mlp(torch.Generator().manual_seed(0), LAYERS, device="cpu"))
    batch = tuple(torch.from_numpy(t) for t in batches()[0])
    _, grads = weight._rank_grads(state.params, batch)
    state, _ = weight.train_step(state, batch)
    assert weight.exchange_counts == [1] * weight.plan.num_buckets
    for p, g in zip(tree_leaves(state.params), tree_leaves(grads)):
        assert torch.equal(p, torch.zeros_like(g).add_(g, alpha=-LR))


def test_build_algorithm_and_shard_batch(tgroup):
    assert isinstance(build_algorithm("bytegrad", hierarchical=False), ByteGradAlgorithm)
    gar = build_algorithm("gradient_allreduce", lr=0.5, wire_precision="int8")
    assert isinstance(gar, GradientAllReduceAlgorithm) and gar.wire_precision == "int8"
    with pytest.raises(KeyError, match="unknown algorithm 'async'"):
        build_algorithm("async")
    batch = (torch.zeros(8, 3), torch.ones(8))
    assert port_engine(tgroup, gar, "auto").shard_batch(batch) is batch


@pytest.mark.parametrize("wire", ["gar_tuple_f32", "bytegrad_hier"])
def test_unused_parameter_same_on_and_off(tgroup, wire):
    """A loss that ignores one parameter: its gradient is zeros, its bucket
    never completes in the backward and is exchanged after it; on and off
    agree bit for bit, and the unused parameter stays put."""
    params = mlp.init_mlp(torch.Generator().manual_seed(1), LAYERS, device="cpu")
    params["unused"] = {"w": torch.ones(4)}
    loss = lambda p, b: mlp.mse_loss({k: v for k, v in p.items() if k != "unused"}, b)  # noqa: E731
    finals = []
    for overlap in (False, True):
        ddp = port_engine(tgroup, port_algorithm(wire), overlap, loss=loss)
        state, _ = train_port(ddp, params, batches(2), census=overlap)
        finals.append(tree_leaves(state.params))
    for a, b in zip(*finals):
        assert torch.equal(a, b)
    assert torch.equal(state.params["unused"]["w"], torch.ones(8, 4))


def test_profile_bucket_order(tgroup):
    """Arrival times, one per bucket in bucket order, from the overlap
    hooks (host clock on the CPU); the state is not touched.  The MLP's
    last layer completes first; within a layer the bias arrives before the
    kernel, which is why the exchange waits for ``backward_order()``."""
    params = mlp.init_mlp(torch.Generator().manual_seed(2), LAYERS, device="cpu")
    ddp = port_engine(tgroup, GradientAllReduceAlgorithm(), True)
    state = ddp.init(params)
    before = [t.clone() for t in tree_leaves(state.params)]
    x, y = batches()[0]
    times = ddp.profile_bucket_order(state, (torch.from_numpy(x), torch.from_numpy(y)))
    assert len(times) == ddp.plan.num_buckets and all(np.isfinite(t) and t >= 0 for t in times)
    assert ddp.plan.backward_order() == [4, 3, 2, 1, 0]
    assert sorted(range(5), key=times.__getitem__) == [4, 2, 3, 0, 1]
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(state.params)))
    assert ddp.exchange_counts == [0] * ddp.plan.num_buckets
