"""The port's static collective-program gate against the JAX package's.

Three contracts, on the 8-rank CPU group (``intra_size=4``) and the JAX
package's MLP:

* the four checkers (a copy) give the JAX checkers' ``(check, severity)``
  findings on the same descriptor lists: JAX's own adversarial programs
  (rank-conditional, sub-axis, ``while``, the bounded-staleness marker),
  converted field for field into the port's descriptors, the
  off-by-one-bytes and stale-plan-version configurations, and the
  hand-built cond-sibling list;
* the port's captured IR (a dry run on ``meta``) equals JAX's traced IR as
  a multiset per ``(bucket, phase)`` of ``(primitive, axes, ring_size,
  nbytes, wire_bytes)``, and the predicted flight programs are equal
  record for record under ``canonical_records``, for ``gradient_allreduce``
  (flat and tuple), the int8 and int4 rings, ByteGrad and ZeRO;
* the engine's gate behaves as the JAX engine's (``tests/
  test_static_verify.py`` and the named-mesh arms of ``tests/
  test_mesh_engine.py``): strict blocks dispatch and caches nothing, passes
  real engines, warn logs and dispatches and survives a failed dry run,
  every switch re-verifies and rolls back, the gate sees the post-reshard
  layout, and a step with the gate ``off`` is bitwise the step with it
  ``strict``.
"""

import collections
import dataclasses
import logging
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import bagua_tpu  # noqa: F401
import bagua_tpu.analysis as jan
from bagua_tpu.algorithms import build_algorithm as jax_build
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP
from bagua_tpu.models import mlp as jax_mlp
from bagua_tpu.observability.scope_grammar import format_stale_scope

import bagua_tpu_torch.analysis as tan
from bagua_tpu_torch.algorithms import build_algorithm
from bagua_tpu_torch.algorithms.decentralized import DecentralizedAlgorithm
from bagua_tpu_torch.algorithms.gradient_allreduce import GradientAllReduceAlgorithm
from bagua_tpu_torch.algorithms.stale import StaleSyncAlgorithm
from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.mesh import MeshSpec
from bagua_tpu_torch.models import mlp
from bagua_tpu_torch.observability.flight_recorder import FlightRecorder
from bagua_tpu_torch.observability.telemetry import Telemetry
from bagua_tpu_torch.sharded.algorithm import ZeroAlgorithm
from bagua_tpu_torch.utils import tree_leaves

N = 8
LAYERS = [64, 128, 128, 64]
BUCKET = 1 << 12


@pytest.fixture()
def tgroup():
    return BaguaProcessGroup([torch.device("cpu")] * N, intra_size=4)


def np_batch(seed=0, n=32, layers=LAYERS):
    rng = np.random.RandomState(seed)
    return rng.randn(n, layers[0]).astype(np.float32), rng.randn(n, layers[-1]).astype(np.float32)


def tbatch(seed=0, **kw):
    return tuple(torch.from_numpy(a) for a in np_batch(seed, **kw))


def jbatch(seed=0, **kw):
    return tuple(jnp.asarray(a) for a in np_batch(seed, **kw))


def jax_params(layers=LAYERS):
    return jax.tree.map(np.asarray, jax_mlp.init_mlp(jax.random.PRNGKey(0), layers))


def make_ddp(group, algo=None, overlap=False, telemetry=None, **kw):
    return DistributedDataParallel(
        mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
        algo or build_algorithm("gradient_allreduce"), group, bucket_size_bytes=BUCKET,
        overlap=overlap, telemetry=telemetry, **kw,
    )


def port_descriptors(jprogram):
    """JAX's descriptors, field for field, as the port's."""
    return tan.CollectiveProgram(
        collectives=[tan.CollectiveDescriptor(**dataclasses.asdict(d)) for d in jprogram.collectives],
        axis_sizes=dict(jprogram.axis_sizes),
    )


def verdicts(findings):
    return sorted((f.check, f.severity) for f in findings)


# ---------------------------------------------------------------------------
# The checkers on the same descriptors
# ---------------------------------------------------------------------------


def _rank_conditional(x):
    r = jax.lax.axis_index("intra")
    return jax.lax.cond(r == 0, lambda v: jax.lax.psum(v, "intra"), lambda v: v * 4.0, x)


def _subaxis(x):
    half_uniform = jax.lax.psum(jax.lax.axis_index("inter"), "intra")
    return jax.lax.cond(half_uniform > 0, lambda v: jax.lax.psum(v, "intra"), lambda v: v * 4.0, x)


def _laundered(x):
    uniform = jax.lax.psum(jax.lax.psum(jax.lax.axis_index("inter"), "intra"), "inter")
    return jax.lax.cond(uniform > 0, lambda v: jax.lax.psum(v, "intra"), lambda v: v * 4.0, x)


def _while_uniform(x):
    def cond_fn(c):
        return jax.lax.psum(jnp.sum(c[1]), "intra") > c[0]

    return jax.lax.while_loop(cond_fn, lambda c: (c[0] + 1, c[1] * 0.5), (jnp.float32(0.0), x))[1]


def _while_tainted(x):
    def cond_fn(c):
        return c[0] < jax.lax.axis_index("intra")

    return jax.lax.while_loop(cond_fn, lambda c: (c[0] + 1, jax.lax.psum(c[1], "intra")), (jnp.int32(0), x))[1]


def _stale(mark=True, equal_bytes=True, both_exchange=True):
    from contextlib import nullcontext

    scope = (lambda: jax.named_scope(format_stale_scope(2))) if mark else nullcontext

    def body(x):
        def fresh(v):
            with scope():
                return jax.lax.psum(v, "intra")

        def replay(v):
            if not both_exchange:
                return v * 2.0
            if not equal_bytes:
                with scope():
                    half = jax.lax.psum(v[:, :2], "intra")
                return jnp.concatenate([half, v[:, 2:]], axis=1)
            with scope():
                return jax.lax.psum(v * 0.5, "intra")

        return jax.lax.cond(jax.lax.axis_index("intra") == 0, fresh, replay, x)

    return body


PROGRAMS = {
    "rank_conditional": _rank_conditional,
    "subaxis": _subaxis,
    "laundered": _laundered,
    "while_uniform": _while_uniform,
    "while_tainted": _while_tainted,
    "stale_sanctioned": _stale(),
    "stale_unequal_bytes": _stale(equal_bytes=False),
    "stale_single_branch": _stale(both_exchange=False),
    "stale_unmarked": _stale(mark=False),
}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_rank_invariance_findings_match_jax(group, name):
    fn = group.shard_map(PROGRAMS[name], in_specs=(P("intra"),), out_specs=P("intra"))
    jprog, _ = jan.collect_ir(fn, (jnp.ones((8, 4), jnp.float32),), dict(group.mesh.shape))
    assert jprog.collectives
    want = jan.check_rank_invariance(jprog)
    got = tan.check_rank_invariance(port_descriptors(jprog))
    assert verdicts(got) == verdicts(want)
    assert [f.message for f in got] == [f.message for f in want]


def test_row_subset_collective_is_rank_conditional(tgroup):
    """The port's rank-conditional flag: a collective whose operand lacks
    some of its group's rank rows is flagged (and refused by the
    collective itself), and the checker rejects it."""
    from bagua_tpu_torch.communication import allreduce

    with tan.capture_collectives() as descriptors:
        allreduce(torch.ones((N, 4)), comm=tgroup)
        with pytest.raises(ValueError):
            allreduce(torch.ones((N - 1, 4)), comm=tgroup)
    assert [d.rank_conditional for d in descriptors] == [False, True]
    program = tan.CollectiveProgram(collectives=descriptors, axis_sizes={"inter": 2, "intra": 4})
    assert verdicts(tan.check_rank_invariance(program)) == [("rank_invariance", "error")]


def test_cond_sibling_branches_not_double_counted():
    """The hand-built list of ``tests/test_static_verify.py``: sibling
    branches of one cond are charged their max."""

    def desc(pkg, i, path, wire):
        return pkg.CollectiveDescriptor(
            index=i, primitive="psum", reduce_op="sum", axes=("intra",), ring_size=4, shapes=((8,),),
            dtypes=("float32",), nbytes=32, wire_bytes=wire, label=f"d{i}",
            scope={"algo": "toy", "bucket": 0, "phase": "mono"}, mp=None, qr=None, path=path,
            rank_conditional=False, cond_label=None,
        )

    rows = []
    for pkg in (jan, tan):
        program = pkg.CollectiveProgram(
            collectives=[desc(pkg, 0, (), 50), desc(pkg, 1, ("cond#0@0",), 100), desc(pkg, 2, ("cond#0@1",), 100),
                         desc(pkg, 3, ("cond#1@0",), 7)],
            axis_sizes={"intra": 4},
        )
        findings, table = pkg.check_wire_exactness(program, pkg.WireModelConfig(algo="other", plan=SimpleNamespace(specs=()), n=4))
        rows.append((verdicts(findings), table))
    assert rows[0] == rows[1]
    assert rows[1][1][0]["observed_bytes"] == 50 + 100 + 7


def _jax_engine(group, name="gradient_allreduce", **kw):
    ddp = JaxDDP(jax_mlp.mse_loss, optax.sgd(0.1, momentum=0.9), jax_build(name, lr=0.1, **kw),
                 process_group=group, bucket_size_bytes=BUCKET, overlap=False)
    state = ddp.init(jax_mlp.init_mlp(jax.random.PRNGKey(0), LAYERS))
    return ddp, state


def _jax_ir(ddp, state):
    program, events = jan.collect_ir(
        ddp._build_sharded("default"),
        (jax.eval_shape(lambda s: s, state), jax.eval_shape(lambda b: b, jbatch())),
        dict(ddp.group.mesh.shape),
    )
    return program, events


def _port_config(jcfg, **changes):
    """The JAX engine's wire-model configuration as the port's (the plan's
    specs are read by duck typing)."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields.update(changes)
    return tan.WireModelConfig(**fields)


def test_off_by_one_bucket_bytes_rejected_by_both(group):
    jd, js = _jax_engine(group, fuse="flat")
    try:
        jprog, _ = _jax_ir(jd, js)
        jcfg = jan.WireModelConfig.from_engine(jd)
        specs = list(jcfg.plan.specs)
        specs[0] = dataclasses.replace(specs[0], numel=specs[0].numel + 1)
        for cfg_j in (jcfg, dataclasses.replace(jcfg, plan=SimpleNamespace(specs=tuple(specs)))):
            want, _ = jan.check_wire_exactness(jprog, cfg_j)
            got, table = tan.check_wire_exactness(port_descriptors(jprog), _port_config(cfg_j))
            assert verdicts(got) == verdicts(want)
            assert [f.bucket for f in got] == [f.bucket for f in want]
        assert verdicts(got) and all(f.check == "wire_exactness" for f in got)
        assert any("bucket=0" in f.label for f in got)
    finally:
        jd.shutdown()


def test_stale_plan_version_rejected_by_both(group, tgroup):
    jd, js = _jax_engine(group)
    ddp = make_ddp(tgroup)
    try:
        state = ddp.init(params_from_jax(jax_params()))
        jprog, _ = _jax_ir(jd, js)
        jcfg = jan.WireModelConfig.from_engine(jd)
        for pv in (jcfg.plan_version + 1, jcfg.plan_version):
            want = jan.check_plan_conformance(jprog, jcfg, payload={"plan_version": pv})
            got = tan.check_plan_conformance(port_descriptors(jprog), _port_config(jcfg), payload={"plan_version": pv})
            assert verdicts(got) == verdicts(want)
        stale = tan.verify_step_program(ddp, state, tbatch(), payload={"plan_version": ddp.plan_version + 1})
        assert not stale.ok and all(f.check == "plan_conformance" for f in stale.errors)
        assert any("plan_version" in f.message for f in stale.errors)
        with pytest.raises(tan.StaticVerifyError, match="plan_conformance"):
            stale.raise_if_failed()
        assert tan.verify_step_program(ddp, state, tbatch(), payload={"plan_version": ddp.plan_version}).ok
    finally:
        jd.shutdown()


# ---------------------------------------------------------------------------
# The captured IR and the predicted flight program against JAX's
# ---------------------------------------------------------------------------

IR_CASES = {
    "tuple": ("gradient_allreduce", dict(fuse="tuple")),
    "flat": ("gradient_allreduce", dict(fuse="flat")),
    "int8": ("gradient_allreduce", dict(wire_precision="int8")),
    "int4": ("gradient_allreduce", dict(wire_precision="int4")),
    "bytegrad": ("bytegrad", {}),
    "zero": ("zero", {}),
    "zero-int8": ("zero", dict(wire_precision="int8")),
    "zero-bytegrad": ("zero", dict(compression="bytegrad")),
}


def census(program):
    out = collections.defaultdict(collections.Counter)
    for d in program.collectives:
        out[(d.bucket, d.phase)][(d.primitive, tuple(d.axes), d.ring_size, d.nbytes, d.wire_bytes)] += 1
    return dict(out)


@pytest.fixture()
def small_blocks(monkeypatch):
    """Ring blocks of 64 in both packages, so that a shard spans several."""
    monkeypatch.setenv("BAGUA_QR_BLOCK", "64")


@pytest.mark.parametrize("case", list(IR_CASES))
def test_captured_ir_and_prediction_match_jax(group, tgroup, small_blocks, case):
    name, kw = IR_CASES[case]
    jd, js = _jax_engine(group, name, **kw)
    try:
        jprog, _ = _jax_ir(jd, js)
        jrep = jan.verify_step_program(jd, js, jbatch())
    finally:
        jd.shutdown()
    ddp = make_ddp(tgroup, build_algorithm(name, **kw))
    state = ddp.init(params_from_jax(jax_params()))
    program, _ = tan.dry_run(ddp, state, tbatch())
    assert census(program) == census(jprog)
    if "wire_precision" in kw:
        assert any(d.qr for d in program.collectives), "the ring's sub-scopes were not captured"
    rep = tan.verify_step_program(ddp, state, tbatch())
    assert rep.ok and jrep.ok, rep.summary()
    assert tan.canonical_records(rep.predicted) == tan.canonical_records(jrep.predicted)
    assert tan.canonical_records(rep.captured) == tan.canonical_records(rep.predicted)
    assert rep.wire_table == jrep.wire_table


def test_dry_run_leaves_the_state_and_the_kernels_alone(tgroup):
    """The dry run is on meta: the live state is untouched and no wrapper
    counts a launch."""
    from bagua_tpu_torch.kernels import minmax_uint8, quantized_ring

    ddp = make_ddp(tgroup, build_algorithm("gradient_allreduce", wire_precision="int8"))
    state = ddp.init(params_from_jax(jax_params()))
    before = [t.clone() for t in tree_leaves(state.params)]
    counts = [k.launches for k in minmax_uint8.KERNELS + quantized_ring.KERNELS]
    program, events = tan.dry_run(ddp, state, tbatch())
    assert program.collectives and events
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(state.params)))
    assert [k.launches for k in minmax_uint8.KERNELS + quantized_ring.KERNELS] == counts
    assert ddp._capture is None and ddp._ir_capture is None


# ---------------------------------------------------------------------------
# The engine's gate
# ---------------------------------------------------------------------------


def _tamper(monkeypatch):
    orig = tan.WireModelConfig.from_engine.__func__

    def tampered(cls, ddp):
        cfg = orig(cls, ddp)
        specs = list(cfg.plan.specs)
        specs[0] = dataclasses.replace(specs[0], numel=specs[0].numel + 1)
        return dataclasses.replace(cfg, plan=SimpleNamespace(specs=tuple(specs)))

    monkeypatch.setattr(tan.WireModelConfig, "from_engine", classmethod(tampered))


def test_strict_gate_blocks_dispatch(tgroup, monkeypatch):
    monkeypatch.setenv("BAGUA_STATIC_VERIFY", "strict")
    _tamper(monkeypatch)
    tel = Telemetry(flight=FlightRecorder(capacity=64, rank=0, world_size=1))
    ddp = make_ddp(tgroup, GradientAllReduceAlgorithm(fuse="flat"), telemetry=tel)
    state = ddp.init(params_from_jax(jax_params()))
    before = [t.clone() for t in tree_leaves(state.params)]
    with pytest.raises(tan.StaticVerifyError, match="wire_exactness"):
        ddp.train_step(state, tbatch())
    assert tel.flight.records() == [], "collectives dispatched anyway"
    assert ddp._flight_programs == {} and ddp._predicted_programs == {}
    # the rejected variant is not cached as seen: a retry verifies again
    assert ddp._variants_seen == set()
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(state.params)))
    with pytest.raises(tan.StaticVerifyError, match="wire_exactness"):
        ddp.train_step(state, tbatch())
    assert tel.flight.records() == []


@pytest.mark.parametrize("name", ["gradient_allreduce", "zero"])
def test_strict_gate_passes_real_engines(tgroup, monkeypatch, name):
    monkeypatch.setenv("BAGUA_STATIC_VERIFY", "strict")
    tel = Telemetry(flight=FlightRecorder(capacity=128, rank=0, world_size=1))
    ddp = make_ddp(tgroup, build_algorithm(name), telemetry=tel)
    state = ddp.init(params_from_jax(jax_params()))
    state, losses = ddp.train_step(state, tbatch())
    assert torch.isfinite(losses).all()
    variant = ddp.impl.step_variant(0)
    predicted, captured = ddp._predicted_programs.get(variant), ddp._flight_programs.get(variant)
    assert predicted and captured
    assert tan.canonical_records(predicted) == tan.canonical_records(captured)


def test_strict_gate_passes_bounded_staleness_engines(tgroup, monkeypatch):
    monkeypatch.setenv("BAGUA_STATIC_VERIFY", "strict")
    for algo in (StaleSyncAlgorithm(staleness_tau=2), DecentralizedAlgorithm(hierarchical=False, staleness_tau=2)):
        ddp = DistributedDataParallel(mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.1), algo, tgroup,
                                      bucket_size_bytes=BUCKET)
        try:
            state = ddp.init(params_from_jax(jax_params()))
            state = ddp.apply_degradation_directive(state, (2,))
            state, losses = ddp.train_step(state, tbatch())
            assert ddp._predicted_programs
            assert ddp.apply_staleness(1, reason="planner") is True
            assert ddp._predicted_programs, "the tau switch did not re-verify"
            state, losses = ddp.train_step(state, tbatch())
            assert torch.isfinite(losses).all()
        finally:
            ddp.shutdown()


def test_warn_gate_logs_but_dispatches(tgroup, monkeypatch, caplog):
    monkeypatch.setenv("BAGUA_STATIC_VERIFY", "warn")
    _tamper(monkeypatch)
    ddp = make_ddp(tgroup, GradientAllReduceAlgorithm(fuse="flat"))
    state = ddp.init(params_from_jax(jax_params()))
    with caplog.at_level(logging.WARNING, logger="bagua_tpu_torch.ddp"):
        state, losses = ddp.train_step(state, tbatch())
    assert state.step == 1 and torch.isfinite(losses).all()
    assert any("wire_exactness" in r.message for r in caplog.records)


def test_warn_gate_survives_dry_run_failure(tgroup, monkeypatch, caplog):
    def boom(*a, **kw):
        raise TypeError("synthetic dry-run failure")

    monkeypatch.setattr(tan, "verify_step_program", boom)
    monkeypatch.setenv("BAGUA_STATIC_VERIFY", "warn")
    ddp = make_ddp(tgroup)
    state = ddp.init(params_from_jax(jax_params()))
    with caplog.at_level(logging.WARNING, logger="bagua_tpu_torch.ddp"):
        state, _ = ddp.train_step(state, tbatch())
    assert state.step == 1
    assert any("dry run failed" in r.message for r in caplog.records)

    monkeypatch.setenv("BAGUA_STATIC_VERIFY", "strict")
    ddp = make_ddp(tgroup)
    state = ddp.init(params_from_jax(jax_params()))
    with pytest.raises(TypeError, match="synthetic dry-run failure"):
        ddp.train_step(state, tbatch())
    assert ddp._variants_seen == set()


def test_rebucket_reverifies_and_rolls_back(tgroup, monkeypatch):
    monkeypatch.setenv("BAGUA_STATIC_VERIFY", "strict")
    ddp = make_ddp(tgroup)
    state = ddp.init(params_from_jax(jax_params()))
    # before the gate has seen a batch a rebucket verifies nothing
    calls = []
    orig = tan.verify_step_program

    def spy(*a, **kw):
        calls.append(kw.get("variant"))
        return orig(*a, **kw)

    monkeypatch.setattr(tan, "verify_step_program", spy)
    state, _ = ddp.train_step(state, tbatch())
    old_plan, old_version = ddp.plan, ddp.plan_version
    ddp.rebucket(ddp.impl.tensors_to_buckets(ddp._tree_template, 1 << 14))
    assert ddp.plan_version > old_version and len(calls) == 2
    adopted = ddp.plan

    def failing(*a, **kw):
        raise tan.StaticVerifyError([])

    monkeypatch.setattr(tan, "verify_step_program", failing)
    with pytest.raises(tan.StaticVerifyError):
        ddp.rebucket(old_plan)
    assert ddp.plan is adopted, "the rejected plan was not rolled back"
    monkeypatch.setattr(tan, "verify_step_program", orig)
    state, losses = ddp.train_step(state, tbatch())
    assert torch.isfinite(losses).all()


def test_precision_and_algorithm_switches_reverify_and_roll_back(tgroup, monkeypatch):
    monkeypatch.setenv("BAGUA_STATIC_VERIFY", "strict")
    ddp = make_ddp(tgroup, build_algorithm("gradient_allreduce", wire_precision="auto"))
    state = ddp.init(params_from_jax(jax_params()))
    state, _ = ddp.train_step(state, tbatch())
    n = ddp.plan.num_buckets
    assert ddp.apply_precision_plan(["int8"] * n)
    assert ddp._predicted_programs, "the precision switch did not re-verify"

    def failing(*a, **kw):
        raise tan.StaticVerifyError([])

    orig = tan.verify_step_program
    monkeypatch.setattr(tan, "verify_step_program", failing)
    with pytest.raises(tan.StaticVerifyError):
        ddp.apply_precision_plan(["f32"] * n)
    assert ddp.impl.bucket_precisions(ddp.plan) == ["int8"] * n
    with pytest.raises(tan.StaticVerifyError):
        ddp.switch_algorithm(state, "zero")
    assert ddp.impl.algo_name == "gradient_allreduce"
    monkeypatch.setattr(tan, "verify_step_program", orig)
    state = ddp.switch_algorithm(state, "zero")
    assert ddp.impl.algo_name == "zero" and ddp._predicted_programs
    state, losses = ddp.train_step(state, tbatch())
    assert torch.isfinite(losses).all()


def test_gate_verifies_post_reshard_layout(tgroup, monkeypatch):
    monkeypatch.setenv("BAGUA_STATIC_VERIFY", "strict")
    verified = []
    orig = tan.verify_step_program

    def spy(ddp_, state_, batch_, **kw):
        verified.append(state_)
        return orig(ddp_, state_, batch_, **kw)

    monkeypatch.setattr(tan, "verify_step_program", spy)
    ddp = make_ddp(tgroup, build_algorithm("zero"))
    state = ddp.init(params_from_jax(jax_params()))
    state, _ = ddp.train_step(state, tbatch())
    ddp.rebucket(ddp.impl.tensors_to_buckets(ddp._tree_template, 1 << 14))
    assert ddp._pending_reshard is not None
    state, losses = ddp.train_step(state, tbatch())
    assert torch.isfinite(losses).all()
    pending = verified[-1].algo_state["pending"]
    n = tgroup.exchange_size
    assert [tuple(p.shape) for p in pending] == [(N, spec.numel // n) for spec in ddp.plan.specs]
    assert all(p.is_meta for p in pending), "the gate ran on the stale live state"
    assert verified[-1].optimizer is None


# ---------------------------------------------------------------------------
# Named meshes (the arms of tests/test_mesh_engine.py)
# ---------------------------------------------------------------------------

MESH_LAYERS = [12, 16, 16, 4]


@pytest.mark.parametrize("axes, algo, want", [({"dp": 4, "tp": 2}, GradientAllReduceAlgorithm, ("dp",)),
                                              ({"dp": 4, "fsdp": 2}, ZeroAlgorithm, ("dp", "fsdp"))],
                         ids=["dp4xtp2", "dp4xfsdp2"])
def test_static_verify_2d_program(axes, algo, want):
    g = BaguaProcessGroup([torch.device("cpu")] * N, mesh_spec=MeshSpec(axes))
    ddp = make_ddp(g, algo())
    state = ddp.init(params_from_jax(jax_params(MESH_LAYERS)))
    cfg = tan.WireModelConfig.from_engine(ddp)
    assert cfg.exchange_axes == want and cfg.mesh_axes == tuple(axes) and cfg.n == g.exchange_size
    report = tan.verify_step_program(ddp, state, tbatch(layers=MESH_LAYERS), variant=ddp.impl.step_variant(0))
    assert report.ok, report.errors
    exchange = [d for d in tan.dry_run(ddp, state, tbatch(layers=MESH_LAYERS))[0].collectives if d.scope]
    assert exchange and all(set(d.axes) <= set(want) for d in exchange)


def test_axis_conformance_flags_stray_exchange_axis():
    g = BaguaProcessGroup([torch.device("cpu")] * N, mesh_spec=MeshSpec({"dp": 4, "tp": 2}))
    ddp = make_ddp(g)
    state = ddp.init(params_from_jax(jax_params(MESH_LAYERS)))
    program, _ = tan.dry_run(ddp, state, tbatch(layers=MESH_LAYERS))
    cfg = tan.WireModelConfig.from_engine(ddp)
    assert not [f for f in tan.check_plan_conformance(program, cfg) if f.severity == "error"]
    lying = dataclasses.replace(cfg, exchange_axes=("tp",))
    findings = [f for f in tan.check_plan_conformance(program, lying) if f.severity == "error" and "stray" in f.message]
    assert findings and any("'dp'" in f.message for f in findings)


# ---------------------------------------------------------------------------
# The gate changes nothing the step computes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name, kw, overlap", [("gradient_allreduce", {}, True), ("bytegrad", {}, True),
                                                ("gradient_allreduce", dict(wire_precision="int8"), False),
                                                ("zero", {}, True)],
                         ids=["allreduce-overlap", "bytegrad-overlap", "int8", "zero-overlap"])
def test_gate_off_and_strict_steps_are_bitwise_equal(tgroup, monkeypatch, name, kw, overlap):
    def run(mode):
        monkeypatch.setenv("BAGUA_STATIC_VERIFY", mode)
        ddp = make_ddp(tgroup, build_algorithm(name, **kw), overlap=overlap)
        state = ddp.init(params_from_jax(jax_params()))
        losses = []
        for i in range(3):
            state, loss = ddp.train_step(state, tbatch(i))
            losses.append(loss)
        state = ddp.finalize_pending_updates(state)
        return [t.clone() for t in tree_leaves(state.params)], torch.stack(losses), ddp

    params_off, losses_off, _ = run("off")
    params_on, losses_on, ddp = run("strict")
    assert ddp._predicted_programs, "the strict gate did not run"
    assert torch.equal(losses_off, losses_on)
    assert all(torch.equal(a, b) for a, b in zip(params_off, params_on))
