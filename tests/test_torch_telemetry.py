"""The port's engine with telemetry, the flight recorder and the health
monitor attached, against the JAX engine's on the same runs (8-rank CPU
group, ``intra_size=4``; the MLP ``[12, 16, 16, 4]`` in 512-byte buckets,
five of them; three SGD steps on batches drawn with numpy).

What must agree, field for field:

* the ``step`` events of the JSONL stream: step, variant, ``wire_bytes``,
  ``wire_bytes_by_leg``, ``wire_bytes_by_precision`` (the wall and
  time fields differ by nature, and ``samples_per_s`` with them), and the
  ``compile`` events (the port's misses are the first step of each variant
  after a reset, JAX's the jit cache's);
* the ``rebucket``, ``precision_switch`` and ``staleness_switch`` events;
* the flight recorder's records, record for record, less their sequence
  numbers and clocks.  One order differs by construction: JAX traces a
  gradient-mode overlap step's backward rules in the reverse of the order
  it wraps the buckets in (bucket 0 first), while the port exchanges them
  as the backward completes them, in ``plan.backward_order()``.  There the
  records are compared grouped by bucket, each bucket's records in their
  own order.

The JAX package's validators must accept the port's JSONL and flight dump;
telemetry and health on vs off must leave the port's parameters and
optimizer state equal bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bagua_tpu.algorithms import build_algorithm as jax_build
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP
from bagua_tpu.models import mlp as jax_mlp
from bagua_tpu.observability import HealthMonitor as JaxHealthMonitor
from bagua_tpu.observability import Telemetry as JaxTelemetry
from bagua_tpu.observability.flight_recorder import validate_flight_dump as jax_validate_flight_dump
from bagua_tpu.observability.metrics import validate_metrics_file as jax_validate_metrics_file

from bagua_tpu_torch.algorithms import build_algorithm
from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.models import mlp
from bagua_tpu_torch.observability import (
    HealthMonitor,
    RegressionSentinel,
    Telemetry,
    Tracer,
    analyze_trace,
    flight_dump_path,
    validate_flight_dump,
    validate_metrics_file,
)
from bagua_tpu_torch.trainer import Trainer
from bagua_tpu_torch.utils import tree_leaves

LAYERS = [12, 16, 16, 4]
BUCKET = 512
LR, STEPS = 0.1, 3

#: name -> (algorithm, kwargs, overlap); the wires and modes of the parity runs
RUNS = {
    "gar_f32_mono": ("gradient_allreduce", {}, False),
    "gar_f32_overlap": ("gradient_allreduce", {}, True),
    "gar_int8_mono": ("gradient_allreduce", {"wire_precision": "int8"}, False),
    "gar_int8_overlap": ("gradient_allreduce", {"wire_precision": "int8"}, True),
    "bytegrad_overlap": ("bytegrad", {}, True),
    "zero_f32_overlap": ("zero", {}, True),
    "zero_int8_mono": ("zero", {"wire_precision": "int8"}, False),
    "decentralized_mono": ("decentralized", {}, False),
    "decentralized_overlap": ("decentralized", {}, True),
}

#: step-event fields that are clocks (or derived from them)
CLOCK_FIELDS = ("ts", "wall_ms", "samples_per_s", "host_overhead_ms")
#: flight-record fields that are sequence numbers or clocks
RECORD_CLOCKS = ("seq", "t_enqueue", "t_retire")


@pytest.fixture()
def tgroup():
    return BaguaProcessGroup([torch.device("cpu")] * 8, intra_size=4)


@pytest.fixture(autouse=True)
def _small_ring_blocks(monkeypatch):
    """Blocks of 16 so that the buckets' ring shards span several."""
    monkeypatch.setenv("BAGUA_QR_BLOCK", "16")


def batches(seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(32, LAYERS[0]).astype(np.float32), rng.randn(32, LAYERS[-1]).astype(np.float32))
            for _ in range(STEPS)]


def jax_params():
    return jax_mlp.init_mlp(jax.random.PRNGKey(11), LAYERS)


def jax_engine(group, algo, kw, overlap, telemetry, **extra):
    return JaxDDP(jax_mlp.mse_loss, optax.sgd(LR), jax_build(algo, **kw), process_group=group,
                  bucket_size_bytes=BUCKET, overlap=overlap, telemetry=telemetry, **extra)


def port_engine(group, algo, kw, overlap, telemetry=None, **extra):
    return DistributedDataParallel(mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=LR), build_algorithm(algo, **kw),
                                   group, bucket_size_bytes=BUCKET, overlap=overlap, telemetry=telemetry, **extra)


def run_jax(ddp, data):
    state = ddp.init(jax_params())
    for x, y in data:
        state, losses = ddp.train_step(state, (jnp.asarray(x), jnp.asarray(y)))
    jax.block_until_ready(losses)
    return state


def run_port(ddp, data):
    state = ddp.init(params_from_jax(jax.tree.map(np.asarray, jax_params())))
    losses = []
    for x, y in data:
        state, loss = ddp.train_step(state, (torch.from_numpy(x), torch.from_numpy(y)))
        losses.append(loss)
    return state, losses


def events(path, kind=None):
    with open(path) as f:
        out = [json.loads(line) for line in f]
    out = [{k: v for k, v in e.items() if k not in CLOCK_FIELDS} for e in out]
    return [e for e in out if kind is None or e["event"] == kind]


def records(flight):
    return [{k: v for k, v in r.items() if k not in RECORD_CLOCKS} for r in flight.records()]


def by_bucket(recs):
    """Each step's records grouped by bucket, each bucket's in their order."""
    return sorted(recs, key=lambda r: (r["step"], r["bucket"]))


@pytest.mark.parametrize("run", sorted(RUNS))
def test_step_events_and_flight_programs_match_jax(group, tgroup, tmp_path, run):
    """The port's JSONL step events and flight records against the JAX
    engine's on the same run; the JAX validators accept the port's JSONL
    and its flight dump."""
    algo, kw, overlap = RUNS[run]
    data = batches()
    jtel = JaxTelemetry(metrics_jsonl=str(tmp_path / "jax.jsonl"), flight="auto")
    run_jax(jax_engine(group, algo, kw, overlap, jtel), data)
    jtel.flush()
    ttel = Telemetry(metrics_jsonl=str(tmp_path / "port.jsonl"), flight="auto")
    ddp = port_engine(tgroup, algo, kw, overlap, ttel)
    run_port(ddp, data)
    ttel.flush()

    assert events(tmp_path / "port.jsonl") == events(tmp_path / "jax.jsonl")
    assert [e["step"] for e in events(tmp_path / "port.jsonl", "step")] == list(range(STEPS))
    want, got = records(jtel.flight), records(ttel.flight)
    assert got, "no flight records"
    if overlap and algo != "decentralized":
        want, got = by_bucket(want), by_bucket(got)
    assert got == want
    assert all(r["t_retire"] is not None for r in ttel.flight.records())
    if overlap:
        # the port's own order: each step's exchanges in backward_order()
        first = [r["bucket"] for r in ttel.flight.records() if r["step"] == 0 and r["phase"] != "hop"
                 and r["phase"] != "ag"]
        assert first == ddp.plan.backward_order()

    assert validate_metrics_file(str(tmp_path / "port.jsonl")) == []
    assert jax_validate_metrics_file(str(tmp_path / "port.jsonl")) == []
    path = flight_dump_path(str(tmp_path), 0)
    dump = ttel.flight.dump(path, reason="manual", telemetry=ttel.snapshot())
    with open(path) as f:
        on_disk = json.load(f)
    assert validate_flight_dump(on_disk) == [] and jax_validate_flight_dump(on_disk) == []
    assert on_disk["last_seq"] == dump["last_seq"] == len(got) - 1


#: switch -> (algorithm kwargs, the switch between steps 0 and 1, the events)
SWITCHES = {
    "rebucket": ({}, lambda ddp: ddp.rebucket(ddp.plan, predicted_exposed_ms=1.5, reason="planner"),
                 ["compile", "step", "rebucket", "compile", "step", "step"]),
    "precision": ({"wire_precision": "auto"},
                  lambda ddp: ddp.apply_precision_plan(["int8", "f32", "int8", "f32", "f32"],
                                                       reason="health:loss_spike"),
                  ["compile", "step", "precision_switch", "compile", "step", "step"]),
}


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_plan_switch_events_match_jax(group, tgroup, tmp_path, switch):
    """``rebucket`` (a new plan) and ``precision_switch`` (a per-bucket plan
    under ``wire_precision="auto"``), with the step events and flight
    programs around them."""
    kw, apply, kinds = SWITCHES[switch]
    data = batches()

    def drive(ddp, state, as_batch):
        for i, (x, y) in enumerate(data):
            if i == 1:
                apply(ddp)
            state, _ = ddp.train_step(state, as_batch(x, y))

    jtel = JaxTelemetry(metrics_jsonl=str(tmp_path / "jax.jsonl"), flight="auto")
    jddp = jax_engine(group, "gradient_allreduce", kw, False, jtel)
    drive(jddp, jddp.init(jax_params()), lambda x, y: (jnp.asarray(x), jnp.asarray(y)))
    jtel.flush()
    ttel = Telemetry(metrics_jsonl=str(tmp_path / "port.jsonl"), flight="auto")
    tddp = port_engine(tgroup, "gradient_allreduce", kw, False, ttel)
    drive(tddp, tddp.init(params_from_jax(jax.tree.map(np.asarray, jax_params()))),
          lambda x, y: (torch.from_numpy(x), torch.from_numpy(y)))
    ttel.flush()

    got = events(tmp_path / "port.jsonl")
    assert [e["event"] for e in got] == kinds
    assert got == events(tmp_path / "jax.jsonl")
    assert records(ttel.flight) == records(jtel.flight)
    assert ttel.registry.snapshot().get("plan_version") == (1 if switch == "rebucket" else None)


def test_staleness_switch_events_match_jax(group, tgroup, tmp_path):
    """``apply_staleness`` on the stale algorithm: the same
    ``staleness_switch`` event and a fresh capture after it."""
    data = batches()

    def drive(ddp, state, as_batch):
        for i, (x, y) in enumerate(data):
            if i == 1:
                assert ddp.apply_staleness(2, reason="autopilot:straggler")
                assert not ddp.apply_staleness(2)
            state, _ = ddp.train_step(state, as_batch(x, y))

    jtel = JaxTelemetry(metrics_jsonl=str(tmp_path / "jax.jsonl"), flight="auto")
    jddp = jax_engine(group, "stale", {"staleness_tau": 0}, False, jtel)
    drive(jddp, jddp.init(jax_params()), lambda x, y: (jnp.asarray(x), jnp.asarray(y)))
    jtel.flush()
    ttel = Telemetry(metrics_jsonl=str(tmp_path / "port.jsonl"), flight="auto")
    tddp = port_engine(tgroup, "stale", {"staleness_tau": 0}, False, ttel)
    drive(tddp, tddp.init(params_from_jax(jax.tree.map(np.asarray, jax_params()))),
          lambda x, y: (torch.from_numpy(x), torch.from_numpy(y)))
    ttel.flush()
    got = events(tmp_path / "port.jsonl")
    assert [e["event"] for e in got] == ["compile", "step", "staleness_switch", "compile", "step", "step"]
    assert got == events(tmp_path / "jax.jsonl")
    assert records(ttel.flight) == records(jtel.flight)


def test_switch_algorithm_emits_rebucket_event(tgroup, tmp_path):
    """A live switch emits ``rebucket`` naming the new algorithm (the JAX
    engine's event) and captures the new algorithm's program."""
    ttel = Telemetry(metrics_jsonl=str(tmp_path / "port.jsonl"), flight="auto")
    ddp = port_engine(tgroup, "gradient_allreduce", {}, True, ttel)
    state = ddp.init(params_from_jax(jax.tree.map(np.asarray, jax_params())))
    (x, y), = batches()[:1]
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    state, _ = ddp.train_step(state, batch)
    state = ddp.switch_algorithm(state, "zero", reason="manual")
    state, _ = ddp.train_step(state, batch)
    ttel.flush()
    ev = events(tmp_path / "port.jsonl")
    assert [e["event"] for e in ev] == ["compile", "step", "rebucket", "compile", "step"]
    assert ev[2]["algorithm"] == "zero" and ev[2]["plan_version"] == 1 and ev[2]["step"] == 1
    assert ev[3]["retrace"] is True
    phases = {r["phase"] for r in ttel.flight.records() if r["step"] == 1}
    assert phases == {"ag", "rs"}
    assert validate_metrics_file(str(tmp_path / "port.jsonl")) == []


def test_recompile_detector_trips_on_variant_churn_as_jax(group, tgroup):
    """A precision plan flapping every step makes every step a miss; both
    engines' detectors count the same retraces and raise the same alert."""
    data = batches() * 3
    plans = (["int8"] * 5, ["f32"] * 5)

    def churn(ddp, state, as_batch):
        for i, (x, y) in enumerate(data):
            ddp.apply_precision_plan(plans[i % 2], reason="planner")
            state, _ = ddp.train_step(state, as_batch(x, y))
        return state

    jtel = JaxTelemetry(flight=None)
    jddp = jax_engine(group, "gradient_allreduce", {"wire_precision": "auto"}, False, jtel)
    churn(jddp, jddp.init(jax_params()), lambda x, y: (jnp.asarray(x), jnp.asarray(y)))
    ttel = Telemetry(flight=None)
    tddp = port_engine(tgroup, "gradient_allreduce", {"wire_precision": "auto"}, False, ttel)
    churn(tddp, tddp.init(params_from_jax(jax.tree.map(np.asarray, jax_params()))),
          lambda x, y: (torch.from_numpy(x), torch.from_numpy(y)))
    want, got = jtel.recompile.report(), ttel.recompile.report()
    for k in ("steps", "retraces", "alerts", "compiles_by_variant"):
        assert got[k] == want[k], k
    assert got["retraces"] == len(data) - 1 and got["alerts"] == 1
    assert ttel.registry.snapshot()["retraces_total"] == len(data) - 1


@pytest.mark.parametrize("run", ["gar_f32_overlap", "zero_f32_overlap", "bytegrad_overlap", "gar_int8_overlap"])
def test_observability_is_bitwise_inert(tgroup, tmp_path, run):
    """Telemetry (JSONL, flight recorder, tracer, regression sentinel) and
    the health monitor on vs off: the parameters, the optimizer state and
    the losses agree bit for bit, overlap on."""
    algo, kw, overlap = RUNS[run]
    data = batches()
    off, off_losses = run_port(port_engine(tgroup, algo, kw, overlap), data)
    tel = Telemetry(metrics_jsonl=str(tmp_path / "m.jsonl"), flight="auto", tracing=Tracer(),
                    regression=RegressionSentinel(warmup=1))
    ddp = port_engine(tgroup, algo, kw, overlap, tel, health_monitor=HealthMonitor())
    on, on_losses = run_port(ddp, data)
    for a, b in zip(off_losses, on_losses):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(off.params), tree_leaves(on.params)):
        assert torch.equal(a, b)
    opt_off, opt_on = off.optimizer, on.optimizer
    if algo == "zero":
        opt_off, opt_on = opt_off.sharded, opt_on.sharded
    for (ka, sa), (kb, sb) in zip(opt_off.state_dict()["state"].items(), opt_on.state_dict()["state"].items()):
        assert ka == kb
        for name in sa:
            if torch.is_tensor(sa[name]):
                assert torch.equal(sa[name], sb[name])
    assert len(tel.tracer.finished_spans()) >= STEPS


@pytest.mark.parametrize("run", ["gar_f32_overlap", "zero_f32_overlap", "gar_int8_mono", "decentralized_overlap"])
def test_health_monitor_reads_the_step_as_jax(group, tgroup, run):
    """The monitor's loss is the mean of the step's returned losses, and
    its gradient norm and non-finite count are JAX's within f32 rounding
    of a sum in another order (rtol 1e-5)."""
    algo, kw, overlap = RUNS[run]
    data = batches()
    seen = {"jax": [], "port": []}

    def spy(monitor, key):
        observe = monitor.observe

        def wrapped(step, loss, grad_norm, nonfinite, state=None):
            seen[key].append((loss, grad_norm, nonfinite))
            return observe(step, loss, grad_norm, nonfinite, state)
        monitor.observe = wrapped
        return monitor

    run_jax(jax_engine(group, algo, kw, overlap, None, health_monitor=spy(JaxHealthMonitor(), "jax")), data)
    monitor = spy(HealthMonitor(), "port")
    _, losses = run_port(port_engine(tgroup, algo, kw, overlap, health_monitor=monitor), data)
    assert len(seen["port"]) == STEPS and monitor.alerts == []
    for (loss, norm, nonfinite), (jloss, jnorm, jnonfinite), step_losses in zip(seen["port"], seen["jax"], losses):
        assert loss == float(step_losses.double().mean())
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        np.testing.assert_allclose(norm, jnorm, rtol=1e-5)
        assert nonfinite == jnonfinite == 0
    assert monitor.registry is None  # no telemetry bound: the gauges stay off


@pytest.mark.parametrize("run", ["gar_f32_mono", "zero_f32_overlap"])
def test_health_monitor_counts_nonfinite_as_jax(group, tgroup, run):
    """A NaN target in one rank's batch (a target, not an input: the ReLU's
    backward is a select in both packages, so the NaNs reach the same
    gradient elements): the engine, which counts only after a non-finite
    norm, reports JAX's count and the monitor latches."""
    algo, kw, overlap = RUNS[run]
    x, y = batches()[0]
    y = y.copy()
    y[5, 3] = np.nan
    seen = {}

    def spy(monitor, key):
        observe = monitor.observe

        def wrapped(step, loss, grad_norm, nonfinite, state=None):
            seen[key] = (grad_norm, nonfinite)
            return observe(step, loss, grad_norm, nonfinite, state)
        monitor.observe = wrapped
        return monitor

    run_jax(jax_engine(group, algo, kw, overlap, None, health_monitor=spy(JaxHealthMonitor(), "jax")), [(x, y)])
    monitor = spy(HealthMonitor(), "port")
    run_port(port_engine(tgroup, algo, kw, overlap, health_monitor=monitor), [(x, y)])
    assert seen["port"][1] == seen["jax"][1] > 0
    assert np.isnan(seen["port"][0]) and np.isnan(seen["jax"][0])
    assert monitor.nan_latched and [a["kind"] for a in monitor.alerts] == ["nonfinite"]


@pytest.mark.parametrize("algo", ["gradient_allreduce", "zero", "decentralized"])
def test_health_norms_with_overlap_equal_monolithic(tgroup, algo):
    """The monitor reads the same gradient norms with overlap as without
    (the hooks' exchange gives the monolithic gradients bit for bit), with
    leaves outside every bucket (a ``dp_filter``'s) and in weight mode."""
    seen = {}
    for overlap in (False, True):
        monitor = HealthMonitor()
        observe = monitor.observe
        monitor.observe = lambda step, loss, grad_norm, nonfinite, state=None: seen.setdefault(
            overlap, []).append(grad_norm) or observe(step, loss, grad_norm, nonfinite, state)
        ddp = port_engine(tgroup, algo, {}, overlap, health_monitor=monitor,
                          dp_filter=None if algo == "zero" else (lambda name: "layer1" not in name))
        run_port(ddp, batches())
        assert ddp.overlap_enabled is overlap
    assert seen[True] == seen[False]


def test_host_overhead_snapshot(tgroup):
    ddp = port_engine(tgroup, "gradient_allreduce", {}, True)
    run_port(ddp, batches())
    snap = ddp.host_overhead_snapshot(reset=True)
    assert snap["steps"] == STEPS
    assert set(snap["step_wall_ms"]) == {"p50", "p95", "p99"}
    assert snap["dispatch_ms_per_step"] > 0 and snap["lock_wait_ms_per_step"] == 0
    assert ddp.host_overhead["steps"] == 0


# ---------------------------------------------------------------------------
# The Trainer
# ---------------------------------------------------------------------------


def port_trainer(tgroup, **kw):
    return Trainer(mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=LR), build_algorithm("gradient_allreduce"),
                   tgroup, bucket_size_bytes=BUCKET, overlap=True, **kw)


def port_batches():
    return [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in batches()]


def test_trainer_gang_window_exports_the_local_view(group, tgroup):
    """``gang_window=2`` with a telemetry hub on one controller: after step
    2 the trainer's gang aggregator holds a local view with the keys of the
    JAX ``Trainer``'s local view, one rank reporting, and the same gang
    gauges in the registry."""
    from bagua_tpu.trainer import Trainer as JaxTrainer

    jtel, tel = JaxTelemetry(), Telemetry()
    jtr = JaxTrainer(jax_mlp.mse_loss, optax.sgd(LR), jax_build("gradient_allreduce"), process_group=group,
                     telemetry=jtel, gang_window=2, watchdog_timeout_s=0)
    jtr.fit(jtr.init_state(jax_params()), [(jnp.asarray(x), jnp.asarray(y)) for x, y in batches()], log_every=0)
    tr = port_trainer(tgroup, telemetry=tel, gang_window=2)
    tr.fit(tr.init_state(params_from_jax(jax.tree.map(np.asarray, jax_params()))), port_batches(), log_every=0)
    view, jview = tr.gang.last_view, jtr.gang.last_view
    assert view is not None and jview is not None
    assert set(view.report()) == set(jview.report())
    assert set(view.report()["ranks"][0]) == set(jview.report()["ranks"][0])
    assert view.ranks_reporting == jview.ranks_reporting == 1 and view.local_only == jview.local_only
    gauges = lambda t: sorted(k for k in t.registry.snapshot() if k.startswith("gang_"))  # noqa: E731
    assert gauges(tel) == gauges(jtel)
    tr.close()
    jtr.close()
    tel.close()
    jtel.close()


def test_trainer_profile_dir_writes_a_trace_the_analyzer_reads(tgroup, tmp_path):
    """One capture of fit iterations [1, 2): a trace file in ``profile_dir``
    whose overlap exchanges ``analyze_trace`` attributes to every bucket."""
    tr = port_trainer(tgroup, profile_dir=str(tmp_path), profile_steps=(1, 2))
    state = tr.init_state(params_from_jax(jax.tree.map(np.asarray, jax_params())))
    state = tr.fit(state, port_batches())
    tr.close()
    assert tr.profile_path is not None and os.path.dirname(tr.profile_path) == str(tmp_path)
    out = analyze_trace(str(tmp_path))
    assert [r["bucket"] for r in out["per_bucket"]] == list(range(tr.ddp.plan.num_buckets))
    assert all(r["algo"] == "gradient_allreduce" and r["phases"] == ["overlap"] for r in out["per_bucket"])
    assert out["unattributed"] is None


def test_trainer_watchdog_timeout_leaves_evidence_and_hang_event(tgroup, tmp_path):
    """A fit loop that stops beating: the watchdog's dump names the hub's
    last phase, the flight ring lands beside it, and the hub emits a
    schema-valid ``hang`` event (``on_timeout`` stands in for the kill)."""
    fired = []
    tel = Telemetry(metrics_jsonl=str(tmp_path / "m.jsonl"), flight="auto")
    tr = port_trainer(tgroup, telemetry=tel, watchdog_timeout_s=2.0)  # far above a step's wall
    wd = tr.watchdog
    wd.check_interval_s, wd.dump_dir, wd.on_timeout = 0.05, str(tmp_path), fired.append
    try:
        state = tr.init_state(params_from_jax(jax.tree.map(np.asarray, jax_params())))
        tr.fit(state, port_batches())
        for _ in range(400):
            if fired:
                break
            wd._stopped.wait(0.05)
    finally:
        tr.close()
    assert fired, "the watchdog never fired"
    assert set(wd.last_dump_paths) == {"watchdog_dump", "flight_dump"}
    with open(wd.last_dump_paths["watchdog_dump"]) as f:
        dump = json.load(f)
    assert dump["reason"] == "watchdog_timeout" and dump["telemetry"]["phase"] == "data"
    assert dump["telemetry"]["step"] == STEPS - 1
    with open(wd.last_dump_paths["flight_dump"]) as f:
        flight = json.load(f)
    assert validate_flight_dump(flight) == [] and jax_validate_flight_dump(flight) == []
    assert len(flight["records"]) == STEPS * tr.ddp.plan.num_buckets
    hang = events(tmp_path / "m.jsonl", "hang")
    assert len(hang) == 1 and hang[0]["reason"] == "watchdog_timeout"
    assert validate_metrics_file(str(tmp_path / "m.jsonl")) == []
    assert not wd._thread.is_alive() or wd._stopped.is_set()


def test_trainer_without_watchdog_by_default(tgroup):
    tr = port_trainer(tgroup)
    assert tr.watchdog is None
    tr.close()
