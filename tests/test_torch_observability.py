"""The port's observability modules against the JAX package's, on the same
input streams.

Most of ``bagua_tpu_torch/observability/`` is a copy of the JAX package's
jax-free modules, so the contract is equality: the same calls on both give
the same results (the health monitor's alerts and report, the CUSUM and the
regression sentinel's incidents, the goodput ledger on a fake clock, the
hang report's verdicts, the straggler score, the span and metrics
validators, the retry policy's delays and the breaker's transitions).  The
rewritten parts are held to what they replace: ``health_scalars`` to
JAX's within f32 rounding (rtol 1e-6: sums over a few hundred terms in
another order), the ``record_function`` labels to the ``named_scope``
strings, and ``analyze_trace`` to the overlap arithmetic on a hand-built
CUDA trace and to one ``per_bucket`` row per plan bucket on a CPU trace of
an overlap step.
"""

import gzip
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bagua_tpu.observability as jobs
import bagua_tpu.resilience.retry as jretry
from bagua_tpu.observability import flight_recorder as jfr
from bagua_tpu.observability import goodput as jgoodput
from bagua_tpu.observability import health as jhealth
from bagua_tpu.observability import scope_grammar as jgrammar
from bagua_tpu.observability import tracing as jtracing

import bagua_tpu_torch.observability as tobs
import bagua_tpu_torch.resilience.retry as tretry
from bagua_tpu_torch.algorithms import build_algorithm
from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.models import mlp
from bagua_tpu_torch.models.vgg import VGG16_CFG, init_vgg16, vgg_loss_fn
from bagua_tpu_torch.observability import flight_recorder as tfr
from bagua_tpu_torch.observability import goodput as tgoodput
from bagua_tpu_torch.observability import scope_grammar as tgrammar
from bagua_tpu_torch.observability import tracing as ttracing

PKGS = {"jax": jobs, "torch": tobs}


def both(fn):
    """``fn(package)`` for the JAX package and the port."""
    return fn(PKGS["jax"]), fn(PKGS["torch"])


# ---------------------------------------------------------------------------
# Labels
# ---------------------------------------------------------------------------


def test_scope_grammar_is_the_jax_grammar():
    for mod in (tgrammar, jgrammar):
        assert mod.format_exchange_label("zero", 3, "rs") == "bagua_ex/algo=zero/bucket=3/phase=rs"
    labels = [tgrammar.format_exchange_label("bytegrad", 11, "overlap"), tgrammar.format_mp_label("tp", "row_psum"),
              tgrammar.format_step_label("optimizer"), tgrammar.format_stale_scope(2), "qr8_hop3",
              "bagua_overlap_bwd/bucket=4", "no label"]
    for lab in labels:
        for parse in ("parse_exchange_label", "parse_mp_label", "parse_step_phase", "parse_qr_scope",
                      "parse_overlap_bwd", "parse_stale_scope"):
            assert getattr(tgrammar, parse)(lab) == getattr(jgrammar, parse)(lab), (parse, lab)


def test_annotations_name_record_functions_with_the_jax_strings(tmp_path):
    """The factories are ``record_function`` contexts named as JAX's
    ``named_scope`` frames, and they change nothing they wrap."""
    x = torch.arange(6.0)
    with tobs.ProfilerSession(str(tmp_path)) as prof:
        with tobs.bucket_scope("gradient_allreduce", 2, "mono"):
            with tobs.mp_scope("tp", "row_psum"):
                y = x * 2
        with tobs.step_scope("optimizer"):
            z = y + 1
    assert torch.equal(z, x * 2 + 1)
    names = [e["name"] for e in tobs.load_trace_events(prof.trace_path) if e["cat"] == "user_annotation"]
    assert names == [jgrammar.format_exchange_label("gradient_allreduce", 2, "mono"),
                     jgrammar.format_mp_label("tp", "row_psum"), jgrammar.format_step_label("optimizer")]


# ---------------------------------------------------------------------------
# Health
# ---------------------------------------------------------------------------


def test_health_scalars_match_jax():
    """One rank's ``(3,)`` vector and the rank-stacked ``(size, 3)``
    against JAX's per rank, with NaN and inf in some leaves; rtol 1e-6."""
    rng = np.random.RandomState(0)
    size = 4
    tree = {"a": rng.randn(size, 17, 5).astype(np.float32), "b": [rng.randn(size, 33).astype(np.float32),
                                                                    rng.randn(size, 2, 2).astype(np.float16)],
            "count": np.arange(size * 3, dtype=np.int32).reshape(size, 3)}
    tree["a"][1, 3, 2] = np.nan
    tree["b"][0][2, 5] = np.inf
    loss = rng.rand(size).astype(np.float32)
    stacked = tobs.health_scalars(torch.from_numpy(loss), jax.tree.map(torch.from_numpy, tree))
    assert stacked.shape == (size, 3) and stacked.dtype == torch.float32
    for r in range(size):
        want = np.asarray(jhealth.health_scalars(jnp.asarray(loss[r]), jax.tree.map(lambda a: jnp.asarray(a[r]), tree)))
        one = tobs.health_scalars(torch.tensor(loss[r]), jax.tree.map(lambda a: torch.from_numpy(a[r]), tree))
        for got in (stacked[r].numpy(), one.numpy()):
            np.testing.assert_allclose(got, want, rtol=1e-6)
    assert stacked[:, 2].tolist() == [0.0, 1.0, 1.0, 0.0]


def health_stream():
    """Losses and grad norms with a warmup, a loss spike, a grad explosion,
    a NaN and a clean stretch after it."""
    rng = np.random.RandomState(3)
    out = []
    for step in range(40):
        loss, norm, nonfinite = 2.0 + 0.01 * rng.randn(), 1.0 + 0.05 * rng.rand(), 0
        if step == 12:
            loss = 9.0
        if step == 18:
            norm = 50.0
        if step == 25:
            loss, nonfinite = float("nan"), 3
        out.append((step, float(loss), float(norm), nonfinite))
    return out


def test_health_monitor_matches_jax(tmp_path):
    def run(pkg):
        tel = pkg.Telemetry(metrics_jsonl=str(tmp_path / f"{pkg.__name__}.jsonl"), flight=None)
        mon = pkg.HealthMonitor(telemetry=tel, config=pkg.HealthConfig(rearm_windows=5))
        applied = []
        mon.register_action(lambda alert, state=None: applied.append(alert["kind"]) or True)
        alerts = [mon.observe(*row) for row in health_stream()]
        tel.flush()
        with open(tmp_path / f"{pkg.__name__}.jsonl") as f:
            emitted = [{k: v for k, v in json.loads(line).items() if k != "ts"} for line in f]
        return alerts, mon.report(), applied, emitted, mon.stabilized(5)

    jax_out, port_out = both(run)
    assert repr(port_out) == repr(jax_out)  # NaN-safe equality
    kinds = [a["kind"] for step in port_out[0] for a in step]
    assert kinds == ["loss_spike", "grad_norm_explosion", "nonfinite"]


class _Ddp:
    """The slice of an engine ``PrecisionDemotionAction`` reads."""

    def __init__(self, precisions):
        self.plan = object()
        self.calls = []
        outer = self

        class Impl:
            def bucket_precisions(self, plan):
                return list(precisions)
        self.impl = Impl()

        def apply(p, reason):
            outer.calls.append((list(p), reason))
            return True
        self.apply_precision_plan = apply


def test_precision_demotion_and_snapshot_actions_match_jax():
    def run(pkg):
        ddp = _Ddp(["int4", "int8", "f32"])
        out = [pkg.PrecisionDemotionAction(ddp)({"kind": "loss_spike"}), ddp.calls]
        ddp_f32 = _Ddp(["f32"])
        out.append(pkg.PrecisionDemotionAction(ddp_f32)({"kind": "nonfinite"}))

        class Snap:
            taken = []

            def snapshot(self, state, step, blocking, kind):
                self.taken.append((state, step, blocking, kind))
        snap = Snap()
        action = pkg.SnapshotOnAnomalyAction(snap)
        out += [action({"step": 4}, "s"), action({"step": 5}, "s"), snap.taken]
        action.rearm()
        out += [action({"step": 9}, "s"), snap.taken]
        return out

    jax_out, port_out = both(run)
    assert port_out == jax_out
    assert port_out[1] == [(["int8", "f32", "f32"], "health:loss_spike")]


def test_precision_demotion_drives_the_ports_engine():
    """On the port's engine under ``wire_precision="auto"`` the action
    demotes the live plan one rung through ``apply_precision_plan``."""
    group = BaguaProcessGroup([torch.device("cpu")] * 8, intra_size=4)
    ddp = DistributedDataParallel(mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.1),
                                  build_algorithm("gradient_allreduce", wire_precision="auto"), group,
                                  bucket_size_bytes=512, overlap=False)
    ddp.init(mlp.init_mlp(torch.Generator().manual_seed(0), [12, 16, 16, 4], device="cpu"))
    ddp.apply_precision_plan(["int8"] * ddp.plan.num_buckets, reason="planner")
    assert tobs.PrecisionDemotionAction(ddp)({"kind": "loss_spike"})
    assert ddp.impl.bucket_precisions(ddp.plan) == ["f32"] * ddp.plan.num_buckets
    assert ddp.export_plan_payload()["config"]["source"] == "health"


# ---------------------------------------------------------------------------
# Regression sentinel, budgets, goodput
# ---------------------------------------------------------------------------


class _Links:
    """One link model for both packages' sentinels (JAX's default names
    TPU links, the port's H100 ones)."""

    def axis_link(self, axis, within_pod=False):
        return "model" if axis == "tp" else "data"


def wall_stream():
    rng = np.random.RandomState(7)
    for step in range(120):
        wall = 20.0 + 0.3 * rng.randn() + (6.0 if step >= 70 else 0.0)
        by_axis = {"dp": 1000 + (3000 if step >= 90 else 0), "tp": 400}
        yield step, float(wall), by_axis


def test_cusum_and_regression_sentinel_match_jax(tmp_path):
    def run(pkg):
        cusum = pkg.Cusum(k=1.0, h=5.0, warmup=10)
        trips = [cusum.update(v) for _, v, _ in wall_stream()]
        sink = pkg.JsonlSink(str(tmp_path / f"{pkg.__name__}.jsonl"))
        sentinel = pkg.RegressionSentinel(sink=sink, registry=pkg.MetricsRegistry(), warmup=10, threshold=6.0,
                                          cooldown=10, topology=_Links())
        budgets = []
        for step, wall, by_axis in wall_stream():
            if step == 40:
                sentinel.note_compile(30.0)
            b = sentinel.observe_step(step, wall, host_ms=1.0, wire_bytes=sum(by_axis.values()),
                                      wire_bytes_by_axis=by_axis, goodput_frac=0.9 - (0.2 if step >= 80 else 0.0),
                                      trace_id="t")
            budgets.append((b.components, b.wire_axis_ms, b.expected_ms, b.residual_ms))
        sink.close()
        incidents = sentinel.drain_incidents()
        return strip_clocks([trips, budgets, incidents, sentinel.report()])

    jax_out, port_out = both(run)
    assert port_out == jax_out
    assert port_out[2], "the stream's shift tripped no incident"
    assert tobs.validate_metrics_file(str(tmp_path / "bagua_tpu_torch.observability.jsonl")) == []


def test_sentinel_default_links_name_h100_links():
    from bagua_tpu_torch.perflab.topology import DEFAULT_TOPOLOGY

    assert tobs.RegressionSentinel().topology is DEFAULT_TOPOLOGY
    assert [DEFAULT_TOPOLOGY.axis_link(a) for a in ("tp", "intra", "dp", "inter")] == [
        "nvlink", "nvlink", "network", "network"]
    assert DEFAULT_TOPOLOGY.axis_link("dp", within_pod=True) == "nvlink"


def test_budget_model_matches_jax():
    def run(pkg):
        program = [{"axes": ["dp"], "nbytes": 4096, "phase": "overlap"}, {"axes": ["dp", "fsdp"], "nbytes": 1024},
                   {"axes": [], "nbytes": 7}]

        class Leg:
            def __init__(self, beta):
                self.beta = beta

            def predict(self, nbytes):
                return 1e-5 + nbytes / self.beta

        class Cost:
            def bucket_wire_time(self, b, hierarchical=False, wire_pattern="allreduce"):
                return 1e-5 + b / 1e9

            def axis_leg(self, axis):
                return Leg(1e9 if axis == "dp" else 2e9)

        model = pkg.BudgetModel(compute_ms=6.0, cost_model=Cost(), program=program)
        out = [model.axis_wire_ms, model.wire_ms, model.expected()]
        model.note_wire(3.0, by_axis={"dp": 2.0, "fsdp": 1.0})
        model.note_snapshot(4.0)
        b = model.settle(0, 25.0, host_ms=2.0)
        out += [b.components, b.wire_axis_ms, b.expected_ms, b.residual_ms, b.axis_partition_error_ms()]
        return out

    jax_out, port_out = both(run)
    assert port_out == jax_out


def test_goodput_ledger_on_a_fake_clock_matches_jax():
    def run(pkg):
        t = [100.0]
        led = pkg.GoodputLedger(clock=lambda: t[0])
        for bucket, dt in (("productive", 2.0), ("data", 0.5), ("productive", 4.0), ("snapshot", 1.0)):
            led.enter(bucket)
            t[0] += dt
        led.reattribute("productive", "compile", 1.5)
        led.charge("lost_restart", 3.0)
        meter = pkg.GoodputMeter(flops_per_sample=1e9, peak_flops_per_chip=1e12, n_chips=4,
                                 clock=lambda: t[0])
        mfus = [meter.on_step(w, 32) for w in (0.1, 0.2, 0.3)]
        meter.on_restart(lost_steps=2)
        return led.report(), mfus, meter.ledger.report()

    jax_out, port_out = both(run)
    assert port_out == jax_out


def test_model_flops_match_jax_and_the_peak_is_the_h100s():
    assert tgoodput.vgg16_fwd_flops() == jgoodput.vgg16_fwd_flops()
    assert tgoodput.vgg16_fwd_flops(image_size=32, num_classes=10, cfg=VGG16_CFG) == jgoodput.vgg16_fwd_flops(
        image_size=32, num_classes=10)
    assert tobs.model_flops_per_sample("vgg16") == jobs.model_flops_per_sample("vgg16")
    assert tobs.model_flops_per_sample("mlp", sizes=[784, 128, 10]) == jobs.model_flops_per_sample(
        "mlp", sizes=[784, 128, 10])
    assert set(tgoodput.PEAK_FLOPS_PER_CHIP) == {"h100-sxm-bf16", "h100-sxm-tf32", "h100-sxm-f32"}
    meter = tobs.GoodputMeter(model="vgg16")
    assert meter.peak_flops_per_chip == 989e12
    mfu = meter.on_step(0.05, 128)
    assert mfu == pytest.approx(tobs.model_flops_per_sample("vgg16") * 128 / 0.05 / 989e12)


def test_flops_from_cost_analysis_counts_one_step():
    """PyTorch's count of a small VGG's forward and backward: about twice
    the analytic registry's (the counter takes a multiply-accumulate as two
    FLOPs), within the pools, ReLUs and biases the registry leaves out."""
    gen = torch.Generator().manual_seed(0)
    model, params = init_vgg16(gen, image_size=32, num_classes=10, device="cpu")
    loss_fn = vgg_loss_fn(model)
    x, y = torch.rand((4, 32, 32, 3), generator=gen), torch.randint(0, 10, (4,), generator=gen)

    def step():
        leaves = {k: {n: p.detach().requires_grad_(True) for n, p in v.items()} for k, v in params.items()}
        loss_fn(leaves, (x, y)).backward()

    counted = tobs.flops_from_cost_analysis(step)
    analytic = tgoodput.vgg16_fwd_flops(image_size=32, num_classes=10) * tgoodput.TRAIN_FLOPS_MULTIPLIER * 4
    assert 1.9 < counted / analytic < 2.1
    meter = tobs.GoodputMeter()
    assert meter.calibrate_from_compiled(step, n_samples=4) == counted / 4
    assert tobs.flops_from_cost_analysis(lambda: None) is None


# ---------------------------------------------------------------------------
# Flight recorder, hang reports, gang aggregation
# ---------------------------------------------------------------------------


def record(i, axes=None):
    rec = {"step": i // 3, "label": f"bagua_ex/algo=gradient_allreduce/bucket={i % 3}/phase=overlap",
           "algo": "gradient_allreduce", "bucket": i % 3, "phase": "overlap", "precision": "f32", "nbytes": 4096,
           "plan_version": 1, "t_enqueue": 100.0 + i, "t_retire": 100.5 + i}
    if axes is not None:
        rec["axes"] = list(axes)
    return rec


def rank_dumps(fr_mod, tmp_path, scenario):
    """Four ranks' dumps of one scenario: ``healthy``, ``desync`` (rank 2
    skipped a collective), ``straggler`` (rank 1 three records behind, all
    retired, host waiting), ``host_wedge`` (rank 1 behind with its last
    record unretired, host in dispatch), ``axes`` (a straggler on a named
    mesh)."""
    dumps = []
    for rank in range(4):
        n = 9 if rank == 1 and scenario in ("straggler", "host_wedge", "axes") else 12
        fr = fr_mod.FlightRecorder(capacity=64, rank=rank, world_size=4)
        program = [record(i, axes=["dp", "fsdp"] if scenario == "axes" else None) for i in range(n)]
        if scenario == "desync" and rank == 2:
            del program[7]
        for i, rec in enumerate(program):
            if scenario == "host_wedge" and rank == 1 and i >= 8:
                rec = dict(rec, t_retire=None)
            fr.record(rec)
        phase = "dispatch" if scenario == "host_wedge" and rank == 1 else "wait"
        d = tmp_path / f"{fr_mod.__name__}-{scenario}"
        d.mkdir(exist_ok=True)
        dumps.append(fr.dump(fr_mod.flight_dump_path(str(d), rank), reason="watchdog_timeout",
                             telemetry={"step": n // 3, "phase": phase}))
    return dumps


def strip_clocks(obj):
    """A report with its clock anchors and thread stacks dropped."""
    if isinstance(obj, dict):
        return {k: strip_clocks(v) for k, v in obj.items()
                if k not in ("mono_at_dump", "unix_at_dump", "threads", "last_record_age_s", "ts")}
    if isinstance(obj, list):
        return [strip_clocks(v) for v in obj]
    return obj


@pytest.mark.parametrize("scenario", ["healthy", "desync", "straggler", "host_wedge", "axes"])
def test_hang_report_verdicts_match_jax(tmp_path, scenario):
    want = jfr.build_hang_report(rank_dumps(jfr, tmp_path, scenario))
    got = tfr.build_hang_report(rank_dumps(tfr, tmp_path, scenario))
    assert strip_clocks(got) == strip_clocks(want)
    assert got["verdict"] == {"axes": "straggler"}.get(scenario, scenario)
    assert tfr.validate_hang_report(got) == [] and jfr.validate_hang_report(got) == []
    assert tfr.build_hang_report([])["verdict"] == jfr.build_hang_report([])["verdict"] == "no_data"


def test_flight_validators_and_digest_match_jax(tmp_path):
    fr = tfr.FlightRecorder(capacity=8, rank=3, world_size=4)
    seqs = fr.record_program([record(i) for i in range(3)], step=5, enqueue_t=1.0)
    fr.retire(seqs[:2], retire_t=2.0)
    dump = fr.dump(str(tmp_path / "f.json"))
    assert tfr.validate_flight_dump(dump) == jfr.validate_flight_dump(dump) == []
    broken = dict(dump, records=[{"seq": "x"}])
    assert tfr.validate_flight_dump(broken) == jfr.validate_flight_dump(broken) != []
    digest = fr.digest()
    assert digest["unretired"] == 1 and digest["last"]["step"] == 5 and len(digest["tail"]) == 3


def test_capture_reenters_on_another_thread():
    """A capture's list re-entered on another thread (the overlap hooks on
    autograd's thread) receives that thread's notifications."""
    import threading

    with tfr.capture_program() as events:
        tfr.notify_collective("gradient_allreduce", 1, "overlap", axes=["dp"])

        def hook():
            tfr.notify_collective("gradient_allreduce", 0, "overlap")  # no capture on this thread
            with tfr.capture_program(events):
                tfr.notify_collective("gradient_allreduce", 0, "overlap", axes=["dp"])
                tfr.notify_ring(kind="rs", bits=8, hops=3, wire_bytes=64)
        t = threading.Thread(target=hook)
        t.start()
        t.join(timeout=20)
        assert not t.is_alive()
    assert [(e["bucket"], e["phase"]) for e in events] == [(1, "overlap"), (0, "overlap"), (0, "hop")]
    assert events[2]["hops"] == 3 and events[2]["precision"] == "int8"


def test_straggler_score_and_gang_view_match_jax():
    def run(pkg):
        summaries = [pkg.StepSummary(rank=r, step=10, window=1, p50_ms=20.0 + (15.0 if r == 2 else r),
                                     p99_ms=30.0, wire_bytes=100, mfu=0.3,
                                     phase_ms={"data": 1.0, "dispatch": 5.0 + (9.0 if r == 2 else 0.0)})
                     for r in range(4)]
        view = pkg.GangView(4, summaries)
        return pkg.straggler_score(summaries), pkg.straggler_score(summaries[:1]), view.report()

    jax_out, port_out = both(run)
    assert port_out == jax_out
    assert port_out[0]["rank"] == 2


def test_summarize_telemetry_matches_jax():
    def run(pkg):
        tel = pkg.Telemetry(flight=None)
        for step, wall in enumerate((0.02, 0.03, 0.025)):
            tel.on_step(step, wall, 32, 4096, wire_bytes_by_precision={"int8": 1024})
        return pkg.summarize_telemetry(tel, rank=1, step=3, window=2, phase_ms={"dispatch": 2.0})

    jax_out, port_out = both(run)
    assert port_out.__dict__ == jax_out.__dict__


# ---------------------------------------------------------------------------
# Metrics, tracing, retries
# ---------------------------------------------------------------------------


def test_metrics_registry_exports_match_jax(tmp_path):
    def run(pkg):
        r = pkg.MetricsRegistry()
        r.counter("steps_total", help="steps").inc(3)
        r.gauge("mfu", help="mfu").set(0.25)
        h = r.histogram("step_wall_ms", help="wall")
        for v in (3.0, 1.0, 2.0, 10.0):
            h.observe(v)
        path = tmp_path / f"{pkg.__name__}.prom"
        r.write_prometheus(str(path))
        return r.snapshot(), r.to_prometheus(), path.read_text()

    jax_out, port_out = both(run)
    assert port_out == jax_out


def test_event_validators_match_jax():
    events = [
        {"event": "step", "step": 1, "wall_ms": 2.0, "samples_per_s": 3.0, "wire_bytes": 4, "variant": "d",
         "ts": 1.0},
        {"event": "step", "step": "1"},
        {"event": "rebucket", "plan_version": 1, "n_buckets": 3, "step": 0, "reason": "planner", "ts": 1.0},
        {"event": "rebucket", "plan_version": 1, "n_buckets": 3, "step": 0, "reason": "because", "ts": 1.0},
        {"event": "nope", "ts": 1.0},
        {"event": "hang", "reason": "watchdog_timeout", "ts": 1.0},
    ]
    for e in events:
        assert tobs.validate_metrics_event(e) == jobs.validate_metrics_event(e), e


def test_tracer_spans_validate_as_jax(tmp_path):
    def run(pkg, mod):
        tracer = pkg.Tracer(path=str(tmp_path / f"{pkg.__name__}.jsonl"), sample_every=2, rank=1)
        for step in range(4):
            tracer.begin_step(step, variant="default")
            tracer.on_phase("dispatch")
            with tracer.span("rpc", kind="client"):
                pass
            tracer.on_phase("wait")
            tracer.note_step(wall_ms=1.0)
        tracer.end_step()
        spans = tracer.finished_spans()
        tracer.close()
        return spans

    spans = run(tobs, ttracing)
    assert spans and all(jtracing.validate_span(s) == [] and ttracing.validate_span(s) == [] for s in spans)
    assert {s["attrs"].get("step") for s in spans if s["name"] == "train_step"} == {0, 2}
    bad = dict(spans[0], trace_id="xyz")
    assert ttracing.validate_span(bad) == jtracing.validate_span(bad) != []
    for header in ("00-" + "a" * 32 + "-" + "b" * 16 + "-01", "garbage", "00-" + "0" * 32 + "-" + "b" * 16 + "-01"):
        assert ttracing.parse_traceparent(header) == jtracing.parse_traceparent(header)


def test_retry_policy_and_breaker_match_jax():
    def run(mod):
        mod.seed_backoff(5)
        policy = mod.RetryPolicy(retries=4, base_s=0.1, max_s=1.0)
        delays = [policy.backoff_s(i) for i in range(5)]
        clock, seen = [0.0], []
        breaker = mod.CircuitBreaker(failure_threshold=2, cooldown_s=10.0, name="t", clock=lambda: clock[0],
                                     listener=lambda *t: seen.append(t))
        states = []
        for ok in (False, False, None, True, False):
            if ok is None:
                clock[0] += 11.0
                breaker.before_call()
            elif ok:
                breaker.record_success()
            else:
                breaker.record_failure()
            states.append(breaker.state)
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionError("down")
            return "up"
        result = mod.retry_call(flaky, policy=mod.RetryPolicy(retries=3, base_s=0.0, max_s=0.0),
                                sleep=lambda s: None)
        return delays, states, seen, breaker.times_opened, result, len(calls)

    assert run(tretry) == run(jretry)


# ---------------------------------------------------------------------------
# The trace analyzer
# ---------------------------------------------------------------------------


def cuda_trace():
    """A hand-built CUDA trace: two host threads (the main one and
    autograd's), each launch joined to its kernel by correlation id; one
    exchange kernel of bucket 0 (phase ``overlap``) of 100 us, 60 of them
    under a compute kernel on another stream; bucket 1's of 50 us, none
    hidden, launched under a nested ring label; a tp ``row_psum`` of 40 us
    hidden 10; a memcpy whose launch fell outside the capture."""
    pid, main, hook = 1, 11, 12
    ev = []

    def ann(name, tid, ts, dur):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur})

    def launch(tid, ts, corr, kernel, stream, kts, kdur, cat="kernel"):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": pid, "tid": tid, "ts": ts,
                   "dur": 2, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": cat, "name": kernel, "pid": 0, "tid": stream, "ts": kts, "dur": kdur,
                   "args": {"correlation": corr, "stream": stream, "device": 0}})

    ann(jgrammar.format_step_label("fwd_bwd"), main, 0, 1000)
    launch(main, 10, 1, "conv_bwd", 7, 100, 260)                  # compute 100-360
    ann(jgrammar.format_exchange_label("bytegrad", 0, "overlap"), hook, 50, 40)
    launch(hook, 60, 2, "compress_rows", 20, 300, 100)            # exchange 300-400: 60 hidden
    ann(jgrammar.format_exchange_label("bytegrad", 1, "overlap"), hook, 100, 40)
    ann("qr8_hop1", hook, 105, 20)
    launch(hook, 110, 3, "hop_kernel", 20, 500, 50)               # exchange 500-550: none hidden
    ann(jgrammar.format_mp_label("tp", "row_psum"), main, 600, 10)
    launch(main, 602, 4, "all_reduce_copy", 7, 700, 40)           # mp 700-740: 10 hidden
    launch(main, 620, 5, "gemm", 21, 730, 100)                    # compute 730-830
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0, "tid": 7, "ts": 900, "dur": 5,
               "args": {"correlation": 99, "stream": 7}})
    ev.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": main, "args": {"name": "main"}})
    return {"traceEvents": ev, "deviceProperties": []}


@pytest.mark.parametrize("suffix", [".json", ".json.gz"])
def test_analyze_trace_joins_kernels_to_labels_through_launches(tmp_path, suffix):
    path = tmp_path / f"trace{suffix}"
    data = json.dumps(cuda_trace())
    if suffix.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(data)
    else:
        path.write_text(data)
    assert tobs.find_trace_file(str(tmp_path)) == str(path)
    out = tobs.analyze_trace(str(tmp_path))
    assert out["per_bucket"] == [
        {"algo": "bytegrad", "bucket": 0, "phases": ["overlap"], "kernels": ["compress_rows"], "spans": 1,
         "collective_ms": 0.1, "hidden_ms": 0.06, "overlap_frac": 0.6},
        {"algo": "bytegrad", "bucket": 1, "phases": ["overlap"], "kernels": ["hop_kernel"], "spans": 1,
         "collective_ms": 0.05, "hidden_ms": 0.0, "overlap_frac": 0.0},
    ]
    assert out["per_scope"] == [{"axis": "tp", "phases": ["row_psum"], "kernels": ["all_reduce_copy"], "spans": 1,
                                 "collective_ms": 0.04, "hidden_ms": 0.01, "measured_overlap_frac": 0.25}]
    assert out["collective_spans"] == 3 and out["num_device_events"] == 6 and out["source"] == "device"
    assert out["measured_overlap_frac"] == round(70 / 190, 4)
    assert out["unattributed"]["kernels"] == ["Memcpy HtoD"] and out["unattributed"]["spans"] == 1
    labels = {e["name"]: e["label"] for e in tobs.attribute_device_events(tobs.load_trace_events(str(path)))}
    assert labels["hop_kernel"] == "bagua_ex/algo=bytegrad/bucket=1/phase=overlap/qr8_hop1"
    assert labels["gemm"] == "bagua_step/phase=fwd_bwd" and labels["Memcpy HtoD"] is None
    with pytest.raises(ValueError, match="hlo_text"):
        tobs.analyze_trace(str(path), hlo_text="HloModule m")


@pytest.mark.parametrize("lost", ["launches", "device_properties"])
def test_a_cuda_trace_without_device_activity_is_refused(tmp_path, lost):
    """A trace captured with CUDA whose device activity was not recorded
    (its kernels lost; or only the header's device list left) must not be
    read through the host-op stand-in: the analyzer raises.  The same
    events without the CUDA signs are a host trace."""
    trace = cuda_trace()
    trace["traceEvents"] = [e for e in trace["traceEvents"]
                            if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset")]
    trace["traceEvents"].append({"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 1, "tid": 11,
                                 "ts": 700, "dur": 5})
    if lost == "device_properties":
        trace["traceEvents"] = [e for e in trace["traceEvents"] if e.get("cat") != "cuda_runtime"]
        # the profiler writes the device list before the events
        trace = {"deviceProperties": [{"id": 0, "name": "NVIDIA H100 80GB HBM3"}],
                 "traceEvents": trace["traceEvents"]}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    with pytest.raises(ValueError, match="no device activity"):
        tobs.analyze_trace(str(path))
    trace["traceEvents"] = [e for e in trace["traceEvents"] if e.get("cat") != "cuda_runtime"]
    trace["deviceProperties"] = []
    path.write_text(json.dumps(trace))
    out = tobs.analyze_trace(str(path))
    assert out["source"] == "host" and out["num_device_events"] == 1


def test_analyze_trace_survives_a_truncated_capture(tmp_path):
    data = json.dumps(cuda_trace())
    path = tmp_path / "cut.json"
    path.write_text(data[: data.index('"gemm"') - 200])
    out = tobs.analyze_trace(str(path))
    assert [r["bucket"] for r in out["per_bucket"]] == [0, 1]
    with pytest.raises(FileNotFoundError):
        tobs.analyze_trace(str(tmp_path / "empty_dir_missing"))


@pytest.mark.parametrize("algo", ["bytegrad", "gradient_allreduce", "zero"])
def test_cpu_profile_of_an_overlap_step_attributes_every_bucket(tmp_path, algo):
    """A ``ProfilerSession`` capture of one overlap step on the CPU: one
    ``per_bucket`` row per plan bucket under the JAX grammar, the algorithm's
    name and the overlap phase (ZeRO's exchange is its ``rs`` leg; its
    ``ag`` leg runs at the step's start)."""
    group = BaguaProcessGroup([torch.device("cpu")] * 8, intra_size=4)
    ddp = DistributedDataParallel(mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.1), build_algorithm(algo), group,
                                  bucket_size_bytes=512, overlap=True)
    state = ddp.init(mlp.init_mlp(torch.Generator().manual_seed(0), [12, 16, 16, 4], device="cpu"))
    batch = (torch.randn(32, 12), torch.randn(32, 4))
    prof = tobs.ProfilerSession(str(tmp_path))
    state, _ = prof.trace_steps(ddp.train_step, state, [batch])
    out = tobs.analyze_trace(prof.trace_path)
    n = ddp.plan.num_buckets
    assert [(r["algo"], r["bucket"]) for r in out["per_bucket"]] == [(algo, b) for b in range(n)]
    want = {"ag", "rs"} if algo == "zero" else {"overlap"}
    assert set().union(*(r["phases"] for r in out["per_bucket"])) == want
    assert all(r["spans"] > 0 and r["collective_ms"] > 0 for r in out["per_bucket"])
    assert out["unattributed"] is None and math.isfinite(out["measured_overlap_frac"])
    assert out["source"] == "host"
