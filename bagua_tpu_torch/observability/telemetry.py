"""The telemetry hub: one object threading metrics, events, heartbeats and
recompile detection through the training stack.

Attach a :class:`Telemetry` to the engine
(``DistributedDataParallel(..., telemetry=...)`` or
``Trainer(..., telemetry=...)``) and every step feeds it:

* step wall time, samples/s, wire bytes (from the bucket plan) into the
  :class:`~bagua_tpu_torch.observability.metrics.MetricsRegistry` and the JSONL
  event stream;
* a **recompile detector** counting the engine's step-cache misses per
  step variant.  The JAX engine counts jit-cache misses; the port has no
  jit, and its counterpart of a miss is the first step of a variant after
  a reset (the engine's start, a ``rebucket``, a precision, staleness or
  algorithm switch, the algorithm's ``need_reset``), where the engine
  captures the variant's collective program again.  Churn there (a plan
  or precision flapping every few steps) is what the alert catches;
* phase-tagged :class:`~bagua_tpu_torch.observability.core.Watchdog` heartbeats
  (``dispatch``/``wait``/``data``) plus a :meth:`snapshot` the watchdog
  embeds in its hang dump, so a timeout says *where* the step was stuck.

Everything is host-side and optional — an unattached engine pays nothing,
an attached one ~a few µs of clock reads and dict updates per step.
"""

import logging
import time
from typing import Dict, Optional

from bagua_tpu_torch.observability.core import StepTimer, Watchdog
from bagua_tpu_torch.observability.metrics import JsonlSink, MetricsRegistry

logger = logging.getLogger(__name__)

__all__ = ["RecompileDetector", "Telemetry"]


class RecompileDetector:
    """Counts step-cache misses per step variant and alerts on retrace churn
    (jit-cache misses in the JAX package; see the module docstring for the
    port's misses).

    The engine reports every compile through :meth:`record_compile` and
    every dispatched step through :meth:`record_step`.  The *first* compile
    of the training run is the expected warmup; every later compile — a
    re-build of a variant that was already compiled (cache cleared by
    ``need_reset``/``rebucket``/shape drift) or a brand-new variant
    appearing mid-run — counts as a **retrace**.  More than
    ``max_retraces_per_window`` retraces inside any ``window``-step window
    raises a rate alert (once per quiet period): steady-state training must
    compile zero times.
    """

    def __init__(self, window: int = 100, max_retraces_per_window: int = 2):
        self.window = window
        self.max_retraces_per_window = max_retraces_per_window
        self.compiles_by_variant: Dict[str, int] = {}
        self.compile_ms_by_variant: Dict[str, float] = {}
        self.compile_ms_total = 0.0
        self.steps = 0
        self.retraces = 0
        self.alerts = 0
        self._retrace_steps = []  # step index of each retrace (rate window)
        self._alerted = False

    def record_compile(self, variant: str, on_alert=None) -> bool:
        """Register one jit-cache miss; returns True when it counts as a
        retrace (anything beyond the run's first compile).  ``on_alert``
        is called with a message when the retrace rate trips the alarm."""
        first_ever = not self.compiles_by_variant
        self.compiles_by_variant[variant] = self.compiles_by_variant.get(variant, 0) + 1
        if first_ever:
            return False
        self.retraces += 1
        self._retrace_steps.append(self.steps)
        logger.warning(
            "recompile detector: retrace #%d at step %d (variant %r, compile #%d "
            "of this variant)",
            self.retraces, self.steps, variant, self.compiles_by_variant[variant],
        )
        recent = [s for s in self._retrace_steps if s > self.steps - self.window]
        if len(recent) > self.max_retraces_per_window and not self._alerted:
            self._alerted = True
            self.alerts += 1
            msg = (
                f"recompile detector ALERT: {len(recent)} retraces in the last "
                f"{self.window} steps (> {self.max_retraces_per_window}); the "
                "step function is churning — look for batch-shape drift, "
                "weak-typed scalars or plan changes"
            )
            logger.error(msg)
            if on_alert is not None:
                on_alert(msg, len(recent))
        return True

    def record_compile_wall(self, variant: str, wall_ms: float) -> None:
        """Attribute one compile's measured wall time to its variant —
        counts say *that* the step function churned, wall time says what
        the churn *cost* (the goodput ledger's compile bucket)."""
        self.compile_ms_by_variant[variant] = (
            self.compile_ms_by_variant.get(variant, 0.0) + float(wall_ms)
        )
        self.compile_ms_total += float(wall_ms)

    def record_step(self) -> None:
        self.steps += 1
        if self._alerted and all(
            s <= self.steps - self.window for s in self._retrace_steps
        ):
            self._alerted = False  # quiet for a full window: re-arm the alarm

    def report(self) -> Dict:
        return {
            "steps": self.steps,
            "retraces": self.retraces,
            "alerts": self.alerts,
            "compiles_by_variant": dict(self.compiles_by_variant),
            "compile_ms_total": round(self.compile_ms_total, 3),
            "compile_ms_by_variant": {
                k: round(v, 3) for k, v in self.compile_ms_by_variant.items()
            },
        }


class Telemetry:
    """Per-process telemetry hub.

    Args:
        metrics_jsonl: path for the JSONL event stream (None = no stream).
        registry: an existing :class:`MetricsRegistry` to feed (default: a
            fresh one, exposed as ``.registry``).
        watchdog: a :class:`Watchdog` to heartbeat from the step path; its
            ``snapshot_provider`` is pointed at :meth:`snapshot` so hang
            dumps carry the last known (step, phase, bucket, variant).
        retrace_window / max_retraces_per_window: recompile alert rate knobs.
        goodput: a :class:`~bagua_tpu_torch.observability.goodput.GoodputMeter` to
            feed (phases → ledger buckets, steps → MFU, compile/snapshot/
            restart walls → their ledger buckets).  The hub points the
            meter's gauges at its own registry.
        flight: the collective flight recorder
            (:class:`~bagua_tpu_torch.observability.flight_recorder.FlightRecorder`)
            the engine replays its collective programs into.  The default
            ``"auto"`` builds one sized by ``BAGUA_FLIGHT_RING`` unless
            ``BAGUA_FLIGHT_RECORDER=0``; pass ``None`` to disable or an
            instance to adopt.  Bitwise-inert either way.
        tracing: the distributed tracer
            (:class:`~bagua_tpu_torch.observability.tracing.Tracer`) the hub
            drives: one sampled root span per step, one child per host
            phase, client spans on every RPC.  The default ``"auto"``
            builds one only under ``BAGUA_TRACING=1`` (sampled by
            ``BAGUA_TRACE_SAMPLE``, span JSONL at ``BAGUA_TRACE_PATH``);
            pass ``None`` to force off or an instance to adopt.  The hub
            installs its tracer as the process-wide ambient tracer and a
            retry observer so ``retry_call`` / the RPC transports see it.
        regression: the performance-regression sentinel
            (:class:`~bagua_tpu_torch.observability.regression.RegressionSentinel`)
            the hub feeds: per-step budget attribution
            (``step_budget_<component>_ms`` gauges) plus CUSUM changepoint
            detection over the step-wall and goodput streams, emitting
            schema-validated ``perf_regression`` incidents on trip.  The
            default ``"auto"`` builds one only under
            ``BAGUA_REGRESSION_SENTINEL=1`` (knobs
            ``BAGUA_REGRESSION_WARMUP`` / ``_THRESHOLD`` / ``_COOLDOWN``),
            priced from the goodput meter's α–β wire model when one is
            attached; pass ``None`` to force off or an instance to adopt.
            Bitwise-inert either way (host-side arithmetic only).
    """

    def __init__(
        self,
        metrics_jsonl: Optional[str] = None,
        registry: Optional[MetricsRegistry] = None,
        watchdog: Optional[Watchdog] = None,
        retrace_window: int = 100,
        max_retraces_per_window: int = 2,
        goodput=None,
        flight="auto",
        tracing="auto",
        regression="auto",
    ):
        self.registry = registry or MetricsRegistry()
        self.goodput = goodput
        if goodput is not None:
            goodput.bind_registry(self.registry)
        self.jsonl = JsonlSink(metrics_jsonl) if metrics_jsonl else None
        self.recompile = RecompileDetector(
            window=retrace_window, max_retraces_per_window=max_retraces_per_window
        )
        self.step_timer = StepTimer()
        if flight == "auto":
            from bagua_tpu_torch.env import (
                get_flight_recorder_enabled,
                get_flight_ring_size,
                get_rank,
                get_world_size,
            )

            flight = None
            if get_flight_recorder_enabled():
                from bagua_tpu_torch.observability.flight_recorder import FlightRecorder

                flight = FlightRecorder(
                    capacity=get_flight_ring_size(),
                    rank=get_rank(),
                    world_size=get_world_size(),
                )
        self.flight = flight
        if tracing == "auto":
            from bagua_tpu_torch.env import (
                get_rank,
                get_trace_path,
                get_trace_sample_every,
                get_tracing_enabled,
            )

            tracing = None
            if get_tracing_enabled():
                from bagua_tpu_torch.observability.tracing import Tracer

                tracing = Tracer(
                    path=get_trace_path(),
                    sample_every=get_trace_sample_every(),
                    rank=get_rank(),
                )
        self.tracer = tracing
        if self.tracer is not None:
            from bagua_tpu_torch.observability.tracing import set_global_tracer

            set_global_tracer(self.tracer)
        if regression == "auto":
            from bagua_tpu_torch.env import (
                get_regression_cooldown,
                get_regression_sentinel_enabled,
                get_regression_threshold,
                get_regression_warmup,
            )

            regression = None
            if get_regression_sentinel_enabled():
                from bagua_tpu_torch.observability.attribution import BudgetModel
                from bagua_tpu_torch.observability.regression import RegressionSentinel

                budget = (BudgetModel.from_meter(goodput)
                          if goodput is not None else BudgetModel())
                regression = RegressionSentinel(
                    budget=budget,
                    warmup=get_regression_warmup(),
                    threshold=get_regression_threshold(),
                    cooldown=get_regression_cooldown(),
                )
        self.regression = regression
        if self.regression is not None:
            if self.regression.sink is None:
                self.regression.sink = self.jsonl
            if self.regression.registry is None:
                self.regression.registry = self.registry
        from bagua_tpu_torch.resilience.retry import set_retry_observer

        set_retry_observer(self.on_rpc_retry)
        self.watchdog = watchdog
        if watchdog is not None:
            self.bind_watchdog(watchdog)
        # last known host position — what the watchdog dump reports
        self.current_phase: str = "init"
        self.current_step: int = -1
        self.current_variant: str = ""
        self._t_start = time.time()

    # -- host position (phases, watchdog) ------------------------------------

    def bind_watchdog(self, watchdog: Watchdog) -> None:
        """Point a watchdog's evidence hooks at this hub (idempotent; only
        unset hooks are claimed): timeout dumps carry :meth:`snapshot`, the
        flight recorder rides along, and the hub's :meth:`on_hang` emits the
        schema-validated ``hang`` event before any exit path runs."""
        self.watchdog = watchdog
        if watchdog.snapshot_provider is None:
            watchdog.snapshot_provider = self.snapshot
        if getattr(watchdog, "flight_recorder", None) is None:
            watchdog.flight_recorder = self.flight
        if getattr(watchdog, "hang_hook", None) is None:
            watchdog.hang_hook = self.on_hang

    def enter_phase(self, phase: str) -> None:
        """Mark the host's position in the step (``data`` → ``dispatch`` →
        ``wait`` → ...) and heartbeat the watchdog with the tag."""
        self.current_phase = phase
        if self.watchdog is not None:
            self.watchdog.beat(phase=phase)
        if self.goodput is not None:
            self.goodput.on_phase(phase)
        if self.tracer is not None:
            self.tracer.on_phase(phase)

    def snapshot(self) -> Dict:
        """The last known position + registry snapshot — embedded in the
        watchdog's timeout dump and exposed for debugging."""
        out = {
            "step": self.current_step,
            "phase": self.current_phase,
            "variant": self.current_variant,
            "uptime_s": round(time.time() - self._t_start, 1),
            "recompile": self.recompile.report(),
            "metrics": self.registry.snapshot(),
        }
        if self.tracer is not None:
            # Watchdog + flight dumps embed this snapshot; the active
            # trace/span ids let forensics join a wedged collective back to
            # the exact in-flight trace on the fleet timeline.
            out["trace"] = self.tracer.trace_context()
        if self.regression is not None:
            out["regression"] = self.regression.report()
        return out

    # -- engine feed ---------------------------------------------------------

    def on_step_start(self, step: int, variant: str = "") -> None:
        """The engine is about to run step ``step``: open the sampled root
        span so the phase children (and any RPC issued inside the step)
        hang off one ``train_step`` trace.  No-op without a tracer."""
        if self.tracer is not None:
            self.tracer.begin_step(int(step), variant=variant)

    def on_compile(self, variant: str, step: int) -> None:
        """The engine's step cache missed: ``variant`` is being (re)built."""
        self.current_variant = variant
        retrace = self.recompile.record_compile(variant, on_alert=self._emit_alert)
        self.registry.counter(
            "compiles_total", help="step-function compiles (step cache misses)"
        ).inc()
        if retrace:
            self.registry.counter(
                "retraces_total", help="compiles beyond the warmup compile"
            ).inc()
        if self.jsonl:
            self.jsonl.emit(
                {"event": "compile", "step": int(step), "variant": variant,
                 "retrace": bool(retrace)}
            )

    def on_compile_done(self, variant: str, step: int, wall_ms: float) -> None:
        """The compile announced by :meth:`on_compile` finished; ``wall_ms``
        is its measured wall time (the engine reads it off the miss step's
        dispatch, as the JAX engine reads jit's synchronous compile).  Feeds the
        ``compile_ms`` histogram, the detector's per-variant wall ledger,
        and the goodput ledger's compile bucket."""
        self.recompile.record_compile_wall(variant, wall_ms)
        self.registry.histogram(
            "compile_ms", help="step-function compile wall time"
        ).observe(float(wall_ms))
        if self.goodput is not None:
            self.goodput.on_compile(float(wall_ms) / 1e3)
        if self.regression is not None:
            self.regression.note_compile(float(wall_ms))

    def on_step(
        self,
        step: int,
        wall_s: float,
        n_samples: int,
        wire_bytes: int,
        variant: str = "default",
        host_overhead: Optional[Dict] = None,
        wire_bytes_by_leg: Optional[Dict[str, int]] = None,
        wire_bytes_by_precision: Optional[Dict[str, int]] = None,
        wire_bytes_by_axis: Optional[Dict[str, int]] = None,
    ) -> None:
        """One dispatched training step's host-side evidence.

        ``wire_bytes_by_leg`` breaks ``wire_bytes`` down by wire pattern leg
        (sharded exchanges report ``{"rs": ..., "ag": ...}``); each leg gets
        its own ``wire_bytes_<leg>_total`` counter and the dict rides the
        ``step`` JSONL event (the schema validator allows extra fields on
        known event types).  ``wire_bytes_by_precision`` breaks the same
        traffic down by wire precision (``f32``/``int8``/``int4`` — the
        quantized-ring exchange's modelled bytes); each precision gets a
        ``wire_bytes_precision_<p>_total`` counter — the flat-name analog of
        a ``wire_bytes{precision=...}`` labeled family.
        ``wire_bytes_by_axis`` breaks the traffic down by the named mesh
        axis it rides (``{"dp": ..., "fsdp": ...}`` — the engine joins the
        variant's flight program records' ``axes`` against the plan);
        per-axis ``wire_bytes_axis_<ax>_total`` counters, the regression
        sentinel's per-axis byte census, and the ``step_budget_wire_<ax>_ms``
        per-axis budget gauges hang off it."""
        self.current_step = int(step)
        self.current_variant = variant
        self.recompile.record_step()
        self.step_timer.tick(wall_s, n_samples)
        if self.goodput is not None:
            self.goodput.on_step(wall_s, n_samples)
        r = self.registry
        r.counter("steps_total", help="training steps dispatched").inc()
        r.counter("samples_total", help="samples processed").inc(max(0, int(n_samples)))
        r.counter(
            "wire_bytes_total",
            help="bytes communicated per rank (bucket-plan census)",
        ).inc(max(0, int(wire_bytes)))
        if wire_bytes_by_leg:
            for leg, nbytes in sorted(wire_bytes_by_leg.items()):
                r.counter(
                    f"wire_bytes_{leg}_total",
                    help=f"bytes communicated per rank on the {leg} leg",
                ).inc(max(0, int(nbytes)))
        if wire_bytes_by_precision:
            for prec, nbytes in sorted(wire_bytes_by_precision.items()):
                r.counter(
                    f"wire_bytes_precision_{prec}_total",
                    help=f"bytes communicated per rank at wire precision {prec}",
                ).inc(max(0, int(nbytes)))
        if wire_bytes_by_axis:
            for ax, nbytes in sorted(wire_bytes_by_axis.items()):
                r.counter(
                    f"wire_bytes_axis_{ax}_total",
                    help=f"bytes communicated per rank on mesh axis {ax}",
                ).inc(max(0, int(nbytes)))
        r.histogram("step_wall_ms", help="host-observed step wall time").observe(
            wall_s * 1e3
        )
        sps = (n_samples / wall_s) if wall_s > 0 else 0.0
        r.gauge("samples_per_s", help="instantaneous throughput").set(round(sps, 3))
        if self.tracer is not None:
            # Stamp the step's vitals on the open root but do NOT close it:
            # the trace stays open across the inter-step gap so the data
            # phase and any RPC the fit loop issues between steps (snapshot
            # agreement, autotune report) join the trace that just ran.
            # The next on_step_start (or teardown) closes it.
            self.tracer.note_step(
                wall_ms=round(wall_s * 1e3, 3), wire_bytes=int(wire_bytes)
            )
        if self.regression is not None:
            host_ms = (sum(host_overhead.values()) * 1e3
                       if host_overhead else None)
            goodput_frac = (self.goodput.ledger.goodput_frac()
                            if self.goodput is not None else None)
            budget = self.regression.observe_step(
                int(step), wall_s * 1e3, host_ms=host_ms,
                wire_bytes=int(wire_bytes),
                wire_bytes_by_axis=wire_bytes_by_axis,
                goodput_frac=goodput_frac,
                trace_id=self._trace_fields().get("trace_id", ""),
            )
            # flat-name analog of a bagua_step_budget_ms{component=...}
            # labeled family, same convention as wire_bytes_precision_<p>
            for comp, ms in budget.components.items():
                r.gauge(
                    f"step_budget_{comp}_ms",
                    help=f"step-budget residual attributed to {comp}",
                ).set(round(ms, 4))
            # the wire_slowdown component's per-axis split — the flat-name
            # analog of step_budget_wire_ms{axis=...}; the sub-components
            # sum to step_budget_wire_slowdown_ms exactly
            for ax, ms in sorted(budget.wire_axis_ms.items()):
                r.gauge(
                    f"step_budget_wire_{ax}_ms",
                    help=f"wire_slowdown budget attributed to mesh axis {ax}",
                ).set(round(ms, 4))
            r.gauge(
                "step_budget_expected_ms",
                help="budget-model expected step wall",
            ).set(round(budget.expected_ms, 4))
            r.gauge(
                "step_budget_residual_ms",
                help="measured minus expected step wall",
            ).set(round(budget.residual_ms, 4))
        if self.jsonl:
            event = {
                "event": "step", "step": int(step),
                "wall_ms": round(wall_s * 1e3, 3),
                "samples_per_s": round(sps, 3),
                "wire_bytes": int(wire_bytes),
                "variant": variant,
            }
            if host_overhead:
                event["host_overhead_ms"] = {
                    k: round(v * 1e3, 4) for k, v in host_overhead.items()
                }
            if wire_bytes_by_leg:
                event["wire_bytes_by_leg"] = {
                    k: int(v) for k, v in sorted(wire_bytes_by_leg.items())
                }
            if wire_bytes_by_precision:
                event["wire_bytes_by_precision"] = {
                    k: int(v) for k, v in sorted(wire_bytes_by_precision.items())
                }
            if wire_bytes_by_axis:
                event["wire_bytes_by_axis"] = {
                    k: int(v) for k, v in sorted(wire_bytes_by_axis.items())
                }
            self.jsonl.emit(event)

    def on_rebucket(
        self,
        plan_version: int,
        n_buckets: int,
        step: int = 0,
        predicted_exposed_ms: Optional[float] = None,
        measured_exposed_ms: Optional[float] = None,
        reason: str = "planner",
        algorithm: Optional[str] = None,
    ) -> None:
        """The engine adopted a new bucket plan (autotune re-bucket, or an
        algorithm switch — ``algorithm`` names the newly adopted relaxation
        in that case).

        Exported as the ``plan_version`` gauge + ``rebucket_total`` counter
        (plus a per-reason-family counter — the unified switch vocabulary) so
        a Prometheus scrape shows when and why the plan changed, and as a
        ``rebucket`` JSONL event carrying the planner's predicted
        exposed-communication time for the new plan next to the measured
        value (when a device-trace analysis supplied one) — the
        predicted-vs-measured drift record."""
        from bagua_tpu_torch.observability.metrics import switch_reason_family

        r = self.registry
        r.counter("rebucket_total", help="bucket-plan swaps adopted by the engine").inc()
        r.counter(
            f"rebucket_reason_{switch_reason_family(reason)}_total",
            help="bucket-plan swaps by requesting reason family",
        ).inc()
        r.gauge("plan_version", help="monotonic bucket-plan version").set(plan_version)
        if self.regression is not None:
            self.regression.plan_version = int(plan_version)
        if predicted_exposed_ms is not None:
            r.gauge(
                "predicted_exposed_comm_ms",
                help="planner-predicted exposed communication for the live plan",
            ).set(round(float(predicted_exposed_ms), 4))
        if measured_exposed_ms is not None:
            r.gauge(
                "measured_exposed_comm_ms",
                help="trace-measured exposed communication for the live plan",
            ).set(round(float(measured_exposed_ms), 4))
        if self.tracer is not None:
            self.tracer.record_event(
                "rebucket",
                attrs={"plan_version": int(plan_version),
                       "n_buckets": int(n_buckets), "reason": str(reason)},
            )
        if self.jsonl:
            event = {
                "event": "rebucket", "step": int(step),
                "plan_version": int(plan_version), "n_buckets": int(n_buckets),
                "reason": str(reason),
            }
            if algorithm is not None:
                event["algorithm"] = str(algorithm)
            if predicted_exposed_ms is not None:
                event["predicted_exposed_ms"] = round(float(predicted_exposed_ms), 4)
            if measured_exposed_ms is not None:
                event["measured_exposed_ms"] = round(float(measured_exposed_ms), 4)
            self.jsonl.emit(event)

    def on_precision_switch(
        self,
        step: int,
        plan_version: int,
        old_precisions,
        new_precisions,
        reason: str = "planner",
    ) -> None:
        """The engine adopted a new per-bucket wire-precision plan
        (``DistributedDataParallel.apply_precision_plan`` — planner-driven
        under ``wire_precision="auto"`` or an operator override).  Exported
        as the ``precision_switch_total`` counter plus per-precision bucket
        counts, and as a schema-validated ``precision_switch`` JSONL event
        carrying the full before/after per-bucket precision lists."""
        from bagua_tpu_torch.observability.metrics import switch_reason_family

        r = self.registry
        r.counter(
            "precision_switch_total",
            help="per-bucket wire-precision plan swaps adopted by the engine",
        ).inc()
        r.counter(
            f"precision_switch_reason_{switch_reason_family(reason)}_total",
            help="wire-precision plan swaps by requesting reason family",
        ).inc()
        if self.regression is not None:
            self.regression.plan_version = int(plan_version)
        new_precisions = [str(p) for p in new_precisions]
        for prec in sorted(set(new_precisions)):
            r.gauge(
                f"buckets_at_precision_{prec}",
                help=f"buckets exchanging at wire precision {prec}",
            ).set(new_precisions.count(prec))
        if self.tracer is not None:
            self.tracer.record_event(
                "precision_switch",
                attrs={"plan_version": int(plan_version), "reason": str(reason)},
            )
        if self.jsonl:
            self.jsonl.emit(
                {"event": "precision_switch", "step": int(step),
                 "plan_version": int(plan_version),
                 "old_precisions": [str(p) for p in old_precisions],
                 "new_precisions": new_precisions,
                 "reason": str(reason)}
            )

    def on_staleness_switch(
        self,
        step: int,
        plan_version: int,
        old_tau: int,
        new_tau: int,
        reason: str = "planner",
    ) -> None:
        """The engine re-bounded the staleness knob
        (``DistributedDataParallel.apply_staleness``): the autopilot degraded
        a straggling gang to bounded-staleness exchange, the HealthMonitor
        guardrail tightened τ back to 0 on a convergence alert, or a
        stabilization window re-promoted it.  Exported as the
        ``staleness_switch_total`` counter, a per-reason-family counter, the
        live ``staleness_tau`` gauge, and a schema-validated
        ``staleness_switch`` JSONL event."""
        from bagua_tpu_torch.observability.metrics import switch_reason_family

        r = self.registry
        r.counter(
            "staleness_switch_total",
            help="bounded-staleness bound (tau) swaps adopted by the engine",
        ).inc()
        r.counter(
            f"staleness_switch_reason_{switch_reason_family(reason)}_total",
            help="staleness bound swaps by requesting reason family",
        ).inc()
        r.gauge(
            "staleness_tau",
            help="current bounded-staleness bound (0 = bulk synchronous)",
        ).set(int(new_tau))
        if self.regression is not None:
            self.regression.plan_version = int(plan_version)
        if self.tracer is not None:
            self.tracer.record_event(
                "staleness_switch",
                attrs={"plan_version": int(plan_version), "reason": str(reason)},
            )
        if self.jsonl:
            self.jsonl.emit(
                {"event": "staleness_switch", "step": int(step),
                 "plan_version": int(plan_version),
                 "old_tau": int(old_tau), "new_tau": int(new_tau),
                 "reason": str(reason)}
            )

    def on_plan_decision(
        self,
        step: int,
        decision: str,
        reason: str,
        trace_id: str,
        plan_version: int,
        from_config: dict,
        to_config: dict,
        verdict: str,
        modeled: Optional[dict] = None,
        axis: Optional[str] = None,
    ) -> None:
        """The gang autopilot made one policy decision
        (:class:`~bagua_tpu.autopilot.GangAutopilot`): demote / re-promote /
        switch / roll back / hold.  ``trace_id`` cites the triggering
        ``perf_regression`` incident (empty when the trigger was a health
        alert or a stabilization window); ``reason`` speaks the unified
        switch vocabulary; ``modeled`` optionally carries the α–β priced
        ``{"stay_ms", "chosen_ms"}`` comparison the decision rests on;
        ``axis`` names the mesh axis the incident indicted (the candidates
        were priced with only that axis's legs degraded).
        Exported as ``plan_decisions_total`` plus a per-verdict counter and
        a schema-validated ``plan_decision`` JSONL event the timeline tools
        join to incidents and switch events by ``trace_id``/``plan_version``."""
        r = self.registry
        r.counter("plan_decisions_total", help="autopilot policy decisions").inc()
        r.counter(
            f"plan_decisions_{verdict}_total",
            help=f"autopilot decisions with verdict {verdict}",
        ).inc()
        if self.tracer is not None:
            self.tracer.record_event(
                "plan_decision",
                attrs={"decision": str(decision), "verdict": str(verdict),
                       "plan_version": int(plan_version)},
            )
        if self.jsonl:
            event = {
                "event": "plan_decision", "step": int(step),
                "decision": str(decision), "reason": str(reason),
                "trace_id": str(trace_id), "plan_version": int(plan_version),
                "from_config": dict(from_config), "to_config": dict(to_config),
                "verdict": str(verdict),
            }
            if modeled is not None:
                event["modeled"] = {
                    k: round(float(v), 4) for k, v in modeled.items()
                }
            if axis:
                event["axis"] = str(axis)
            self.jsonl.emit(event)

    def on_snapshot(
        self, step: int, wall_ms: float, n_bytes: int, kind: str = "async"
    ) -> None:
        """The resilience subsystem wrote one state snapshot (``kind``
        ``"async"`` = cadenced background write off the critical path,
        ``"final"`` = forced synchronous write on the preemption drain).
        ``wall_ms`` is the *writer thread's* wall time — the hot path only
        paid the device-side buffer copy dispatch."""
        r = self.registry
        r.counter("snapshots_total", help="state snapshots written").inc()
        r.histogram(
            "snapshot_wall_ms",
            help="background snapshot write time (off the critical path)",
        ).observe(float(wall_ms))
        r.gauge("snapshot_last_step", help="step of the newest snapshot").set(step)
        if self.goodput is not None:
            self.goodput.on_snapshot(kind, float(wall_ms))
        if self.regression is not None and kind != "async":
            # only blocking writes stall the step loop; cadenced async
            # snapshots ride the background writer and cost the step nothing
            self.regression.note_snapshot(float(wall_ms))
        if self.tracer is not None:
            self.tracer.record_event(
                "snapshot",
                attrs={"kind": str(kind), "bytes": int(n_bytes)},
                wall_ms=float(wall_ms),
            )
        if self.jsonl:
            self.jsonl.emit(
                {"event": "snapshot", "step": int(step),
                 "wall_ms": round(float(wall_ms), 3),
                 "bytes": int(n_bytes), "kind": kind}
            )

    def on_restart(
        self,
        step: int,
        old_world_size: int,
        new_world_size: int,
        plan_source: str = "fresh",
        lost_steps: int = 0,
    ) -> None:
        """The gang resumed from a snapshot (elastic restart).  ``step`` is
        the resumed-from step; ``lost_steps`` counts steps the previous
        incarnation ran past it (0 when the preemption drain landed its
        final snapshot); ``plan_source`` records whether the tuned bucket
        plan was carried over (``"carried"``) or rebuilt (``"fresh"``)."""
        r = self.registry
        r.counter("restarts_total", help="elastic resumes from a snapshot").inc()
        r.counter(
            "lost_steps_total",
            help="training steps lost across restarts (bounded by the snapshot cadence)",
        ).inc(max(0, int(lost_steps)))
        r.gauge("resumed_world_size", help="gang size after the latest resume").set(
            new_world_size
        )
        if self.goodput is not None:
            self.goodput.on_restart(lost_steps)
        if self.jsonl:
            self.jsonl.emit(
                {"event": "restart", "step": int(step),
                 "old_world_size": int(old_world_size),
                 "new_world_size": int(new_world_size),
                 "plan_source": plan_source, "lost_steps": int(lost_steps)}
            )

    def on_health_alert(
        self,
        step: int,
        kind: str,
        value: float,
        threshold: float,
        detail: str = "",
        actions=(),
    ) -> None:
        """The health monitor detected an anomaly (``kind`` one of
        ``loss_spike``/``grad_norm_explosion``/``nonfinite``); ``actions``
        lists the registered corrective actions that reported applying.
        Exported as a per-kind counter and a schema-validated
        ``health_alert`` JSONL event."""
        self.registry.counter(
            f"health_alerts_{kind}_total",
            help=f"health anomalies of kind {kind}",
        ).inc()
        if self.jsonl:
            event = {
                "event": "health_alert", "step": int(step), "kind": str(kind),
                "value": float(value), "threshold": float(threshold),
                "detail": str(detail), "actions": [str(a) for a in actions],
            }
            event.update(self._trace_fields())
            self.jsonl.emit(event)

    def bind_breaker(self, breaker) -> None:
        """Point a :class:`~bagua_tpu_torch.resilience.retry.CircuitBreaker`'s
        transition hook at this hub (idempotent; an already-set listener is
        left alone): every evented state change — closed→open,
        open→half-open, half-open→closed/open — lands as a
        ``breaker_transition`` JSONL event plus ``breaker_state`` gauges."""
        if getattr(breaker, "listener", None) is None:
            breaker.listener = self.on_breaker_transition

    #: breaker state → gauge code (closed=0 half-open=1 open=2): a scrape
    #: alerting on ``breaker_state > 0`` catches both degraded states.
    BREAKER_STATE_CODES = {"closed": 0, "half-open": 1, "open": 2}

    def on_breaker_transition(
        self, name: str, old_state: str, new_state: str
    ) -> None:
        """One circuit-breaker state change (see
        :class:`~bagua_tpu_torch.resilience.retry.CircuitBreaker`): exported as
        the shared ``breaker_state`` gauge, a per-breaker
        ``breaker_state_<name>`` gauge, a ``breaker_transitions_total``
        counter, and the schema-validated ``breaker_transition`` event."""
        code = self.BREAKER_STATE_CODES.get(new_state, -1)
        r = self.registry
        r.gauge(
            "breaker_state",
            help="newest breaker transition (0 closed / 1 half-open / 2 open)",
        ).set(code)
        safe = "".join(c if c.isalnum() else "_" for c in str(name))
        r.gauge(
            f"breaker_state_{safe}",
            help=f"breaker {name} state (0 closed / 1 half-open / 2 open)",
        ).set(code)
        r.counter(
            "breaker_transitions_total", help="circuit-breaker state changes"
        ).inc()
        if self.tracer is not None:
            sp = self.tracer.current_span()
            if sp is not None:
                sp.annotate(
                    "breaker_transition",
                    breaker=str(name), old=str(old_state), new=str(new_state),
                )
        if self.jsonl:
            self.jsonl.emit(
                {"event": "breaker_transition", "step": int(self.current_step),
                 "breaker": str(name), "old_state": str(old_state),
                 "new_state": str(new_state)}
            )

    def on_hang(self, reason: str, ctx: Optional[dict] = None,
                dump_paths: Optional[dict] = None) -> None:
        """The watchdog (or a preemption drain) declared this rank hung:
        bump ``hangs_total`` and emit the schema-validated ``hang`` JSONL
        event, then flush — the process may be about to ``os._exit``, and
        the event must already be on disk when the restart loop's collector
        arrives.  Bound to ``Watchdog.hang_hook`` so it runs *before*
        ``on_timeout``."""
        ctx = ctx or {}
        self.registry.counter(
            "hangs_total", help="watchdog timeouts / hang declarations"
        ).inc()
        if self.jsonl:
            event = {
                "event": "hang", "step": int(self.current_step),
                "reason": str(reason),
                "last_phase": str(ctx.get("last_phase") or self.current_phase),
            }
            if dump_paths:
                event["dumps"] = {k: str(v) for k, v in sorted(dump_paths.items())}
            if self.flight is not None:
                event["flight_last_seq"] = int(self.flight.last_seq)
            event.update(self._trace_fields())
            self.jsonl.emit(event)
            self.flush()

    def _trace_fields(self) -> Dict:
        """``{"trace_id", "span_id"}`` extras for events that should join
        the timeline (hang, health_alert, rpc_retry); empty when no trace
        is active."""
        if self.tracer is None:
            return {}
        return self.tracer.trace_context()

    def on_rpc_retry(
        self,
        endpoint: str,
        attempt: int,
        delay_s: float,
        reason: str = "error",
        retry_after_s: Optional[float] = None,
    ) -> None:
        """One ``retry_call`` backoff sleep (installed as the process-wide
        retry observer): the otherwise-invisible dead time lands as the
        ``rpc_retry_total`` / ``rpc_backoff_s_total`` counters and a
        schema-validated ``rpc_retry`` event.  Emit failures are swallowed —
        a closed sink (hub torn down mid-retry) must never break a live
        RPC retry loop."""
        r = self.registry
        r.counter("rpc_retry_total", help="retry_call backoff sleeps").inc()
        r.counter(
            "rpc_backoff_s_total",
            help="cumulative seconds slept in RPC retry backoff",
        ).inc(max(0.0, float(delay_s)))
        if reason == "backpressure":
            r.counter(
                "rpc_backpressure_total",
                help="retries paced by a server Retry-After hint (429s)",
            ).inc()
        if self.regression is not None:
            self.regression.note_backpressure(float(delay_s))
        if self.jsonl:
            event = {
                "event": "rpc_retry", "step": int(self.current_step),
                "endpoint": str(endpoint), "attempt": int(attempt),
                "delay_s": round(float(delay_s), 4), "reason": str(reason),
            }
            if retry_after_s is not None:
                event["retry_after_s"] = round(float(retry_after_s), 3)
            event.update(self._trace_fields())
            try:
                self.jsonl.emit(event)
            except ValueError:
                pass  # sink closed under us; the counters still landed

    def _emit_alert(self, msg: str, retraces_in_window: int) -> None:
        self.registry.counter(
            "retrace_alerts_total", help="recompile-rate alarms raised"
        ).inc()
        if self.jsonl:
            self.jsonl.emit(
                {"event": "retrace_alert", "step": int(self.current_step),
                 "retraces": int(retraces_in_window),
                 "window": self.recompile.window, "message": msg}
            )

    # -- export / teardown ---------------------------------------------------

    def export_prometheus(self, path: str) -> None:
        """Write the registry as a Prometheus textfile (atomic)."""
        self.registry.write_prometheus(path)

    def flush(self) -> None:
        """Durably flush the JSONL stream without closing it — the trainer's
        exception-safe teardown calls this so a crash mid-``fit`` never loses
        buffered events, while the hub stays usable for a post-mortem."""
        if self.jsonl:
            self.jsonl.flush()

    def close(self) -> None:
        from bagua_tpu_torch.resilience.retry import get_retry_observer, set_retry_observer

        if get_retry_observer() == self.on_rpc_retry:
            set_retry_observer(None)
        if self.tracer is not None:
            from bagua_tpu_torch.observability.tracing import (
                get_global_tracer, set_global_tracer,
            )

            if get_global_tracer() is self.tracer:
                set_global_tracer(None)
            self.tracer.close()
        if self.jsonl:
            self.jsonl.close()

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
