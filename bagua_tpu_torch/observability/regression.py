"""The performance-regression sentinel: online changepoint detection over
the step-wall and goodput streams, with a budget-attribution verdict.

A perf regression is the failure aggregate dashboards confirm and nobody
explains: the step wall drifts 20% and the job keeps training.  The
sentinel watches the two streams the hub already produces — step wall (up
is bad) and goodput fraction (down is bad) — with one-sided standardized
**CUSUM** detectors: each sample's deviation from an EWMA baseline, in
baseline-σ units, accumulates into ``s = max(0, s + z − k)``; ``s > h``
trips.  CUSUM catches the small-but-sustained drift a single-sample
z-threshold misses, while the drift allowance ``k`` ignores ordinary
jitter; warmup suppresses everything until the baseline settles (the
health monitor's discipline), and a cooldown re-arms the trip so one
incident doesn't become a stream of them.

On trip the sentinel aggregates the recent window of
:class:`~bagua_tpu_torch.observability.attribution.StepBudget` rows, names the
**dominant** component, and emits one schema-validated ``perf_regression``
JSONL event carrying the full component partition, the residual, the live
``plan_version`` and the active ``trace_id`` — the attribution verdict the
fleet scheduler view and the autopilot consume.  Incidents queue in
:meth:`drain_incidents` for the gang's best-effort push to the fleet
control plane's volatile incident tier.

Everything is host-side arithmetic: sentinel on vs off trains
bitwise-identical state (pinned in CI for ``gradient_allreduce`` and
``zero`` with overlap on, the health-monitor/flight-recorder contract).
"""

import collections
import logging
import math
import time
from typing import Dict, List, Optional

from bagua_tpu_torch.observability.attribution import (
    BUDGET_COMPONENTS,
    BudgetModel,
    StepBudget,
)

logger = logging.getLogger(__name__)

__all__ = ["Cusum", "RegressionSentinel"]


class Cusum:
    """One-sided standardized CUSUM over a scalar stream.

    The baseline mean/variance are EWMAs fed only by in-family samples
    (``z < h``) — a sustained shift must trip the detector, not get
    absorbed into the baseline.  ``direction=+1`` watches for upward
    shifts (step wall), ``-1`` for downward (goodput).  The σ floor
    (``rel_floor`` of the mean, plus ``abs_floor``) keeps a near-constant
    clean stream from hair-triggering on numerically tiny variance.
    """

    def __init__(self, k: float = 1.0, h: float = 8.0, warmup: int = 30,
                 alpha: float = 0.05, direction: int = 1,
                 rel_floor: float = 0.02, abs_floor: float = 1e-6):
        self.k = float(k)
        self.h = float(h)
        self.warmup = max(1, int(warmup))
        self.alpha = float(alpha)
        self.direction = 1 if direction >= 0 else -1
        self.rel_floor = float(rel_floor)
        self.abs_floor = float(abs_floor)
        self.mean: Optional[float] = None
        self.var = 0.0
        self.n = 0
        self.s = 0.0
        self.trips = 0

    def _sigma(self) -> float:
        sigma = math.sqrt(max(0.0, self.var))
        floor = max(self.abs_floor, self.rel_floor * abs(self.mean or 0.0))
        return max(sigma, floor)

    def update(self, x: float) -> bool:
        """Feed one sample; True when the accumulated drift trips ``h``
        (the accumulator resets so the caller's cooldown owns re-arming)."""
        x = float(x)
        self.n += 1
        if self.mean is None:
            self.mean = x
            return False
        z = self.direction * (x - self.mean) / self._sigma()
        in_family = z < self.h
        if in_family or self.n <= self.warmup:
            delta = x - self.mean
            self.mean += self.alpha * delta
            self.var = (1.0 - self.alpha) * (self.var + self.alpha * delta * delta)
        if self.n <= self.warmup:
            return False
        self.s = max(0.0, self.s + z - self.k)
        if self.s > self.h:
            self.s = 0.0
            self.trips += 1
            return True
        return False


class RegressionSentinel:
    """Watches the per-step stream, attributes regressions, emits incidents.

    Args:
        budget: the :class:`~bagua_tpu_torch.observability.attribution.BudgetModel`
            pricing the expected step (default: a self-calibrating one).
        sink: a :class:`~bagua_tpu_torch.observability.metrics.JsonlSink` for the
            schema-validated ``perf_regression`` events (None = incidents
            only accumulate in memory).
        registry: a :class:`~bagua_tpu_torch.observability.metrics.MetricsRegistry`
            for the ``perf_regressions_total`` counter.
        warmup / threshold / drift_k / alpha: CUSUM knobs (shared by both
            streams; env defaults ``BAGUA_REGRESSION_WARMUP`` /
            ``BAGUA_REGRESSION_THRESHOLD``).
        cooldown: steps after a trip before the sentinel can trip again.
        window: how many recent budgets an incident's verdict aggregates.
        topology: any object with ``axis_link(axis) -> str`` resolving an
            indicted axis to its physical link class on wire-dominant
            incidents; defaults to
            :data:`~bagua_tpu_torch.perflab.topology.DEFAULT_TOPOLOGY`, the
            port's one link model (``nvlink`` / ``network``; the JAX
            package's resolves to ``ici`` / ``dcn``).

    Beyond the wall/goodput detectors, the sentinel runs **one CUSUM stream
    per mesh axis** over the budgets' per-axis ``wire_slowdown`` split
    (``StepBudget.wire_axis_ms``, lazily created as axes appear).  An axis
    stream's sustained drift trips like the scalar streams do, and any
    wire-dominant incident names the ``axis`` whose windowed slowdown
    dominates plus its ``link_class`` — a tp/NVLink brownout and a
    dp/network collapse become distinguishable verdicts.
    """

    def __init__(self, budget: Optional[BudgetModel] = None, sink=None,
                 registry=None, warmup: int = 30, threshold: float = 8.0,
                 drift_k: float = 1.0, alpha: float = 0.05,
                 cooldown: int = 50, window: int = 20,
                 max_incidents: int = 256, topology=None):
        self.budget = budget or BudgetModel()
        self.sink = sink
        self.registry = registry
        if topology is None:
            from bagua_tpu_torch.perflab.topology import DEFAULT_TOPOLOGY

            topology = DEFAULT_TOPOLOGY
        self.topology = topology
        self.cooldown = max(0, int(cooldown))
        self.window = max(1, int(window))
        self.max_incidents = max(1, int(max_incidents))
        self._wall = Cusum(k=drift_k, h=threshold, warmup=warmup,
                           alpha=alpha, direction=+1)
        self._goodput = Cusum(k=drift_k, h=threshold, warmup=warmup,
                              alpha=alpha, direction=-1)
        # one lazily-created detector per mesh axis over the per-axis wire
        # slowdown stream; the raised σ floor (0.05 ms vs the default 1e-6)
        # keeps an all-zeros clean split from hair-triggering on noise
        self._axis_cusum_kwargs = dict(k=drift_k, h=threshold, warmup=warmup,
                                       alpha=alpha, direction=+1,
                                       abs_floor=0.05)
        self._axis_cusums: Dict[str, Cusum] = {}
        self._budgets: collections.deque = collections.deque(maxlen=self.window)
        self._cooldown_until = -1
        self._steps_seen = 0
        self.plan_version = 0
        self.incidents: List[Dict] = []
        self._pending: List[Dict] = []

    # -- evidence hooks (delegated to the budget model) -----------------------

    def note_compile(self, wall_ms: float) -> None:
        self.budget.note_compile(wall_ms)

    def note_snapshot(self, wall_ms: float) -> None:
        self.budget.note_snapshot(wall_ms)

    def note_backpressure(self, delay_s: float) -> None:
        self.budget.note_backpressure(delay_s)

    def note_straggler(self, excess_ms: float, rank: int = -1) -> None:
        self.budget.note_straggler(excess_ms, rank=rank)

    def mark_degraded(self, ranks) -> None:
        self.budget.mark_degraded(ranks)

    def note_wire(self, measured_wire_ms: float,
                  by_axis: Optional[Dict[str, float]] = None) -> None:
        self.budget.note_wire(measured_wire_ms, by_axis=by_axis)

    # -- the per-step entry point ---------------------------------------------

    def observe_step(
        self,
        step: int,
        wall_ms: float,
        host_ms: Optional[float] = None,
        wire_bytes: Optional[float] = None,
        wire_bytes_by_axis: Optional[Dict[str, float]] = None,
        goodput_frac: Optional[float] = None,
        trace_id: str = "",
    ) -> StepBudget:
        """Settle this step's budget and run every detector; on trip, emit
        one ``perf_regression`` incident.  Returns the settled budget (the
        hub exports its components as ``step_budget_<component>_ms``
        gauges, and its per-axis wire split as
        ``step_budget_wire_<axis>_ms``)."""
        self._steps_seen += 1
        budget = self.budget.settle(step, wall_ms, host_ms=host_ms,
                                    wire_bytes=wire_bytes,
                                    wire_bytes_by_axis=wire_bytes_by_axis)
        self._budgets.append(budget)
        tripped_wall = self._wall.update(wall_ms)
        tripped_goodput = (goodput_frac is not None
                           and self._goodput.update(goodput_frac))
        tripped_axis = None
        for ax in sorted(budget.wire_axis_ms):
            detector = self._axis_cusums.get(ax)
            if detector is None:
                detector = self._axis_cusums[ax] = Cusum(
                    **self._axis_cusum_kwargs)
            if detector.update(budget.wire_axis_ms[ax]) and tripped_axis is None:
                tripped_axis = ax
        if ((tripped_wall or tripped_goodput or tripped_axis is not None)
                and self._steps_seen > self._cooldown_until):
            if tripped_wall:
                stream = "step_wall"
            elif tripped_goodput:
                stream = "goodput"
            else:
                stream = f"wire_axis:{tripped_axis}"
            self._trip(step, stream, trace_id, axis=tripped_axis)
            self._cooldown_until = self._steps_seen + self.cooldown
        return budget

    # -- the incident ---------------------------------------------------------

    def _verdict(self) -> Dict:
        """Aggregate the recent window into one partition + dominant name."""
        components = dict.fromkeys(BUDGET_COMPONENTS, 0.0)
        wire_axis: Dict[str, float] = {}
        residual = measured = expected = 0.0
        straggler_rank = -1
        for b in self._budgets:
            for c in BUDGET_COMPONENTS:
                components[c] += b.components.get(c, 0.0)
            for ax, ms in b.wire_axis_ms.items():
                wire_axis[ax] = wire_axis.get(ax, 0.0) + ms
            residual += b.residual_ms
            measured += b.measured_ms
            expected += b.expected_ms
            if b.straggler_rank >= 0:
                straggler_rank = b.straggler_rank
        dominant = max(components, key=lambda c: components[c])
        if components[dominant] <= 0:
            dominant = "unattributed"
        return {
            "components": {k: round(v, 4) for k, v in components.items()},
            "dominant": dominant,
            "wire_axis": {k: round(v, 4) for k, v in sorted(wire_axis.items())},
            "residual_ms": round(residual, 4),
            "measured_ms": round(measured, 4),
            "expected_ms": round(expected, 4),
            "straggler_rank": straggler_rank,
        }

    def _trip(self, step: int, stream: str, trace_id: str,
              axis: Optional[str] = None) -> None:
        verdict = self._verdict()
        # ts stamped here (not left to the sink) so drained incidents carry
        # it onto the fleet timeline even when no JSONL sink is attached
        event = {
            "event": "perf_regression",
            "ts": time.time(),
            "step": int(step),
            "stream": stream,
            "dominant": verdict["dominant"],
            "components": verdict["components"],
            "residual_ms": verdict["residual_ms"],
            "expected_ms": verdict["expected_ms"],
            "measured_ms": verdict["measured_ms"],
            "plan_version": int(self.plan_version),
            "trace_id": str(trace_id or ""),
        }
        if verdict["straggler_rank"] >= 0:
            event["straggler_rank"] = verdict["straggler_rank"]
        # a wire-dominant verdict indicts the axis whose windowed slowdown
        # dominates (or the axis whose own CUSUM stream tripped), resolved
        # through the topology to the physical link class it rides
        wire_axis = verdict["wire_axis"]
        if axis is None and verdict["dominant"] == "wire_slowdown" and wire_axis:
            worst = max(sorted(wire_axis), key=lambda a: wire_axis[a])
            if wire_axis[worst] > 0:
                axis = worst
        if axis is not None:
            event["axis"] = str(axis)
            event["link_class"] = self.topology.axis_link(str(axis))
            if wire_axis:
                event["wire_axis_ms"] = wire_axis
        logger.warning(
            "perf regression at step %d (%s stream): dominant=%s "
            "residual=%.2fms over the last %d steps",
            step, stream, event["dominant"], event["residual_ms"],
            len(self._budgets),
        )
        if self.registry is not None:
            self.registry.counter(
                "perf_regressions_total",
                help="regression-sentinel trips (perf_regression incidents)",
            ).inc()
        if self.sink is not None:
            try:
                self.sink.emit(dict(event))
            except ValueError:
                pass  # sink closed under us; the incident still queues
        self.incidents.append(event)
        if len(self.incidents) > self.max_incidents:
            del self.incidents[: len(self.incidents) - self.max_incidents]
        self._pending.append(event)
        if len(self._pending) > self.max_incidents:
            del self._pending[: len(self._pending) - self.max_incidents]

    def drain_incidents(self) -> List[Dict]:
        """Incidents emitted since the last drain — what the gang
        aggregator pushes (best-effort) to the fleet incident tier."""
        out, self._pending = self._pending, []
        return out

    def rebaseline(self, wire_ms: Optional[float] = None,
                   axis_wire_ms: Optional[Dict[str, float]] = None) -> None:
        """A committed configuration change (rebucket, precision switch,
        algorithm switch) legitimately moved the step wall: reset every CUSUM
        baseline — the wall/goodput pair and the per-axis streams — so they
        re-learn over a fresh warmup instead of reading the new steady state
        as a sustained regression, and optionally re-price the budget's wire
        expectation to the new configuration's modeled wire (the autopilot
        passes its α–β prediction at nominal bandwidth; ``axis_wire_ms``
        re-prices the per-axis ledger alongside)."""
        for detector in (self._wall, self._goodput):
            detector.mean = None
            detector.var = 0.0
            detector.n = 0
            detector.s = 0.0
        self._axis_cusums = {}
        self._budgets.clear()
        if wire_ms is not None:
            self.budget.wire_ms = float(wire_ms)
        if axis_wire_ms is not None:
            self.budget.axis_wire_ms = {
                str(k): float(v) for k, v in axis_wire_ms.items()
            }

    def report(self) -> Dict:
        return {
            "steps_seen": self._steps_seen,
            "incidents": len(self.incidents),
            "wall_trips": self._wall.trips,
            "goodput_trips": self._goodput.trips,
            "axis_trips": {
                ax: c.trips for ax, c in sorted(self._axis_cusums.items())
                if c.trips
            },
            "last_incident": self.incidents[-1] if self.incidents else None,
            "budget": self.budget.report(),
        }
