"""Step-time budget attribution: price the expected step, name the residual.

The stack already *records* every ingredient of a slow step — the perflab
prices compute, the planner's fitted α–β :class:`~bagua_tpu_torch.service.planner.CostModel`
prices the wire, the recompile detector measures compile walls, the
snapshotter reports blocking writes, the gang aggregator scores stragglers,
and ``retry_call`` counts backpressure sleeps — but they are disjoint
streams: a 20% step-wall regression produces five uncorrelated artifacts
and zero verdicts.  This module is the joiner: a per-step **budget model**
that prices the *expected* step wall and decomposes the measured-minus-
expected residual into named components:

``compile``
    measured compile wall charged to this step (a step-cache miss — the
    engine reads it off the miss step's dispatch).
``snapshot``
    blocking snapshot wall (``kind != "async"``: anomaly/final writes stall
    the step loop; cadenced async writes cost nothing here).
``host_data``
    host-side overhead (pre/lock-wait/post + data wait) above its
    calibrated baseline.
``wire_slowdown``
    measured wire time beyond the α–β prediction, or — when only the
    byte census moved — the priced cost of wire bytes beyond baseline.
``straggler``
    the gang aggregator's attributed excess (straggler p50 − gang median).
``backpressure``
    RPC retry backoff sleeps (429-paced and error retries).
``unattributed``
    whatever remains: ``residual − sum(named)``.  The components therefore
    **sum to the residual by construction** — the same partition guarantee
    the goodput ledger pins (±1% in tests), made exact here because the
    remainder is the definition, not a hope.

The model is host-side arithmetic over numbers the hub already holds —
attaching it never touches the traced program (bitwise-inert, the health-
monitor discipline).  :class:`~bagua_tpu_torch.observability.regression.RegressionSentinel`
consumes the per-step :class:`StepBudget` stream and turns a sustained
regression into one ``perf_regression`` incident carrying the verdict.
"""

import dataclasses
import statistics
from typing import Dict, Optional

__all__ = [
    "BUDGET_COMPONENTS",
    "BudgetModel",
    "StepBudget",
    "priced_axis_wire_ms",
]

#: every attribution component, in report order; ``unattributed`` is always
#: last — it is the constructed remainder that makes the partition exact.
BUDGET_COMPONENTS = (
    "compile",
    "snapshot",
    "host_data",
    "wire_slowdown",
    "straggler",
    "backpressure",
    "unattributed",
)


def priced_axis_wire_ms(cost_model, program) -> Dict[str, float]:
    """Join one step's flight/IR program against the planner's per-axis α–β
    legs: every record carrying ``axes`` (stamped by ``annotate()`` and
    mirrored by ``predict_flight_program``) is priced on each axis's fitted
    leg — :meth:`~bagua_tpu_torch.service.planner.CostModel.axis_leg` falls back
    to the ``flat`` leg on legacy 1-D meshes — with a joint multi-axis
    exchange's bytes split evenly across its axes.  Returns ``{axis: ms}``
    (empty when no record carries axes)."""
    out: Dict[str, float] = {}
    if cost_model is None:
        return out
    for rec in program or ():
        axes = [a for a in (rec.get("axes") or ()) if a]
        nbytes = float(rec.get("nbytes") or 0.0)
        if not axes or nbytes <= 0:
            continue
        share = nbytes / len(axes)
        for ax in axes:
            out[ax] = out.get(ax, 0.0) + cost_model.axis_leg(ax).predict(share) * 1e3
    return out


@dataclasses.dataclass
class StepBudget:
    """One settled step: measured vs expected wall and the named partition
    of the difference.  ``components`` carries every name in
    :data:`BUDGET_COMPONENTS` and sums to ``residual_ms`` exactly.
    ``wire_axis_ms`` splits ``components["wire_slowdown"]`` by mesh axis —
    the sub-partition sums to the component exactly (same construction:
    the component IS the sum) and is empty on axis-blind meshes."""

    step: int
    measured_ms: float
    expected_ms: float
    residual_ms: float
    components: Dict[str, float]
    dominant: str = ""
    calibrated: bool = False
    straggler_rank: int = -1
    wire_axis_ms: Dict[str, float] = dataclasses.field(default_factory=dict)

    def partition_error_ms(self) -> float:
        """|sum(components) − residual| — zero up to float rounding."""
        return abs(sum(self.components.values()) - self.residual_ms)

    def axis_partition_error_ms(self) -> float:
        """|sum(wire_axis_ms) − wire_slowdown| — exactly zero when the axis
        split exists (the component is constructed as the sum)."""
        if not self.wire_axis_ms:
            return 0.0
        return abs(sum(self.wire_axis_ms[ax] for ax in sorted(self.wire_axis_ms))
                   - self.components.get("wire_slowdown", 0.0))

    def payload(self) -> Dict:
        out = dataclasses.asdict(self)
        out["components"] = {k: round(v, 4) for k, v in self.components.items()}
        out["wire_axis_ms"] = {
            k: round(v, 4) for k, v in sorted(self.wire_axis_ms.items())
        }
        for key in ("measured_ms", "expected_ms", "residual_ms"):
            out[key] = round(out[key], 4)
        return out


class BudgetModel:
    """Prices the expected step and settles one :class:`StepBudget` per
    dispatched step.

    Two pricing modes, composable:

    * **priced** — ``compute_ms`` (perflab census / roofline) and a wire
      price (``wire_ms`` directly, or ``cost_model`` + ``bucket_bytes``
      through :func:`~bagua_tpu_torch.observability.goodput.predicted_wire_time`)
      with ``overlap_frac`` naming how much of the wire the schedule hides:
      ``expected = compute + (1 − overlap_frac) × wire``.
    * **self-calibrated** — with no prices given, the expected wall is the
      median of the first ``calibrate_steps`` *clean* steps (no compile,
      snapshot, straggler or backpressure noted).  Until calibration
      settles, ``expected = measured`` so the residual is zero — the model
      cannot cry wolf while it is still learning the baseline.

    The engine/hub feed per-step evidence through the ``note_*`` hooks
    (cleared at every :meth:`settle`); nothing here reads the device or the
    traced program.
    """

    def __init__(
        self,
        compute_ms: Optional[float] = None,
        wire_ms: Optional[float] = None,
        overlap_frac: float = 0.0,
        cost_model=None,
        bucket_bytes=None,
        hierarchical: bool = False,
        wire_pattern: str = "allreduce",
        calibrate_steps: int = 20,
        axis_wire_ms: Optional[Dict[str, float]] = None,
        program=None,
    ):
        self.compute_ms = None if compute_ms is None else float(compute_ms)
        self.overlap_frac = min(1.0, max(0.0, float(overlap_frac)))
        self.cost_model = cost_model
        self.hierarchical = bool(hierarchical)
        self.wire_pattern = str(wire_pattern)
        # per-axis expected wire: given directly, or joined from the step's
        # flight/IR program (records carry ``axes``) against ``axis_legs``
        if axis_wire_ms is None and program is not None:
            axis_wire_ms = priced_axis_wire_ms(cost_model, program) or None
        self.axis_wire_ms: Dict[str, float] = {
            str(k): float(v) for k, v in (axis_wire_ms or {}).items()
        }
        if wire_ms is None and self.axis_wire_ms:
            # the axis-priced ledger IS the wire expectation: the scalar is
            # its sum, so the per-axis split partitions it by construction
            wire_ms = sum(self.axis_wire_ms[ax]
                          for ax in sorted(self.axis_wire_ms))
        if wire_ms is None and cost_model is not None and bucket_bytes:
            from bagua_tpu_torch.observability.goodput import predicted_wire_time

            wire_ms = predicted_wire_time(
                cost_model, bucket_bytes, hierarchical=hierarchical,
                wire_pattern=wire_pattern) * 1e3
        self.wire_ms = None if wire_ms is None else float(wire_ms)
        self.calibrate_steps = max(1, int(calibrate_steps))
        # calibration samples from clean steps: wall, host ms, wire bytes
        self._wall_samples = []
        self._host_samples = []
        self._bytes_samples = []
        self._axis_bytes_samples: Dict[str, list] = {}
        # per-step evidence, cleared on settle
        self._compile_ms = 0.0
        self._snapshot_ms = 0.0
        self._backpressure_s = 0.0
        self._straggler_ms = 0.0
        self._straggler_rank = -1
        self._measured_wire_ms: Optional[float] = None
        self._measured_wire_axis_ms: Optional[Dict[str, float]] = None
        # ranks running under a bounded-staleness degradation directive:
        # their excess over the gang median is the *expected* behavior (the
        # gang paces at the median, not the straggler's max), so straggler
        # evidence naming them must not charge the budget
        self._degraded_ranks: set = set()

    @classmethod
    def from_meter(cls, meter, compute_ms: Optional[float] = None,
                   overlap_frac: float = 0.0, calibrate_steps: int = 20
                   ) -> "BudgetModel":
        """Price the wire from an attached
        :class:`~bagua_tpu_torch.observability.goodput.GoodputMeter` (its fitted
        cost model + live bucket plan, routed through the per-axis legs
        when the plan rides a named mesh); compute stays self-calibrated
        unless supplied."""
        wire_s = meter.predicted_wire_s() if meter is not None else None
        by_axis = (meter.predicted_wire_by_axis_s()
                   if meter is not None
                   and hasattr(meter, "predicted_wire_by_axis_s") else None)
        return cls(
            compute_ms=compute_ms,
            wire_ms=None if wire_s is None else wire_s * 1e3,
            overlap_frac=overlap_frac,
            cost_model=getattr(meter, "cost_model", None),
            calibrate_steps=calibrate_steps,
            axis_wire_ms=(
                {ax: s * 1e3 for ax, s in by_axis.items()} if by_axis else None
            ),
        )

    # -- per-step evidence hooks (cleared at settle) --------------------------

    def note_compile(self, wall_ms: float) -> None:
        """A step-cache miss rebuilt the step inside this step's dispatch."""
        self._compile_ms += max(0.0, float(wall_ms))

    def note_snapshot(self, wall_ms: float) -> None:
        """A *blocking* snapshot write stalled this step."""
        self._snapshot_ms += max(0.0, float(wall_ms))

    def note_backpressure(self, delay_s: float) -> None:
        """One RPC retry backoff sleep (429-paced or error retry)."""
        self._backpressure_s += max(0.0, float(delay_s))

    def note_straggler(self, excess_ms: float, rank: int = -1) -> None:
        """The gang aggregator attributed this window to a straggling rank;
        ``excess_ms`` is its p50 over the gang median.  Evidence naming a
        rank the engine already degraded to bounded-staleness exchange is
        dropped: under degradation the gang steps at the *median* pace by
        construction, so the indicted rank's excess no longer stretches the
        step wall and must not trip the sentinel again."""
        if int(rank) in self._degraded_ranks:
            return
        self._straggler_ms = max(self._straggler_ms, max(0.0, float(excess_ms)))
        self._straggler_rank = int(rank)

    def mark_degraded(self, ranks) -> None:
        """Replace the set of ranks running under a degradation directive
        (``mark_degraded(())`` clears it, e.g. after the guardrail returns
        the gang to bulk sync)."""
        self._degraded_ranks = {int(r) for r in ranks}

    def note_wire(self, measured_wire_ms: float,
                  by_axis: Optional[Dict[str, float]] = None) -> None:
        """A measured per-step wire time (trace analysis ``collective_ms``
        or flight-recorder enqueue→retire deltas).  ``by_axis`` optionally
        splits the measurement by mesh axis (per-axis enqueue→retire
        deltas) — the strongest evidence for the per-axis ledger."""
        self._measured_wire_ms = max(0.0, float(measured_wire_ms))
        if by_axis:
            self._measured_wire_axis_ms = {
                str(k): max(0.0, float(v)) for k, v in by_axis.items()
            }

    # -- pricing helpers ------------------------------------------------------

    @property
    def calibrated(self) -> bool:
        return (self.compute_ms is not None
                or len(self._wall_samples) >= self.calibrate_steps)

    def expected(self) -> Optional[float]:
        """The priced (or calibrated) expected step wall in ms; None while
        still calibrating with nothing priced."""
        if self.compute_ms is not None:
            wire = self.wire_ms or 0.0
            return self.compute_ms + (1.0 - self.overlap_frac) * wire
        if len(self._wall_samples) >= 3:
            return statistics.median(self._wall_samples)
        return None

    def _price_bytes_ms(self, nbytes: float) -> Optional[float]:
        if nbytes <= 0:
            return 0.0
        if self.cost_model is not None:
            return self.cost_model.bucket_wire_time(
                float(nbytes), hierarchical=self.hierarchical,
                wire_pattern=self.wire_pattern) * 1e3
        return None

    def _price_axis_bytes_ms(self, axis: str, nbytes: float) -> Optional[float]:
        if nbytes <= 0:
            return 0.0
        if self.cost_model is not None and hasattr(self.cost_model, "axis_leg"):
            return self.cost_model.axis_leg(axis).predict(float(nbytes)) * 1e3
        return None

    def _split_by_axis_share(self, total: float) -> Dict[str, float]:
        """Partition a scalar slowdown over the priced per-axis expectations,
        proportionally by expected share — the last axis takes the exact
        remainder so the parts sum bitwise to ``total``."""
        axes = sorted(self.axis_wire_ms)
        weight = sum(self.axis_wire_ms[ax] for ax in axes)
        if not axes or weight <= 0:
            return {}
        parts: Dict[str, float] = {}
        assigned = 0.0
        for ax in axes[:-1]:
            part = total * self.axis_wire_ms[ax] / weight
            parts[ax] = part
            assigned += part
        parts[axes[-1]] = total - assigned
        return parts

    def _wire_slowdown_parts(
        self,
        wire_bytes: Optional[float],
        wire_bytes_by_axis: Optional[Dict[str, float]] = None,
    ) -> "tuple[float, Dict[str, float]]":
        """``(wire_slowdown_ms, {axis: ms})`` — the per-axis parts sum to
        the scalar exactly whenever they exist (partition by construction:
        either the scalar is computed as their sum, or the last axis takes
        the remainder of a proportional split).  Axis-blind inputs return
        an empty split and the legacy scalar unchanged."""
        # per-axis measured evidence is the strongest: each axis's overshoot
        # of its own priced promise, the scalar defined as the sum (needs a
        # priced per-axis promise — without one, fall to the scalar path)
        if self._measured_wire_axis_ms is not None and self.axis_wire_ms:
            parts = {
                ax: max(0.0, ms - self.axis_wire_ms.get(ax, 0.0))
                for ax, ms in self._measured_wire_axis_ms.items()
            }
            return sum(parts[ax] for ax in sorted(parts)), parts
        # scalar measured wire beyond the α–β promise wins next; with a
        # priced per-axis ledger the overshoot splits by expected share
        if self._measured_wire_ms is not None and self.wire_ms is not None:
            total = max(0.0, self._measured_wire_ms - self.wire_ms)
            return total, self._split_by_axis_share(total)
        # otherwise, price the byte inflation: census bytes over baseline.
        # Per-axis censuses price each axis's excess on its own leg and the
        # scalar is the sum of the parts.
        if wire_bytes_by_axis:
            parts = {}
            for ax in sorted(wire_bytes_by_axis):
                samples = self._axis_bytes_samples.get(ax)
                if not samples:
                    continue
                baseline = statistics.median(samples)
                excess = float(wire_bytes_by_axis[ax]) - baseline
                if excess <= 0 or baseline <= 0:
                    parts[ax] = 0.0
                    continue
                priced = self._price_axis_bytes_ms(ax, excess)
                if priced is not None:
                    parts[ax] = priced
                elif self.axis_wire_ms.get(ax):
                    parts[ax] = self.axis_wire_ms[ax] * excess / baseline
                else:
                    parts[ax] = 0.0
            if parts:
                return sum(parts[ax] for ax in sorted(parts)), parts
        if wire_bytes is None or not self._bytes_samples:
            return 0.0, {}
        baseline = statistics.median(self._bytes_samples)
        excess = float(wire_bytes) - baseline
        if excess <= 0 or baseline <= 0:
            return 0.0, {}
        priced = self._price_bytes_ms(excess)
        if priced is not None:
            return priced, {}
        if self.wire_ms is not None:
            return self.wire_ms * excess / baseline, {}
        return 0.0, {}

    # -- the per-step settle --------------------------------------------------

    def settle(
        self,
        step: int,
        measured_ms: float,
        host_ms: Optional[float] = None,
        wire_bytes: Optional[float] = None,
        wire_bytes_by_axis: Optional[Dict[str, float]] = None,
    ) -> StepBudget:
        """Close one step: compute the residual against the expected wall
        and partition it.  ``host_ms`` is the step's total host-side
        overhead (the engine's pre + lock-wait + post), ``wire_bytes`` the
        step's bucket-plan census (``wire_bytes_by_axis`` the same census
        split by mesh axis).  Clears the per-step evidence hooks."""
        measured_ms = float(measured_ms)
        clean = (self._compile_ms == 0.0 and self._snapshot_ms == 0.0
                 and self._backpressure_s == 0.0 and self._straggler_ms == 0.0)
        expected = self.expected()
        settled = expected is not None
        if expected is None:
            expected = measured_ms  # still calibrating: residual is zero
        residual = measured_ms - expected

        components = dict.fromkeys(BUDGET_COMPONENTS, 0.0)
        components["compile"] = self._compile_ms
        components["snapshot"] = self._snapshot_ms
        components["backpressure"] = self._backpressure_s * 1e3
        components["straggler"] = self._straggler_ms
        if host_ms is not None and self._host_samples:
            components["host_data"] = max(
                0.0, float(host_ms) - statistics.median(self._host_samples))
        wire_slowdown, wire_axis = self._wire_slowdown_parts(
            wire_bytes, wire_bytes_by_axis)
        components["wire_slowdown"] = wire_slowdown
        named = sum(components[c] for c in BUDGET_COMPONENTS[:-1])
        components["unattributed"] = residual - named

        dominant = ""
        if residual > 0:
            dominant = max(components, key=lambda c: components[c])
        budget = StepBudget(
            step=int(step),
            measured_ms=measured_ms,
            expected_ms=expected,
            residual_ms=residual,
            components=components,
            dominant=dominant,
            calibrated=settled,
            straggler_rank=self._straggler_rank,
            wire_axis_ms=wire_axis,
        )

        # clean steps feed the baselines (bounded: keep the newest window).
        # A step that regressed without named evidence (e.g. inflated wire
        # bytes) must not drag the baseline up after it, so a settled model
        # only admits samples inside a 25% band of the expected wall.
        if clean and settled and measured_ms > expected * 1.25:
            clean = False
        if clean:
            self._wall_samples.append(measured_ms)
            if host_ms is not None:
                self._host_samples.append(float(host_ms))
            if wire_bytes is not None:
                self._bytes_samples.append(float(wire_bytes))
            if wire_bytes_by_axis:
                for ax, nbytes in wire_bytes_by_axis.items():
                    self._axis_bytes_samples.setdefault(str(ax), []).append(
                        float(nbytes))
            cap = max(self.calibrate_steps, 64)
            for samples in (self._wall_samples, self._host_samples,
                            self._bytes_samples,
                            *self._axis_bytes_samples.values()):
                if len(samples) > cap:
                    del samples[: len(samples) - cap]

        self._compile_ms = 0.0
        self._snapshot_ms = 0.0
        self._backpressure_s = 0.0
        self._straggler_ms = 0.0
        self._straggler_rank = -1
        self._measured_wire_ms = None
        self._measured_wire_axis_ms = None
        return budget

    def report(self) -> Dict:
        return {
            "priced": self.compute_ms is not None,
            "compute_ms": self.compute_ms,
            "wire_ms": self.wire_ms,
            "axis_wire_ms": {
                k: round(v, 4) for k, v in sorted(self.axis_wire_ms.items())
            },
            "overlap_frac": self.overlap_frac,
            "expected_ms": self.expected(),
            "calibrated": self.calibrated,
            "calibration_samples": len(self._wall_samples),
        }
