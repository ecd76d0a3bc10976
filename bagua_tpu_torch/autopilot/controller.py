"""The gang autopilot: incident attribution in, cheapest-healthy switches out.

The port of ``bagua_tpu/autopilot/controller.py``, a copy over the port's
engine.  BAGUA's thesis is that {centralized/decentralized, sync/async,
full/low precision} are composable relaxations to pick per workload, not
once at construction.  The autopilot closes the
loop: it consumes the regression sentinel's attributed ``perf_regression``
incidents, the health monitor's stability signal, and the planner's
fitted α–β cost model, and continuously moves the gang to the cheapest
configuration the evidence says is healthy — riding the engine's existing
single-recompile actions (``switch_algorithm`` / ``apply_precision_plan``),
every one statically verified before dispatch.

The decision ladder (evaluated in priority order each :meth:`~GangAutopilot.tick`):

1. **Safety** — the health monitor reset its clean streak (loss spike /
   nonfinite) while the gang runs a quantized wire: re-promote to ``f32``
   immediately (``repromote_precision``, no canary — safety moves don't
   gamble on parity).
2. **Canary adjudication** — a pending switch's probation window ended:
   commit if the post-switch loss EWMA is within ``canary_loss_factor`` of
   the pre-switch EWMA, roll back otherwise.
3. **Demotion** — ≥ ``hysteresis_incidents`` wire-dominant incidents since
   the last action and the knob is off cooldown: price every candidate at
   the incident's measured/expected bandwidth factor and switch to the
   cheapest one that models at least ``min_saving_frac`` below stay-put
   (``demote_precision`` / ``switch_algorithm``), entering a canary.
4. **Re-promotion** — ``stabilized(repromote_windows)`` clean windows, no
   wire incident within the same patience window (quarantine: the collapse
   may still be in progress) and off cooldown: re-price at nominal
   bandwidth; if the gang is no longer on
   the cheapest configuration (the collapse ended), move back — the
   goodput-recovery win a one-way demotion ratchet never collects.  Latched
   health actions are re-armed on the same evidence.

Every decision — including holds and strict-verifier rejections — is
emitted as a schema-validated ``plan_decision`` JSONL event citing the
triggering incident's ``trace_id``, so the telemetry's timeline can join
decision ↔ incident ↔ switch.
"""

import dataclasses
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

from bagua_tpu_torch.autopilot.pricing import (
    Configuration,
    candidate_configurations,
    modeled_step_ms,
    price_configurations,
    wire_ms,
)

logger = logging.getLogger(__name__)

__all__ = ["AutopilotConfig", "GangAutopilot"]


@dataclasses.dataclass
class AutopilotConfig:
    """Policy knobs (production-shaped defaults: hysteresis, cooldown,
    canary probation, explicit re-promotion patience)."""

    #: steps a knob stays untouchable after any committed/rolled-back action
    cooldown_steps: int = 50
    #: wire-dominant incidents required before a demotion is considered
    hysteresis_incidents: int = 2
    #: probation steps between an applied switch and its commit/rollback
    canary_steps: int = 8
    #: post-switch loss EWMA must stay within this factor of the pre-switch
    #: EWMA for the canary to commit
    canary_loss_factor: float = 1.25
    #: clean health windows required before re-promotion is considered
    repromote_windows: int = 20
    #: a candidate must model at least this fraction below stay-put
    min_saving_frac: float = 0.05
    #: the precision rungs the controller may move over
    precisions: Tuple[str, ...] = ("f32", "int8")
    #: the algorithm relaxations the controller may move over
    algorithms: Tuple[str, ...] = ("gradient_allreduce", "zero")
    #: loss EWMA smoothing for the canary parity check
    loss_ewma_alpha: float = 0.2
    #: modeled compute milliseconds per step; None reads the sentinel's
    #: self-calibrated budget model
    compute_ms: Optional[float] = None


class GangAutopilot:
    """One controller per gang, driven once per step from the train loop.

    Args:
        ddp: the :class:`~bagua_tpu_torch.ddp.DistributedDataParallel` engine
            (constructed with ``wire_precision="auto"`` if the precision
            knob should participate).
        cost_model: the planner's fitted
            :class:`~bagua_tpu_torch.service.planner.CostModel`.
        config: :class:`AutopilotConfig`.
        sentinel: the gang's
            :class:`~bagua_tpu_torch.observability.regression.RegressionSentinel`
            — incidents are read non-destructively, so the fleet push's
            ``drain_incidents()`` is untouched.
        health: the gang's
            :class:`~bagua_tpu_torch.observability.health.HealthMonitor`.
        telemetry: optional hub for ``plan_decision`` events.
    """

    def __init__(self, ddp, cost_model, config: Optional[AutopilotConfig] = None,
                 sentinel=None, health=None, telemetry=None):
        self.ddp = ddp
        self.cost_model = cost_model
        self.config = config or AutopilotConfig()
        self.sentinel = sentinel
        self.health = health
        self.telemetry = telemetry
        #: every decision this controller took (dicts in plan_decision shape)
        #: — the fleet gang aggregator pushes these to the control plane
        self.decisions: List[Dict] = []
        self._pending_decisions: List[Dict] = []
        self._seen_incidents = 0
        self._wire_evidence: List[Dict] = []
        self._last_incident_trace = ""
        self._last_wire_step: Optional[int] = None
        self._cooldown_until = {"algorithm": -1, "precision": -1, "staleness": -1}
        self._canary: Optional[Dict] = None
        self._loss_ewma: Optional[float] = None
        #: count of strict-verifier rejections the controller absorbed (the
        #: CI lane asserts this stays 0 — rejected programs never dispatch)
        self.verifier_rejections = 0

    # -- introspection -------------------------------------------------------

    def current_configuration(self) -> Configuration:
        algo = self.ddp.impl.algo_name or type(self.ddp.impl).__name__
        precision = "f32"
        if self.ddp.plan is not None and hasattr(self.ddp.impl, "bucket_precisions"):
            precs = self.ddp.impl.bucket_precisions(self.ddp.plan)
            if precs:
                # the controller moves all buckets together; rank the gang by
                # its cheapest (lowest-precision) rung
                order = {"int4": 0, "int8": 1, "f32": 2}
                precision = min(precs, key=lambda p: order.get(str(p), 2))
        tau = getattr(self.ddp.impl, "staleness_tau", None) or 0
        return Configuration(
            algorithm=algo, precision=str(precision), staleness=int(tau)
        )

    def report(self) -> Dict:
        return {
            "configuration": self.current_configuration().as_dict(),
            "decisions": len(self.decisions),
            "canary_active": self._canary is not None,
            "verifier_rejections": self.verifier_rejections,
            "wire_evidence": len(self._wire_evidence),
            "last_decision": self.decisions[-1] if self.decisions else None,
        }

    def drain_decisions(self) -> List[Dict]:
        """Decisions since the last drain — what the gang aggregator pushes
        (best-effort) to the fleet control plane's decision tier."""
        out, self._pending_decisions = self._pending_decisions, []
        return out

    # -- the per-step entry point -------------------------------------------

    def tick(self, state, step: int, loss: Optional[float] = None):
        """Run the decision ladder once; returns the (possibly remapped)
        train state.  Call after ``train_step`` with the step's mean loss."""
        if loss is not None:
            a = self.config.loss_ewma_alpha
            self._loss_ewma = (
                float(loss) if self._loss_ewma is None
                else (1 - a) * self._loss_ewma + a * float(loss)
            )
        self._ingest_incidents()

        out = self._safety_repromote(state, step)
        if out is not None:
            return out
        out = self._adjudicate_canary(state, step)
        if out is not None:
            return out
        if self._canary is not None:
            return state  # probation: no new moves while a canary runs
        out = self._demote_on_wire_evidence(state, step)
        if out is not None:
            return out
        out = self._repromote_on_stability(state, step)
        if out is not None:
            return out
        return state

    # -- evidence ------------------------------------------------------------

    def _ingest_incidents(self) -> None:
        if self.sentinel is None:
            return
        new = self.sentinel.incidents[self._seen_incidents:]
        self._seen_incidents = len(self.sentinel.incidents)
        for inc in new:
            if inc.get("dominant") == "wire_slowdown":
                self._wire_evidence.append(inc)
                self._last_wire_step = int(inc.get("step", 0))
            if inc.get("trace_id"):
                self._last_incident_trace = str(inc["trace_id"])

    def _bandwidth_factor(self, incident: Dict) -> float:
        """The operating point candidates are priced at: how much slower the
        measured step ran than the budget's expectation.  The incident is
        wire-dominant, so the whole overshoot is charged to bandwidth."""
        expected = float(incident.get("expected_ms") or 0.0)
        measured = float(incident.get("measured_ms") or 0.0)
        if expected <= 0.0:
            return 1.0
        return max(1.0, measured / expected)

    def _compute_ms(self) -> float:
        if self.config.compute_ms is not None:
            return float(self.config.compute_ms)
        budget = getattr(self.sentinel, "budget", None)
        return float(getattr(budget, "compute_ms", 0.0) or 0.0)

    def _healthy(self, n_windows: int = 1) -> bool:
        return self.health is None or self.health.stabilized(n_windows)

    def _off_cooldown(self, step: int, knobs: Tuple[str, ...]) -> bool:
        return all(step >= self._cooldown_until[k] for k in knobs)

    def _start_cooldown(self, step: int, knobs: Tuple[str, ...]) -> None:
        for k in knobs:
            self._cooldown_until[k] = step + self.config.cooldown_steps

    @staticmethod
    def _knobs(frm: Configuration, to: Configuration) -> Tuple[str, ...]:
        knobs = []
        if frm.algorithm != to.algorithm:
            knobs.append("algorithm")
        if frm.precision != to.precision:
            knobs.append("precision")
        if frm.staleness != to.staleness:
            knobs.append("staleness")
        return tuple(knobs) or ("precision",)

    # -- ladder rungs ---------------------------------------------------------

    def _safety_repromote(self, state, step: int):
        cur = self.current_configuration()
        if cur.precision == "f32" or self.health is None:
            return None
        if self.health.stabilized(1):
            return None
        if not self._off_cooldown(step, ("precision",)):
            return None
        to = dataclasses.replace(cur, precision="f32")
        try:
            state = self._apply(state, cur, to, "autopilot:loss_spike")
        except Exception as e:
            self._record(step, "repromote_precision", "autopilot:loss_spike",
                         cur, to, "rejected", error=e)
            return state
        self._start_cooldown(step, ("precision",))
        self._record(step, "repromote_precision", "autopilot:loss_spike",
                     cur, to, "committed")
        return state

    def _adjudicate_canary(self, state, step: int):
        c = self._canary
        if c is None or step < c["until_step"]:
            return None
        self._canary = None
        pre = c["pre_ewma"]
        post = self._loss_ewma
        parity = (
            pre is None or post is None
            or post <= pre * self.config.canary_loss_factor
        )
        frm = Configuration(**c["from_config"])
        to = Configuration(**c["to_config"])
        if parity:
            self._record(step, c["decision"], c["reason"], frm, to,
                         "committed", modeled=c.get("modeled"),
                         axis=c.get("axis"))
            return state
        try:
            state = self._apply(state, to, frm, c["reason"])
        except Exception as e:
            self._record(step, "rollback", c["reason"], to, frm, "rejected",
                         error=e, axis=c.get("axis"))
            return state
        self._start_cooldown(step, self._knobs(frm, to))
        self._record(step, "rollback", c["reason"], to, frm, "rolled_back",
                     modeled=c.get("modeled"), axis=c.get("axis"))
        return state

    def _demote_on_wire_evidence(self, state, step: int):
        cfg = self.config
        if len(self._wire_evidence) < cfg.hysteresis_incidents:
            return None
        incident = self._wire_evidence[-1]
        self._wire_evidence = []
        if not self._healthy(1):
            return None  # never chase goodput while the loss is misbehaving
        cur = self.current_configuration()
        factor = self._bandwidth_factor(incident)
        # axis-scoped pricing: an incident that indicts a named mesh axis
        # degrades only that axis's traffic.  When the indicted axis is not
        # one the gradient exchange rides (group.data_axes), the candidate
        # ranking cannot flip and the controller holds — demoting the dp
        # wire precision does nothing for a tp/NVLink brownout.
        axis = incident.get("axis")
        axis = str(axis) if axis else None
        exchange_axes = tuple(
            str(a) for a in (getattr(self.ddp.group, "data_axes", ()) or ()) if a
        )
        candidates = candidate_configurations(cfg.algorithms, cfg.precisions)
        if cur not in candidates:
            candidates.append(cur)
        candidates = [
            c for c in candidates
            if self._off_cooldown(step, self._knobs(cur, c)) or c == cur
        ]
        priced = price_configurations(
            self.cost_model, self.ddp.plan, self.ddp.group.exchange_size,
            candidates, self._compute_ms(),
            hierarchical=bool(getattr(self.ddp.impl, "hierarchical", False)),
            bandwidth_factor=factor,
            axis=axis, exchange_axes=exchange_axes,
        )
        stay = next(ms for c, ms in priced if c == cur)
        best, best_ms = priced[0]
        reason = f"autopilot:{incident.get('dominant', 'wire_slowdown')}"
        trace = str(incident.get("trace_id") or "")
        modeled = {
            "stay_ms": stay, "chosen_ms": best_ms, "bandwidth_factor": factor,
        }
        if best == cur or best_ms > stay * (1.0 - cfg.min_saving_frac):
            self._record(step, "hold", reason, cur, cur, "held",
                         trace_id=trace, modeled=modeled, axis=axis)
            return state
        decision = (
            "switch_algorithm" if best.algorithm != cur.algorithm
            else "demote_precision"
        )
        try:
            state = self._apply(state, cur, best, reason)
        except Exception as e:
            self._record(step, decision, reason, cur, best, "rejected",
                         trace_id=trace, modeled=modeled, error=e, axis=axis)
            return state
        self._start_canary(step, decision, reason, cur, best, trace, modeled,
                           axis=axis)
        return state

    def _repromote_on_stability(self, state, step: int):
        cfg = self.config
        if self.health is None or not self.health.stabilized(cfg.repromote_windows):
            return None
        if (self._last_wire_step is not None
                and step - self._last_wire_step < cfg.repromote_windows):
            return None  # quarantine: the collapse may still be in progress
        self.health.rearm()  # latched guardrail actions may fire again
        cur = self.current_configuration()
        candidates = candidate_configurations(cfg.algorithms, cfg.precisions)
        if cur not in candidates:
            candidates.append(cur)
        candidates = [
            c for c in candidates
            if self._off_cooldown(step, self._knobs(cur, c)) or c == cur
        ]
        priced = price_configurations(
            self.cost_model, self.ddp.plan, self.ddp.group.exchange_size,
            candidates, self._compute_ms(),
            hierarchical=bool(getattr(self.ddp.impl, "hierarchical", False)),
            bandwidth_factor=1.0,  # stabilized: price at nominal bandwidth
        )
        stay = next(ms for c, ms in priced if c == cur)
        best, best_ms = priced[0]
        if best == cur or best_ms > stay * (1.0 - cfg.min_saving_frac):
            return None  # already cheapest at nominal bandwidth: quiet
        decision = (
            "switch_algorithm" if best.algorithm != cur.algorithm
            else ("repromote_precision"
                  if best.precision == "f32" else "demote_precision")
        )
        reason = "autopilot:stabilized"
        modeled = {"stay_ms": stay, "chosen_ms": best_ms, "bandwidth_factor": 1.0}
        try:
            state = self._apply(state, cur, best, reason)
        except Exception as e:
            self._record(step, decision, reason, cur, best, "rejected",
                         modeled=modeled, error=e)
            return state
        self._start_canary(step, decision, reason, cur, best,
                           self._last_incident_trace, modeled)
        return state

    # -- actions ---------------------------------------------------------------

    def _apply(self, state, frm: Configuration, to: Configuration, reason: str):
        """Move the engine to ``to`` (algorithm first — it resets the plan —
        then the per-bucket precision).  A strict-verifier rejection raises
        out of here having already rolled the engine back; callers count it
        and never dispatch the rejected program."""
        ddp = self.ddp
        try:
            if to.algorithm != frm.algorithm:
                kwargs = {}
                if to.algorithm in ("gradient_allreduce", "zero"):
                    # keep the per-bucket precision knob live across the switch
                    auto = getattr(ddp.impl, "wire_precision", None) == "auto"
                    kwargs["wire_precision"] = "auto" if auto else "f32"
                state = ddp.switch_algorithm(state, to.algorithm, reason=reason,
                                             **kwargs)
            cur_prec = self.current_configuration().precision
            if to.precision != cur_prec and hasattr(ddp.impl, "set_bucket_precision"):
                ddp.apply_precision_plan(
                    [to.precision] * ddp.plan.num_buckets, reason=reason
                )
        except Exception:
            self.verifier_rejections += 1
            raise
        if self.sentinel is not None:
            self.sentinel.plan_version = ddp.plan_version
            if hasattr(self.sentinel, "rebaseline"):
                # the step wall legitimately moved: re-learn the CUSUM
                # baseline and re-price the budget's wire expectation to
                # the adopted configuration's modeled wire at nominal
                # bandwidth
                self.sentinel.rebaseline(wire_ms=wire_ms(
                    self.cost_model, ddp.plan, ddp.group.exchange_size, to,
                    hierarchical=bool(getattr(ddp.impl, "hierarchical", False)),
                ))
        return state

    def _start_canary(self, step, decision, reason, frm, to, trace, modeled,
                      axis: Optional[str] = None):
        self._canary = {
            "until_step": step + self.config.canary_steps,
            "pre_ewma": self._loss_ewma,
            "from_config": frm.as_dict(),
            "to_config": to.as_dict(),
            "decision": decision,
            "reason": reason,
            "trace_id": trace,
            "modeled": modeled,
            "axis": axis,
        }
        self._start_cooldown(step, self._knobs(frm, to))
        self._record(step, decision, reason, frm, to, "canary",
                     trace_id=trace, modeled=modeled, axis=axis)

    def _record(self, step, decision, reason, frm, to, verdict,
                trace_id: Optional[str] = None, modeled: Optional[Dict] = None,
                error: Optional[BaseException] = None,
                axis: Optional[str] = None) -> None:
        if trace_id is None:
            trace_id = (self._canary or {}).get("trace_id") or self._last_incident_trace
        row = {
            "event": "plan_decision",
            "ts": time.time(),
            "step": int(step),
            "decision": str(decision),
            "reason": str(reason),
            "trace_id": str(trace_id or ""),
            "plan_version": int(self.ddp.plan_version),
            "from_config": frm.as_dict(),
            "to_config": to.as_dict(),
            "verdict": str(verdict),
        }
        if axis:
            row["axis"] = str(axis)
        if modeled:
            row["modeled"] = {k: round(float(v), 4) for k, v in modeled.items()}
        if error is not None:
            logger.warning(
                "autopilot %s %s -> %s rejected before dispatch: %s",
                decision, frm.label(), to.label(), error,
            )
        else:
            logger.info(
                "autopilot %s (%s): %s -> %s [%s]",
                decision, reason, frm.label(), to.label(), verdict,
            )
        self.decisions.append(row)
        self._pending_decisions.append(row)
        if self.telemetry is not None:
            self.telemetry.on_plan_decision(
                step=int(step), decision=str(decision), reason=str(reason),
                trace_id=str(trace_id or ""), plan_version=int(self.ddp.plan_version),
                from_config=frm.as_dict(), to_config=to.as_dict(),
                verdict=str(verdict), modeled=modeled, axis=axis,
            )
