"""The staleness director: straggler attribution in, bounded-staleness out.

The port of ``bagua_tpu/autopilot/staleness.py``, a copy.  The gang
autopilot (:mod:`~bagua_tpu_torch.autopilot.controller`) moves the *collective* knobs — algorithm and
wire precision — on wire-dominant evidence.  A straggler is a different
failure: one rank is slow, the wire is fine, and demoting everyone's
precision buys nothing.  The correct relaxation is *per-rank*: let the
indicted rank fall up to τ rounds behind (the ``stale`` algorithm's
error-feedback replay, or the gossip decentralized mode's published-weight
skip) so the gang paces at its median instead of the straggler's max.

:class:`StalenessDirector` closes that loop with the same production
discipline as the autopilot's decision ladder:

* **Evidence** — the regression sentinel's ``perf_regression`` incidents
  whose ``dominant`` component is ``straggler`` (the gang aggregator's
  attributed excess, carrying the indicted ``straggler_rank`` and the
  incident ``trace_id``).
* **Hysteresis + cooldown** — ≥ ``hysteresis_incidents`` straggler
  incidents before a degrade, ``cooldown_steps`` between staleness moves.
* **Degrade** — one recompile-free directive flip
  (:meth:`~bagua_tpu_torch.ddp.DistributedDataParallel.apply_degradation_directive`)
  plus, when the engine is still at τ=0, one single-recompile
  :meth:`~bagua_tpu_torch.ddp.DistributedDataParallel.apply_staleness` switch.
  The budget model is told the gang now paces at the median
  (``sentinel.mark_degraded``) so the degraded rank's excess stops
  re-tripping the very detector that indicted it.
* **Convergence guardrail** — :class:`StalenessTightenAction` registered
  on the :class:`~bagua_tpu_torch.observability.health.HealthMonitor` snaps τ
  back to 0 on a loss spike / grad explosion (safety moves don't wait for
  a tick).  The director notices the tightened knob and only re-promotes
  staleness after ``repromote_windows`` clean health windows — the same
  stabilization arc as the precision re-promotion.
* **Heal** — no straggler evidence for ``heal_patience`` steps: restore
  bulk sync (τ=0, directive cleared, budget back to worst-rank pacing).

Every move — including holds — is a schema-valid ``plan_decision`` event
citing the triggering incident's ``trace_id`` and indicted rank, so the
fleet timeline joins decision ↔ incident exactly as it does for the
autopilot's switches.
"""

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Tuple

from bagua_tpu_torch.autopilot.pricing import Configuration, modeled_step_ms

logger = logging.getLogger(__name__)

__all__ = ["StalenessConfig", "StalenessDirector", "StalenessTightenAction"]


@dataclasses.dataclass
class StalenessConfig:
    """Policy knobs for the per-rank degradation loop."""

    #: the staleness bound a degrade moves the gang to (0 disables degrades)
    tau: int = 2
    #: straggler-dominant incidents required before a degrade is considered
    hysteresis_incidents: int = 2
    #: steps the staleness knob stays untouchable after any move
    cooldown_steps: int = 50
    #: clean health windows before a guardrail-tightened τ is re-promoted
    repromote_windows: int = 20
    #: steps without fresh straggler evidence before the degradation heals
    heal_patience: int = 100


class StalenessDirector:
    """One director per gang, driven once per step from the train loop.

    Args:
        ddp: the engine, running an algorithm with the ``set_staleness_tau``
            knob (``stale`` or the gossip ``decentralized`` mode).
        config: :class:`StalenessConfig`.
        sentinel: the gang's
            :class:`~bagua_tpu_torch.observability.regression.RegressionSentinel`
            (incidents read non-destructively, like the autopilot).
        health: the gang's
            :class:`~bagua_tpu_torch.observability.health.HealthMonitor`.
        telemetry: optional hub for ``plan_decision`` events.
        cost_model: optional fitted planner cost model — when present,
            degrade decisions carry a ``modeled`` block pricing bulk sync
            vs the staleness candidate at the incident's measured excess.
    """

    def __init__(self, ddp, config: Optional[StalenessConfig] = None,
                 sentinel=None, health=None, telemetry=None, cost_model=None):
        self.ddp = ddp
        self.config = config or StalenessConfig()
        self.sentinel = sentinel
        self.health = health
        self.telemetry = telemetry
        self.cost_model = cost_model
        self.decisions: List[Dict] = []
        self._pending_decisions: List[Dict] = []
        self._seen_incidents = 0
        self._straggler_evidence: List[Dict] = []
        self._last_straggler_step: Optional[int] = None
        self._last_trace = ""
        self._cooldown_until = -1
        #: ranks currently under a degradation directive
        self.degraded_ranks: Tuple[int, ...] = ()
        #: True while the guardrail holds τ at 0 under an open degradation
        self._tightened = False

    # -- introspection -------------------------------------------------------

    def current_tau(self) -> int:
        return int(getattr(self.ddp.impl, "staleness_tau", None) or 0)

    def _configuration(self, tau: Optional[int] = None) -> Configuration:
        algo = self.ddp.impl.algo_name or type(self.ddp.impl).__name__
        return Configuration(
            algorithm=algo, precision="f32",
            staleness=self.current_tau() if tau is None else int(tau),
        )

    def report(self) -> Dict:
        return {
            "tau": self.current_tau(),
            "degraded_ranks": list(self.degraded_ranks),
            "tightened": self._tightened,
            "decisions": len(self.decisions),
            "straggler_evidence": len(self._straggler_evidence),
            "last_decision": self.decisions[-1] if self.decisions else None,
        }

    def drain_decisions(self) -> List[Dict]:
        """Decisions since the last drain — the gang aggregator pushes these
        to the fleet control plane's decision tier beside the autopilot's."""
        out, self._pending_decisions = self._pending_decisions, []
        return out

    # -- the per-step entry point -------------------------------------------

    def tick(self, state, step: int):
        """Run the degradation ladder once; returns the (possibly updated)
        train state.  Call after ``train_step``."""
        self._ingest_incidents()
        if (self.degraded_ranks and not self._tightened
                and self.current_tau() == 0
                and self.health is not None
                and not self.health.stabilized(1)):
            # a registered StalenessTightenAction snapped τ to 0 outside our
            # ladder — adopt the tightened state so re-promotion can run
            self._tightened = True
            self._cooldown_until = max(
                self._cooldown_until, step + self.config.cooldown_steps
            )
        out = self._tighten_on_anomaly(state, step)
        if out is not None:
            return out
        out = self._repromote_after_guardrail(state, step)
        if out is not None:
            return out
        out = self._heal(state, step)
        if out is not None:
            return out
        out = self._degrade_on_straggler(state, step)
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
            if inc.get("dominant") != "straggler":
                continue
            if int(inc.get("straggler_rank", -1)) < 0:
                continue
            self._straggler_evidence.append(inc)
            self._last_straggler_step = int(inc.get("step", 0))
            if inc.get("trace_id"):
                self._last_trace = str(inc["trace_id"])

    def _modeled(self, incident: Dict, tau: int) -> Optional[Dict]:
        """Price bulk sync vs the τ candidate at the incident's measured
        per-step straggler excess (the gang pays ``excess/(τ+1)`` once the
        indicted rank may skip τ consecutive rounds)."""
        if self.cost_model is None or self.ddp.plan is None:
            return None
        excess = float(
            (incident.get("components") or {}).get("straggler", 0.0)
        )
        budget = getattr(self.sentinel, "budget", None)
        compute = float(getattr(budget, "compute_ms", 0.0) or 0.0)
        kwargs = dict(
            hierarchical=bool(getattr(self.ddp.impl, "hierarchical", False)),
            straggler_excess_ms=excess,
        )
        stay = modeled_step_ms(
            self.cost_model, self.ddp.plan, self.ddp.group.exchange_size,
            self._configuration(tau=0), compute, **kwargs,
        )
        chosen = modeled_step_ms(
            self.cost_model, self.ddp.plan, self.ddp.group.exchange_size,
            self._configuration(tau=tau), compute, **kwargs,
        )
        return {
            "stay_ms": stay,
            "chosen_ms": chosen,
            "straggler_excess_ms": excess,
        }

    # -- ladder rungs ---------------------------------------------------------

    def _tighten_on_anomaly(self, state, step: int):
        """Belt-and-braces mirror of :class:`StalenessTightenAction`: if the
        health monitor's clean streak broke while τ > 0, snap it to 0 now —
        even when the action was never registered."""
        if self.health is None or self.current_tau() == 0:
            return None
        if self.health.stabilized(1):
            return None
        frm = self._configuration()
        to = self._configuration(tau=0)
        reason = "health:anomaly"
        try:
            self.ddp.apply_staleness(0, reason=reason)
        except (AttributeError, ValueError) as e:
            self._record(step, "tighten_staleness", reason, frm, to,
                         "rejected", error=e)
            return state
        self._tightened = bool(self.degraded_ranks)
        self._cooldown_until = step + self.config.cooldown_steps
        self._record(step, "tighten_staleness", reason, frm, to, "committed")
        return state

    def _repromote_after_guardrail(self, state, step: int):
        """The guardrail held τ at 0; after ``repromote_windows`` clean
        windows the degradation (still evidenced) gets its staleness back —
        the same stabilization arc as the precision re-promotion."""
        if not self._tightened or self.current_tau() != 0:
            return None
        if self.health is None or not self.health.stabilized(
            self.config.repromote_windows
        ):
            return None
        if step < self._cooldown_until:
            return None
        self.health.rearm()
        frm = self._configuration()
        to = self._configuration(tau=self.config.tau)
        reason = "autopilot:stabilized"
        try:
            self.ddp.apply_staleness(self.config.tau, reason=reason)
            # replay state froze during the τ=0 stretch: force every
            # directive-carrying rank to a fresh first round
            state = self.ddp.reset_staleness_state(state)
        except (AttributeError, ValueError) as e:
            self._record(step, "repromote_staleness", reason, frm, to,
                         "rejected", error=e)
            return state
        self._tightened = False
        self._cooldown_until = step + self.config.cooldown_steps
        self._record(step, "repromote_staleness", reason, frm, to, "committed")
        return state

    def _heal(self, state, step: int):
        """No fresh straggler evidence for ``heal_patience`` steps: the
        straggler healed — restore bulk sync end to end."""
        if not self.degraded_ranks:
            return None
        if (self._last_straggler_step is not None
                and step - self._last_straggler_step < self.config.heal_patience):
            return None
        frm = self._configuration()
        to = self._configuration(tau=0)
        reason = "autopilot:straggler_healed"
        try:
            if self.current_tau() != 0:
                self.ddp.apply_staleness(0, reason=reason)
            state = self.ddp.apply_degradation_directive(state, ())
        except (AttributeError, ValueError) as e:
            self._record(step, "restore_bulk_sync", reason, frm, to,
                         "rejected", error=e)
            return state
        if self.sentinel is not None and hasattr(self.sentinel, "mark_degraded"):
            self.sentinel.mark_degraded(())
        healed = self.degraded_ranks
        self.degraded_ranks = ()
        self._tightened = False
        self._straggler_evidence = []
        self._cooldown_until = step + self.config.cooldown_steps
        self._record(step, "restore_bulk_sync", reason, frm, to, "committed",
                     ranks=healed)
        return state

    def _degrade_on_straggler(self, state, step: int):
        cfg = self.config
        if cfg.tau <= 0:
            return None
        if len(self._straggler_evidence) < cfg.hysteresis_incidents:
            return None
        incident = self._straggler_evidence[-1]
        self._straggler_evidence = []
        rank = int(incident.get("straggler_rank", -1))
        trace = str(incident.get("trace_id") or "")
        if rank < 0:
            return None
        if step < self._cooldown_until:
            return None
        frm = self._configuration()
        to = self._configuration(tau=cfg.tau)
        reason = "autopilot:straggler"
        if self.health is not None and not self.health.stabilized(1):
            # never relax convergence while the loss is already misbehaving
            self._record(step, "hold", reason, frm, frm, "held",
                         trace_id=trace, ranks=(rank,))
            return state
        if rank in self.degraded_ranks and self.current_tau() >= cfg.tau:
            self._record(step, "hold", reason, frm, frm, "held",
                         trace_id=trace, ranks=(rank,))
            return state
        modeled = self._modeled(incident, cfg.tau)
        try:
            if self.current_tau() < cfg.tau:
                self.ddp.apply_staleness(cfg.tau, reason=reason)
                # don't resume replay from frozen (or init-zero) payloads:
                # the first degraded round must be a fresh contribution
                state = self.ddp.reset_staleness_state(state)
            ranks = tuple(sorted(set(self.degraded_ranks) | {rank}))
            state = self.ddp.apply_degradation_directive(state, ranks)
        except (AttributeError, ValueError) as e:
            self._record(step, "degrade_staleness", reason, frm, to,
                         "rejected", trace_id=trace, ranks=(rank,), error=e)
            return state
        self.degraded_ranks = ranks
        if self.sentinel is not None and hasattr(self.sentinel, "mark_degraded"):
            # the gang now paces at its median: stop charging the degraded
            # rank's excess to the budget (it would re-trip the detector)
            self.sentinel.mark_degraded(ranks)
        self._cooldown_until = step + cfg.cooldown_steps
        self._record(step, "degrade_staleness", reason, frm, to, "committed",
                     trace_id=trace, ranks=ranks, modeled=modeled)
        return state

    # -- the decision record ---------------------------------------------------

    def _record(self, step, decision, reason, frm: Configuration,
                to: Configuration, verdict, trace_id: Optional[str] = None,
                ranks: Tuple[int, ...] = (), modeled: Optional[Dict] = None,
                error: Optional[BaseException] = None) -> None:
        if trace_id is None:
            trace_id = self._last_trace
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
        if ranks:
            row["ranks"] = [int(r) for r in ranks]
        if modeled:
            row["modeled"] = {k: round(float(v), 4) for k, v in modeled.items()}
        if error is not None:
            logger.warning(
                "staleness director %s %s -> %s rejected before dispatch: %s",
                decision, frm.label(), to.label(), error,
            )
        else:
            logger.info(
                "staleness director %s (%s): %s -> %s [%s]",
                decision, reason, frm.label(), to.label(), verdict,
            )
        self.decisions.append(row)
        self._pending_decisions.append(row)
        if self.telemetry is not None:
            self.telemetry.on_plan_decision(
                step=int(step), decision=str(decision), reason=str(reason),
                trace_id=str(trace_id or ""),
                plan_version=int(self.ddp.plan_version),
                from_config=frm.as_dict(), to_config=to.as_dict(),
                verdict=str(verdict), modeled=modeled,
            )


class StalenessTightenAction:
    """Health-monitor action snapping the staleness budget back to τ=0 on
    any anomaly — the convergence guardrail of the bounded-staleness modes.
    The divergence bound τ buys goodput only while the loss behaves; a
    loss spike / grad explosion means the slack is being *spent*, so the
    gang returns to bulk synchronous immediately (one verified recompile)
    and only re-earns its staleness through the director's
    stabilization arc.  No-op (returns False) when the algorithm has no
    staleness knob or is already at τ=0."""

    name = "staleness_tighten"

    def __init__(self, ddp):
        self.ddp = ddp

    def __call__(self, alert: Dict, state=None) -> bool:
        ddp = self.ddp
        if not int(getattr(ddp.impl, "staleness_tau", None) or 0):
            return False
        try:
            return bool(ddp.apply_staleness(
                0, reason=f"health:{alert.get('kind', 'anomaly')}"))
        except (AttributeError, ValueError) as e:
            logger.debug("staleness tighten not applicable: %s", e)
            return False
