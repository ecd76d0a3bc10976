"""Fleet remediation engine: the verdict ladder starts *acting*.

The control plane holds the evidence chain — per-gang verdicts, a
structured incident tier carrying ``plan_version`` + ``trace_id``, pushed
flight digests; without this module every fleet-level remediation is
manual.  This module
closes the loop with three arcs, all driven by one deterministic
:meth:`RemediationEngine.sweep` over the control plane's existing views:

* **Quarantine + rollback** — a cached plan whose *adopters* (journaled by
  ``plan_get`` with a gang identity) report ``regressed`` verdicts with
  incidents naming that exact ``plan_version`` is quarantined in the
  cross-gang cache (never served again) and rolled back fleet-wide: every
  adopter gets a durable ``rollback_plan`` directive.  The correlation is
  *exact* — incident ``plan_version`` must equal the adopted version — so
  a healthy plan can never be quarantined by a neighbor's noise (the
  zero-false-quarantine property the scale lane asserts).  The emitted
  ``plan_quarantine`` event cites the indicting incidents' trace_ids.
* **Hang diagnosis + directed resize** — a ``wedged`` gang's pushed flight
  digests (each carrying a ``tail`` of full records) are synthesized into
  pseudo-dumps and joined through the same first-desync logic as
  ``ci/diagnose_hang.py`` (:func:`build_hang_report`).  On a ``desync`` or
  ``host_wedge`` verdict the gang gets a durable ``resize`` directive with
  a target world size — consumed by the elastic-resume path
  (``ElasticResumeCoordinator.directed_world_size``).
* **Canary graduation** — a freshly published plan starts in ``canary``
  status: only the first ``canary_n`` requesting gangs receive it.  Each
  sweep records a clean window for every canary adopter currently judged
  ``healthy``; at ``canary_n`` clean adopters the plan graduates to
  ``default`` and is served fleet-wide.

Every action lands in the control plane's durable remediation tier (WAL
ops ``adopt``/``quarantine``/``canary``/``plan_status``/``directive``), so
a SIGKILL'd server replays to the same remediation state bitwise.  The
sweep itself is stateless and idempotent: re-running it against the same
views issues nothing new.

The engine works identically against a single :class:`FleetControlPlane`
or the sharded facade (:class:`bagua_tpu_torch.fleet.shards.ShardedControlPlane`)
— it only speaks the fan-out/merge view API.
"""

import logging
import time
from typing import Dict, List, Optional

from bagua_tpu_torch.observability.flight_recorder import build_hang_report
from bagua_tpu_torch.observability.metrics import validate_metrics_event

logger = logging.getLogger("bagua_tpu_torch.fleet")

__all__ = ["RemediationEngine"]

#: hang verdicts that warrant a directed resize (a ``straggler`` verdict is
#: left to the gang's own StalenessDirector — the fleet does not resize a
#: gang for being slow)
RESIZE_VERDICTS = ("desync", "host_wedge")


def _pseudo_dump(digest: dict) -> dict:
    """A pushed flight digest, reshaped into the per-rank dump structure
    ``build_hang_report`` joins (the digest's ``tail`` stands in for the
    full ring)."""
    return {
        "rank": int(digest.get("rank", -1)),
        "last_seq": int(digest.get("last_seq", -1)),
        "records": [dict(r) for r in (digest.get("tail") or [])
                    if isinstance(r, dict)],
        "telemetry": {},
        "mono_at_dump": digest.get("mono"),
        "reason": "fleet_digest",
    }


class RemediationEngine:
    """One sweep of verdict-driven fleet remediation.

    Args:
        plane: a :class:`~bagua_tpu_torch.fleet.control_plane.FleetControlPlane`
            or the sharded facade — anything speaking the view/remediation
            API (``scheduler_view``/``plan_statuses``/``incidents``/
            ``flight_digests``/``mark_plan_quarantined``/
            ``issue_directive``/``record_canary_clean``/``ingest_spans``).
        quarantine_threshold: distinct regressed adopter gangs (with
            version-matched incidents) required to quarantine a plan.
        sink: optional :class:`~bagua_tpu_torch.observability.metrics.JsonlSink`
            receiving every emitted event (schema-validated).
        clock: wall-clock source for event timestamps.
    """

    def __init__(
        self,
        plane,
        quarantine_threshold: int = 1,
        sink=None,
        clock=time.time,
    ):
        self.plane = plane
        self.quarantine_threshold = max(1, int(quarantine_threshold))
        self.sink = sink
        self.clock = clock

    # -- event plumbing -------------------------------------------------------

    def _emit(self, gangs: List[str], event: dict, events: List[dict]) -> None:
        """Validate one remediation event, append it to the sweep's event
        list, push it into each named gang's timeline ring, and tee it to
        the sink.  A schema problem is a bug at this emit site — raise."""
        problems = validate_metrics_event(event)
        if problems:
            raise ValueError(f"invalid remediation event {event!r}: {problems}")
        events.append(event)
        for gang in gangs:
            try:
                self.plane.ingest_spans(gang, [], events=[dict(event)])
            except Exception:
                logger.exception("remediation event push failed (gang %r)", gang)
        if self.sink is not None:
            self.sink.emit(dict(event))

    # -- the sweep ------------------------------------------------------------

    def sweep(self) -> dict:
        view = self.plane.scheduler_view()
        gangs_view: Dict[str, dict] = view.get("gangs", {})
        statuses = self.plane.plan_statuses()
        events: List[dict] = []
        summary = {
            "checked_plans": len(statuses),
            "checked_gangs": len(gangs_view),
            "quarantined": [],
            "rollbacks": [],
            "resized": [],
            "clean": [],
            "graduated": [],
        }
        self._sweep_quarantine(gangs_view, statuses, summary, events)
        self._sweep_wedged(gangs_view, summary, events)
        self._sweep_canary(gangs_view, statuses, summary, events)
        summary["events"] = events
        return summary

    # -- arc 1: quarantine + fleet-wide rollback ------------------------------

    def _sweep_quarantine(self, gangs_view, statuses, summary, events) -> None:
        for key in sorted(statuses):
            rec = statuses[key]
            if rec.get("status") == "quarantined":
                continue
            plan_version = int(rec.get("plan_version", 0))
            indicted: Dict[str, List[str]] = {}
            max_step = 0
            for gang, adopted_version in sorted(rec.get("adopters", {}).items()):
                row = gangs_view.get(gang)
                if not row or not row.get("regressed"):
                    continue
                if int(adopted_version) != plan_version:
                    continue
                incs = self.plane.incidents(gang).get("incidents", [])
                cites = [
                    str(inc.get("trace_id") or "")
                    for inc in incs
                    if isinstance(inc, dict)
                    and inc.get("plan_version") == plan_version
                ]
                if cites:
                    indicted[gang] = cites
                    max_step = max(
                        max_step,
                        max((int(inc.get("step", 0)) for inc in incs
                             if isinstance(inc, dict)
                             and inc.get("plan_version") == plan_version),
                            default=0),
                    )
            if len(indicted) < self.quarantine_threshold:
                continue
            all_cites = sorted({t for ts in indicted.values() for t in ts if t})
            if not self.plane.mark_plan_quarantined(key, all_cites):
                continue
            summary["quarantined"].append(key)
            # fleet-wide rollback: every adopter — indicted or not — must
            # drop the poisoned plan
            for gang in sorted(rec.get("adopters", {})):
                directive = self.plane.issue_directive(
                    gang, "rollback_plan",
                    reason=f"plan_quarantine:v{plan_version}",
                    detail={"cache_key": key, "plan_version": plan_version},
                )
                summary["rollbacks"].append(
                    {"gang": gang, "id": directive["id"]}
                )
                self._emit([gang], {
                    "ts": round(self.clock(), 6),
                    "event": "remediation",
                    "step": max_step,
                    "action": "rollback_plan",
                    "gang": gang,
                    "reason": f"plan_quarantine:v{plan_version}",
                }, events)
            self._emit(sorted(indicted), {
                "ts": round(self.clock(), 6),
                "event": "plan_quarantine",
                "step": max_step,
                "cache_key": key,
                "plan_version": plan_version,
                "cites": all_cites,
                "gangs": sorted(indicted),
                "action": "quarantine",
            }, events)

    # -- arc 2: hang diagnosis + directed resize ------------------------------

    def _sweep_wedged(self, gangs_view, summary, events) -> None:
        for gang in sorted(gangs_view):
            row = gangs_view[gang]
            if row.get("verdict") != "wedged":
                continue
            if (row.get("remediation") or {}).get("pending"):
                continue  # already directed; wait for the ack
            dumps = [_pseudo_dump(d) for d in self.plane.flight_digests(gang)]
            report = build_hang_report(dumps)
            if report["verdict"] not in RESIZE_VERDICTS:
                continue
            implicated = sorted(
                set(report.get("divergent_ranks", []))
                | set(report.get("lagging_ranks", []))
            )
            to_world = max(1, len(report.get("ranks", [])) - max(1, len(implicated)))
            self.plane.issue_directive(
                gang, "resize",
                reason=f"hang:{report['verdict']}",
                detail={
                    "verdict": report["verdict"],
                    "to_world_size": to_world,
                    "implicated_ranks": implicated,
                    "note": report.get("detail", ""),
                },
            )
            summary["resized"].append(
                {"gang": gang, "verdict": report["verdict"],
                 "to_world_size": to_world}
            )
            self._emit([gang], {
                "ts": round(self.clock(), 6),
                "event": "remediation",
                "step": max(0, int(row.get("max_step", 0))),
                "action": "resize",
                "gang": gang,
                "reason": f"hang:{report['verdict']}",
            }, events)

    # -- arc 3: canary graduation ---------------------------------------------

    def _sweep_canary(self, gangs_view, statuses, summary, events) -> None:
        canary_n = int(getattr(self.plane, "canary_n", 1))
        for key in sorted(statuses):
            rec = statuses[key]
            if rec.get("status") != "canary":
                continue
            plan_version = int(rec.get("plan_version", 0))
            clean_now = list(rec.get("clean", []))
            graduated = False
            for gang in rec.get("cohort", []):
                if gang in clean_now:
                    continue
                row = gangs_view.get(gang)
                if not row or row.get("verdict") != "healthy":
                    continue
                outcome = self.plane.record_canary_clean(key, gang)
                if outcome is None:
                    continue
                clean_now.append(gang)
                summary["clean"].append({"cache_key": key, "gang": gang})
                self._emit([gang], {
                    "ts": round(self.clock(), 6),
                    "event": "canary_verdict",
                    "step": max(0, int(row.get("max_step", 0))),
                    "cache_key": key,
                    "plan_version": plan_version,
                    "verdict": "clean",
                    "clean": list(clean_now),
                    "needed": canary_n,
                }, events)
                if outcome == "graduated":
                    graduated = True
                    break
            if graduated:
                summary["graduated"].append(key)
                self._emit(list(clean_now), {
                    "ts": round(self.clock(), 6),
                    "event": "canary_verdict",
                    "step": 0,
                    "cache_key": key,
                    "plan_version": plan_version,
                    "verdict": "graduated",
                    "clean": list(clean_now),
                    "needed": canary_n,
                }, events)
