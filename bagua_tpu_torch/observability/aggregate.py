"""Cross-rank aggregation: per-window step summaries joined into a gang view.

The telemetry hub is strictly per-process — no rank ever sees the
gang.  This module closes that gap without adding a new wire protocol:
each rank serializes a compact :class:`StepSummary` (step, p50/p99
step-wall, wire bytes, MFU, health stats, phase attribution) and pushes it
through the rendezvous KV under the ``BAGUA_ATTEMPT`` nonce, reusing the
retry/breaker-hardened rendezvous client (the JAX package's
``distributed/rendezvous.py``; the port's comes with the launcher, ROADMAP
Queue 1 item 7).  Rank 0 collects the set into a :class:`GangView`:
per-rank skew, a straggler score (the rank whose step-wall p50 exceeds the
gang median by a configurable factor, attributed to its slowest phase via
the phase-tagged host-overhead breakdown), and gang-level Prometheus
gauges.

Degradation is a design constraint, not an afterthought: the KV path is
best-effort behind a :class:`~bagua_tpu_torch.resilience.retry.CircuitBreaker` —
a KV outage means the rank falls back to a local-only view (``gang_degraded``
gauge set, push-failure counter bumped) with zero training-path impact.
"""

import dataclasses
import logging
import os
import statistics
from typing import Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

__all__ = [
    "GangAggregator",
    "GangView",
    "StepSummary",
    "gang_kv_key",
    "straggler_score",
    "summarize_telemetry",
]


def gang_kv_key(attempt: str, rank: int) -> str:
    """KV key one rank's summary lives under — namespaced by the elastic
    attempt nonce so a restarted gang never reads a dead incarnation's
    numbers."""
    return f"bagua/obs/{attempt}/rank{int(rank)}"


@dataclasses.dataclass
class StepSummary:
    """One rank's compact per-window report — small enough to push through
    the rendezvous KV every window without anyone noticing."""

    rank: int
    step: int
    window: int = 0
    p50_ms: float = 0.0
    p99_ms: float = 0.0
    wire_bytes: int = 0
    mfu: float = 0.0
    samples_per_s: float = 0.0
    phase_ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    health: Dict[str, float] = dataclasses.field(default_factory=dict)

    def payload(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_payload(cls, payload: Dict) -> "StepSummary":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dict(payload).items() if k in fields})


def straggler_score(summaries: Sequence[StepSummary], factor: float = 1.5) -> Optional[Dict]:
    """The gang's straggler, if it has one: the rank whose step-wall p50
    exceeds the gang median by ``factor``, attributed to its slowest phase
    (largest entry of its phase-tagged host-overhead breakdown).  None when
    fewer than two ranks report or nobody crosses the threshold."""
    reports = [s for s in summaries if s is not None]
    if len(reports) < 2:
        return None
    median = statistics.median(s.p50_ms for s in reports)
    worst = max(reports, key=lambda s: s.p50_ms)
    if median <= 0:
        return None
    score = worst.p50_ms / median
    if score < factor:
        return None
    phase = None
    if worst.phase_ms:
        phase = max(worst.phase_ms.items(), key=lambda kv: kv[1])[0]
    return {
        "rank": worst.rank,
        "score": round(score, 4),
        "p50_ms": worst.p50_ms,
        "gang_median_ms": median,
        "phase": phase,
    }


class GangView:
    """The joined picture rank 0 (or a degraded rank, about itself) sees."""

    def __init__(self, world_size: int, summaries: Sequence[StepSummary],
                 straggler_factor: float = 1.5, local_only: bool = False,
                 heartbeat_ages: Optional[Dict[int, float]] = None):
        self.world_size = int(world_size)
        self.summaries = sorted((s for s in summaries if s is not None),
                                key=lambda s: s.rank)
        self.local_only = bool(local_only)
        # coordinator-side seconds since each rank's last heartbeat — a rank
        # can stop heartbeating (hung host) while its stale summary still
        # reads healthy, so this is surfaced per rank, not folded into skew
        self.heartbeat_ages: Dict[int, float] = {
            int(r): float(a) for r, a in (heartbeat_ages or {}).items()
        }
        self.straggler = straggler_score(self.summaries, factor=straggler_factor)
        p50s = [s.p50_ms for s in self.summaries]
        self.p50_median = statistics.median(p50s) if p50s else 0.0
        self.skew = (max(p50s) / self.p50_median
                     if p50s and self.p50_median > 0 else 1.0)
        # per-rank straggler scores (each rank's p50 / gang median), not just
        # the worst rank's — what makes a per-rank degradation decision
        # auditable end-to-end (which ranks were how far off, not only who
        # crossed the threshold)
        self.rank_scores: Dict[int, float] = (
            {s.rank: round(s.p50_ms / self.p50_median, 4) for s in self.summaries}
            if len(self.summaries) >= 2 and self.p50_median > 0 else {}
        )
        mfus = [s.mfu for s in self.summaries if s.mfu]
        self.mfu_mean = sum(mfus) / len(mfus) if mfus else 0.0

    @property
    def ranks_reporting(self) -> int:
        return len(self.summaries)

    def report(self) -> Dict:
        return {
            "world_size": self.world_size,
            "ranks_reporting": self.ranks_reporting,
            "local_only": self.local_only,
            "p50_median_ms": self.p50_median,
            "p50_skew": round(self.skew, 4),
            "mfu_mean": round(self.mfu_mean, 6),
            "straggler": self.straggler,
            "rank_scores": {str(r): v for r, v in sorted(self.rank_scores.items())},
            "heartbeat_ages_s": {str(r): round(a, 3)
                                 for r, a in sorted(self.heartbeat_ages.items())},
            "ranks": [s.payload() for s in self.summaries],
        }

    def export(self, registry) -> None:
        """Gang-level gauges into a metrics registry (rides the same
        Prometheus textfile export as everything else)."""
        g = registry.gauge
        g("gang_ranks_reporting", help="ranks whose summaries reached the gang view").set(
            self.ranks_reporting)
        g("gang_local_only", help="1 when the KV was unreachable and the view is local-only").set(
            1 if self.local_only else 0)
        g("gang_step_p50_ms_median", help="gang median of per-rank step-wall p50").set(
            round(self.p50_median, 3))
        g("gang_step_p50_skew", help="worst rank p50 / gang median p50").set(
            round(self.skew, 4))
        g("gang_mfu_mean", help="mean MFU across reporting ranks").set(
            round(self.mfu_mean, 6))
        g("gang_straggler_rank", help="straggling rank (-1 when none)").set(
            self.straggler["rank"] if self.straggler else -1)
        g("gang_straggler_score", help="straggler p50 / gang median (0 when none)").set(
            self.straggler["score"] if self.straggler else 0.0)
        for r, score in sorted(self.rank_scores.items()):
            g(f"gang_straggler_score_rank{r}",
              help="this rank's step-wall p50 / gang median p50").set(score)
        for r, age in sorted(self.heartbeat_ages.items()):
            g(f"gang_heartbeat_age_s_rank{r}",
              help="seconds since this rank's last rendezvous heartbeat").set(
                round(age, 3))


def summarize_telemetry(telemetry, rank: int, step: int, window: int = 0,
                        phase_ms: Optional[Dict[str, float]] = None) -> StepSummary:
    """Build this rank's :class:`StepSummary` from the telemetry hub's
    registry snapshot (+ an optional phase-tagged host-overhead breakdown,
    e.g. ``ddp.host_overhead_snapshot()`` totals scaled to ms)."""
    snap = telemetry.registry.snapshot()
    wall = snap.get("step_wall_ms") or {}
    health = {}
    for key in ("health_loss", "health_grad_norm", "health_nan_latched"):
        if key in snap:
            health[key] = snap[key]
    if "health_alerts_total" in snap:
        health["alerts_total"] = snap["health_alerts_total"]
    return StepSummary(
        rank=int(rank),
        step=int(step),
        window=int(window),
        p50_ms=float(wall.get("p50", 0.0) or 0.0),
        p99_ms=float(wall.get("p99", 0.0) or 0.0),
        wire_bytes=int(snap.get("wire_bytes_total", 0) or 0),
        mfu=float(snap.get("mfu", 0.0) or 0.0),
        samples_per_s=float(snap.get("samples_per_s", 0.0) or 0.0),
        phase_ms=dict(phase_ms or {}),
        health=health,
    )


class GangAggregator:
    """Window-cadenced push/collect of :class:`StepSummary` through the
    rendezvous KV.

    Every rank :meth:`push`\\ es its summary; rank 0 additionally
    :meth:`collect`\\ s whatever the gang has published and exports the
    joined :class:`GangView`.  All KV traffic is best-effort behind the
    shared circuit-breaker policy (``BAGUA_RPC_BREAKER_*``): when the KV is
    unreachable — or no client was configured at all — the view degrades to
    local-only and training never notices.
    """

    def __init__(self, client, rank: int = 0, world_size: int = 1,
                 attempt: Optional[str] = None, window: int = 20,
                 straggler_factor: float = 1.5, registry=None, breaker=None,
                 incident_push=None):
        from bagua_tpu_torch.env import get_rpc_breaker_cooldown_s, get_rpc_breaker_threshold
        from bagua_tpu_torch.resilience.retry import CircuitBreaker

        self.client = client
        self.rank = int(rank)
        self.world_size = max(1, int(world_size))
        self.attempt = (attempt if attempt is not None
                        else os.environ.get("BAGUA_ATTEMPT", "0"))
        self.window = max(1, int(window))
        self.straggler_factor = float(straggler_factor)
        self.registry = registry
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=get_rpc_breaker_threshold(),
            cooldown_s=get_rpc_breaker_cooldown_s(),
            name="gang-obs",
        )
        # best-effort sink for regression-sentinel incidents, e.g.
        # ``lambda incs: fleet.push_incidents(gang_id, incs)`` — same
        # degradation contract as the KV pushes: failures count, never raise
        self.incident_push = incident_push
        self.last_view: Optional[GangView] = None
        self._last_summary: Optional[StepSummary] = None

    # -- KV plumbing (best-effort, breaker-gated) -----------------------------

    def _kv_call(self, fn, *args):
        from bagua_tpu_torch.resilience.retry import CircuitOpenError

        try:
            self.breaker.before_call()
        except CircuitOpenError:
            return False, None
        try:
            out = fn(*args)
        except Exception as exc:  # any transport failure degrades, never raises
            self.breaker.record_failure()
            logger.debug("gang KV call failed (%s): %s", getattr(fn, "__name__", fn), exc)
            return False, None
        self.breaker.record_success()
        return True, out

    def push(self, summary: StepSummary) -> bool:
        """Publish this rank's summary; False (and a bumped failure
        counter) on any KV trouble."""
        self._last_summary = summary
        if self.client is None:
            return False
        ok, _ = self._kv_call(
            self.client.kv_set, gang_kv_key(self.attempt, summary.rank),
            summary.payload())
        if not ok and self.registry is not None:
            self.registry.counter(
                "gang_push_failures_total",
                help="gang summary KV pushes that failed or were breaker-gated",
            ).inc()
        return ok

    def collect(self) -> List[StepSummary]:
        """All summaries currently published for this attempt (missing or
        unparseable ranks are skipped)."""
        out: List[StepSummary] = []
        if self.client is None:
            return out
        for r in range(self.world_size):
            ok, payload = self._kv_call(
                self.client.kv_get, gang_kv_key(self.attempt, r))
            if not ok or not isinstance(payload, dict):
                continue
            try:
                out.append(StepSummary.from_payload(payload))
            except (TypeError, ValueError):
                logger.debug("gang: discarding malformed summary for rank %d", r)
        return out

    def heartbeat_ages(self) -> Dict[int, float]:
        """Coordinator-reported seconds since each rank's last heartbeat
        (best-effort, breaker-gated; empty on any KV trouble or when the
        client predates the ``ages`` reply field)."""
        if self.client is None or not hasattr(self.client, "heartbeat"):
            return {}
        ok, out = self._kv_call(self.client.heartbeat)
        if not ok or not isinstance(out, dict):
            return {}
        ages = out.get("ages")
        if not isinstance(ages, dict):
            return {}
        try:
            return {int(r): float(a) for r, a in ages.items()}
        except (TypeError, ValueError):
            return {}

    # -- the per-window entry point -------------------------------------------

    def aggregate(self, summary: StepSummary) -> Optional[GangView]:
        """Push this rank's summary; on rank 0 also collect and export the
        gang view (local-only when the KV path is down).  Returns the view
        on rank 0, None elsewhere."""
        pushed = self.push(summary)
        if self.rank != 0:
            return None
        summaries: Sequence[StepSummary] = [summary]
        local_only = True
        if pushed:
            collected = self.collect()
            if collected:
                summaries = collected
                local_only = len(collected) < self.world_size and self.world_size > 1
        ages = self.heartbeat_ages()
        view = GangView(self.world_size, summaries,
                        straggler_factor=self.straggler_factor,
                        local_only=local_only and self.world_size > 1,
                        heartbeat_ages=ages)
        self.last_view = view
        if self.registry is not None:
            try:
                view.export(self.registry)
                self.registry.gauge(
                    "gang_degraded",
                    help="1 while the gang view is local-only (KV unreachable)",
                ).set(1 if view.local_only else 0)
            except Exception:
                logger.exception("gang view export failed")
        return view

    def tick(self, step: int, telemetry, phase_ms: Optional[Dict[str, float]] = None
             ) -> Optional[GangView]:
        """Trainer-loop convenience: every ``window`` steps, summarize the
        local telemetry and aggregate.  Cheap no-op off-cadence."""
        if step == 0 or step % self.window != 0:
            return None
        summary = summarize_telemetry(telemetry, self.rank, step,
                                      window=self.window, phase_ms=phase_ms)
        view = self.aggregate(summary)
        sentinel = getattr(telemetry, "regression", None)
        if sentinel is not None:
            # the gang view is the only place straggler evidence exists:
            # feed the attributed excess (and rank) into the budget model so
            # the sentinel's next incident names it
            if view is not None and view.straggler is not None:
                excess = max(0.0, float(view.straggler["p50_ms"])
                             - float(view.straggler["gang_median_ms"]))
                sentinel.note_straggler(excess, rank=view.straggler["rank"])
            if self.incident_push is not None:
                pending = sentinel.drain_incidents()
                if pending:
                    try:
                        self.incident_push(pending)
                    except Exception as exc:
                        logger.debug("gang incident push failed: %s", exc)
                        if self.registry is not None:
                            self.registry.counter(
                                "gang_incident_push_failures_total",
                                help="fleet incident pushes that failed",
                            ).inc()
        return view
