"""Consistent-hash sharded control plane.

One :class:`~bagua_tpu_torch.fleet.control_plane.FleetControlPlane` process was
validated at 8 gangs; "millions of users" is 2–3 orders of magnitude more
tenants.  The existing :class:`GangNamespace` isolation is the natural
cut: nothing crosses gang boundaries except the plan cache and the
remediation tier, both of which are keyed — so the fleet shards cleanly
by key.

* **Gang ops** (rendezvous, KV, blobs, spans, incidents, directives,
  admission, leases) route by ``hash("gang:<gang_id>")`` — a gang's whole
  namespace lives on exactly one shard, so every per-gang invariant the
  unsharded plane guarantees holds unchanged.
* **Plan ops** (the cross-gang cache + its quarantine/canary lifecycle)
  route by ``hash("plan:<cache_key>")`` — every gang looking up the same
  (fingerprint, topology, algorithm, wire_precision) tuple lands on the
  same shard, so adoption journaling, canary cohorts, and quarantine are
  exactly as coherent as on one plane.
* **``/fleet/*`` reads** (scheduler view, gang list, incidents, metrics,
  dump) fan out to every shard and merge — gang ids are disjoint across
  shards by construction, so the merge is a plain union.

Each shard owns a private WAL directory (``<wal_dir>/shard-<k>``) and
replays independently; :meth:`ShardedControlPlane.dump` nests the
per-shard dumps so SIGKILL+replay stays a bitwise comparison per shard.

The hash ring uses virtual nodes so shard loads stay within a few percent
of uniform at 1000 gangs, and the ring is a pure function of
``n_shards`` — no rebalancing state to persist.
"""

import bisect
import hashlib
import os
import threading
from typing import Dict, List, Optional

from bagua_tpu_torch.fleet.control_plane import FleetControlPlane, plan_cache_key

__all__ = ["HashRing", "ShardedControlPlane"]


class HashRing:
    """Consistent-hash ring over ``n_shards`` with ``vnodes`` virtual
    points per shard (sha256-based, stable across processes and runs)."""

    def __init__(self, n_shards: int, vnodes: int = 64):
        self.n_shards = max(1, int(n_shards))
        self.vnodes = max(1, int(vnodes))
        points = []
        for shard in range(self.n_shards):
            for v in range(self.vnodes):
                points.append((self._hash(f"shard{shard}:vn{v}"), shard))
        points.sort()
        self._hashes = [h for h, _ in points]
        self._shards = [s for _, s in points]

    @staticmethod
    def _hash(key: str) -> int:
        return int.from_bytes(
            hashlib.sha256(key.encode("utf-8")).digest()[:8], "big"
        )

    def shard_for(self, key: str) -> int:
        if self.n_shards == 1:
            return 0
        i = bisect.bisect(self._hashes, self._hash(key)) % len(self._hashes)
        return self._shards[i]


class ShardedControlPlane:
    """N independent control-plane shards behind the one-plane API.

    The facade exposes the exact surface :class:`FleetHandler` and the
    :class:`~bagua_tpu_torch.fleet.remediation.RemediationEngine` speak, so the
    HTTP layer and the remediation sweep run unmodified against 1 shard
    or 64.  Per-key ops route through the ring; fleet-wide reads fan out
    and merge.
    """

    def __init__(
        self,
        n_shards: int = 4,
        wal_dir: Optional[str] = None,
        vnodes: int = 64,
        **plane_kwargs,
    ):
        self.ring = HashRing(n_shards, vnodes=vnodes)
        self.n_shards = self.ring.n_shards
        self._lock = threading.Lock()
        self.shards: List[FleetControlPlane] = []
        for k in range(self.n_shards):
            shard_wal = os.path.join(wal_dir, f"shard-{k}") if wal_dir else None
            self.shards.append(FleetControlPlane(wal_dir=shard_wal, **plane_kwargs))

    # -- routing ----------------------------------------------------------------

    def shard_for_gang(self, gang_id: str) -> FleetControlPlane:
        return self.shards[self.ring.shard_for(f"gang:{gang_id}")]

    def shard_for_plan_key(self, key: str) -> FleetControlPlane:
        return self.shards[self.ring.shard_for(f"plan:{key}")]

    # -- gang namespaces, leases, admission -------------------------------------

    def gang(self, gang_id: str):
        return self.shard_for_gang(gang_id).gang(gang_id)

    def admit(self, gang_id: str) -> "tuple[bool, float]":
        return self.shard_for_gang(gang_id).admit(gang_id)

    def sweep_leases(self, min_interval_s: float = 1.0) -> List[str]:
        reaped: List[str] = []
        for shard in self.shards:
            reaped.extend(shard.sweep_leases(min_interval_s))
        return reaped

    def gang_ids(self) -> List[str]:
        ids: List[str] = []
        for shard in self.shards:
            ids.extend(shard.gang_ids())
        return sorted(ids)

    @property
    def gangs_gcd(self) -> int:
        return sum(s.gangs_gcd for s in self.shards)

    @property
    def backpressure_denials(self) -> int:
        return sum(s.backpressure_denials for s in self.shards)

    @property
    def canary_n(self) -> int:
        return self.shards[0].canary_n

    @property
    def plan_hits(self) -> int:
        return sum(s.plan_hits for s in self.shards)

    @property
    def plan_misses(self) -> int:
        return sum(s.plan_misses for s in self.shards)

    # -- cross-gang plan cache ---------------------------------------------------

    def plan_put(self, fingerprint, topology, algorithm, wire_precision,
                 plan, meta=None) -> str:
        key = plan_cache_key(fingerprint, topology, algorithm, wire_precision)
        return self.shard_for_plan_key(key).plan_put(
            fingerprint, topology, algorithm, wire_precision, plan, meta
        )

    def plan_get(self, fingerprint, topology, algorithm, wire_precision,
                 gang: Optional[str] = None) -> Optional[dict]:
        key = plan_cache_key(fingerprint, topology, algorithm, wire_precision)
        return self.shard_for_plan_key(key).plan_get(
            fingerprint, topology, algorithm, wire_precision, gang=gang
        )

    def plan_count(self) -> int:
        return sum(s.plan_count() for s in self.shards)

    # -- remediation tier --------------------------------------------------------

    def plan_statuses(self) -> Dict[str, dict]:
        merged: Dict[str, dict] = {}
        for shard in self.shards:
            merged.update(shard.plan_statuses())
        return merged

    def mark_plan_quarantined(self, key: str, cites) -> bool:
        return self.shard_for_plan_key(key).mark_plan_quarantined(key, cites)

    def record_canary_clean(self, key: str, gang: str) -> Optional[str]:
        return self.shard_for_plan_key(key).record_canary_clean(key, gang)

    def issue_directive(self, gang_id: str, action: str, reason: str = "",
                        detail: Optional[dict] = None) -> dict:
        return self.shard_for_gang(gang_id).issue_directive(
            gang_id, action, reason=reason, detail=detail
        )

    def directive(self, gang_id: str) -> Optional[dict]:
        return self.shard_for_gang(gang_id).directive(gang_id)

    def ack_directive(self, gang_id: str, directive_id: int) -> bool:
        return self.shard_for_gang(gang_id).ack_directive(gang_id, directive_id)

    def pending_directives(self, gang_id: str) -> List[dict]:
        return self.shard_for_gang(gang_id).pending_directives(gang_id)

    def remediation_summary(self) -> dict:
        merged = {"plans": {}, "directives": {}, "actions": {}}
        for shard in self.shards:
            summary = shard.remediation_summary()
            merged["plans"].update(summary["plans"])
            merged["directives"].update(summary["directives"])
            for action, n in summary["actions"].items():
                merged["actions"][action] = merged["actions"].get(action, 0) + n
        merged["canary_n"] = self.canary_n
        return merged

    def flight_digests(self, gang_id: str) -> List[dict]:
        return self.shard_for_gang(gang_id).flight_digests(gang_id)

    def remediate(self, **knobs) -> dict:
        """One RemediationEngine sweep over the *whole* sharded fleet: the
        engine reads the merged views and its writes route back through
        the ring (quarantine to the plan's shard, directives to each
        gang's shard)."""
        from bagua_tpu_torch.fleet.remediation import RemediationEngine

        return RemediationEngine(self, **knobs).sweep()

    def shard_info(self) -> dict:
        return {
            "n_shards": self.n_shards,
            "gangs_per_shard": [len(s.gang_ids()) for s in self.shards],
            "wal_replay_ms": [s.wal_replay_ms for s in self.shards],
        }

    # -- fleet-wide reads (fan out + merge) --------------------------------------

    def scheduler_view(self) -> dict:
        view = {"gangs": {}, "n_gangs": 0}
        for shard in self.shards:
            sv = shard.scheduler_view()
            view["gangs"].update(sv["gangs"])
            view["n_gangs"] += sv["n_gangs"]
        view["gangs"] = dict(sorted(view["gangs"].items()))
        return view

    def incidents(self, gang_id: Optional[str] = None) -> dict:
        if gang_id is not None:
            return self.shard_for_gang(gang_id).incidents(gang_id)
        gangs: Dict[str, list] = {}
        for shard in self.shards:
            gangs.update(shard.incidents()["gangs"])
        gangs = dict(sorted(gangs.items()))
        return {"gangs": gangs,
                "n_incidents": sum(len(v) for v in gangs.values())}

    def decisions(self, gang_id: Optional[str] = None) -> dict:
        if gang_id is not None:
            return self.shard_for_gang(gang_id).decisions(gang_id)
        gangs: Dict[str, list] = {}
        for shard in self.shards:
            gangs.update(shard.decisions()["gangs"])
        gangs = dict(sorted(gangs.items()))
        return {"gangs": gangs,
                "n_decisions": sum(len(v) for v in gangs.values())}

    def timeline(self, gang_id: str) -> dict:
        return self.shard_for_gang(gang_id).timeline(gang_id)

    # -- tracing (routed) --------------------------------------------------------

    def record_server_span(self, gang_id: str, route: str, status: int,
                           dur_ms: float, traceparent=None,
                           retry_after_s=None) -> dict:
        return self.shard_for_gang(gang_id).record_server_span(
            gang_id, route, status, dur_ms,
            traceparent=traceparent, retry_after_s=retry_after_s,
        )

    def ingest_spans(self, gang_id: str, spans, events=None) -> dict:
        return self.shard_for_gang(gang_id).ingest_spans(gang_id, spans, events)

    def ingest_incidents(self, gang_id: str, incidents) -> dict:
        return self.shard_for_gang(gang_id).ingest_incidents(gang_id, incidents)

    def ingest_decisions(self, gang_id: str, decisions) -> dict:
        return self.shard_for_gang(gang_id).ingest_decisions(gang_id, decisions)

    # -- metrics -----------------------------------------------------------------

    def metrics_text(self) -> str:
        """Merged ``/fleet/metrics`` exposition.  Per-shard registries
        cannot be concatenated (duplicate family names), so the aggregate
        families are composed by hand, plus the shard-labeled gauges only
        the sharded facade can know."""
        with self._lock:
            n_gangs = sum(len(s.gang_ids()) for s in self.shards)
            n_plans = self.plan_count()
            hits, misses = self.plan_hits, self.plan_misses
            denials = self.backpressure_denials
            actions = self.remediation_summary()["actions"]
            replay_ms = [s.wal_replay_ms for s in self.shards]
            has_wal = any(s.wal is not None for s in self.shards)
        lines = [
            "# HELP bagua_fleet_gangs live gang namespaces (all shards)",
            "# TYPE bagua_fleet_gangs gauge",
            f"bagua_fleet_gangs {n_gangs}",
            "# HELP bagua_fleet_plans_cached entries in the cross-gang plan cache (all shards)",
            "# TYPE bagua_fleet_plans_cached gauge",
            f"bagua_fleet_plans_cached {n_plans}",
            "# HELP bagua_fleet_plan_cache_hits_total plan-cache lookup hits (all shards)",
            "# TYPE bagua_fleet_plan_cache_hits_total counter",
            f"bagua_fleet_plan_cache_hits_total {hits}",
            "# HELP bagua_fleet_plan_cache_misses_total plan-cache lookup misses (all shards)",
            "# TYPE bagua_fleet_plan_cache_misses_total counter",
            f"bagua_fleet_plan_cache_misses_total {misses}",
            "# HELP bagua_fleet_backpressure_denials_total requests denied 429 (all shards)",
            "# TYPE bagua_fleet_backpressure_denials_total counter",
            f"bagua_fleet_backpressure_denials_total {denials}",
            "# HELP bagua_fleet_shard_count control-plane shards serving this fleet",
            "# TYPE bagua_fleet_shard_count gauge",
            f"bagua_fleet_shard_count {self.n_shards}",
        ]
        if has_wal:
            lines += [
                "# HELP bagua_wal_replay_ms wall time of the last WAL replay per shard",
                "# TYPE bagua_wal_replay_ms gauge",
            ]
            for k, ms in enumerate(replay_ms):
                lines.append(f'bagua_wal_replay_ms{{shard="{k}"}} {ms}')
        if actions:
            lines += [
                "# HELP bagua_remediations_total remediation actions journaled, by action",
                "# TYPE bagua_remediations_total counter",
            ]
            for action, n in sorted(actions.items()):
                lines.append(f'bagua_remediations_total{{action="{action}"}} {n}')
        return "\n".join(lines) + "\n"

    # -- durable-state witness ---------------------------------------------------

    def dump(self) -> dict:
        return {
            "n_shards": self.n_shards,
            "shards": [s.dump() for s in self.shards],
        }

    def maybe_compact(self) -> bool:
        return any([s.maybe_compact() for s in self.shards])

    def close(self) -> None:
        for shard in self.shards:
            shard.close()
