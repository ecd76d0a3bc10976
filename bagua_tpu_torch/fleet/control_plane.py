"""Multi-tenant fleet control plane: per-gang namespaces over one server.

One :class:`FleetControlPlane` hosts N concurrent gangs.  Each gang gets a
:class:`GangNamespace` — its own rendezvous membership machine + KV + blob
tier (a journaled :class:`~bagua_tpu_torch.distributed.rendezvous.RendezvousState`)
and its own lazily-created
:class:`~bagua_tpu_torch.service.autotune_service.AutotuneService` (so every gang
tunes against its own ``AutotuneTaskManager`` pool, never a neighbor's).
Nothing is shared across gangs except what is *meant* to be shared: the
cross-gang plan cache.

Durability tiers (what the WAL covers):

* **durable** — membership/assignment/epoch, KV, blobs, gang set, the plan
  cache, and the remediation tier (plan adoptions, quarantine/canary
  status, gang directives).  Every mutation is journaled before the
  request is acknowledged; a killed-and-restarted server replays to the
  exact pre-crash state (:meth:`FleetControlPlane.dump` is the bitwise
  witness — remediation state included, so SIGKILL+replay reproduces
  every quarantine and directive the pre-crash engine issued).
* **advisory** — autotune tuning state.  Gangs re-register on reconnect
  (``register_tensors`` already handles restarted gangs), and the part
  worth keeping across jobs — the *winning plan* — is exactly what the
  durable plan cache distills.
* **volatile** — heartbeat ages, lease clocks, token buckets.  Replay
  restarts member ``last_seen`` and leases at *now*: a gang that rode out
  the outage on its retry/breaker machinery must not be reaped for the
  server's own crash.

Lock order (deadlock-free by construction): a gang state's lock and the
fleet lock are never held while waiting on each other; the WAL's lock is a
leaf.  Compaction (which walks every gang) runs only from
:meth:`maybe_compact`, called by the HTTP layer with no locks held.
"""

import base64
import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from bagua_tpu_torch.distributed.rendezvous import RendezvousState
from bagua_tpu_torch.fleet.wal import WriteAheadLog

logger = logging.getLogger("bagua_tpu_torch.fleet")

__all__ = [
    "plan_cache_key",
    "TokenBucket",
    "GangNamespace",
    "FleetControlPlane",
]

#: the plan-cache key dimensions, in canonical order
PLAN_KEY_FIELDS = ("fingerprint", "topology", "algorithm", "wire_precision")


def plan_cache_key(
    fingerprint: str, topology: str, algorithm: str, wire_precision: str
) -> str:
    """Canonical cache key: a plan proven on (model fingerprint, topology,
    algorithm, wire precision) is only valid for an *identical* tuple —
    bucket boundaries depend on the declaration list, and a plan tuned for
    a 32-rank int8 ring says nothing about 8-rank f32."""
    from urllib.parse import quote

    return "/".join(
        quote(str(v), safe="")
        for v in (fingerprint, topology, algorithm, wire_precision)
    )


class TokenBucket:
    """Per-gang admission control (thread-safe).  ``rate`` tokens/second
    refill up to ``burst``; a denied request gets the seconds until one
    token exists — the Retry-After hint.  ``rate <= 0`` admits everything."""

    def __init__(self, rate: float, burst: float, clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self._clock = clock
        self._tokens = self.burst
        self._refilled = clock()
        self._lock = threading.Lock()

    def admit(self) -> "tuple[bool, float]":
        """(admitted, retry_after_s)."""
        if self.rate <= 0:
            return True, 0.0
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst, self._tokens + (now - self._refilled) * self.rate)
            self._refilled = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True, 0.0
            return False, (1.0 - self._tokens) / self.rate


class _JournaledState(RendezvousState):
    """A gang's rendezvous state wired into the fleet WAL.

    KV/blob writes journal an idempotent per-op record *inside* the state
    lock (strict replay order).  Membership-mutating entry points re-export
    the durable membership machine after the call, under a dedicated serial
    lock: the export is re-read at append time, so the newest WAL record
    always reflects the newest state even under concurrent joins — full
    replaces, last-write-wins."""

    def __init__(self, gang_id: str, journal: Callable[[dict], None], **kwargs):
        super().__init__(**kwargs)
        self.gang_id = gang_id
        self._journal = journal
        self._journal_serial = threading.Lock()
        self._last_membership: Optional[dict] = None

    # -- membership (journal-after, serialized re-export) ---------------------

    def _journal_membership(self):
        with self._journal_serial:
            snap = self.export_membership()
            if snap != self._last_membership:
                self._last_membership = snap
                self._journal({"op": "rdzv", "gang": self.gang_id, "state": snap})

    def join(self, *args, **kwargs) -> dict:
        out = super().join(*args, **kwargs)
        self._journal_membership()
        return out

    def leave(self, *args, **kwargs) -> dict:
        out = super().leave(*args, **kwargs)
        self._journal_membership()
        return out

    def heartbeat(self, *args, **kwargs) -> dict:
        # A heartbeat itself is volatile, but it can reap/settle.
        out = super().heartbeat(*args, **kwargs)
        self._journal_membership()
        return out

    def request_restart(self, *args, **kwargs) -> dict:
        out = super().request_restart(*args, **kwargs)
        self._journal_membership()
        return out

    def report_crash(self, *args, **kwargs) -> dict:
        out = super().report_crash(*args, **kwargs)
        self._journal_membership()
        return out

    def assignment(self) -> dict:
        out = super().assignment()
        self._journal_membership()  # assignment() may reap/settle
        return out

    # -- KV / blobs (journal-in-lock, per-op) ---------------------------------

    def kv_set(self, key: str, value) -> None:
        with self._lock:
            self._kv[key] = value
            self._journal(
                {"op": "kv", "gang": self.gang_id, "key": key, "value": value}
            )

    def blob_set(self, key: str, data: bytes) -> None:
        with self._lock:
            old = self._blobs.pop(key, None)
            if old is not None:
                self._blob_bytes -= len(old)
            self._blobs[key] = data
            self._blob_bytes += len(data)
            while self._blob_bytes > self.max_blob_bytes and len(self._blobs) > 1:
                _, evicted = self._blobs.popitem(last=False)
                self._blob_bytes -= len(evicted)
            self._journal(
                {"op": "blob", "gang": self.gang_id, "key": key,
                 "b64": base64.b64encode(data).decode("ascii")}
            )

    def blob_get(self, key: str) -> "Optional[bytes]":
        # No LRU touch (unlike the single-tenant base class): reads are not
        # journaled, so eviction order must be a pure function of the
        # journaled sets (FIFO by insertion, re-set moves to the back — the
        # exact order replay_blob reconstructs) or a replayed server would
        # evict a different key than the one it ran before the crash.
        with self._lock:
            return self._blobs.get(key)

    # -- replay (no journaling) -----------------------------------------------

    def replay_kv(self, key: str, value) -> None:
        with self._lock:
            self._kv[key] = value

    def replay_blob(self, key: str, data: bytes) -> None:
        RendezvousState.blob_set(self, key, data)

    def replay_membership(self, snap: dict) -> None:
        self.restore_membership(snap)
        with self._journal_serial:
            self._last_membership = snap


class GangNamespace:
    """One gang's slice of the control plane."""

    def __init__(
        self,
        gang_id: str,
        journal: Callable[[dict], None],
        rdzv_kwargs: Optional[dict] = None,
        autotune_kwargs: Optional[dict] = None,
    ):
        self.gang_id = gang_id
        self.rendezvous = _JournaledState(gang_id, journal, **(rdzv_kwargs or {}))
        self._autotune_kwargs = dict(autotune_kwargs or {})
        self._autotune = None
        self._autotune_lock = threading.Lock()

    def autotune_service(self, world_size: Optional[int] = None):
        """This gang's private AutotuneService (own ``AutotuneTaskManager``
        pool), created on first use.  ``world_size`` only matters at
        creation (the sampling quorum); later calls ignore it."""
        with self._autotune_lock:
            if self._autotune is None:
                from bagua_tpu_torch.env import (
                    get_autotune_max_samples,
                    get_autotune_sampling_confidence_time_s,
                    get_autotune_warmup_time_s,
                )
                from bagua_tpu_torch.service.autotune_service import AutotuneService

                kwargs = dict(
                    autotune_level=1,
                    max_samples=get_autotune_max_samples(),
                    sampling_confidence_time_s=get_autotune_sampling_confidence_time_s(),
                    warmup_time_s=get_autotune_warmup_time_s(),
                )
                kwargs.update(self._autotune_kwargs)
                self._autotune = AutotuneService(
                    world_size=int(world_size or 1), **kwargs
                )
            return self._autotune

    @property
    def autotune_models(self) -> List[str]:
        with self._autotune_lock:
            if self._autotune is None:
                return []
            return sorted(self._autotune._managers)


class FleetControlPlane:
    """The whole fleet's shared state: gang namespaces, leases, admission
    control, the cross-gang plan cache, the WAL, the scheduler view."""

    def __init__(
        self,
        wal_dir: Optional[str] = None,
        lease_ttl_s: Optional[float] = None,
        rate: Optional[float] = None,
        burst: Optional[float] = None,
        compact_every: int = 1000,
        fsync: bool = False,
        rdzv_kwargs: Optional[dict] = None,
        autotune_kwargs: Optional[dict] = None,
        clock: Callable[[], float] = time.monotonic,
        canary_n: int = 2,
    ):
        from bagua_tpu_torch.env import (
            get_fleet_burst, get_fleet_lease_ttl_s, get_fleet_rate_limit,
        )

        self.lease_ttl_s = get_fleet_lease_ttl_s() if lease_ttl_s is None else float(lease_ttl_s)
        self.rate = get_fleet_rate_limit() if rate is None else float(rate)
        self.burst = get_fleet_burst() if burst is None else float(burst)
        self.rdzv_kwargs = dict(rdzv_kwargs or {})
        self.autotune_kwargs = dict(autotune_kwargs or {})
        self._clock = clock
        self._lock = threading.RLock()
        self._gangs: Dict[str, GangNamespace] = {}
        self._leases: Dict[str, float] = {}  # gang_id -> lease deadline
        self._buckets: Dict[str, TokenBucket] = {}
        self._plans: Dict[str, dict] = {}  # cache key -> {"plan", "meta"}
        self._last_sweep = clock()
        self._replaying = False
        self.gangs_gcd = 0
        self.backpressure_denials = 0
        # tracing + metrics tier — volatile by design: span rings and
        # request counters restart empty (like leases and token buckets)
        # and must NEVER appear in dump()/the WAL, or the kill/restart
        # bitwise witness would diff on observability noise.
        self._server_spans: Dict[str, deque] = {}   # gang -> finished server spans
        self._client_spans: Dict[str, deque] = {}   # gang -> ingested client spans
        self._timeline_events: Dict[str, deque] = {}  # gang -> ingested events
        self._incidents: Dict[str, deque] = {}  # gang -> perf_regression events
        self._decisions: Dict[str, deque] = {}  # gang -> plan_decision events
        self._request_counts: Dict[str, int] = {}
        self._deny_counts: Dict[str, int] = {}
        self._incident_counts: Dict[str, int] = {}
        self._decision_counts: Dict[str, int] = {}
        self.plan_hits = 0
        self.plan_misses = 0
        # -- remediation tier (durable): plan adoption/quarantine/canary
        # status + per-gang directives.  Journaled like the plan cache so
        # SIGKILL+replay reproduces the same remediation state bitwise.
        self.canary_n = max(1, int(canary_n))
        self._rem: dict = {"plans": {}, "directives": {}, "actions": {}}
        #: wall time of the last WAL replay (volatile; /fleet/metrics gauge)
        self.wal_replay_ms = 0.0
        self.wal = WriteAheadLog(wal_dir, compact_every=compact_every, fsync=fsync) if wal_dir else None
        if self.wal is not None:
            self._replay()

    # -- WAL ------------------------------------------------------------------

    def journal(self, record: dict) -> None:
        if self.wal is None or self._replaying:
            return
        self.wal.append(record)

    def maybe_compact(self) -> bool:
        """Fold the WAL into a snapshot when due.  Called with no locks
        held (the HTTP layer, after replying): the full-fleet dump below
        takes the fleet lock and every gang lock in turn.  The WAL cursor
        is captured *before* the dump — handler threads keep acknowledging
        mutations while we walk the gangs, and anything they journal past
        the cursor must outlive the compaction in the rewritten log."""
        if self.wal is None or not self.wal.needs_compact():
            return False
        as_of = self.wal.cursor()
        self.wal.compact(self._snapshot_state(), as_of_seq=as_of)
        logger.info("WAL compacted (#%d)", self.wal.compactions)
        return True

    def _snapshot_state(self) -> dict:
        import json as _json

        with self._lock:
            gangs = dict(self._gangs)
            plans = {k: dict(v) for k, v in self._plans.items()}
            # deep copy via JSON round-trip: the snapshot must not alias
            # live remediation dicts a concurrent sweep keeps mutating
            remediation = _json.loads(_json.dumps(self._rem))
        state = {"plans": plans, "gangs": {}, "remediation": remediation}
        for gang_id, ns in sorted(gangs.items()):
            st = ns.rendezvous
            with st._lock:
                kv = dict(st._kv)
                blobs = {
                    k: base64.b64encode(v).decode("ascii")
                    for k, v in st._blobs.items()
                }
            state["gangs"][gang_id] = {
                "rdzv": st.export_membership(),
                "kv": kv,
                "blobs": blobs,
            }
        return state

    def _replay(self) -> None:
        t0 = time.perf_counter()
        snapshot, records = self.wal.load()
        self._replaying = True
        try:
            if snapshot:
                for key, entry in snapshot.get("plans", {}).items():
                    self._plans[key] = dict(entry)
                rem = snapshot.get("remediation")
                if isinstance(rem, dict):
                    self._rem = {
                        "plans": dict(rem.get("plans", {})),
                        "directives": dict(rem.get("directives", {})),
                        "actions": dict(rem.get("actions", {})),
                    }
                for gang_id, gs in snapshot.get("gangs", {}).items():
                    ns = self._ensure_gang(gang_id)
                    ns.rendezvous.replay_membership(gs.get("rdzv", {}))
                    for k, v in gs.get("kv", {}).items():
                        ns.rendezvous.replay_kv(k, v)
                    for k, b64 in gs.get("blobs", {}).items():
                        ns.rendezvous.replay_blob(k, base64.b64decode(b64))
            for rec in records:
                self._apply(rec)
        finally:
            self._replaying = False
        self.wal_replay_ms = round((time.perf_counter() - t0) * 1e3, 3)
        if snapshot or records:
            logger.info(
                "WAL replay: %d gangs, %d cached plans, %d records past "
                "snapshot (%.1f ms)",
                len(self._gangs), len(self._plans), len(records),
                self.wal_replay_ms,
            )

    #: WAL ops owned by the remediation tier (dispatched to _rem_apply)
    _REM_OPS = ("adopt", "quarantine", "canary", "plan_status",
                "directive", "directive_ack")

    def _apply(self, rec: dict) -> None:
        op = rec.get("op")
        if op == "gang":
            self._ensure_gang(rec["gang"])
        elif op == "gang_gc":
            self._gangs.pop(rec["gang"], None)
            self._leases.pop(rec["gang"], None)
            self._buckets.pop(rec["gang"], None)
            self._rem["directives"].pop(rec["gang"], None)
        elif op == "rdzv":
            self._ensure_gang(rec["gang"]).rendezvous.replay_membership(rec["state"])
        elif op == "kv":
            self._ensure_gang(rec["gang"]).rendezvous.replay_kv(rec["key"], rec["value"])
        elif op == "blob":
            self._ensure_gang(rec["gang"]).rendezvous.replay_blob(
                rec["key"], base64.b64decode(rec["b64"])
            )
        elif op == "plan":
            self._plans[rec["key"]] = dict(rec["entry"])
            self._rem_plan_init(rec["key"], rec["entry"])
        elif op in self._REM_OPS:
            self._rem_apply(rec)
        else:
            logger.warning("WAL replay: unknown op %r (skipped)", op)

    # -- gang namespaces, leases, admission -----------------------------------

    def _ensure_gang(self, gang_id: str) -> GangNamespace:
        with self._lock:
            ns = self._gangs.get(gang_id)
            if ns is None:
                ns = GangNamespace(
                    gang_id,
                    self.journal,
                    rdzv_kwargs=self.rdzv_kwargs,
                    autotune_kwargs=self.autotune_kwargs,
                )
                self._gangs[gang_id] = ns
                self.journal({"op": "gang", "gang": gang_id})
                if not self._replaying:
                    logger.info("gang %r: namespace created", gang_id)
            self._leases[gang_id] = self._clock() + self.lease_ttl_s
            return ns

    def gang(self, gang_id: str) -> GangNamespace:
        """Resolve (creating on first touch) a gang's namespace; touches
        its lease and opportunistically sweeps expired neighbors."""
        self.sweep_leases()
        return self._ensure_gang(gang_id)

    def admit(self, gang_id: str) -> "tuple[bool, float]":
        """Token-bucket admission for one request; (admitted, retry_after_s)."""
        with self._lock:
            bucket = self._buckets.get(gang_id)
            if bucket is None:
                bucket = self._buckets[gang_id] = TokenBucket(
                    self.rate, self.burst, clock=self._clock
                )
        ok, retry_after = bucket.admit()
        if not ok:
            with self._lock:
                self.backpressure_denials += 1
                # A denial must not starve the lease: admission runs before
                # fleet.gang(), so a live gang held in backpressure (or
                # pacing on Retry-After) past the TTL would otherwise get
                # its whole durable namespace reaped.  Touch known gangs
                # only — a denied request never *creates* a namespace.
                if gang_id in self._gangs:
                    self._leases[gang_id] = self._clock() + self.lease_ttl_s
        return ok, retry_after

    def sweep_leases(self, min_interval_s: float = 1.0) -> List[str]:
        """Reap gangs whose lease expired: drop the namespace (KV, blobs,
        membership, autotune managers — all of it) and journal the GC so a
        restart doesn't resurrect the dead.  Rate-limited; returns the
        reaped gang ids."""
        now = self._clock()
        reaped = []
        with self._lock:
            if now - self._last_sweep < min_interval_s:
                return reaped
            self._last_sweep = now
            for gang_id, deadline in list(self._leases.items()):
                if now > deadline:
                    reaped.append(gang_id)
                    self._gangs.pop(gang_id, None)
                    self._leases.pop(gang_id, None)
                    self._buckets.pop(gang_id, None)
                    # pending directives die with the namespace (same fate
                    # on replay: _apply("gang_gc") pops the same key)
                    self._rem["directives"].pop(gang_id, None)
                    self.gangs_gcd += 1
                    # Journal inside the removal's critical section (the WAL
                    # lock is a leaf, so this is deadlock-free): journaling
                    # after releasing the fleet lock would let a concurrent
                    # recreation journal its gang/kv records first, and
                    # replay would then GC a gang the pre-crash server
                    # considered alive.
                    self.journal({"op": "gang_gc", "gang": gang_id})
        for gang_id in reaped:
            logger.warning("gang %r: lease expired; namespace GC'd", gang_id)
        return reaped

    def gang_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._gangs)

    # -- cross-gang plan cache -------------------------------------------------

    def plan_put(
        self,
        fingerprint: str,
        topology: str,
        algorithm: str,
        wire_precision: str,
        plan: dict,
        meta: Optional[dict] = None,
    ) -> str:
        key = plan_cache_key(fingerprint, topology, algorithm, wire_precision)
        entry = {
            "plan": plan,
            "meta": dict(meta or {}),
            "key": {
                "fingerprint": str(fingerprint),
                "topology": str(topology),
                "algorithm": str(algorithm),
                "wire_precision": str(wire_precision),
            },
        }
        with self._lock:
            self._plans[key] = entry
            self.journal({"op": "plan", "key": key, "entry": entry})
            self._rem_plan_init(key, entry)
        logger.info("plan cache: stored %s", key)
        return key

    def plan_get(
        self,
        fingerprint: str,
        topology: str,
        algorithm: str,
        wire_precision: str,
        gang: Optional[str] = None,
    ) -> Optional[dict]:
        """Cache lookup.  With a ``gang`` identity the remediation tier
        gates the entry (a quarantined plan is never served; a canary plan
        is served only to its cohort until it graduates) and the adoption
        is journaled — the correlation record the :class:`RemediationEngine`
        sweeps.  ``gang=None`` is the legacy read-only path: no adoption is
        recorded and canary gating does not apply (quarantine still does)."""
        key = plan_cache_key(fingerprint, topology, algorithm, wire_precision)
        with self._lock:
            entry = self._plans.get(key)
            if entry is None:
                self.plan_misses += 1
                return None
            rec = self._rem["plans"].get(key)
            if rec is not None:
                if rec["status"] == "quarantined":
                    self.plan_misses += 1
                    return None
                if gang is not None:
                    if (
                        rec["status"] == "canary"
                        and gang not in rec["cohort"]
                        and len(rec["cohort"]) >= self.canary_n
                    ):
                        # cohort is full: withheld until the canaries report
                        # clean windows and the plan graduates to default
                        self.plan_misses += 1
                        return None
                    if gang not in rec["adopters"]:
                        self._rem_record({
                            "op": "adopt",
                            "key": key,
                            "gang": str(gang),
                            "plan_version": rec["plan_version"],
                            "cohort_add": bool(
                                rec["status"] == "canary"
                                and gang not in rec["cohort"]
                            ),
                        })
            self.plan_hits += 1
            return dict(entry)

    def plan_count(self) -> int:
        with self._lock:
            return len(self._plans)

    # -- remediation tier (durable) ---------------------------------------------

    def _rem_record(self, rec: dict) -> None:
        """Journal one remediation op, then apply it — the single mutation
        path shared by the live API and WAL replay (``journal`` is a no-op
        while replaying), so both produce identical state."""
        self.journal(rec)
        self._rem_apply(rec)

    def _rem_plan_init(self, key: str, entry: dict) -> None:
        """(Re)published plan: a fresh ``plan_version`` starts its canary
        lifecycle; republishing the same version keeps the current status —
        a quarantined version cannot launder itself by republication."""
        plan_version = int((entry.get("meta") or {}).get("plan_version", 0))
        rec = self._rem["plans"].get(key)
        if rec is None or rec.get("plan_version") != plan_version:
            self._rem["plans"][key] = {
                "status": "canary",
                "plan_version": plan_version,
                "adopters": {},
                "cohort": [],
                "clean": [],
            }

    def _rem_apply(self, rec: dict) -> None:
        op = rec["op"]
        if op == "adopt":
            plan = self._rem["plans"].get(rec["key"])
            if plan is not None:
                plan["adopters"][rec["gang"]] = rec["plan_version"]
                if rec.get("cohort_add") and rec["gang"] not in plan["cohort"]:
                    plan["cohort"].append(rec["gang"])
        elif op == "quarantine":
            plan = self._rem["plans"].get(rec["key"])
            if plan is not None and plan["status"] != "quarantined":
                plan["status"] = "quarantined"
                plan["cites"] = list(rec.get("cites", []))
                actions = self._rem["actions"]
                actions["quarantine"] = actions.get("quarantine", 0) + 1
        elif op == "canary":
            plan = self._rem["plans"].get(rec["key"])
            if plan is not None and rec["gang"] not in plan["clean"]:
                plan["clean"].append(rec["gang"])
        elif op == "plan_status":
            plan = self._rem["plans"].get(rec["key"])
            if plan is not None and plan["status"] != rec["status"]:
                if plan["status"] == "canary" and rec["status"] == "default":
                    actions = self._rem["actions"]
                    actions["canary_graduate"] = actions.get("canary_graduate", 0) + 1
                plan["status"] = rec["status"]
        elif op == "directive":
            lst = self._rem["directives"].setdefault(rec["gang"], [])
            lst.append(dict(rec["directive"]))
            action = rec["directive"].get("action", "unknown")
            actions = self._rem["actions"]
            actions[action] = actions.get(action, 0) + 1
        elif op == "directive_ack":
            for d in self._rem["directives"].get(rec["gang"], []):
                if d["id"] == rec["id"]:
                    d["acked"] = True

    def plan_statuses(self) -> Dict[str, dict]:
        """Deep copy of every plan's remediation record (status,
        plan_version, adopters, canary cohort, clean reporters)."""
        import json as _json

        with self._lock:
            return _json.loads(_json.dumps(self._rem["plans"]))

    def mark_plan_quarantined(self, key: str, cites) -> bool:
        """Quarantine one cached plan (idempotent; False when the key is
        unknown or already quarantined).  ``cites`` are the indicting
        incidents' trace_ids — journaled with the quarantine so the
        evidence chain survives SIGKILL+replay."""
        with self._lock:
            rec = self._rem["plans"].get(key)
            if rec is None or rec["status"] == "quarantined":
                return False
            self._rem_record({
                "op": "quarantine", "key": key,
                "cites": [str(t) for t in cites],
            })
        logger.warning("plan cache: QUARANTINED %s (cited: %s)", key, list(cites))
        return True

    def record_canary_clean(self, key: str, gang: str) -> Optional[str]:
        """One canary adopter reported a clean window.  Returns ``"clean"``
        (recorded), ``"graduated"`` (this report met ``canary_n`` and the
        plan was promoted to default), or None (not a canary adopter /
        already counted)."""
        with self._lock:
            rec = self._rem["plans"].get(key)
            if (
                rec is None or rec["status"] != "canary"
                or gang not in rec["cohort"] or gang in rec["clean"]
            ):
                return None
            self._rem_record({"op": "canary", "key": key, "gang": str(gang)})
            if len(rec["clean"]) >= self.canary_n:
                self._rem_record({"op": "plan_status", "key": key,
                                  "status": "default"})
                logger.info("plan cache: %s graduated canary -> default", key)
                return "graduated"
            return "clean"

    def issue_directive(
        self, gang_id: str, action: str, reason: str = "",
        detail: Optional[dict] = None,
    ) -> dict:
        """Durably direct one gang (``rollback_plan``, ``resize``, ...).
        The gang polls ``GET /g/<gang>/directive`` and acks; unacked
        directives surface as the scheduler view's remediation-pending
        marker."""
        with self._lock:
            lst = self._rem["directives"].get(gang_id, [])
            directive = {
                "id": 1 + max((d["id"] for d in lst), default=0),
                "action": str(action),
                "reason": str(reason),
                "acked": False,
            }
            if detail:
                directive["detail"] = dict(detail)
            self._rem_record({"op": "directive", "gang": str(gang_id),
                              "directive": directive})
            return dict(directive)

    def directive(self, gang_id: str) -> Optional[dict]:
        """The gang's oldest pending (unacked) directive, or None."""
        with self._lock:
            for d in self._rem["directives"].get(gang_id, []):
                if not d["acked"]:
                    return dict(d)
            return None

    def ack_directive(self, gang_id: str, directive_id: int) -> bool:
        with self._lock:
            for d in self._rem["directives"].get(gang_id, []):
                if d["id"] == int(directive_id) and not d["acked"]:
                    self._rem_record({"op": "directive_ack",
                                      "gang": str(gang_id),
                                      "id": int(directive_id)})
                    return True
            return False

    def pending_directives(self, gang_id: str) -> List[dict]:
        with self._lock:
            return [dict(d) for d in self._rem["directives"].get(gang_id, [])
                    if not d["acked"]]

    def remediation_summary(self) -> dict:
        """Deep copy of the whole durable remediation tier (the
        ``GET /fleet/remediation`` route)."""
        import json as _json

        with self._lock:
            out = _json.loads(_json.dumps(self._rem))
        out["canary_n"] = self.canary_n
        return out

    def flight_digests(self, gang_id: str) -> List[dict]:
        """The gang's pushed flight digests for its most-advanced attempt —
        the pseudo-dumps the RemediationEngine joins through
        ``build_hang_report`` when the gang goes ``wedged``."""
        with self._lock:
            ns = self._gangs.get(gang_id)
        if ns is None:
            return []
        st = ns.rendezvous
        by_attempt: Dict[str, List[dict]] = {}
        for key in st.kv_keys():
            parts = key.split("/")
            if key.startswith("bagua/flight/") and len(parts) == 4:
                digest = st.kv_get(key)
                if isinstance(digest, dict):
                    by_attempt.setdefault(parts[2], []).append(digest)
        if not by_attempt:
            return []
        def _advance(attempt: str) -> int:
            return max(
                (d["last_seq"] for d in by_attempt[attempt]
                 if isinstance(d.get("last_seq"), int)),
                default=-1,
            )
        return by_attempt[max(by_attempt, key=_advance)]

    def remediate(self, **knobs) -> dict:
        """Run one RemediationEngine sweep over this plane (the
        ``POST /fleet/remediate`` route)."""
        from bagua_tpu_torch.fleet.remediation import RemediationEngine

        return RemediationEngine(self, **knobs).sweep()

    def shard_info(self) -> dict:
        """Shard topology view (one unsharded plane = one shard)."""
        with self._lock:
            n_gangs = len(self._gangs)
        return {
            "n_shards": 1,
            "gangs_per_shard": [n_gangs],
            "wal_replay_ms": [self.wal_replay_ms],
        }

    # -- scheduler view ---------------------------------------------------------

    def scheduler_view(self) -> dict:
        """Fleet-wide verdicts from the streams gangs already push: per-gang
        ``wedged`` (a flight digest landed — some rank dumped its black box)
        > ``straggler`` (StepSummary p50 spread past the threshold) >
        ``regressed`` (the gang's regression sentinel pushed a
        ``perf_regression`` incident) > ``healthy`` (summaries, no
        findings) > ``idle`` (nothing pushed)."""
        from bagua_tpu_torch.observability.aggregate import StepSummary, straggler_score

        self.sweep_leases()
        now = self._clock()
        with self._lock:
            gangs = dict(self._gangs)
            leases = dict(self._leases)
            incidents_by_gang = {g: list(ring) for g, ring in self._incidents.items()}
            decisions_by_gang = {g: list(ring) for g, ring in self._decisions.items()}
            pending_by_gang = {
                g: [dict(d) for d in lst if not d["acked"]]
                for g, lst in self._rem["directives"].items()
            }
        view = {"gangs": {}, "n_gangs": len(gangs)}
        for gang_id, ns in sorted(gangs.items()):
            st = ns.rendezvous
            # group pushed summaries by attempt nonce; judge the newest
            # attempt (max settled step) — dead incarnations' numbers stay
            by_attempt: Dict[str, List[StepSummary]] = {}
            flight_ranks = []
            for key in st.kv_keys():
                parts = key.split("/")
                if key.startswith("bagua/obs/") and len(parts) == 4:
                    try:
                        summary = StepSummary.from_payload(st.kv_get(key))
                    except (TypeError, ValueError):
                        continue
                    by_attempt.setdefault(parts[2], []).append(summary)
                elif key.startswith("bagua/flight/") and len(parts) == 4:
                    flight_ranks.append(parts[3])
            summaries: List[StepSummary] = []
            if by_attempt:
                attempt = max(by_attempt, key=lambda a: max(s.step for s in by_attempt[a]))
                summaries = by_attempt[attempt]
            straggler = straggler_score(summaries) if summaries else None
            # per-rank score vector (p50 / gang median) — who is how far off,
            # not only who crossed the threshold; same math as
            # GangView.rank_scores so the scheduler and gang views agree
            rank_scores = {}
            if len(summaries) >= 2:
                import statistics as _stats

                median = _stats.median(s.p50_ms for s in summaries)
                if median > 0:
                    rank_scores = {
                        str(s.rank): round(s.p50_ms / median, 4) for s in summaries
                    }
            incidents = incidents_by_gang.get(gang_id, [])
            if flight_ranks:
                verdict = "wedged"
            elif straggler is not None:
                verdict = "straggler"
            elif incidents:
                verdict = "regressed"
            elif summaries:
                verdict = "healthy"
            else:
                verdict = "idle"
            last = incidents[-1] if incidents else None
            decisions = decisions_by_gang.get(gang_id, [])
            last_dec = decisions[-1] if decisions else None
            asn = st.export_membership()
            settled = asn.get("settled")
            view["gangs"][gang_id] = {
                "verdict": verdict,
                "straggler": straggler,
                "rank_scores": rank_scores,
                "regressed": bool(incidents),
                "incidents": len(incidents),
                "last_incident": (
                    {"step": last.get("step"), "dominant": last.get("dominant"),
                     "stream": last.get("stream"),
                     # axis-resolved incidents name the mesh axis and link
                     # class (ici/dcn) the sentinel indicted
                     **({"axis": last["axis"]} if last.get("axis") else {}),
                     **({"link_class": last["link_class"]}
                        if last.get("link_class") else {})}
                    if isinstance(last, dict) else None
                ),
                # what the gang's autopilot last did about its incidents —
                # None means no controller is attached (or it never spoke)
                "autopilot": (
                    {"decision": last_dec.get("decision"),
                     "verdict": last_dec.get("verdict"),
                     "step": last_dec.get("step"),
                     "to_config": last_dec.get("to_config"),
                     **({"axis": last_dec["axis"]}
                        if last_dec.get("axis") else {})}
                    if isinstance(last_dec, dict) else None
                ),
                "decisions": len(decisions),
                # remediation-pending marker: the engine already directed
                # this gang and the directive is not yet acked.  A marker,
                # not a verdict rung — the ladder above is unchanged.
                "remediation": (
                    {"pending": len(pending_by_gang[gang_id]),
                     "action": pending_by_gang[gang_id][0]["action"],
                     "id": pending_by_gang[gang_id][0]["id"]}
                    if pending_by_gang.get(gang_id) else None
                ),
                "flight_ranks": sorted(flight_ranks),
                "ranks_reporting": len(summaries),
                "max_step": max((s.step for s in summaries), default=-1),
                "n_members": len(asn.get("members", [])),
                "epoch": asn.get("epoch", 0),
                "generation": asn.get("generation", 0),
                "world_size": settled.get("world_size") if settled else None,
                "lease_remaining_s": round(leases.get(gang_id, now) - now, 3),
            }
        return view

    # -- tracing (volatile tier) -------------------------------------------------

    #: per-gang span-ring capacity; old spans fall off — this is a flight
    #: recorder for the RPC tier, not an archive
    SPAN_RING = 512

    def _ring(self, store: Dict[str, deque], gang_id: str) -> deque:
        with self._lock:
            ring = store.get(gang_id)
            if ring is None:
                ring = store[gang_id] = deque(maxlen=self.SPAN_RING)
            return ring

    def record_server_span(
        self,
        gang_id: str,
        route: str,
        status: int,
        dur_ms: float,
        traceparent: Optional[str] = None,
        retry_after_s: Optional[float] = None,
    ) -> dict:
        """One handled HTTP request as a server-side span.  With a valid
        ``traceparent`` the span joins the caller's trace as a child of the
        in-flight client span; without one it's a root (unattributed
        traffic still shows on the timeline).  Also feeds the per-gang
        request/deny counters ``/fleet/metrics`` exports."""
        from bagua_tpu_torch.observability.tracing import (
            new_span_id, new_trace_id, parse_traceparent,
        )

        ctx = parse_traceparent(traceparent)
        span = {
            "schema": "bagua.span.v1",
            "trace_id": ctx["trace_id"] if ctx else new_trace_id(),
            "span_id": new_span_id(),
            "name": f"http {route}",
            "kind": "server",
            "ts": round(time.time() - max(0.0, float(dur_ms)) / 1e3, 6),
            "dur_ms": round(max(0.0, float(dur_ms)), 4),
            "attrs": {
                "service": "fleet-server",
                "gang": str(gang_id),
                "route": str(route),
                "status": int(status),
            },
        }
        if ctx:
            span["parent_id"] = ctx["span_id"]
        if int(status) == 429:
            span["annotations"] = [{
                "name": "backpressure", "ts": round(time.time(), 6),
                "retry_after_s": round(float(retry_after_s or 0.0), 3),
            }]
        self._ring(self._server_spans, gang_id).append(span)
        with self._lock:
            self._request_counts[gang_id] = self._request_counts.get(gang_id, 0) + 1
            if int(status) == 429:
                self._deny_counts[gang_id] = self._deny_counts.get(gang_id, 0) + 1
        return span

    def ingest_spans(self, gang_id: str, spans, events=None) -> dict:
        """Client-side span batch (the ``/g/<gang>/spans`` route): each
        valid ``bagua.span.v1`` dict lands in the gang's volatile client
        ring; malformed ones are counted and dropped (a trace must never
        poison the control plane).  ``events`` (plain dicts with a ``ts``)
        ride a separate ring so hang/health/rpc_retry events can appear on
        the timeline next to the spans that caused them."""
        from bagua_tpu_torch.observability.tracing import validate_span

        accepted = rejected = 0
        ring = self._ring(self._client_spans, gang_id)
        for span in spans or []:
            if validate_span(span):
                rejected += 1
                continue
            ring.append(dict(span))
            accepted += 1
        ev_ring = self._ring(self._timeline_events, gang_id)
        n_events = 0
        for ev in events or []:
            if isinstance(ev, dict):
                ev_ring.append(dict(ev))
                n_events += 1
        return {"accepted": accepted, "rejected": rejected, "events": n_events}

    def ingest_incidents(self, gang_id: str, incidents) -> dict:
        """A batch of regression-sentinel ``perf_regression`` incidents
        (the ``POST /g/<gang>/incidents`` route).  Same volatile contract
        as the span rings: a bounded per-gang deque, never in the WAL or
        ``dump()``, restarts empty.  An incident must at least carry a
        ``step`` and a ``dominant`` component; anything else is counted
        and dropped (a malformed verdict must never poison the control
        plane)."""
        accepted = rejected = 0
        ring = self._ring(self._incidents, gang_id)
        for inc in incidents or []:
            if (not isinstance(inc, dict) or "step" not in inc
                    or not isinstance(inc.get("dominant"), str)):
                rejected += 1
                continue
            ring.append(dict(inc))
            accepted += 1
        if accepted:
            with self._lock:
                self._incident_counts[gang_id] = (
                    self._incident_counts.get(gang_id, 0) + accepted
                )
        return {"accepted": accepted, "rejected": rejected}

    def ingest_decisions(self, gang_id: str, decisions) -> dict:
        """A batch of autopilot ``plan_decision`` events (the
        ``POST /g/<gang>/decisions`` route).  Volatile like the incident
        tier: bounded per-gang deque, never in the WAL or ``dump()``.  A
        decision must carry string ``decision`` and ``verdict`` fields;
        anything else is counted and dropped."""
        accepted = rejected = 0
        ring = self._ring(self._decisions, gang_id)
        for dec in decisions or []:
            if (not isinstance(dec, dict)
                    or not isinstance(dec.get("decision"), str)
                    or not isinstance(dec.get("verdict"), str)):
                rejected += 1
                continue
            ring.append(dict(dec))
            accepted += 1
        if accepted:
            with self._lock:
                self._decision_counts[gang_id] = (
                    self._decision_counts.get(gang_id, 0) + accepted
                )
        return {"accepted": accepted, "rejected": rejected}

    def decisions(self, gang_id: Optional[str] = None) -> dict:
        """The volatile decision tier (the ``GET /fleet/decisions`` route):
        every gang's recent autopilot ``plan_decision`` events, or one
        gang's when ``gang_id`` is given."""
        with self._lock:
            if gang_id is not None:
                rows = list(self._decisions.get(gang_id, ()))
                return {"gang": str(gang_id), "decisions": rows,
                        "n_decisions": len(rows)}
            gangs = {g: list(ring) for g, ring in sorted(self._decisions.items())
                     if ring}
        return {"gangs": gangs,
                "n_decisions": sum(len(v) for v in gangs.values())}

    def incidents(self, gang_id: Optional[str] = None) -> dict:
        """The volatile incident tier (the ``GET /fleet/incidents`` route):
        every gang's recent ``perf_regression`` events, or one gang's when
        ``gang_id`` is given."""
        with self._lock:
            if gang_id is not None:
                rows = list(self._incidents.get(gang_id, ()))
                return {"gang": str(gang_id), "incidents": rows,
                        "n_incidents": len(rows)}
            gangs = {g: list(ring) for g, ring in sorted(self._incidents.items())
                     if ring}
        return {"gangs": gangs,
                "n_incidents": sum(len(v) for v in gangs.values())}

    def timeline(self, gang_id: str) -> dict:
        """The gang's joined, causally ordered timeline: client spans
        (ingested), server spans (recorded per request), StepSummary
        windows and flight digests (from the gang KV), and ingested
        events — one flat ``items`` list ordered by wall clock, plus a
        ``traces`` index listing each trace's spans parent-before-child
        (the client→server chain the CI lane asserts)."""
        from bagua_tpu_torch.observability.aggregate import StepSummary

        with self._lock:
            ns = self._gangs.get(gang_id)
            client = list(self._client_spans.get(gang_id, ()))
            server = list(self._server_spans.get(gang_id, ()))
            events = list(self._timeline_events.get(gang_id, ()))
            incidents = list(self._incidents.get(gang_id, ()))
            decisions = list(self._decisions.get(gang_id, ()))
        items = []
        # the discriminator is "item", not "kind" — spans already carry a
        # "kind" of their own (internal/client/server) that must survive
        for span in client:
            items.append({"item": "client_span", "ts": span.get("ts"), **span})
        for span in server:
            items.append({"item": "server_span", "ts": span.get("ts"), **span})
        for ev in events:
            items.append({"item": "event", "ts": ev.get("ts"), **ev})
        for inc in incidents:
            items.append({"item": "incident", "ts": inc.get("ts"), **inc})
        for dec in decisions:
            items.append({"item": "decision", "ts": dec.get("ts"), **dec})
        if ns is not None:
            st = ns.rendezvous
            for key in st.kv_keys():
                parts = key.split("/")
                if key.startswith("bagua/obs/") and len(parts) == 4:
                    try:
                        summary = StepSummary.from_payload(st.kv_get(key))
                    except (TypeError, ValueError):
                        continue
                    items.append({
                        "item": "step_summary", "ts": None,
                        "attempt": parts[2], "rank": summary.rank,
                        "step": summary.step, "p50_ms": summary.p50_ms,
                        "p99_ms": summary.p99_ms, "health": summary.health,
                    })
                elif key.startswith("bagua/flight/") and len(parts) == 4:
                    digest = st.kv_get(key)
                    items.append({
                        "item": "flight_digest", "ts": None,
                        "attempt": parts[2], "rank": parts[3],
                        "digest": digest if isinstance(digest, dict) else {},
                    })
        # wall-clock order; ts-less KV items (summaries/digests) lead —
        # they are windows, not instants
        items.sort(key=lambda it: (it.get("ts") is not None, it.get("ts") or 0.0))
        # per-trace causal chains: parent before child, siblings by ts
        by_trace: Dict[str, List[dict]] = {}
        for span in client + server:
            tid = span.get("trace_id")
            if tid:
                by_trace.setdefault(tid, []).append(span)
        traces = {}
        for tid, spans in by_trace.items():
            children: Dict[Optional[str], List[dict]] = {}
            ids = {s["span_id"] for s in spans}
            for s in spans:
                parent = s.get("parent_id")
                children.setdefault(
                    parent if parent in ids else None, []
                ).append(s)
            ordered: List[dict] = []
            stack = sorted(
                children.get(None, []),
                key=lambda s: s.get("ts") or 0.0, reverse=True,
            )
            while stack:
                s = stack.pop()
                ordered.append(s)
                stack.extend(sorted(
                    children.get(s["span_id"], []),
                    key=lambda c: c.get("ts") or 0.0, reverse=True,
                ))
            traces[tid] = ordered
        return {
            "gang": str(gang_id),
            "items": items,
            "traces": traces,
            "n_client_spans": len(client),
            "n_server_spans": len(server),
            "n_events": len(events),
            "n_incidents": len(incidents),
            "n_decisions": len(decisions),
            "n_traces": len(traces),
        }

    def metrics_registry(self):
        """A fresh registry materializing the fleet's own counters — what
        ``/fleet/metrics`` renders with the shared Prometheus formatter.
        Built per scrape (the live counters are plain ints under the fleet
        lock; a registry would be a second copy to keep coherent)."""
        from bagua_tpu_torch.observability.metrics import MetricsRegistry, _prom_name

        self.sweep_leases()
        now = self._clock()
        with self._lock:
            requests = dict(self._request_counts)
            denials = dict(self._deny_counts)
            incidents = dict(self._incident_counts)
            decisions = dict(self._decision_counts)
            leases = {g: d - now for g, d in self._leases.items() if g in self._gangs}
            n_gangs = len(self._gangs)
            plan_hits, plan_misses = self.plan_hits, self.plan_misses
            total_denials = self.backpressure_denials
            n_plans = len(self._plans)
        r = MetricsRegistry(prefix="bagua_fleet")
        r.gauge("gangs", help="live gang namespaces").set(n_gangs)
        r.gauge("plans_cached", help="entries in the cross-gang plan cache").set(n_plans)
        r.counter("plan_cache_hits_total", help="plan-cache lookup hits").inc(plan_hits)
        r.counter("plan_cache_misses_total", help="plan-cache lookup misses").inc(plan_misses)
        r.counter(
            "backpressure_denials_total", help="requests denied 429 (all gangs)"
        ).inc(total_denials)
        r.counter("requests_total", help="gang requests handled (all gangs)").inc(
            sum(requests.values())
        )
        for gang_id, n in sorted(requests.items()):
            r.counter(
                f"requests_total_{_prom_name(gang_id)}",
                help=f"requests handled for gang {gang_id}",
            ).inc(n)
        for gang_id, n in sorted(denials.items()):
            r.counter(
                f"denials_429_total_{_prom_name(gang_id)}",
                help=f"requests denied 429 for gang {gang_id}",
            ).inc(n)
        r.counter(
            "incidents_total",
            help="perf_regression incidents ingested (all gangs)",
        ).inc(sum(incidents.values()))
        for gang_id, n in sorted(incidents.items()):
            r.counter(
                f"incidents_total_{_prom_name(gang_id)}",
                help=f"perf_regression incidents ingested for gang {gang_id}",
            ).inc(n)
        r.counter(
            "plan_decisions_total",
            help="autopilot plan_decision events ingested (all gangs)",
        ).inc(sum(decisions.values()))
        for gang_id, n in sorted(decisions.items()):
            r.counter(
                f"plan_decisions_total_{_prom_name(gang_id)}",
                help=f"autopilot plan_decision events ingested for gang {gang_id}",
            ).inc(n)
        for gang_id, remaining in sorted(leases.items()):
            r.gauge(
                f"lease_remaining_s_{_prom_name(gang_id)}",
                help=f"seconds until gang {gang_id}'s lease expires",
            ).set(round(max(0.0, remaining), 3))
        return r

    def metrics_text(self) -> str:
        """The full ``/fleet/metrics`` exposition: the registry above plus
        the labeled shard/remediation families the registry's label-less
        instruments cannot express (composed by hand — same format)."""
        text = self.metrics_registry().to_prometheus()
        with self._lock:
            actions = dict(self._rem["actions"])
        lines = [
            "# HELP bagua_fleet_shard_count control-plane shards serving this fleet",
            "# TYPE bagua_fleet_shard_count gauge",
            "bagua_fleet_shard_count 1",
        ]
        if self.wal is not None:
            lines += [
                "# HELP bagua_wal_replay_ms wall time of the last WAL replay per shard",
                "# TYPE bagua_wal_replay_ms gauge",
                f'bagua_wal_replay_ms{{shard="0"}} {self.wal_replay_ms}',
            ]
        if actions:
            lines += [
                "# HELP bagua_remediations_total remediation actions journaled, by action",
                "# TYPE bagua_remediations_total counter",
            ]
            for action, n in sorted(actions.items()):
                lines.append(f'bagua_remediations_total{{action="{action}"}} {n}')
        return text + "\n".join(lines) + "\n"

    # -- durable-state witness --------------------------------------------------

    def dump(self) -> dict:
        """Deterministic export of every *durable* tier — the bitwise
        witness the kill/restart tests compare.  Volatile state (heartbeat
        ages, lease clocks, token buckets) and the advisory autotune tier
        are excluded by design; blobs appear as sha256 digests so the dump
        stays small."""
        import hashlib

        state = self._snapshot_state()
        for gs in state["gangs"].values():
            gs["blobs"] = {
                k: hashlib.sha256(base64.b64decode(v)).hexdigest()
                for k, v in gs["blobs"].items()
            }
        state["n_gangs"] = len(state["gangs"])
        state["n_plans"] = len(state["plans"])
        return state

    def close(self) -> None:
        if self.wal is not None:
            as_of = self.wal.cursor()
            self.wal.compact(self._snapshot_state(), as_of_seq=as_of)
            self.wal.close()
