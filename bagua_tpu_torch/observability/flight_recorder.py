"""Collective flight recorder: black-box hang forensics for bucketed
collectives.

The BAGUA engines compose every algorithm out of bucketed collectives, so
the dominant production failure is a desynced or wedged collective — and a
post-mortem needs *which rank, which bucket, which collective, which plan
version*, cross-rank, before the restart loop erases the scene.  This
module is the per-rank black box: a sequence-numbered ring of one record
per collective the engine issues, dumped atomically on Watchdog timeout or
SIGTERM and joined offline by ``ci/diagnose_hang.py`` into a
``hang_report`` with first-desync attribution.

Design constraints (and how they are met):

* **Capture once, replay every step** (the JAX package's design, kept
  though the port runs its stages eagerly).  The engine enables
  :func:`capture_program` around the first step of each step variant, and
  again after every ``rebucket``, precision, staleness or algorithm switch
  (where the JAX engine clears its captured programs), and
  :meth:`AlgorithmImpl.annotate <bagua_tpu_torch.algorithms.base.AlgorithmImpl.annotate>`
  — the single choke point every bucket exchange wraps itself in — calls
  :func:`notify_collective`, yielding an ordered *program* of collective
  descriptors, which the engine caches per variant.  The quantized ring
  adds one ``phase="hop"`` descriptor per ring with the hop count
  in-record (:func:`notify_ring`).  Every step then replays the program
  into the ring with monotonic enqueue/retire timestamps from the host
  dispatch window.  The capture is a thread-local list, so the overlap
  hooks, which autograd runs on its own thread on the card, re-enter the
  step's list (``capture_program(events)``) around each exchange.
* **Bitwise-inert.**  Capture reads host-side Python values only; no
  tensor is touched, so recorder on vs off produces bit-identical
  training state (pinned in tests, the ``health_scalars`` discipline).
* **Lock-free hot path.**  ``record()`` builds an immutable dict, assigns
  it into a preallocated slot, then bumps the sequence counter — single
  reference assignments, no lock, no device sync.  A dump from another
  thread (the watchdog) reads whole-record references, so a dump during an
  append can never observe a torn record.
* **Degradation.**  The post-dump digest push rides the rendezvous KV
  behind the shared retry policy and a circuit breaker; any KV trouble
  degrades to local-only evidence, never an exception on the dying path.

Record labels reuse the named-scope grammar
(``bagua_ex/algo=<a>/bucket=<i>/phase=<p>``) so ring records and device-
trace labels join on the same key.
"""

import json
import logging
import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

from bagua_tpu_torch.observability.scope_grammar import EXCHANGE_PREFIX

logger = logging.getLogger(__name__)

__all__ = [
    "FLIGHT_DUMP_SCHEMA",
    "HANG_REPORT_SCHEMA",
    "VERDICTS",
    "FlightRecorder",
    "build_hang_report",
    "capture_program",
    "flight_dump_path",
    "flight_kv_key",
    "notify_collective",
    "notify_ring",
    "push_flight_digest",
    "thread_stacks",
    "validate_flight_dump",
    "validate_hang_report",
    "write_json_atomic",
]

FLIGHT_DUMP_SCHEMA = "bagua.flight_dump.v1"
HANG_REPORT_SCHEMA = "bagua.hang_report.v1"

#: the analyzer's verdict taxonomy: ``desync`` = ring *content* diverges at
#: a sequence number (a rank issued a different collective — the skipped/
#: extra-collective bug class); ``straggler`` = identical programs but a
#: rank stopped advancing with its host parked in ``wait`` (device-side
#: lag); ``host_wedge`` = the lagging rank's host stopped mid-dispatch
#: (unretired records) or outside ``wait``; ``healthy``/``no_data`` close
#: the taxonomy.
VERDICTS = ("healthy", "desync", "straggler", "host_wedge", "no_data")


# ---------------------------------------------------------------------------
# Trace-time capture
# ---------------------------------------------------------------------------

_tls = threading.local()


class capture_program:
    """Enable collective capture on this thread::

        with capture_program() as events:
            out = step(state, batch)   # annotate() notifies

    ``events`` is the ordered list of collective descriptors the step
    issued.  Pass a list to append to it: ``capture_program(events)``
    re-enters a capture on another thread (the engine's overlap hooks).
    Reentrant (the previous capture, if any, is restored on exit).
    """

    def __init__(self, events: Optional[List[Dict]] = None):
        self.events: List[Dict] = [] if events is None else events

    def __enter__(self) -> List[Dict]:
        self._prev = getattr(_tls, "capture", None)
        _tls.capture = self.events
        return self.events

    def __exit__(self, *exc) -> bool:
        _tls.capture = self._prev
        return False


def notify_collective(algo: str, bucket_idx: int, phase: str, **extra) -> None:
    """One bucket collective was issued (called by
    ``AlgorithmImpl.annotate``).  No-op unless a capture is active."""
    cap = getattr(_tls, "capture", None)
    if cap is None:
        return
    ev: Dict[str, Any] = {
        "algo": str(algo), "bucket": int(bucket_idx), "phase": str(phase),
    }
    ev.update(extra)
    cap.append(ev)


def notify_ring(*, kind: str, bits: int, hops: int, wire_bytes: int = 0) -> None:
    """One quantized ring (reduce-scatter or all-gather leg) was issued: a
    single ``phase="hop"`` descriptor carrying the hop count —
    not one per hop — attributed to the enclosing bucket collective."""
    cap = getattr(_tls, "capture", None)
    if cap is None:
        return
    algo, bucket = "ring", -1
    for ev in reversed(cap):
        if ev.get("phase") != "hop":
            algo, bucket = ev["algo"], ev["bucket"]
            break
    cap.append({
        "algo": algo, "bucket": bucket, "phase": "hop", "ring": str(kind),
        "bits": int(bits), "hops": int(hops), "nbytes": int(wire_bytes),
        "precision": f"int{int(bits)}",
    })


# ---------------------------------------------------------------------------
# The ring
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Per-rank lock-free ring of sequence-numbered collective records.

    The hot path (:meth:`record` / :meth:`record_program` / :meth:`retire`)
    runs on the engine's dispatch thread; :meth:`records` / :meth:`dump`
    may run concurrently on the watchdog thread.  Safety argument: every
    slot holds either ``None`` or a complete immutable record (the dict is
    fully built before the single reference assignment publishes it), so a
    reader sees whole records only — at worst a mix of just-overwritten and
    just-published ones, which the per-record ``seq`` sorts out.
    """

    def __init__(self, capacity: int = 4096, rank: int = 0, world_size: int = 1):
        self._slots: List[Optional[Dict]] = [None] * max(8, int(capacity))
        self._seq = 0  # next sequence number == records ever appended
        self.rank = int(rank)
        self.world_size = int(world_size)

    @property
    def capacity(self) -> int:
        return len(self._slots)

    @property
    def last_seq(self) -> int:
        """Sequence number of the newest record (-1 while empty)."""
        return self._seq - 1

    def record(self, rec: Dict) -> int:
        """Append one collective record; returns its sequence number."""
        seq = self._seq
        rec = dict(rec)
        rec["seq"] = seq
        self._slots[seq % len(self._slots)] = rec  # publish (atomic ref set)
        self._seq = seq + 1
        return seq

    def record_program(self, program: Sequence[Dict], *, step: int,
                       enqueue_t: Optional[float] = None) -> List[int]:
        """Replay one step's captured collective program into the ring with
        ``t_retire=None`` (the dispatch is in flight); returns the sequence
        numbers for :meth:`retire`."""
        t = time.monotonic() if enqueue_t is None else float(enqueue_t)
        seqs = []
        for tmpl in program:
            rec = dict(tmpl)
            rec["step"] = int(step)
            rec["t_enqueue"] = t
            rec["t_retire"] = None
            seqs.append(self.record(rec))
        return seqs

    def retire(self, seqs: Sequence[int], retire_t: Optional[float] = None) -> None:
        """The dispatch window closed: stamp ``t_retire`` on the given
        records (skipping any the ring already evicted)."""
        t = time.monotonic() if retire_t is None else float(retire_t)
        cap = len(self._slots)
        for seq in seqs:
            cur = self._slots[seq % cap]
            if cur is not None and cur.get("seq") == seq and cur.get("t_retire") is None:
                new = dict(cur)
                new["t_retire"] = t
                self._slots[seq % cap] = new

    def records(self) -> List[Dict]:
        """Snapshot of the ring's live records in sequence order.  Safe
        against a concurrent :meth:`record` (see class docstring)."""
        recs = [r for r in list(self._slots) if r is not None]
        recs.sort(key=lambda r: r["seq"])
        return recs

    # -- the dying-path surface ----------------------------------------------

    def dump(self, path: str, *, reason: str = "manual",
             telemetry: Optional[Dict] = None,
             plan_version: Optional[int] = None,
             extra: Optional[Dict] = None) -> Dict:
        """Atomically write this rank's black box (`write-temp +
        os.replace`): the ring, every thread's stack, the telemetry
        snapshot, and monotonic/unix clock anchors so offline analysis can
        convert record timestamps to ages."""
        payload: Dict[str, Any] = {
            "schema": FLIGHT_DUMP_SCHEMA,
            "rank": self.rank,
            "world_size": self.world_size,
            "reason": str(reason),
            "mono_at_dump": time.monotonic(),
            "unix_at_dump": time.time(),
            "capacity": len(self._slots),
            "last_seq": self.last_seq,
            "records": self.records(),
            "threads": thread_stacks(),
            "telemetry": telemetry,
            "plan_version": plan_version,
        }
        if extra:
            payload.update(extra)
        write_json_atomic(path, payload)
        return payload

    def digest(self) -> Dict:
        """The compact cross-rank breadcrumb pushed through the rendezvous
        KV at dump time — enough for a live operator (or the analyzer, when
        a rank's dump file is lost) to place this rank in the gang."""
        recs = self.records()
        last = recs[-1] if recs else None
        return {
            "rank": self.rank,
            "last_seq": self.last_seq,
            "unretired": sum(1 for r in recs if r.get("t_retire") is None),
            "last": (
                {k: last.get(k) for k in
                 ("seq", "step", "label", "bucket", "phase", "plan_version")}
                if last else None
            ),
            # the newest few full records: enough for the fleet's
            # RemediationEngine to synthesize a pseudo-dump per rank and
            # run build_hang_report's first-desync join server-side, even
            # when every dump file died with its host
            "tail": [dict(r) for r in recs[-8:]],
            "mono": time.monotonic(),
        }


def flight_dump_path(dump_dir: str, rank: int) -> str:
    return os.path.join(dump_dir, f"flight_{int(rank)}.json")


def thread_stacks() -> Dict[str, str]:
    """Formatted stacks of every live thread, keyed ``<name>-<ident>``."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        out[f"{names.get(ident, 'thread')}-{ident}"] = "".join(
            traceback.format_stack(frame)
        )
    return out


def write_json_atomic(path: str, payload: Dict) -> None:
    """Write-temp + ``os.replace`` — a reader (or the restart loop's
    collector) never sees a torn file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True, default=str)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Digest push (rendezvous KV, best-effort)
# ---------------------------------------------------------------------------

_breaker = None
_breaker_lock = threading.Lock()


def _default_breaker():
    global _breaker
    with _breaker_lock:
        if _breaker is None:
            from bagua_tpu_torch.env import (
                get_rpc_breaker_cooldown_s,
                get_rpc_breaker_threshold,
            )
            from bagua_tpu_torch.resilience.retry import CircuitBreaker

            _breaker = CircuitBreaker(
                failure_threshold=get_rpc_breaker_threshold(),
                cooldown_s=get_rpc_breaker_cooldown_s(),
                name="flight-digest",
            )
        return _breaker


def flight_kv_key(attempt: str, rank: int) -> str:
    """KV key one rank's flight digest lives under — namespaced by the
    elastic attempt nonce like the gang-observability keys."""
    return f"bagua/flight/{attempt}/rank{int(rank)}"


def push_flight_digest(client, recorder: Optional[FlightRecorder],
                       attempt: Optional[str] = None, breaker=None) -> bool:
    """Best-effort digest push through the rendezvous KV.  The client's
    transport already retries (``RetryPolicy``); this adds the circuit
    breaker and swallows every failure — the dying path degrades to
    local-only dumps, it never raises."""
    if client is None or recorder is None:
        return False
    if attempt is None:
        attempt = os.environ.get("BAGUA_ATTEMPT", "0")
    breaker = breaker or _default_breaker()
    try:
        breaker.before_call()
    except Exception:
        return False
    try:
        client.kv_set(flight_kv_key(attempt, recorder.rank), recorder.digest())
    except Exception as exc:
        breaker.record_failure()
        logger.warning("flight digest push failed (local-only evidence): %s", exc)
        return False
    breaker.record_success()
    return True


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------

#: per-record required fields (``t_retire`` is float-or-None, checked apart)
_RECORD_FIELDS = {
    "seq": int,
    "step": int,
    "label": str,
    "algo": str,
    "bucket": int,
    "phase": str,
    "precision": str,
    "nbytes": int,
    "plan_version": int,
    "t_enqueue": (int, float),
}

_DUMP_FIELDS = {
    "rank": int,
    "world_size": int,
    "reason": str,
    "mono_at_dump": (int, float),
    "unix_at_dump": (int, float),
    "capacity": int,
    "last_seq": int,
    "records": list,
    "threads": dict,
}

_REPORT_FIELDS = {
    "ranks": list,
    "last_seq": dict,
    "lagging_ranks": list,
    "divergent_ranks": list,
    "verdict": str,
    "per_rank": dict,
    "detail": str,
}

_BLOCKED_ON_FIELDS = {"seq": int, "label": str, "algo": str, "bucket": int,
                      "phase": str, "plan_version": int}


def _check_fields(obj: Dict, fields: Dict, problems: List[str], where: str) -> None:
    for field, types in fields.items():
        if field not in obj:
            problems.append(f"{where} missing field {field!r}")
        elif not isinstance(obj[field], types) or isinstance(obj[field], bool):
            problems.append(
                f"{where} field {field!r} is {type(obj[field]).__name__}, "
                f"expected {types}"
            )


def validate_flight_record(rec: Dict, where: str = "record") -> List[str]:
    problems: List[str] = []
    if not isinstance(rec, dict):
        return [f"{where} is {type(rec).__name__}, not an object"]
    _check_fields(rec, _RECORD_FIELDS, problems, where)
    t_ret = rec.get("t_retire", None)
    if t_ret is not None and not isinstance(t_ret, (int, float)):
        problems.append(f"{where} field 't_retire' must be a number or null")
    return problems


def validate_flight_dump(dump: Dict) -> List[str]:
    """Schema-check one per-rank flight dump; returns problems (empty =
    valid)."""
    if not isinstance(dump, dict):
        return [f"dump is {type(dump).__name__}, not an object"]
    problems: List[str] = []
    if dump.get("schema") != FLIGHT_DUMP_SCHEMA:
        problems.append(
            f"schema is {dump.get('schema')!r}, expected {FLIGHT_DUMP_SCHEMA!r}"
        )
    _check_fields(dump, _DUMP_FIELDS, problems, "dump")
    records = dump.get("records")
    if isinstance(records, list):
        prev = None
        for i, rec in enumerate(records):
            problems.extend(validate_flight_record(rec, where=f"records[{i}]"))
            seq = rec.get("seq") if isinstance(rec, dict) else None
            if isinstance(seq, int):
                if prev is not None and seq <= prev:
                    problems.append(
                        f"records[{i}] seq {seq} not increasing (prev {prev})"
                    )
                prev = seq
        if records and isinstance(dump.get("last_seq"), int) and prev is not None:
            if prev != dump["last_seq"]:
                problems.append(
                    f"last_seq {dump['last_seq']} != newest record seq {prev}"
                )
    return problems


def validate_hang_report(report: Dict) -> List[str]:
    """Schema-check a joined hang report; returns problems (empty = valid)."""
    if not isinstance(report, dict):
        return [f"report is {type(report).__name__}, not an object"]
    problems: List[str] = []
    if report.get("schema") != HANG_REPORT_SCHEMA:
        problems.append(
            f"schema is {report.get('schema')!r}, expected {HANG_REPORT_SCHEMA!r}"
        )
    _check_fields(report, _REPORT_FIELDS, problems, "report")
    if report.get("verdict") not in VERDICTS:
        problems.append(
            f"verdict {report.get('verdict')!r} not in {VERDICTS}"
        )
    fd = report.get("first_divergence_seq", None)
    if fd is not None and not isinstance(fd, int):
        problems.append("'first_divergence_seq' must be an int or null")
    blocked = report.get("blocked_on", None)
    if blocked is not None:
        if not isinstance(blocked, dict):
            problems.append("'blocked_on' must be an object or null")
        else:
            _check_fields(blocked, _BLOCKED_ON_FIELDS, problems, "blocked_on")
    if report.get("verdict") in ("desync", "straggler", "host_wedge") and blocked is None:
        problems.append(f"verdict {report['verdict']!r} requires 'blocked_on'")
    return problems


# ---------------------------------------------------------------------------
# The join: per-rank rings -> hang report
# ---------------------------------------------------------------------------


def _signature(rec: Dict) -> Tuple:
    """What must agree across ranks for a sequence slot to be 'the same
    collective' (timestamps excluded — those differ by design)."""
    return (
        rec.get("label"), rec.get("step"), rec.get("nbytes"),
        rec.get("precision"), rec.get("plan_version"), rec.get("hops"),
    )


def _blocked_on(rec: Dict) -> Dict:
    out = {k: rec.get(k) for k in
           ("seq", "step", "label", "algo", "bucket", "phase", "precision",
            "nbytes", "plan_version", "variant")}
    if "hops" in rec:
        out["hops"] = rec["hops"]
    if "axes" in rec:
        # which mesh axes the blocked collective rides — lets the hang
        # verdict name the link a wedged gang is stuck behind
        out["axes"] = list(rec["axes"])
    return out


def build_hang_report(dumps: Sequence[Dict]) -> Dict:
    """Join per-rank flight dumps into the forensics verdict.

    * ``first_divergence_seq`` — the first sequence number (within the
      window every surviving ring still covers) where record *content*
      differs across ranks; its majority record is the collective the
      minority desynced from.
    * ``lagging_ranks`` — ranks whose newest sequence number trails the
      most-advanced rank; ``blocked_on`` is then the first collective they
      have not issued (read from an advanced rank's ring) — the collective
      the gang is blocked on.
    * verdict — see :data:`VERDICTS`; the straggler-vs-host-wedge split
      uses per-record enqueue/retire deltas (an unretired record means the
      host never came back from the dispatch) plus the dumped telemetry
      phase.
    """
    dumps = sorted((d for d in dumps if isinstance(d, dict)),
                   key=lambda d: d.get("rank", 0))
    report: Dict[str, Any] = {
        "schema": HANG_REPORT_SCHEMA,
        "ranks": [int(d.get("rank", -1)) for d in dumps],
        "last_seq": {},
        "first_divergence_seq": None,
        "lagging_ranks": [],
        "divergent_ranks": [],
        "blocked_on": None,
        "verdict": "no_data",
        "per_rank": {},
        "detail": "",
    }
    if not dumps:
        report["detail"] = "no flight dumps found"
        return report

    by_rank: Dict[int, Dict[int, Dict]] = {}
    for d in dumps:
        r = int(d.get("rank", -1))
        recs = {rec["seq"]: rec for rec in d.get("records", [])
                if isinstance(rec, dict) and isinstance(rec.get("seq"), int)}
        by_rank[r] = recs
        last = int(d.get("last_seq", -1))
        unretired = [s for s, rec in sorted(recs.items())
                     if rec.get("t_retire") is None]
        tel = d.get("telemetry") or {}
        mono = d.get("mono_at_dump")
        newest = recs.get(last)
        age = None
        if newest is not None and isinstance(mono, (int, float)):
            t_ref = newest.get("t_retire") or newest.get("t_enqueue")
            if isinstance(t_ref, (int, float)):
                age = round(mono - t_ref, 3)
        report["last_seq"][str(r)] = last
        report["per_rank"][str(r)] = {
            "last_seq": last,
            "unretired": len(unretired),
            "first_unretired_seq": unretired[0] if unretired else None,
            "last_record_age_s": age,
            "phase": tel.get("phase"),
            "step": tel.get("step"),
            "reason": d.get("reason"),
        }

    ranks = sorted(by_rank)
    lasts = {r: int(report["last_seq"][str(r)]) for r in ranks}
    min_last, max_last = min(lasts.values()), max(lasts.values())
    report["lagging_ranks"] = [r for r in ranks if lasts[r] < max_last]

    # Content comparison over the window every ring still covers.
    window_lo = 0
    for r in ranks:
        if by_rank[r]:
            window_lo = max(window_lo, min(by_rank[r]))
    divergence, majority_rec = None, None
    for seq in range(window_lo, min_last + 1):
        recs = {r: by_rank[r].get(seq) for r in ranks}
        if any(rec is None for rec in recs.values()):
            continue  # evicted on some rank: nothing to compare
        sigs: Dict[Tuple, List[int]] = {}
        for r, rec in recs.items():
            sigs.setdefault(_signature(rec), []).append(r)
        if len(sigs) > 1:
            major_sig = max(sigs.items(), key=lambda kv: (len(kv[1]), -kv[1][0]))[0]
            divergence = seq
            majority_rec = recs[sigs[major_sig][0]]
            report["divergent_ranks"] = sorted(
                r for sig, rs in sigs.items() if sig != major_sig for r in rs
            )
            break

    if divergence is not None:
        report["first_divergence_seq"] = divergence
        report["verdict"] = "desync"
        report["blocked_on"] = _blocked_on(majority_rec)
        report["detail"] = (
            f"rank(s) {report['divergent_ranks']} issued a different "
            f"collective at seq {divergence}: the gang desynced at "
            f"{majority_rec.get('label')} (plan_version "
            f"{majority_rec.get('plan_version')})"
        )
        return report

    def _wedged(r: int) -> bool:
        pr = report["per_rank"][str(r)]
        return bool(pr["unretired"]) or pr["phase"] not in (None, "wait", "data")

    if report["lagging_ranks"]:
        # The collective the gang is blocked on: the first one the most-
        # lagging ranks have not issued, read from any advanced rank.
        behind = [r for r in ranks if lasts[r] == min_last]
        ahead = [r for r in ranks if lasts[r] > min_last]
        blocked = None
        for r in ahead:
            blocked = by_rank[r].get(min_last + 1)
            if blocked is not None:
                break
        if blocked is not None:
            report["blocked_on"] = _blocked_on(blocked)
        wedged = [r for r in behind if _wedged(r)]
        report["verdict"] = "host_wedge" if wedged else "straggler"
        who = wedged or behind
        report["detail"] = (
            f"rank(s) {who} stopped at seq {min_last} "
            f"({'host wedged mid-dispatch' if wedged else 'device lagging in wait'}); "
            f"gang blocked on "
            f"{report['blocked_on']['label'] if report['blocked_on'] else 'unknown'}"
        )
        return report

    # Aligned rings: a rank that never retired its newest dispatch is a
    # gang-wide host wedge; otherwise the rings show nothing wrong.
    wedged = [r for r in ranks if report["per_rank"][str(r)]["unretired"]]
    if wedged:
        r = wedged[0]
        first = report["per_rank"][str(r)]["first_unretired_seq"]
        report["verdict"] = "host_wedge"
        report["blocked_on"] = _blocked_on(by_rank[r][first])
        report["detail"] = (
            f"rank(s) {wedged} never retired seq {first}: host wedged inside "
            f"the dispatch window"
        )
        return report

    report["verdict"] = "healthy"
    report["detail"] = (
        f"all {len(ranks)} rings aligned through seq {max_last}; nothing to blame"
    )
    return report
