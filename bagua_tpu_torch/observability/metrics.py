"""Structured metrics: counters/gauges/histograms, JSONL events, Prometheus.

The reference fed its autotuner from an OTel span pipeline
(``bagua-opentelemetry``) and logged speed through ``StatisticalAverage``;
production training jobs additionally need *exportable* per-step evidence — a
metrics registry a dashboard can scrape and an append-only event stream a
post-mortem can replay.  Everything here is host-side, stdlib-only and
thread-safe; nothing touches the step's tensors.

* :class:`MetricsRegistry` — named counters, gauges and ring-buffer
  histograms (p50/p95/p99), exportable as a plain dict snapshot or in the
  Prometheus text exposition format (the *textfile-collector* pattern:
  write a ``.prom`` file, let node_exporter scrape it — no HTTP server in
  the training process).
* :class:`JsonlSink` — one JSON object per line, schema-checked by
  :func:`validate_metrics_event` (the CI lane validates every emitted
  event, see ``ci/perf_audit.py --quick``).
"""

import json
import math
import os
import threading
import time
from typing import Dict, IO, List, Optional, Union

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "JsonlSink",
    "MetricsRegistry",
    "rotated_metrics_files",
    "validate_metrics_event",
    "validate_switch_reason",
    "switch_reason_family",
    "EVENT_REQUIRED_FIELDS",
    "SWITCH_REASON_FAMILIES",
]


class Counter:
    """Monotonic counter."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._lock = threading.Lock()
        self.value: Union[int, float] = 0

    def inc(self, amount: Union[int, float] = 1) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {amount})")
        with self._lock:
            self.value += amount


class Gauge:
    """Last-write-wins scalar."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value: float = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Ring-buffer histogram: O(1) observe, percentiles over the last
    ``window`` observations (recent-tail semantics — a 10-hour job's p99
    should reflect the last minutes, not hour one)."""

    def __init__(self, name: str, help: str = "", window: int = 1024):
        self.name, self.help = name, help
        self._lock = threading.Lock()
        self._ring: List[float] = [0.0] * max(1, window)
        self._n = 0
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        with self._lock:
            self._ring[self._n % len(self._ring)] = float(value)
            self._n += 1
            self.count += 1
            self.sum += float(value)

    def percentiles(self) -> Dict[str, float]:
        """Nearest-rank percentiles (the p-th is the ``ceil(p*n)``-th
        smallest sample — same indexing as ``StepTimer.percentiles``; the
        old ``int(p*n)`` truncation biased small rings high, returning the
        max as the p50 of a 2-sample ring)."""
        with self._lock:
            n = min(self._n, len(self._ring))
            recent = sorted(self._ring[:n]) if n else []
        if not recent:
            return {}
        def q(p):
            n = len(recent)
            return recent[min(n - 1, max(0, math.ceil(p * n) - 1))]
        return {"p50": q(0.50), "p95": q(0.95), "p99": q(0.99)}


def _prom_name(name: str) -> str:
    """Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    out = "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)
    return out if out and not out[0].isdigit() else "_" + out


class MetricsRegistry:
    """Create-on-first-use registry of named metrics.

    ``registry.counter("steps_total").inc()`` — the same name always
    returns the same instrument; mixing kinds under one name raises.
    """

    def __init__(self, prefix: str = "bagua"):
        self.prefix = prefix
        self._lock = threading.Lock()
        self._metrics: Dict[str, Union[Counter, Gauge, Histogram]] = {}

    def _get(self, name: str, kind, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = kind(name, **kwargs)
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} already registered as {type(m).__name__}, "
                    f"requested {kind.__name__}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "", window: int = 1024) -> Histogram:
        return self._get(name, Histogram, help=help, window=window)

    def snapshot(self) -> Dict:
        """Plain-dict view: counters/gauges as scalars, histograms as
        ``{count, sum, p50, p95, p99}``."""
        with self._lock:
            metrics = dict(self._metrics)
        out: Dict = {}
        for name, m in sorted(metrics.items()):
            if isinstance(m, Histogram):
                out[name] = {"count": m.count, "sum": round(m.sum, 6), **m.percentiles()}
            else:
                out[name] = m.value
        return out

    # -- Prometheus text exposition ------------------------------------------

    #: ring-buffer percentile -> Prometheus summary quantile label
    _QUANTILE_LABELS = (("p50", "0.5"), ("p95", "0.95"), ("p99", "0.99"))

    def to_prometheus(self) -> str:
        """The text exposition format (one family per metric; histograms as
        conformant summaries: ``name{quantile="0.5|0.95|0.99"}`` series
        followed by ``name_count``/``name_sum`` — quantile summaries
        without the streaming-quantile machinery)."""
        with self._lock:
            metrics = dict(self._metrics)
        lines = []
        for name, m in sorted(metrics.items()):
            full = _prom_name(f"{self.prefix}_{name}")
            if m.help:
                lines.append(f"# HELP {full} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {full} counter")
                lines.append(f"{full} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {full} gauge")
                lines.append(f"{full} {m.value}")
            else:
                lines.append(f"# TYPE {full} summary")
                pct = m.percentiles()
                for key, q in self._QUANTILE_LABELS:
                    if key in pct:
                        lines.append(f'{full}{{quantile="{q}"}} {pct[key]}')
                lines.append(f"{full}_count {m.count}")
                lines.append(f"{full}_sum {m.sum}")
        return "\n".join(lines) + "\n"

    def write_prometheus(self, path: str) -> None:
        """Atomic textfile export (write-then-rename so a scraper never
        reads a torn file — the node_exporter textfile-collector contract)."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.to_prometheus())
        os.replace(tmp, path)


#: every JSONL event must carry these (the CI schema gate)
EVENT_REQUIRED_FIELDS = {"ts": (int, float), "event": str, "step": int}

#: per-event-type required payload fields
EVENT_PAYLOAD_FIELDS = {
    "step": {
        "wall_ms": (int, float),
        "samples_per_s": (int, float),
        "wire_bytes": int,
        "variant": str,
    },
    "compile": {"variant": str, "retrace": bool},
    "retrace_alert": {"retraces": int, "window": int},
    # one bucket-plan swap adopted by the engine (autotune re-bucket, or an
    # algorithm switch — ``algorithm`` then rides as an optional extra);
    # reason speaks the unified switch vocabulary (validate_switch_reason);
    # predicted/measured exposed-comm ms ride as optional fields
    "rebucket": {"plan_version": int, "n_buckets": int, "reason": str},
    # one async/final state snapshot written by the resilience subsystem
    # (kind: "async" = cadenced background write, "final" = preemption drain)
    "snapshot": {"wall_ms": (int, float), "bytes": int, "kind": str},
    # one elastic resume: the gang restarted from a snapshot (step = the
    # resumed-from step; lost_steps = steps the previous incarnation ran
    # past it, 0 for a drained preemption exit)
    "restart": {
        "old_world_size": int,
        "new_world_size": int,
        "plan_source": str,
        "lost_steps": int,
    },
    # the engine adopted a new per-bucket wire-precision plan (planner-driven
    # under wire_precision="auto", or an operator override): before/after
    # per-bucket precisions plus who asked for the change
    "precision_switch": {
        "plan_version": int,
        "old_precisions": list,
        "new_precisions": list,
        "reason": str,
    },
    # the engine re-bounded the staleness knob (autopilot degradation, the
    # HealthMonitor convergence guardrail tightening tau to 0, or a
    # stabilization re-promotion): before/after bound plus who asked
    "staleness_switch": {
        "plan_version": int,
        "old_tau": int,
        "new_tau": int,
        "reason": str,
    },
    # the health monitor detected an anomaly (kind: loss_spike /
    # grad_norm_explosion / nonfinite); actions lists the registered
    # correctives that reported applying (e.g. precision_demotion)
    "health_alert": {
        "kind": str,
        "value": (int, float),
        "threshold": (int, float),
        "actions": list,
    },
    # the watchdog declared this rank hung (reason: watchdog_timeout /
    # sigterm); emitted + flushed BEFORE any exit path runs, so the event
    # survives the process kill.  Optional extras: dumps (the evidence file
    # paths) and flight_last_seq (the flight recorder's newest sequence
    # number, joining this event to the per-rank flight dump).
    "hang": {
        "reason": str,
        "last_phase": str,
    },
    # one retry_call backoff sleep (resilience/retry.py): the attempt that
    # failed, the delay about to be slept, and why (reason: "backpressure"
    # when a 429 Retry-After hint shaped the delay, "error" otherwise).
    # Optional extras: retry_after_s (the server's hint) and trace_id /
    # span_id when a trace is active.
    "rpc_retry": {
        "endpoint": str,
        "attempt": int,
        "delay_s": (int, float),
        "reason": str,
    },
    # one circuit-breaker state change (resilience/retry.py): states are
    # closed / half-open / open; step is the hub's last known step (-1
    # before the first step — breakers guard out-of-step RPC paths too)
    "breaker_transition": {
        "breaker": str,
        "old_state": str,
        "new_state": str,
    },
    # the regression sentinel tripped (observability/regression.py): the
    # CUSUM stream that fired ("step_wall" / "goodput"), the budget
    # attribution verdict over the recent window — components is the full
    # named partition summing to residual_ms by construction, dominant its
    # largest member — plus the live plan_version and the active trace_id
    # ("" with tracing off).  Optional extra: straggler_rank when the gang
    # aggregator attributed the window to a specific rank.
    "perf_regression": {
        "stream": str,
        "dominant": str,
        "components": dict,
        "residual_ms": (int, float),
        "expected_ms": (int, float),
        "measured_ms": (int, float),
        "plan_version": int,
        "trace_id": str,
    },
    # one autopilot policy decision (autopilot/controller.py): what the
    # controller decided (decision: demote_precision / repromote_precision /
    # switch_algorithm / rollback / hold), why (reason: the validated switch
    # vocabulary, e.g. "autopilot:wire_slowdown"), the triggering incident's
    # trace_id ("" when health- rather than incident-driven), the engine's
    # plan_version AFTER the action, the before/after configuration dicts,
    # and the verdict of the canary protocol (canary / committed /
    # rolled_back / held / rejected).  Optional extra: modeled — the α–β
    # priced step-ms of the stay-put vs chosen configuration.
    "plan_decision": {
        "decision": str,
        "reason": str,
        "trace_id": str,
        "plan_version": int,
        "from_config": dict,
        "to_config": dict,
        "verdict": str,
    },
    # the fleet RemediationEngine quarantined a cached plan: its cache key
    # and plan_version, the indicting incidents' trace_ids (cites), the
    # regressed adopter gangs that indicted it, and the action taken
    # (quarantine — rollback directives to every adopter ride as separate
    # ``remediation`` events)
    "plan_quarantine": {
        "cache_key": str,
        "plan_version": int,
        "cites": list,
        "gangs": list,
        "action": str,
    },
    # one fleet remediation action directed at a gang (action: resize /
    # rollback_plan / ...), with the hang/quarantine verdict that drove it
    "remediation": {
        "action": str,
        "gang": str,
        "reason": str,
    },
    # one canary-lifecycle transition for a cached plan (verdict: clean =
    # an adopter reported a clean window; graduated = the plan was promoted
    # to default after ``needed`` clean adopters)
    "canary_verdict": {
        "cache_key": str,
        "plan_version": int,
        "verdict": str,
        "clean": list,
        "needed": int,
    },
}

#: the unified ``reason`` vocabulary every configuration switch
#: (``apply_precision_plan`` / ``rebucket`` / ``switch_algorithm``) and every
#: ``plan_decision`` event must speak: who asked for the change.
#: ``planner`` and ``manual`` are bare; ``health`` and ``autopilot`` carry a
#: mandatory ``:<detail>`` suffix naming the alert kind / incident dominant.
SWITCH_REASON_FAMILIES = ("planner", "health", "autopilot", "manual")


def validate_switch_reason(reason: str) -> str:
    """Validate a configuration-switch ``reason`` against the unified
    vocabulary (``planner | health:<kind> | autopilot:<incident> | manual``)
    and return it unchanged.  Raises ValueError on anything else — a
    free-text reason is a bug at the switch site, not something the
    timeline joiners should have to fuzzy-match."""
    reason = str(reason)
    family, sep, detail = reason.partition(":")
    if family not in SWITCH_REASON_FAMILIES:
        raise ValueError(
            f"switch reason {reason!r} is not in the validated vocabulary "
            f"(families: {'|'.join(SWITCH_REASON_FAMILIES)})"
        )
    if family in ("health", "autopilot") and not detail:
        raise ValueError(
            f"switch reason {reason!r} needs a detail suffix "
            f"({family}:<{'kind' if family == 'health' else 'incident'}>)"
        )
    if family in ("planner", "manual") and sep:
        raise ValueError(
            f"switch reason {reason!r} must be bare ({family!r} takes no "
            "detail suffix)"
        )
    return reason


def switch_reason_family(reason: str) -> str:
    """The vocabulary family of a (validated) switch reason — the label the
    per-family Prometheus counters aggregate on."""
    return str(reason).partition(":")[0]


def validate_metrics_event(event: Dict) -> List[str]:
    """Schema-check one JSONL event; returns a list of problems (empty =
    valid).  Unknown event types only need the required envelope."""
    problems = []
    if not isinstance(event, dict):
        return [f"event is {type(event).__name__}, not an object"]
    for field, types in EVENT_REQUIRED_FIELDS.items():
        if field not in event:
            problems.append(f"missing required field {field!r}")
        elif not isinstance(event[field], types):
            problems.append(
                f"field {field!r} is {type(event[field]).__name__}, expected {types}"
            )
    for field, types in EVENT_PAYLOAD_FIELDS.get(event.get("event", ""), {}).items():
        if field not in event:
            problems.append(f"{event.get('event')} event missing field {field!r}")
        elif not isinstance(event[field], types):
            problems.append(
                f"field {field!r} is {type(event[field]).__name__}, expected {types}"
            )
    return problems


class JsonlSink:
    """Append-only JSONL event stream (one flat JSON object per line).

    Events are validated on emit; an invalid event raises immediately —
    a malformed stream is a bug at the emit site, not something a reader
    should have to defend against.

    Long jobs can bound the file with size-based rotation: when
    ``max_bytes`` (default: ``BAGUA_METRICS_MAX_MB`` MiB; unset/0 = off)
    would be exceeded, the live file is atomically renamed to ``path.N``
    (``.1`` oldest) and a fresh ``path`` is opened — no line is ever split
    across files, and :func:`validate_metrics_file` validates the whole
    rotated set."""

    def __init__(self, path: str, max_bytes: Optional[int] = None):
        if max_bytes is None:
            from bagua_tpu_torch.env import get_metrics_max_mb

            mb = get_metrics_max_mb()
            max_bytes = int(mb * (1 << 20)) if mb > 0 else 0
        self.path = path
        self.max_bytes = max(0, int(max_bytes))
        self._lock = threading.Lock()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._f: Optional[IO] = open(path, "a")

    def _rotate_locked(self) -> None:
        assert self._f is not None
        self._f.close()
        suffixes = [0]
        base = os.path.basename(self.path)
        d = os.path.dirname(os.path.abspath(self.path))
        for entry in os.listdir(d):
            if entry.startswith(base + "."):
                tail = entry[len(base) + 1:]
                if tail.isdigit():
                    suffixes.append(int(tail))
        os.replace(self.path, f"{self.path}.{max(suffixes) + 1}")
        self._f = open(self.path, "a")

    def emit(self, event: Dict) -> None:
        event.setdefault("ts", time.time())
        problems = validate_metrics_event(event)
        if problems:
            raise ValueError(f"invalid metrics event {event!r}: {problems}")
        line = json.dumps(event, sort_keys=True)
        with self._lock:
            if self._f is None:
                raise ValueError(f"JsonlSink({self.path}) is closed")
            if (
                self.max_bytes
                and self._f.tell() > 0
                and self._f.tell() + len(line) + 1 > self.max_bytes
            ):
                self._rotate_locked()
            self._f.write(line + "\n")
            self._f.flush()

    def flush(self) -> None:
        """Push buffered lines to the OS (emit already flushes per line;
        this is the teardown-path belt-and-suspenders).  No-op when closed."""
        with self._lock:
            if self._f is not None:
                self._f.flush()
                os.fsync(self._f.fileno())

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def rotated_metrics_files(path: str) -> List[str]:
    """The rotated set a :class:`JsonlSink` at ``path`` may have produced,
    oldest first: ``path.1``, ``path.2``, ..., then the live ``path``.
    Just ``[path]`` when rotation never fired."""
    base = os.path.basename(path)
    d = os.path.dirname(os.path.abspath(path))
    suffixes = []
    if os.path.isdir(d):
        for entry in os.listdir(d):
            if entry.startswith(base + "."):
                tail = entry[len(base) + 1:]
                if tail.isdigit():
                    suffixes.append(int(tail))
    out = [f"{path}.{n}" for n in sorted(suffixes)]
    out.append(path)
    return out


def validate_metrics_file(path: str) -> List[str]:
    """Validate every line of a JSONL metrics file — including any rotated
    ``path.N`` segments the sink produced — returning problems with line
    numbers (empty = the whole stream is schema-clean).  Problems in a
    rotated segment are prefixed with its basename."""
    problems = []
    files = [p for p in rotated_metrics_files(path) if os.path.exists(p)]
    if not files:
        files = [path]  # surface the FileNotFoundError from open()
    for fp in files:
        tag = "" if len(files) == 1 else f"{os.path.basename(fp)} "
        with open(fp) as f:
            for i, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    event = json.loads(line)
                except json.JSONDecodeError as e:
                    problems.append(f"{tag}line {i}: not JSON ({e})")
                    continue
                problems += [
                    f"{tag}line {i}: {p}" for p in validate_metrics_event(event)
                ]
    return problems
