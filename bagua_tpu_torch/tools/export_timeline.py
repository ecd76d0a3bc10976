"""Render bagua spans / fleet timelines as Chrome trace-event JSON.

Takes any mix of the tracing subsystem's outputs —

* a local span JSONL (``BAGUA_TRACE_PATH``: one ``bagua.span.v1`` object
  per line),
* a ``/fleet/timeline`` response saved to a file (``FleetClient.timeline``
  / ``curl``), which carries client spans, server spans and timeline
  events for one gang,
* or a live fleet endpoint + gang id to fetch that timeline directly —

and renders one Chrome trace-event file (``{"traceEvents": [...]}``) that
opens in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.  The
mapping:

* each finished span → an ``X`` (complete) event; ``pid`` is the span's
  service (trainer / fleet-server), ``tid`` its rank (or the gang for
  server spans), with ``M`` metadata rows naming both;
* each parent→child span link → an ``s``/``f`` flow pair, so the
  cross-process hop (client span on the trainer → server span on the
  fleet) renders as an arrow across the process tracks;
* span annotations (retries, backpressure hints, breaker transitions)
  and ingested timeline events → ``i`` (instant) events on the owning
  track;
* ``perf_regression`` incidents — from a metrics JSONL (``--metrics``) or
  riding a ``/fleet/timeline`` response as ``"item": "incident"`` rows —
  → ``i`` instants named ``perf_regression:<dominant>`` carrying the full
  budget-component partition in ``args``, so the regression verdict lands
  on the same Perfetto canvas as the spans it indicts;
* autopilot ``plan_decision`` events (metrics JSONL or ``"item":
  "decision"`` timeline rows) → ``i`` instants named
  ``plan_decision:<decision>`` with the from/to configuration, verdict and
  the triggering incident's ``trace_id`` in ``args`` — incident and
  response visible on the same canvas;
* fleet remediation events — ``plan_quarantine`` / ``remediation`` /
  ``canary_verdict`` rows the remediation engine pushed into gang
  timelines — → ``i`` instants named ``plan_quarantine:v<version>``,
  ``remediation:<action>`` and ``canary_verdict:<verdict>`` (cat
  ``remediation``), carrying the indicting incidents' ``cites``, the
  rolled-back gangs and the canary cohort progress in ``args``.

:func:`validate_chrome_trace` schema-checks the output — the CI tracing
lane gates on it.  Stdlib only.

Usage::

    python -m bagua_tpu_torch.tools.export_timeline --spans spans.jsonl --out trace.json
    python -m bagua_tpu_torch.tools.export_timeline --timeline timeline.json --out trace.json
    python -m bagua_tpu_torch.tools.export_timeline --spans spans.jsonl \
        --metrics metrics.jsonl --out trace.json
    python -m bagua_tpu_torch.tools.export_timeline --endpoint 127.0.0.1:29500 --gang g0 \
        --out trace.json
"""

import argparse
import json
import os
import sys
from typing import Dict, List, Optional


from bagua_tpu_torch.observability.tracing import validate_span

__all__ = [
    "load_span_jsonl",
    "load_metrics_incidents",
    "spans_to_trace_events",
    "build_chrome_trace",
    "validate_chrome_trace",
]


def load_span_jsonl(path: str) -> List[dict]:
    """Read a span JSONL file, keeping only schema-valid spans (a torn
    tail line from a killed process must not sink the whole export)."""
    spans = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                span = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not validate_span(span):
                spans.append(span)
    return spans


def load_timeline(payload: dict) -> "tuple[List[dict], List[dict]]":
    """Split a ``/fleet/timeline`` response into (spans, events)."""
    spans, events = [], []
    for item in payload.get("items", []):
        kind = item.get("item")
        if kind in ("client_span", "server_span"):
            span = {k: v for k, v in item.items() if k != "item"}
            if not validate_span(span):
                spans.append(span)
        elif kind in ("event", "incident", "decision"):
            # incident/decision rows are perf_regression / plan_decision
            # events the gang pushed to the fleet's volatile rings — same
            # instant rendering
            events.append({k: v for k, v in item.items() if k != "item"})
    return spans, events


#: metrics-JSONL event kinds that render as timeline instants
_ANNOTATION_EVENTS = (
    "perf_regression",
    "plan_decision",
    "plan_quarantine",
    "remediation",
    "canary_verdict",
)


def load_metrics_incidents(path: str) -> List[dict]:
    """The annotation events from a metrics JSONL (rotated set included) —
    ``perf_regression`` incidents and autopilot ``plan_decision`` rows
    become instants on the timeline, joined to each other by
    ``trace_id``."""
    from bagua_tpu_torch.observability.metrics import (
        rotated_metrics_files, validate_metrics_event,
    )

    incidents = []
    for part in rotated_metrics_files(path):
        try:
            f = open(part)
        except OSError:
            continue
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if ev.get("event") in _ANNOTATION_EVENTS and \
                        not validate_metrics_event(ev):
                    incidents.append(ev)
    return incidents


def _track(span: dict) -> "tuple[str, str]":
    """(process, thread) track for a span: service / rank-or-gang."""
    attrs = span.get("attrs") or {}
    service = str(attrs.get("service") or "unknown")
    if "rank" in attrs:
        thread = f"rank{attrs['rank']}"
    elif "gang" in attrs:
        thread = f"gang:{attrs['gang']}"
    else:
        thread = "main"
    return service, thread


class _TrackIds:
    """Stable small integer pid/tid per (service, thread) track, with the
    ``M`` metadata rows Perfetto names the tracks from."""

    def __init__(self):
        self._pids: Dict[str, int] = {}
        self._tids: Dict[tuple, int] = {}
        self.metadata: List[dict] = []

    def resolve(self, service: str, thread: str) -> "tuple[int, int]":
        pid = self._pids.get(service)
        if pid is None:
            pid = self._pids[service] = len(self._pids) + 1
            self.metadata.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": service},
            })
        tid = self._tids.get((service, thread))
        if tid is None:
            tid = self._tids[(service, thread)] = (
                sum(1 for s, _ in self._tids if s == service) + 1
            )
            self.metadata.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": thread},
            })
        return pid, tid


def spans_to_trace_events(
    spans: List[dict], events: Optional[List[dict]] = None
) -> List[dict]:
    """The core mapping: spans → X events (+ i for annotations), parent
    links → s/f flow pairs, loose timeline events → i events."""
    tracks = _TrackIds()
    out: List[dict] = []
    by_id: Dict[str, dict] = {}
    placed: Dict[str, "tuple[int, int]"] = {}  # span_id -> (pid, tid)
    for span in spans:
        by_id[span["span_id"]] = span
    for span in spans:
        pid, tid = tracks.resolve(*_track(span))
        placed[span["span_id"]] = (pid, tid)
        ts_us = float(span["ts"]) * 1e6
        dur_us = max(0.0, float(span.get("dur_ms") or 0.0)) * 1e3
        out.append({
            "ph": "X", "name": span["name"],
            "cat": span.get("kind", "internal"),
            "ts": round(ts_us, 3), "dur": round(dur_us, 3),
            "pid": pid, "tid": tid,
            "args": {
                "trace_id": span["trace_id"], "span_id": span["span_id"],
                **({"parent_id": span["parent_id"]} if span.get("parent_id") else {}),
                **(span.get("attrs") or {}),
            },
        })
        for ann in span.get("annotations") or []:
            out.append({
                "ph": "i", "name": ann.get("name", "annotation"),
                "cat": "annotation", "s": "t",
                "ts": round(float(ann.get("ts") or span["ts"]) * 1e6, 3),
                "pid": pid, "tid": tid,
                "args": {k: v for k, v in ann.items() if k not in ("name", "ts")},
            })
    # flow arrows for every resolvable parent→child link (the cross-pid
    # ones are the point, but intra-pid arrows don't hurt)
    flow = 0
    for span in spans:
        parent = by_id.get(span.get("parent_id") or "")
        if parent is None:
            continue
        flow += 1
        ppid, ptid = placed[parent["span_id"]]
        cpid, ctid = placed[span["span_id"]]
        start_us = float(parent["ts"]) * 1e6
        out.append({
            "ph": "s", "id": flow, "name": "span_link", "cat": "flow",
            "ts": round(start_us, 3), "pid": ppid, "tid": ptid,
        })
        out.append({
            "ph": "f", "id": flow, "name": "span_link", "cat": "flow",
            "bp": "e", "ts": round(float(span["ts"]) * 1e6, 3),
            "pid": cpid, "tid": ctid,
        })
    for ev in events or []:
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        name = str(ev.get("event") or "event")
        cat = "event"
        if name == "perf_regression":
            # the sentinel's verdict IS the headline: put the dominant
            # budget component in the instant's name so the Perfetto track
            # reads perf_regression:compile / :wire_slowdown / ... at a
            # glance, with the full partition in args
            name = f"perf_regression:{ev.get('dominant') or 'unattributed'}"
            if ev.get("axis"):
                # axis-resolved incidents headline the indicted mesh axis
                # and its link class: perf_regression:wire_slowdown@tp[ici]
                name += f"@{ev['axis']}"
                if ev.get("link_class"):
                    name += f"[{ev['link_class']}]"
            cat = "incident"
        elif name == "plan_decision":
            # same treatment for the autopilot: the decision kind headlines
            # (plan_decision:demote_precision / :switch_algorithm / ...),
            # from/to configs + verdict + citing trace_id ride in args
            name = f"plan_decision:{ev.get('decision') or 'unknown'}"
            cat = "decision"
        elif name == "plan_quarantine":
            # fleet remediation verdicts render like autopilot decisions:
            # the quarantined plan version headlines, the indicting
            # incidents' trace_ids (cites) + rolled-back gangs ride in args
            name = f"plan_quarantine:v{ev.get('plan_version')}"
            cat = "remediation"
        elif name == "remediation":
            # per-gang remediation actions (rollback_plan / resize / ...)
            name = f"remediation:{ev.get('action') or 'unknown'}"
            cat = "remediation"
        elif name == "canary_verdict":
            # canary cohort progress: clean adopter windows and the
            # graduation instant, joined to the plan by plan_version
            name = f"canary_verdict:{ev.get('verdict') or 'unknown'}"
            cat = "remediation"
        pid, tid = tracks.resolve("events", name)
        out.append({
            "ph": "i", "name": name,
            "cat": cat, "s": "t", "ts": round(float(ts) * 1e6, 3),
            "pid": pid, "tid": tid,
            "args": {k: v for k, v in ev.items() if k not in ("event", "ts")},
        })
    return tracks.metadata + out


def build_chrome_trace(
    spans: List[dict], events: Optional[List[dict]] = None
) -> dict:
    return {
        "traceEvents": spans_to_trace_events(spans, events),
        "displayTimeUnit": "ms",
    }


#: event phases the exporter emits, with their required extra fields
_PHASE_FIELDS = {
    "X": ("dur",),
    "M": ("args",),
    "i": ("s",),
    "s": ("id",),
    "f": ("id",),
}


def validate_chrome_trace(trace: dict) -> List[str]:
    """Schema-check a Chrome trace-event JSON object (the subset this
    exporter emits); returns problems (empty = valid)."""
    problems = []
    if not isinstance(trace, dict):
        return [f"trace is {type(trace).__name__}, not an object"]
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PHASE_FIELDS:
            problems.append(f"event {i}: unknown phase {ph!r}")
            continue
        for field in ("name", "pid", "tid") + _PHASE_FIELDS[ph]:
            if field not in ev:
                problems.append(f"event {i} (ph={ph}): missing {field!r}")
        if ph != "M" and not isinstance(ev.get("ts"), (int, float)):
            problems.append(f"event {i} (ph={ph}): missing numeric ts")
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            problems.append(f"event {i}: X event dur not numeric")
    # every flow start must have a matching finish (a dangling arrow
    # renders as nothing in Perfetto — catch it here)
    starts = {e.get("id") for e in events if isinstance(e, dict) and e.get("ph") == "s"}
    ends = {e.get("id") for e in events if isinstance(e, dict) and e.get("ph") == "f"}
    if starts != ends:
        problems.append(f"unmatched flow ids: starts-only {sorted(starts - ends)}, "
                        f"ends-only {sorted(ends - starts)}")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spans", action="append", default=[],
                    help="span JSONL file (repeatable; BAGUA_TRACE_PATH output)")
    ap.add_argument("--timeline", action="append", default=[],
                    help="saved /fleet/timeline JSON response (repeatable)")
    ap.add_argument("--metrics", action="append", default=[],
                    help="metrics JSONL whose perf_regression incidents "
                    "become annotation instants (repeatable)")
    ap.add_argument("--endpoint", default=None,
                    help="live fleet endpoint (host:port) to fetch --gang from")
    ap.add_argument("--gang", default=None,
                    help="gang id to fetch from --endpoint")
    ap.add_argument("--out", default=None,
                    help="write the Chrome trace JSON here (default: stdout)")
    args = ap.parse_args(argv)

    spans: List[dict] = []
    events: List[dict] = []
    for path in args.spans:
        spans.extend(load_span_jsonl(path))
    for path in args.timeline:
        with open(path) as f:
            tl_spans, tl_events = load_timeline(json.load(f))
        spans.extend(tl_spans)
        events.extend(tl_events)
    for path in args.metrics:
        events.extend(load_metrics_incidents(path))
    if args.endpoint:
        if not args.gang:
            print("export_timeline: --endpoint requires --gang", file=sys.stderr)
            return 2
        from bagua_tpu_torch.fleet.client import FleetClient

        tl_spans, tl_events = load_timeline(
            FleetClient(args.endpoint).timeline(args.gang)
        )
        spans.extend(tl_spans)
        events.extend(tl_events)
    if not spans and not events:
        print("export_timeline: no spans or events to export", file=sys.stderr)
        return 2

    # a span can arrive twice (local JSONL + pushed to the fleet): dedup
    seen = set()
    unique = []
    for span in spans:
        if span["span_id"] in seen:
            continue
        seen.add(span["span_id"])
        unique.append(span)

    trace = build_chrome_trace(unique, events)
    problems = validate_chrome_trace(trace)
    if problems:
        print("export_timeline: internal error — output failed its own "
              f"schema: {'; '.join(problems[:5])}", file=sys.stderr)
        return 3
    text = json.dumps(trace, sort_keys=True)
    if args.out:
        tmp = f"{args.out}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(text + "\n")
        os.replace(tmp, args.out)
        n_x = sum(1 for e in trace["traceEvents"] if e.get("ph") == "X")
        print(f"export_timeline: {n_x} spans -> {args.out} "
              "(open in https://ui.perfetto.dev)", file=sys.stderr)
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
