"""Render one ``perf_regression`` incident as a "why was step N slow" report.

The regression sentinel (``bagua_tpu_torch/observability/regression.py``) trips
online and emits a ``perf_regression`` JSONL event carrying the budget
attribution verdict: a named component partition of the
measured-minus-expected residual (compile / snapshot / host_data /
wire_slowdown / straggler / backpressure / unattributed) that sums to the
residual by construction.  This offline doctor joins that incident back
to everything else the observability stack recorded around it —

* the metrics JSONL itself: ``step`` walls around the incident,
  ``compile`` / ``snapshot`` / ``rpc_retry`` / ``health_alert`` events in
  the attribution window, the ``rebucket`` / ``precision_switch`` event
  that produced the incident's ``plan_version``, and the autopilot's
  answer — ``plan_decision`` rows citing this incident's ``trace_id``,
  each joined (by its post-switch ``plan_version``) to the switch event
  it dispatched;
* a span JSONL (``BAGUA_TRACE_PATH`` output), joined on the incident's
  ``trace_id`` — the RPCs in flight when the sentinel fired;
* flight-recorder dumps (``flight_<rank>.json``), when the hang forensics
  left any next to the incident — per-rank last phases corroborating a
  ``straggler`` verdict —

and renders a one-screen human report (stderr/stdout) plus an optional
JSON artifact.  Stdlib only; runnable from any cwd.

Usage::

    python -m bagua_tpu_torch.tools.perf_doctor --metrics metrics.jsonl              # latest
    python -m bagua_tpu_torch.tools.perf_doctor --metrics metrics.jsonl --step 1200
    python -m bagua_tpu_torch.tools.perf_doctor --metrics metrics.jsonl \
        --spans spans.jsonl --flight-dir dumps --out incident.json
    python -m bagua_tpu_torch.tools.perf_doctor --metrics metrics.jsonl --quarantine

``--quarantine`` flips the doctor to the fleet remediation side: instead
of one incident it joins the latest ``plan_quarantine`` verdict back to
the ``perf_regression`` incidents it cites (by ``trace_id``), the fleet
plan adoptions that exposed gangs to the bad plan, the per-gang
``rollback_plan`` remediation rows, and the plan's ``canary_verdict``
history — the full indict-then-remediate chain in one screen.
"""

import argparse
import glob as globlib
import json
import os
import sys
from typing import Dict, List, Optional


from bagua_tpu_torch.observability.metrics import (
    rotated_metrics_files,
    validate_metrics_event,
)

__all__ = [
    "load_events",
    "select_incident",
    "build_incident_report",
    "render_report",
    "select_quarantine",
    "build_quarantine_report",
    "render_quarantine_report",
]

#: how many steps on each side of the incident count as "around it"
CONTEXT_STEPS = 50


def load_events(paths) -> List[dict]:
    """Read metrics JSONL files (each expanded to its rotated set),
    keeping only schema-valid events — a torn tail line from a killed
    process must not sink the diagnosis."""
    events = []
    for base in paths:
        for path in rotated_metrics_files(base):
            try:
                f = open(path)
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
                    if not validate_metrics_event(ev):
                        events.append(ev)
    events.sort(key=lambda e: (e.get("ts") or 0.0))
    return events


def select_incident(events: List[dict], step: Optional[int] = None) -> Optional[dict]:
    """The ``perf_regression`` event to diagnose: the one at ``step``
    (exact match preferred, nearest otherwise) or the latest."""
    incidents = [e for e in events if e.get("event") == "perf_regression"]
    if not incidents:
        return None
    if step is None:
        return incidents[-1]
    exact = [e for e in incidents if e.get("step") == step]
    if exact:
        return exact[-1]
    return min(incidents, key=lambda e: abs(int(e.get("step", 0)) - step))


def _window(events: List[dict], kind: str, lo: int, hi: int) -> List[dict]:
    return [
        e for e in events
        if e.get("event") == kind and lo <= int(e.get("step", -1)) <= hi
    ]


def load_flight_phases(pattern: str) -> Dict[str, dict]:
    """Per-rank (last_seq, newest record label/phase) from any flight
    dumps next to the incident — the corroborating witness for a
    ``straggler`` verdict."""
    out: Dict[str, dict] = {}
    for path in sorted(globlib.glob(pattern)):
        try:
            with open(path) as f:
                dump = json.load(f)
        except (OSError, ValueError):
            continue
        records = dump.get("records") or []
        newest = records[-1] if records else {}
        out[str(dump.get("rank", -1))] = {
            "last_seq": dump.get("last_seq"),
            "label": newest.get("label"),
            "phase": newest.get("phase"),
        }
    return out


def load_trace_spans(paths, trace_id: str) -> List[dict]:
    """Spans from a trace JSONL belonging to the incident's trace."""
    if not trace_id:
        return []
    spans = []
    for path in paths:
        try:
            f = open(path)
        except OSError:
            continue
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    span = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if span.get("trace_id") == trace_id:
                    spans.append(span)
    spans.sort(key=lambda s: (s.get("ts") or 0.0))
    return spans


def build_incident_report(
    incident: dict,
    events: List[dict],
    spans: Optional[List[dict]] = None,
    flight: Optional[Dict[str, dict]] = None,
) -> dict:
    """Join one incident with its surrounding evidence into one dict."""
    step = int(incident.get("step", 0))
    lo, hi = step - CONTEXT_STEPS, step + CONTEXT_STEPS
    steps = _window(events, "step", lo, hi)
    walls = [float(e["wall_ms"]) for e in steps if "wall_ms" in e]
    baseline = sorted(walls)[len(walls) // 2] if walls else None

    plan_version = incident.get("plan_version")
    plan_event = None
    for e in events:
        if e.get("event") in ("rebucket", "precision_switch") and \
                e.get("plan_version") == plan_version:
            plan_event = e  # newest wins (events are ts-sorted)

    # the autopilot's answer to THIS incident: plan_decision rows citing the
    # incident's trace_id, plus the switch events each committed decision
    # produced (joined by the decision's post-switch plan_version)
    trace_id = str(incident.get("trace_id") or "")
    decisions = [
        e for e in events
        if e.get("event") == "plan_decision"
        and trace_id and e.get("trace_id") == trace_id
    ]
    decision_switches = []
    decision_versions = {d.get("plan_version") for d in decisions}
    for e in events:
        if e.get("event") in ("rebucket", "precision_switch") and \
                e.get("plan_version") in decision_versions:
            decision_switches.append(e)

    report = {
        "incident": incident,
        "step": step,
        "stream": incident.get("stream"),
        "dominant": incident.get("dominant"),
        "components": incident.get("components") or {},
        "residual_ms": incident.get("residual_ms"),
        "expected_ms": incident.get("expected_ms"),
        "measured_ms": incident.get("measured_ms"),
        "baseline_wall_ms": baseline,
        "context": {
            "steps": len(steps),
            "compiles": _window(events, "compile", lo, hi),
            "snapshots": _window(events, "snapshot", lo, hi),
            "rpc_retries": _window(events, "rpc_retry", lo, hi),
            "health_alerts": _window(events, "health_alert", lo, hi),
            "plan_event": plan_event,
        },
        "decisions": decisions,
        "decision_switches": decision_switches,
        "trace_spans": spans or [],
        "flight_by_rank": flight or {},
    }
    if "straggler_rank" in incident:
        report["straggler_rank"] = incident["straggler_rank"]
    if incident.get("axis"):
        report["axis"] = incident["axis"]
        if incident.get("link_class"):
            report["link_class"] = incident["link_class"]
        if incident.get("wire_axis_ms"):
            report["wire_axis_ms"] = incident["wire_axis_ms"]
    return report


def select_quarantine(events: List[dict]) -> Optional[dict]:
    """The ``plan_quarantine`` event to diagnose (the latest)."""
    quarantines = [e for e in events if e.get("event") == "plan_quarantine"]
    return quarantines[-1] if quarantines else None


def build_quarantine_report(
    quarantine: dict, events: List[dict]
) -> dict:
    """Join one fleet ``plan_quarantine`` verdict back to its evidence.

    The quarantine event names the indicting incidents by ``trace_id``
    (``cites``) and the quarantined plan by ``plan_version`` — this walks
    the same metrics stream and recovers the full causal chain:

    * the ``perf_regression`` incidents whose ``trace_id`` the quarantine
      cites — the indictment itself, with each incident's budget verdict;
    * the fleet-plan adoptions that exposed gangs to the bad plan:
      ``restart`` events with ``plan_source == "fleet"``;
    * the remediation engine's response: per-gang ``remediation`` rows
      whose reason carries this quarantine's ``plan_version``
      (``rollback_plan``), plus any other remediation actions nearby;
    * the plan's canary history: ``canary_verdict`` rows for the same
      ``plan_version`` — whether the plan graduated before it went bad.
    """
    plan_version = quarantine.get("plan_version")
    cites = set(quarantine.get("cites") or [])
    incidents = [
        e for e in events
        if e.get("event") == "perf_regression" and e.get("trace_id") in cites
    ]
    uncited = sorted(
        cites - {e.get("trace_id") for e in incidents}
    )  # cited but not in these metrics files — name them, don't hide them
    adoptions = [
        e for e in events
        if e.get("event") == "restart" and e.get("plan_source") == "fleet"
    ]
    version_tag = f"v{plan_version}"
    rollbacks = [
        e for e in events
        if e.get("event") == "remediation"
        and e.get("action") == "rollback_plan"
        and version_tag in str(e.get("reason") or "")
    ]
    other_remediations = [
        e for e in events
        if e.get("event") == "remediation" and e not in rollbacks
    ]
    canary = [
        e for e in events
        if e.get("event") == "canary_verdict"
        and e.get("plan_version") == plan_version
    ]
    return {
        "quarantine": quarantine,
        "cache_key": quarantine.get("cache_key"),
        "plan_version": plan_version,
        "cites": sorted(cites),
        "uncited_trace_ids": uncited,
        "incidents": incidents,
        "adoptions": adoptions,
        "rollbacks": rollbacks,
        "other_remediations": other_remediations,
        "canary_history": canary,
        "rolled_back_gangs": sorted(quarantine.get("gangs") or []),
    }


def render_quarantine_report(report: dict) -> str:
    """The human one-screen answer to "why was this plan quarantined"."""
    q = report["quarantine"]
    lines = [
        f"perf_doctor: plan {report.get('cache_key')} v"
        f"{report.get('plan_version')} was quarantined fleet-wide",
        f"  indicted by {len(report.get('cites') or [])} incident(s); "
        f"{len(report.get('rolled_back_gangs') or [])} adopter gang(s) "
        f"rolled back: {report.get('rolled_back_gangs')}",
    ]
    for inc in report.get("incidents") or []:
        lines.append(
            f"  incident {inc.get('trace_id')}: step {inc.get('step')} "
            f"regressed, dominant {inc.get('dominant')} "
            f"({_fmt_ms(inc.get('residual_ms'))} residual) under "
            f"plan_version {inc.get('plan_version')}"
        )
    for tid in report.get("uncited_trace_ids") or []:
        lines.append(f"  incident {tid}: cited by the quarantine but not "
                     "present in the given metrics files")
    for ad in report.get("adoptions") or []:
        lines.append(
            f"  adoption: restart at step {ad.get('step')} took the fleet "
            f"plan (world {ad.get('old_world_size')} -> "
            f"{ad.get('new_world_size')})"
        )
    for rb in report.get("rollbacks") or []:
        lines.append(
            f"  rollback directed at gang {rb.get('gang')} "
            f"[{rb.get('reason')}]"
        )
    for cv in report.get("canary_history") or []:
        lines.append(
            f"  canary history: {cv.get('verdict')} "
            f"({len(cv.get('clean') or [])}/{cv.get('needed')} clean) at "
            f"step {cv.get('step')}"
        )
    if q.get("ts"):
        lines.append(f"  quarantine recorded at ts {q['ts']}")
    return "\n".join(lines)


def _fmt_ms(v) -> str:
    return f"{float(v):.3f} ms" if isinstance(v, (int, float)) else "n/a"


#: per-component one-line explanations used in the rendered report
_COMPONENT_HINTS = {
    "compile": "XLA retrace walls charged to this window",
    "snapshot": "blocking state-snapshot walls",
    "host_data": "host/data time above its rolling baseline",
    "wire_slowdown": "wire time above the priced alpha-beta expectation",
    "straggler": "gang p50-over-median excess on one rank",
    "backpressure": "RPC retry/backoff sleeps",
    "unattributed": "residual no instrumented cause explains",
}


def render_report(report: dict) -> str:
    """The human one-screen answer to "why was step N slow"."""
    step = report["step"]
    lines = [
        f"perf_doctor: step {step} regressed on the "
        f"{report.get('stream')} stream",
        f"  measured {_fmt_ms(report.get('measured_ms'))}, expected "
        f"{_fmt_ms(report.get('expected_ms'))}, residual "
        f"{_fmt_ms(report.get('residual_ms'))}"
        + (f" (window median wall {_fmt_ms(report['baseline_wall_ms'])})"
           if report.get("baseline_wall_ms") is not None else ""),
        f"  dominant component: {report.get('dominant')}"
        + (f" on mesh axis {report['axis']}"
           + (f" [{report['link_class']}]" if report.get("link_class") else "")
           if report.get("axis") else ""),
        "  budget attribution (sums to residual by construction):",
    ]
    comps = report.get("components") or {}
    for name in sorted(comps, key=lambda n: -float(comps[n])):
        hint = _COMPONENT_HINTS.get(name, "")
        lines.append(f"    {name:>14}: {_fmt_ms(comps[name])}"
                     + (f"  — {hint}" if hint else ""))
    wam = report.get("wire_axis_ms") or {}
    if wam:
        lines.append("  wire slowdown by mesh axis "
                     "(sums to wire_slowdown by construction):")
        for ax in sorted(wam, key=lambda a: -float(wam[a])):
            lines.append(f"    {ax:>14}: {_fmt_ms(wam[ax])}")
    ctx = report.get("context") or {}
    if ctx.get("compiles"):
        steps = sorted({e.get("step") for e in ctx["compiles"]})
        lines.append(f"  evidence: {len(ctx['compiles'])} compile event(s) "
                     f"nearby (steps {steps})")
    if ctx.get("snapshots"):
        total = sum(float(e.get("wall_ms", 0.0)) for e in ctx["snapshots"])
        lines.append(f"  evidence: {len(ctx['snapshots'])} snapshot(s) "
                     f"nearby totalling {total:.1f} ms")
    if ctx.get("rpc_retries"):
        total = sum(float(e.get("delay_s", 0.0)) for e in ctx["rpc_retries"])
        lines.append(f"  evidence: {len(ctx['rpc_retries'])} rpc retry "
                     f"sleep(s) nearby totalling {total * 1e3:.1f} ms")
    if ctx.get("health_alerts"):
        kinds = sorted({e.get("kind") for e in ctx["health_alerts"]})
        lines.append(f"  evidence: health alerts nearby: {kinds}")
    if ctx.get("plan_event") is not None:
        pe = ctx["plan_event"]
        lines.append(
            f"  plan_version {report['incident'].get('plan_version')} came "
            f"from a {pe.get('event')} at step {pe.get('step')}"
        )
    for dec in report.get("decisions") or []:
        frm = dec.get("from_config") or {}
        to = dec.get("to_config") or {}
        lines.append(
            f"  autopilot answered: {dec.get('decision')} "
            f"{frm.get('algorithm')}/{frm.get('precision')} -> "
            f"{to.get('algorithm')}/{to.get('precision')} at step "
            f"{dec.get('step')} [{dec.get('verdict')}]"
        )
    for sw in report.get("decision_switches") or []:
        lines.append(
            f"  ... landing as a {sw.get('event')} at step {sw.get('step')} "
            f"(plan_version {sw.get('plan_version')})"
        )
    if "straggler_rank" in report and report["straggler_rank"] >= 0:
        lines.append(f"  sentinel attributes the window to rank "
                     f"{report['straggler_rank']}")
    for rank, ctx2 in sorted((report.get("flight_by_rank") or {}).items()):
        lines.append(
            f"  flight rank {rank}: last_seq {ctx2.get('last_seq')}, "
            f"newest record {ctx2.get('label')} (phase {ctx2.get('phase')})"
        )
    spans = report.get("trace_spans") or []
    if spans:
        lines.append(f"  trace {report['incident'].get('trace_id')}: "
                     f"{len(spans)} span(s) in flight:")
        for span in spans[:8]:
            lines.append(
                f"    {span.get('name')} "
                f"({_fmt_ms(span.get('dur_ms'))})"
            )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--metrics", action="append", default=[], required=True,
                    help="metrics JSONL file (repeatable; rotated set is "
                    "expanded automatically)")
    ap.add_argument("--step", type=int, default=None,
                    help="diagnose the incident at/nearest this step "
                    "(default: the latest incident)")
    ap.add_argument("--spans", action="append", default=[],
                    help="span JSONL to join on the incident trace_id "
                    "(repeatable)")
    ap.add_argument("--flight-dir", default=None,
                    help="directory holding flight_<rank>.json dumps")
    ap.add_argument("--flight-glob", default=None,
                    help="explicit glob for flight dumps (overrides "
                    "--flight-dir)")
    ap.add_argument("--quarantine", action="store_true",
                    help="diagnose the latest fleet plan_quarantine verdict "
                    "instead of a perf_regression incident")
    ap.add_argument("--out", default=None,
                    help="write the joined incident report JSON here")
    args = ap.parse_args(argv)

    events = load_events(args.metrics)
    if not events:
        print("perf_doctor: no valid events in the given metrics files",
              file=sys.stderr)
        return 2
    if args.quarantine:
        quarantine = select_quarantine(events)
        if quarantine is None:
            print("perf_doctor: no plan_quarantine events found "
                  "(did the remediation engine sweep?)", file=sys.stderr)
            return 2
        report = build_quarantine_report(quarantine, events)
        if args.out:
            tmp = f"{args.out}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(json.dumps(report, indent=2, sort_keys=True) + "\n")
            os.replace(tmp, args.out)
            print(f"perf_doctor: report written to {args.out}",
                  file=sys.stderr)
        print(render_quarantine_report(report))
        return 0
    incident = select_incident(events, args.step)
    if incident is None:
        print("perf_doctor: no perf_regression incidents found "
              "(is BAGUA_REGRESSION_SENTINEL on?)", file=sys.stderr)
        return 2

    spans = load_trace_spans(args.spans, str(incident.get("trace_id") or ""))
    flight = {}
    pattern = args.flight_glob or (
        os.path.join(args.flight_dir, "flight_*.json")
        if args.flight_dir else None
    )
    if pattern:
        flight = load_flight_phases(pattern)

    report = build_incident_report(incident, events, spans, flight)
    if args.out:
        tmp = f"{args.out}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(json.dumps(report, indent=2, sort_keys=True) + "\n")
        os.replace(tmp, args.out)
        print(f"perf_doctor: report written to {args.out}", file=sys.stderr)
    print(render_report(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
