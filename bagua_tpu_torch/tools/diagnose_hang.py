"""Join per-rank flight-recorder dumps into a hang report.

When a gang hangs, every rank's watchdog (or SIGTERM drain) leaves a
``flight_<rank>.json`` black-box dump: the ring of sequence-numbered
collective records the host dispatch path issued, plus thread stacks and
the telemetry snapshot.  This analyzer joins those rings offline and
answers the three questions an on-call actually has:

1. **Where did the gang first diverge?** — the first sequence number at
   which ring contents disagree (a skipped or extra collective on some
   rank), with the divergent rank set.
2. **What is the gang blocked on?** — the exact collective (scope label,
   bucket index, phase, plan_version) the lagging ranks never issued or
   never retired.
3. **What kind of failure is it?** — a ``desync`` (programs differ),
   ``straggler`` (identical programs, some ranks behind, the laggard
   parked in a benign phase) or ``host_wedge`` (unretired records / a rank
   stuck mid-dispatch) verdict, from per-record enqueue/retire deltas.

The output is a schema-validated ``hang_report``
(``bagua.hang_report.v1`` — see
:func:`bagua_tpu_torch.observability.flight_recorder.validate_hang_report`).
Invalid input dumps are skipped with a warning; an invalid *report* (or no
usable dumps at all) exits non-zero so CI lanes can gate on it.

When the regression sentinel was on, its ``perf_regression`` incidents
usually land in a metrics JSONL next to the dumps; the analyzer folds any
it finds into the report (``incidents`` extra field), and when both the
flight forensics and the sentinel point at the same rank — a
``straggler`` verdict here, a ``straggler``-dominant incident there with
a matching ``straggler_rank`` — the agreement is recorded as
``straggler_confirmed_by_sentinel``: two independent witnesses, one from
collective sequence deltas, one from step-time budget attribution.

Usage::

    python -m bagua_tpu_torch.tools.diagnose_hang --dir /path/to/dumps          # flight_*.json
    python -m bagua_tpu_torch.tools.diagnose_hang --dir dumps --out hang_report.json
    python -m bagua_tpu_torch.tools.diagnose_hang --glob 'dumps/flight_*.json'  # explicit glob
"""

import argparse
import glob as globlib
import json
import os
import sys


from bagua_tpu_torch.observability.flight_recorder import (
    build_hang_report,
    validate_flight_dump,
    validate_hang_report,
)


def load_dumps(paths):
    """Parse + schema-validate each dump; invalid ones are reported and
    skipped (one corrupt rank must not block forensics on the rest)."""
    dumps, skipped = [], []
    for path in sorted(paths):
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError) as exc:
            skipped.append((path, f"unreadable: {exc}"))
            continue
        problems = validate_flight_dump(payload)
        if problems:
            skipped.append((path, "; ".join(problems[:3])))
            continue
        dumps.append(payload)
    return dumps, skipped


def sentinel_incidents(pattern: str):
    """``perf_regression`` events from any metrics JSONL matching
    ``pattern`` (typically ``<dump_dir>/*.jsonl``): the regression
    sentinel's online verdicts, folded in as the second witness next to
    the flight-recorder forensics.  Unreadable files and torn lines are
    skipped — the incidents are corroboration, never a prerequisite."""
    incidents = []
    for path in sorted(globlib.glob(pattern)):
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
                if ev.get("event") == "perf_regression":
                    incidents.append(ev)
    incidents.sort(key=lambda e: (e.get("ts") or 0.0))
    return incidents


def fold_incidents(report: dict, incidents) -> None:
    """Attach sentinel incidents to the report (extra fields only — the
    hang_report schema checks required fields, so these ride along), and
    record the rank-level agreement when the flight verdict and the
    budget attribution both indict the same straggler."""
    if not incidents:
        return
    report["incidents"] = [
        {
            "step": inc.get("step"),
            "stream": inc.get("stream"),
            "dominant": inc.get("dominant"),
            "residual_ms": inc.get("residual_ms"),
            **({"straggler_rank": inc["straggler_rank"]}
               if "straggler_rank" in inc else {}),
            **({"axis": inc["axis"]} if inc.get("axis") else {}),
            **({"link_class": inc["link_class"]}
               if inc.get("link_class") else {}),
        }
        for inc in incidents[-8:]
    ]
    if report.get("verdict") != "straggler":
        return
    lagging = {int(r) for r in report.get("lagging_ranks") or []}
    for inc in reversed(incidents):
        rank = inc.get("straggler_rank", -1)
        if inc.get("dominant") == "straggler" and isinstance(rank, int) \
                and rank in lagging:
            report["straggler_confirmed_by_sentinel"] = rank
            return


def trace_contexts(dumps) -> dict:
    """Per-rank active trace/span ids from the dumps' embedded telemetry
    snapshots (present when the gang ran with ``BAGUA_TRACING=1``): the
    join key from a wedged collective to the exact in-flight RPC on the
    fleet's ``/fleet/timeline``."""
    out = {}
    for d in dumps:
        trace = (d.get("telemetry") or {}).get("trace") or {}
        if trace.get("trace_id"):
            out[str(d.get("rank", -1))] = {
                "trace_id": trace["trace_id"],
                "span_id": trace.get("span_id"),
            }
    return out


def summarize(report) -> str:
    """Human one-screen summary (stderr; the JSON is the artifact)."""
    lines = [
        f"verdict: {report['verdict']}",
        f"ranks: {report['ranks']}  last_seq: {report['last_seq']}",
    ]
    if report.get("divergent_ranks"):
        lines.append(
            f"first divergence at seq {report['first_divergence_seq']} "
            f"(divergent ranks {report['divergent_ranks']})"
        )
    if report.get("lagging_ranks"):
        lines.append(f"lagging ranks: {report['lagging_ranks']}")
    blocked = report.get("blocked_on")
    if blocked:
        axes = blocked.get("axes")
        lines.append(
            "blocked on: "
            f"{blocked['label']} (seq {blocked['seq']}, bucket "
            f"{blocked['bucket']}, phase {blocked['phase']}, "
            f"plan_version {blocked['plan_version']}"
            + (f", axes {'x'.join(str(a) for a in axes)}" if axes else "")
            + ")"
        )
    traces = report.get("trace_by_rank") or {}
    for rank, ctx in sorted(traces.items()):
        lines.append(
            f"rank {rank} in-flight trace: {ctx['trace_id']} "
            f"(span {ctx.get('span_id')}) — query "
            f"/fleet/timeline for the RPC chain"
        )
    incidents = report.get("incidents") or []
    if incidents:
        newest = incidents[-1]
        axis_note = (
            f", axis {newest['axis']}"
            + (f" [{newest['link_class']}]" if newest.get("link_class") else "")
            if newest.get("axis") else ""
        )
        lines.append(
            f"sentinel: {len(incidents)} perf_regression incident(s) "
            f"nearby; newest at step {newest.get('step')} "
            f"(dominant {newest.get('dominant')}{axis_note})"
        )
    if "straggler_confirmed_by_sentinel" in report:
        lines.append(
            "straggler verdict CONFIRMED by the regression sentinel: "
            f"rank {report['straggler_confirmed_by_sentinel']} indicted by "
            "both the flight rings and the budget attribution"
        )
    if report.get("detail"):
        lines.append(f"detail: {report['detail']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=".",
                    help="directory holding flight_<rank>.json dumps")
    ap.add_argument("--glob", default=None,
                    help="explicit glob for dump files (overrides --dir)")
    ap.add_argument("--metrics-glob", default=None,
                    help="glob for metrics JSONL holding perf_regression "
                    "incidents (default: *.jsonl next to the dumps)")
    ap.add_argument("--out", default=None,
                    help="write the hang_report JSON here (default: stdout)")
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero (4) when the verdict is a desync — "
                    "lets CI and watchdog wrappers gate on the forensics")
    args = ap.parse_args(argv)

    pattern = args.glob or os.path.join(args.dir, "flight_*.json")
    paths = globlib.glob(pattern)
    if not paths:
        print(f"diagnose_hang: no dumps match {pattern}", file=sys.stderr)
        return 2

    dumps, skipped = load_dumps(paths)
    for path, why in skipped:
        print(f"diagnose_hang: skipping {path}: {why}", file=sys.stderr)
    if not dumps:
        print("diagnose_hang: no valid dumps to join", file=sys.stderr)
        return 2

    report = build_hang_report(dumps)
    traces = trace_contexts(dumps)
    if traces:
        # extra field (the report schema checks required fields only):
        # which trace each rank was inside when it wedged
        report["trace_by_rank"] = traces
    metrics_pattern = args.metrics_glob or os.path.join(
        os.path.dirname(pattern) or ".", "*.jsonl"
    )
    fold_incidents(report, sentinel_incidents(metrics_pattern))
    problems = validate_hang_report(report)
    if problems:
        print("diagnose_hang: internal error — report failed its own "
              f"schema: {'; '.join(problems)}", file=sys.stderr)
        return 3

    text = json.dumps(report, indent=2, sort_keys=True)
    if args.out:
        tmp = f"{args.out}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(text + "\n")
        os.replace(tmp, args.out)
        print(f"diagnose_hang: report written to {args.out}", file=sys.stderr)
    else:
        print(text)
    print(summarize(report), file=sys.stderr)
    if args.strict and report["verdict"] == "desync":
        print("diagnose_hang: --strict and verdict is desync", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
