"""Device-trace overlap analysis: measure — don't assert — the overlap.

The port of the JAX package's module, rebuilt on the torch profiler's
Chrome trace (:class:`~bagua_tpu_torch.observability.core.ProfilerSession`,
or ``torch.profiler``'s ``export_chrome_trace``; ``.json`` or ``.json.gz``).
It computes, for every collective kernel, the fraction of its duration
*hidden under compute* — compute kernels running at the same time on other
streams (T3, arXiv:2401.16677: fine-grained compute/collective overlap must
be tracked transparently to be trusted).

Attribution.  XLA's trace names each op's HLO instruction, which the JAX
package joins to its ``named_scope`` labels through the compiled HLO text.
A torch trace has no such table; it has the launch.  Each CUDA kernel (and
memcpy/memset) carries ``args.correlation``, which names the runtime call
(``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync``...) that
launched it; that call sits on a host thread inside the ``record_function``
labels open there (:mod:`~bagua_tpu_torch.observability.annotations`).
The labels enclosing the launch, outermost first, joined with ``/`` (as
XLA joins nested scopes into an ``op_name``), are the kernel's label, and
:mod:`~bagua_tpu_torch.observability.scope_grammar` parses it.

"Collective" means a kernel launched under an exchange label
(``bagua_ex/algo=.../bucket=...``) or a model-parallel one
(``bagua_ex/axis=...``): the port's collectives are stacked tensor
operations, not wire operations, so the label is what makes them one.
Every other kernel is compute.  A device event whose launch is not in the
trace (no correlation, or a launch before the capture began) is neither: it
is counted in ``unattributed``.

A trace taken without CUDA has no device events.  There the innermost
host ops of each thread (the ``cpu_op`` events that enclose no other op)
stand in for kernels, each labeled by the annotations enclosing it on its
own thread, so a CPU test can run the analyzer end to end; the interval
math is the same, and the result says ``"source": "host"``.  A trace that
was captured with CUDA (it lists a device in ``deviceProperties``, or
holds CUDA launches) but recorded no device activity raises instead: the
card's activity was lost (CUPTI missing or refused), and host threads
must not be read as the card's streams.

The metric::

    measured_overlap_frac = hidden_collective_time / total_collective_time

1.0 = every collective microsecond ran under concurrent compute (fully
hidden); 0.0 = strictly serialized exchange.
"""

import bisect
import glob
import gzip
import json
import logging
import os
import re
import zlib
from typing import Dict, List, Optional, Tuple

from bagua_tpu_torch.observability.scope_grammar import (
    EXCHANGE_PREFIX,
    hlo_op_labels,
    parse_exchange_label,
    parse_mp_label,
)

logger = logging.getLogger(__name__)

__all__ = [
    "COLLECTIVE_OPS",
    "attribute_device_events",
    "find_trace_file",
    "load_trace_events",
    "hlo_op_labels",
    "analyze_trace",
]

#: label prefixes under which a launched kernel counts as a collective (the
#: JAX package lists HLO instruction-name prefixes here)
COLLECTIVE_OPS = (EXCHANGE_PREFIX + "/",)

#: trace categories of work that runs on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: trace categories of the host calls that launch it
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def find_trace_file(log_dir: str) -> Optional[str]:
    """Newest ``*.json`` or ``*.json.gz`` trace under ``log_dir``."""
    paths = [p for pat in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(log_dir, "**", pat), recursive=True)]
    return max(paths, key=os.path.getmtime) if paths else None


def _trace_path(log_dir: str) -> str:
    """``log_dir`` itself, or the newest trace in that directory."""
    if not os.path.isdir(log_dir):
        return log_dir
    path = find_trace_file(log_dir)
    if path is None:
        raise FileNotFoundError(f"no .json or .json.gz trace under {log_dir}")
    return path


def _open(path: str):
    return (gzip.open if path.endswith(".gz") else open)(path, "rt")


_TRACE_EVENTS_KEY = re.compile(r'"traceEvents"\s*:\s*\[')
#: a ``deviceProperties`` list with at least one device in it
_CUDA_DEVICES = re.compile(r'"deviceProperties"\s*:\s*\[\s*\{')


def _trace_has_cuda(log_dir: str, chunk: int = 1 << 16) -> bool:
    """Whether the trace was captured with CUDA devices present: the
    profiler's ``deviceProperties`` header, written before the events,
    lists at least one."""
    head = ""
    with _open(_trace_path(log_dir)) as f:
        try:
            while True:
                more = f.read(chunk)
                head += more
                if not more or _TRACE_EVENTS_KEY.search(head):
                    break
        except (EOFError, gzip.BadGzipFile, OSError, zlib.error):
            pass  # a truncated capture: the header read so far
    return bool(_CUDA_DEVICES.search(head.split('"traceEvents"')[0]))


def _iter_trace_events(f, chunk: int = 1 << 22):
    """Stream the objects of the top-level ``traceEvents`` array without
    materializing the document — a few steps of a conv net on the CPU sim
    produce multi-GB trace JSONs (every thread-pool slice is an event), and
    ``json.load`` would need an order of magnitude more RAM than the file."""
    dec = json.JSONDecoder()
    buf = ""
    while True:  # locate the array, tolerating a chunk-straddling key
        more = f.read(chunk)
        if not more:
            return
        buf += more
        m = _TRACE_EVENTS_KEY.search(buf)
        if m:
            buf = buf[m.end():]
            break
        buf = buf[-32:]
    idx = 0
    while True:
        while True:  # skip separators; refill when the buffer runs dry
            while idx < len(buf) and buf[idx] in " \t\r\n,":
                idx += 1
            if idx < len(buf):
                break
            buf = f.read(chunk)
            idx = 0
            if not buf:
                return
        if buf[idx] == "]":
            return
        try:
            obj, idx = dec.raw_decode(buf, idx)
        except ValueError:  # object truncated at the buffer edge: refill
            more = f.read(chunk)
            if not more:
                return
            buf, idx = buf[idx:] + more, 0
            continue
        yield obj
        if idx > chunk:  # compact so the buffer stays O(chunk)
            buf, idx = buf[idx:], 0


def load_trace_events(log_dir: str) -> List[Dict]:
    """The complete events (``ph == "X"``) of a trace: ``cat``, ``name``,
    ``lane`` (``(pid, tid)``: a host thread, or a device and stream),
    ``ts``/``dur`` in microseconds, and ``correlation`` and ``stream``
    where the event has them.  ``log_dir`` is a trace file or a directory
    (its newest trace).  The file is stream-parsed; a truncated capture
    keeps the events read before the cut."""
    path = _trace_path(log_dir)
    out = []
    with _open(path) as f:
        try:
            for ev in _iter_trace_events(f):
                if ev.get("ph") != "X" or "dur" not in ev:
                    continue
                args = ev.get("args") or {}
                out.append({
                    "cat": ev.get("cat", ""),
                    "name": ev.get("name", ""),
                    "lane": (ev.get("pid"), ev.get("tid")),
                    "ts": float(ev["ts"]),
                    "dur": float(ev["dur"]),
                    "correlation": args.get("correlation"),
                    "stream": args.get("stream", ev.get("tid")),
                })
        except (EOFError, gzip.BadGzipFile, OSError, zlib.error) as e:
            # a truncated capture (job killed mid-profile) is the common
            # case, not a parse bug: degrade to the events salvaged so far
            logger.warning(
                "trace %s truncated/corrupt after %d events (%s); "
                "analyzing the salvaged prefix", path, len(out), e,
            )
    return out


class _Labels:
    """The ``record_function`` labels of one host thread, for lookups of
    the labels open at an instant."""

    def __init__(self, spans: List[Dict]):
        # outermost first: by start, the longer of two equal starts first
        self.spans = sorted(spans, key=lambda e: (e["ts"], -e["dur"]))
        self.starts = [e["ts"] for e in self.spans]

    def at(self, t: float) -> str:
        hi = bisect.bisect_right(self.starts, t)
        return "/".join(e["name"] for e in self.spans[:hi] if t <= e["ts"] + e["dur"])


def _innermost(ops: List[Dict]) -> List[Dict]:
    """The ops of one thread that enclose no other op of that thread (the
    leaves of its op tree, which never overlap one another)."""
    ops = sorted(ops, key=lambda e: (e["ts"], -e["dur"]))
    return [e for e, nxt in zip(ops, ops[1:] + [None])
            if nxt is None or nxt["ts"] >= e["ts"] + e["dur"]]


def attribute_device_events(events: List[Dict], cuda: bool = False) -> List[Dict]:
    """Each device event of a loaded trace with its ``label``: the
    ``record_function`` labels open around its launch, outermost first,
    joined with ``/`` (``""`` for none, None where the launch is not in
    the trace).  A trace without device events gives the innermost host
    ops of each thread (those that call no other op), labeled on their own
    thread, unless it was captured with CUDA (``cuda``, the
    profiler's device list, or CUDA launches among ``events``): then the
    card's activity was not recorded, and this raises ValueError."""
    by_lane: Dict[Tuple, List[Dict]] = {}
    for e in events:
        if e["cat"] == "user_annotation":
            by_lane.setdefault(e["lane"], []).append(e)
    labels = {lane: _Labels(spans) for lane, spans in by_lane.items()}
    device = [e for e in events if e["cat"] in DEVICE_CATS]
    if not device and (cuda or any(e["cat"] in LAUNCH_CATS for e in events)):
        raise ValueError("the trace was captured with CUDA but holds no device activity (CUPTI "
                         "recorded nothing): it cannot measure the card's overlap")
    if not device:
        ops: Dict[Tuple, List[Dict]] = {}
        for e in events:
            if e["cat"] == "cpu_op":
                ops.setdefault(e["lane"], []).append(e)
        out = []
        for lane, lane_ops in ops.items():
            lab = labels.get(lane)
            for e in _innermost(lane_ops):
                out.append({**e, "label": lab.at(e["ts"]) if lab else ""})
        return out
    launches = {e["correlation"]: e for e in events
                if e["cat"] in LAUNCH_CATS and e["correlation"] is not None}
    out = []
    for e in device:
        launch = launches.get(e["correlation"])
        if launch is None:
            label = None
        else:
            lab = labels.get(launch["lane"])
            label = lab.at(launch["ts"]) if lab else ""
        out.append({**e, "label": label})
    return out


def _merge_intervals(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    if not intervals:
        return []
    intervals.sort()
    merged = [list(intervals[0])]
    for s, e in intervals[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(iv) for iv in merged]


def _covered(start: float, end: float, merged: List[Tuple[float, float]],
             starts: List[float]) -> float:
    """Length of [start, end] ∩ union(merged) (merged sorted, disjoint)."""
    if end <= start or not merged:
        return 0.0
    covered = 0.0
    i = max(0, bisect.bisect_right(starts, start) - 1)
    while i < len(merged) and merged[i][0] < end:
        s, e = merged[i]
        covered += max(0.0, min(e, end) - max(s, start))
        i += 1
    return covered


def _is_collective(label: str) -> bool:
    return any(p in label for p in COLLECTIVE_OPS)


def analyze_trace(
    log_dir: str,
    hlo_text: Optional[str] = None,
    module: Optional[str] = None,
) -> Dict:
    """Per-bucket measured overlap efficiency from one profiler capture.

    Args:
        log_dir: a trace file (``.json`` / ``.json.gz``) or a directory
            holding one (its newest trace).
        hlo_text, module: the JAX package's HLO join; a torch trace needs
            neither (its kernels join to their labels through their
            launches), and passing either raises ValueError.

    Returns a dict with the aggregate ``measured_overlap_frac``, a
    ``per_bucket`` list (one row per labeled ``(algo, bucket)``), a
    ``per_scope`` list (one row per model-parallel scope axis, ``tp``/``ep``
    exchanges labeled by
    :func:`~bagua_tpu_torch.observability.annotations.mp_scope`, each row
    with its own ``measured_overlap_frac``), and ``unattributed``: the
    device events whose launch is not in the trace (None when there is
    none), which count neither as collective nor as compute.  ``source``
    says what the intervals are: ``"device"`` (kernels) or ``"host"`` (a
    trace taken without CUDA, whose innermost host ops stand in); a trace
    taken with CUDA that recorded no device activity raises ValueError.
    """
    if hlo_text is not None or module is not None:
        raise ValueError("a torch profiler trace joins kernels to labels through their "
                         "launches; hlo_text and module are the JAX package's")
    path = _trace_path(log_dir)
    loaded = load_trace_events(path)
    source = "device" if any(e["cat"] in DEVICE_CATS for e in loaded) else "host"
    events = attribute_device_events(loaded, cuda=_trace_has_cuda(path))
    known = [e for e in events if e["label"] is not None]
    lost = [e for e in events if e["label"] is None]
    collectives = [e for e in known if _is_collective(e["label"])]
    compute = [e for e in known if not _is_collective(e["label"])]

    merged = _merge_intervals([(e["ts"], e["ts"] + e["dur"]) for e in compute])
    starts = [s for s, _ in merged]

    def row(**key):
        return {**key, "phases": set(), "kernels": set(), "spans": 0,
                "collective_us": 0.0, "hidden_us": 0.0}

    def add(r, e, hid, phase=None):
        if phase is not None:
            r["phases"].add(phase)
        r["kernels"].add(e["name"])
        r["spans"] += 1
        r["collective_us"] += e["dur"]
        r["hidden_us"] += hid

    per_key: Dict[Tuple, Dict] = {}
    per_scope_key: Dict[str, Dict] = {}
    total_us = hidden_us = 0.0
    for e in collectives:
        hid = _covered(e["ts"], e["ts"] + e["dur"], merged, starts)
        total_us += e["dur"]
        hidden_us += hid
        lab = parse_exchange_label(e["label"])
        if lab is not None:
            r = per_key.setdefault((lab["algo"], lab["bucket"]),
                                   row(algo=lab["algo"], bucket=lab["bucket"]))
            add(r, e, hid, lab["phase"])
            continue
        mp = parse_mp_label(e["label"])
        if mp is not None:
            add(per_scope_key.setdefault(mp["axis"], row(axis=mp["axis"])), e, hid, mp["phase"])
            continue
        # under the exchange prefix but in neither form
        add(per_key.setdefault(None, row(algo=None, bucket=None)), e, hid)

    def frac(r):
        return round(r["hidden_us"] / r["collective_us"], 4) if r["collective_us"] else 0.0

    def finish(r):
        return {
            "algo": r["algo"],
            "bucket": r["bucket"],
            "phases": sorted(r["phases"]),
            "kernels": sorted(r["kernels"]),
            "spans": r["spans"],
            "collective_ms": round(r["collective_us"] / 1e3, 3),
            "hidden_ms": round(r["hidden_us"] / 1e3, 3),
            "overlap_frac": frac(r),
        }

    def finish_scope(r):
        return {
            "axis": r["axis"],
            "phases": sorted(r["phases"]),
            "kernels": sorted(r["kernels"]),
            "spans": r["spans"],
            "collective_ms": round(r["collective_us"] / 1e3, 3),
            "hidden_ms": round(r["hidden_us"] / 1e3, 3),
            "measured_overlap_frac": frac(r),
        }

    per_bucket = sorted(
        (finish(r) for k, r in per_key.items() if k is not None),
        key=lambda r: (r["algo"], r["bucket"]),
    )
    per_scope = sorted((finish_scope(r) for r in per_scope_key.values()), key=lambda r: r["axis"])
    unattributed = None
    if lost or None in per_key:
        r = per_key.get(None) or row(algo=None, bucket=None)
        for e in lost:
            add(r, e, 0.0)
        unattributed = finish(r)
    return {
        "module": "",
        "source": source,
        "num_device_events": len(events),
        "collective_spans": len(collectives),
        "collective_ms": round(total_us / 1e3, 3),
        "hidden_ms": round(hidden_us / 1e3, 3),
        "measured_overlap_frac": round(hidden_us / total_us, 4) if total_us else 0.0,
        "per_bucket": per_bucket,
        "per_scope": per_scope,
        "unattributed": unattributed,
    }
