"""Distributed tracing: causal spans from the train step to the control plane.

The observability stack can *name* every symptom — goodput buckets, flight
records, fleet scheduler verdicts — but nothing links them causally: when a
gang's step stalls on a rendezvous RPC the fleet server 429'd, that chain is
spread across three uncorrelated JSONL streams.  This module closes the gap
with a dependency-free span model:

* :class:`Span` — trace_id / span_id / parent_id, a name, a kind
  (``internal`` / ``client`` / ``server``), wall-clock start + duration,
  flat attributes and timestamped annotations.  Serialized as one JSON
  object (``bagua.span.v1``).
* **W3C context propagation** — :func:`format_traceparent` /
  :func:`parse_traceparent` implement the ``traceparent`` header
  (``00-<trace_id>-<span_id>-<flags>``), so the RPC clients inject the
  active span's context and the fleet server's per-request span becomes a
  *child* of the in-flight client span: one trace_id follows a training
  step from ``Trainer`` through the control plane and back.
* :class:`Tracer` — hung off the :class:`~bagua_tpu_torch.observability.telemetry.Telemetry`
  hub (``BAGUA_TRACING=1``), step-sampled (``BAGUA_TRACE_SAMPLE``), with a
  thread-local context stack, a bounded in-memory ring of finished spans,
  and an optional span-JSONL sink ``ci/export_timeline.py`` renders to
  Chrome trace-event JSON (Perfetto).

Everything here is host-side, stdlib-only and bitwise-inert by
construction: spans wrap the host's phase bookkeeping (``enter_phase`` /
``on_step``) and the RPC transports — never the traced computation.  The
CI tracing lane proves on-vs-off training state identical, like the flight
recorder.
"""

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

__all__ = [
    "SPAN_SCHEMA",
    "Span",
    "Tracer",
    "client_span",
    "format_traceparent",
    "get_global_tracer",
    "new_span_id",
    "new_trace_id",
    "parse_traceparent",
    "set_global_tracer",
    "validate_span",
]

#: schema tag every serialized span carries
SPAN_SCHEMA = "bagua.span.v1"

_HEX = set("0123456789abcdef")


def new_trace_id() -> str:
    """A fresh 16-byte (32 hex char) W3C trace id."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """A fresh 8-byte (16 hex char) W3C span id."""
    return os.urandom(8).hex()


def format_traceparent(trace_id: str, span_id: str, sampled: bool = True) -> str:
    """The W3C ``traceparent`` header value:
    ``00-<trace_id>-<span_id>-<flags>`` (version 00, flags 01 = sampled)."""
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


def parse_traceparent(header: Optional[str]) -> Optional[Dict]:
    """Parse a ``traceparent`` header; None on anything malformed (wrong
    field count, non-hex, all-zero ids, version ``ff``) — a bad header must
    degrade to "no context", never crash a request handler."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if len(version) != 2 or version == "ff" or not set(version) <= _HEX:
        return None
    if len(trace_id) != 32 or not set(trace_id) <= _HEX or set(trace_id) == {"0"}:
        return None
    if len(span_id) != 16 or not set(span_id) <= _HEX or set(span_id) == {"0"}:
        return None
    if len(flags) != 2 or not set(flags) <= _HEX:
        return None
    return {
        "trace_id": trace_id,
        "span_id": span_id,
        "sampled": bool(int(flags, 16) & 0x01),
    }


class Span:
    """One unit of causally attributed work.

    Mutable while open (``annotate`` / ``set``); :meth:`Tracer.finish` (or
    the ``tracer.span(...)`` context manager) stamps the duration and
    freezes it into the tracer's ring + sink as a plain dict."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "kind",
        "ts", "_mono", "dur_ms", "attrs", "annotations",
    )

    def __init__(
        self,
        name: str,
        kind: str = "internal",
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        attrs: Optional[Dict] = None,
        clock: float = None,
    ):
        self.trace_id = trace_id or new_trace_id()
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.name = str(name)
        self.kind = str(kind)
        self.ts = time.time() if clock is None else float(clock)
        self._mono = time.monotonic()
        self.dur_ms: Optional[float] = None
        self.attrs: Dict = dict(attrs or {})
        self.annotations: List[Dict] = []

    def set(self, key: str, value) -> "Span":
        self.attrs[str(key)] = value
        return self

    def annotate(self, name: str, **attrs) -> "Span":
        """A timestamped point event inside the span (a retry backoff, a
        Retry-After hint, a breaker transition)."""
        self.annotations.append(
            {"name": str(name), "ts": round(time.time(), 6), **attrs}
        )
        return self

    @property
    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id)

    def to_dict(self) -> Dict:
        out = {
            "schema": SPAN_SCHEMA,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "name": self.name,
            "kind": self.kind,
            "ts": round(self.ts, 6),
            "dur_ms": round(self.dur_ms, 4) if self.dur_ms is not None else None,
        }
        if self.parent_id:
            out["parent_id"] = self.parent_id
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        if self.annotations:
            out["annotations"] = list(self.annotations)
        return out


def validate_span(span: Dict) -> List[str]:
    """Schema-check one serialized span dict; returns problems (empty =
    valid).  The fleet's ``/g/<gang>/spans`` ingest and the Perfetto
    exporter both hold incoming spans to this."""
    problems = []
    if not isinstance(span, dict):
        return [f"span is {type(span).__name__}, not an object"]
    tid = span.get("trace_id")
    if not (isinstance(tid, str) and len(tid) == 32 and set(tid) <= _HEX):
        problems.append(f"bad trace_id {tid!r}")
    sid = span.get("span_id")
    if not (isinstance(sid, str) and len(sid) == 16 and set(sid) <= _HEX):
        problems.append(f"bad span_id {sid!r}")
    pid = span.get("parent_id")
    if pid is not None and not (
        isinstance(pid, str) and len(pid) == 16 and set(pid) <= _HEX
    ):
        problems.append(f"bad parent_id {pid!r}")
    if not isinstance(span.get("name"), str) or not span.get("name"):
        problems.append("missing name")
    if span.get("kind") not in ("internal", "client", "server"):
        problems.append(f"bad kind {span.get('kind')!r}")
    if not isinstance(span.get("ts"), (int, float)):
        problems.append("missing ts")
    dur = span.get("dur_ms")
    if dur is not None and not isinstance(dur, (int, float)):
        problems.append(f"bad dur_ms {dur!r}")
    return problems


class Tracer:
    """Per-process span factory + collector.

    Thread-local context stack: :meth:`span` opens a child of the calling
    thread's current span (or a fresh root), so an RPC issued from the fit
    loop inherits the step trace while a background writer thread starts
    its own.  Finished spans land in a bounded ring (``capacity``) and,
    when ``path`` is given, one-JSON-object-per-line in the span file.

    The step machinery (:meth:`begin_step` / :meth:`on_phase` /
    :meth:`end_step`) is what the Telemetry hub drives: one sampled root
    span per training step with one child span per host phase
    (``dispatch`` → ``wait`` → ``data``), so every RPC the step issues
    hangs off the phase it blocked.
    """

    def __init__(
        self,
        path: Optional[str] = None,
        sample_every: int = 1,
        service: str = "trainer",
        rank: int = 0,
        capacity: int = 4096,
    ):
        self.path = path
        self.sample_every = max(1, int(sample_every))
        self.service = str(service)
        self.rank = int(rank)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(16, int(capacity)))
        self._tls = threading.local()
        self._step_span: Optional[Span] = None
        self._phase_span: Optional[Span] = None
        self.n_spans = 0
        self.n_dropped_unsampled = 0
        self._f = None
        if path:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            self._f = open(path, "a")

    # -- context -------------------------------------------------------------

    def _stack(self) -> List[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current_span(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    def trace_context(self) -> Dict[str, str]:
        """``{"trace_id", "span_id"}`` of the active span (empty when no
        trace is open) — what ``hang`` / ``health_alert`` events and flight
        dumps embed so forensics can join back to the timeline."""
        sp = self.current_span()
        if sp is None:
            return {}
        return {"trace_id": sp.trace_id, "span_id": sp.span_id}

    def traceparent(self) -> Optional[str]:
        sp = self.current_span()
        return sp.traceparent if sp is not None else None

    # -- span lifecycle ------------------------------------------------------

    def start_span(
        self,
        name: str,
        kind: str = "internal",
        parent: Optional[Span] = None,
        attrs: Optional[Dict] = None,
    ) -> Span:
        if parent is None:
            parent = self.current_span()
        return Span(
            name,
            kind=kind,
            trace_id=parent.trace_id if parent is not None else None,
            parent_id=parent.span_id if parent is not None else None,
            attrs=attrs,
        )

    def finish(self, span: Span) -> Dict:
        if span.dur_ms is None:
            span.dur_ms = (time.monotonic() - span._mono) * 1e3
        span.attrs.setdefault("service", self.service)
        span.attrs.setdefault("rank", self.rank)
        out = span.to_dict()
        with self._lock:
            self._ring.append(out)
            self.n_spans += 1
            if self._f is not None:
                self._f.write(json.dumps(out, sort_keys=True) + "\n")
                self._f.flush()
        return out

    class _SpanCtx:
        def __init__(self, tracer: "Tracer", span: Span):
            self.tracer, self.span = tracer, span

        def __enter__(self) -> Span:
            self.tracer._stack().append(self.span)
            return self.span

        def __exit__(self, exc_type, exc, tb) -> bool:
            stack = self.tracer._stack()
            if stack and stack[-1] is self.span:
                stack.pop()
            if exc is not None:
                # A 429 carries the server's pacing hint; any other failure
                # is just tagged — the span must record the outcome without
                # swallowing it.
                hint = getattr(exc, "retry_after_s", None)
                if hint is not None or getattr(exc, "code", None) == 429:
                    self.span.set("status", 429)
                    self.span.annotate(
                        "backpressure",
                        retry_after_s=round(float(hint or 0.0), 3),
                    )
                else:
                    self.span.set("error", type(exc).__name__)
            self.tracer.finish(self.span)
            return False

    def span(
        self,
        name: str,
        kind: str = "internal",
        parent: Optional[Span] = None,
        attrs: Optional[Dict] = None,
    ) -> "_SpanCtx":
        """``with tracer.span("rpc /rdzv/heartbeat", kind="client") as sp:``
        — opens a child of the calling thread's current span, pushes it as
        the new context, records it (with error / backpressure attribution)
        on exit."""
        return Tracer._SpanCtx(self, self.start_span(name, kind, parent, attrs))

    def record_event(
        self, name: str, attrs: Optional[Dict] = None, wall_ms: float = 0.0
    ) -> Dict:
        """A point-in-time span (snapshot write, rebucket, precision
        switch): child of the current context, duration stamped from the
        reported wall time rather than measured."""
        sp = self.start_span(name, kind="internal", attrs=attrs)
        sp.dur_ms = max(0.0, float(wall_ms))
        sp.ts -= sp.dur_ms / 1e3  # the work *ended* now; start it earlier
        return self.finish(sp)

    # -- the step machinery (driven by the Telemetry hub) --------------------

    def step_sampled(self, step: int) -> bool:
        return int(step) % self.sample_every == 0

    def begin_step(self, step: int, variant: str = "") -> Optional[Span]:
        """Open the sampled step's root span (closing any still-open
        previous step first — the ``data`` phase between steps belongs to
        the trace that just ran)."""
        if self._step_span is not None:
            self.end_step()
        if not self.step_sampled(step):
            self.n_dropped_unsampled += 1
            return None
        root = self.start_span(
            "train_step", kind="internal", parent=None,
            attrs={"step": int(step), **({"variant": variant} if variant else {})},
        )
        self._stack().append(root)
        self._step_span = root
        return root

    def on_phase(self, phase: str) -> None:
        """Host phase transition inside the sampled step: close the open
        phase child, open the next."""
        root = self._step_span
        if root is None:
            return
        self._close_phase()
        child = Span(
            f"phase:{phase}", kind="internal",
            trace_id=root.trace_id, parent_id=root.span_id,
        )
        self._stack().append(child)
        self._phase_span = child

    def _close_phase(self) -> None:
        child = self._phase_span
        if child is None:
            return
        stack = self._stack()
        if stack and stack[-1] is child:
            stack.pop()
        self.finish(child)
        self._phase_span = None

    def note_step(self, **attrs) -> None:
        """Stamp attributes on the open step root *without* closing it —
        the hub calls this when the dispatched step retires, leaving the
        trace open so the inter-step gap (data phase, snapshot/autotune
        RPCs) still hangs off the step that just ran."""
        root = self._step_span
        if root is None:
            return
        for k, v in attrs.items():
            root.set(k, v)

    def end_step(self, **attrs) -> None:
        """Close the step trace (phase child first, then the root)."""
        root = self._step_span
        if root is None:
            return
        self._close_phase()
        for k, v in attrs.items():
            root.set(k, v)
        stack = self._stack()
        if stack and stack[-1] is root:
            stack.pop()
        self.finish(root)
        self._step_span = None

    # -- export --------------------------------------------------------------

    def finished_spans(self, trace_id: Optional[str] = None) -> List[Dict]:
        with self._lock:
            spans = list(self._ring)
        if trace_id is not None:
            spans = [s for s in spans if s.get("trace_id") == trace_id]
        return spans

    def flush(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()

    def close(self) -> None:
        self.end_step()
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


# -- the ambient tracer (what retry_call and the RPC clients consult) ---------

_global_tracer: Optional[Tracer] = None


def set_global_tracer(tracer: Optional[Tracer]) -> None:
    """Install (or clear, with None) the process-wide ambient tracer.  The
    Telemetry hub does this when ``BAGUA_TRACING`` builds one; code that
    cannot be handed a tracer (``retry_call``, the RPC transports) reads it
    back with :func:`get_global_tracer` — None means tracing is off and
    every instrumentation site must be a no-op."""
    global _global_tracer
    _global_tracer = tracer


def get_global_tracer() -> Optional[Tracer]:
    return _global_tracer


class client_span:
    """RPC-transport instrumentation: a no-op context manager when tracing
    is off, else a ``client``-kind span whose W3C context the transport
    injects::

        with client_span(f"rpc {path}", component="rendezvous",
                         endpoint=path) as (sp, headers):
            # headers == {} or {"traceparent": "00-..."}
            req = urllib.request.Request(url, headers={**base, **headers})

    A 429 raised inside the block lands on the span as ``status: 429`` plus
    a ``backpressure`` annotation with the Retry-After hint (see
    :class:`Tracer._SpanCtx`) — the retry child span the CI lane asserts."""

    def __init__(self, name: str, component: str = "rpc", **attrs):
        self.name = name
        self.attrs = {"component": component, **attrs}
        self._ctx = None

    def __enter__(self):
        tracer = get_global_tracer()
        if tracer is None:
            return None, {}
        self._ctx = tracer.span(self.name, kind="client", attrs=self.attrs)
        sp = self._ctx.__enter__()
        return sp, {"traceparent": sp.traceparent}

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._ctx is not None:
            return self._ctx.__exit__(exc_type, exc, tb)
        return False
