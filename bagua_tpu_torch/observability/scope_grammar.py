"""The one scope-label grammar: formatters + parsers shared by every layer.

A copy of the JAX package's module.  Every subsystem that names a
collective speaks this grammar: the ``record_function`` labels the
exchanges open (:mod:`bagua_tpu_torch.observability.annotations`, the same
strings as the JAX package's ``jax.named_scope`` frames), the flight
recorder's ring records (``ddp._flight_finalize`` renders labels with
:func:`format_exchange_label`) and the profiler-trace joiner
(:mod:`bagua_tpu_torch.observability.trace_analysis` joins the labels open
on a launching thread with ``/``, as XLA joins nested scopes into an
``op_name``, and parses the result here).  Keeping one module as the
source of truth is what lets the recorder's *captured* program and the
trace's labels join record-for-record on the label key.
:func:`hlo_op_labels` is kept for HLO text from the JAX package.

The three label forms::

    bagua_ex/algo=gradient_allreduce/bucket=3/phase=overlap   (bucket exchanges)
    bagua_ex/axis=tp/phase=rs_ring                            (model-parallel)
    bagua_step/phase=optimizer                                (engine step phases)

plus the quantized-ring sub-scopes nested *inside* a bucket-exchange frame
(``qr8_quant``, ``qr8_hop3``, ``qr4_ag``) and the overlap backward anchor
``bagua_overlap_bwd/bucket=<i>`` of the JAX package's traces, and the
bounded-staleness frame ``bagua_stale/tau=<k>`` wrapping every exchange a
stale-sync/gossip algorithm issues — the sanction marker the static
verifier's taint analysis keys off (a rank-conditional collective inside a
stale frame is bounded-by-construction, not a divergence bug).

Field separators are ``/`` (the scope-nesting separator, which XLA joins
verbatim into ``op_name``) and ``=``; characters like ``@`` are truncated
by the MLIR location plumbing and must not appear in scope names.
"""

import re
from typing import Dict, Optional, Tuple

__all__ = [
    "EXCHANGE_PREFIX",
    "STEP_PREFIX",
    "STALE_PREFIX",
    "EXCHANGE_RE",
    "STEP_RE",
    "MP_RE",
    "QR_RE",
    "OVERLAP_BWD_RE",
    "STALE_RE",
    "format_exchange_label",
    "format_mp_label",
    "format_step_label",
    "format_stale_scope",
    "parse_exchange_label",
    "parse_mp_label",
    "parse_step_phase",
    "parse_qr_scope",
    "parse_overlap_bwd",
    "parse_stale_scope",
    "hlo_op_labels",
]

#: scope-name prefixes (kept short: every annotated HLO op carries them)
EXCHANGE_PREFIX = "bagua_ex"
STEP_PREFIX = "bagua_step"
STALE_PREFIX = "bagua_stale"

EXCHANGE_RE = re.compile(
    EXCHANGE_PREFIX + r"/algo=(?P<algo>[^/]+)/bucket=(?P<bucket>\d+)/phase=(?P<phase>[^/\"]+)"
)
STEP_RE = re.compile(STEP_PREFIX + r"/phase=(?P<phase>[^/\"]+)")
MP_RE = re.compile(
    EXCHANGE_PREFIX + r"/axis=(?P<axis>[^/=]+)/phase=(?P<phase>[^/\"]+)"
)
#: quantized-ring sub-scopes (nested inside a bucket-exchange frame)
QR_RE = re.compile(r"qr(?P<bits>\d+)_(?P<stage>quant|ag|hop(?P<hop>\d+))")
#: the custom_vjp backward anchor wrapping each bucket's overlap exchange
OVERLAP_BWD_RE = re.compile(r"bagua_overlap_bwd/bucket=(?P<bucket>\d+)")
#: the bounded-staleness sanction frame (τ = the staleness bound the
#: algorithm was compiled at)
STALE_RE = re.compile(STALE_PREFIX + r"/tau=(?P<tau>\d+)")


# -- formatters (the single way a label string is ever built) -----------------


def format_exchange_label(algo: str, bucket_idx, phase: str) -> str:
    """Render one bucket-exchange label; the inverse of
    :func:`parse_exchange_label` and the exact string both
    ``annotations.bucket_scope`` and the flight recorder's record templates
    carry."""
    return f"{EXCHANGE_PREFIX}/algo={algo}/bucket={int(bucket_idx)}/phase={phase}"


def format_mp_label(axis: str, phase: str) -> str:
    return f"{EXCHANGE_PREFIX}/axis={axis}/phase={phase}"


def format_step_label(phase: str) -> str:
    return f"{STEP_PREFIX}/phase={phase}"


def format_stale_scope(tau) -> str:
    """Render the bounded-staleness frame a stale-sync/gossip exchange is
    traced under — the marker :func:`parse_stale_scope` (and through it the
    static verifier's sanction) recovers from the jaxpr name stack."""
    return f"{STALE_PREFIX}/tau={int(tau)}"


# -- parsers ------------------------------------------------------------------


def parse_exchange_label(op_name: str) -> Optional[Dict]:
    """Extract ``{algo, bucket, phase}`` from any string carrying a
    bucket-exchange frame (HLO ``op_name`` metadata, a jaxpr ``name_stack``,
    a flight-recorder label); None when no frame is present."""
    m = EXCHANGE_RE.search(op_name or "")
    if not m:
        return None
    return {"algo": m.group("algo"), "bucket": int(m.group("bucket")), "phase": m.group("phase")}


def parse_mp_label(op_name: str) -> Optional[Dict]:
    """Extract ``{axis, phase}`` from a model-parallel exchange frame; None
    for unlabeled ops (bucket-exchange labels use ``algo=``/``bucket=``
    fields and never match)."""
    m = MP_RE.search(op_name or "")
    if not m:
        return None
    return {"axis": m.group("axis"), "phase": m.group("phase")}


def parse_step_phase(op_name: str) -> Optional[str]:
    """The engine step phase an op was traced under, if labeled."""
    m = STEP_RE.search(op_name or "")
    return m.group("phase") if m else None


def parse_qr_scope(op_name: str) -> Optional[Dict]:
    """Extract ``{bits, stage, hop}`` from a quantized-ring sub-scope
    (``stage`` is ``"quant"``, ``"hop"`` or ``"ag"``; ``hop`` is the 1-based
    hop index for hop frames, else None)."""
    m = QR_RE.search(op_name or "")
    if not m:
        return None
    stage = m.group("stage")
    hop = m.group("hop")
    return {
        "bits": int(m.group("bits")),
        "stage": "hop" if hop is not None else stage,
        "hop": int(hop) if hop is not None else None,
    }


def parse_overlap_bwd(op_name: str) -> Optional[int]:
    """Bucket index of a ``bagua_overlap_bwd`` backward anchor, if present."""
    m = OVERLAP_BWD_RE.search(op_name or "")
    return int(m.group("bucket")) if m else None


def parse_stale_scope(op_name: str) -> Optional[int]:
    """The staleness bound τ of a ``bagua_stale`` frame, if present."""
    m = STALE_RE.search(op_name or "")
    return int(m.group("tau")) if m else None


# -- the HLO join table -------------------------------------------------------

_HLO_INSTR = re.compile(r"%([A-Za-z0-9_.\-]+) = .*metadata=\{[^}]*op_name=\"([^\"]*)\"")
_HLO_MODULE = re.compile(r"^HloModule ([^\s,]+)", re.MULTILINE)


def hlo_op_labels(hlo_text: str) -> Tuple[str, Dict[str, str]]:
    """``(module_name, {instruction_name: op_name_metadata})`` from compiled
    HLO text — the join table between trace events and named-scope labels."""
    m = _HLO_MODULE.search(hlo_text)
    module = m.group(1) if m else ""
    return module, {name: op_name for name, op_name in _HLO_INSTR.findall(hlo_text)}
