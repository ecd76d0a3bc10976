"""CollectiveIR: a canonical description of every collective a step issues.

The static verifier's substrate (the port of ``bagua_tpu/analysis/
collective_ir.py``).  The JAX package walks a traced jaxpr; the port has
none, since its collectives are eager tensor operations on the rank-stacked
axis (:mod:`bagua_tpu_torch.communication`).  So the port *captures* them
instead: inside :class:`capture_collectives`, every collective of
:mod:`~bagua_tpu_torch.communication` appends one
:class:`CollectiveDescriptor` with the JAX package's fields:

* the JAX primitive it stands for (``allreduce`` SUM/AVG is ``psum``, MAX
  ``pmax``, MIN ``pmin``, the bitwise and PRODUCT reductions the
  ``all_gather`` they run as; ``reduce_scatter``, ``all_gather``,
  ``all_to_all``, ``ppermute``; a hierarchical all-reduce is its two
  ``psum`` legs, and a variadic all-reduce of several leaves one ``psum``,
  as ``lax.psum`` over a tuple is one primitive);
* the mesh axes it spans and their ring size;
* the per-rank operand shapes (the stacked shape without its rank rows),
  dtypes and **exact** bytes, and the ring-model wire bytes
  (:func:`primitive_wire_bytes`);
* the enclosing labels, parsed with the shared grammar
  (:mod:`bagua_tpu_torch.observability.scope_grammar`).  The
  ``record_function`` labels of :mod:`~bagua_tpu_torch.observability.
  annotations` cannot be read back, so while a capture is active they (and
  the quantized ring's ``qr<bits>_*`` sub-scopes, :class:`label_scope`)
  also push their label on a thread-local stack; a descriptor's ``label``
  is that stack joined with ``/``, as JAX's ``name_stack`` joins its
  scopes (``bagua_ex/algo=zero/bucket=3/phase=rs/qr8_hop2``).

Rank conditionality: the JAX walker taints ``axis_index``-derived values
and flags a collective under a ``cond``/``while`` whose predicate they
reach.  One controller runs every rank's Python here, so a branch is taken
for all ranks at once and that taint has no counterpart.  The port flags a
collective whose operand does not hold every member of its group (fewer
rank rows than the group's size: a row subset, the only way one rank could
take part without another).  ``path`` holds the port's own control-flow
frames, of which there are none: every descriptor's ``path`` is ``()``.

With no capture active a collective pays one thread-local read.  The
overlap hooks, which autograd runs on its own thread on the card, re-enter
the capture there (``capture_collectives(events)``), as they re-enter the
flight recorder's.
"""

import dataclasses
import functools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = [
    "COLLECTIVE_PRIMITIVES",
    "CollectiveDescriptor",
    "CollectiveProgram",
    "capture_collectives",
    "label_scope",
    "primitive_wire_bytes",
    "record_collective",
]

#: JAX primitive name -> reduction op (None = data movement only)
COLLECTIVE_PRIMITIVES = {
    "psum": "sum",
    "pmax": "max",
    "pmin": "min",
    "reduce_scatter": "sum",  # lax.psum_scatter
    "all_gather": None,
    "ppermute": None,
    "all_to_all": None,
}

def primitive_wire_bytes(primitive: str, operand_bytes: int, n: int) -> int:
    """Per-rank ring-model wire bytes for one collective primitive over an
    ``n``-rank axis with ``operand_bytes`` of local input.  These are the
    planner's α–β payload legs: ring all-reduce ``2N(n-1)/n``, rs/a2a one
    scatter leg ``N(n-1)/n``, all-gather ``N(n-1)`` (the operand IS the
    local shard), ppermute one send of ``N``."""
    if n <= 1:
        return 0
    if primitive in ("psum", "pmax", "pmin"):
        return 2 * operand_bytes * (n - 1) // n
    if primitive in ("reduce_scatter", "all_to_all"):
        return operand_bytes * (n - 1) // n
    if primitive == "all_gather":
        return operand_bytes * (n - 1)
    if primitive == "ppermute":
        return operand_bytes
    raise ValueError(f"not a collective primitive: {primitive!r}")


@dataclasses.dataclass
class CollectiveDescriptor:
    """One collective of the captured step program."""

    index: int                      #: position in issue order
    primitive: str                  #: the JAX primitive it stands for
    reduce_op: Optional[str]        #: "sum"/"max"/"min" or None
    axes: Tuple[str, ...]           #: mesh axis names it spans
    ring_size: int                  #: product of those axes' sizes
    shapes: Tuple[Tuple[int, ...], ...]  #: per-rank operand shapes
    dtypes: Tuple[str, ...]         #: per-rank operand dtypes
    nbytes: int                     #: exact per-rank operand bytes (summed)
    wire_bytes: int                 #: per-rank ring-model wire bytes
    label: str                      #: the label stack, joined with "/"
    scope: Optional[Dict]           #: parsed bucket-exchange frame
    mp: Optional[Dict]              #: parsed model-parallel frame
    qr: Optional[Dict]              #: parsed quantized-ring sub-scope
    path: Tuple[str, ...]           #: control-flow frames (always ``()``)
    rank_conditional: bool          #: the operand misses members of its group
    cond_label: Optional[str]       #: the label it was flagged under
    #: the bound τ of an enclosing ``bagua_stale/tau=<k>`` frame, or None
    stale: Optional[int] = None

    @property
    def bucket(self) -> Optional[int]:
        return self.scope["bucket"] if self.scope else None

    @property
    def phase(self) -> Optional[str]:
        return self.scope["phase"] if self.scope else None

    @property
    def algo(self) -> Optional[str]:
        return self.scope["algo"] if self.scope else None


@dataclasses.dataclass
class CollectiveProgram:
    """The CollectiveIR of one step: descriptors in issue order plus the
    mesh geometry they were captured under."""

    collectives: List[CollectiveDescriptor]
    axis_sizes: Dict[str, int]

    @property
    def world_size(self) -> int:
        n = 1
        for s in self.axis_sizes.values():
            n *= int(s)
        return n

    def labeled(self) -> List[CollectiveDescriptor]:
        """Descriptors carrying a bucket-exchange frame."""
        return [d for d in self.collectives if d.scope is not None]

    def by_bucket_phase(self) -> Dict[Tuple[str, int, str], List[CollectiveDescriptor]]:
        """Group the labeled descriptors by ``(algo, bucket, phase)``,
        preserving issue order inside each group (and insertion order of the
        groups themselves)."""
        out: Dict[Tuple[str, int, str], List[CollectiveDescriptor]] = {}
        for d in self.labeled():
            out.setdefault((d.scope["algo"], d.scope["bucket"], d.scope["phase"]), []).append(d)
        return out


class _State(threading.local):
    #: the descriptor list of the capture active on this thread, or None
    capture: Optional[list] = None
    #: the labels open on this thread while a capture is active
    labels: Tuple[str, ...] = ()


_tls = _State()


class capture_collectives:
    """Capture every collective issued on this thread::

        with capture_collectives() as descriptors:
            step(state, batch)

    Pass a list to append to it: ``capture_collectives(descriptors)``
    re-enters a capture on another thread (the engine's overlap hooks).
    Reentrant: the previous capture and label stack are restored on exit."""

    def __init__(self, descriptors: Optional[List[CollectiveDescriptor]] = None):
        self.descriptors: List[CollectiveDescriptor] = [] if descriptors is None else descriptors

    def __enter__(self) -> List[CollectiveDescriptor]:
        self._prev = (_tls.capture, _tls.labels)
        _tls.capture, _tls.labels = self.descriptors, ()
        return self.descriptors

    def __exit__(self, *exc) -> bool:
        _tls.capture, _tls.labels = self._prev
        return False


class label_scope:
    """Push ``label`` on this thread's label stack while a capture is
    active (a no-op otherwise): the annotations' ``record_function``
    labels and the quantized ring's sub-scopes enter it."""

    __slots__ = ("label", "_prev")

    def __init__(self, label: str):
        self.label = label
        self._prev = None

    def __enter__(self):
        if _tls.capture is not None:
            self._prev = _tls.labels
            _tls.labels = self._prev + (self.label,)
        return self

    def __exit__(self, *exc) -> bool:
        if self._prev is not None:
            _tls.labels, self._prev = self._prev, None
        return False


@functools.lru_cache(maxsize=4096)
def _parsed(label: str):
    """The label's exchange, model-parallel, quantized-ring and staleness
    frames.  (Imported here: the annotations import this module, and the
    grammar's package imports the annotations.)"""
    from bagua_tpu_torch.observability.scope_grammar import (
        parse_exchange_label,
        parse_mp_label,
        parse_qr_scope,
        parse_stale_scope,
    )

    return (parse_exchange_label(label), parse_mp_label(label), parse_qr_scope(label),
            parse_stale_scope(label))


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def record_collective(primitive: str, operands: Sequence[torch.Tensor], group, axes: Tuple[str, ...]) -> None:
    """Append one descriptor for a collective over ``axes`` of ``group`` on
    the stacked ``operands`` (``(rows, ...)`` each) to the active capture.
    The caller checks that a capture is active (``_tls.capture``)."""
    sizes = dict(zip(group.all_axes, group.shape))
    n = 1
    for a in axes:
        n *= int(sizes[a])
    shapes = tuple(tuple(int(d) for d in t.shape[1:]) for t in operands)
    nbytes = sum(t[0].numel() * t.element_size() for t in operands if t.shape[0])
    rows = min((int(t.shape[0]) for t in operands), default=group.local_size)
    label = "/".join(_tls.labels)
    scope, mp, qr, stale = (dict(f) if isinstance(f, dict) else f for f in _parsed(label))
    conditional = rows < group.local_size
    cap = _tls.capture
    cap.append(CollectiveDescriptor(
        index=len(cap),
        primitive=primitive,
        reduce_op=COLLECTIVE_PRIMITIVES[primitive],
        axes=tuple(axes),
        ring_size=n,
        shapes=shapes,
        dtypes=tuple(_dtype_name(t.dtype) for t in operands),
        nbytes=int(nbytes),
        wire_bytes=primitive_wire_bytes(primitive, int(nbytes), n),
        label=label,
        scope=scope,
        mp=mp,
        qr=qr,
        path=(),
        rank_conditional=conditional,
        cond_label=label if conditional else None,
        stale=stale,
    ))
