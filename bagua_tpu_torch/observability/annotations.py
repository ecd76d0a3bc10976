"""Labels on the port's exchanges: attribute profiler-trace kernels to
buckets and step phases.

The counterpart of the JAX package's ``jax.named_scope`` labels.  Each
factory here returns a :class:`torch.profiler.record_function` context
whose name is the very string the JAX package puts in its scope, so a
torch profiler trace carries the same grammar::

    bagua_ex/algo=gradient_allreduce/bucket=3/phase=overlap   (bucket exchanges)
    bagua_ex/axis=tp/phase=rs_ring                             (model-parallel)
    bagua_step/phase=optimizer                                 (step phases)

The second form labels *model-parallel* exchanges (the tensor-parallel
all-reduces and all-gathers, the MoE dispatch/combine all-to-alls), keyed
by the logical parallelism axis (``tp`` or ``ep``) and a phase naming the
exchange.  :mod:`bagua_tpu_torch.observability.trace_analysis` joins every
CUDA kernel of a trace to the labels open on the host thread that launched
it, and rolls the kernels up per bucket and per scope.

A ``record_function`` is a host-side marker: it launches nothing and
changes no tensor, so a labeled and an unlabeled step are bitwise equal
(``tests/test_torch_observability.py`` pins it), and the labels stay on.
Outside a profiler it costs one dispatcher call on entry and one on exit.

While the static verifier captures a step
(:class:`~bagua_tpu_torch.analysis.collective_ir.capture_collectives`) each
label is also pushed on a thread-local stack, which names the collectives
issued inside it; outside a capture that costs one thread-local read.

The grammar itself (prefixes, regexes, formatters and parsers) lives in
:mod:`bagua_tpu_torch.observability.scope_grammar`, shared with the trace
joiner and the flight recorder's record templates; this module re-exports
the parsers and adds the factories.
"""

from torch.profiler import record_function

from bagua_tpu_torch.analysis.collective_ir import label_scope
from bagua_tpu_torch.observability.scope_grammar import (
    EXCHANGE_PREFIX,
    STEP_PREFIX,
    format_exchange_label,
    format_mp_label,
    format_step_label,
    parse_exchange_label,
    parse_mp_label,
    parse_step_phase,
)

__all__ = [
    "EXCHANGE_PREFIX",
    "STEP_PREFIX",
    "bucket_scope",
    "step_scope",
    "mp_scope",
    "parse_exchange_label",
    "parse_mp_label",
    "parse_step_phase",
]


class _Labeled:
    """A ``record_function`` that also enters :class:`label_scope`."""

    __slots__ = ("_fn", "_scope")

    def __init__(self, label: str):
        self._fn = record_function(label)
        self._scope = label_scope(label)

    def __enter__(self):
        self._fn.__enter__()
        self._scope.__enter__()
        return self

    def __exit__(self, *exc):
        self._scope.__exit__(*exc)
        return self._fn.__exit__(*exc)


def bucket_scope(algo: str, bucket_idx, phase: str):
    """A ``record_function`` labeling one bucket's exchange (the JAX
    package's ``named_scope`` of the same string).

    ``algo`` is the algorithm's registry-style name, ``phase`` distinguishes
    the monolithic tail exchange (``mono``) from the backward-anchored one
    (``overlap``).  Use as a context manager around the exchange."""
    return _Labeled(format_exchange_label(algo, bucket_idx, phase))


def step_scope(phase: str):
    """A ``record_function`` labeling one engine phase of the train step
    (``fwd_bwd``, ``optimizer``, ``algo_start``, ``algo_end``,
    ``finalize``...)."""
    return _Labeled(format_step_label(phase))


def mp_scope(axis: str, phase: str):
    """A ``record_function`` labeling one model-parallel exchange.

    ``axis`` is the *logical* parallelism scope — ``"tp"`` for tensor-parallel
    exchanges, ``"ep"`` for expert-parallel ones — not the mesh axis name
    (which is deployment-specific and may be a tuple).  ``phase`` names the
    exchange within the scope (``row_psum``, ``ag_ring``, ``rs_ring``,
    ``row_allgather``, ``col_allgather``, ``dispatch``, ``combine``).  Use as
    a context manager around the collective, exactly like
    :func:`bucket_scope`."""
    return _Labeled(format_mp_label(axis, phase))
