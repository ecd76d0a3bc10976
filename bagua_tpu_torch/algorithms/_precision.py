"""The ``wire_precision`` knob of the gradient exchange.

The port of ``bagua_tpu/algorithms/_precision.py``.  ``wire_precision=
"f32"|"int8"|"int4"|"auto"``: the quantized settings route each bucket's
padded flat buffer through the blockwise ring
(:mod:`bagua_tpu_torch.kernels.quantized_ring`) instead of the plain
collective.  The mixin holds what does not depend on the engine:

* validation;
* the per-bucket precision: an adopted plan (``bucket_precision``, only
  under ``"auto"``) > the uniform ``wire_precision`` > ``"f32"`` for
  non-float buckets; ``"auto"`` without a plan is ``"f32"``, so the engine
  never quantizes before a plan lands;
* the error-feedback policy: ``"int4"`` and ``"auto"`` (which may resolve
  to int4) carry an f32 residual per bucket in the algorithm state, so the
  algorithm holds bucketized state;
* the modelled wire bytes per precision.
"""

from typing import List, Optional, Sequence

from bagua_tpu_torch.kernels.quantized_ring import WIRE_PRECISIONS, ring_wire_bytes

#: bagua datatype names eligible for blockwise quantization (the ring runs
#: in f32; other buckets take the exact path)
FLOAT_DTYPES = ("f32", "f16", "bf16")

VALID_WIRE_PRECISIONS = WIRE_PRECISIONS + ("auto",)

#: bits on the wire per quantized precision
PRECISION_BITS = {"int8": 8, "int4": 4}


class WirePrecisionMixin:
    """Per-bucket wire-precision resolution and error-feedback policy.

    Classes mixing this in call :meth:`_init_wire_precision` from their
    ``__init__`` and read :meth:`bucket_precisions` in their exchange."""

    def _init_wire_precision(self, wire_precision: str) -> None:
        if wire_precision not in VALID_WIRE_PRECISIONS:
            raise ValueError(
                f"wire_precision must be one of {VALID_WIRE_PRECISIONS}, "
                f"got {wire_precision!r}"
            )
        self.wire_precision = wire_precision
        #: the adopted per-bucket precision plan, aligned with plan.specs;
        #: read only under wire_precision="auto"
        self.bucket_precision: Optional[List[str]] = None

    @property
    def holds_bucketized_state(self) -> bool:
        """The int4 residual is per-bucket state: re-bucketing would desync
        it, and an exchange inside the backward pass could not carry it."""
        return self._ef_enabled()

    def _ef_enabled(self) -> bool:
        return self.wire_precision in ("int4", "auto")

    def _precision_for_bucket(self, bucket_idx: int, spec) -> str:
        if spec.dtype not in FLOAT_DTYPES:
            return "f32"
        if self.wire_precision == "auto":
            if self.bucket_precision is None:
                return "f32"
            return self.bucket_precision[bucket_idx]
        return self.wire_precision

    def bucket_precisions(self, plan) -> List[str]:
        """Resolved wire precision per bucket: what the step uses."""
        return [self._precision_for_bucket(i, spec) for i, spec in enumerate(plan.specs)]

    def set_bucket_precision(self, precisions: Optional[Sequence[str]]) -> None:
        """Adopt a per-bucket precision plan (``None`` clears it).  Needs
        ``wire_precision="auto"``: a pinned precision is never overridden."""
        if precisions is None:
            self.bucket_precision = None
            return
        if self.wire_precision != "auto":
            raise ValueError(
                "per-bucket precision plans require wire_precision='auto' "
                f"(this algorithm is pinned to {self.wire_precision!r})"
            )
        precisions = list(precisions)
        bad = sorted(set(p for p in precisions if p not in WIRE_PRECISIONS))
        if bad:
            raise ValueError(f"unknown wire precisions {bad}; valid: {WIRE_PRECISIONS}")
        plan = getattr(self, "_bound_plan", None)
        if plan is not None and len(precisions) != len(plan.specs):
            raise ValueError(
                f"precision plan has {len(precisions)} entries for {len(plan.specs)} buckets"
            )
        self.bucket_precision = precisions

    def wire_bytes_by_precision(self, plan) -> dict:
        """Modelled wire bytes one rank moves per step, by precision, on the
        ring model: an N-byte f32 bucket's allreduce moves ``2*N*(n-1)/n``;
        a quantized bucket moves :func:`ring_wire_bytes`."""
        n = self.process_group.size
        out: dict = {}
        for spec, prec in zip(plan.specs, self.bucket_precisions(plan)):
            if prec == "f32":
                nb = 2 * spec.nbytes * (n - 1) // n
            else:
                nb = ring_wire_bytes(spec.numel, n, PRECISION_BITS[prec])
            out[prec] = out.get(prec, 0) + nb
        return out
