"""Centralized synchronous gradient allreduce.

The port of ``bagua_tpu/algorithms/gradient_allreduce.py``: one allreduce
per bucket, flat or hierarchical (intra-axis reduce, then inter-axis),
averaging or summing.

``fuse``: ``"tuple"`` (the default) reduces a bucket's leaves one by one,
``"flat"`` reduces its padded flat tensor; the stacked allreduce is
elementwise, so the two give the same bits.  ``wire_dtype`` casts floating
gradients to a narrower dtype for the exchange only (``torch.bfloat16``
halves the wire's bytes); the sum runs in that dtype and the result is cast
back.

``wire_precision`` (the in-collective quantization rung below ByteGrad):
``"int8"``/``"int4"`` route a bucket's padded flat buffer through the
blockwise-quantized ring (:mod:`bagua_tpu_torch.kernels.quantized_ring`):
every hop ships int8 or packed int4 levels plus an 8-byte (min, max)
sidecar per block, and each receiving rank dequantizes, adds and
requantizes in one fused kernel.  ``"int4"`` also carries a per-bucket
error-feedback residual (``qr_residual``) in the algorithm state: this
step's requantization error re-enters the next step's gradient.  ``"auto"``
follows an adopted per-bucket plan (``DistributedDataParallel.
apply_precision_plan``) and is f32 until one is adopted.  Under
``hierarchical=True`` only the inter-axis ring quantizes; the intra-axis
sum stays exact f32.  A quantized ``wire_precision`` excludes
``wire_dtype``.  ``"int4"`` and ``"auto"`` hold per-bucket state, so they
run neither with overlap nor through a rebucket.
"""

import torch

from bagua_tpu_torch.algorithms._precision import PRECISION_BITS, WirePrecisionMixin
from bagua_tpu_torch.algorithms.base import Algorithm, AlgorithmImpl, StepContext
from bagua_tpu_torch.bucket import flatten_bucket_leaves, split_bucket_flat
from bagua_tpu_torch.communication import (
    INTER_AXIS,
    INTRA_AXIS,
    ReduceOp,
    allreduce,
    allreduce_many,
    hierarchical_allreduce_many,
)
from bagua_tpu_torch.kernels.quantized_ring import quantized_ring_allreduce


class GradientAllReduceAlgorithmImpl(WirePrecisionMixin, AlgorithmImpl):
    algo_name = "gradient_allreduce"
    supports_overlap = True

    def __init__(
        self, process_group, hierarchical: bool = False, average: bool = True,
        fuse: str = "tuple", wire_dtype=None, wire_precision: str = "f32",
    ):
        super().__init__(process_group, hierarchical=hierarchical)
        self.average = average
        if fuse not in ("tuple", "flat"):
            raise ValueError(f"fuse must be 'tuple' or 'flat', got {fuse!r}")
        self.fuse = fuse
        self.wire_dtype = wire_dtype
        if wire_precision != "f32" and wire_dtype is not None:
            raise ValueError(
                "wire_dtype and a quantized wire_precision are mutually exclusive "
                "— pick one compression rung"
            )
        self._init_wire_precision(wire_precision)

    def init_state(self, params):
        """Error-feedback residuals: one stacked ``(size, numel)`` f32
        tensor per bucket when the precision may resolve to int4 (always
        under ``"auto"``, so the state's layout never depends on the adopted
        plan; f32 and int8 buckets carry zeros)."""
        if not self._ef_enabled():
            return {}
        group = self.process_group
        return {
            "qr_residual": tuple(
                torch.zeros((group.local_size, spec.numel), dtype=torch.float32, device=group.device)
                for spec in self._bound_plan.specs
            )
        }

    def _quantized_bucket_allreduce(self, flat, precision, residual):
        """All-reduce one bucket's stacked ``(size, numel)`` flat buffer
        through the blockwise ring; returns ``(out, new_residual)``
        (``new_residual`` is None when error feedback is off for it).

        The ring sums and divides once at the end, so a hop's error ``e``
        makes the average short by ``e / n``: adding ``e`` to the next
        step's gradient restores exactly that."""
        bits = PRECISION_BITS[precision]
        group = self.process_group
        x = flat.to(torch.float32)
        if residual is not None:
            x = x + residual
        if self.hierarchical:
            # every rank of an intra group holds the same inter-ring error,
            # so the residual is divided by intra_size: the next step's
            # intra sum multiplies it back
            x = allreduce(x, ReduceOp.SUM, group, INTRA_AXIS)
            out, err = quantized_ring_allreduce(x, group, INTER_AXIS, bits=bits, average=False)
            if self.average:
                out = out / torch.full_like(out, group.size)
            if residual is not None:
                err = err / torch.full_like(err, group.intra_size)
        else:
            out, err = quantized_ring_allreduce(x, group, bits=bits, average=self.average)
        return out.to(flat.dtype), (err if residual is not None else None)

    def _reduce(self, xs):
        """One allreduce of the tensors ``xs`` over the group, in the wire
        dtype: a single variadic collective (each leg of it, hierarchical),
        as the JAX package's ``psum`` of the leaves' tuple."""
        op = ReduceOp.AVG if self.average else ReduceOp.SUM
        wires = [x.to(self.wire_dtype) if self.wire_dtype is not None and x.is_floating_point() else x
                 for x in xs]
        if self.hierarchical:
            out = hierarchical_allreduce_many(wires, op, self.process_group)
        else:
            out = allreduce_many(wires, op, self.process_group)
        return [o.to(x.dtype) for o, x in zip(out, xs)]

    def _exchange_bucket(self, leaves, spec, precision, residual=None):
        """One bucket's exchange on its stacked leaves (slot order); returns
        ``(leaves, new_residual)``.  f32: per leaf (tuple) or on the padded
        flat tensor (flat); quantized: the ring on the flat tensor."""
        if precision == "f32":
            if self.fuse == "tuple":
                return self._reduce(leaves), None
            return split_bucket_flat(self._reduce([flatten_bucket_leaves(leaves, spec)])[0], spec), None
        out, new_r = self._quantized_bucket_allreduce(
            flatten_bucket_leaves(leaves, spec), precision, residual
        )
        return split_bucket_flat(out, spec), new_r

    def transform_gradients(self, grads, params, state, ctx: StepContext):
        resid = list(state["qr_residual"]) if "qr_residual" in state else None
        groups = ctx.plan.group_leaves(grads)
        out = []
        for i, (spec, prec) in enumerate(zip(ctx.plan.specs, self.bucket_precisions(ctx.plan))):
            r = resid[i] if resid is not None and prec == "int4" else None
            with self.annotate(i, "mono"):
                red, new_r = self._exchange_bucket([groups[i][s.name] for s in spec.slots], spec, prec, r)
            if new_r is not None:
                resid[i] = new_r
            out.append(dict(zip((s.name for s in spec.slots), red)))
        if resid is not None:
            state = {**state, "qr_residual": tuple(resid)}
        return ctx.plan.ungroup_leaves(out, grads), params, state

    def overlap_exchange(self, bucket_idx: int, grads, ctx: StepContext, params_leaves=None):
        """One bucket's exchange from inside the backward pass: the same
        operations as :meth:`transform_gradients` runs on it.  int4 and
        ``"auto"`` never get here (``holds_bucketized_state``)."""
        spec = ctx.plan.specs[bucket_idx]
        with self.annotate(bucket_idx, "overlap"):
            return self._exchange_bucket(list(grads), spec, self._precision_for_bucket(bucket_idx, spec))[0]


class GradientAllReduceAlgorithm(Algorithm):
    def __init__(
        self, hierarchical: bool = False, average: bool = True, fuse: str = "tuple",
        wire_dtype=None, wire_precision: str = "f32",
    ):
        self.hierarchical = hierarchical
        self.average = average
        self.fuse = fuse
        self.wire_dtype = wire_dtype
        self.wire_precision = wire_precision

    def reify(self, process_group) -> GradientAllReduceAlgorithmImpl:
        return GradientAllReduceAlgorithmImpl(
            process_group, hierarchical=self.hierarchical, average=self.average,
            fuse=self.fuse, wire_dtype=self.wire_dtype, wire_precision=self.wire_precision,
        )
