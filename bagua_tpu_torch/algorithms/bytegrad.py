"""ByteGrad: centralized synchronous 8-bit-compressed gradient allreduce.

The port of ``bagua_tpu/algorithms/bytegrad.py``, on rank-stacked tensors.
The compressed allreduce is the reference's scatter-gather pipeline:

    compress → alltoall → fused decompress-reduce-requantize
             → allgather → decompress

Each rank quantizes its bucket per destination chunk (chunk = numel / n,
exact because the bucket plan pads to the exchange size), reduces the chunk
it owns in float32, re-quantizes it, and gathers everyone's chunk.  Every
quantizer call covers all ranks at once, so one bucket costs one launch of
each of the three kernels.

Hierarchical mode (the default) reduces the ``intra`` axis in full
precision first and runs the compressed pipeline over the ``inter`` axis
only.  With ``intra_size`` equal to the group size that axis has one rank
and nothing is compressed; ``intra_size=1`` compresses across every rank.
"""

import torch

from bagua_tpu_torch.algorithms.base import Algorithm, AlgorithmImpl, StepContext
from bagua_tpu_torch.bucket import flatten_bucket_leaves, split_bucket_flat
from bagua_tpu_torch.communication import (
    INTER_AXIS,
    INTRA_AXIS,
    ReduceOp,
    allgather,
    allreduce,
    alltoall,
    axis_size,
)
from bagua_tpu_torch.kernels.minmax_uint8 import (
    compress_minmax_uint8,
    decompress_minmax_uint8,
    decompress_reduce_requantize,
)


def compressed_reduce_scatter(flat: torch.Tensor, group, axis=None, average: bool = True):
    """The scatter stage of the compressed allreduce of the stacked
    ``(size, numel)`` tensor over ``axis``: compress, all-to-all, fused
    reduce.  Returns each rank's reduced chunk, still quantized: ``(q2
    (size, 1, chunk) uint8, minmax2 (size, 1, 2))``."""
    n = axis_size(group, axis)
    size, numel = flat.shape
    chunk = numel // n
    q, mm = compress_minmax_uint8(flat.reshape(size * n, chunk))
    # (size, n, chunk): rank r's row j is member j's chunk for r
    q_recv = alltoall(q.reshape(size, n, chunk), group, axis)
    mm_recv = alltoall(mm.reshape(size, n, 2), group, axis)
    return decompress_reduce_requantize(q_recv, mm_recv, average=average)


def compressed_allreduce(flat: torch.Tensor, group, axis=None, average: bool = True) -> torch.Tensor:
    """The scatter-gather compressed allreduce of the stacked ``(size,
    numel)`` tensor over ``axis``."""
    n = axis_size(group, axis)
    if n == 1:
        return flat
    size, numel = flat.shape
    chunk = numel // n
    q2, mm2 = compressed_reduce_scatter(flat, group, axis, average)
    qg = allgather(q2, group, axis)  # (size, n, chunk)
    mmg = allgather(mm2, group, axis)  # (size, n, 2)
    out = decompress_minmax_uint8(qg.reshape(size * n, chunk), mmg.reshape(size * n, 2))
    return out.reshape(size, numel).to(flat.dtype)


class ByteGradAlgorithmImpl(AlgorithmImpl):
    algo_name = "bytegrad"
    supports_overlap = True

    def __init__(self, process_group, hierarchical: bool = True, average: bool = True):
        super().__init__(process_group, hierarchical=hierarchical)
        self.average = average

    def _exchange_flat(self, flat, spec):
        """One bucket's exchange."""
        group = self.process_group
        if spec.dtype not in ("f32", "f16", "bf16"):
            # Non-float buckets fall back to plain allreduce, like the
            # reference rejecting non-float tensors for compression.
            return allreduce(flat, ReduceOp.AVG if self.average else ReduceOp.SUM, group)
        if self.hierarchical and group.intra_size > 1:
            intra = allreduce(flat, ReduceOp.SUM, group, INTRA_AXIS)
            red = compressed_allreduce(intra, group, INTER_AXIS, average=False)
            if self.average:
                red = red / torch.full_like(red, group.size)
            return red.to(flat.dtype)
        return compressed_allreduce(flat, group, None, self.average)

    def transform_gradients(self, grads, params, state, ctx: StepContext):
        flats = ctx.plan.bucketize(grads)
        out = [self._exchange_flat(flat, spec) for flat, spec in zip(flats, ctx.plan.specs)]
        return ctx.plan.debucketize(out), params, state

    def overlap_exchange(self, bucket_idx: int, grads, ctx: StepContext, params_leaves=None):
        """One bucket's compressed pipeline from inside the backward pass,
        on the very flat tensor :meth:`BucketPlan.bucketize` builds (same
        chunks, same quantizer inputs), so it gives the monolithic path's
        bits."""
        spec = ctx.plan.specs[bucket_idx]
        return split_bucket_flat(self._exchange_flat(flatten_bucket_leaves(grads, spec), spec), spec)


class ByteGradAlgorithm(Algorithm):
    def __init__(self, hierarchical: bool = True, average: bool = True):
        self.hierarchical = hierarchical
        self.average = average

    def reify(self, process_group) -> ByteGradAlgorithmImpl:
        return ByteGradAlgorithmImpl(
            process_group, hierarchical=self.hierarchical, average=self.average
        )
