"""The ``zero`` algorithm: reduce-scatter, sharded update, deferred gather
(the port of ``bagua_tpu/sharded/algorithm.py``).

The wire half of the ZeRO exchange (arXiv:2004.13336).  Three legs per
bucket, two of them here:

1. **reduce-scatter** replaces the all-reduce: each rank receives only the
   reduced values of its contiguous flat shard.  Issued from inside the
   backward pass by the engine's overlap hooks, like every other
   gradient-mode algorithm, or after the backward (monolithic); the same
   operations either way.
2. The optimizer update runs on the shard only: that lives in
   :mod:`bagua_tpu_torch.sharded.updater`, which the engine's
   sharded-update phase calls; it hands back per-bucket *updated parameter
   shards*, stashed in this algorithm's state.
3. **all-gather** of the updated parameter shards is deferred to
   :meth:`ZeroAlgorithmImpl.on_step_start` of the *next* step, and
   *replaces* the parameters (``copy_`` into the stacked tensors, which
   stay the same objects).  At step 0 the pending shards are the initial
   parameters' own, so the gather returns them bit for bit: the port needs
   no step-0 gate.

The exchange hands the engine each bucket's shards alone, ``(size, numel /
n)``: row r is rank r's reduced slice.  The engine passes them to the
updater as they are, in both modes; nothing is embedded in a full-shape
image (the JAX package does that because its leaves must keep their shapes
through a ``custom_vjp``).

ByteGrad composition (``compression="bytegrad"``): the compressed
pipeline's scatter stage already ends with each rank holding its reduced
chunk (compress, all-to-all, fused decompress-reduce-requantize); the
sharded path stops there and decompresses that chunk locally, with no u8
all-gather.  Bitwise that rank's chunk of flat ByteGrad's output, since
decompress works row by row.

``wire_precision`` composition: the reduce-scatter runs as the
blockwise-quantized ring (:mod:`bagua_tpu_torch.kernels.quantized_ring`).
``"int4"`` threads a per-bucket error-feedback residual through the state
(monolithic only: the residual makes the algorithm hold bucketized state,
which fences off overlap and re-bucketing); ``"int8"`` is stateless and
keeps overlap.  The parameter all-gather (leg 3) stays full precision.
Mutually exclusive with ``compression="bytegrad"``.  ``hierarchical`` is
kept for the reference's signature; as there, every leg runs over the
whole group.
"""

from typing import Any, Dict, Optional

import torch

from bagua_tpu_torch.algorithms._precision import FLOAT_DTYPES, PRECISION_BITS, WirePrecisionMixin
from bagua_tpu_torch.algorithms.base import Algorithm, AlgorithmImpl, StepContext
from bagua_tpu_torch.algorithms.bytegrad import compressed_reduce_scatter
from bagua_tpu_torch.bucket import flatten_bucket_leaves, split_bucket_flat
from bagua_tpu_torch.communication import ReduceOp, allgather, rank_id, reduce_scatter
from bagua_tpu_torch.kernels.minmax_uint8 import decompress_minmax_uint8
from bagua_tpu_torch.kernels.quantized_ring import quantized_ring_reduce_scatter
from bagua_tpu_torch.sharded.layout import ShardLayout, reshard_bucket_rows, to_device, to_host
from bagua_tpu_torch.utils import from_bagua_datatype


class ZeroAlgorithmImpl(WirePrecisionMixin, AlgorithmImpl):
    algo_name = "zero"
    supports_overlap = True
    #: tells the engine to run the sharded-update phase
    #: (:class:`~bagua_tpu_torch.sharded.updater.ShardedOptimizerUpdater`)
    #: in place of the whole-tree optimizer step
    sharded_update = True

    def __init__(
        self, process_group, hierarchical: bool = False, average: bool = True,
        compression: Optional[str] = None, wire_precision: str = "f32",
    ):
        super().__init__(process_group, hierarchical=hierarchical)
        if compression not in (None, "bytegrad"):
            raise ValueError(f"zero compression must be None or 'bytegrad', got {compression!r}")
        if compression is not None and wire_precision != "f32":
            raise ValueError(
                "compression and a quantized wire_precision are mutually exclusive "
                "— pick one compression rung"
            )
        self.average = average
        self.compression = compression
        self._init_wire_precision(wire_precision)

    # -- state ---------------------------------------------------------------

    def init_state(self, params) -> Dict[str, Any]:
        """Per-bucket pending parameter shards, ``(size, numel / n)`` in the
        bucket's dtype, n the exchange size: at init, the shards of
        ``params`` (one rank's tree), which every rank starts from, each
        rank holding the shard of its index within the data axes.  With
        int4 error feedback, an f32 ``(size, numel)`` residual per bucket."""
        group = self.process_group
        n = group.exchange_size
        plan = self._bound_plan
        groups = plan.group_leaves(params)
        # this process's ranks' rows: every row when it holds the whole ring
        mine = None if n == group.local_size else rank_id(group, group.data_axes)
        rows = [flatten_bucket_leaves([groups[bi][s.name] for s in spec.slots], spec)
                .to(group.device).reshape(n, spec.numel // n) for bi, spec in enumerate(plan.specs)]
        state = {"pending": tuple(r if mine is None else r[mine] for r in rows)}
        if self._ef_enabled():
            state["qr_residual"] = tuple(
                torch.zeros((group.local_size, spec.numel), dtype=torch.float32, device=group.device)
                for spec in plan.specs
            )
        return state

    def stash_updates(self, state, pending):
        """Called by the engine's sharded-update phase with this step's
        per-bucket updated parameter shards; they ride the state to the
        next step's :meth:`on_step_start`."""
        return {**state, "pending": tuple(pending)}

    def reshard_host_state(self, state, old: ShardLayout, new: ShardLayout):
        """The pending shards moved from layout ``old`` to ``new`` (a
        mid-training rebucket), value for value by tensor name, on the
        host.  Error-feedback residuals do not migrate (dropping them loses
        one step of compensation, not correctness): they restart at zero."""
        device = self.process_group.device
        rows = reshard_bucket_rows([to_host(p) for p in state["pending"]], old, new)
        out = {"pending": tuple(to_device(r, from_bagua_datatype(b.dtype), device)
                                for r, b in zip(rows, new.buckets))}
        if "qr_residual" in state:
            out["qr_residual"] = tuple(
                torch.zeros((new.n_shards, b.numel), dtype=torch.float32, device=device)
                for b in new.buckets
            )
        return out

    # -- leg 3: deferred all-gather --------------------------------------------

    def on_step_start(self, params, state, ctx: StepContext):
        """Complete the parameters: gather every bucket's pending shards and
        copy them into the stacked parameter tensors.  Replace semantics:
        gathering the same pending twice is idempotent, so
        ``finalize_pending_updates`` is always safe, and pending is not
        cleared."""
        groups = ctx.plan.group_leaves(params)
        for bi, spec in enumerate(ctx.plan.specs):
            with self.annotate(bi, "ag"):
                full = allgather(state["pending"][bi], self.process_group)
            for s, g in zip(spec.slots, split_bucket_flat(full, spec)):
                groups[bi][s.name].copy_(g)
        return params, state

    # -- leg 1: reduce-scatter ---------------------------------------------------

    def _reduce_scatter_flat(self, flat, spec, precision="f32", residual=None):
        """Each rank's reduced shard of one bucket's stacked ``(size,
        numel)`` flat buffer: ``(shard (size, numel / n), new_residual)``,
        ``new_residual`` None except on the ring with error feedback."""
        group = self.process_group
        if precision in PRECISION_BITS and spec.dtype in FLOAT_DTYPES:
            x = flat.to(torch.float32)
            if residual is not None:
                x = x + residual
            shard, err = quantized_ring_reduce_scatter(
                x, group, bits=PRECISION_BITS[precision], average=self.average
            )
            return shard.to(flat.dtype), (err if residual is not None else None)
        if self.compression == "bytegrad" and spec.dtype in FLOAT_DTYPES:
            q2, mm2 = compressed_reduce_scatter(flat, group, average=self.average)
            # flat ByteGrad would all-gather (q2, mm2) here; the sharded path
            # decompresses its own chunk: bitwise that row of ByteGrad's output
            shard = decompress_minmax_uint8(q2.reshape(group.local_size, -1), mm2.reshape(group.local_size, 2))
            return shard.to(flat.dtype), None
        op = ReduceOp.AVG if self.average else ReduceOp.SUM
        return reduce_scatter(flat, op, group), None

    def _exchange_bucket(self, bucket_idx, grads, ctx: StepContext, residual=None):
        """One bucket's exchange: its stacked gradient leaves (slot order)
        reduce-scattered, ``(shard (size, numel / n), new_residual)``."""
        spec = ctx.plan.specs[bucket_idx]
        with self.annotate(bucket_idx, "rs"):
            return self._reduce_scatter_flat(
                flatten_bucket_leaves(grads, spec), spec, self._precision_for_bucket(bucket_idx, spec), residual
            )

    def transform_gradients(self, grads, params, state, ctx: StepContext):
        """The gradients out are each bucket's shards, plan order: what the
        engine's sharded-update phase takes."""
        groups = ctx.plan.group_leaves(grads)
        resid = list(state["qr_residual"]) if "qr_residual" in state else None
        shards = []
        for bi, spec in enumerate(ctx.plan.specs):
            r = resid[bi] if resid is not None and self._precision_for_bucket(bi, spec) == "int4" else None
            shard, new_r = self._exchange_bucket(bi, [groups[bi][s.name] for s in spec.slots], ctx, r)
            if new_r is not None:
                resid[bi] = new_r
            shards.append(shard)
        if resid is not None:
            state = {**state, "qr_residual": tuple(resid)}
        return shards, params, state

    def overlap_exchange(self, bucket_idx: int, grads, ctx: StepContext, params_leaves=None):
        """The same operations as :meth:`transform_gradients` runs on the
        bucket; returns ``[shard]``.  Error feedback never gets here: int4
        and ``"auto"`` hold bucketized state, which refuses overlap."""
        return [self._exchange_bucket(bucket_idx, list(grads), ctx)[0]]


class ZeroAlgorithm(Algorithm):
    """ZeRO-sharded data parallelism: reduce-scatter the gradients, update
    only each rank's shard (optimizer state at ``1/n`` per rank), all-gather
    the updated shards into the next step's parameters."""

    def __init__(
        self, hierarchical: bool = False, average: bool = True,
        compression: Optional[str] = None, wire_precision: str = "f32",
    ):
        self.hierarchical = hierarchical
        self.average = average
        self.compression = compression
        self.wire_precision = wire_precision

    def reify(self, process_group) -> ZeroAlgorithmImpl:
        return ZeroAlgorithmImpl(
            process_group, hierarchical=self.hierarchical, average=self.average,
            compression=self.compression, wire_precision=self.wire_precision,
        )
