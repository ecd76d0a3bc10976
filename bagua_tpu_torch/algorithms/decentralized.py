"""Decentralized SGD, full and low precision (the port of
``bagua_tpu/algorithms/decentralized.py``), on rank-stacked tensors.

**Full precision**: every step the *weights* are exchanged with peers,
``all`` (an AVG allreduce) or ``shift_one`` (a symmetric pairing that
cycles with the exchange count: rank r < n/2 pairs with ``((round + r) %
(n/2)) + n/2``), and the averaged weights replace the parameters before
the optimizer applies the gradients taken at the old ones.  One bucket
holds the whole model, unless overlap is on: then each bucket's weights
are exchanged from inside the backward pass as its gradients complete
(the engine's ``"weight"`` mode).  Averaging is elementwise, so the split
changes no bit.  The JAX package picks the ``shift_one`` branch with
``lax.switch`` on the traced step; here the step is a Python int and the
branch is picked in Python.

**Low precision** runs after the optimizer step.  Each rank keeps three
replicas per bucket: ``weight`` (its own weights at the last exchange),
``left`` and ``right`` (its ring neighbours').  It compresses

    diff = t + left/3 + right/3 - 5 w/3        (t: the post-optimizer weights)

with MinMaxUInt8, one row per rank (the whole bucket one chunk), sends it
both ways round the ring, adds what arrives to the neighbour replicas, and
sets both ``weight`` and the parameters to ``w + dequant(own diff)``, so
every rank's view of every replica stays the same bits.  Each step that
is one compress and three decompresses per bucket, of ``(size, numel)``.

``hierarchical=True`` (the default) averages over the ``intra`` axis first
and runs the exchange over the ``inter`` axis, so the peers are nodes.
Gossip (``staleness_tau``) is not ported.
"""

from typing import List, Optional, Tuple

import torch

from bagua_tpu_torch.algorithms.base import Algorithm, AlgorithmImpl, OverlapCapability, StepContext
from bagua_tpu_torch.bucket import flatten_bucket_leaves, split_bucket_flat
from bagua_tpu_torch.communication import (
    INTER_AXIS,
    INTRA_AXIS,
    ReduceOp,
    allreduce,
    axis_size,
    ppermute_apply,
    ppermute_shift,
)
from bagua_tpu_torch.kernels.minmax_uint8 import compress_minmax_uint8, decompress_minmax_uint8

#: one bucket for the whole model (the reference's layout)
WHOLE_MODEL_BUCKET = 1 << 62


def _shift_one_perm(step: int, n: int) -> List[Tuple[int, int]]:
    """The step-indexed symmetric pairing: rank < n/2 pairs with ``((step +
    rank) % (n/2)) + n/2``, as ``(rank, peer)`` pairs."""
    h = n // 2
    perm = []
    for r in range(n):
        if r < h:
            peer = ((step + r) % h) + h
        else:
            peer = (r - h - step) % h
        perm.append((r, peer))
    return perm


def _exchange(flat: torch.Tensor, comm_round: int, mode: str, group, axis) -> torch.Tensor:
    """One decentralized exchange of the stacked ``(size, numel)`` weights
    over ``axis``: the averaged peer weights."""
    n = axis_size(group, axis)
    if n == 1:
        return flat
    if mode == "all":
        return allreduce(flat, ReduceOp.AVG, group, axis)
    if mode == "shift_one":
        if n % 2:
            raise ValueError(
                "shift_one requires an even number of peers: world size "
                f"{n} cannot be symmetrically paired (ranks split into "
                "lower/upper halves, and the middle rank would land in "
                "both schedules). Resize the gang to an even world size "
                f"(e.g. {n - 1} or {n + 1}) or use "
                "peer_selection_mode='all' — see reference "
                "decentralized_full_precision_synchronous.rs:71-79"
            )
        recv = ppermute_apply(flat, _shift_one_perm(comm_round % (n // 2), n), group, axis)
        return (flat + recv) * 0.5
    raise ValueError(f"unknown peer_selection_mode {mode!r}")


class _PeerExchange(AlgorithmImpl):
    """What the decentralized pair shares: the axis their peers sit on and
    their bucket plan."""

    def _axis(self):
        """``inter`` under ``hierarchical`` (the intra axis is averaged
        first), else every rank."""
        if self.hierarchical and self.process_group.intra_size > 1:
            return INTER_AXIS
        return None

    def tensors_to_buckets(self, tree, bucket_size_bytes=None):
        """One bucket for the whole model (the reference's layout: one
        exchange, and for low precision one min/max a rank); under overlap
        the default plan, so that each bucket goes on its own."""
        if self.overlap_hint:
            return super().tensors_to_buckets(tree, bucket_size_bytes)
        return super().tensors_to_buckets(tree, WHOLE_MODEL_BUCKET)


class DecentralizedAlgorithmImpl(_PeerExchange):
    algo_name = "decentralized"
    supports_overlap = True
    #: the exchange moves weights, issued as each bucket's gradients complete
    overlap_mode = "weight"

    def __init__(self, process_group, hierarchical: bool = True, peer_selection_mode: str = "all",
                 communication_interval: int = 1, staleness_tau: Optional[int] = None):
        super().__init__(process_group, hierarchical=hierarchical)
        if staleness_tau is not None:
            raise NotImplementedError(
                "gossip staleness (staleness_tau) is not ported yet; it comes with the engine's "
                "staleness knobs (ROADMAP Queue 1 item 4); pass staleness_tau=None"
            )
        self.peer_selection_mode = peer_selection_mode
        self.communication_interval = communication_interval
        if peer_selection_mode == "shift_one":
            peers = axis_size(process_group, self._axis())
            if peers > 1 and peers % 2:
                raise ValueError(
                    "peer_selection_mode='shift_one' requires an even number "
                    f"of peers: this group exchanges across {peers} peers "
                    f"(group {process_group!r}), which cannot be "
                    "symmetrically paired. Resize the gang to an even peer "
                    f"count (e.g. {peers - 1} or {peers + 1}) or use "
                    "peer_selection_mode='all' — see reference "
                    "decentralized_full_precision_synchronous.rs:71-79"
                )

    def _exchange_flat(self, flat: torch.Tensor, comm_round: int) -> torch.Tensor:
        group = self.process_group
        if self._axis() == INTER_AXIS:
            flat = allreduce(flat, ReduceOp.AVG, group, INTRA_AXIS)
        return _exchange(flat, comm_round, self.peer_selection_mode, group, self._axis())

    def _exchanges(self, step: int) -> bool:
        return step % self.communication_interval == 0

    def transform_gradients(self, grads, params, state, ctx: StepContext):
        """The averaged peer weights replace the parameters; the gradients
        pass as they are.  ``comm_round`` counts the exchanges, so the
        ``shift_one`` schedule meets every peer whatever the interval."""
        if self._exchanges(ctx.step):
            comm_round = ctx.step // self.communication_interval
            params = ctx.plan.debucketize(
                [self._exchange_flat(flat, comm_round) for flat in ctx.plan.bucketize(params)])
        return grads, params, state

    def overlap_exchange(self, bucket_idx: int, grads, ctx: StepContext, params_leaves=None):
        """One bucket's weights exchanged (``"weight"`` mode), on the very
        flat tensor :meth:`BucketPlan.bucketize` builds: the monolithic
        path's bits."""
        if not self._exchanges(ctx.step):
            return list(params_leaves)
        spec = ctx.plan.specs[bucket_idx]
        flat = flatten_bucket_leaves(params_leaves, spec)
        return split_bucket_flat(self._exchange_flat(flat, ctx.step // self.communication_interval), spec)


class DecentralizedAlgorithm(Algorithm):
    def __init__(self, hierarchical: bool = True, peer_selection_mode: str = "all",
                 communication_interval: int = 1, staleness_tau: Optional[int] = None):
        self.hierarchical = hierarchical
        self.peer_selection_mode = peer_selection_mode
        self.communication_interval = communication_interval
        self.staleness_tau = staleness_tau

    def reify(self, process_group) -> DecentralizedAlgorithmImpl:
        return DecentralizedAlgorithmImpl(
            process_group, hierarchical=self.hierarchical,
            peer_selection_mode=self.peer_selection_mode,
            communication_interval=self.communication_interval,
            staleness_tau=self.staleness_tau,
        )


# ---------------------------------------------------------------------------
# Low precision: compressed weight differences round the ring
# ---------------------------------------------------------------------------


class LowPrecisionDecentralizedAlgorithmImpl(_PeerExchange):
    algo_name = "low_precision_decentralized"
    #: the replicas are laid out on the bound plan: a rebucket would desync them
    holds_bucketized_state = True
    supports_overlap = True
    overlap_mode = "post_step"

    def __init__(self, process_group, hierarchical: bool = True, communication_interval: int = 1):
        super().__init__(process_group, hierarchical=hierarchical)
        self.communication_interval = communication_interval

    def overlap_capability(self) -> OverlapCapability:
        """Overlap only splits the plan (each bucket's chain on its own);
        ``auto=False``, since per-bucket min/max quantize otherwise than the
        whole model's."""
        return OverlapCapability(
            True, mode="post_step", auto=False,
            reason="LowPrecisionDecentralizedAlgorithmImpl overlap changes "
            "quantization granularity (per-bucket min/max); enable explicitly "
            "with overlap=True",
        )

    def init_state(self, params):
        """``weight``, ``left`` and ``right`` per bucket, each ``(size,
        numel)`` on the group's device, from ``params`` (one rank's tree,
        which every rank starts from).  They start as one tensor: no stage
        writes them in place."""
        group = self.process_group
        flats = [flat.to(group.device).unsqueeze(0).repeat(group.size, 1)
                 for flat in self._bound_plan.bucketize(params)]
        return {"weight": list(flats), "left": list(flats), "right": list(flats)}

    def _ring_step(self, t, w, left, right):
        """One bucket's exchange: ``(new weights, new left, new right)``.
        ``t + l / 3``: XLA rewrites a division by a constant as a multiply
        by its reciprocal and contracts the multiply-add into one fused
        multiply-add; ``torch.add(..., alpha=)`` is that operation."""
        group, axis = self.process_group, self._axis()
        third = 1.0 / 3.0
        diff = torch.add(torch.add(torch.add(t, left, alpha=third), right, alpha=third), w, alpha=-5.0 / 3.0)
        q, mm = compress_minmax_uint8(diff)
        # shift +1 receives from the left peer, -1 from the right
        left = left + decompress_minmax_uint8(ppermute_shift(q, 1, group, axis), ppermute_shift(mm, 1, group, axis))
        right = right + decompress_minmax_uint8(ppermute_shift(q, -1, group, axis),
                                                ppermute_shift(mm, -1, group, axis))
        t_new = decompress_minmax_uint8(q, mm) + w
        return t_new.to(t.dtype), left.to(t.dtype), right.to(t.dtype)

    def on_step_end(self, params, state, ctx: StepContext):
        if ctx.step % self.communication_interval:
            return params, state
        flats = ctx.plan.bucketize(params)
        if self._axis() == INTER_AXIS:
            flats = [allreduce(f, ReduceOp.AVG, self.process_group, INTRA_AXIS) for f in flats]
        new = [self._ring_step(*bucket) for bucket in zip(flats, state["weight"], state["left"], state["right"])]
        weight, left, right = (list(x) for x in zip(*new))
        return ctx.plan.debucketize(weight), {"weight": weight, "left": left, "right": right}


class LowPrecisionDecentralizedAlgorithm(Algorithm):
    def __init__(self, hierarchical: bool = True, communication_interval: int = 1):
        self.hierarchical = hierarchical
        self.communication_interval = communication_interval

    def reify(self, process_group) -> LowPrecisionDecentralizedAlgorithmImpl:
        return LowPrecisionDecentralizedAlgorithmImpl(
            process_group, hierarchical=self.hierarchical,
            communication_interval=self.communication_interval,
        )
