"""Operations whose batching rule keeps each rank's own kernel.

The engine runs the ranks' forward and backward as one ``torch.func.vmap``
over rank-stacked parameters (:mod:`bagua_tpu_torch.ddp`).  There
``F.conv2d`` with a batched weight becomes one grouped convolution over an
NCHW tensor with the ranks folded into the channels, and cuDNN converts
that layout on the way in and out (``nchwToNhwcKernel``,
``nhwcToNchwKernel``).  :func:`rank_conv2d` gives the convolution a
``vmap`` rule of its own: one ``F.conv2d`` per rank on that rank's input
and weight, stacked along a new leading dim.  Autograd then records plain
per-rank convolutions in layer order, each rank's input keeps its own
layout (an NHWC view stays one), and a stacked leaf still gets one
gradient from one backward over every rank.

:func:`rank_alltoall` is the expert-parallel exchange of the MoE layer:
its ``vmap`` rule sees the rank-stacked tensor and runs the group's stacked
:func:`~bagua_tpu_torch.communication.alltoall` on it, so autograd records
the permutation and its transpose is the backward's exchange.  The
engine's ``vmap`` runs over the ranks this process holds
(``group.local_size``: every rank of a single-controller group), so the
rules see the local stack, the one a group that spans processes takes.

:func:`rank_collective` does the same for the rank-stacked models'
collectives (the tensor-parallel layers' ``psum``, gathers and rings):
outside a ``vmap`` it runs the collective on the stack it is given; under
the engine's ``vmap``, where each rank's model sees a rank axis of one
(``models.bert.one_rank``), its rule runs the collective on the whole
stack, so a rank's tp peers are there and the backward is the one the
hand-scheduled step takes through the same collective.

:func:`over_ranks` marks code that runs under a ``vmap`` over a group's
ranks (the engine enters it around its forward).  A model's collectives
that bind axes only there, as a JAX model's bind only under
``shard_map`` (:class:`~bagua_tpu_torch.contrib.sync_batchnorm.SyncBatchNorm`),
read the group from :func:`ranks_group`.
"""

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from bagua_tpu_torch.communication import alltoall, axis_size


#: the group whose ranks the current ``vmap`` runs over, where one is entered
_RANKS: contextvars.ContextVar = contextvars.ContextVar("bagua_vmap_ranks", default=None)


@contextlib.contextmanager
def over_ranks(group):
    """Within, code runs under a ``vmap`` over ``group``'s ranks (on this
    thread)."""
    token = _RANKS.set(group)
    try:
        yield
    finally:
        _RANKS.reset(token)


def ranks_group():
    """The group :func:`over_ranks` entered, or None outside one."""
    return _RANKS.get()


def _ranks(t: torch.Tensor, dim, n: int):
    """The ``n`` per-rank slices of ``t`` batched at ``dim``, or ``t``
    expanded to ``n`` where it is not batched."""
    if dim is None:
        return t.expand(n, *t.shape).unbind(0)
    # unbind, not t[r]: the backward of an index hands each rank a
    # zero-filled tensor of the whole stack
    return t.movedim(dim, 0).unbind(0)


class _RankConv2d(torch.autograd.Function):
    """``F.conv2d(x, w, stride=stride, padding=padding)``, no bias, one group."""

    @staticmethod
    def forward(x, w, padding, stride):
        return F.conv2d(x, w, stride=stride, padding=padding)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, padding, stride = inputs
        ctx.save_for_backward(x, w)
        ctx.padding, ctx.stride = padding, stride

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx, gw, _ = torch.ops.aten.convolution_backward(
            gy, x, w, None, [ctx.stride, ctx.stride], [ctx.padding, ctx.padding], [1, 1], False,
            [0, 0], 1, [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False],
        )
        return gx, gw, None, None

    @staticmethod
    def vmap(info, in_dims, x, w, padding, stride):
        xs = _ranks(x, in_dims[0], info.batch_size)
        ws = _ranks(w, in_dims[1], info.batch_size)
        return torch.stack([F.conv2d(xr, wr, stride=stride, padding=padding)
                            for xr, wr in zip(xs, ws)]), 0


def rank_conv2d(x: torch.Tensor, w: torch.Tensor, padding: int, stride: int = 1) -> torch.Tensor:
    """``F.conv2d(x, w, stride=stride, padding=padding)`` (NCHW input, OIHW
    weight); under ``vmap``, one convolution per rank in place of a grouped
    one."""
    return _RankConv2d.apply(x, w, padding, stride)


class _RankAllToAll(torch.autograd.Function):
    """The tiled all-to-all of each rank's first dim over ``axis`` of
    ``group``; it exists only under ``vmap`` over the group's ranks."""

    @staticmethod
    def forward(x, group, axis):
        raise RuntimeError(
            "rank_alltoall runs under torch.func.vmap over the group's ranks (the engine's "
            "loss, or a vmap over a rank-stacked input); outside one there is no rank to "
            "exchange with"
        )

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, x, group, axis):
        if info.batch_size != group.local_size:
            raise ValueError(f"rank_alltoall under a vmap of {info.batch_size}, over a group whose "
                             f"process holds {group.local_size} ranks")
        # functorch calls this rule only for a batched x
        return alltoall(x.movedim(in_dims[0], 0), group, axis), 0


def rank_alltoall(x: torch.Tensor, group, axis) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis=0, concat_axis=0, tiled=True)``
    inside the engine's ``vmap`` over ``group``'s ranks: each rank's ``x``
    is cut along its first dim into one chunk per member of its collective
    over ``axis``, chunk j goes to member j, and each rank gets the chunks
    it received in member order.  Its gradient is the exchange back."""
    n = axis_size(group, axis)
    if x.shape[0] % n:
        raise ValueError(f"rank_alltoall: dim {x.shape[0]} does not divide into {n} chunks")
    return _RankAllToAll.apply(x, group, axis)


class _RankCollective(torch.autograd.Function):
    """``fn(*stacked)`` on the group's whole rank stack; it exists only
    under ``vmap`` over the group's ranks."""

    @staticmethod
    def forward(fn, group, *tensors):
        raise RuntimeError(
            f"a collective over a group whose process holds {group.local_size} ranks was given a "
            f"stack of {tensors[0].shape[0]}: outside torch.func.vmap over the group's ranks the "
            "stacked models take every local rank's slice at once"
        )

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, fn, group, *tensors):
        if info.batch_size != group.local_size:
            raise ValueError(f"a collective under a vmap of {info.batch_size}, over a group whose "
                             f"process holds {group.local_size} ranks")
        stacked = []
        for t, dim in zip(tensors, in_dims[2:]):
            t = t.expand(group.local_size, *t.shape) if dim is None else t.movedim(dim, 0)
            if t.shape[1] != 1:
                raise ValueError(f"under the engine's vmap a rank's stack has one rank, got "
                                 f"{t.shape[1]}")
            stacked.append(t.select(1, 0))
        return fn(*stacked).unsqueeze(1), 0


def rank_collective(fn, group, *tensors: torch.Tensor) -> torch.Tensor:
    """``fn(*tensors)``, a collective over ``group`` on rank-stacked
    ``(local_size, ...)`` tensors (this process's ranks: every rank of a
    single-controller group), returning one; inside a ``vmap`` over the
    process's ranks, where each rank holds ``(1, ...)``, ``fn`` runs on the
    ``(local_size, ...)`` stack of them, which the collectives of a group
    that spans processes take, and each rank gets its own slice back."""
    batched = any(torch._C._functorch.is_batchedtensor(t) for t in tensors)
    if not batched and tensors[0].shape[0] == group.local_size:
        return fn(*tensors)
    return _RankCollective.apply(fn, group, *tensors)
