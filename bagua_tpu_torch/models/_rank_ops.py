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
"""

import torch
import torch.nn.functional as F


def _ranks(t: torch.Tensor, dim, n: int):
    """The ``n`` per-rank slices of ``t`` batched at ``dim``, or ``t``
    expanded to ``n`` where it is not batched."""
    if dim is None:
        return t.expand(n, *t.shape).unbind(0)
    # unbind, not t[r]: the backward of an index hands each rank a
    # zero-filled tensor of the whole stack
    return t.movedim(dim, 0).unbind(0)


class _RankConv2d(torch.autograd.Function):
    """``F.conv2d(x, w, padding=padding)``, stride 1, no bias, one group."""

    @staticmethod
    def forward(x, w, padding):
        return F.conv2d(x, w, padding=padding)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, padding = inputs
        ctx.save_for_backward(x, w)
        ctx.padding = padding

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx, gw, _ = torch.ops.aten.convolution_backward(
            gy, x, w, None, [1, 1], [ctx.padding, ctx.padding], [1, 1], False, [0, 0], 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False],
        )
        return gx, gw, None

    @staticmethod
    def vmap(info, in_dims, x, w, padding):
        xs = _ranks(x, in_dims[0], info.batch_size)
        ws = _ranks(w, in_dims[1], info.batch_size)
        return torch.stack([F.conv2d(xr, wr, padding=padding) for xr, wr in zip(xs, ws)]), 0


def rank_conv2d(x: torch.Tensor, w: torch.Tensor, padding: int) -> torch.Tensor:
    """``F.conv2d(x, w, padding=padding)`` (NCHW input, OIHW weight); under
    ``vmap``, one convolution per rank in place of a grouped one."""
    return _RankConv2d.apply(x, w, padding)
