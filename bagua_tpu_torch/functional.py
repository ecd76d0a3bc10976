"""Differentiable collectives (the port of ``bagua_tpu/functional.py``).

The reference wraps ``all_reduce`` in a ``torch.autograd.Function`` whose
backward is the same all_reduce of the output cotangents
(``data_parallel/functional.py:56-79``); so does this module, over
rank-stacked tensors.  For SUM and AVG that backward is the transpose of
the reduction, the gradient the JAX package's ``jax.grad`` gives; for the
other ops it is the reference's symmetric rule.
"""

from typing import Optional

import torch

from bagua_tpu_torch.communication import BaguaProcessGroup, allreduce
from bagua_tpu_torch.defs import ReduceOp


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op, group, axis):
        ctx.op, ctx.group, ctx.axis = op, group, axis
        return allreduce(x, op, group, axis)

    @staticmethod
    def backward(ctx, grad):
        return allreduce(grad, ctx.op, ctx.group, ctx.axis), None, None, None


def all_reduce_inplace(
    x: torch.Tensor, op: ReduceOp = ReduceOp.AVG, axis=None, comm: Optional[BaguaProcessGroup] = None
) -> torch.Tensor:
    """Differentiable allreduce of each rank's slice over ``axis`` of the
    group (the in-step form: ``axis`` ``"inter"``, ``"intra"`` or None for
    every rank)."""
    return _AllReduce.apply(x, ReduceOp(op), comm, axis)


def all_reduce(
    tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVG, group: Optional[BaguaProcessGroup] = None
) -> torch.Tensor:
    """Differentiable eager allreduce over every rank of ``group``: the
    gradient of each rank's input is the same reduction of the output
    cotangents."""
    return all_reduce_inplace(tensor, op, None, group)
