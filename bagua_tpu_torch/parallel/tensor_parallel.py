"""Tensor parallelism: column- and row-parallel dense layers over a group
axis (the port of ``bagua_tpu/parallel/tensor_parallel.py``).

A ``tp`` axis of the group shards the hidden dimension, Megatron style:

* :class:`ColumnParallelDense` -- the weight's columns sharded; each rank's
  output is its slice of the features, with no collective.
* :class:`RowParallelDense` -- the weight's rows sharded; it takes the
  sliced features and sums the partial products over the ``tp`` axis
  (``allreduce(SUM)``, JAX's ``psum``).

``fused`` replaces those collectives with the rings of
:mod:`bagua_tpu_torch.kernels.collective_matmul`: the Row product becomes
:func:`~bagua_tpu_torch.kernels.collective_matmul.matmul_rs` (no all-reduce;
an all-gather restores the replicated output unless ``scatter_output``),
and a row-sharded Column input (``gather_input``, the sequence-parallel
layout) becomes :func:`~bagua_tpu_torch.kernels.collective_matmul.ag_matmul`.
``"auto"`` takes the ring wherever its divisibility holds and falls back to
the ``psum`` path otherwise; ``True`` makes an impossible ring an error.

A layer holds flax's ``kernel`` ``(in, out // tp_size)`` or ``(in, out)``
and ``bias``, created in ``dtype`` as the JAX layers create them, and
applies a rank-stacked parameter tree to rank-stacked inputs: ``x (R, ...,
in)`` with ``R`` the group size, or ``R = 1`` inside the engine's ``vmap``
over the group's ranks, where the collectives run on the whole stack
(:func:`~bagua_tpu_torch.models._rank_ops.rank_collective`).  ``tp_axis``
names an axis of the layer's group (``"tp"`` of a named mesh, ``"inter"``
or ``"intra"`` of the legacy one); its size must be ``tp_size`` when
``tp_size > 1``.  At ``tp_size == 1`` no collective runs and ``fused``
has no effect.  Parameters are built on ``device``, by default the current
CUDA device (raises without one).
"""

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from bagua_tpu_torch.communication import (
    _axes, allgather, allreduce, axis_size, get_default_group, rank_id,
)
from bagua_tpu_torch.defs import ReduceOp
from bagua_tpu_torch.kernels.collective_matmul import ag_matmul, matmul_rs
from bagua_tpu_torch.models._rank_ops import rank_collective
from bagua_tpu_torch.observability.annotations import mp_scope
from bagua_tpu_torch.utils import lecun_normal, resolve_device

#: ``ParallelMLP``'s activation: ``jax.nn.gelu``, the tanh approximation by
#: default
gelu = functools.partial(F.gelu, approximate="tanh")


def stacked_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (R, ..., in) @ w (R, in, out)`` per rank, as one batched matmul."""
    R = x.shape[0]
    y = torch.bmm(x.reshape(R, -1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _check_axis(tp_size: int, group, axis_name) -> None:
    if tp_size == 1:
        return
    axes = _axes(axis_name, group)
    unknown = [a for a in axes if a not in group.all_axes]
    if unknown:
        raise ValueError(f"tp axis {unknown} is not an axis of the group: use one of {group.all_axes}")
    n = axis_size(group, axes)
    if n != tp_size:
        raise ValueError(f"tp_size={tp_size} but bound axes {axes} have size {n}")


def _single_axis(axis_name) -> str:
    axes = _axes(axis_name)
    if len(axes) != 1:
        raise ValueError(f"fused collective matmul needs a single mesh axis, got {axes}")
    return axes[0]


def _resolve_fused(fused, tp_size: int) -> bool:
    """``False`` keeps the plain collectives; ``True`` and ``"auto"`` take
    the rings.  Inactive at ``tp_size == 1``."""
    if fused not in (False, True, "auto"):
        raise ValueError(f"fused must be False, True or 'auto', got {fused!r}")
    return tp_size > 1 and bool(fused)


def _per_rank(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A stacked ``(R, features)`` leaf shaped to broadcast against an
    ``ndim``-dim ``(R, ..., features)`` activation."""
    return t.reshape(t.shape[0], *([1] * (ndim - 2)), t.shape[-1])


class _ParallelDense(nn.Module):
    def __init__(self, in_features, kernel_out, bias_features, tp_size, tp_axis, use_bias,
                 dtype, fused, group, device, generator):
        super().__init__()
        _resolve_fused(fused, tp_size)
        self.tp_size, self.tp_axis, self.use_bias = tp_size, tp_axis, use_bias
        self.dtype, self.fused, self._group = dtype, fused, group
        device = resolve_device(device)
        self.kernel = nn.Parameter(lecun_normal((in_features, kernel_out), in_features, dtype,
                                                device, generator))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(bias_features, dtype=dtype, device=device))

    @property
    def group(self):
        return self._group or get_default_group()

    def _add_bias(self, params, y):
        return y + _per_rank(params["bias"], y.dim()) if self.use_bias else y


class ColumnParallelDense(_ParallelDense):
    """``y_local = x @ kernel[:, rank slice] (+ bias slice)``: ``features //
    tp_size`` outputs per rank.

    ``gather_input=True`` takes a row-sharded ``x`` (each rank holds its
    block of the tokens) and gathers it on the fly: through the
    :func:`ag_matmul` ring when ``fused``, else an ``allgather`` and one
    batched matmul.  The output is then ``(R, tp_size * tokens, local)``."""

    def __init__(self, in_features, features, tp_size=1, tp_axis="intra", use_bias=True,
                 dtype=torch.float32, fused=False, gather_input=False, *, group=None,
                 device=None, generator=None):
        if features % tp_size != 0:
            raise ValueError(f"features ({features}) must divide by tp_size ({tp_size})")
        local = features // tp_size
        super().__init__(in_features, local, local, tp_size, tp_axis, use_bias, dtype, fused,
                         group, device, generator)
        self.gather_input = gather_input

    def forward(self, params, x):
        """``params``: this layer's rank-stacked subtree; ``x (R, ..., in)``."""
        group = self.group if self.tp_size > 1 else None
        _check_axis(self.tp_size, group, self.tp_axis)
        w = params["kernel"]
        if self.gather_input and self.tp_size > 1:
            axis = _single_axis(self.tp_axis)
            x2 = x.to(self.dtype).reshape(x.shape[0], -1, x.shape[-1])
            if _resolve_fused(self.fused, self.tp_size):
                y = rank_collective(lambda a, b: ag_matmul(a, b, group, axis, axis_tag="tp"), group, x2, w)
            else:
                with mp_scope("tp", "col_allgather"):
                    xg = rank_collective(lambda a: allgather(a, group, axis), group, x2)
                y = stacked_matmul(xg, w)
        else:
            y = stacked_matmul(x.to(self.dtype), w)
        return self._add_bias(params, y)


class RowParallelDense(_ParallelDense):
    """``y = allreduce_SUM_tp(x_local @ kernel[rank slice, :]) (+ bias)``:
    ``in_features`` is the sliced hidden a rank holds, and the output is
    replicated over the ``tp`` axis.

    When ``fused``, the product and its sum are the :func:`matmul_rs` ring
    and an ``allgather`` of the row blocks restores the replicated output;
    ``scatter_output=True`` skips that and returns this rank's ``(R, tokens
    // tp_size, features)`` row block (the sequence-parallel layout, for the
    next layer's ``gather_input``), on either path."""

    def __init__(self, in_features, features, tp_size=1, tp_axis="intra", use_bias=True,
                 dtype=torch.float32, fused=False, scatter_output=False, *, group=None,
                 device=None, generator=None):
        super().__init__(in_features, features, features, tp_size, tp_axis, use_bias, dtype,
                         fused, group, device, generator)
        self.features, self.scatter_output = features, scatter_output

    def forward(self, params, x):
        group = self.group if self.tp_size > 1 else None
        _check_axis(self.tp_size, group, self.tp_axis)
        w = params["kernel"]
        use_fused = _resolve_fused(self.fused, self.tp_size)
        R, lead = x.shape[0], tuple(x.shape[1:-1])
        tokens = 1
        for d in lead:
            tokens *= d
        if use_fused and tokens % self.tp_size != 0:
            if self.fused == "auto":
                use_fused = False
            else:
                raise ValueError(
                    f"fused RowParallelDense needs the token count ({tokens}) "
                    f"to divide by tp_size ({self.tp_size}); use fused='auto' "
                    "to fall back to the psum path"
                )
        if use_fused:
            axis = _single_axis(self.tp_axis)
            x2 = x.to(self.dtype).reshape(R, tokens, x.shape[-1])
            # this rank's row block
            y = rank_collective(lambda a, b: matmul_rs(a, b, group, axis, axis_tag="tp"), group, x2, w)
            if not self.scatter_output:
                with mp_scope("tp", "row_allgather"):
                    y = rank_collective(lambda a: allgather(a, group, axis), group, y)
                y = y.reshape(R, *lead, self.features)
        else:
            y = stacked_matmul(x.to(self.dtype), w)
            if self.tp_size > 1:
                with mp_scope("tp", "row_psum"):
                    y = rank_collective(lambda a: allreduce(a, ReduceOp.SUM, group, self.tp_axis), group, y)
                if self.scatter_output:
                    if tokens % self.tp_size != 0:
                        raise ValueError(
                            f"scatter_output needs the token count ({tokens}) to "
                            f"divide by tp_size ({self.tp_size})"
                        )
                    axis = _single_axis(self.tp_axis)

                    def own_block(a):
                        blocks = a.reshape(a.shape[0], self.tp_size, tokens // self.tp_size, self.features)
                        idx = rank_id(group, axis).to(a.device)
                        return blocks[torch.arange(a.shape[0], device=a.device), idx]

                    y = rank_collective(own_block, group, y)
        return self._add_bias(params, y)


class ParallelMLP(nn.Module):
    """Column -> GELU (tanh) -> Row feed-forward: one all-reduce in the
    forward, or with ``fused`` none: the Row product runs the
    :func:`matmul_rs` ring and only its closing ``allgather`` is exposed.
    The Column layer never fuses (its input is replicated).  Parameters as
    flax names them: ``ColumnParallelDense_0``, ``RowParallelDense_0``."""

    def __init__(self, in_features, hidden_features, out_features, tp_size=1, tp_axis="intra",
                 dtype=torch.float32, fused=False, *, group=None, device=None, generator=None):
        super().__init__()
        self.ColumnParallelDense_0 = ColumnParallelDense(
            in_features, hidden_features, tp_size, tp_axis, dtype=dtype, group=group,
            device=device, generator=generator)
        self.RowParallelDense_0 = RowParallelDense(
            hidden_features // tp_size, out_features, tp_size, tp_axis, dtype=dtype, fused=fused,
            group=group, device=device, generator=generator)

    def forward(self, params, x):
        h = self.ColumnParallelDense_0(params["ColumnParallelDense_0"], x)
        return self.RowParallelDense_0(params["RowParallelDense_0"], gelu(h))
