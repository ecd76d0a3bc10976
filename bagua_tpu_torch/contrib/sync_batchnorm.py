"""Synchronized batch normalization across data-parallel ranks (the port of
``bagua_tpu/contrib/sync_batchnorm.py``).

The analog of the reference's Horovod-derived ``SyncBatchNorm``
(``contrib/sync_batchnorm.py:31+``), which allgathers per-rank moments and
runs a hand-written backward.  Here, as in the JAX package, the batch mean
and mean of squares go through a mean over the group's ranks (one
collective of the stacked pair a norm) and autograd takes the backward
through it.

The JAX module synchronizes over the axes of ``axis_name`` that the
current ``shard_map`` binds.  The port's counterpart of that binding is a
``vmap`` over a group's ranks entered with
:func:`~bagua_tpu_torch.models._rank_ops.over_ranks` (the engine's forward
enters it): the axes of ``axis_name`` that the group declares are bound,
and each rank's statistics go through
:func:`~bagua_tpu_torch.models._rank_ops.rank_collective`, whose ``vmap``
rule averages them over the whole rank stack, so the gradient flows
through the mean as it does through ``pmean``.  With no bound axis (no
group entered, or a mesh that declares none of ``axis_name``) it is
ordinary batch norm on each rank's batch, as the JAX module is outside
``shard_map``.

Types follow the JAX module: the statistics are taken in the input's own
type (bf16 under bf16 convolutions), the parameters and running
statistics are ``dtype`` (f32), and the output is the promotion of the two.
"""

import contextlib
import contextvars
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from bagua_tpu_torch.communication import allreduce, axis_size
from bagua_tpu_torch.defs import ReduceOp
from bagua_tpu_torch.models._rank_ops import rank_collective, ranks_group

#: where each forward appends its ``(mean, var)``, while one is entered
_SINK: contextvars.ContextVar = contextvars.ContextVar("bagua_sync_bn_sink", default=None)


@contextlib.contextmanager
def statistics_sink(sink: list):
    """Within, every :class:`SyncBatchNorm` forward that normalizes with its
    batch's statistics appends ``(mean, var)`` to ``sink`` (under a
    ``vmap``, return them from the mapped function to see each rank's)."""
    token = _SINK.set(sink)
    try:
        yield
    finally:
        _SINK.reset(token)


def bound_axes(axis_name: Union[str, Sequence[str]], group) -> Tuple[str, ...]:
    """The axes of ``axis_name`` that ``group`` declares (none without a
    group), per axis, so a mesh that declares only one of the default axes
    still synchronizes over that one."""
    if group is None:
        return ()
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    return tuple(a for a in axes if a in group.all_axes)


class SyncBatchNorm(nn.Module):
    """Cross-replica batch norm over the channel dim ``channel_dim`` (flax's
    is the last).

    Args:
        features: the channel count.
        axis_name: mesh axis (or tuple) to synchronize over; defaults to the
            group axes ``("inter", "intra")``.
        momentum: running-stats EMA momentum.
        epsilon: numerical stability constant.
        use_running_average: normalize with the stored running statistics
            (eval mode).
        dtype: the parameters' and running statistics' type.
        channel_dim: the input's channel dim (1 for an NCHW view).
        track_running_stats: fold each batch's statistics into the running
            ones, in place, where the forward runs outside a ``vmap`` over
            ranks (under one the statistics are per rank and the update is
            :meth:`running_update`'s to return; the engine's losses drop it,
            as the JAX package's do).
    """

    def __init__(self, features: int, axis_name: Union[str, Tuple[str, ...]] = ("inter", "intra"),
                 momentum: float = 0.9, epsilon: float = 1e-5, use_running_average: bool = False,
                 dtype=torch.float32, channel_dim: int = -1, track_running_stats: bool = True,
                 device=None):
        super().__init__()
        self.axis_name, self.momentum, self.epsilon = axis_name, momentum, epsilon
        self.use_running_average, self.channel_dim = use_running_average, channel_dim
        self.track_running_stats = track_running_stats
        self.scale = nn.Parameter(torch.ones(features, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=dtype, device=device))
        self.register_buffer("mean", torch.zeros(features, dtype=dtype, device=device))
        self.register_buffer("var", torch.ones(features, dtype=dtype, device=device))

    def _shape(self, x: torch.Tensor):
        """``(features,)`` broadcast against ``x``'s channel dim."""
        shape = [1] * x.dim()
        shape[self.channel_dim] = x.shape[self.channel_dim]
        return shape

    def batch_statistics(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The batch's ``(mean, var)`` in ``x``'s type, averaged over the
        bound axes' ranks: ``var = max(E[x^2] - E[x]^2, 0)``."""
        dims = tuple(d for d in range(x.dim()) if d != self.channel_dim % x.dim())
        mean = x.mean(dim=dims)
        mean2 = (x * x).mean(dim=dims)
        group = ranks_group()
        bound = bound_axes(self.axis_name, group)
        if bound and axis_size(group, bound) > 1:
            # the JAX module's two pmeans as one collective of the stacked
            # pair: each element folds over the ranks as it would alone
            both = rank_collective(lambda t: allreduce(t, ReduceOp.AVG, group, bound), group,
                                   torch.stack([mean, mean2])[None])[0]
            mean, mean2 = both[0], both[1]
        # E[x^2] - E[x]^2 can go slightly negative in floating point: clamp,
        # as flax's BatchNorm does, to keep the root finite
        return mean, torch.clamp(mean2 - mean * mean, min=0.0)

    def running_update(self, mean: torch.Tensor, var: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The running statistics after folding in a batch's ``(mean,
        var)``: ``momentum * running + (1 - momentum) * batch``."""
        m = self.momentum
        return m * self.mean + (1 - m) * mean, m * self.var + (1 - m) * var

    def forward(self, x: torch.Tensor, use_running_average: Optional[bool] = None) -> torch.Tensor:
        if use_running_average is None:
            use_running_average = self.use_running_average
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            mean, var = self.batch_statistics(x)
            sink = _SINK.get()
            if sink is not None:
                sink.append((mean, var))
            if self.track_running_stats and ranks_group() is None:
                with torch.no_grad():
                    new_mean, new_var = self.running_update(mean, var)
                    self.mean.copy_(new_mean)
                    self.var.copy_(new_var)
        shape = self._shape(x)
        y = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + self.epsilon)
        return y * self.scale.reshape(shape) + self.bias.reshape(shape)
