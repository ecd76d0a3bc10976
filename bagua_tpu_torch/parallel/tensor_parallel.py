"""Column- and row-parallel dense layers (the port of
``bagua_tpu/parallel/tensor_parallel.py``) at ``tp_size == 1``, without
bias (the Llama model's use).

A layer holds flax's ``kernel`` ``(in, out)``, created in ``dtype`` as the
JAX layers create it (``tensor_parallel.py:102-104``), and applies a
rank-stacked parameter tree to rank-stacked inputs: ``x (R, ..., in) @
kernel (R, in, out)``, one batched matmul for every rank.  Sharding over a
``tp`` axis (``tp_size > 1``) and the ``fused`` collective-matmul rings of
``kernels/collective_matmul.py`` belong to the tensor-parallel slice of the
port, which has not landed: both raise.
"""

import torch
import torch.nn as nn

from bagua_tpu_torch.utils import lecun_normal


def _unported(what: str):
    return NotImplementedError(
        f"{what} belongs to the tensor-parallel slice of the port, which is not ported yet; "
        "use tp_size=1 and fused=False"
    )


def stacked_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (R, ..., in) @ w (R, in, out)`` per rank, as one batched matmul."""
    R = x.shape[0]
    y = torch.bmm(x.reshape(R, -1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


class _ParallelDense(nn.Module):
    def __init__(self, in_features, features, tp_size=1, dtype=torch.float32, fused=False,
                 device=None, generator=None):
        super().__init__()
        if features % tp_size != 0:
            raise ValueError(f"features ({features}) must divide by tp_size ({tp_size})")
        if fused not in (False, True, "auto"):
            raise ValueError(f"fused must be False, True or 'auto', got {fused!r}")
        if tp_size > 1:
            raise _unported(f"tp_size={tp_size}")
        if fused:
            raise _unported(f"fused={fused!r}")
        self.dtype = dtype
        self.kernel = nn.Parameter(lecun_normal((in_features, features), in_features, dtype,
                                                device, generator))

    def forward(self, params, x):
        """``params``: this layer's rank-stacked subtree; ``x (R, ..., in)``."""
        return stacked_matmul(x.to(self.dtype), params["kernel"])


class ColumnParallelDense(_ParallelDense):
    """``y = x @ kernel``; at ``tp_size == 1`` the whole output."""


class RowParallelDense(_ParallelDense):
    """``y = x @ kernel``; at ``tp_size == 1`` no reduction."""
