"""Collective matmul: the tensor-parallel GEMMs as rings of tile products.

The port of ``bagua_tpu/kernels/collective_matmul.py``.  A sharded GEMM is
broken into per-rank ring steps, each a tile product plus one neighbour
shift, instead of one blocking collective and one big product:

* :func:`ag_matmul` -- **all-gather matmul**: ``allgather(x_shard) @
  w_local``, multiplying the block a rank holds while the ring forwards it;
* :func:`matmul_rs` -- **matmul reduce-scatter**: each rank's row block of
  ``allreduce_SUM(x_local @ w_local)``, the partial products accumulated
  into a travelling shard, so no all-reduce is emitted at all.

Tensors are rank-stacked, ``(R, rows, cols)`` with ``R`` the group size,
and the ring runs within each collective of one group ``axis``
(:func:`~bagua_tpu_torch.communication.ppermute_shift`: shift +1 for the
JAX package's ``fwd`` pairs, -1 for its ``back`` pairs).  Each ring step is
one tile product for every rank: the rank axis is the kernel's batch axis.
The steps, the destination schedule ``d = (idx + 1 + t) mod n``, the arcs
of ``ring="bidir"``, the serial add order and the final per-rank reorder
follow the JAX code step for step, so integer-valued operands give the
JAX package's bits.

==========================================  ================================
wrapper                                     replaces the Pallas kernel
==========================================  ================================
:func:`matmul_tile`                         ``_matmul_kernel`` (pallas_call :299)
==========================================  ================================

:func:`matmul_tile` runs ``csrc/collective_matmul.cu`` on CUDA f32 tensors
and :func:`matmul_tile_plain` on CPU tensors.  Other types (bf16, f16,
f64) take ``x @ w`` on either device, as the reference's
``matmul_tile_pallas`` sends them to ``jnp.dot`` outside its kernel.
:class:`TileMatmulFn` is its gradient, by the same rule.  The JAX package's ``use_pallas``
switch, its evidence gate and ``get_collective_matmul`` are not carried
over: dispatch is by device, so the rings always take :func:`matmul_tile`.
"""

import ctypes
from typing import Tuple

import torch

from bagua_tpu_torch.communication import _axes, axis_size, ppermute_shift, rank_id
from bagua_tpu_torch.kernels import _build
from bagua_tpu_torch.kernels import minmax_uint8 as mm8


# ---------------------------------------------------------------------------
# The tile product: plain version, kernel wrapper, gradient
# ---------------------------------------------------------------------------


def matmul_tile_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``: ``(m, k) @ (k, n)``, or rank-stacked ``(R, m, k) @ (R, k,
    n)``; the oracle, as ``jnp.dot`` is the JAX package's."""
    return x @ w


def _lib() -> ctypes.CDLL:
    lib = _build.load("collective_matmul")
    if not getattr(lib, "_bagua_typed", False):
        P = ctypes.c_void_p
        lib.bagua_matmul_tile.argtypes = [P, P, P, P, P, P]
        lib.bagua_matmul_tile.restype = ctypes.c_int
        lib._bagua_typed = True
    return lib


def _int64s(values) -> ctypes.Array:
    return (ctypes.c_int64 * len(values))(*values)


def matmul_tile(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in f32 through the tile kernel, one launch for every batch
    entry: ``(m, k) @ (k, n)`` or ``(R, m, k) @ (R, k, n)``.  Both operands
    are read through their strides (transposed views need no copy); the
    result is contiguous.  CPU tensors take :func:`matmul_tile_plain`.

    The kernel takes f32 operands only.  Operands that are not both f32
    take ``x @ w`` (:func:`matmul_tile_plain`) on either device, decided by
    dtype before any launch, with no launch counted: the reference's rule,
    whose ``matmul_tile_pallas`` returns ``jnp.dot(x, w)`` for them outside
    its Pallas kernel (``bagua_tpu/kernels/collective_matmul.py:247-248,
    262-263``)."""
    if x.device.type == "cpu" or x.dtype != torch.float32 or w.dtype != torch.float32:
        return matmul_tile_plain(x, w)
    what = "matmul_tile"
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"{what}: expected CPU or CUDA operands on one device, got {x.device} "
                         f"and {w.device}")
    if x.dim() not in (2, 3) or w.dim() != x.dim() or x.shape[-1] != w.shape[-2] \
            or x.shape[:-2] != w.shape[:-2]:
        raise ValueError(f"{what}: expected (m, k) @ (k, n) or (R, m, k) @ (R, k, n), got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    x3, w3 = (x[None], w[None]) if x.dim() == 2 else (x, w)
    R, m, k = x3.shape
    n = w3.shape[2]
    out = torch.empty((R, m, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out.reshape(*x.shape[:-1], n)
    with torch.cuda.device(x.device):
        code = _lib().bagua_matmul_tile(
            x3.data_ptr(), w3.data_ptr(), out.data_ptr(), _int64s([R, m, n, k]),
            _int64s([*x3.stride(), *w3.stride()]), mm8._stream(x.device),
        )
    mm8._check(code, what)
    matmul_tile.launches += 1
    return out.reshape(*x.shape[:-1], n)


matmul_tile.launches = 0

#: the wrappers that launch kernels, for callers that read or reset the counts
KERNELS = (matmul_tile,)


class TileMatmulFn(torch.autograd.Function):
    """Differentiable :func:`matmul_tile`, the twin of ``_tile_matmul``'s
    ``custom_vjp``: ``dx = g . w^T`` and ``dw = x^T . g`` through
    :func:`matmul_tile` on transposed views (the kernel for f32, ``x @ w``
    for other types).  Only the products that ``ctx.needs_input_grad`` asks
    for run (XLA drops the unused half)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return matmul_tile(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = matmul_tile(g, w.transpose(-1, -2)) if ctx.needs_input_grad[0] else None
        dw = matmul_tile(x.transpose(-1, -2), g) if ctx.needs_input_grad[1] else None
        return dx, dw


#: :func:`matmul_tile` with its gradient, the rings' tile product
tile_matmul = TileMatmulFn.apply


# ---------------------------------------------------------------------------
# The rings
# ---------------------------------------------------------------------------


def _axis_meta(group, axis) -> int:
    axes = _axes(axis)
    if len(axes) != 1:
        raise ValueError(
            f"collective matmul rings run over a single mesh axis, got {axes} "
            "(hierarchical multi-axis rings are not supported)"
        )
    return axis_size(group, axes[0])


def _ring_arcs(ring: str, n: int) -> Tuple[int, int]:
    """Hop counts per direction: ``"uni"`` walks the ``n - 1``-hop ring one
    way; ``"bidir"`` splits it into two counter-rotating arcs of
    ``ceil((n-1)/2)`` and ``floor((n-1)/2)`` hops."""
    if ring == "uni":
        return n - 1, 0
    if ring == "bidir":
        return -(-(n - 1) // 2), (n - 1) // 2
    raise ValueError(f"ring must be 'uni' or 'bidir', got {ring!r}")


def ag_matmul(x_shard: torch.Tensor, w_local: torch.Tensor, group, axis="intra", *,
              ring: str = "uni") -> torch.Tensor:
    """All-gather matmul: ``allgather(x_shard) @ w_local`` over ``axis``.

    ``x_shard (R, m_shard, k)``: each rank's row block of the activations;
    ``w_local (R, k, n_local)``: each rank's weight shard.  Step t
    multiplies the block a rank holds (origin member ``(idx - t) mod n``)
    while the ring forwards it.  Returns ``(R, n * m_shard, n_local)`` with
    rows in source-member order.  ``ring="bidir"`` forwards half the blocks
    each way; every block is still multiplied whole by the same kernel, so
    the result is bitwise the unidirectional ring's."""
    n = _axis_meta(group, axis)
    kf, kb = _ring_arcs(ring, n)
    if n == 1:
        return tile_matmul(x_shard, w_local)
    # parts[t] is the product of the block from member (idx - t) mod n: the
    # forward arc fills t = 1..kf, the backward arc n-1 down to n-kb
    parts = [None] * n
    parts[0] = tile_matmul(x_shard, w_local)
    fbuf = bbuf = x_shard
    for t in range(1, kf + 1):
        fbuf = ppermute_shift(fbuf, 1, group, axis)
        parts[t] = tile_matmul(fbuf, w_local)
        if t <= kb:
            bbuf = ppermute_shift(bbuf, -1, group, axis)
            parts[n - t] = tile_matmul(bbuf, w_local)
    # block s of a rank's output is member s's: parts[(idx - s) mod n], a
    # different order on every rank (JAX's roll of the reversed stack)
    stacked = torch.stack(parts, dim=1)  # (R, n, m_shard, n_local)
    R = stacked.shape[0]
    idx = rank_id(group, axis).to(stacked.device)
    src = (idx[:, None] - torch.arange(n, device=stacked.device)[None]) % n
    out = stacked[torch.arange(R, device=stacked.device)[:, None], src]
    return out.reshape(R, n * x_shard.shape[1], w_local.shape[-1])


def matmul_rs(x_local: torch.Tensor, w_local: torch.Tensor, group, axis="intra", *,
              ring: str = "uni") -> torch.Tensor:
    """Matmul reduce-scatter: each rank's row block of ``allreduce_SUM(x_local
    @ w_local)`` over ``axis``.

    ``x_local (R, m, k_local)``: the activations with the contraction dim
    sharded; ``w_local (R, k_local, features)``.  The ring walks the
    destination schedule ``d = (idx + 1 + t) mod n``: each step computes the
    partial product for one destination's row block and adds it onto the
    accumulator arriving from the right neighbour.  Member ``idx`` ends with
    rows ``[idx m/n, (idx+1) m/n)``: ``(R, m / n, features)``.
    ``ring="bidir"`` sums the same partial products over two arcs, in
    another order (equal to f32 rounding; bitwise where the sums are exact).

    The slices are taken from one per-rank rotation of ``x_local``'s row
    blocks (a gather, as JAX's ``dynamic_slice`` is), after which every
    step's slice is a strided view that the kernel reads in place."""
    n = _axis_meta(group, axis)
    ka, kb = _ring_arcs(ring, n)
    if n == 1:
        return tile_matmul(x_local, w_local)
    R, m, k = x_local.shape
    if m % n:
        raise ValueError(
            f"matmul_rs needs the leading dim ({m}) to divide by the ring size ({n})"
        )
    blk = m // n
    device = x_local.device
    idx = rank_id(group, axis).to(device)
    # rotated block j of rank r is its row block (idx_r + 1 + j) mod n
    rot = (idx[:, None] + 1 + torch.arange(n, device=device)[None]) % n
    x_rot = x_local.reshape(R, n, blk, k)[torch.arange(R, device=device)[:, None], rot]

    def part(j):
        """The partial product for destination (idx + 1 + j) mod n."""
        return tile_matmul(x_rot[:, j % n], w_local)

    if ring == "uni":
        acc = part(0)
        for t in range(1, n):
            # arrival order is fixed by the ring, so the serial sum order is
            # the JAX package's
            acc = ppermute_shift(acc, -1, group, axis) + part(t)
        return acc
    # backward chain: born at member d + ka, adds every member down to the
    # destination: sources d+ka .. d+1, then d's own part
    acc_a = part(-ka - 1)
    for t in range(1, ka + 1):
        acc_a = ppermute_shift(acc_a, -1, group, axis) + part(t - ka - 1)
    if kb == 0:
        return acc_a
    # forward chain: born at member d - kb, adds through d - 1, then one last
    # hop delivers it (d's own part rode the backward chain)
    acc_b = part(kb - 1)
    for t in range(1, kb):
        acc_b = ppermute_shift(acc_b, 1, group, axis) + part(kb - 1 - t)
    acc_b = ppermute_shift(acc_b, 1, group, axis)
    return acc_a + acc_b

