"""MinMaxUInt8 quantization: 8-bit lossy compression for collectives.

The port of ``bagua_tpu/kernels/minmax_uint8.py``.  Semantics, per chunk:

    scale       = 255 / (max - min + 1e-7)      (denominator bounded; see
                                                 :func:`_safe_scale`)
    upper_bound = rint(max * scale)
    lower_bound = upper_bound - 255
    q           = clip(rint(x * scale), -inf, upper_bound) - lower_bound   (uint8)
    x'          = (q + lower_bound) / scale

Three functions, each with a hand-written CUDA kernel
(``csrc/minmax_uint8.cu``) and, beside it, a plain PyTorch version that
follows the JAX expressions in order:

==============================  ==========================================
wrapper                         replaces the Pallas kernel
==============================  ==========================================
:func:`compress_minmax_uint8`   ``_compress_kernel`` (pallas_call :195)
:func:`decompress_minmax_uint8` ``_decompress_kernel`` (pallas_call :232)
:func:`decompress_reduce_requantize`
                                ``_fused_reduce_kernel`` (pallas_call :318)
==============================  ==========================================

Dispatch is by device and nothing else: a tensor on the CPU goes to the
plain version, a CUDA tensor launches the kernel (or raises).  Each wrapper
counts its kernel launches in ``<wrapper>.launches``, one a call; the plain
path leaves the count alone.  The kernels are bounded by device-memory
bytes; the CUDA source's header says what each moves and how many kernels
one call runs (compress 1 where a chunk has at most 16384 elements, else 2;
decompress 1; fused 2, or 1 where the chunk is a single tile of 4096).  The
fused kernel looks each peer's dequantized levels up in a table
(:func:`level_table_plain` is its plain twin).

Bitwise parity with the jnp reference needs three things the obvious torch
spelling gets wrong: ``scalar / tensor`` is computed as a multiply by the
reciprocal, so divisions are written tensor by tensor; the clamp bound is
``torch.finfo(torch.float32).max``, since 3.4028235e38 overflows float32;
and the casts and reductions follow XLA's rules (see :func:`_to_uint8`,
:func:`_row_min`).
"""

import ctypes
from typing import Optional, Tuple

import torch

from bagua_tpu_torch.kernels import _build

EPS = 1e-7
LEVELS = 255.0
# Degenerate-range guard terms (see _safe_scale).
REL_EPS = 1e-35
F32_MAX = torch.finfo(torch.float32).max


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the semantic reference on every device
# ---------------------------------------------------------------------------


def _safe_scale(mn: torch.Tensor, mx: torch.Tensor, levels: float = LEVELS) -> torch.Tensor:
    """Per-chunk scale with a bounded denominator (``REL_EPS * amax`` keeps
    ``rint(mx * scale)`` finite for huge near-constant chunks, the
    ``F32_MAX`` clamp keeps scale > 0 when the range overflows)."""
    amax = torch.maximum(mn.abs(), mx.abs())
    denom = torch.minimum(mx - mn + EPS + REL_EPS * amax, torch.full_like(mn, F32_MAX))
    return torch.full_like(denom, levels) / denom


def _to_uint8(v: torch.Tensor) -> torch.Tensor:
    """XLA's f32 -> u8 convert: saturating, NaN to 0 (a torch cast wraps)."""
    return torch.nan_to_num(v, nan=0.0).clamp_(0.0, LEVELS).to(torch.uint8)


def _row_min(x: torch.Tensor) -> torch.Tensor:
    """``jnp.min`` over each row: NaN propagates, and -0 orders below +0
    whatever the element order (``torch.amin`` may return either zero)."""
    mn = torch.amin(x, dim=1, keepdim=True)
    neg_zero = ((x == 0) & torch.signbit(x)).any(dim=1, keepdim=True)
    return torch.where(mn == 0, torch.where(neg_zero, -0.0, 0.0), mn)


def _row_max(x: torch.Tensor) -> torch.Tensor:
    """``jnp.max`` over each row, with +0 above -0 (see :func:`_row_min`)."""
    mx = torch.amax(x, dim=1, keepdim=True)
    pos_zero = ((x == 0) & ~torch.signbit(x)).any(dim=1, keepdim=True)
    return torch.where(mx == 0, torch.where(pos_zero, 0.0, -0.0), mx)


def _quantize(x, mn, mx):
    scale = _safe_scale(mn, mx)
    upper = torch.round(mx * scale)
    lower = upper - LEVELS
    level = torch.minimum(torch.round(x * scale), upper)
    return _to_uint8(level - lower)


def level_table_plain(minmax: torch.Tensor, levels: float = LEVELS) -> torch.Tensor:
    """The value each level ``0 .. levels`` of a row dequantizes to, for every
    row of ``minmax`` ``(rows, 2)``: ``(rows, levels + 1)`` float32.  The
    fused reduce and the ring hop build these tables on the card in place of
    a division per element; used by the tests, which hold them against the
    JAX package's dequantize."""
    mn, mx = minmax[:, 0:1], minmax[:, 1:2]
    scale = _safe_scale(mn, mx, levels)
    lower = torch.round(mx * scale) - levels
    q = torch.arange(int(levels) + 1, dtype=torch.float32, device=minmax.device)
    return (q + lower) / scale


def compress_minmax_uint8_plain(chunks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`compress_minmax_uint8`."""
    x = chunks.to(torch.float32)
    mn = _row_min(x)
    mx = _row_max(x)
    return _quantize(x, mn, mx), torch.cat([mn, mx], dim=1)


def decompress_minmax_uint8_plain(q: torch.Tensor, minmax: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`decompress_minmax_uint8`."""
    mn = minmax[:, 0:1]
    mx = minmax[:, 1:2]
    scale = _safe_scale(mn, mx)
    lower = torch.round(mx * scale) - LEVELS
    return (q.to(torch.float32) + lower) / scale


def decompress_reduce_requantize_plain(
    q: torch.Tensor, minmax: torch.Tensor, average: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`decompress_reduce_requantize`: the peers are
    summed left to right from +0, as XLA's reduce does."""
    ranks, n, chunk = q.shape
    x = decompress_minmax_uint8_plain(
        q.reshape(ranks * n, chunk), minmax.reshape(ranks * n, 2)
    ).reshape(ranks, n, chunk)
    red = torch.zeros((ranks, chunk), dtype=torch.float32, device=q.device)
    for p in range(n):
        red = red + x[:, p]
    if average:
        red = red / torch.full_like(red, n)
    q2, mm2 = compress_minmax_uint8_plain(red)
    return q2.reshape(ranks, 1, chunk), mm2.reshape(ranks, 1, 2)


# ---------------------------------------------------------------------------
# Wrappers: the CUDA kernel on CUDA tensors, the plain version on CPU tensors
# ---------------------------------------------------------------------------

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "bagua_minmax_u8_tiles": ([_I64], _I64),
    "bagua_compress_minmax_u8": ([_P, _P, _P, _P, _I64, _I64, _P], ctypes.c_int),
    "bagua_decompress_minmax_u8": ([_P, _P, _P, _I64, _I64, _P], ctypes.c_int),
    "bagua_fused_reduce_minmax_u8": (
        [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_int, _P], ctypes.c_int,
    ),
}


def _lib() -> ctypes.CDLL:
    lib = _build.load("minmax_uint8")
    if not getattr(lib, "_bagua_typed", False):
        for fn, (argtypes, restype) in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib._bagua_tiles = {}  # chunk -> bagua_minmax_u8_tiles(chunk)
        lib._bagua_typed = True
    return lib


def _cuda_operand(t: torch.Tensor, dtype: torch.dtype, ndim: int, what: str) -> torch.Tensor:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got one on {t.device}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.numel() == 0:
        raise ValueError(f"{what}: empty input {tuple(t.shape)}")
    return t.contiguous()


def _scratch(rows: int, chunk: int, device) -> Optional[torch.Tensor]:
    """Scratch for compress or the fused reduce of ``rows`` chunks of
    ``chunk`` elements: ``2 * rows * (tiles + 1)`` floats, with ``tiles`` as
    the library reports it once per chunk length; None where it reports -1
    (chunks of at most 4096 elements, which both take in one launch with no
    scratch; compress also leaves the scratch of chunks up to 16384 unread)."""
    lib = _lib()
    tiles = lib._bagua_tiles.get(chunk)
    if tiles is None:
        tiles = lib._bagua_tiles[chunk] = lib.bagua_minmax_u8_tiles(chunk)
    if tiles < 0:
        return None
    return torch.empty(2 * rows * (tiles + 1), dtype=torch.float32, device=device)


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA kernel launch failed with cudaError {err}")


def _stream(device) -> int:
    """The current stream: kernels launch on it and do not synchronise.
    Scratch tensors the wrappers drop on return go back to PyTorch's
    stream-ordered allocator, which reuses them only for later work on the
    same stream, after the kernel."""
    return torch.cuda.current_stream(device).cuda_stream


def compress_minmax_uint8(chunks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compress ``chunks`` of shape ``(nchunks, chunk_size)``.

    Returns ``(q, minmax)``: ``q`` uint8 of the same shape and ``minmax``
    float32 of shape ``(nchunks, 2)``."""
    if chunks.device.type == "cpu":
        return compress_minmax_uint8_plain(chunks)
    x = _cuda_operand(chunks.to(torch.float32), torch.float32, 2, "compress_minmax_uint8")
    rows, chunk = x.shape
    q = torch.empty((rows, chunk), dtype=torch.uint8, device=x.device)
    minmax = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
    scratch = _scratch(rows, chunk, x.device)
    with torch.cuda.device(x.device):
        err = _lib().bagua_compress_minmax_u8(
            x.data_ptr(), q.data_ptr(), minmax.data_ptr(), _ptr(scratch),
            rows, chunk, _stream(x.device),
        )
    _check(err, "compress_minmax_uint8")
    compress_minmax_uint8.launches += 1
    return q, minmax


def decompress_minmax_uint8(q: torch.Tensor, minmax: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`compress_minmax_uint8` (lossy); float32 out."""
    if q.device.type == "cpu":
        return decompress_minmax_uint8_plain(q, minmax)
    q = _cuda_operand(q, torch.uint8, 2, "decompress_minmax_uint8")
    minmax = _cuda_operand(minmax, torch.float32, 2, "decompress_minmax_uint8 minmax")
    rows, chunk = q.shape
    if minmax.shape != (rows, 2) or minmax.device != q.device:
        raise ValueError(f"minmax {tuple(minmax.shape)} does not fit q {tuple(q.shape)}")
    out = torch.empty((rows, chunk), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _lib().bagua_decompress_minmax_u8(
            q.data_ptr(), minmax.data_ptr(), out.data_ptr(), rows, chunk, _stream(q.device)
        )
    _check(err, "decompress_minmax_uint8")
    decompress_minmax_uint8.launches += 1
    return out


def decompress_reduce_requantize(
    q: torch.Tensor, minmax: torch.Tensor, average: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse ByteGrad's middle stages for every rank at once.

    ``q`` is uint8 of shape ``(R, n, chunk)`` (rank r's received chunk from
    each of its n peers), ``minmax`` float32 ``(R, n, 2)``.  Returns
    ``(q2, mm2)`` with ``q2`` uint8 ``(R, 1, chunk)`` and ``mm2`` float32
    ``(R, 1, 2)``: per rank, ``compress(sum(decompress(q, minmax))[/ n])``."""
    if q.device.type == "cpu":
        return decompress_reduce_requantize_plain(q, minmax, average)
    q = _cuda_operand(q, torch.uint8, 3, "decompress_reduce_requantize")
    minmax = _cuda_operand(minmax, torch.float32, 3, "decompress_reduce_requantize minmax")
    ranks, n, chunk = q.shape
    if minmax.shape != (ranks, n, 2) or minmax.device != q.device:
        raise ValueError(f"minmax {tuple(minmax.shape)} does not fit q {tuple(q.shape)}")
    q2 = torch.empty((ranks, 1, chunk), dtype=torch.uint8, device=q.device)
    mm2 = torch.empty((ranks, 1, 2), dtype=torch.float32, device=q.device)
    red = torch.empty((ranks, chunk), dtype=torch.float32, device=q.device)
    scratch = _scratch(ranks, chunk, q.device)
    with torch.cuda.device(q.device):
        err = _lib().bagua_fused_reduce_minmax_u8(
            q.data_ptr(), minmax.data_ptr(), q2.data_ptr(), mm2.data_ptr(),
            red.data_ptr(), _ptr(scratch), ranks, n, chunk, int(bool(average)),
            _stream(q.device),
        )
    _check(err, "decompress_reduce_requantize")
    decompress_reduce_requantize.launches += 1
    return q2, mm2


compress_minmax_uint8.launches = 0
decompress_minmax_uint8.launches = 0
decompress_reduce_requantize.launches = 0

#: the wrappers that launch kernels, for callers that read or reset the counts
KERNELS = (compress_minmax_uint8, decompress_minmax_uint8, decompress_reduce_requantize)
