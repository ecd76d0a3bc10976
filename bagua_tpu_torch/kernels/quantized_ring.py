"""In-collective blockwise quantization: the int8/int4 ring reduce with
error feedback.

The port of ``bagua_tpu/kernels/quantized_ring.py``.  ByteGrad quantizes
around the collective; here the quantization lives inside the ring: the
travelling shard crosses every hop as uint8 levels (int8) or two int4
nibbles per byte, plus an f32 (min, max) sidecar per block, and each
receiving rank runs one fused dequantize -> add local partial -> requantize,
the hop.

Quantization is per block of ``BAGUA_QR_BLOCK`` elements (default 4096),
the MinMax scheme of :mod:`~bagua_tpu_torch.kernels.minmax_uint8` with
``L = 255`` (int8) or ``L = 15`` (int4) levels.  Int4 packs element ``j`` of
a block with element ``j + B/2``: low nibble the first half, high nibble the
second.

Error feedback: every (re)quantization a rank performs charges its residual
buffer with the sum-space error ``s - dequant(quant(s))`` at the shard it
quantized; added to the next step's gradient, it restores exactly what the
average lost.

==========================================  ================================
wrapper                                     replaces the Pallas kernel
==========================================  ================================
:func:`hop_dequant_add_requant`, bits=8     ``_hop_kernel8`` (pallas_call :253)
:func:`hop_dequant_add_requant`, bits=4     ``_hop_kernel4`` (pallas_call :253)
:func:`compress_minmax_uint4`               no Pallas kernel; jnp at
                                            ``bagua_tpu/kernels/quantized_ring.py:101``
:func:`decompress_minmax_uint4`             no Pallas kernel; jnp at
                                            ``bagua_tpu/kernels/quantized_ring.py:125``
==========================================  ================================

Each runs ``csrc/quantized_ring.cu`` on CUDA tensors and its plain version
(:func:`hop_dequant_add_requant_plain`, :func:`compress_minmax_uint4_plain`,
:func:`decompress_minmax_uint4_plain`) on CPU and meta tensors.  XLA fuses
the JAX package's jnp int4 codec into the jitted step; the two codec
kernels give the port the same one pass.  The int8 block codec is
:mod:`~bagua_tpu_torch.kernels.minmax_uint8`'s, so on the card it launches
that module's CUDA kernels.

The ring collectives take rank-stacked ``(size, L)`` tensors and a group
and axis, as :mod:`~bagua_tpu_torch.communication` does, and call each
codec and hop once per step for every rank at once.  :data:`TALLY` counts
the bytes one rank puts on the wire through the ring's shifts and gathers.
"""

import ctypes
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from bagua_tpu_torch.analysis.collective_ir import label_scope
from bagua_tpu_torch.communication import allgather, axis_size, ppermute_shift, rank_id
from bagua_tpu_torch.kernels import _build
from bagua_tpu_torch.kernels import minmax_uint8 as mm8
from bagua_tpu_torch.observability.flight_recorder import notify_ring

LEVELS4 = 15.0  # int4: 16 levels
DEFAULT_BLOCK = 4096

#: wire precisions understood by the algorithms ("auto" resolves to a
#: per-bucket choice from this set)
WIRE_PRECISIONS = ("f32", "int8", "int4")

#: f32 bytes on the wire per byte of each precision's payload (the f32
#: (min, max) sidecar adds 8 bytes per block)
PRECISION_DIVISOR = {"int8": 4, "int4": 8}


def resolve_block(requested: Optional[int] = None) -> int:
    """Quantization block size: the argument, else ``BAGUA_QR_BLOCK`` (read
    on every call), else 4096.  Must be even: int4 pairs element ``j`` with
    ``j + B/2``."""
    if requested is None:
        env = os.environ.get("BAGUA_QR_BLOCK")
        requested = int(env) if env else DEFAULT_BLOCK
    block = int(requested)
    if block < 2 or block % 2:
        raise ValueError(f"quantized-ring block must be even and >= 2, got {block}")
    return block


# ---------------------------------------------------------------------------
# The int4 block codec: plain versions (the jnp expressions in order)
# ---------------------------------------------------------------------------


def _to_int32(v: torch.Tensor) -> torch.Tensor:
    """XLA's f32 -> s32 convert: truncating, saturating, NaN to 0 (a torch
    cast gives INT_MIN for NaN and out of range).  Held in int64."""
    v = torch.nan_to_num(v, nan=0.0).to(torch.float64)
    return v.clamp_(-(2.0 ** 31), 2.0 ** 31 - 1).to(torch.int64)


def compress_minmax_uint4_plain(blocks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`compress_minmax_uint4`."""
    x = blocks.to(torch.float32)
    mn, mx = mm8._row_min(x), mm8._row_max(x)
    scale = mm8._safe_scale(mn, mx, LEVELS4)
    upper = torch.round(mx * scale)
    lower = upper - LEVELS4
    q = torch.minimum(torch.round(x * scale), upper) - lower
    half = x.shape[1] // 2
    packed = _to_int32(q[:, :half]) | (_to_int32(q[:, half:]) << 4)
    return (packed & 0xFF).to(torch.uint8), torch.cat([mn, mx], dim=1)


def decompress_minmax_uint4_plain(packed: torch.Tensor, minmax: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`decompress_minmax_uint4`."""
    p = packed.to(torch.int32)
    q = torch.cat([p & 0xF, p >> 4], dim=1).to(torch.float32)
    mn, mx = minmax[:, 0:1], minmax[:, 1:2]
    scale = mm8._safe_scale(mn, mx, LEVELS4)
    lower = torch.round(mx * scale) - LEVELS4
    return (q + lower) / scale


def _compressors(bits: int, plain: bool = False):
    if bits == 8:
        if plain:
            return mm8.compress_minmax_uint8_plain, mm8.decompress_minmax_uint8_plain
        return mm8.compress_minmax_uint8, mm8.decompress_minmax_uint8
    if bits == 4:
        if plain:
            return compress_minmax_uint4_plain, decompress_minmax_uint4_plain
        return compress_minmax_uint4, decompress_minmax_uint4
    raise ValueError(f"quantized ring supports bits in (8, 4), got {bits}")


# ---------------------------------------------------------------------------
# The hop: fused dequantize -> add local partial -> requantize
# ---------------------------------------------------------------------------


def hop_dequant_add_requant_plain(
    q: torch.Tensor, minmax: torch.Tensor, local: torch.Tensor, bits: int = 8
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`hop_dequant_add_requant`, the JAX oracle's
    expressions in order."""
    comp, deco = _compressors(bits, plain=True)
    s = deco(q, minmax) + local.to(torch.float32)
    q2, mm2 = comp(s)
    return q2, mm2, s - deco(q2, mm2)


def _lib() -> ctypes.CDLL:
    lib = _build.load("quantized_ring")
    if not getattr(lib, "_bagua_typed", False):
        P, I64 = ctypes.c_void_p, ctypes.c_int64
        lib.bagua_qr_hop.argtypes = [P, P, P, P, P, P, I64, I64, ctypes.c_int, P]
        lib.bagua_qr_hop.restype = ctypes.c_int
        lib.bagua_qr_compress4.argtypes = [P, P, P, I64, I64, P]
        lib.bagua_qr_compress4.restype = ctypes.c_int
        lib.bagua_qr_decompress4.argtypes = [P, P, P, I64, I64, P]
        lib.bagua_qr_decompress4.restype = ctypes.c_int
        lib._bagua_typed = True
    return lib


def compress_minmax_uint4(blocks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compress ``blocks`` ``(nblocks, B)`` (B even) to 4-bit levels, two per
    byte: ``(packed (nblocks, B // 2) uint8, minmax (nblocks, 2) float32)``.
    Element ``j`` rides the low nibble of byte ``j``, element ``j + B/2`` the
    high nibble; the nibbles are packed in int32 and truncated to u8, as
    XLA does.  A CUDA tensor must be float32."""
    if blocks.device.type in _build.PLAIN_DEVICES:
        return compress_minmax_uint4_plain(blocks)
    what = "compress_minmax_uint4"
    x = mm8._cuda_operand(blocks, torch.float32, 2, what)
    rows, block = x.shape
    if block % 2:
        raise ValueError(f"{what}: blocks {tuple(x.shape)} must have an even B")
    packed = torch.empty((rows, block // 2), dtype=torch.uint8, device=x.device)
    minmax = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = _lib().bagua_qr_compress4(
            x.data_ptr(), packed.data_ptr(), minmax.data_ptr(), rows, block, mm8._stream(x.device)
        )
    mm8._check(code, what)
    compress_minmax_uint4.launches += 1
    _build.witness(what, (x,), (packed, minmax))
    return packed, minmax


def decompress_minmax_uint4(packed: torch.Tensor, minmax: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`compress_minmax_uint4` (lossy): ``(nblocks, B//2)``
    packed bytes back to ``(nblocks, B)`` float32 values."""
    if packed.device.type in _build.PLAIN_DEVICES:
        return decompress_minmax_uint4_plain(packed, minmax)
    what = "decompress_minmax_uint4"
    packed = mm8._cuda_operand(packed, torch.uint8, 2, what)
    minmax = mm8._cuda_operand(minmax, torch.float32, 2, f"{what} minmax")
    rows, half = packed.shape
    if minmax.shape != (rows, 2) or minmax.device != packed.device:
        raise ValueError(f"{what}: minmax {tuple(minmax.shape)} does not fit packed {tuple(packed.shape)}")
    out = torch.empty((rows, 2 * half), dtype=torch.float32, device=packed.device)
    with torch.cuda.device(packed.device):
        code = _lib().bagua_qr_decompress4(
            packed.data_ptr(), minmax.data_ptr(), out.data_ptr(), rows, 2 * half, mm8._stream(packed.device)
        )
    mm8._check(code, what)
    decompress_minmax_uint4.launches += 1
    _build.witness(what, (packed, minmax), (out,))
    return out


compress_minmax_uint4.launches = 0
decompress_minmax_uint4.launches = 0


def hop_dequant_add_requant(
    q: torch.Tensor, minmax: torch.Tensor, local: torch.Tensor, bits: int = 8
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One ring step on the travelling packages: dequantize the incoming
    payload, add this rank's local partial, requantize for the next hop.

    ``q`` is ``(nblocks, B)`` uint8 (int8) or ``(nblocks, B//2)`` packed
    uint8 (int4), ``minmax`` float32 ``(nblocks, 2)``, ``local`` float32
    ``(nblocks, B)``.  Returns ``(q2, minmax2, err)``, ``err = s -
    dequant(q2, minmax2)`` the sum-space requantization error."""
    if q.device.type in _build.PLAIN_DEVICES:
        return hop_dequant_add_requant_plain(q, minmax, local, bits)
    if bits not in (8, 4):
        raise ValueError(f"quantized ring supports bits in (8, 4), got {bits}")
    what = f"hop_dequant_add_requant(bits={bits})"
    local = mm8._cuda_operand(local, torch.float32, 2, what)
    rows, block = local.shape
    cols = block if bits == 8 else block // 2
    q = mm8._cuda_operand(q, torch.uint8, 2, what)
    minmax = mm8._cuda_operand(minmax, torch.float32, 2, f"{what} minmax")
    if block % 2 or q.shape != (rows, cols) or minmax.shape != (rows, 2) \
            or not q.device == minmax.device == local.device:
        raise ValueError(
            f"{what}: q {tuple(q.shape)}, minmax {tuple(minmax.shape)} and local "
            f"{tuple(local.shape)} do not fit (B even, q (rows, {cols}))"
        )
    q2 = torch.empty_like(q)
    mm2 = torch.empty_like(minmax)
    err = torch.empty_like(local)
    with torch.cuda.device(q.device):
        code = _lib().bagua_qr_hop(
            q.data_ptr(), minmax.data_ptr(), local.data_ptr(), q2.data_ptr(),
            mm2.data_ptr(), err.data_ptr(), rows, block, bits, mm8._stream(q.device),
        )
    mm8._check(code, what)
    hop_dequant_add_requant.launches += 1
    hop_dequant_add_requant.launches_by_bits[bits] += 1
    _build.witness(f"hop_dequant_add_requant_int{bits}", (q, minmax, local, bits), (q2, mm2, err))
    return q2, mm2, err


hop_dequant_add_requant.launches = 0
#: the launches of the int8 and of the int4 kernel, which ``launches`` sums;
#: reset it with ``launches``
hop_dequant_add_requant.launches_by_bits = {8: 0, 4: 0}

#: the int4 block codec's wrappers, whose launches are counted by name (the
#: hop's also by bits, in ``launches_by_bits``)
CODEC4 = (compress_minmax_uint4, decompress_minmax_uint4)
#: the wrappers that launch kernels, for callers that read or reset the counts
KERNELS = (hop_dequant_add_requant, *CODEC4)


# ---------------------------------------------------------------------------
# The stacked ring collectives
# ---------------------------------------------------------------------------


class WireTally:
    """Bytes one rank has put on the wire through the ring's shifts and
    gathers: payload and sidecars, what :func:`ring_wire_bytes` prices."""

    def __init__(self):
        self.bytes_per_rank = 0

    def ship(self, x: torch.Tensor, peers: int) -> None:
        self.bytes_per_rank += peers * x[0].numel() * x.element_size()


TALLY = WireTally()


def _pad_to_blocks(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, int]:
    """(rows, S) -> (rows, nblocks, B), zero-padded."""
    rows, S = x.shape
    nblocks = -(-S // block)
    if nblocks * block != S:
        x = F.pad(x, (0, nblocks * block - S))
    return x.reshape(rows, nblocks, block), nblocks


def quantized_ring_reduce_scatter(
    flat: torch.Tensor, group, axis=None, *, bits: int = 8, average: bool = True,
    block: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise-quantized ring reduce-scatter of the stacked ``(size, L)``
    tensor over ``axis`` (L divisible by the ring size n).

    Returns ``(shard, err)``: ``shard`` ``(size, L // n)``, the member with
    index i getting the reduced shard i at full precision, and ``err``
    ``(size, L)``, each rank's sum-space error-feedback buffer (non-zero
    only at the shards whose packages it quantized).

    The schedule is the JAX package's: the package for member d starts at
    member d + 1, which quantizes its local shard d, and moves forward one
    member per step; at step t member i holds the package for ``(i - 1 -
    t) mod n`` and runs the hop on it with its own shard of that index; the
    destination adds its own shard without requantizing.  Sums stay in sum
    space; ``average`` divides once at the end."""
    n = axis_size(group, axis)
    size, L = flat.shape
    if L % n:
        raise ValueError(f"flat length {L} not divisible by ring size {n}")
    S = L // n
    x = flat.to(torch.float32)
    if n == 1:
        return x, torch.zeros_like(x)
    B = resolve_block(block)
    comp, deco = _compressors(bits)
    xb, nblocks = _pad_to_blocks(x.reshape(size * n, S), B)
    xb = xb.reshape(size, n, nblocks, B)
    # one flight-recorder descriptor per ring (hop count in-record, not one
    # per hop); a no-op without an active capture
    notify_ring(kind="rs", bits=bits, hops=n - 1,
                wire_bytes=(n - 1) * (nblocks * B // (1 if bits == 8 else 2) + nblocks * 8))
    ranks, idx = torch.arange(size, device=flat.device), rank_id(group, axis)
    rows = size * nblocks

    def ship(t: torch.Tensor) -> torch.Tensor:
        t = t.reshape(size, nblocks, t.shape[-1])
        TALLY.ship(t, 1)
        return ppermute_shift(t, 1, group, axis).reshape(rows, t.shape[-1])

    # the JAX package's qr<bits>_* sub-scopes, which the static verifier's
    # capture reads (the hops' collectives carry qr<bits>_hop<t>)
    tag = f"qr{bits}"
    with label_scope(f"{tag}_quant"):
        local0 = xb[ranks, (idx - 1) % n].reshape(rows, B)
        q0, mm0 = comp(local0)
    q, mm = q0, mm0
    err = torch.zeros((size, n, nblocks, B), dtype=torch.float32, device=flat.device)
    for t in range(1, n):
        with label_scope(f"{tag}_hop{t}"):
            q, mm = ship(q), ship(mm)
            d = (idx - 1 - t) % n
            local = xb[ranks, d].reshape(rows, B)
            if t < n - 1:
                q, mm, e = hop_dequant_add_requant(q, mm, local, bits)
                err[ranks, d] = e.reshape(size, nblocks, B)
    # one decompress for the step-0 packages (their error) and the arrived
    # own-destination packages (d == idx at the last step)
    x0, arrived = deco(torch.cat([q0, q]), torch.cat([mm0, mm])).split(rows)
    err[ranks, (idx - 1) % n] = (local0 - x0).reshape(size, nblocks, B)
    red = arrived + local
    if average:
        red = red / torch.full_like(red, n)
    shard = red.reshape(size, nblocks * B)[:, :S]
    return shard, err.reshape(size, n, nblocks * B)[:, :, :S].reshape(size, L)


def quantized_allgather(
    shard: torch.Tensor, group, axis=None, *, bits: int = 8, block: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise-quantized all-gather of the stacked ``(size, S)`` shards:
    every rank compresses its own shard, the payloads and sidecars cross the
    wire, every rank decompresses all n.  Returns ``(flat, err)``: ``flat``
    ``(size, n * S)``, the same on every member of a collective, and ``err``
    ``(size, S)``, each owner's sum-space error for its shard."""
    n = axis_size(group, axis)
    size, S = shard.shape
    x = shard.to(torch.float32)
    if n == 1:
        return x, torch.zeros_like(x)
    B = resolve_block(block)
    comp, deco = _compressors(bits)
    blocks, nblocks = _pad_to_blocks(x, B)
    # this rank ships its compressed shard to n-1 peers: one descriptor,
    # hop count in-record
    notify_ring(kind="ag", bits=bits, hops=n - 1,
                wire_bytes=(n - 1) * (nblocks * B // (1 if bits == 8 else 2) + nblocks * 8))
    q, mm = comp(blocks.reshape(size * nblocks, B))
    q, mm = q.reshape(size, nblocks, -1), mm.reshape(size, nblocks, 2)
    TALLY.ship(q, n - 1)
    TALLY.ship(mm, n - 1)
    with label_scope(f"qr{bits}_ag"):
        qg, mmg = allgather(q, group, axis), allgather(mm, group, axis)
    out = deco(qg.reshape(size * n * nblocks, -1), mmg.reshape(size * n * nblocks, 2))
    out = out.reshape(size, n, nblocks * B)
    # a rank's own slice of the gather is deco(q, mm) of its shard
    own = out[torch.arange(size, device=shard.device), rank_id(group, axis)]
    err = (blocks.reshape(size, nblocks * B) - own)[:, :S]
    return out[:, :, :S].reshape(size, n * S), err


def quantized_ring_allreduce(
    flat: torch.Tensor, group, axis=None, *, bits: int = 8, average: bool = True,
    block: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized ring reduce-scatter, then quantized all-gather: the
    allreduce of ``wire_precision`` int8/int4.  Both legs ship sums; the
    average divides once at the end, so every error lives in sum space.
    Returns ``(out, err)``, both ``(size, L)`` float32: ``out`` the same on
    every member of a collective, ``err`` each rank's error-feedback
    buffer."""
    n = axis_size(group, axis)
    if n == 1:
        out = flat.to(torch.float32)
        return out, torch.zeros_like(out)
    shard_sum, err_rs = quantized_ring_reduce_scatter(
        flat, group, axis, bits=bits, average=False, block=block
    )
    full, err_ag = quantized_allgather(shard_sum, group, axis, bits=bits, block=block)
    if average:
        full = full / torch.full_like(full, n)
    size, S = shard_sum.shape
    own = torch.zeros((size, n, S), dtype=torch.float32, device=flat.device)
    own[torch.arange(size, device=flat.device), rank_id(group, axis)] = err_ag
    return full, err_rs + own.reshape(size, n * S)


def ring_wire_bytes(numel: int, n: int, bits: int, block: Optional[int] = None) -> int:
    """Exact wire bytes one rank moves for a quantized ring allreduce of
    ``numel`` f32 elements over ``n`` ranks: ``n - 1`` hops of the
    reduce-scatter plus the shard it ships to ``n - 1`` peers in the
    all-gather, payload and (min, max) sidecars."""
    if bits not in (8, 4):
        raise ValueError(f"ring_wire_bytes prices int8/int4 rings; got bits={bits!r}")
    if n == 1:
        return 0
    B = resolve_block(block)
    S = -(-(numel // n) // B) * B  # padded shard elements
    per_hop = S // (1 if bits == 8 else 2) + (S // B) * 8
    return 2 * (n - 1) * per_hop
