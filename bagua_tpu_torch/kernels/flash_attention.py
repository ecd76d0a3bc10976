"""Blockwise (flash) attention for ring attention.

The port of ``bagua_tpu/kernels/flash_attention.py``.  The ring visits one
K/V block per step and folds its contribution into an online-softmax carry:

* :func:`block_attention` -- one block's **unnormalized** contribution
  ``(o, l, m)`` (max-shifted weighted values, normalizer, row max);
* :func:`flash_attention_bwd` -- its backward, recomputing the
  probabilities from ``m`` and holding ``m`` constant (stop-gradient);
* :class:`BlockAttentionFn` -- the two as one differentiable call, the twin
  of ``block_attention_fused``'s ``custom_vjp``;
* :func:`merge_blocks` -- the elementwise online-softmax combine.

==========================================  ================================
wrapper                                     replaces the Pallas kernel
==========================================  ================================
:func:`block_attention`                     ``_tiled_flash_kernel`` (pallas_call :314)
:func:`flash_attention_bwd_dq`             ``_flash_bwd_dq_kernel`` (pallas_call :510)
:func:`flash_attention_bwd_dkv`            ``_flash_bwd_dkv_kernel`` (pallas_call :543)
==========================================  ================================

The wrappers run ``csrc/flash_attention.cu`` on CUDA tensors and the plain
versions on CPU tensors.  They take any layout whose last dim is
contiguous (the ring's half-block views go to the kernel uncopied) and
grouped-query K/V with ``h // h_kv`` query heads per K/V head.  Masked
scores are ``NEG``, never ``-inf``, so a fully masked row stays NaN-free
through the merges: it ends with ``m = NEG``, ``l = 0`` and ``o = 0``.

Stop-gradient on ``m``: the backward drops ``m``'s cotangent.  That is
exact for ring attention's merge and normalization, whose result does not
depend on the max shift, and it is not the per-block VJP of
:func:`block_attention_plain` (``bagua_tpu/kernels/flash_attention.py``
:456-467).  On the card the fused backward always runs; the JAX package's
``BAGUA_PALLAS_FLASH_BWD`` pin and evidence gate are not carried over.
"""

import ctypes
from typing import Tuple

import torch

from bagua_tpu_torch.kernels import _build
from bagua_tpu_torch.kernels import minmax_uint8 as mm8

NEG = -1e30  # large negative finite: a fully masked row stays NaN-free

#: the K/V types the kernels read, by their code in the C interface
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the widest head the kernels take (tiles hold d padded to 64 or 128)
MAX_HEAD_DIM = 128


# ---------------------------------------------------------------------------
# Plain versions (the JAX expressions in order)
# ---------------------------------------------------------------------------


def _repeat_kv(x: torch.Tensor, h: int) -> torch.Tensor:
    """Grouped K/V ``(b, t, h_kv, d)`` expanded to ``h`` heads: query head i
    reads K/V head ``i // (h // h_kv)``, as ``jnp.repeat`` lays them out."""
    g = h // x.shape[2]
    return x if g == 1 else torch.repeat_interleave(x, g, dim=2)


def _check_heads(h: int, h_kv: int) -> None:
    if h % h_kv:
        raise ValueError(f"q heads ({h}) must divide by kv heads ({h_kv})")


def block_attention_plain(
    qf: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One K/V block's unnormalized attention contribution.

    ``qf`` pre-scaled queries ``(b, tq, h, d)`` float32; ``k_blk``, ``v_blk``
    ``(b, tk, h_kv, d)`` of any float type; ``mask`` ``(b, tq, tk)`` bool,
    True = attend.  Returns ``o (b, h, tq, d) = sum_k exp(s - m) v``,
    ``l (b, h, tq) = sum_k exp(s - m)`` and ``m (b, h, tq)``, the row max
    (``NEG`` where every key is masked)."""
    _check_heads(qf.shape[2], k_blk.shape[2])
    h = qf.shape[2]
    k, v = _repeat_kv(k_blk, h).float(), _repeat_kv(v_blk, h).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf.float(), k)
    s = torch.where(mask[:, None], s, NEG)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(mask[:, None], p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bhqd", p, v)
    return o, l, m


def _bwd_probabilities(qf, k_blk, v_blk, mask, m, dl, do):
    """``(p, ds, k, v)`` of the backward: the probabilities recomputed from
    the constant ``m``, and ``ds = p * (do . v^T + dl)``, with K/V expanded
    to the query heads in float32."""
    _check_heads(qf.shape[2], k_blk.shape[2])
    h = qf.shape[2]
    k, v = _repeat_kv(k_blk, h).float(), _repeat_kv(v_blk, h).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf.float(), k)
    p = torch.where(mask[:, None], torch.exp(s - m[..., None]), 0.0)
    dp = torch.einsum("bhqd,bkhd->bhqk", do.float(), v) + dl[..., None]
    return p, p * dp, k, v


def flash_attention_bwd_dq_plain(qf, k_blk, v_blk, mask, m, dl, do) -> torch.Tensor:
    """Plain version of the dq kernel: ``dq (b, tq, h, d) = ds . k``."""
    _, ds, k, _ = _bwd_probabilities(qf, k_blk, v_blk, mask, m, dl, do)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k)


def flash_attention_bwd_dkv_plain(qf, k_blk, v_blk, mask, m, dl, do) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dk/dv kernel: ``dk = ds^T . qf`` and ``dv = p^T .
    do``, ``(b, tk, h_kv, d)`` each, summed over the query heads that share
    a K/V head and cast to ``k_blk``'s type."""
    p, ds, _, _ = _bwd_probabilities(qf, k_blk, v_blk, mask, m, dl, do)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf.float())
    dv = torch.einsum("bhqk,bhqd->bkhd", p, do.float())
    b, tk, h_kv, d = k_blk.shape
    g = qf.shape[2] // h_kv
    if g > 1:
        dk = dk.reshape(b, tk, h_kv, g, d).sum(dim=3)
        dv = dv.reshape(b, tk, h_kv, g, d).sum(dim=3)
    return dk.to(k_blk.dtype), dv.to(v_blk.dtype)


def merge_blocks(carry, block):
    """Online-softmax combine of two unnormalized contributions.  An
    all-masked block ``(0, 0, NEG)`` merges as an exact identity."""
    o, l, m = carry
    o_b, l_b, m_b = block
    m_new = torch.maximum(m, m_b)
    c = torch.exp(m - m_new)
    c_b = torch.exp(m_b - m_new)
    return o * c[..., None] + o_b * c_b[..., None], l * c + l_b * c_b, m_new


# ---------------------------------------------------------------------------
# Wrappers: the CUDA kernels for CUDA tensors, the plain versions for CPU ones
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_bagua_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.bagua_flash_fwd.argtypes = [P, P, P, P, P, P, P, P, P, I, P]
        lib.bagua_flash_bwd_dq.argtypes = [P, P, P, P, P, P, P, P, P, P, I, P]
        lib.bagua_flash_bwd_dkv.argtypes = [P, P, P, P, P, P, P, P, P, P, P, I, P]
        for fn in (lib.bagua_flash_fwd, lib.bagua_flash_bwd_dq, lib.bagua_flash_bwd_dkv):
            fn.restype = I
        lib._bagua_typed = True
    return lib


def _lastdim_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _operands(what, qf, k_blk, v_blk, mask):
    """Checked CUDA operands and the C interface's dims, strides and K/V
    type code: ``(qf, k, v, mask, dims, strides)``."""
    if qf.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got one on {qf.device}")
    if not (qf.device == k_blk.device == v_blk.device == mask.device):
        raise ValueError(f"{what}: operands on different devices")
    if qf.dim() != 4 or k_blk.dim() != 4 or v_blk.shape != k_blk.shape or mask.dim() != 3:
        raise ValueError(f"{what}: expected qf (b, tq, h, d), k and v (b, tk, h_kv, d), mask "
                         f"(b, tq, tk); got {tuple(qf.shape)}, {tuple(k_blk.shape)}, "
                         f"{tuple(v_blk.shape)}, {tuple(mask.shape)}")
    b, tq, h, d = qf.shape
    _, tk, h_kv, _ = k_blk.shape
    if k_blk.shape[0] != b or k_blk.shape[3] != d or tuple(mask.shape) != (b, tq, tk):
        raise ValueError(f"{what}: qf {tuple(qf.shape)}, k {tuple(k_blk.shape)} and mask "
                         f"{tuple(mask.shape)} do not fit")
    _check_heads(h, h_kv)
    if qf.numel() == 0 or k_blk.numel() == 0:
        raise ValueError(f"{what}: empty input")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {d} is over the kernels' {MAX_HEAD_DIM}")
    if k_blk.dtype not in _KV_DTYPES or v_blk.dtype != k_blk.dtype:
        raise ValueError(f"{what}: K/V must share one of {list(_KV_DTYPES)}, got "
                         f"{k_blk.dtype} and {v_blk.dtype}")
    if mask.dtype != torch.bool:
        raise ValueError(f"{what}: mask must be bool, got {mask.dtype}")
    qf = _lastdim_contiguous(qf.to(torch.float32))
    k_blk, v_blk = _lastdim_contiguous(k_blk), _lastdim_contiguous(v_blk)
    dims = [b, tq, tk, h, h_kv, d]
    strides = [*qf.stride()[:3], *k_blk.stride()[:3], *v_blk.stride()[:3], *mask.stride()]
    return qf, k_blk, v_blk, mask, dims, strides


def _int64s(values) -> ctypes.Array:
    return (ctypes.c_int64 * len(values))(*values)


def block_attention(
    qf: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One K/V block's unnormalized contribution ``(o, l, m)``, the contract
    of :func:`block_attention_plain`; grouped K/V by index.  Dead tiles
    (mask all false) are skipped."""
    if qf.device.type in _build.PLAIN_DEVICES:
        return block_attention_plain(qf, k_blk, v_blk, mask)
    qf, k_blk, v_blk, mask, dims, strides = _operands("block_attention", qf, k_blk, v_blk, mask)
    b, tq, _, h, _, d = dims
    o = torch.empty((b, h, tq, d), dtype=torch.float32, device=qf.device)
    l = torch.empty((b, h, tq), dtype=torch.float32, device=qf.device)
    m = torch.empty_like(l)
    with torch.cuda.device(qf.device):
        code = _lib().bagua_flash_fwd(
            qf.data_ptr(), k_blk.data_ptr(), v_blk.data_ptr(), mask.data_ptr(), o.data_ptr(),
            l.data_ptr(), m.data_ptr(), _int64s(dims), _int64s(strides),
            _KV_DTYPES[k_blk.dtype], mm8._stream(qf.device),
        )
    mm8._check(code, "block_attention")
    block_attention.launches += 1
    _build.witness("block_attention", (qf, k_blk, v_blk, mask), (o, l, m))
    return o, l, m


block_attention.launches = 0


def _bwd_operands(what, qf, k_blk, v_blk, mask, m, dl, do):
    """Checked CUDA operands of a backward kernel: ``(pointers, dims,
    tail)``, where ``tail`` is the C interface's trailing arguments."""
    qf, k_blk, v_blk, mask, dims, strides = _operands(what, qf, k_blk, v_blk, mask)
    b, tq, _, h, _, d = dims
    if tuple(m.shape) != (b, h, tq) or tuple(dl.shape) != (b, h, tq) \
            or tuple(do.shape) != (b, h, tq, d):
        raise ValueError(f"{what}: m {tuple(m.shape)}, dl {tuple(dl.shape)} and do "
                         f"{tuple(do.shape)} do not fit qf {(b, tq, h, d)}")
    m = m.to(device=qf.device, dtype=torch.float32).contiguous()
    dl = dl.to(device=qf.device, dtype=torch.float32).contiguous()
    do = _lastdim_contiguous(do.to(device=qf.device, dtype=torch.float32))
    strides = strides + [do.stride(0), do.stride(2), do.stride(1)]  # batch, sequence, head
    # the converted operands stay referenced until the launch is enqueued
    keep = (qf, k_blk, v_blk, mask, m, dl, do)
    ptrs = tuple(t.data_ptr() for t in keep)
    tail = (_int64s(dims), _int64s(strides), _KV_DTYPES[k_blk.dtype], mm8._stream(qf.device))
    return keep, ptrs, dims, tail


def flash_attention_bwd_dq(qf, k_blk, v_blk, mask, m, dl, do) -> torch.Tensor:
    """``dq (b, tq, h, d)`` float32 of the fused backward: one launch of the
    dq kernel on the card, :func:`flash_attention_bwd_dq_plain` on the CPU."""
    if qf.device.type in _build.PLAIN_DEVICES:
        return flash_attention_bwd_dq_plain(qf, k_blk, v_blk, mask, m, dl, do)
    what = "flash_attention_bwd_dq"
    keep, ptrs, (b, tq, _, h, _, d), tail = _bwd_operands(what, qf, k_blk, v_blk, mask, m, dl, do)
    dq = torch.empty((b, tq, h, d), dtype=torch.float32, device=keep[0].device)
    with torch.cuda.device(dq.device):
        code = _lib().bagua_flash_bwd_dq(*ptrs, dq.data_ptr(), *tail)
    mm8._check(code, what)
    flash_attention_bwd_dq.launches += 1
    _build.witness(what, keep, (dq,))
    return dq


def flash_attention_bwd_dkv(qf, k_blk, v_blk, mask, m, dl, do) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)``, ``(b, tk, h_kv, d)`` in ``k_blk``'s type, of the fused
    backward: one launch of the dk/dv kernel on the card,
    :func:`flash_attention_bwd_dkv_plain` on the CPU."""
    if qf.device.type in _build.PLAIN_DEVICES:
        return flash_attention_bwd_dkv_plain(qf, k_blk, v_blk, mask, m, dl, do)
    what = "flash_attention_bwd_dkv"
    keep, ptrs, (b, _, tk, _, h_kv, d), tail = _bwd_operands(what, qf, k_blk, v_blk, mask, m, dl, do)
    dk = torch.empty((b, tk, h_kv, d), dtype=keep[1].dtype, device=keep[0].device)
    dv = torch.empty_like(dk)
    with torch.cuda.device(dk.device):
        code = _lib().bagua_flash_bwd_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), *tail)
    mm8._check(code, what)
    flash_attention_bwd_dkv.launches += 1
    _build.witness(what, keep, (dk, dv))
    return dk, dv


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0

#: the wrappers that launch kernels, for callers that read or reset the counts
KERNELS = (block_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)


def flash_attention_bwd(
    qf: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor, mask: torch.Tensor,
    m: torch.Tensor, dl: torch.Tensor, do: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused flash backward: ``(dq, dk, dv)`` from the residuals ``(qf, k,
    v, mask, m)`` and the cotangents ``do (b, h, tq, d)`` and ``dl (b, h,
    tq)``, with ``m`` held constant: :func:`flash_attention_bwd_dq` and
    :func:`flash_attention_bwd_dkv`, one kernel launch each on the card."""
    dq = flash_attention_bwd_dq(qf, k_blk, v_blk, mask, m, dl, do)
    return (dq, *flash_attention_bwd_dkv(qf, k_blk, v_blk, mask, m, dl, do))


class BlockAttentionFn(torch.autograd.Function):
    """Differentiable :func:`block_attention`: ``BlockAttentionFn.apply(qf,
    k, v, mask) -> (o, l, m)``, backward by :func:`flash_attention_bwd`.
    ``m`` is not differentiable (stop-gradient), so the ring's merges carry
    no gradient through the max shift; the JAX package drops the same
    cotangent (``f_bwd``, ``flash_attention.py:640-651``)."""

    @staticmethod
    def forward(ctx, qf, k_blk, v_blk, mask):
        o, l, m = block_attention(qf, k_blk, v_blk, mask)
        ctx.save_for_backward(qf, k_blk, v_blk, mask, m)
        ctx.mark_non_differentiable(m)
        return o, l, m

    @staticmethod
    def backward(ctx, do, dl, _dm):
        qf, k_blk, v_blk, mask, m = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(qf, k_blk, v_blk, mask, m, dl, do)
        return dq, dk, dv, None
