"""Ring attention: sequence parallelism over a group axis.

The port of ``bagua_tpu/parallel/ring_attention.py``.  The sequence is
sharded over the ``axis`` of a :class:`~bagua_tpu_torch.BaguaProcessGroup`
and attention runs blockwise: each rank attends its local queries to one
K/V block at a time while the K/V blocks rotate around the ring
(:func:`~bagua_tpu_torch.communication.ppermute_shift`), folding each
block's contribution into an online-softmax carry.

Tensors are rank-stacked, ``(R, b, t, heads, d)`` with ``R`` the group
size, and the rank axis is folded into the batch, so every block call of a
ring step serves all ranks at once: one kernel launch, not R.  Where the
JAX package skips a block that lies in a rank's causal future
(``lax.cond`` per rank), the stacked ring computes it for every rank and
lets the mask do the skipping: the kernel drops dead tiles, and an
all-masked contribution ``(0, 0, NEG)`` merges as an exact identity, with
zero gradient.

Each block goes through :class:`~bagua_tpu_torch.kernels.flash_attention.BlockAttentionFn`
(the CUDA kernels on the card, the plain versions on the CPU), which takes
grouped K/V natively: with ``kv_groups > 1`` the ring ships the unrepeated
K/V heads.
"""

from typing import Optional

import numpy as np
import torch

from bagua_tpu_torch.communication import axis_size, ppermute_shift, rank_id
from bagua_tpu_torch.kernels.flash_attention import NEG, BlockAttentionFn, merge_blocks


def _block(qf, k, v, mask):
    """One block call for every rank: ``(R, b, ...)`` folded to ``(R*b,
    ...)``; returns ``(o, l, m)`` folded, ``(R*b, h, tq, ...)``."""
    fold = lambda x: x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])  # noqa: E731
    return BlockAttentionFn.apply(fold(qf), fold(k), fold(v), fold(mask))


def _empty(n: int, h: int, t: int, d: int, device):
    return (torch.zeros((n, h, t, d), dtype=torch.float32, device=device),
            torch.zeros((n, h, t), dtype=torch.float32, device=device),
            torch.full((n, h, t), NEG, dtype=torch.float32, device=device))


def _normalize(o, l, R: int, dtype):
    """``o / l`` (``l = 0``, a fully masked row, divides by 1), unfolded to
    ``(R, b, t, h, d)``."""
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (o / l[..., None]).to(dtype)
    return out.reshape(R, -1, *out.shape[1:]).transpose(2, 3)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group=None,
    axis="intra",
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
    layout: str = "contiguous",
    kv_groups: int = 1,
) -> torch.Tensor:
    """Blockwise ring attention.

    Args:
        q, k, v: rank-stacked local blocks ``(R, b, t_local, heads, d)``.
            The global sequence is the concatenation of the blocks of an
            ``axis`` collective in member order (``layout="contiguous"``) or
            in zigzag order.  With ``kv_groups > 1`` K/V carry ``heads //
            kv_groups`` heads.
        group, axis: the sequence-parallel axis of the group.  With
            ``group=None`` every rank stands alone (``sp == 1``).
        causal: a causal mask over *global* positions.
        kv_mask: optional key-padding mask of the local block, ``(R, b,
            t_local)`` bool, True = attend; it rotates with its K/V block.
        layout: ``"contiguous"`` (member i holds global block i) or
            ``"zigzag"`` (member i holds global half-blocks ``(i, 2sp-1-i)``;
            permute with :func:`zigzag_order` before sharding), the balanced
            causal schedule.

    Returns:
        Attention output for the local queries, shaped and typed as ``q``.
    """
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown layout {layout!r}")
    sp = 1 if group is None else axis_size(group, axis)
    R, b, t, h, d = q.shape
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    qf = q.to(torch.float32) * scale.to(q.device)
    if kv_mask is None:
        kv_mask = torch.ones((R, b, k.shape[2]), dtype=torch.bool, device=q.device)
    if kv_groups > 1 and k.shape[3] * kv_groups != h:
        raise ValueError(
            f"kv_groups={kv_groups} needs K/V with {h // kv_groups} heads, "
            f"got {k.shape[3]} (q has {h})"
        )

    if sp == 1:
        # zigzag of 1 rank is the identity layout
        t_k = k.shape[2]
        mask = kv_mask[:, :, None, :].expand(R, b, t, t_k)
        if causal:
            tri = torch.arange(t, device=q.device)[:, None] >= torch.arange(t_k, device=q.device)
            mask = mask & tri
        o, l, _ = _block(qf, k, v, mask)
        return _normalize(o, l, R, q.dtype)

    if layout == "zigzag" and causal:
        # non-causal attention does not depend on the blocks' order: the
        # contiguous ring below computes the same with one call per step
        return _ring_attention_zigzag(qf, k, v, kv_mask, group, axis, sp, q.dtype)

    my = rank_id(group, axis)
    pos = torch.arange(t, device=q.device)
    o, l, m = _empty(R * b, h, t, d, q.device)
    k_blk, v_blk, mask_blk = k, v, kv_mask
    for i in range(sp):
        # the block held at step i came from member (my - i) mod sp
        mask = mask_blk[:, :, None, :].expand(R, b, t, t)
        if causal:
            src = (my - i) % sp
            q_pos = my[:, None] * t + pos
            k_pos = src[:, None] * t + pos
            mask = mask & (q_pos[:, :, None] >= k_pos[:, None, :])[:, None]
        o, l, m = merge_blocks((o, l, m), _block(qf, k_blk, v_blk, mask))
        if i < sp - 1:
            k_blk = ppermute_shift(k_blk, 1, group, axis)
            v_blk = ppermute_shift(v_blk, 1, group, axis)
            mask_blk = ppermute_shift(mask_blk, 1, group, axis)
    return _normalize(o, l, R, q.dtype)


def _ring_attention_zigzag(qf, k, v, kv_mask, group, axis, sp, out_dtype):
    """Zigzag-layout causal ring: member r's local sequence is global
    half-blocks ``(r, 2sp-1-r)``.  Each ring step merges the four (q-half,
    k-half) pairs, in the JAX package's order; a pair whose k half lies in
    a rank's future is masked out for that rank."""
    R, b, t, h, d = qf.shape
    if t % 2 != 0:
        raise ValueError(f"zigzag needs an even local length, got {t}")
    t2 = t // 2
    my = rank_id(group, axis)
    pos = torch.arange(t2, device=qf.device)
    q_halves = (qf[:, :, :t2], qf[:, :, t2:])
    qg = (my, 2 * sp - 1 - my)  # global half-block id of each local q half
    acc = [_empty(R * b, h, t2, d, qf.device) for _ in range(2)]
    k_blk, v_blk, mask_blk = k, v, kv_mask
    for i in range(sp):
        src = (my - i) % sp
        kg = (src, 2 * sp - 1 - src)
        for qh in range(2):
            q_pos = qg[qh][:, None] * t2 + pos
            for kh in range(2):
                k_pos = kg[kh][:, None] * t2 + pos
                half = slice(kh * t2, (kh + 1) * t2)
                mask = mask_blk[:, :, None, half].expand(R, b, t2, t2)
                mask = mask & (q_pos[:, :, None] >= k_pos[:, None, :])[:, None]
                block = _block(q_halves[qh], k_blk[:, :, half], v_blk[:, :, half], mask)
                acc[qh] = merge_blocks(acc[qh], block)
        if i < sp - 1:
            k_blk = ppermute_shift(k_blk, 1, group, axis)
            v_blk = ppermute_shift(v_blk, 1, group, axis)
            mask_blk = ppermute_shift(mask_blk, 1, group, axis)
    outs = [_normalize(o, l, R, out_dtype) for o, l, _ in acc]
    return torch.cat(outs, dim=2)


def zigzag_order(seq_len: int, sp: int) -> np.ndarray:
    """Global index permutation laying a length-``seq_len`` sequence out so
    that contiguous per-rank shards hold global half-blocks ``(r, 2sp-1-r)``
    (the balanced causal layout).  Apply with ``x[:, zigzag_order(T, sp)]``
    before sharding; invert with :func:`zigzag_inverse`."""
    if seq_len % (2 * sp) != 0:
        raise ValueError(f"seq_len {seq_len} not divisible by 2*sp={2 * sp}")
    t2 = seq_len // (2 * sp)
    order = []
    for r in range(sp):
        order.extend(range(r * t2, (r + 1) * t2))
        order.extend(range((2 * sp - 1 - r) * t2, (2 * sp - r) * t2))
    return np.asarray(order)


def zigzag_inverse(seq_len: int, sp: int) -> np.ndarray:
    """Inverse permutation of :func:`zigzag_order` (maps zigzag-laid-out
    positions back to natural order)."""
    order = zigzag_order(seq_len, sp)
    inv = np.empty_like(order)
    inv[order] = np.arange(seq_len)
    return inv


def _block_attention_local(q, k, v, causal=False, kv_mask=None):
    """Plain (quadratic) single-device attention, the test oracle: ``q, k,
    v`` ``(b, t, h, d)`` with as many K/V heads as query heads."""
    b, t, h, d = q.shape
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32) * scale.to(q.device), k.to(torch.float32))
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :], s, -torch.inf)
    if causal:
        mask = torch.arange(t, device=q.device)[:, None] >= torch.arange(k.shape[1], device=q.device)
        s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return out.to(q.dtype)
