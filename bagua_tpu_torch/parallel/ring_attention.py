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
(``lax.cond`` per rank), the stacked ring leaves that rank's rows out of
the call: a causal ring's call serves the ranks whose block is live, and
each row of it is live.  Which ranks those are follows from the group's
layout, read on the host once (:func:`~bagua_tpu_torch.communication.member_index`),
so no call waits on the card.  The contiguous ring calls, at step i, the
members with ``my >= i``; the zigzag ring makes the JAX package's ``2sp +
1`` pair calls a pass.  A block wholly in the queries' past takes the
key-padding mask alone, expanded over the queries (no causal mask is
made for it).  The rows a call serves are copied out of the ring's
tensors for the call and again for its backward (:class:`_PickedBlockFn`),
so no copy is held between the two.  Every ``ppermute_shift`` still runs
at every step, on every rank.

Each block goes through :class:`~bagua_tpu_torch.kernels.flash_attention.BlockAttentionFn`
(the CUDA kernels on the card, the plain versions on the CPU), which takes
grouped K/V natively: with ``kv_groups > 1`` the ring ships the unrepeated
K/V heads.
"""

from typing import Optional

import numpy as np
import torch

from bagua_tpu_torch.communication import _index, axis_size, member_index, ppermute_shift
from bagua_tpu_torch.kernels.flash_attention import NEG, BlockAttentionFn, flash_attention_bwd, merge_blocks


def _fold(x: torch.Tensor) -> torch.Tensor:
    """``(R, b, ...)`` to ``(R*b, ...)``."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def _block(qf, k, v, mask):
    """One block call for every rank: ``(R, b, ...)`` folded to ``(R*b,
    ...)``; returns ``(o, l, m)`` folded, ``(R*b, h, tq, ...)``."""
    return BlockAttentionFn.apply(_fold(qf), _fold(k), _fold(v), _fold(mask))


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


def _triangle(t: int, device) -> torch.Tensor:
    """``(t, t)``: query i sees key j <= i (a block on the diagonal)."""
    pos = torch.arange(t, device=device)
    return pos[:, None] >= pos[None, :]


def _past_mask(kv_mask: torch.Tensor) -> torch.Tensor:
    """The mask of a block wholly in the queries' past: the key-padding mask
    ``(n, b, tk)``, folded and expanded over the queries with stride 0 (no
    copy)."""
    n, b, tk = kv_mask.shape
    return kv_mask.reshape(n * b, 1, tk).expand(n * b, tk, tk)


#: the fills of an all-masked block's ``(o, l, m)``: merging it is an exact
#: identity (up to the sign of zero)
_DEAD = (0.0, 0.0, NEG)


class _Ranks:
    """A block call on the ranks ``live`` (an index into the rank axis, of
    ``R``) of ``(qf, k, v)``, their keys wholly in the past; its result
    laid out over every rank, the others' rows all-masked."""

    def __init__(self, live: torch.Tensor, R: int):
        self.live, self.R = live, R

    def take(self, xs, kv_mask):
        q, k, v = (_fold(x.index_select(0, self.live)) for x in xs)
        return q, k, v, _past_mask(kv_mask.index_select(0, self.live))

    def spread(self, block):
        rows = block[0].shape[0] // self.live.shape[0]  # sequences a rank
        return tuple(x.new_full((self.R, rows, *x.shape[1:]), fill)
                     .index_copy_(0, self.live, x.reshape(-1, rows, *x.shape[1:])).reshape(-1, *x.shape[1:])
                     for x, fill in zip(block, _DEAD))

    def gather(self, grads):
        return tuple(_fold(g.reshape(self.R, -1, *g.shape[1:]).index_select(0, self.live)) for g in grads[:2])

    def give(self, grads, xs):
        return [x.new_zeros(x.shape).index_copy_(0, self.live, g.reshape(-1, *x.shape[1:]))
                for g, x in zip(grads, xs)]


class _Halves:
    """A block call in which each rank takes one of two (q, k, v) halves:
    the first where ``first`` holds, else the second; of ``(q0, q1, k0, k1,
    v0, v1)`` and the key-padding mask of the whole local block, its keys
    wholly in the past.  Its result as two blocks over every rank, the
    first half's and the second's, the other rows all-masked in each."""

    def __init__(self, first: torch.Tensor):
        self.first = first

    def take(self, xs, kv_mask):
        t2 = xs[0].shape[2]
        q, k, v = (_fold(_where_ranks(self.first, a, b)) for a, b in zip(xs[::2], xs[1::2]))
        return q, k, v, _past_mask(_where_ranks(self.first, kv_mask[:, :, :t2], kv_mask[:, :, t2:]))

    def spread(self, block):
        return (*(_where_ranks(self.first, x, fill) for x, fill in zip(block, _DEAD)),
                *(_where_ranks(self.first, fill, x) for x, fill in zip(block, _DEAD)))

    def gather(self, grads):
        return tuple(_where_ranks(self.first, a, b) for a, b in zip(grads[:2], grads[3:5]))

    def give(self, grads, xs):
        out = []
        for g, x in zip(grads, xs[::2]):
            g = g.reshape(x.shape)
            out += [_where_ranks(self.first, g, 0.0), _where_ranks(self.first, 0.0, g)]
        return out


class _PickedBlockFn(torch.autograd.Function):
    """:class:`BlockAttentionFn` on the rows that ``pick`` (:class:`_Ranks`,
    :class:`_Halves`) takes from the ring's tensors ``xs``: ``pick.take``
    copies them out, and the backward takes them again instead of keeping
    the copies, so a call holds no more memory until its backward than an
    unpicked one.  The result comes back laid out over every rank by
    ``pick.spread``, all-masked ``(0, 0, NEG)`` on the rows the call did not
    serve, and the ring merges it as it merged an unpicked call's: the
    carry of a row left out stays as it was.  ``pick.give`` lays the rows'
    gradients back out over ``xs``, zeros elsewhere."""

    @staticmethod
    def forward(ctx, pick, kv_mask, *xs):
        o, l, m = BlockAttentionFn.apply(*pick.take(xs, kv_mask))
        ctx.pick = pick
        ctx.save_for_backward(kv_mask, m, *xs)
        out = pick.spread((o, l, m))
        ctx.mark_non_differentiable(*out[2::3])
        return out

    @staticmethod
    def backward(ctx, *grads):
        kv_mask, m, *xs = ctx.saved_tensors
        do, dl = ctx.pick.gather(grads)
        grads = flash_attention_bwd(*ctx.pick.take(xs, kv_mask), m, dl, do)
        return (None, None, *ctx.pick.give(grads, xs))


class _Keep(torch.autograd.Function):
    """The identity on ``x`` that also takes ``ys`` and gives them zero
    gradients: holds a ring step's K/V in the backward of a process that
    makes no call with them, so that the backward of their ring shift, a
    collective across processes, runs in every process."""

    @staticmethod
    def forward(ctx, x, *ys):
        ctx.ys = [(y.shape, y.dtype, y.device) for y in ys]
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(shape, dtype=dtype, device=device) for shape, dtype, device in ctx.ys))


def _where_ranks(first: torch.Tensor, a, b) -> torch.Tensor:
    """Rank by rank, ``a``'s rows where ``first`` (``(R,)`` bool) holds and
    ``b``'s elsewhere; each a tensor with a leading rank axis, or folded
    ``(R * b, ...)``, or a number."""
    like = a if torch.is_tensor(a) else b
    R = first.shape[0]
    split = lambda x: x.reshape(R, -1, *like.shape[1:]) if torch.is_tensor(x) else x  # noqa: E731
    cond = first.reshape(R, *([1] * like.dim()))
    return torch.where(cond, split(a), split(b)).reshape(like.shape)


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
        group, axis: the sequence-parallel axis of the group (``"sp"`` of
            a named mesh, ``"inter"`` or ``"intra"`` of the legacy one).  With
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

    my = member_index(group, axis)
    o, l, m = _empty(R * b, h, t, d, q.device)
    k_blk, v_blk, mask_blk = k, v, kv_mask
    for i in range(sp):
        # the block held at step i came from member (my - i) mod sp: for
        # i > 0 it lies wholly in the past of the members with my >= i and
        # wholly in the future of the rest, which the call leaves out
        if i == 0 or not causal:
            mask = mask_blk[:, :, None, :].expand(R, b, t, t)
            if causal:
                mask = mask & _triangle(t, q.device)
            o, l, m = merge_blocks((o, l, m), _block(qf, k_blk, v_blk, mask))
        elif (my >= i).any():
            live = _index(group, ("ring_live", axis, i), lambda i=i: np.flatnonzero(my >= i))
            o, l, m = merge_blocks((o, l, m), _PickedBlockFn.apply(_Ranks(live, R), mask_blk, qf, k_blk, v_blk))
        else:
            # none of this process's ranks is live: no call, but the block
            # stays in the backward, whose ring shifts every process joins
            o = _Keep.apply(o, k_blk, v_blk)
        if i < sp - 1:
            k_blk = ppermute_shift(k_blk, 1, group, axis)
            v_blk = ppermute_shift(v_blk, 1, group, axis)
            mask_blk = ppermute_shift(mask_blk, 1, group, axis)
    return _normalize(o, l, R, q.dtype)


def _ring_attention_zigzag(qf, k, v, kv_mask, group, axis, sp, out_dtype):
    """Zigzag-layout causal ring: member r's local sequence is global
    half-blocks ``(r, 2sp-1-r)``, and a (q half, k half) pair is live iff
    the k half does not lie in the q half's future, as in the JAX package.
    Every member has ``2sp + 1`` live pairs a pass, and the ring makes one
    block call for each (rank-folded): at step 0 the diagonal pairs (0,0)
    and (1,1) and the whole pair (1,0); at each later step (1,0), whole
    for every member, and one call in which each member takes its own
    other live pair, (0,0) where ``my >= i`` and (1,1) where ``my < i``.
    Pair (0,1) is never live.  Each accumulator merges its pairs in the
    JAX package's order."""
    R, b, t, h, d = qf.shape
    if t % 2 != 0:
        raise ValueError(f"zigzag needs an even local length, got {t}")
    t2 = t // 2
    my = member_index(group, axis)
    q_halves = (qf[:, :, :t2], qf[:, :, t2:])
    acc = [_empty(R * b, h, t2, d, qf.device) for _ in range(2)]
    k_blk, v_blk, mask_blk = k, v, kv_mask

    def half(blk, kh):  # k half kh of a rotating block
        return blk[:, :, kh * t2:(kh + 1) * t2]

    for i in range(sp):
        if i == 0:
            diagonal = _triangle(t2, qf.device)
            for qh, kh in ((0, 0), (1, 0), (1, 1)):
                mask = half(mask_blk, kh)[:, :, None, :].expand(R, b, t2, t2)
                if qh == kh:
                    mask = mask & diagonal
                block = _block(q_halves[qh], half(k_blk, kh), half(v_blk, kh), mask)
                acc[qh] = merge_blocks(acc[qh], block)
        else:
            # the picked call reads K/V views sliced before (1,0)'s and is made
            # after (1,0): autograd then sums each tensor's gradients in the
            # order the four-pair ring did (bitwise the same)
            k_halves, v_halves = (half(k_blk, 0), half(k_blk, 1)), (half(v_blk, 0), half(v_blk, 1))
            mask = half(mask_blk, 0)[:, :, None, :].expand(R, b, t2, t2)
            acc[1] = merge_blocks(acc[1], _block(q_halves[1], half(k_blk, 0), half(v_blk, 0), mask))
            first = _index(group, ("ring_first", axis, i), lambda i=i: my >= i) != 0
            blocks = _PickedBlockFn.apply(_Halves(first), mask_blk, *q_halves, *k_halves, *v_halves)
            acc = [merge_blocks(acc[0], blocks[:3]), merge_blocks(acc[1], blocks[3:])]
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
