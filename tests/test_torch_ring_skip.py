"""The causal rings call only the blocks the JAX package computes.

The JAX package skips every block that lies wholly in a rank's causal
future (``lax.cond`` per rank: ``bagua_tpu/parallel/ring_attention.py``
:178 for the contiguous ring, :222 for the zigzag pairs).  The port's
stacked ring folds the ranks into one call, so it skips a block by
leaving that rank's rows out of the call.  Held here on the CPU:

- against the JAX package's ``ring_attention`` under ``shard_map`` (jnp and
  interpret-mode Pallas), both layouts at sp 2 and sp 4, GQA K/V and a
  key-padding mask: the output within ``BLOCK_TOL`` and the gradients of
  ``sum(sin(y))`` within ``GRAD_TOL`` (``tests/test_torch_flash_attention.py``'s
  bounds);
- the calls, by a spy on ``BlockAttentionFn.apply``: zigzag makes ``2sp + 1``
  a pass and no row of any call has an all-false causal mask; the
  contiguous ring makes ``sp``, with the rows of ``R (sp - i) / sp`` ranks at
  step i; a block wholly in the past gets its key-padding mask expanded
  over the queries (stride 0), no causal mask;
- against the four-pair ring it replaced (``_four_pair_ring`` below, kept as
  the witness: every pair of every ring step called for every rank, the
  dead ones masked out): outputs and gradients **bitwise** on the CPU in
  every case here (the plain versions compute each row alone, the merge of
  an all-masked block is an exact identity, and autograd sums each
  tensor's gradients in the same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from bagua_tpu.parallel import ring_attention as jra

from bagua_tpu_torch.communication import BaguaProcessGroup, axis_size, ppermute_shift, rank_id
from bagua_tpu_torch.kernels import flash_attention as fa
from bagua_tpu_torch.mesh import MeshSpec
from bagua_tpu_torch.parallel import ring_attention as ra

from test_torch_flash_attention import BLOCK_TOL, GRAD_TOL

CPU = torch.device("cpu")
DP = 2


# ---------------------------------------------------------------------------
# The witness: the stacked ring before it skipped dead blocks
# ---------------------------------------------------------------------------


def _four_pair_ring(q, k, v, group, axis, causal, kv_mask, layout, kv_groups):
    """The port's ring as it was: every block call serves every rank, a
    block in a rank's future masked out for it; zigzag calls all four
    (q half, k half) pairs at every step."""
    sp = axis_size(group, axis)
    R, b, t, h, d = q.shape
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    qf = q.to(torch.float32) * scale
    if kv_mask is None:
        kv_mask = torch.ones((R, b, k.shape[2]), dtype=torch.bool)
    my = rank_id(group, axis)
    if layout == "zigzag" and causal:
        t2 = t // 2
        pos = torch.arange(t2)
        q_halves = (qf[:, :, :t2], qf[:, :, t2:])
        qg = (my, 2 * sp - 1 - my)
        acc = [ra._empty(R * b, h, t2, d, CPU) for _ in range(2)]
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
                    block = ra._block(q_halves[qh], k_blk[:, :, half], v_blk[:, :, half], mask)
                    acc[qh] = fa.merge_blocks(acc[qh], block)
            if i < sp - 1:
                k_blk, v_blk, mask_blk = (ppermute_shift(x, 1, group, axis) for x in (k_blk, v_blk, mask_blk))
        return torch.cat([ra._normalize(o, l, R, q.dtype) for o, l, _ in acc], dim=2)
    pos = torch.arange(t)
    o, l, m = ra._empty(R * b, h, t, d, CPU)
    k_blk, v_blk, mask_blk = k, v, kv_mask
    for i in range(sp):
        mask = mask_blk[:, :, None, :].expand(R, b, t, t)
        if causal:
            src = (my - i) % sp
            q_pos, k_pos = my[:, None] * t + pos, src[:, None] * t + pos
            mask = mask & (q_pos[:, :, None] >= k_pos[:, None, :])[:, None]
        o, l, m = fa.merge_blocks((o, l, m), ra._block(qf, k_blk, v_blk, mask))
        if i < sp - 1:
            k_blk, v_blk, mask_blk = (ppermute_shift(x, 1, group, axis) for x in (k_blk, v_blk, mask_blk))
    return ra._normalize(o, l, R, q.dtype)


# ---------------------------------------------------------------------------
# Inputs and the two packages' rings
# ---------------------------------------------------------------------------


def ring_inputs(seed, h=4, h_kv=2, B=2 * DP, T=32, d=8):
    """Global ``q, k, v`` ``(B, T, heads, d)`` and a key-padding mask ``(B,
    T)`` whose first key is kept (each causal row keeps a key)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, h, d).astype(np.float32)
    k = rng.randn(B, T, h_kv, d).astype(np.float32)
    v = rng.randn(B, T, h_kv, d).astype(np.float32)
    kv_mask = rng.rand(B, T) < 0.7
    kv_mask[:, 0] = True
    return q, k, v, kv_mask


def shard(x: np.ndarray, sp: int) -> torch.Tensor:
    """Global ``(B, T, ...)`` to the stacked ``(DP * sp, B / DP, T / sp,
    ...)`` shards of ``P("dp", "sp")``."""
    B, T = x.shape[:2]
    s = x.reshape(DP, B // DP, sp, T // sp, *x.shape[2:]).swapaxes(1, 2)
    return torch.from_numpy(np.ascontiguousarray(s.reshape(DP * sp, B // DP, T // sp, *x.shape[2:])))


def unshard(t: torch.Tensor, sp: int) -> np.ndarray:
    x = t.detach().numpy()
    b, t_local = x.shape[1:3]
    g = x.reshape(DP, sp, b, t_local, *x.shape[3:]).swapaxes(1, 2)
    return g.reshape(DP * b, sp * t_local, *x.shape[3:])


def jax_ring(q, k, v, kv_mask, layout, sp, use_pallas):
    """``(y, (dq, dk, dv))`` of the JAX package's causal GQA ring under
    ``shard_map`` on a ``("dp", "sp")`` mesh, the gradients of
    ``sum(sin(y))``."""
    mesh = Mesh(np.array(jax.devices()[:DP * sp]).reshape(DP, sp), ("dp", "sp"))
    spec = P("dp", "sp")

    def ring(qq, kk, vv, mm):
        return jra.ring_attention(qq, kk, vv, axis_name="sp", causal=True, kv_mask=mm, layout=layout,
                                  kv_groups=q.shape[2] // k.shape[2], use_pallas=use_pallas,
                                  interpret=use_pallas)

    fwd = jax.shard_map(ring, mesh=mesh, in_specs=(spec,) * 4, out_specs=spec, check_vma=False)
    mm = jnp.asarray(kv_mask)
    loss = lambda q_, k_, v_: jnp.sum(jnp.sin(fwd(q_, k_, v_, mm)))  # noqa: E731
    args = tuple(map(jnp.asarray, (q, k, v)))
    y = jax.jit(fwd)(*args, mm)
    return np.asarray(y), [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)]


def port_ring(q, k, v, kv_mask, layout, sp):
    group = BaguaProcessGroup([CPU] * (DP * sp), intra_size=sp)
    qs, ks, vs = (shard(x, sp).requires_grad_() for x in (q, k, v))
    y = ra.ring_attention(qs, ks, vs, group, "intra", causal=True, kv_mask=shard(kv_mask, sp), layout=layout,
                          kv_groups=q.shape[2] // k.shape[2])
    torch.sin(y).sum().backward()
    return unshard(y, sp), [unshard(x.grad, sp) for x in (qs, ks, vs)]


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_skipping_ring_matches_jax(layout, sp, use_pallas, monkeypatch):
    """Causal ring with GQA K/V (4 query heads, 2 K/V heads) and a
    key-padding mask, forward and gradients, against JAX's jnp path and its
    fused Pallas path (stop-gradient m, ``BAGUA_PALLAS_FLASH_BWD=1``)."""
    monkeypatch.setenv("BAGUA_PALLAS_FLASH_BWD", "1")
    q, k, v, kv_mask = ring_inputs(11 + sp)
    y, grads = port_ring(q, k, v, kv_mask, layout, sp)
    y_j, grads_j = jax_ring(q, k, v, kv_mask, layout, sp, use_pallas)
    np.testing.assert_allclose(y, y_j, rtol=BLOCK_TOL, atol=BLOCK_TOL)
    for name, g, w in zip(("dq", "dk", "dv"), grads, grads_j):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)


# ---------------------------------------------------------------------------
# The calls
# ---------------------------------------------------------------------------


@pytest.fixture()
def calls(monkeypatch):
    """Every ``BlockAttentionFn.apply``'s ``(rows, mask)`` and the count of
    backward passes (dq kernel calls)."""
    seen = {"fwd": [], "bwd": 0}
    apply, dq = fa.BlockAttentionFn.apply, fa.flash_attention_bwd_dq

    def spy_apply(qf, k, v, mask):
        seen["fwd"].append((qf.shape[0], mask))
        return apply(qf, k, v, mask)

    def spy_dq(*args):
        seen["bwd"] += 1
        return dq(*args)

    monkeypatch.setattr(fa.BlockAttentionFn, "apply", spy_apply)
    monkeypatch.setattr(fa, "flash_attention_bwd_dq", spy_dq)
    return seen


def stacked_run(layout, sp, dp=DP, kv_mask=True, causal=True, seed=3, group=None, axis="intra"):
    """The port's ring on a ``dp x sp`` stack (``intra_size=sp``) and its
    gradients against a seeded cotangent: ``[y, dq, dk, dv]``."""
    group = group or BaguaProcessGroup([CPU] * (dp * sp), intra_size=sp)
    rng = np.random.RandomState(seed)
    R, t = group.size, 8
    q, k, v = (torch.from_numpy(rng.randn(R, 2, t, h, 8).astype(np.float32)).requires_grad_()
               for h in (4, 2, 2))
    mask = torch.from_numpy(rng.rand(R, 2, t) < 0.7) if kv_mask else None
    cot = torch.from_numpy(rng.randn(R, 2, t, 4, 8).astype(np.float32))
    y = ra.ring_attention(q, k, v, group, axis, causal=causal, kv_mask=mask, layout=layout, kv_groups=2)
    (y * cot).sum().backward()
    return [y.detach()] + [x.grad for x in (q, k, v)]


@pytest.mark.parametrize("sp", [2, 3, 4])
def test_zigzag_calls_the_2sp_plus_1_live_pairs(calls, sp):
    """``2sp + 1`` block calls a pass, each over every rank's rows; no row's
    causal mask is all false; the calls past step 0's two diagonal ones
    take the key-padding mask alone, stride 0 over the queries; one
    backward a call."""
    stacked_run("zigzag", sp, kv_mask=False)
    assert len(calls["fwd"]) == 2 * sp + 1 and calls["bwd"] == 2 * sp + 1
    R = DP * sp
    for n, (rows, mask) in enumerate(calls["fwd"]):
        assert rows == R * 2
        assert bool(mask.reshape(rows, -1).any(1).all()), f"call {n} has a dead row"
        diagonal = n in (0, 2)  # step 0: (0,0), (1,0), (1,1)
        assert (mask.stride(1) == 0) is not diagonal, n
        if diagonal:
            t2 = mask.shape[1]
            assert torch.equal(mask, torch.ones((t2, t2), dtype=torch.bool).tril().expand_as(mask))


@pytest.mark.parametrize("sp", [2, 3, 4])
def test_contiguous_calls_the_live_ranks_only(calls, sp):
    """``sp`` block calls a pass; at step i the rows of the ``R (sp - i) /
    sp`` ranks with ``my >= i``, a block wholly in their past (key-padding
    mask alone, stride 0); step 0 the diagonal for every rank."""
    stacked_run("contiguous", sp, kv_mask=False)
    R = DP * sp
    assert [rows for rows, _ in calls["fwd"]] == [R * (sp - i) // sp * 2 for i in range(sp)]
    assert calls["bwd"] == sp
    for i, (rows, mask) in enumerate(calls["fwd"]):
        assert bool(mask.reshape(rows, -1).any(1).all())
        if i:
            assert mask.stride(1) == 0 and bool(mask.all())


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_non_causal_ring_is_unchanged(calls, layout):
    """A non-causal ring (BERT's, with a key-padding mask) calls every rank
    at every step, as before, whatever the layout."""
    sp = 4
    stacked_run(layout, sp, causal=False)
    assert [rows for rows, _ in calls["fwd"]] == [DP * sp * 2] * sp


# ---------------------------------------------------------------------------
# Against the four-pair witness, bitwise
# ---------------------------------------------------------------------------


WITNESS_CASES = {
    "dp2-sp2": dict(dp=2, sp=2), "dp1-sp4": dict(dp=1, sp=4), "dp2-sp4": dict(dp=2, sp=4),
    "dp1-sp3": dict(dp=1, sp=3), "dp2-sp4-no-kv-mask": dict(dp=2, sp=4, kv_mask=False),
    "dp2-sp4-non-causal": dict(dp=2, sp=4, causal=False),
}


def _witness_run(monkeypatch, layout, **kw):
    """``stacked_run`` through the four-pair ring instead."""
    with monkeypatch.context() as m:
        m.setattr(ra, "ring_attention", _four_pair_ring)
        return stacked_run(layout, **kw)


@pytest.mark.parametrize("case", list(WITNESS_CASES))
@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_skipping_ring_is_the_four_pair_ring_bitwise(monkeypatch, layout, case):
    """Output and the three gradients equal the four-pair ring's bit for
    bit on the CPU (``torch.equal``: -0 and +0 compare equal; a merged
    all-masked block turns a -0 carry into +0)."""
    want = _witness_run(monkeypatch, layout, **WITNESS_CASES[case])
    got = stacked_run(layout, **WITNESS_CASES[case])
    for name, g, w in zip(("y", "dq", "dk", "dv"), got, want):
        assert torch.equal(g, w), f"{name} off by {float((g - w).abs().max()):.3e}"


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_sp_axis_outside_the_data_axis_is_bitwise(monkeypatch, layout):
    """A named mesh whose sp axis is the outer one (rank r's sp coordinate
    r // dp): the live ranks are read from the group's layout."""
    group = BaguaProcessGroup([CPU] * 8, mesh_spec=MeshSpec({"sp": 4, "dp": 2}))
    want = _witness_run(monkeypatch, layout, sp=4, group=group, axis="sp")
    got = stacked_run(layout, sp=4, group=group, axis="sp")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
