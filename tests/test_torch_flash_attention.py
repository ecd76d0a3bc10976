"""The port's flash-attention block and ring attention against the JAX package.

Inputs are made with numpy from a seed and go through both packages on the
CPU: the port's wrappers take their plain versions there, and the JAX side
runs its jnp reference and its Pallas kernels in interpret mode.  The ring
runs on an 8-rank group (``[cpu] * 8``, ``intra_size=4``: dp = inter = 2,
sp = intra = 4) against JAX's ``ring_attention`` under ``shard_map`` on a
``("dp", "sp") = (2, 4)`` mesh.

Tolerances: one block within 1e-5 (f32 sums in another order); composed
ring gradients within 3e-4, the JAX package's own bound for its fused
backward against the jnp path (``tests/test_parallel.py:391-424``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from bagua_tpu.kernels import flash_attention as jfa
from bagua_tpu.parallel import ring_attention as jra

from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.kernels import flash_attention as fa
from bagua_tpu_torch.parallel import ring_attention as ra

BLOCK_TOL = 1e-5
GRAD_TOL = 3e-4
DP, SP = 2, 4


def make_mask(kind: str, b: int, tq: int, tk: int, rng) -> np.ndarray:
    if kind == "causal":
        mask = np.tril(np.ones((tq, tk), bool), k=tk - tq)[None].repeat(b, 0)
    elif kind == "firstcol":  # only the first key survives
        mask = np.zeros((b, tq, tk), bool)
        mask[:, :, 0] = True
    else:
        mask = rng.rand(b, tq, tk) < 0.6
    mask[:, 3] = False  # a fully masked row
    return mask


def block_inputs(seed, b, tq, tk, h, h_kv, d, kind):
    rng = np.random.RandomState(seed)
    qf = (rng.randn(b, tq, h, d) / np.sqrt(d)).astype(np.float32)
    k = rng.randn(b, tk, h_kv, d).astype(np.float32)
    v = rng.randn(b, tk, h_kv, d).astype(np.float32)
    return qf, k, v, make_mask(kind, b, tq, tk, rng)


BLOCK_CASES = [
    # (b, tq, tk, h, h_kv, d, mask): non-aligned lengths, GQA, masked rows
    (2, 40, 72, 2, 2, 24, "causal"),
    (1, 33, 20, 4, 2, 16, "firstcol"),
    (2, 70, 130, 4, 1, 8, "random"),
]


@pytest.mark.parametrize("case", BLOCK_CASES, ids=lambda c: f"{c[1]}x{c[2]}-h{c[3]}kv{c[4]}-{c[6]}")
def test_block_attention_matches_jax(case):
    """The plain version (what the wrapper runs on the CPU) against JAX's
    jnp reference (K/V repeated to the query heads) and its Pallas kernel
    in interpret mode (grouped K/V by index)."""
    b, tq, tk, h, h_kv, d, kind = case
    qf, k, v, mask = block_inputs(0, b, tq, tk, h, h_kv, d, kind)
    t = [torch.from_numpy(x) for x in (qf, k, v, mask)]
    got = fa.block_attention(*t)
    plain = fa.block_attention_plain(*t)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    g_rep = h // h_kv
    want_jnp = jfa.block_attention(jnp.asarray(qf), jnp.repeat(k, g_rep, axis=2),
                                   jnp.repeat(v, g_rep, axis=2), jnp.asarray(mask))
    want_pallas = jfa.block_attention_pallas(*map(jnp.asarray, (qf, k, v, mask)), interpret=True)
    for want in (want_jnp, want_pallas):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=BLOCK_TOL, atol=BLOCK_TOL)
    # a fully masked row ends with m = NEG, l = 0, o = 0
    o, l, m = got
    assert torch.all(m[:, :, 3] == fa.NEG) and torch.all(l[:, :, 3] == 0) and torch.all(o[:, :, 3] == 0)


@pytest.mark.parametrize("case", BLOCK_CASES, ids=lambda c: f"{c[1]}x{c[2]}-h{c[3]}kv{c[4]}-{c[6]}")
def test_flash_bwd_plain_matches_jax_pallas(case):
    """dq and dk/dv of the plain versions against the JAX package's fused
    backward kernels in interpret mode, block by block: both hold m
    constant (stop-gradient) and sum dk/dv over each K/V head's query
    heads."""
    b, tq, tk, h, h_kv, d, kind = case
    qf, k, v, mask = block_inputs(1, b, tq, tk, h, h_kv, d, kind)
    rng = np.random.RandomState(2)
    _, _, m = fa.block_attention_plain(*(torch.from_numpy(x) for x in (qf, k, v, mask)))
    m = m.numpy()
    dl = rng.randn(b, h, tq).astype(np.float32)
    do = rng.randn(b, h, tq, d).astype(np.float32)
    got = fa.flash_attention_bwd(*(torch.from_numpy(x) for x in (qf, k, v, mask, m, dl, do)))
    want = jfa.flash_attention_bwd_pallas(*map(jnp.asarray, (qf, k, v, mask, m, dl, do)), interpret=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=BLOCK_TOL, atol=BLOCK_TOL, err_msg=name)


def test_all_masked_block_merges_as_identity():
    """The stacked ring computes a block that lies in a rank's causal
    future instead of skipping it: its contribution is exactly (0, 0, NEG),
    and merging it leaves any carry bit for bit as it was, the empty carry
    included, with zero gradient into q, k and v."""
    qf, k, v, _ = block_inputs(3, 2, 16, 24, 4, 2, 8, "random")
    qf, k, v = (torch.from_numpy(x).requires_grad_() for x in (qf, k, v))
    dead = torch.zeros((2, 16, 24), dtype=torch.bool)
    o_b, l_b, m_b = fa.BlockAttentionFn.apply(qf, k, v, dead)
    assert torch.equal(o_b, torch.zeros_like(o_b)) and torch.equal(l_b, torch.zeros_like(l_b))
    assert torch.all(m_b == fa.NEG)
    live = torch.from_numpy(make_mask("random", 2, 16, 24, np.random.RandomState(4)))
    carries = [fa.block_attention_plain(qf.detach(), k.detach(), v.detach(), live),
               (torch.zeros_like(o_b), torch.zeros_like(l_b), torch.full_like(m_b, fa.NEG))]
    for carry in carries:
        merged = fa.merge_blocks(carry, (o_b, l_b, m_b))
        for got, want in zip(merged, carry):
            assert torch.equal(got, want)
    (o_b.sum() + l_b.sum()).backward()
    for x in (qf, k, v):
        assert torch.equal(x.grad, torch.zeros_like(x))


@pytest.mark.parametrize("seq_len,sp", [(16, 2), (64, 4), (24, 3)])
def test_zigzag_order_matches_jax(seq_len, sp):
    order, inv = ra.zigzag_order(seq_len, sp), ra.zigzag_inverse(seq_len, sp)
    np.testing.assert_array_equal(order, np.asarray(jra.zigzag_order(seq_len, sp)))
    np.testing.assert_array_equal(inv, np.asarray(jra.zigzag_inverse(seq_len, sp)))
    np.testing.assert_array_equal(order[inv], np.arange(seq_len))
    with pytest.raises(ValueError):
        ra.zigzag_order(seq_len + 1, sp)


def test_wrappers_refuse_other_devices():
    x = torch.zeros((1, 4, 2, 8), device="meta")
    mask = torch.ones((1, 4, 4), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fa.block_attention(x, x, x, mask)
    m = torch.zeros((1, 2, 4), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fa.flash_attention_bwd(x, x, x, mask, m, m, torch.zeros((1, 2, 4, 8), device="meta"))


# ---------------------------------------------------------------------------
# Ring attention, port against JAX
# ---------------------------------------------------------------------------


def shard(x: np.ndarray) -> torch.Tensor:
    """Global ``(B, T, ...)`` to the stacked ``(DP * SP, B / DP, T / SP,
    ...)`` shards of ``P("dp", "sp")``."""
    B, T = x.shape[:2]
    s = x.reshape(DP, B // DP, SP, T // SP, *x.shape[2:]).swapaxes(1, 2)
    return torch.from_numpy(np.ascontiguousarray(s.reshape(DP * SP, B // DP, T // SP, *x.shape[2:])))


def unshard(t: torch.Tensor) -> np.ndarray:
    x = t.detach().numpy()
    R, b, t_local = x.shape[:3]
    g = x.reshape(DP, SP, b, t_local, *x.shape[3:]).swapaxes(1, 2)
    return g.reshape(DP * b, SP * t_local, *x.shape[3:])


def jax_ring(q, k, v, layout, causal, kv_groups, use_pallas, kv_mask=None):
    """``(y, (dq, dk, dv))`` of JAX's ring under shard_map, the gradients of
    ``sum(sin(y))``."""
    mesh = Mesh(np.array(jax.devices()[:DP * SP]).reshape(DP, SP), ("dp", "sp"))
    spec = P("dp", "sp")

    def ring(qq, kk, vv, mm):
        return jra.ring_attention(qq, kk, vv, axis_name="sp", causal=causal, kv_mask=mm,
                                  layout=layout, kv_groups=kv_groups,
                                  use_pallas=use_pallas, interpret=use_pallas)

    mm = jnp.ones(q.shape[:2], bool) if kv_mask is None else jnp.asarray(kv_mask)
    fwd = jax.shard_map(ring, mesh=mesh, in_specs=(spec,) * 4, out_specs=spec, check_vma=False)
    loss = lambda q_, k_, v_: jnp.sum(jnp.sin(fwd(q_, k_, v_, mm)))  # noqa: E731
    args = tuple(map(jnp.asarray, (q, k, v)))
    y = jax.jit(fwd)(*args, mm)
    return np.asarray(y), [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)]


def port_ring(q, k, v, layout, causal, kv_groups, kv_mask=None):
    group = BaguaProcessGroup([torch.device("cpu")] * (DP * SP), intra_size=SP)
    qs, ks, vs = (shard(x).requires_grad_() for x in (q, k, v))
    y = ra.ring_attention(qs, ks, vs, group, "intra", causal=causal,
                          kv_mask=None if kv_mask is None else shard(kv_mask),
                          layout=layout, kv_groups=kv_groups)
    torch.sin(y).sum().backward()
    return unshard(y), [unshard(x.grad) for x in (qs, ks, vs)]


def ring_inputs(seed, h, h_kv, B=2, T=32, d=8):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, h, d).astype(np.float32)
    k = rng.randn(B, T, h_kv, d).astype(np.float32)
    v = rng.randn(B, T, h_kv, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_ring_attention_matches_jax(layout, use_pallas, monkeypatch):
    """Causal GQA ring, forward and the gradients of sum(sin(y)), against
    JAX's jnp path (exact VJP through the max shift) and its fused Pallas
    path (stop-gradient m, ``BAGUA_PALLAS_FLASH_BWD=1``)."""
    monkeypatch.setenv("BAGUA_PALLAS_FLASH_BWD", "1")
    q, k, v = ring_inputs(5, h=4, h_kv=2)
    y, grads = port_ring(q, k, v, layout, True, 2)
    y_j, grads_j = jax_ring(q, k, v, layout, True, 2, use_pallas)
    np.testing.assert_allclose(y, y_j, rtol=BLOCK_TOL, atol=BLOCK_TOL)
    for name, g, w in zip(("dq", "dk", "dv"), grads, grads_j):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)


def test_ring_attention_kv_mask_matches_jax():
    """Non-causal contiguous ring with a key-padding mask that rotates with
    its block (BERT's use), against JAX's jnp path."""
    q, k, v = ring_inputs(6, h=2, h_kv=2)
    kv_mask = np.random.RandomState(7).rand(2, 32) < 0.7
    kv_mask[:, 0] = True
    y, grads = port_ring(q, k, v, "contiguous", False, 1, kv_mask)
    y_j, grads_j = jax_ring(q, k, v, "contiguous", False, 1, False, kv_mask)
    np.testing.assert_allclose(y, y_j, rtol=BLOCK_TOL, atol=BLOCK_TOL)
    for g, w in zip(grads, grads_j):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_single_rank_ring_matches_local_oracle(causal):
    """``sp == 1`` (no group): one block call, normalized, equals the plain
    quadratic attention of the JAX package's oracle."""
    q, k, v = ring_inputs(8, h=2, h_kv=2, T=24)
    got = ra.ring_attention(*(torch.from_numpy(x)[None] for x in (q, k, v)), causal=causal)
    want = jra._block_attention_local(*map(jnp.asarray, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=BLOCK_TOL, atol=BLOCK_TOL)
    np.testing.assert_allclose(
        ra._block_attention_local(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal).numpy(),
        np.asarray(want), rtol=BLOCK_TOL, atol=BLOCK_TOL)
