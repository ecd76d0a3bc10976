"""The port's collective-matmul rings and tile product against the JAX
package, on CPU groups.

The port's ring runs over one axis of a ``[cpu] * n`` group; JAX's runs
under ``shard_map`` on an ``("tp",)`` mesh of n of the conftest's 8 CPU
devices.  Each rank holds its own weight shard (stacked in the port, a
``P("tp")`` stack in JAX).  Tolerances, each with its reason:

* integer-valued operands (entries in [-4, 4]): **bitwise** -- every
  partial product and serial sum is exact in f32, so a block misrouted,
  dropped or counted twice, or a wrong per-rank reorder, shows;
* random normal operands: within 1e-5 (rtol and atol) of JAX, the JAX
  package's own bound for these rings (``tests/test_collective_matmul.py``):
  the two frameworks' dots sum in other orders;
* the port's plain tile product against JAX's Pallas kernel in interpret
  mode: within 1e-6, not bitwise (some hosts' CPU dot, e.g. with AMX,
  differs from the interpreted tile in the last bits);
* gradients through the rings: within 1e-5 of ``jax.grad``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from bagua_tpu.kernels import collective_matmul as jcm

from bagua_tpu_torch.communication import BaguaProcessGroup, allgather, allreduce
from bagua_tpu_torch.defs import ReduceOp
from bagua_tpu_torch.kernels import collective_matmul as cm

RTOL = ATOL = 1e-5


def ring_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("tp",))


def tgroup(n):
    return BaguaProcessGroup([torch.device("cpu")] * n)


@functools.lru_cache(maxsize=None)
def jax_ring(kind, n, ring):
    """JAX's ring under shard_map, per-rank weights, per-rank outputs."""
    fn, x_spec = (jcm.ag_matmul, P("tp", None)) if kind == "ag" else (jcm.matmul_rs, P(None, "tp"))
    return jax.jit(jax.shard_map(
        lambda a, b: fn(a, b[0], "tp", ring=ring)[None], mesh=ring_mesh(n),
        in_specs=(x_spec, P("tp")), out_specs=P("tp"), check_vma=False))


def operands(kind, n, seed, integer):
    """Global x and per-rank w, as numpy: ag (n*6, 16) and (n, 16, 12); rs
    (n*4, n*5) and (n, 5, 12)."""
    rng = np.random.RandomState(seed)
    draw = (lambda *s: rng.randint(-4, 5, size=s)) if integer else rng.randn
    if kind == "ag":
        x, w = draw(n * 6, 16), draw(n, 16, 12)
    else:
        x, w = draw(n * 4, n * 5), draw(n, 5, 12)
    return x.astype(np.float32), w.astype(np.float32)


def port_ring(kind, n, ring, x, w, group=None, axis="intra"):
    """The port's ring on the stacked shards of global x: ag's rows or rs's
    columns, one block per member."""
    group = group or tgroup(n)
    xt = torch.from_numpy(x)
    if kind == "ag":
        shards = xt.reshape(n, -1, x.shape[1])
        return cm.ag_matmul(shards, torch.from_numpy(w), group, axis, ring=ring)
    shards = xt.reshape(x.shape[0], n, -1).transpose(0, 1).contiguous()
    return cm.matmul_rs(shards, torch.from_numpy(w), group, axis, ring=ring)


@pytest.mark.parametrize("ring", ["uni", "bidir"])
@pytest.mark.parametrize("kind", ["ag", "rs"])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_ring_matches_jax(kind, n, ring):
    """Bitwise on integer operands, within 1e-5 on random ones; the outputs
    have JAX's per-rank shapes and row order."""
    for integer in (True, False):
        x, w = operands(kind, n, 10 * n + (kind == "rs"), integer)
        want = np.asarray(jax_ring(kind, n, ring)(jnp.asarray(x), jnp.asarray(w)))
        got = port_ring(kind, n, ring, x, w).numpy()
        assert got.shape == want.shape
        if integer:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_rings_match_the_plain_collectives(n):
    """``ag_matmul`` bidir is bitwise uni (the same block products);
    ``matmul_rs`` bidir equals uni to f32 rounding; both equal ``allgather
    + matmul`` and ``allreduce(SUM) + slice``."""
    group = tgroup(n)
    x, w = operands("ag", n, 3, False)
    uni, bidir = (port_ring("ag", n, r, x, w, group) for r in ("uni", "bidir"))
    assert torch.equal(uni, bidir)
    gathered = allgather(torch.from_numpy(x).reshape(n, -1, x.shape[1]), group)
    torch.testing.assert_close(uni, gathered @ torch.from_numpy(w), rtol=RTOL, atol=ATOL)

    x, w = operands("rs", n, 4, False)
    uni, bidir = (port_ring("rs", n, r, x, w, group) for r in ("uni", "bidir"))
    torch.testing.assert_close(bidir, uni, rtol=RTOL, atol=ATOL)
    shards = torch.from_numpy(x).reshape(x.shape[0], n, -1).transpose(0, 1)
    full = allreduce(shards @ torch.from_numpy(w), ReduceOp.SUM, group)
    mine = full.reshape(n, n, -1, w.shape[-1])[torch.arange(n), torch.arange(n)]
    torch.testing.assert_close(uni, mine, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["ag", "rs"])
@pytest.mark.parametrize("axis", ["intra", "inter"])
def test_ring_within_each_collective_of_an_axis(kind, axis):
    """An 8-rank group (intra 4): the ring runs within each collective of
    ``axis`` (2 of 4 members on ``intra``, 4 of 2 on ``inter``), each
    collective equal bitwise to JAX's ring over its members' shards."""
    group = BaguaProcessGroup([torch.device("cpu")] * 8, intra_size=4)
    n = 4 if axis == "intra" else 2
    members = [[g * 4 + i for i in range(4)] for g in range(2)] if axis == "intra" \
        else [[g, g + 4] for g in range(4)]
    per = [operands(kind, n, 20 + c, True) for c in range(len(members))]
    xs, ws = [None] * 8, [None] * 8
    for (x, w), ranks in zip(per, members):
        split = np.split(x, n, axis=0 if kind == "ag" else 1)
        for i, r in enumerate(ranks):
            xs[r], ws[r] = split[i], w[i]
    fn = cm.ag_matmul if kind == "ag" else cm.matmul_rs
    got = fn(torch.from_numpy(np.stack(xs)), torch.from_numpy(np.stack(ws)), group, axis).numpy()
    for (x, w), ranks in zip(per, members):
        want = np.asarray(jax_ring(kind, n, "uni")(jnp.asarray(x), jnp.asarray(w)))
        np.testing.assert_array_equal(got[ranks], want)


@pytest.mark.parametrize("ring", ["uni", "bidir"])
@pytest.mark.parametrize("kind", ["ag", "rs"])
def test_ring_gradients_match_jax(kind, ring):
    """``sum(ring(x, w) ** 2)``: the port's autograd through the ring (the
    tile product's gradient, the shifts' and the reorder's) against
    ``jax.grad`` of the JAX composition, on every rank's x and w."""
    n = 4
    x, w = operands(kind, n, 30, False)
    spec = P("tp", None) if kind == "ag" else P(None, "tp")
    fn = jcm.ag_matmul if kind == "ag" else jcm.matmul_rs
    want = jax.jit(jax.shard_map(
        jax.grad(lambda a, b: jnp.sum(fn(a, b[0], "tp", ring=ring) ** 2), argnums=(0, 1)),
        mesh=ring_mesh(n), in_specs=(spec, P("tp")), out_specs=(spec, P("tp")),
        check_vma=False))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x)
    shards = (xt.reshape(n, -1, x.shape[1]) if kind == "ag"
              else xt.reshape(x.shape[0], n, -1).transpose(0, 1).contiguous()).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    port_fn = cm.ag_matmul if kind == "ag" else cm.matmul_rs
    (port_fn(shards, wt, tgroup(n), "intra", ring=ring) ** 2).sum().backward()
    dx = shards.grad.reshape(x.shape) if kind == "ag" else shards.grad.transpose(0, 1).reshape(x.shape)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want[0]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want[1]), rtol=RTOL, atol=ATOL)


def test_ring_errors():
    x, w = torch.zeros(2, 4, 4), torch.zeros(2, 4, 4)
    for fn in (cm.ag_matmul, cm.matmul_rs):
        with pytest.raises(ValueError, match="ring must be"):
            fn(x, w, tgroup(2), "intra", ring="spiral")
        with pytest.raises(ValueError, match="single mesh axis"):
            fn(x, w, BaguaProcessGroup([torch.device("cpu")] * 2), ("inter", "intra"))
        with pytest.raises(ValueError, match="single mesh axis"):
            fn(x, w, BaguaProcessGroup([torch.device("cpu")] * 2), None)
    with pytest.raises(ValueError, match="divide by the ring size"):
        cm.matmul_rs(torch.zeros(4, 13, 8), torch.zeros(4, 8, 6), tgroup(4), "intra")


def test_single_rank_ring_is_the_dot():
    """An axis of size 1: both rings are the one local product."""
    group = BaguaProcessGroup([torch.device("cpu")] * 2, intra_size=1)
    rng = np.random.RandomState(7)
    x, w = (torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in ((2, 6, 8), (2, 8, 4)))
    for fn in (cm.ag_matmul, cm.matmul_rs):
        assert torch.equal(fn(x, w, group, "intra"), x @ w)


@pytest.mark.parametrize("shape", [(16, 32, 48), (9, 7, 10), (1, 1, 1)])
def test_tile_product_matches_pallas_interpret(shape):
    """The plain tile product (what the CPU runs) against JAX's Pallas tile
    kernel in interpret mode at its edge shapes, 2-D and rank-stacked."""
    m, k, n = shape
    rng = np.random.RandomState(3)
    x, w = rng.randn(3, m, k).astype(np.float32), rng.randn(3, k, n).astype(np.float32)
    for r in range(3):
        want = np.asarray(jcm.matmul_tile_pallas(jnp.asarray(x[r]), jnp.asarray(w[r]),
                                                 interpret=True, tile_m=4, tile_n=4))
        got = cm.matmul_tile(torch.from_numpy(x[r]), torch.from_numpy(w[r]))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        stacked = cm.matmul_tile(torch.from_numpy(x), torch.from_numpy(w))[r]
        np.testing.assert_allclose(stacked.numpy(), want, rtol=1e-6, atol=1e-6)
    # other types compute on the CPU, as jnp.dot does
    xb = torch.from_numpy(x).bfloat16()
    assert cm.matmul_tile(xb, xb.transpose(1, 2)).dtype == torch.bfloat16


def test_tile_gradient_launches_only_what_is_needed(monkeypatch):
    """``TileMatmulFn``'s gradients equal autograd of ``x @ w`` and go
    through the tile product on transposed views; only the products that
    ``needs_input_grad`` asks for are computed."""
    calls = []
    real = cm.matmul_tile

    def recording(x, w):
        calls.append((tuple(x.shape), x.is_contiguous(), tuple(w.shape), w.is_contiguous()))
        return real(x, w)

    monkeypatch.setattr(cm, "matmul_tile", recording)
    rng = np.random.RandomState(4)
    x0, w0 = rng.randn(2, 10, 7).astype(np.float32), rng.randn(2, 7, 12).astype(np.float32)
    for need_x, need_w in ((True, True), (False, True), (True, False)):
        calls.clear()
        x = torch.from_numpy(x0).requires_grad_(need_x)
        w = torch.from_numpy(w0).requires_grad_(need_w)
        torch.sin(cm.tile_matmul(x, w)).sum().backward()
        assert len(calls) == 1 + need_x + need_w
        xr = torch.from_numpy(x0).requires_grad_(need_x)
        wr = torch.from_numpy(w0).requires_grad_(need_w)
        torch.sin(xr @ wr).sum().backward()
        if need_x:
            torch.testing.assert_close(x.grad, xr.grad, rtol=1e-6, atol=1e-6)
            assert ((2, 10, 12), True, (2, 12, 7), False) in calls  # g @ w^T, a view
        if need_w:
            torch.testing.assert_close(w.grad, wr.grad, rtol=1e-6, atol=1e-6)
            assert ((2, 7, 10), False, (2, 10, 12), True) in calls  # x^T @ g
