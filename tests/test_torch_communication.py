"""The port's collectives and user API against the JAX package's, on the
8-rank CPU group (``intra_size=4``), replaying ``tests/test_communication.py``.

The same numpy-seeded stacks go through the JAX package's eager
collectives (or its in-step ones under ``shard_map`` for an axis) and the
port's.  Tolerance: none.  Every result is bitwise the JAX package's,
floats included: both fold the ranks left to right in rank order (XLA:CPU's
``psum``, ``pmax`` and ``pmin`` too), and the data movement copies.  The
numpy oracles of the JAX tests hold within their own rtol 1e-5, and the
hierarchical composition matches the flat allreduce within rtol 1e-6 (its
two phases sum in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import bagua_tpu
from bagua_tpu import communication as C

import bagua_tpu_torch
from bagua_tpu_torch import ReduceOp
from bagua_tpu_torch.communication import alltoall_v_inplace, hierarchical_allreduce
from bagua_tpu_torch.examples import communication_primitives
from bagua_tpu_torch.functional import all_reduce, all_reduce_inplace

N = 8
BITWISE = (ReduceOp.BOR, ReduceOp.BAND, ReduceOp.BXOR)


@pytest.fixture()
def tgroup():
    return bagua_tpu_torch.init_process_group([torch.device("cpu")] * N, intra_size=4)


def stacked_input(n=N, numel=16, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return rng.uniform(-1, 1, size=(n, numel)).astype(dtype)


def inputs(op, seed):
    """The JAX tests' stacks: floats in [-1, 1), or their x100 integers."""
    x = stacked_input(seed=seed)
    return [(x * 100).astype(np.int32)] if op in BITWISE else [x, (x * 100).astype(np.int32)]


def check(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def jax_in_step(group, fn, x):
    """``fn`` of each rank's slice under the JAX group's ``shard_map``."""
    f = jax.jit(group.shard_map(lambda v: fn(v[0])[None], in_specs=P(C.ALL_AXES), out_specs=P(C.ALL_AXES)))
    return np.asarray(f(jnp.asarray(x)))


@pytest.mark.parametrize("op", list(ReduceOp), ids=lambda op: op.name)
@pytest.mark.parametrize("axis", [None, "inter", "intra"])
def test_allreduce_every_op(group, tgroup, op, axis):
    for x in inputs(op, seed=1):
        got = bagua_tpu_torch.allreduce(torch.from_numpy(x), op, tgroup, axis)
        if axis is None:
            want = bagua_tpu.allreduce(jnp.asarray(x), op=op)
        else:
            want = jax_in_step(group, lambda v: C.allreduce_inplace(v, op=op, axis=axis), x)
        check(got.numpy(), want)


@pytest.mark.parametrize("op", list(ReduceOp), ids=lambda op: op.name)
def test_hierarchical_every_op(group, tgroup, op):
    for x in inputs(op, seed=3):
        got = hierarchical_allreduce(torch.from_numpy(x), op, tgroup)
        want = jax_in_step(group, lambda v: C.hierarchical_allreduce_inplace(v, op=op), x)
        check(got.numpy(), want)
    if op not in BITWISE:
        # the two phases compose: the flat allreduce to rounding
        flat = bagua_tpu_torch.allreduce(torch.from_numpy(x), op, tgroup)
        np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=1e-6)


def test_allreduce_oracles(tgroup):
    """``tests/test_communication.py``'s numpy oracles: MIN, MAX and PRODUCT
    as numpy computes them, the bitwise ops as numpy's reduces."""
    x = stacked_input(seed=1)
    for op, red in [(ReduceOp.MIN, np.min), (ReduceOp.MAX, np.max), (ReduceOp.PRODUCT, np.prod)]:
        out = bagua_tpu_torch.allreduce(torch.from_numpy(x), op).numpy()
        np.testing.assert_allclose(out, np.tile(red(x, axis=0, keepdims=True), (N, 1)), rtol=1e-5)
    xi = (stacked_input(seed=2) * 100).astype(np.int32)
    for op, red in [(ReduceOp.BOR, np.bitwise_or.reduce), (ReduceOp.BAND, np.bitwise_and.reduce),
                    (ReduceOp.BXOR, np.bitwise_xor.reduce)]:
        out = bagua_tpu_torch.allreduce(torch.from_numpy(xi), op).numpy()
        np.testing.assert_array_equal(out, np.tile(red(xi, axis=0)[None], (N, 1)))
    with pytest.raises(RuntimeError):
        bagua_tpu_torch.allreduce(torch.from_numpy(x), ReduceOp.BOR)  # floats have no bits to or


def test_reducescatter(group, tgroup):
    x = stacked_input()
    got = bagua_tpu_torch.reducescatter(torch.from_numpy(x), ReduceOp.SUM)
    check(got.numpy(), bagua_tpu.reducescatter(jnp.asarray(x), op=ReduceOp.SUM))
    np.testing.assert_allclose(got.numpy(), x.sum(0).reshape(N, 2), rtol=1e-5)
    with pytest.raises(NotImplementedError, match="SUM and AVG"):
        bagua_tpu_torch.reducescatter(torch.from_numpy(x), ReduceOp.MAX)


@pytest.mark.parametrize("dtype", [np.float32, np.int32], ids=["f32", "i32"])
def test_broadcast_reduce_scatter_gather(group, tgroup, dtype):
    x = (stacked_input(seed=4) * 100).astype(dtype)
    t = torch.from_numpy(x)
    check(bagua_tpu_torch.broadcast(t, src=3).numpy(), bagua_tpu.broadcast(jnp.asarray(x), src=3))
    check(bagua_tpu_torch.scatter(t, src=1).numpy(), bagua_tpu.scatter(jnp.asarray(x), src=1))
    got = bagua_tpu_torch.gather(t, dst=5).numpy()
    check(got, bagua_tpu.gather(jnp.asarray(x), dst=5))
    np.testing.assert_array_equal(got[5], x.reshape(-1))
    assert not np.any(np.delete(got, 5, axis=0))  # the other ranks get zeros
    for op in (ReduceOp.SUM, ReduceOp.MAX, ReduceOp.MIN, ReduceOp.PRODUCT):
        got = bagua_tpu_torch.reduce(t, dst=2, op=op).numpy()
        check(got, bagua_tpu.reduce(jnp.asarray(x), dst=2, op=op))
        np.testing.assert_array_equal(np.delete(got, 2, axis=0), np.delete(x, 2, axis=0))
    with pytest.raises(ValueError, match="does not divide"):
        bagua_tpu_torch.scatter(torch.zeros(N, 5))


def test_allgather_alltoall(group, tgroup):
    x = stacked_input()
    check(bagua_tpu_torch.allgather(torch.from_numpy(x)).numpy(), bagua_tpu.allgather(jnp.asarray(x)))
    check(bagua_tpu_torch.alltoall(torch.from_numpy(x)).numpy(), bagua_tpu.alltoall(jnp.asarray(x)))


def test_barrier_new_group_and_the_rest(group, tgroup):
    bagua_tpu.barrier()
    assert bagua_tpu_torch.barrier() is None
    assert bagua_tpu_torch.is_initialized() and bagua_tpu.is_initialized()
    assert bagua_tpu_torch.local_ranks() == bagua_tpu.local_ranks(group) == list(range(N))
    obj = {"step": 3, "ranks": [1, 2]}
    assert bagua_tpu_torch.broadcast_object(obj, src=2) is obj and bagua_tpu.broadcast_object(obj, src=2) is obj
    sub, jsub = bagua_tpu_torch.new_group(ranks=[0, 1, 2, 3], intra_size=2), \
        bagua_tpu.new_group(ranks=[0, 1, 2, 3], intra_size=2)
    assert (sub.size, sub.inter_size, sub.intra_size) == (jsub.size, jsub.inter_size, jsub.intra_size)
    x = stacked_input(n=4, seed=5)
    got = bagua_tpu_torch.allreduce(torch.from_numpy(x), ReduceOp.SUM, comm=sub)
    check(got.numpy(), bagua_tpu.allreduce(jnp.asarray(x), op=ReduceOp.SUM, comm=jsub))
    np.testing.assert_allclose(got.numpy(), np.tile(x.sum(0, keepdims=True), (4, 1)), rtol=1e-5)
    assert bagua_tpu_torch.new_group().size == N


@pytest.mark.parametrize("axis", [None, "inter", "intra"])
def test_alltoall_v_inplace(group, tgroup, axis):
    """Counts that differ by rank and by destination, against the JAX
    package's ``alltoall_v_inplace`` under ``shard_map``."""
    n = {None: N, "inter": 2, "intra": 4}[axis]
    cap = 4
    rng = np.random.RandomState(1)
    data = rng.randn(N, n, cap, 2).astype(np.float32)
    counts = rng.randint(0, cap + 1, (N, n)).astype(np.int32)
    recv, rc = alltoall_v_inplace(torch.from_numpy(data), torch.from_numpy(counts), tgroup, axis)

    def local(x, c):
        r, k = C.alltoall_v_inplace(x[0], c[0], axis=axis)
        return r[None], k[None]

    f = jax.jit(group.shard_map(local, in_specs=(P(C.ALL_AXES), P(C.ALL_AXES)),
                                out_specs=(P(C.ALL_AXES), P(C.ALL_AXES))))
    jrecv, jrc = f(jnp.asarray(data), jnp.asarray(counts))
    check(recv.numpy(), jrecv)
    check(rc.numpy(), jrc)
    member = bagua_tpu_torch.communication.rank_id(tgroup, axis)
    peers = {r: [s for s in range(N) if (s // 4 == r // 4 if axis == "intra" else
                                         s % 4 == r % 4 if axis == "inter" else True)] for r in range(N)}
    for r in range(N):
        for j, s in enumerate(peers[r]):
            np.testing.assert_array_equal(recv[r, j].numpy(), data[s, member[r]])
            assert rc[r, j] == counts[s, member[r]]
    with pytest.raises(ValueError, match="send_counts"):
        alltoall_v_inplace(torch.from_numpy(data), torch.from_numpy(counts[:, :1]), tgroup, axis)


@pytest.mark.parametrize("op", [ReduceOp.AVG, ReduceOp.SUM], ids=lambda op: op.name)
def test_functional_all_reduce_gradient_matches_jax(group, tgroup, op):
    from bagua_tpu.functional import all_reduce as jax_all_reduce

    x = np.random.RandomState(0).randn(N, 4).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jax_all_reduce(v, op=op, group=group) ** 2))(jnp.asarray(x))
    leaf = torch.from_numpy(x).requires_grad_()
    (all_reduce(leaf, op, tgroup) ** 2).sum().backward()
    check(leaf.grad.numpy(), want)
    mean = x.mean(0) if op == ReduceOp.AVG else x.sum(0) * N
    np.testing.assert_allclose(leaf.grad.numpy(), np.tile(2 * mean[None], (N, 1)), rtol=1e-4, atol=1e-6)


def test_functional_backward_is_the_same_reduction(tgroup):
    """The reference's symmetric backward: the cotangents reduced with the
    forward's op, over the forward's axis."""
    x = torch.from_numpy(np.random.RandomState(2).randn(N, 5).astype(np.float32))
    ct = torch.from_numpy(np.random.RandomState(3).randn(N, 5).astype(np.float32))
    for op in (ReduceOp.MAX, ReduceOp.MIN, ReduceOp.SUM):
        for axis in (None, "inter", "intra"):
            leaf = x.clone().requires_grad_()
            out = all_reduce_inplace(leaf, op, axis, tgroup)
            assert torch.equal(out, bagua_tpu_torch.allreduce(x, op, tgroup, axis))
            out.backward(ct)
            assert torch.equal(leaf.grad, bagua_tpu_torch.allreduce(ct, op, tgroup, axis))


def test_communication_primitives_twin_prints_the_jax_example_lines(capsys):
    communication_primitives.main(["--device", "cpu", "--ranks", str(N)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"group: BaguaProcessGroup(size={N}") and lines[-1] == "barrier OK"
    assert lines[1:-1] == [
        "allreduce SUM : [224. 232. 240. 248.]", "allreduce AVG : [28. 29. 30. 31.]",
        f"allgather     : ({N}, {8 * N})", f"reducescatter : ({N}, 1)", "broadcast     : [0. 1. 2. 3.]",
        f"alltoall      : ({N}, 8)", "reduce(dst=0) : [28. 29. 30. 31.]", f"scatter(src=0): ({N}, 1)",
        f"gather(dst=0) : ({N}, {8 * N})",
    ]
