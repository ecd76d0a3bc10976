"""Worker processes for the port's gang tests (``tests/test_torch_dist_*.py``).

Run as ``python tests/torch_dist_workers.py <job> <process> <port> <out>
[args...]``: the worker joins a gloo gang at
``127.0.0.1:<port>`` as process ``<process>`` and writes its results to
``<out>.proc<process>.json`` (or ``.npz``).  Every input comes from numpy
seeds, the same in every process; each process holds its rows of the
stack.  Imports the port only.
"""

import json
import os
import sys
import time

import numpy as np
import torch

torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bagua_tpu_torch.communication as C  # noqa: E402
from bagua_tpu_torch.defs import ReduceOp  # noqa: E402
from bagua_tpu_torch.mesh import MeshSpec  # noqa: E402
from bagua_tpu_torch.utils import tree_flatten_with_names  # noqa: E402

CPU = torch.device("cpu")

#: layout -> (processes, ranks a process, intra_size or a MeshSpec's sizes)
LAYOUTS = {
    "W4k2-intra4": (4, 2, 4),
    "W2k4-intra4": (2, 4, 4),
    "W4k1-dp2tp2": (4, 1, {"dp": 2, "tp": 2}),
}

BITWISE_OPS = (ReduceOp.BOR, ReduceOp.BAND, ReduceOp.BXOR)


def join(layout: str, p: int, port: str):
    """``(gang group, the stacked group of the same ranks)``."""
    W, k, shape = LAYOUTS[layout]
    address = f"127.0.0.1:{port}"
    if isinstance(shape, dict):
        group = C.init_process_group([CPU] * k, mesh_spec=MeshSpec(shape), coordinator_address=address,
                                     num_processes=W, process_id=p)
        return group, C.BaguaProcessGroup([CPU] * (W * k), mesh_spec=MeshSpec(shape))
    group = C.init_process_group([CPU] * k, intra_size=shape, coordinator_address=address,
                                 num_processes=W, process_id=p)
    return group, C.BaguaProcessGroup([CPU] * (W * k), intra_size=shape)


def _axes(group):
    """Every axis choice a collective takes: None, each axis, all of them
    out of mesh order."""
    return [None] + [(a,) for a in group.all_axes] + [tuple(reversed(group.all_axes))]


def _stack(n, *shape, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    if np.issubdtype(dtype, np.integer):
        return torch.from_numpy(rng.randint(0, 1 << 20, size=(n, *shape)).astype(dtype))
    return torch.from_numpy(rng.randn(n, *shape).astype(dtype))


def _case_pairs(name, g, ref):
    """``[(what, got, want)]`` of one case: ``got`` this process's result,
    ``want`` the stacked group's for every rank (or an exception of each)."""
    n_all, rows = ref.size, list(g.local_rows)
    x = _stack(n_all, 8, 3)
    out = []

    def both(what, fn_got, fn_want):
        try:
            got = fn_got()
        except Exception as e:  # the stacked group must raise the same
            got = e
        try:
            want = fn_want()
        except Exception as e:
            want = e
        out.append((what, got, want))

    if name == "rank_id":
        for ax in _axes(g):
            both(ax, lambda: C.rank_id(g, ax), lambda: C.rank_id(ref, ax))
    elif name == "grouped_views":
        def refused():
            raise ValueError("a spanning group has no whole stack to view")
        both("_grouped", lambda: C._grouped(x[rows], g, None), refused)
        both("_ungrouped", lambda: C._ungrouped(x[rows].unsqueeze(1), g, None), refused)
    elif name == "local_ranks":
        both(None, lambda: torch.tensor(C.local_ranks(g)),
             lambda: torch.arange(n_all)[g.process_index * g.local_size:(g.process_index + 1) * g.local_size])
    elif name == "ppermute_shift":
        for ax in _axes(g):
            for s in (1, -1, 3):
                both((ax, s), lambda: C.ppermute_shift(x[rows], s, g, ax), lambda: C.ppermute_shift(x, s, ref, ax))
    elif name == "ppermute_apply":
        for ax in _axes(g):
            n = C.axis_size(ref, ax)
            for perm in ([(0, n - 1)], [(i, (i + 1) % n) for i in range(n)], [(n - 1, 0), (0, n // 2)]):
                if n > 1:
                    both((ax, perm), lambda: C.ppermute_apply(x[rows], perm, g, ax),
                         lambda: C.ppermute_apply(x, perm, ref, ax))
    elif name == "broadcast_inplace":
        xz = x.clone()
        xz[:, 0, 0] = -0.0  # the sign of zero: +0 after the masked sum
        for ax in _axes(g):
            for src in {0, C.axis_size(ref, ax) - 1}:
                both((ax, src), lambda: C.broadcast_inplace(xz[rows], src, g, ax),
                     lambda: C.broadcast_inplace(xz, src, ref, ax))
    elif name.startswith("allreduce["):
        op = ReduceOp[name[len("allreduce["):-1]]
        t = _stack(n_all, 8, 3, seed=1, dtype=np.int32) if op in BITWISE_OPS else x
        for ax in _axes(g):
            both(ax, lambda: C.allreduce(t[rows], op, g, ax), lambda: C.allreduce(t, op, ref, ax))
    elif name == "allreduce_many":
        xi = _stack(n_all, 5, seed=2, dtype=np.int32)
        xb = _stack(n_all, 7, seed=3).to(torch.bfloat16)
        for ax in _axes(g):
            for op in (ReduceOp.SUM, ReduceOp.AVG, ReduceOp.MAX):
                sends = [x, xi, xb] if op != ReduceOp.AVG else [x, xb]
                got = lambda: torch.cat([t.reshape(len(rows), -1).float() for t in  # noqa: E731
                                         C.allreduce_many([s[rows] for s in sends], op, g, ax)], 1)
                want = lambda: torch.cat([t.reshape(n_all, -1).float() for t in  # noqa: E731
                                          C.allreduce_many(sends, op, ref, ax)], 1)
                both((ax, op.name), got, want)
    elif name == "hierarchical_allreduce":
        for op in (ReduceOp.SUM, ReduceOp.AVG, ReduceOp.MIN):
            both(op.name, lambda: C.hierarchical_allreduce(x[rows], op, g),
                 lambda: C.hierarchical_allreduce(x, op, ref))
    elif name == "hierarchical_allreduce_many":
        y = _stack(n_all, 4, 2, seed=4)
        both("AVG", lambda: torch.cat([t.reshape(len(rows), -1) for t in
                                        C.hierarchical_allreduce_many([x[rows], y[rows]], ReduceOp.AVG, g)], 1),
             lambda: torch.cat([t.reshape(n_all, -1) for t in
                                C.hierarchical_allreduce_many([x, y], ReduceOp.AVG, ref)], 1))
    elif name in ("reduce_scatter", "alltoall", "allgather"):
        for ax in _axes(g):
            n = C.axis_size(ref, ax)
            y = _stack(n_all, 3 * n, 2, seed=5)
            if name == "reduce_scatter":
                for op in (ReduceOp.SUM, ReduceOp.AVG):
                    both((ax, op.name), lambda: C.reduce_scatter(y[rows], op, g, ax),
                         lambda: C.reduce_scatter(y, op, ref, ax))
            else:
                fn = getattr(C, name)
                both(ax, lambda: fn(y[rows], g, ax), lambda: fn(y, ref, ax))
    elif name == "alltoall_v_inplace":
        for ax in _axes(g):
            n = C.axis_size(ref, ax)
            y = _stack(n_all, n, 3, 2, seed=6)
            counts = torch.from_numpy(np.random.RandomState(7).randint(0, 4, size=(n_all, n)).astype(np.int64))
            both(ax, lambda: torch.cat([t.reshape(len(rows), -1).float() for t in
                                        C.alltoall_v_inplace(y[rows], counts[rows], g, ax)], 1),
                 lambda: torch.cat([t.reshape(n_all, -1).float() for t in C.alltoall_v_inplace(y, counts, ref, ax)], 1))
    elif name == "reducescatter":
        y = _stack(n_all, 2 * n_all, seed=8)
        for op in (ReduceOp.SUM, ReduceOp.AVG):
            both(op.name, lambda: C.reducescatter(y[rows], op, g), lambda: C.reducescatter(y, op, ref))
    elif name in ("broadcast", "gather"):
        for r in (0, n_all - 1):
            fn = getattr(C, name)
            both(r, lambda: fn(x[rows], r, g), lambda: fn(x, r, ref))
    elif name == "reduce":
        for r, op in ((0, ReduceOp.AVG), (n_all - 1, ReduceOp.MAX)):
            both((r, op.name), lambda: C.reduce(x[rows], r, op, g), lambda: C.reduce(x, r, op, ref))
    elif name == "scatter":
        y = _stack(n_all, 2 * n_all, 3, seed=9)
        for r in (0, n_all - 1):
            both(r, lambda: C.scatter(y[rows], r, g), lambda: C.scatter(y, r, ref))
    elif name == "barrier":
        both(None, lambda: (C.barrier(g), torch.zeros(len(rows)))[1], lambda: torch.zeros(n_all))
    elif name == "broadcast_object":
        for src in range(g.process_count):
            obj = {"from": g.process_index, "payload": list(range(g.process_index + 3))}
            both(src, lambda: C.broadcast_object(obj, src=src),
                 lambda: {"from": src, "payload": list(range(src + 3))})
    else:
        raise ValueError(name)
    return out


COLLECTIVES = (
    ["rank_id", "local_ranks", "grouped_views", "ppermute_shift", "ppermute_apply", "broadcast_inplace"]
    + [f"allreduce[{op.name}]" for op in ReduceOp]
    + ["allreduce_many", "hierarchical_allreduce", "hierarchical_allreduce_many", "reduce_scatter", "alltoall",
       "allgather", "alltoall_v_inplace", "reducescatter", "broadcast", "reduce", "scatter", "gather", "barrier",
       "broadcast_object"]
)


def _same(got, want, rows, n_all) -> str:
    """'' when ``got`` is bitwise the stacked result's rows ``rows`` (or
    both raised the same exception type), else what differs."""
    if isinstance(want, Exception) or isinstance(got, Exception):
        if type(got) is type(want):
            return ""
        return f"got {str(got)[:200]!r}, want {str(want)[:200]!r}"
    if not torch.is_tensor(want):
        return "" if got == want else f"got {str(got)[:200]}, want {str(want)[:200]}"
    if want.dim() and want.shape[0] == n_all and len(rows) != n_all:
        want = want[rows]
    if got.shape != want.shape or got.dtype != want.dtype:
        return f"shape/dtype {tuple(got.shape)} {got.dtype} != {tuple(want.shape)} {want.dtype}"
    gb = got.contiguous().reshape(-1).view(torch.uint8) if got.dtype != torch.bool else got
    wb = want.contiguous().reshape(-1).view(torch.uint8) if want.dtype != torch.bool else want
    return "" if torch.equal(gb, wb) else "values differ"


def _near(got, want, rows, tol) -> str:
    """'' when ``got`` is ``want``'s rows ``rows`` within ``tol`` relative
    and absolute (or both raised the same exception type), else what
    differs."""
    if isinstance(want, Exception) or isinstance(got, Exception):
        return "" if type(got) is type(want) else f"got {str(got)[:200]!r}, want {str(want)[:200]!r}"
    want = want[rows]
    if got.shape != want.shape or got.dtype != want.dtype:
        return f"shape/dtype {tuple(got.shape)} {got.dtype} != {tuple(want.shape)} {want.dtype}"
    return "" if torch.allclose(got, want, rtol=tol, atol=tol) else \
        f"off by up to {float((got - want).abs().max()):.3e} from the plain formula"


def collectives(p: int, port: str, out: str, layout: str) -> None:
    group, ref = join(layout, p, port)
    rows = list(group.local_rows)
    report = {}
    for name in COLLECTIVES:
        bad = []
        try:
            for what, got, want in _case_pairs(name, group, ref):
                why = _same(got, want, rows, ref.size)
                if why:
                    bad.append(f"{what}: {why}")
        except Exception as e:  # a failure to run is the case's result
            bad.append(f"raised {e!r}")
        report[name] = bad
    with open(f"{out}.proc{p}.json", "w") as f:
        json.dump(report, f)
    C.barrier(group)
    C.destroy_process_group()


# ---------------------------------------------------------------------------
# Vector-Jacobian products of the collectives across processes
# ---------------------------------------------------------------------------


def _cotangent(shape, seed):
    """A seeded cotangent with a -0 every seventh element and a +0 every
    eleventh (the sign of a zero is part of the bits compared)."""
    ct = _stack(shape[0], *shape[1:], seed=seed).to(torch.float32)
    flat = ct.view(-1)
    flat[::7] = -0.0
    flat[3::11] = 0.0
    return ct


def _vjp(fn, xs, cts_of):
    """``[grad of each x]`` of ``fn(*xs)`` against ``cts_of(outputs)``."""
    xs = [x.clone().requires_grad_() for x in xs]
    ys = fn(*xs)
    ys = list(ys) if isinstance(ys, (list, tuple)) else [ys]
    torch.autograd.backward(ys, cts_of(ys))
    return torch.cat([x.grad.reshape(x.shape[0], -1).float() for x in xs], 1)


def _plain_members(ref, axis):
    """``(G, n)``: the ranks of each collective over ``axis`` (None: every
    axis), from the mesh's shape alone: ranks that share every other
    axis's coordinate, member index row-major over ``axis`` in the order
    named, ranks row-major over the mesh."""
    names, shape = list(ref.all_axes), list(ref.shape)
    axes = names if axis is None else list(axis)
    collectives = {}
    for r, coords in enumerate(np.ndindex(*shape)):
        key = tuple(c for a, c in zip(names, coords) if a not in axes)
        member = 0
        for a in axes:
            member = member * shape[names.index(a)] + coords[names.index(a)]
        collectives.setdefault(key, {})[member] = r
    return torch.tensor([[m[i] for i in range(len(m))] for _, m in sorted(collectives.items())])


def _plain(kind, x, ref, axis, arg=None):
    """A collective written out on the whole stack with plain tensor ops
    (no code of ``communication.py``): gather each collective's members
    (:func:`_plain_members`), move or reduce them, put the rows back.
    ``kind``: ``shift`` (by ``arg``), ``apply`` (pairs ``arg``),
    ``alltoall``, ``allgather``, ``reduce_scatter`` / ``allreduce`` (``arg``
    SUM or AVG), ``broadcast`` (from member ``arg``)."""
    members = _plain_members(ref, axis)
    G, n = members.shape
    g = x[members]  # (G, n, ...)
    if kind == "shift":
        y = torch.roll(g, arg, dims=1)
    elif kind == "apply":
        source = {d: s for s, d in arg}
        y = torch.stack([g[:, source[d]] if d in source else torch.zeros_like(g[:, 0]) for d in range(n)], 1)
    elif kind == "alltoall":
        y = g.reshape(G, n, n, -1, *g.shape[3:]).transpose(1, 2).reshape(g.shape)
    elif kind == "allgather":
        y = g.reshape(G, 1, -1, *g.shape[3:]).expand(G, n, n * g.shape[2], *g.shape[3:])
    elif kind in ("reduce_scatter", "allreduce"):
        total = g.sum(1) / (n if arg == ReduceOp.AVG else 1)
        y = (total.reshape(G, n, -1, *g.shape[3:]) if kind == "reduce_scatter"
             else total.unsqueeze(1).expand_as(g))
    elif kind == "broadcast":
        y = g[:, arg:arg + 1].expand_as(g)
    else:
        raise ValueError(kind)
    return y.reshape(G * n, *y.shape[2:])[torch.argsort(members.reshape(-1))]


def _vjp_pairs(name, g, ref):
    """``[(what, got, want, tol)]``: this process's gradient rows of a
    collective over every axis choice, and for every rank the stacked
    group's autograd's (``tol`` None: bitwise) and, where the collective
    has a plain formula (:func:`_plain`), autograd's through it (``tol``:
    within ``tol`` relative and absolute; sums in another order), or an
    exception of each."""
    n_all, rows = ref.size, list(g.local_rows)
    out = []

    def both(what, fn_got, fn_want, xs, seed=11, plain=None):
        def want_cts(ys):
            return [_cotangent(y.shape, seed + i).to(y.dtype) for i, y in enumerate(ys)]

        try:
            got = _vjp(fn_got, [x[rows] for x in xs],
                       lambda ys: [_cotangent((n_all, *y.shape[1:]), seed + i).to(y.dtype)[rows]
                                   for i, y in enumerate(ys)])
        except Exception as e:
            got = e
        for fn, tol in ((fn_want, None), (plain, 1e-5)):
            if fn is None:
                continue
            try:
                want = _vjp(fn, xs, want_cts)
            except Exception as e:
                want = e
            out.append((what if tol is None else (what, "plain"), got, want, tol))

    x = _stack(n_all, 8, 3)
    if name == "ppermute_shift":
        for ax in _axes(g):
            for s in (1, -1, 3):
                both((ax, s), lambda t: C.ppermute_shift(t, s, g, ax), lambda t: C.ppermute_shift(t, s, ref, ax), [x],
                     plain=lambda t: _plain("shift", t, ref, ax, s))
    elif name == "ppermute_apply":
        for ax in _axes(g):
            n = C.axis_size(ref, ax)
            for perm in ([(0, n - 1)], [(i, (i + 1) % n) for i in range(n)], [(n - 1, 0), (0, n // 2)]):
                if n > 1:
                    both((ax, perm), lambda t: C.ppermute_apply(t, perm, g, ax),
                         lambda t: C.ppermute_apply(t, perm, ref, ax), [x],
                         plain=lambda t: _plain("apply", t, ref, ax, perm))
    elif name == "broadcast_inplace":
        for ax in _axes(g):
            for src in {0, C.axis_size(ref, ax) - 1}:
                both((ax, src), lambda t: C.broadcast_inplace(t, src, g, ax),
                     lambda t: C.broadcast_inplace(t, src, ref, ax), [x],
                     plain=lambda t: _plain("broadcast", t, ref, ax, src))
    elif name in ("allreduce[SUM]", "allreduce[AVG]"):
        op = ReduceOp[name[len("allreduce["):-1]]
        for ax in _axes(g):
            both(ax, lambda t: C.allreduce(t, op, g, ax), lambda t: C.allreduce(t, op, ref, ax), [x],
                 plain=lambda t: _plain("allreduce", t, ref, ax, op))
    elif name == "allreduce_many":
        xb = _stack(n_all, 7, seed=3).to(torch.bfloat16)
        for ax in _axes(g):
            for op in (ReduceOp.SUM, ReduceOp.AVG):
                both((ax, op.name), lambda a, b: C.allreduce_many([a, b], op, g, ax),
                     lambda a, b: C.allreduce_many([a, b], op, ref, ax), [x, xb])
    elif name == "hierarchical_allreduce":
        for op in (ReduceOp.SUM, ReduceOp.AVG):
            both(op.name, lambda t: C.hierarchical_allreduce(t, op, g),
                 lambda t: C.hierarchical_allreduce(t, op, ref), [x])
    elif name in ("reduce_scatter", "alltoall", "allgather"):
        for ax in _axes(g):
            n = C.axis_size(ref, ax)
            y = _stack(n_all, 3 * n, 2, seed=5)
            if name == "reduce_scatter":
                for op in (ReduceOp.SUM, ReduceOp.AVG):
                    both((ax, op.name), lambda t: C.reduce_scatter(t, op, g, ax),
                         lambda t: C.reduce_scatter(t, op, ref, ax), [y],
                         plain=lambda t: _plain("reduce_scatter", t, ref, ax, op))
            else:
                fn = getattr(C, name)
                both(ax, lambda t: fn(t, g, ax), lambda t: fn(t, ref, ax), [y], plain=lambda t: _plain(name, t, ref, ax))
    elif name == "user_api":
        y = _stack(n_all, 2 * n_all, seed=8)
        for op in (ReduceOp.SUM, ReduceOp.AVG):
            both(("reducescatter", op.name), lambda t: C.reducescatter(t, op, g), lambda t: C.reducescatter(t, op, ref), [y],
                 plain=lambda t: _plain("reduce_scatter", t, ref, None, op))
        for r in (0, n_all - 1):
            both(("broadcast", r), lambda t: C.broadcast(t, r, g), lambda t: C.broadcast(t, r, ref), [x])
            both(("gather", r), lambda t: C.gather(t, r, g), lambda t: C.gather(t, r, ref), [x],
                 plain=lambda t: _plain("allgather", t, ref, None) * (torch.arange(n_all) == r).reshape(-1, 1, 1))
            both(("scatter", r), lambda t: C.scatter(t, r, g), lambda t: C.scatter(t, r, ref), [y],
                 plain=lambda t: t[r].reshape(n_all, -1))
            both(("reduce", r), lambda t: C.reduce(t, r, ReduceOp.AVG, g), lambda t: C.reduce(t, r, ReduceOp.AVG, ref),
                 [x])
    elif name == "collective_matmul":
        from bagua_tpu_torch.kernels.collective_matmul import ag_matmul, matmul_rs

        for ax in g.all_axes:
            n = C.axis_size(ref, ax)
            xa, w = _stack(n_all, 3, 5, seed=13), _stack(n_all, 5, 4, seed=14)
            xr = _stack(n_all, 2 * n, 5, seed=15)
            for ring in ("uni", "bidir"):
                both((ax, "ag", ring), lambda a, b: ag_matmul(a, b, g, ax, ring=ring),
                     lambda a, b: ag_matmul(a, b, ref, ax, ring=ring), [xa, w])
                both((ax, "rs", ring), lambda a, b: matmul_rs(a, b, g, ax, ring=ring),
                     lambda a, b: matmul_rs(a, b, ref, ax, ring=ring), [xr, w])
    elif name == "no_gradient":
        # the stacked group differentiates these; across processes they raise
        def refused(t):
            raise RuntimeError("no gradient across processes")
        for op in (ReduceOp.MAX, ReduceOp.MIN, ReduceOp.PRODUCT, ReduceOp.BOR, ReduceOp.BAND, ReduceOp.BXOR):
            for ax in _axes(g):
                both((ax, op.name), lambda t: C.allreduce(t, op, g, ax), refused, [x])
    else:
        raise ValueError(name)
    return out


VJPS = ["ppermute_shift", "ppermute_apply", "broadcast_inplace", "allreduce[SUM]", "allreduce[AVG]",
        "allreduce_many", "hierarchical_allreduce", "reduce_scatter", "alltoall", "allgather", "user_api",
        "collective_matmul", "no_gradient"]


def vjps(p: int, port: str, out: str, layout: str) -> None:
    group, ref = join(layout, p, port)
    rows = list(group.local_rows)
    report = {}
    for name in VJPS:
        bad = []
        try:
            for what, got, want, tol in _vjp_pairs(name, group, ref):
                why = _same(got, want, rows, ref.size) if tol is None else _near(got, want, rows, tol)
                if why:
                    bad.append(f"{what}: {why}")
        except Exception as e:
            bad.append(f"raised {e!r}")
        report[name] = bad
    # the fault this slice repaired: no gradient path through a collective
    x = torch.ones((group.local_size, 3), requires_grad=True)
    C.allgather(x, group, group.all_axes).sum().backward()
    report["allgather_sum_grad"] = {"grad_is_none": x.grad is None,
                                    "values": [] if x.grad is None else sorted(set(x.grad.reshape(-1).tolist()))}
    with open(f"{out}.proc{p}.json", "w") as f:
        json.dump(report, f)
    C.barrier(group)
    C.destroy_process_group()


# ---------------------------------------------------------------------------
# Model axes across processes: FSDP, MoE over ep, SyncBatchNorm, sub-groups
# (2 processes x 2 ranks, every case against the stacked group in-process)
# ---------------------------------------------------------------------------


def _rows_of(t, n_all, rows):
    """Ranks ``rows``' blocks of a global batch cut into ``n_all``."""
    return t.reshape(n_all, -1, *t.shape[1:])[rows].reshape(-1, *t.shape[1:])


def _tree_rows_bad(what, got, want, rows):
    """The leaves of ``got`` (this process's rows) that differ from
    ``want``'s rows ``rows``."""
    bad = []
    for (name, g), (_, w) in zip(tree_flatten_with_names(got), tree_flatten_with_names(want)):
        why = _same(g.detach(), w.detach()[rows], list(range(len(rows))), len(rows))
        if why:
            bad.append(f"{what} {name}: {why}")
    return bad


def _fsdp_case(group, ref, rows):
    """Three Adam steps of FSDP on the MLP [16, 64, 8]: this process's
    shard rows and its ranks' gathered copies bitwise the stacked run's."""
    from bagua_tpu_torch.models import mlp
    from bagua_tpu_torch.parallel.fsdp import FSDP

    params = mlp.init_mlp(torch.Generator().manual_seed(3), [16, 64, 8], device="cpu")
    rng = np.random.RandomState(2)
    batches = [(torch.from_numpy(rng.randn(32, 16).astype(np.float32)),
                torch.from_numpy(rng.randn(32, 8).astype(np.float32))) for _ in range(3)]

    def run(g, local):
        fsdp = FSDP(torch.func.vmap(mlp.mse_loss), lambda ps: torch.optim.Adam(ps, lr=1e-2), g)
        ps, opt = fsdp.init(params)
        for b in batches:
            (ps, opt), _ = fsdp.train_step(ps, opt, tuple(_rows_of(t, ref.size, local) for t in b))
        return fsdp, ps

    fsdp_g, got = run(group, rows)
    fsdp_r, want = run(ref, list(range(ref.size)))
    bad = _tree_rows_bad("shard", got, want, rows)
    full_g, full_r = fsdp_g.full_params(got, rows[-1]), fsdp_r.full_params(want, rows[-1])
    bad += [f"full {n}: {w}" for (n, g), (_, r) in zip(tree_flatten_with_names(full_g), tree_flatten_with_names(full_r))
            for w in [_same(g, r, [0], 1)] if w]
    return bad


def _engine_rows(group, ref, rows, loss_fn_of, params_of, batches, **kw):
    """The engine (``gradient_allreduce``, SGD 0.005) on ``group`` and on
    ``ref``, the gang feeding its rows of each global batch: the
    parameters' rows that differ."""
    from bagua_tpu_torch.algorithms import GradientAllReduceAlgorithm
    from bagua_tpu_torch.ddp import DistributedDataParallel

    out = {}
    for g in (group, ref):
        ddp = DistributedDataParallel(loss_fn_of(g), lambda ps: torch.optim.SGD(ps, lr=0.005),
                                      GradientAllReduceAlgorithm(), g, **kw)
        try:
            state = ddp.init(params_of(g))
            for b in batches:
                state, _ = ddp.train_step(state, ddp.process_rows(b))
            out[g is group] = state.params
        finally:
            ddp.shutdown()
    return _tree_rows_bad("param", out[True], out[False], rows)


def _moe_case(group, ref, rows):
    """Two engine steps of an MoE block over ``ep`` = every rank (4
    experts, one a rank, kept local by ``dp_filter``): its rank
    all-to-alls run under the engine's ``vmap`` across processes."""
    from bagua_tpu_torch.models._layers import module_params
    from bagua_tpu_torch.parallel.moe import MoE
    from bagua_tpu_torch.utils import dotted_leaves

    models = {}

    def model(g):
        return models.setdefault(id(g), MoE(8, 16, num_experts=4, capacity_factor=2.0, ep_size=4,
                                            ep_axis=("inter", "intra"), group=g, device="cpu",
                                            generator=torch.Generator().manual_seed(0)))

    def loss_fn_of(g):
        moe = model(g)

        def loss_fn(params, batch):
            x, y = batch
            out, l_aux = torch.func.functional_call(moe, dotted_leaves(params), (x,))
            return torch.mean((out - y) ** 2) + 0.01 * l_aux
        return loss_fn

    rng = np.random.RandomState(4)
    batches = [(torch.from_numpy(rng.randn(4 * 16, 8).astype(np.float32)),
                torch.from_numpy(rng.randn(4 * 16, 8).astype(np.float32))) for _ in range(2)]
    return _engine_rows(group, ref, rows, loss_fn_of, lambda g: module_params(model(g)), batches,
                        dp_filter=lambda n: "experts" not in n)


def _sync_bn_case(group, ref, rows):
    """Two engine steps of the small ResNet ([1, 1, 1, 1], 10 classes) with
    ``sync_bn=True``: each norm's statistics collective across processes."""
    from bagua_tpu_torch.models.resnet import ResNet, init_resnet, resnet_loss_fn

    model = ResNet([1, 1, 1, 1], 10, torch.float32, sync_bn=True, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    variables = init_resnet(model)
    rng = np.random.RandomState(5)
    batches = [(torch.from_numpy(rng.randn(4 * 2, 32, 32, 3).astype(np.float32)),
                torch.from_numpy(rng.randint(0, 10, (4 * 2,)).astype(np.int64))) for _ in range(2)]
    return _engine_rows(group, ref, rows, lambda g: resnet_loss_fn(model), lambda g: variables, batches,
                        dp_filter=lambda n: "batch_stats" not in n)


def _new_group_case(group, ref, rows):
    """``new_group`` of some of the gang's ranks: each member process passes
    its own ranks' rows (in the order listed) and gets the stacked
    ``new_group``'s rows, values and gradients; a process holding none gets
    a group whose collectives raise; a list against the rule raises
    ValueError naming it."""
    bad = []
    x = _stack(ref.size, 8, 3, seed=12)
    k = group.local_size
    for ranks, kw in (([1, 0, 3, 2], {}), ([0, 2], {}), ([2, 3], {}),
                      ([0, 1, 2, 3], {"mesh_spec": MeshSpec({"dp": 2, "tp": 2})})):
        sub = C.new_group(ranks, **kw)
        stacked = C.BaguaProcessGroup([CPU] * len(ranks), **({"intra_size": len(ranks)} if not kw else kw))
        xs = x[ranks]
        mine = [i for i, r in enumerate(ranks) if r in rows]
        if not mine:
            try:
                C.allreduce(x[:1], ReduceOp.SUM, sub)
                bad.append(f"{ranks}: a process holding none of the ranks ran a collective")
            except RuntimeError:
                pass
            continue
        for name, fn in (("allreduce", lambda t, g: C.allreduce(t, ReduceOp.AVG, g)),
                         ("allgather", lambda t, g: C.allgather(t, g)),
                         ("ppermute_shift", lambda t, g: C.ppermute_shift(t, 1, g)),
                         ("alltoall", lambda t, g: C.alltoall(t.reshape(t.shape[0], -1)[:, :len(ranks) * 4], g))):
            def vjp(t, g):
                t = t.clone().requires_grad_()
                y = fn(t, g)
                ct = _cotangent((len(ranks), *y.shape[1:]), 21)
                y.backward(ct if y.shape[0] == len(ranks) else ct[mine])
                return torch.cat([y.detach().reshape(y.shape[0], -1), t.grad.reshape(t.shape[0], -1)], 1)
            why = _same(vjp(xs[mine], sub), vjp(xs, stacked), mine, len(ranks))
            if why:
                bad.append(f"{ranks} {kw} {name}: {why}")
    for ranks in ([0, 1, 2], [2, 3, 0, 1], [0, 2, 1, 3], [0, 0, 1, 2]):
        try:
            C.new_group(ranks)
            bad.append(f"{ranks}: accepted against the rule")
        except ValueError as e:
            if "process by process" not in str(e):
                bad.append(f"{ranks}: {e}")
    return bad


def _pipeline_case(group, ref, rows):
    """The three schedules over every rank (4 stages, two a process) on a
    stage of one tanh layer: each process's losses and gradients (the
    stage's, and 1F1B's input and loss-parameter ones) bitwise the stacked
    run's rows."""
    from bagua_tpu_torch.parallel import pipeline as pl

    w = _stack(ref.size, 6, 6, seed=16) * 0.3
    wv = _stack(ref.size, 2, 6, 6, seed=17) * 0.3
    head = _stack(ref.size, 6, 3, seed=18)
    mbs, tgt = _stack(ref.size, 4, 2, 6, seed=19), _stack(ref.size, 4, 2, 3, seed=20)

    def stage(p, x):
        return torch.tanh(torch.bmm(x, p["w"]))

    def loss(y, t):
        return ((y[..., :3] - t) ** 2).mean(dim=(1, 2))

    def head_loss(hp, y, t):
        return ((torch.bmm(y, hp["k"]) - t) ** 2).mean(dim=(1, 2))

    def run(g, sel):
        out = []
        for kind in ("gpipe", "interleaved"):
            leaf = (w if kind == "gpipe" else wv)[sel].clone().requires_grad_()
            fn = pl.pipeline_loss if kind == "gpipe" else pl.pipeline_loss_interleaved
            losses = fn(stage, {"w": leaf}, mbs[sel], tgt[sel], loss, g, None)
            losses.sum().backward()
            out += [losses.detach().reshape(len(sel), -1), leaf.grad.reshape(len(sel), -1)]
        losses, grads = pl.pipeline_train_1f1b(stage, {"w": w[sel]}, mbs[sel], tgt[sel], head_loss, g, None,
                                               loss_params={"k": head[sel]}, with_input_grads=True)
        out += [losses.reshape(len(sel), -1), grads.stage["w"].reshape(len(sel), -1),
                grads.inputs.reshape(len(sel), -1), grads.loss_params["k"].reshape(len(sel), -1)]
        return torch.cat(out, 1)

    why = _same(run(group, rows), run(ref, list(range(ref.size))), rows, ref.size)
    return [why] if why else []


MODEL_AXES = {"fsdp": _fsdp_case, "moe_ep": _moe_case, "sync_bn": _sync_bn_case, "pipeline": _pipeline_case,
              "new_group": _new_group_case}


def model_axes(p: int, port: str, out: str) -> None:
    group = C.init_process_group([CPU] * 2, coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                                 process_id=p)
    ref = C.BaguaProcessGroup([CPU] * 4, intra_size=2)
    rows = list(group.local_rows)
    report = {}
    for name, case in MODEL_AXES.items():
        try:
            report[name] = case(group, ref, rows)
        except Exception as e:
            import traceback
            report[name] = [f"raised {e!r}", traceback.format_exc()[-2000:]]
    with open(f"{out}.proc{p}.json", "w") as f:
        json.dump(report, f)
    C.barrier(group)
    C.destroy_process_group()


# ---------------------------------------------------------------------------
# The engine's host-side agreements across processes (2 processes x 2 ranks)
# ---------------------------------------------------------------------------


def _mlp_gang(p: int, port: str):
    from bagua_tpu_torch.models import mlp

    group = C.init_process_group([CPU] * 2, coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=p)
    params = mlp.init_mlp(torch.Generator().manual_seed(0), [12, 16, 4], device="cpu")
    rng = np.random.RandomState(100 + p)
    batches = [(torch.from_numpy(rng.randn(8, 12).astype(np.float32)),
                torch.from_numpy(rng.randn(8, 4).astype(np.float32))) for _ in range(4)]
    return group, params, mlp.mse_loss, batches


def async_abort(p: int, port: str, out: str) -> None:
    """Two steps of async model average, then two manual cycles: process 1
    aborted for the first, resumed for the second."""
    from bagua_tpu_torch.algorithms.async_model_average import AsyncModelAverageAlgorithm
    from bagua_tpu_torch.ddp import DistributedDataParallel

    group, params, loss_fn, batches = _mlp_gang(p, port)
    ddp = DistributedDataParallel(loss_fn, lambda ps: torch.optim.SGD(ps, lr=0.05),
                                  AsyncModelAverageAlgorithm(sync_interval_ms=10 ** 9), process_group=group,
                                  overlap=False)
    impl = ddp.impl
    try:
        state = ddp.init(params)
        for batch in batches[:2]:
            state, _ = ddp.train_step(state, batch)
        if p == 1:
            impl.abort()
        impl._cycle(wait=True)
        after_abort = impl._pending is None
        if p == 1:
            impl.resume()
        impl._cycle(wait=True)
        delta = impl._pending[1] if impl._pending is not None else {}
        np.savez(f"{out}.proc{p}.npz", **{"delta" + k: v.numpy() for k, v in delta.items()},
                 **{"param" + k: v.numpy() for k, v in tree_flatten_with_names(state.params)})
        with open(f"{out}.proc{p}.json", "w") as f:
            json.dump({"negotiated": impl.negotiated, "after_abort_pending_empty": after_abort,
                       "averaged": sorted(delta)}, f)
    finally:
        ddp.shutdown()
        C.destroy_process_group()


def async_threaded(p: int, port: str, out: str) -> None:
    """The averager thread cycling every 5 ms while each process trains
    until two averages have landed in its parameters; process 1 then
    trains 5 more steps before it shuts down, so process 0's averager
    stops first and process 1's must leave in the same round."""
    from bagua_tpu_torch.algorithms.async_model_average import AsyncModelAverageAlgorithm
    from bagua_tpu_torch.ddp import DistributedDataParallel

    group, params, loss_fn, batches = _mlp_gang(p, port)
    ddp = DistributedDataParallel(loss_fn, lambda ps: torch.optim.SGD(ps, lr=0.05),
                                  AsyncModelAverageAlgorithm(sync_interval_ms=5), process_group=group,
                                  overlap=False)
    impl = ddp.impl
    state = ddp.init(params)
    steps, deadline = 0, time.monotonic() + 60
    while impl.folds_applied < 2 and time.monotonic() < deadline:
        state, _ = ddp.train_step(state, batches[steps % len(batches)])
        steps += 1
        time.sleep(0.01)
    if p == 1:
        for i in range(5):
            state, _ = ddp.train_step(state, batches[i % len(batches)])
            time.sleep(0.05)
    thread = impl._thread
    t0 = time.monotonic()
    ddp.shutdown()
    shutdown_s = time.monotonic() - t0
    with open(f"{out}.proc{p}.json", "w") as f:
        json.dump({"folds": impl.folds_applied, "failed": impl.folds_failed, "negotiated": impl.negotiated,
                   "left": impl._left, "thread_alive": thread is not None and thread.is_alive(),
                   "shutdown_s": shutdown_s, "finite": all(bool(torch.isfinite(t).all())
                                                          for _, t in tree_flatten_with_names(state.params))}, f)
    C.destroy_process_group()


def init_mismatch(p: int, port: str, out: str) -> None:
    """``init(params)`` with other weights on process 1: every process
    raises."""
    from bagua_tpu_torch.algorithms import GradientAllReduceAlgorithm
    from bagua_tpu_torch.ddp import DistributedDataParallel
    from bagua_tpu_torch.models import mlp

    group, params, loss_fn, _ = _mlp_gang(p, port)
    if p == 1:
        params = mlp.init_mlp(torch.Generator().manual_seed(1), [12, 16, 4], device="cpu")
    ddp = DistributedDataParallel(loss_fn, lambda ps: torch.optim.SGD(ps, lr=0.05),
                                  GradientAllReduceAlgorithm(), process_group=group)
    try:
        ddp.init(params)
        raised = ""
    except ValueError as e:
        raised = str(e)
    with open(f"{out}.proc{p}.json", "w") as f:
        json.dump({"raised": raised}, f)
    C.destroy_process_group()


def resume_agree(p: int, port: str, out: str, snap_dir: str, endpoint: str) -> None:
    """Train 4 steps with a snapshot every 2 (each process writes its own
    ``proc<p>.npz``), then resume in a new Trainer while process 1's scan
    sees only step 2: the gang agrees through the rendezvous KV."""
    from bagua_tpu_torch.algorithms import GradientAllReduceAlgorithm
    from bagua_tpu_torch.examples.gang import digests
    from bagua_tpu_torch.resilience.snapshot import SnapshotStore
    from bagua_tpu_torch.trainer import Trainer

    os.environ["BAGUA_RDZV_ENDPOINT"] = endpoint
    group, params, loss_fn, batches = _mlp_gang(p, port)

    def trainer():
        return Trainer(loss_fn, lambda ps: torch.optim.SGD(ps, lr=0.05, momentum=0.9),
                       GradientAllReduceAlgorithm(), group, overlap=False, snapshot_dir=snap_dir,
                       snapshot_every=2, snapshot_keep=5)

    os.environ["BAGUA_ATTEMPT"] = "0"
    t = trainer()
    state = t.init_state(params)
    cold = t.resume_result is None
    state = t.fit(state, batches[:2])
    at2 = digests(state.params, 2)
    state = t.fit(state, batches[2:])
    at4 = digests(state.params, 2)
    t.close()
    C.barrier(group)
    files = sorted(os.listdir(os.path.join(snap_dir, "step_0000004")))
    if p == 1:
        SnapshotStore.latest_complete = lambda self: 2  # this process's scan lags
    os.environ["BAGUA_ATTEMPT"] = "1"
    t2 = trainer()
    resumed = t2.init_state(params)
    report = {"cold_start": cold, "files_step4": files, "agreed": t2.resume_result.step if t2.resume_result else None,
              "digests_at2": at2, "digests_at4": at4, "digests_resumed": digests(resumed.params, 2)}
    # the resumed momentum carries the run on to the same step 4
    report["digests_resumed_at4"] = digests(t2.fit(resumed, batches[2:]).params, 2)
    t2.close()
    with open(f"{out}.proc{p}.json", "w") as f:
        json.dump(report, f)
    C.destroy_process_group()


def launched(out: str, endpoint: str, mode: str) -> None:
    """A worker under ``python -m bagua_tpu_torch.distributed.run``: form
    the gang from the launcher's environment (2 CPU ranks a process, gloo),
    allreduce across it, push this process's step summary through the
    rendezvous KV and, on process 0, collect the gang view.  ``mode``
    ``fail_once``: process 1 exits 1 on the first attempt; ``fail_always``:
    on every attempt."""
    from bagua_tpu_torch.distributed import init_from_env
    from bagua_tpu_torch.distributed.rendezvous import RendezvousClient
    from bagua_tpu_torch.env import get_rank, get_world_size
    from bagua_tpu_torch.observability.aggregate import GangAggregator, StepSummary

    group = init_from_env([CPU] * 2)
    rank, world = get_rank(), get_world_size()
    attempt = os.environ["BAGUA_ATTEMPT"]
    if rank == 1 and (mode == "fail_always" or (mode == "fail_once" and attempt == "0")):
        sys.exit(1)
    total = C.allreduce(torch.full((2, 1), float(rank)), ReduceOp.SUM, group)
    agg = GangAggregator(RendezvousClient(endpoint, node_rank=rank), rank=rank, world_size=world, window=1)
    summary = StepSummary(rank=rank, step=5, p50_ms=10.0 + 20.0 * rank, p99_ms=12.0 + 20.0 * rank,
                          phase_ms={"dispatch": 1.0 + rank})
    agg.push(summary)
    C.barrier(group)  # every summary is in the KV
    view = agg.aggregate(summary)
    with open(f"{out}.proc{rank}.json", "w") as f:
        json.dump({"size": group.size, "spans": group.spans_processes, "world": world, "attempt": attempt,
                   "sum": total.reshape(-1).tolist(), "view": view.report() if view is not None else None}, f)
    C.destroy_process_group()


def main(argv) -> int:
    if argv[0] == "launched":
        launched(*argv[1:])
        return 0
    job, p, port, out = argv[0], int(argv[1]), argv[2], argv[3]
    {"collectives": collectives, "vjps": vjps, "model_axes": model_axes, "async_abort": async_abort, "async_threaded": async_threaded,
     "resume_agree": resume_agree, "init_mismatch": init_mismatch}[job](
        p, port, out, *argv[4:])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
