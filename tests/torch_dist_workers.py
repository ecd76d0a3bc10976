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
    {"collectives": collectives, "async_abort": async_abort, "async_threaded": async_threaded,
     "resume_agree": resume_agree, "init_mismatch": init_mismatch}[job](
        p, port, out, *argv[4:])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
