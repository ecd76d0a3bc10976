"""Training on a gang in a fleet namespace: a worker of the launcher's
store-coordinated mode whose store is a gang's namespace on the fleet
control plane.

Start one launcher a node, each pointing at the gang's endpoint
(``fleet.gang_endpoint(base, gang)``, ``<base>/g/<gang>``):

    python -m bagua_tpu_torch.distributed.run --nnodes 1:2 --node_rank 0 --nproc_per_node 1 \\
        --rdzv_endpoint http://127.0.0.1:29600/g/beta \\
        bagua_tpu_torch/examples/fleet_gang.py --fleet http://127.0.0.1:29600 --gang beta \\
        --model vgg16 --algorithm bytegrad --steps 6 --snapshot-dir /tmp/beta

The plane, not the launcher, sets the membership (its ``rdzv_kwargs``:
min and max nodes, settle, TTL); the launcher's ``--rdzv_endpoint``
carries its announcements, the snapshot agreement and the gang view to
that namespace (``BAGUA_RDZV_ENDPOINT``).  Each worker forms its group
from the launcher's environment (``torch.distributed`` even in a gang of
one process: NCCL with its ranks on ``cuda:LOCAL_RANK``, gloo with
``--device cpu``), builds the seed-drawn weights, and trains under the
``Trainer`` with a snapshot every ``--snapshot-every`` steps:

* a cold start looks the engine's plan up in the fleet's cache under the
  gang's identity and adopts it at step 0
  (``ElasticResumeCoordinator.fleet_warm_start``, ``plan_source="fleet"``);
* a restarted gang, of this or another process count, agrees on the newest
  complete snapshot, loads it (remapped to the live world) and carries its
  bucket plan over (``Trainer.init_state``);
* each step's global batch comes from one seed and is split over the live
  world (:meth:`~bagua_tpu_torch.ddp.DistributedDataParallel.process_rows`);
* each step this process pushes its step summary to the gang's KV, which
  the plane's ``scheduler_view`` reads (``ranks_reporting``).

The snapshots follow the ``Trainer``'s cadence, which skips a tick while
the writer is still busy with the one before; a run that ends on a
cadence step leaves that step on disk (taken in line if its tick was
skipped), so that a replay of a segment resumes where the gang did.

Two faults for the elastic drills: ``--crash STEP[:NODE]`` exits the
process hard (``os._exit``) after step STEP, once the newest cadence
snapshot at or before it is complete, the first time (a flag file in the
snapshot directory) the node gets there; ``--hold RANKS:STEP`` stops after
step STEP in a world of RANKS ranks with that step on disk, writes
``held_r<RANKS>_s<STEP>.p<process>`` into the snapshot directory and waits
for the launcher's SIGTERM (a membership change re-forms the gang).  Each
attempt writes its report to ``REPORT.e<attempt>.p<process>.json`` after
every step: the resume, the adoption, the plan's bucket names, each step's
ms, per-rank losses and whether the snapshot's writer was busy when it
started and, on the card, how far the pinned host allocator grew while it
ran, the kernels' launches, each first launch held against its plain
version, ms/step and, at the end, a SHA-256 of each rank's parameters.
:func:`run` trains the same way on any group (a single-controller group
replays a gang's run).
"""

import argparse
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from bagua_tpu_torch.examples import gang

#: the MLP's widths and its global batch, the same at every world size
MLP_SIZES = gang.MLP_SIZES
MLP_BATCH = 16
#: exit code of ``--crash``, and of a hold that no membership change ended
CRASH_EXIT, HOLD_TIMEOUT_EXIT = 17, 3
HOLD_TIMEOUT_S = 180.0


def model_parts(model: str, device, params_npz: Optional[str] = None):
    """``(params, loss_fn, optimizer factory, global_batch(world, step))``:
    the MLP (SGD 0.05, momentum 0.9, a global batch of MLP_BATCH rows from
    ``RandomState(7919 * (step + 1))``), or ``gang.build_model``'s VGGs
    with the whole world's rows of each step's batch."""
    if model == "mlp":
        params, loss_fn, _, _, _ = gang.build_model("mlp", device, params_npz)

        def global_batch(world, step):
            rng = np.random.RandomState(7919 * (step + 1))
            return (torch.from_numpy(rng.randn(MLP_BATCH, MLP_SIZES[0]).astype(np.float32)).to(device),
                    torch.from_numpy(rng.randn(MLP_BATCH, MLP_SIZES[-1]).astype(np.float32)).to(device))
        return params, loss_fn, lambda ps: torch.optim.SGD(ps, lr=0.05, momentum=0.9), global_batch
    params, loss_fn, optimizer, _, batch_of = gang.build_model(model, device)

    def global_batch(world, step):
        return tuple(t.to(device) for t in batch_of(0, world, 1, step))
    return params, loss_fn, optimizer, global_batch


def _write(path: Optional[str], report: dict) -> None:
    if path:
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(report, f)
        os.replace(tmp, path)


def _crashes_here(args, step: int) -> bool:
    if not args.crash:
        return False
    at, _, node = args.crash.partition(":")
    return int(at) == step and (not node or int(node) == int(os.environ.get("NODE_RANK", 0)))


def run(group, args, fleet=None, adopt_gang: Optional[str] = None, report_path: Optional[str] = None) -> dict:
    """Train ``args.model`` on ``group`` to step ``args.steps`` under the
    ``Trainer`` (snapshots in ``args.snapshot_dir``), resuming from its
    newest complete snapshot when there is one, else adopting the fleet's
    cached plan (``fleet``, a ``FleetClient``; the lookup under
    ``adopt_gang``'s identity, None for the read-only lookup).  Returns the
    report (also written to ``report_path`` after every step)."""
    from bagua_tpu_torch.env import get_rank, get_world_size
    from bagua_tpu_torch.fleet import engine_plan_key
    from bagua_tpu_torch.observability.aggregate import GangAggregator, StepSummary
    from bagua_tpu_torch.resilience import ElasticResumeCoordinator
    from bagua_tpu_torch.trainer import Trainer

    device = group.device
    params, loss_fn, optimizer, global_batch = model_parts(args.model, device, args.params)
    trainer = Trainer(loss_fn, optimizer, gang.make_algorithm(args.algorithm, {}), group,
                      overlap={"on": True, "off": False}.get(args.overlap, args.overlap),
                      snapshot_dir=args.snapshot_dir, snapshot_every=args.snapshot_every, snapshot_keep=args.steps + 1)
    ddp = trainer.ddp
    k, p = group.local_size, group.process_index
    report = {"process": p, "processes": group.process_count, "local_ranks": k, "world": group.size,
              "device": str(device), "node": int(os.environ.get("NODE_RANK", 0)),
              "attempt": os.environ.get("BAGUA_ATTEMPT", "0"), "resumed_from": None, "plan_source": None,
              "resume_ms": None, "resume_bytes": None, "adopted": None, "adopt_ms": None, "buckets": [],
              "overlap": None, "steps": [], "launches": {}, "held": {}, "ms_per_step": None, "digests": None,
              "exit": None}
    try:
        state = trainer.init_state(params)
        del params
        result = trainer.resume_result
        if result is not None:
            read = trainer.snapshotter.store.step_dir(result.step)
            report.update(resumed_from=result.step, plan_source=result.plan_source, resume_ms=result.wall_ms,
                          resume_bytes=sum(os.path.getsize(os.path.join(read, f)) for f in os.listdir(read)))
        elif fleet is not None:
            key = engine_plan_key(ddp)
            coordinator = ElasticResumeCoordinator(
                trainer.snapshotter.store,
                fleet_plan_fn=lambda: (fleet.lookup_plan(gang=adopt_gang, **key) or {}).get("plan"))
            t0 = time.perf_counter()
            report["adopted"] = coordinator.fleet_warm_start(ddp) == "fleet"
            report["adopt_ms"] = (time.perf_counter() - t0) * 1e3
            report["plan_source"] = "fleet" if report["adopted"] else "fresh"
        report["buckets"] = [[td.name for td in b] for b in ddp.plan.declarations()]
        report["overlap"] = ddp.overlap_enabled
        view = None
        if fleet is not None and adopt_gang is not None:
            view = GangAggregator(fleet.rendezvous_client(adopt_gang, node_rank=report["node"]), rank=get_rank(),
                                  world_size=get_world_size(), window=1)
        held = {}
        gang.reset_launches()
        start, timed = int(state.step), []
        for step in range(start, args.steps):
            batch = ddp.process_rows(global_batch(group.size, step))
            gang._wait(device)
            writer_busy, pinned = trainer.snapshotter.busy, _pinned_growth(device)
            t0 = time.perf_counter()
            if step == start:
                with gang.held_against_plain(held):
                    state = trainer.fit(state, [batch], log_every=0)
            else:
                state = trainer.fit(state, [batch], log_every=0)
            gang._wait(device)
            ms, done = (time.perf_counter() - t0) * 1e3, step + 1
            if step > start:
                timed.append(ms)
            if pinned is not None:
                pinned = [b - a for a, b in zip(pinned, _pinned_growth(device))]
            report["steps"].append({"step": done, "ms": ms, "losses": trainer.losses.float().cpu().tolist(),
                                    "writer_busy": writer_busy, "pinned": pinned})
            report.update(launches=gang.read_launches(), held=held,
                          ms_per_step=sum(timed) / len(timed) if timed else None)
            if view is not None:
                view.push(StepSummary(rank=get_rank(), step=done, p50_ms=ms))
            if _crashes_here(args, done):
                _crash(trainer, state, args, done, report, report_path)
            if [group.size, done] in args.hold:
                _hold(trainer, state, args, done, report, report_path)
            _write(report_path, report)
        if args.snapshot_every and args.steps > start and args.steps % args.snapshot_every == 0:
            _on_disk(trainer, state, args.steps)
        final = ddp.finalize_pending_updates(state)
        report["digests"] = gang.digests(final.params, k)
        report["exit"] = "done"
        _write(report_path, report)
        return report
    finally:
        trainer.close()


def _pinned_growth(device) -> Optional[list]:
    """On the card, the pinned host allocator's growth so far in this
    process (its ``cudaHostAlloc`` calls and the microseconds spent in
    them, the snapshot writer's included); None elsewhere."""
    if device.type != "cuda":
        return None
    stats = torch.cuda.host_memory_stats()
    return [stats.get("num_host_alloc", 0), stats.get("host_alloc_time.total", 0)]


def _on_disk(trainer, state, step: int) -> None:
    """``step``'s snapshot written: the writer drained, and the snapshot
    taken in line where the cadence skipped it or did not fall on it."""
    snapshotter = trainer.snapshotter
    snapshotter.drain()
    if snapshotter.last_step != step:
        snapshotter.snapshot(state, step, blocking=True)


def _crash(trainer, state, args, step: int, report: dict, report_path: Optional[str]) -> None:
    """``--crash``: once the newest cadence snapshot at or before ``step``
    is complete (every process's file and the manifest), exit hard."""
    flag = os.path.join(args.snapshot_dir, f"crashed.node{os.environ.get('NODE_RANK', '0')}")
    if os.path.exists(flag):
        return
    store, want = trainer.snapshotter.store, step - step % args.snapshot_every
    if want == step:
        _on_disk(trainer, state, step)
    else:
        trainer.snapshotter.drain()
    deadline = time.monotonic() + HOLD_TIMEOUT_S
    while not store.is_complete(want):
        if time.monotonic() > deadline:
            raise TimeoutError(f"the snapshot at step {want} never completed")
        time.sleep(0.02)
    report["exit"] = f"crash after step {step} (snapshot {want} complete)"
    _write(report_path, report)
    with open(flag, "w") as f:
        f.write(str(step))
    os._exit(CRASH_EXIT)


def _hold(trainer, state, args, step: int, report: dict, report_path: Optional[str]) -> None:
    """``--hold``: this step's snapshot on disk, a marker file, then wait
    for the launcher's SIGTERM (the preemption watcher's flag)."""
    _on_disk(trainer, state, step)
    report["exit"] = f"held after step {step} in a world of {trainer.ddp.group.size}"
    _write(report_path, report)
    marker = os.path.join(args.snapshot_dir, f"held_r{trainer.ddp.group.size}_s{step}.p{trainer.ddp.group.process_index}")
    with open(marker, "w") as f:
        f.write(str(os.getpid()))
    deadline = time.monotonic() + HOLD_TIMEOUT_S
    while not trainer.preemption.should_stop():
        if time.monotonic() > deadline:
            os._exit(HOLD_TIMEOUT_EXIT)
        time.sleep(0.02)
    trainer.close()
    os._exit(0)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="vgg16", choices=["mlp", "small-vgg", "vgg16"])
    ap.add_argument("--params", default=None, help="an npz of the mlp's weights (layer<i>.w, layer<i>.b)")
    ap.add_argument("--algorithm", default="bytegrad", help="a registered algorithm, on its defaults")
    ap.add_argument("--overlap", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ranks-per-process", type=int, default=None,
                    help="ranks this process holds (default: 1 on the card, 2 on the CPU)")
    ap.add_argument("--steps", type=int, default=6, help="train to this step")
    ap.add_argument("--snapshot-dir", required=True)
    ap.add_argument("--snapshot-every", type=int, default=1, help="0: no snapshots (and no --crash)")
    ap.add_argument("--fleet", default=None, help="the fleet plane's base URL (the plan cache, the gang view)")
    ap.add_argument("--gang", default=None, help="this gang's id in the fleet")
    ap.add_argument("--crash", default=None, metavar="STEP[:NODE]")
    ap.add_argument("--hold", default=[], action="append", metavar="RANKS:STEP",
                    type=lambda s: [int(v) for v in s.split(":")])
    ap.add_argument("--report", default=None, help="write REPORT.e<attempt>.p<process>.json")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from bagua_tpu_torch.communication import destroy_process_group, init_process_group
    from bagua_tpu_torch.distributed import init_gang, launched
    from bagua_tpu_torch.fleet import FleetClient

    if args.device == "cpu":
        torch.set_num_threads(1)
        device = torch.device("cpu")
    else:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    k = args.ranks_per_process or (2 if device.type == "cpu" else 1)
    group = init_gang([device] * k, intra_size=1) if launched() else \
        init_process_group([device] * k, intra_size=1)
    fleet = FleetClient(args.fleet) if args.fleet else None
    report_path = None
    if args.report:
        report_path = f"{args.report}.e{os.environ.get('BAGUA_ATTEMPT', '0')}.p{group.process_index}.json"
    try:
        run(group, args, fleet, args.gang, report_path)
    finally:
        destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
