"""Elastic launcher: ``python -m bagua_tpu_torch.distributed.run ... script.py``.

A copy of the JAX package's launcher, itself the analog of the reference's torchelastic-derived launcher
(``bagua/distributed/run.py``): sets up the distributed env, spawns one
worker process per local replica, monitors them, and on failure re-forms the
gang (restart-all semantics, reference behavior doc ``run.py:116-148``).

**Elastic membership** (reference ``run.py:116-148,189-345``): ``--nnodes``
accepts ``MIN:MAX``.  Worker slots that fail repeatedly
(``--slot_failure_tolerance`` consecutive crashes) are benched, and the gang
re-rendezvouses at the reduced world size — fresh ``WORLD_SIZE``/``RANK``
(contiguous over the surviving slots) and a rotated ``MASTER_PORT`` so the
new gang's rendezvous never collides with a lingering listener.
``SIGUSR1`` un-benches every slot and re-forms the gang at full size (the
operator's "scale up now" signal — the analog of a new node joining the
reference's etcd rendezvous).  Workers are expected to checkpoint and resume
via ``bagua_tpu_torch.checkpoint`` (reference pattern ``run.py:149-159``), using
:func:`bagua_tpu_torch.checkpoint.remap_world_size` when the world size changed.

**Cross-host membership** (reference ``run.py:606-627``): with ``--nnodes
MIN:MAX`` the launcher coordinates through the rendezvous store
(:mod:`bagua_tpu_torch.distributed.rendezvous`) — hosted by the ``node_rank 0``
launcher by default, or externally via ``--rdzv_endpoint``.  Every launcher
announces its healthy slot count; ``WORLD_SIZE``/``RANK`` come from the
store's published assignment (never from symmetric-shrink assumptions), the
worker rendezvous port rotates with the store's epoch (identical on every
host), and node join/leave/death (heartbeat TTL) re-forms the gang
everywhere.  ``bagua_tpu_torch.distributed.baguarun`` fans launchers out across
hosts.

Env exported to workers (reference ``set_bagua_env``, ``run.py:578-603``):
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``NODE_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``, ``BAGUA_SERVICE_PORT``, ``BAGUA_SLOT``,
``BAGUA_ATTEMPT``, autotune knobs.
Rank 0's launcher also hosts the autotune service when ``--autotune_level >= 1``.
"""

import argparse
import logging
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("bagua_tpu_torch.launcher")


def parse_nnodes(spec: str) -> Tuple[int, int]:
    """``"N"`` -> (N, N); ``"MIN:MAX"`` -> (MIN, MAX) (reference CLI)."""
    if ":" in spec:
        lo, hi = spec.split(":", 1)
        lo, hi = int(lo), int(hi)
    else:
        lo = hi = int(spec)
    if not (1 <= lo <= hi):
        raise ValueError(f"bad --nnodes {spec!r}")
    return lo, hi


def parse_args(argv=None):
    from bagua_tpu_torch.env import (
        get_autotune_level,
        get_autotune_max_samples,
        get_autotune_sampling_confidence_time_s,
        get_autotune_warmup_time_s,
    )

    p = argparse.ArgumentParser(
        "bagua_tpu_torch.distributed.run", description="bagua_tpu_torch elastic launcher"
    )
    p.add_argument(
        "--nnodes", type=str, default="1",
        help="number of nodes: N, or MIN:MAX for elastic membership",
    )
    p.add_argument("--node_rank", type=int, default=0)
    p.add_argument(
        "--nproc_per_node", type=int, default=1,
        help="worker processes per node: one per card, worker i on cuda:LOCAL_RANK=i, the gang formed by init_from_env() over NCCL (gloo for CPU ranks); 1: one process drives every rank of its group",
    )
    p.add_argument(
        "--min_replicas", type=int, default=None,
        help="elastic floor for local worker slots; below this the launch "
        "fails (defaults to nproc_per_node, i.e. no shrinking)",
    )
    p.add_argument(
        "--slot_failure_tolerance", type=int, default=2,
        help="consecutive failures before a worker slot is benched and the "
        "gang shrinks",
    )
    p.add_argument("--master_addr", default="127.0.0.1")
    p.add_argument("--master_port", type=int, default=29500)
    p.add_argument(
        "--host_addr", type=str, default=None,
        help="this node's address as reachable by the other nodes, advertised "
        "through the rendezvous store so the gang's coordinator (the node "
        "owning rank 0 after a membership change) can move; defaults to "
        "--master_addr on node_rank 0 and this host's resolved name elsewhere",
    )
    p.add_argument(
        "--rdzv_endpoint", type=str, default=None,
        help="host:port of an externally hosted rendezvous store; default is "
        "for the node_rank-0 launcher to host one at master_addr:rdzv_port "
        "when --nnodes is elastic (MIN:MAX) or > 1",
    )
    p.add_argument("--rdzv_port", type=int, default=29400)
    p.add_argument(
        "--rdzv_settle_s", type=float, default=1.0,
        help="quiet window after a membership change before the store "
        "publishes a new assignment (batches simultaneous joins)",
    )
    p.add_argument(
        "--rdzv_ttl_s", type=float, default=30.0,
        help="heartbeat TTL after which a silent node is reaped",
    )
    p.add_argument(
        "--rdzv_timeout_s", type=float, default=300.0,
        help="max wait for the gang to reach min_nodes and settle",
    )
    p.add_argument("--max_restarts", type=int, default=3)
    p.add_argument("--monitor_interval", type=float, default=1.0)
    p.add_argument("--autotune_level", type=int, default=get_autotune_level())
    # reference CLI parity (bagua/distributed/run.py autotune args)
    p.add_argument("--autotune_max_samples", type=int, default=get_autotune_max_samples())
    p.add_argument(
        "--autotune_tune_wire_dtype", action="store_true",
        help="let autotune also explore bf16 wire exchange (numerics-affecting"
        ", so opt-in; applies to algorithms exposing wire_dtype)",
    )
    p.add_argument("--autotune_warmup_time_s", type=float, default=get_autotune_warmup_time_s())
    p.add_argument("--autotune_sampling_confidence_time_s", type=float,
                   default=get_autotune_sampling_confidence_time_s())
    p.add_argument("--bagua_service_port", type=int, default=29501)
    p.add_argument("--no_python", action="store_true")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    args.min_nodes, args.max_nodes = parse_nnodes(args.nnodes)
    # The rendezvous store coordinates membership whenever more than one
    # node can participate; a single static node keeps the store-free path.
    args.use_rdzv = args.max_nodes > 1 or args.rdzv_endpoint is not None
    if args.host_addr is None:
        if args.node_rank == 0:
            args.host_addr = args.master_addr
        else:
            import socket

            try:
                resolved = socket.gethostbyname(socket.gethostname())
            except OSError:
                resolved = None
            # Debian-style /etc/hosts maps the hostname to 127.0.1.1 —
            # advertising loopback as this node's gang-reachable address
            # would strand peers if this node ever owns rank 0.
            if resolved is None or resolved.startswith("127."):
                if args.use_rdzv:
                    logger.warning(
                        "cannot resolve a non-loopback address for this host "
                        "(got %s); advertising --master_addr %s instead — if "
                        "this node is ever elected coordinator, peers will "
                        "dial the wrong host.  Pass --host_addr explicitly.",
                        resolved, args.master_addr,
                    )
                args.host_addr = args.master_addr
            else:
                args.host_addr = resolved
    if args.min_replicas is None:
        args.min_replicas = args.nproc_per_node
    return args


def worker_env(
    args, slot: int, rank: int, local_rank: int, local_world: int,
    world_size: int, attempt: int, master_port: int,
    master_addr: Optional[str] = None,
) -> dict:
    env = dict(os.environ)
    env.update(
        RANK=str(rank),
        WORLD_SIZE=str(world_size),
        LOCAL_RANK=str(local_rank),
        LOCAL_WORLD_SIZE=str(local_world),
        NODE_RANK=str(args.node_rank),
        MASTER_ADDR=master_addr or args.master_addr,
        MASTER_PORT=str(master_port),
        BAGUA_SERVICE_PORT=str(args.bagua_service_port),
        BAGUA_AUTOTUNE=str(args.autotune_level),
        BAGUA_SLOT=str(slot),
        BAGUA_ATTEMPT=str(attempt),
        AUTO_TUNE_SERVER_ADDR=f"{args.master_addr}:{args.bagua_service_port}",
    )
    if args.use_rdzv:
        env["BAGUA_RDZV_ENDPOINT"] = args.rdzv_endpoint or (
            f"{args.master_addr}:{args.rdzv_port}"
        )
    return env


def single_node_master_port(args, attempt: int) -> int:
    """Single-node gangs rotate the rendezvous port per gang epoch so a fresh
    gang never trips over a lingering listener; the rotation skips the
    autotune service port.  (Multi-node gangs rotate by the *store's* epoch
    instead — see ``_run_rendezvous`` / ``rotated_master_port`` — which every
    host observes.)"""
    master_port = args.master_port + attempt
    while master_port == args.bagua_service_port:
        master_port += 1
    return master_port


def spawn_workers(
    args,
    slots: List[int],
    attempt: int,
    world_size: Optional[int] = None,
    rank_offset: int = 0,
    master_port: Optional[int] = None,
    master_addr: Optional[str] = None,
) -> Dict[int, subprocess.Popen]:
    """Spawn one worker per active slot; ranks are contiguous over ``slots``
    starting at ``rank_offset`` (this node's offset in the gang-wide
    assignment; 0 for single-node)."""
    if world_size is None:
        world_size = len(slots)
    if master_port is None:
        master_port = single_node_master_port(args, attempt)
    procs = {}
    for local_rank, slot in enumerate(slots):
        if args.no_python:
            cmd = [args.training_script] + args.training_script_args
        else:
            cmd = [sys.executable, "-u", args.training_script] + args.training_script_args
        procs[slot] = subprocess.Popen(
            cmd,
            env=worker_env(
                args, slot, rank_offset + local_rank, local_rank, len(slots),
                world_size, attempt, master_port, master_addr,
            ),
        )
    return procs


def kill_all(procs) -> None:
    plist = list(procs.values()) if isinstance(procs, dict) else list(procs)
    for p in plist:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.time() + 10
    for p in plist:
        try:
            p.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()


def monitor(
    procs: Dict[int, subprocess.Popen], interval: float, interrupt=lambda: False
) -> Tuple[str, List[int]]:
    """Watch the gang.  Returns ``("done", [])`` when all workers exit 0,
    ``("failed", slots)`` with *every* slot that had exited nonzero when the
    failure was observed, or ``("interrupted", [])`` when ``interrupt()``
    goes true (scale-up signal).

    Reporting the whole failed set (rather than the lowest-indexed slot)
    avoids systematically mis-blaming a healthy slot whose worker merely
    collapsed after a faulty peer died within the same poll window."""
    while True:
        codes = {slot: p.poll() for slot, p in procs.items()}
        failed = [slot for slot, code in codes.items() if code is not None and code != 0]
        if failed:
            return "failed", failed
        if all(code == 0 for code in codes.values()):
            return "done", []
        if interrupt():
            return "interrupted", []
        time.sleep(interval)


class _GangController:
    """Shared slot-benching bookkeeping for both launcher loops."""

    def __init__(self, args):
        self.args = args
        self.consecutive_failures = {s: 0 for s in range(args.nproc_per_node)}
        self.benched = set()
        self.failures = 0  # restart budget: consumed by blamed failures only

    def active_slots(self) -> List[int]:
        return [s for s in range(self.args.nproc_per_node) if s not in self.benched]

    def below_floor(self) -> bool:
        if len(self.active_slots()) < self.args.min_replicas:
            logger.error(
                "only %d healthy worker slots left (< --min_replicas %d)",
                len(self.active_slots()), self.args.min_replicas,
            )
            return True
        return False

    def reset_counters(self):
        for s in self.consecutive_failures:
            self.consecutive_failures[s] = 0

    def blame(self, slots: List[int], failed_slots: List[int]) -> bool:
        """Count a locally-blamed gang failure.  Returns True when the bench
        set changed (the node's slot count shrinks)."""
        self.failures += 1
        for s in slots:
            if s in failed_slots:
                self.consecutive_failures[s] += 1
            else:
                self.consecutive_failures[s] = 0
        shrunk = False
        for s in failed_slots:
            if self.consecutive_failures[s] >= self.args.slot_failure_tolerance:
                self.benched.add(s)
                shrunk = True
                logger.warning(
                    "slot %d benched after %d consecutive failures; gang shrinks",
                    s, self.consecutive_failures[s],
                )
        logger.warning(
            "worker slot(s) %s failed (failure %d/%d); restarting gang",
            failed_slots, self.failures, self.args.max_restarts + 1,
        )
        return shrunk

    def scale_up(self):
        logger.info(
            "SIGUSR1: un-benching %s, re-forming at full size", sorted(self.benched)
        )
        self.benched.clear()
        self.reset_counters()


def _run_single_node(args, service, scale_up) -> int:
    gang = _GangController(args)
    epoch = 0  # every gang formation (drives single-node port rotation)
    while gang.failures <= args.max_restarts:
        slots = gang.active_slots()
        if gang.below_floor():
            return 1
        if service is not None:
            # keep the autotune check board sized to the LIVE world, or
            # benched ranks would block tuning forever
            service.world_size = len(slots)
        logger.info(
            "gang epoch %d: %d worker(s) (slots %s), world re-formed",
            epoch, len(slots), slots,
        )
        procs = spawn_workers(args, slots, epoch)
        outcome, failed_slots = monitor(
            procs, args.monitor_interval, interrupt=lambda: scale_up["armed"]
        )
        epoch += 1
        if outcome == "done":
            logger.info("all workers finished")
            return 0
        kill_all(procs)
        if outcome == "interrupted":
            scale_up["armed"] = False
            gang.scale_up()
            continue
        gang.blame(slots, failed_slots)
    logger.error("exceeded max_restarts=%d", args.max_restarts)
    return 1


def _run_rendezvous(args, service, scale_up) -> int:
    """Store-coordinated gang loop (reference membership contract,
    ``run.py:116-148``: any membership change stops ALL workers everywhere
    and restarts them with fresh ``RANK``/``WORLD_SIZE``).

    Every launcher announces its healthy slot count to the store and spawns
    workers from the published assignment.  Local failures are *blamed*
    (slot benching + restart budget) only when no other node initiated a
    re-form around the same time — a worker killed by a peer node's crash
    (distributed-runtime collateral) must not bench a healthy local slot."""
    from bagua_tpu_torch.distributed.rendezvous import (
        RendezvousClient, RendezvousState, rotated_master_port,
        start_rendezvous_server,
    )

    rdzv_server = None
    if args.rdzv_endpoint is None:
        endpoint = f"{args.master_addr}:{args.rdzv_port}"
        if args.node_rank == 0:
            state = RendezvousState(
                min_nodes=args.min_nodes,
                max_nodes=args.max_nodes,
                settle_s=args.rdzv_settle_s,
                ttl_s=args.rdzv_ttl_s,
            )
            rdzv_server = start_rendezvous_server(state, args.rdzv_port)
            logger.info("hosting rendezvous store on port %d", args.rdzv_port)
    else:
        endpoint = args.rdzv_endpoint
    client = RendezvousClient(
        endpoint, args.node_rank, timeout_s=args.rdzv_timeout_s,
        addr=args.host_addr,
    )
    # Distinguishes this launcher process from a previous holder of the same
    # node_rank whose stale membership the store may still carry.
    incarnation = os.getpid()
    gang = _GangController(args)
    reserved = [args.bagua_service_port, args.rdzv_port]
    try:
        while gang.failures <= args.max_restarts:
            slots = gang.active_slots()
            if gang.below_floor():
                client.leave()
                return 1
            try:
                asn = client.wait_assignment(len(slots), incarnation)
            except TimeoutError as e:
                logger.error("rendezvous failed: %s", e)
                client.leave()
                return 1
            mine = next(m for m in asn["members"] if m["node_rank"] == args.node_rank)
            master_port = rotated_master_port(args.master_port, asn["epoch"], reserved)
            if service is not None:
                service.world_size = asn["world_size"]
            logger.info(
                "gang generation %d epoch %d: world_size=%d, node %d ranks "
                "[%d..%d), port %d",
                asn["generation"], asn["epoch"], asn["world_size"], args.node_rank,
                mine["rank_offset"], mine["rank_offset"] + len(slots), master_port,
            )
            procs = spawn_workers(
                args, slots, asn["epoch"], world_size=asn["world_size"],
                rank_offset=mine["rank_offset"], master_port=master_port,
                master_addr=asn.get("master_addr"),
            )
            outcome, failed_slots = monitor(
                procs, args.monitor_interval,
                interrupt=lambda: scale_up["armed"] or client.epoch_changed(asn["epoch"]),
            )
            # The store is notified BEFORE kill_all: SIGTERM grace can take
            # up to 10 s, and while the epoch is unmoved a peer whose workers
            # die of collateral in that window would be mis-ruled the crash
            # origin (and bench a healthy slot).
            if outcome == "done":
                logger.info("all workers finished")
                client.leave(completed=True)
                return 0
            if outcome == "interrupted":
                if scale_up["armed"]:
                    scale_up["armed"] = False
                    gang.scale_up()
                    # Move the epoch FIRST so peer launchers take the clean
                    # "membership changed elsewhere" path.
                    client.request_restart(asn["epoch"])
                else:
                    # Remote membership/epoch change: collateral, not local.
                    logger.info("membership changed elsewhere; re-forming")
                    gang.reset_counters()
                kill_all(procs)
                continue
            # Failed: ask the store who crashed first.  The origin's worker
            # exits before the collateral deaths it causes on other nodes, so
            # the first reporter per epoch takes the blame; everyone else
            # re-forms without benching healthy local slots.
            origin = client.report_crash(asn["epoch"])
            kill_all(procs)
            if origin:
                shrunk = gang.blame(slots, failed_slots)
                if not shrunk:
                    # Same membership: ask the store for a gang-wide restart
                    # so every node re-forms on a fresh (epoch-rotated) port.
                    client.request_restart(asn["epoch"])
                # A shrink re-announces automatically via wait_assignment.
                continue
            # Collateral: wait for the origin's membership change / restart
            # to land, then re-form.  Fall back to local blame if nothing
            # moves (e.g. the origin node lost power before acting — its
            # heartbeat TTL will eventually reap it, which also moves the
            # epoch).
            logger.info("collateral worker failure; waiting for the gang to re-form")
            deadline = time.time() + max(10.0 * args.rdzv_settle_s, 5.0)
            moved = False
            while time.time() < deadline:
                if client.epoch_changed(asn["epoch"]):
                    moved = True
                    break
                time.sleep(0.1)
            gang.reset_counters()
            if not moved:
                logger.warning(
                    "no membership change after collateral failure; "
                    "restarting the gang"
                )
                client.request_restart(asn["epoch"])
        logger.error("exceeded max_restarts=%d", args.max_restarts)
        client.leave()
        return 1
    finally:
        if rdzv_server is not None:
            rdzv_server.shutdown()


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="[bagua_tpu_torch.launcher] %(message)s")
    args = parse_args(argv)

    autotune_server = service = None
    if args.autotune_level >= 1 and args.node_rank == 0:
        from bagua_tpu_torch.service import AutotuneService, start_autotune_server

        service = AutotuneService(
            world_size=args.max_nodes * args.nproc_per_node,
            autotune_level=args.autotune_level,
            max_samples=args.autotune_max_samples,
            warmup_time_s=args.autotune_warmup_time_s,
            sampling_confidence_time_s=args.autotune_sampling_confidence_time_s,
            tune_wire_dtype=args.autotune_tune_wire_dtype,
        )
        autotune_server = start_autotune_server(service, port=args.bagua_service_port)
        logger.info("autotune service on port %d", args.bagua_service_port)

    scale_up = {"armed": False}
    signal.signal(signal.SIGUSR1, lambda *_: scale_up.__setitem__("armed", True))

    try:
        if args.use_rdzv:
            return _run_rendezvous(args, service, scale_up)
        return _run_single_node(args, service, scale_up)
    finally:
        if autotune_server is not None:
            autotune_server.shutdown()


if __name__ == "__main__":
    sys.exit(main())
