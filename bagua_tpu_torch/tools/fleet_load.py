"""Fleet control-plane load lane (the artifact ``FLEET_LOAD_TORCH.json``).

The port of the JAX package's ``ci/fleet_load.py``.  One ``python -m
bagua_tpu_torch.fleet.server`` subprocess (WAL-backed, token-bucket
admission) serves everything this lane throws at it:

* **multi-tenant load**: 8 simulated gangs (``perflab/fleetsim.py``, each
  pointed at its own ``/g/<gang_id>`` namespace through ``gang_endpoint``)
  push StepSummary and flight-digest streams through the GangAggregator and
  breaker paths, with an injected wire straggler, a KV flap and a rank
  preemption.  Every gang must come back healthy, the straggler attributed
  to the injected rank and phase, the flap absorbed by the breaker, and the
  ``/fleet/scheduler`` view must show all of it.
* **isolation**: an adversarial gang probes another gang's KV and blob keys
  (must read nothing) and the unprefixed single-tenant routes (must 404).
* **backpressure**: a threaded raw hammer past the token bucket's burst
  must collect 429 + Retry-After denials; a paced ``retry_call`` client then
  rides the same bucket to completion with the circuit breaker never
  counting a 429 (``times_opened == 0``).
* **latency**: p99 over 200 paced KV RPCs, gated at ``LATENCY_GATE_MS``.
* **SIGKILL + WAL replay**: with rider clients mid-heartbeat, the server is
  SIGKILLed and restarted on the same port and WAL directory; the riders
  must see the outage (a breaker opens) and recover, and the ``/fleet/dump``
  durable witness must be **bitwise identical** across the kill.
* **cross-gang plan cache**: an engine's plan (the port's engine, its ranks
  on ``--device``) published *before* the kill is adopted by a second
  engine (another bucketing, the same cache key) *after* the restart, at
  step 0 with ``plan_source="fleet"``, the restart event schema-checked.

The server's port is chosen free and then bound by the server; where
another process takes it first (EADDRINUSE, at the start or at the
restart), the lane runs again on a fresh port, each retry printed.

::

    python -m bagua_tpu_torch.tools.fleet_load                  # the engines on the card
    python -m bagua_tpu_torch.tools.fleet_load --device cpu --out /tmp/FLEET_LOAD_TORCH.json --workdir /tmp/fl
"""

import argparse
import json
import os
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import torch

from bagua_tpu_torch.tools._fleet import canon, free_port, spawn_server, wait_health, with_port_retries
from bagua_tpu_torch.tools._lane import REPO, add_device_args, command_line, device_record, lane_group, \
    write_json

N_SIM_GANGS = 8
LAYERS = [12, 16, 16, 4]
LATENCY_CALLS = 200
LATENCY_GATE_MS = 500.0
HAMMER_THREADS = 10
HAMMER_CALLS = 60
# Per-gang admission: burst 40 is far above any honest client's window burst
# (a 4-rank gang's aggregate is ~10 calls) and far below the hammer's 600.
RATE, BURST = 100.0, 40.0
#: the JAX lane's group: 2 inter x 4 intra
INTRA_SIZE = 4


def _server_args(port: int, wal_dir: str):
    return [
        "--port", str(port), "--host", "127.0.0.1", "--wal-dir", wal_dir,
        "--settle-s", "0.05", "--lease-ttl-s", "600", "--member-ttl-s", "600",
        "--rate", str(RATE), "--burst", str(BURST), "--compact-every", "400",
    ]


def _raw_kv_set(gang_ep: str, key: str, value: str, timeout: float = 10.0):
    """One unpaced KV write (no retry layer: the hammer must SEE the 429)."""
    from urllib.parse import quote

    req = urllib.request.Request(
        f"{gang_ep}/rdzv/kv/{quote(key, safe='')}",
        data=json.dumps({"value": value}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def run_lane(workdir: str, out_path: str, group) -> dict:
    """The whole lane, its engines on ``group``; returns the payload (also
    written to ``out_path``).  A run whose server lost its port to another
    process runs again on a fresh port, in a fresh WAL directory."""
    return with_port_retries("[fleet-load]", lambda t: _run_lane_once(
        os.path.join(workdir, f"try{t}") if t else workdir, out_path, group))


def _run_lane_once(workdir: str, out_path: str, group) -> dict:
    from bagua_tpu_torch.algorithms.gradient_allreduce import GradientAllReduceAlgorithm
    from bagua_tpu_torch.ddp import DistributedDataParallel
    from bagua_tpu_torch.distributed.rendezvous import RendezvousClient
    from bagua_tpu_torch.fleet import FleetClient, adopt_fleet_plan, gang_endpoint, publish_engine_plan
    from bagua_tpu_torch.models.mlp import init_mlp, mse_loss
    from bagua_tpu_torch.observability import Telemetry, validate_metrics_file
    from bagua_tpu_torch.perflab.fleetsim import FleetConfig, KVFlap, Preemption, Straggler, run_fleet
    from bagua_tpu_torch.resilience.retry import CircuitBreaker, RetryPolicy, retry_call

    os.makedirs(workdir, exist_ok=True)
    wal_dir = os.path.join(workdir, "wal")
    log_path = os.path.join(workdir, "server.log")
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    device = group.device

    def make_engine(bucket_size: int) -> DistributedDataParallel:
        ddp = DistributedDataParallel(
            mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.1), GradientAllReduceAlgorithm(),
            process_group=group, bucket_size_bytes=bucket_size, overlap=False,
        )
        params = init_mlp(torch.Generator().manual_seed(0), LAYERS, device="cpu")
        ddp.init({k: {n: t.to(device) for n, t in v.items()} for k, v in params.items()})
        return ddp

    proc = spawn_server(_server_args(port, wal_dir), log_path)
    restarted_proc = None
    try:
        wait_health(base, proc, log_path)
        fleet = FleetClient(base, timeout_s=10.0)

        # -- gang alpha: membership + KV + blob + the published plan --------
        alpha_ep = gang_endpoint(base, "alpha")
        alpha = RendezvousClient(alpha_ep, node_rank=0, timeout_s=30.0)
        asn = alpha.wait_assignment(nslots=2)
        assert asn["world_size"] == 2, asn
        for i in range(4):
            alpha.kv_set(f"fleet-lane/k{i}", f"v{i}")
        alpha.kv_set("fleet-lane/secret", "alpha-only")
        blob_req = urllib.request.Request(
            f"{alpha_ep}/rdzv/blob/alpha-blob", data=b"\x00\x01payload",
            method="PUT",
        )
        with urllib.request.urlopen(blob_req, timeout=10.0) as resp:
            resp.read()

        ddp_a = make_engine(1 << 9)  # many small buckets: a non-default plan
        plan_key = publish_engine_plan(
            fleet, ddp_a, meta={"origin": "fleet-load-lane"}
        )
        assert plan_key, "engine plan publish failed"
        buckets_published = [
            [td.name for td in b] for b in ddp_a.plan.declarations()
        ]

        # -- the 8-gang fleet: straggler + KV flap + preemption churn -------
        cfg = FleetConfig(
            n_gangs=N_SIM_GANGS, ranks_per_gang=4, windows=3, seed=0,
            faults=(
                Straggler(gang=1, rank=2, factor=3.0, phase="wire"),
                KVFlap(gang=3, start_window=2, end_window=3),
                Preemption(gang=5, rank=1, window=3),
            ),
        )
        report = run_fleet(
            cfg, gang_endpoint=lambda g: gang_endpoint(base, f"sim{g}")
        )
        unhealthy = [g["gang"] for g in report["gangs"] if not g["healthy"]]
        assert not unhealthy, f"unhealthy gang verdicts: {unhealthy}"
        errors = [e for g in report["gangs"] for e in g["errors"]]
        assert not errors, f"exceptions reached a sim step loop: {errors}"
        detections = report["gangs"][1]["straggler_detections"]
        assert detections and all(
            d["rank"] == 2 and d["phase"] == "wire" for d in detections
        ), f"straggler misattributed: {detections}"
        flap = report["gangs"][3]
        assert flap["breaker"]["times_opened"] >= 1, "flap never opened breaker"
        assert flap["breaker"]["final_state"] == "closed", "breaker stayed open"
        churn = report["gangs"][5]["windows"][2]
        assert churn["stale_ranks"] == [1], (
            f"preempted rank not surfaced as stale: {churn}"
        )

        # -- scheduler view: all the streams above, one endpoint ------------
        sched = fleet.scheduler_view()
        sim_ids = [f"sim{g}" for g in range(N_SIM_GANGS)]
        missing = [g for g in sim_ids + ["alpha"] if g not in sched["gangs"]]
        assert not missing, f"scheduler view missing gangs: {missing}"
        for gid in sim_ids:
            v = sched["gangs"][gid]
            # every sim gang pushed a post-run flight digest, so the wedged
            # precedence wins — exactly the black-box-first triage order
            assert v["verdict"] == "wedged" and v["flight_ranks"], (gid, v)
            assert v["ranks_reporting"] == 4, (gid, v)
        sched_straggler = sched["gangs"]["sim1"]["straggler"]
        assert sched_straggler and sched_straggler["rank"] == 2, sched_straggler
        assert sched_straggler["phase"] == "wire", sched_straggler
        assert sched["gangs"]["alpha"]["n_members"] == 1, sched["gangs"]["alpha"]

        # -- adversarial isolation probe ------------------------------------
        probes, leaks = 0, 0
        intruder = RendezvousClient(
            gang_endpoint(base, "intruder"), node_rank=0, timeout_s=10.0
        )
        for key in ("fleet-lane/secret", "fleet-lane/k0",
                    "bagua/obs/sim-g1/rank0"):
            probes += 1
            if intruder.kv_get(key) is not None:
                leaks += 1
        # the same key IS readable where it lives (the probe isn't vacuous)
        sim1 = RendezvousClient(
            gang_endpoint(base, "sim1"), node_rank=0, timeout_s=10.0
        )
        assert sim1.kv_get("bagua/obs/sim-g1/rank0") is not None
        for url in (
            f"{gang_endpoint(base, 'intruder')}/rdzv/blob/alpha-blob",
            f"{base}/rdzv/assignment",
            f"{base}/rdzv/kv/fleet-lane%2Fsecret",
        ):
            probes += 1
            try:
                with urllib.request.urlopen(url, timeout=10.0) as resp:
                    resp.read()
                leaks += 1  # anything readable from here is a leak
            except urllib.error.HTTPError as e:
                if e.code != 404:
                    leaks += 1
        assert leaks == 0, f"cross-gang leakage: {leaks}/{probes} probes"

        # -- backpressure: raw hammer past burst, then the paced ride -------
        hammer_ep = gang_endpoint(base, "hammer")
        denials, hints = [], []

        def hammer(tid: int):
            for i in range(HAMMER_CALLS):
                try:
                    _raw_kv_set(hammer_ep, f"hammer/{tid}/{i}", "x")
                except urllib.error.HTTPError as e:
                    if e.code == 429:
                        body = json.loads(e.read())
                        denials.append(body)
                        hints.append(int(e.headers.get("Retry-After", 0)))
                    else:  # pragma: no cover - any other code is a lane bug
                        raise

        threads = [
            threading.Thread(target=hammer, args=(t,))
            for t in range(HAMMER_THREADS)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert denials, (
            f"{HAMMER_THREADS * HAMMER_CALLS} raw calls never drew a 429 "
            f"(burst {BURST}, rate {RATE})"
        )
        assert all(d["error"] == "backpressure" for d in denials)
        assert min(hints) >= 1, hints

        paced = RendezvousClient(hammer_ep, node_rank=0, timeout_s=10.0)
        paced_breaker = CircuitBreaker(failure_threshold=3, name="lane-paced")
        paced_policy = RetryPolicy(retries=8, base_s=0.02, max_s=1.0)
        for i in range(25):
            retry_call(
                paced._call_once, "/rdzv/kv/paced%2F" + str(i), {"value": "y"},
                policy=paced_policy, breaker=paced_breaker,
            )
        assert paced_breaker.times_opened == 0, (
            "429s must never count against the breaker"
        )

        # -- p99 RPC latency under the shared-tenant load -------------------
        lat_ep = gang_endpoint(base, "lat")
        lat = RendezvousClient(lat_ep, node_rank=0, timeout_s=10.0)
        walls = []
        for i in range(LATENCY_CALLS // 2):
            t0 = time.monotonic()
            lat.kv_set(f"lat/{i}", "z" * 64)
            walls.append(time.monotonic() - t0)
            t0 = time.monotonic()
            lat.kv_get(f"lat/{i}")
            walls.append(time.monotonic() - t0)
            # Honest pacing: 2 calls per iteration must stay under RATE even
            # on an idle box where the calls themselves are ~free — at
            # 0.01s/iter a fast box exceeds the bucket, draws a 429, and the
            # client's >=1s Retry-After sleep lands in the measured wall.
            time.sleep(2.0 / RATE * 1.25)
        walls.sort()
        p50_ms = walls[len(walls) // 2] * 1e3
        p99_ms = walls[int(len(walls) * 0.99)] * 1e3
        assert p99_ms <= LATENCY_GATE_MS, (
            f"p99 RPC latency {p99_ms:.1f} ms over the {LATENCY_GATE_MS} ms gate"
        )

        # -- SIGKILL with live riders; WAL replay must be bitwise -----------
        pre = fleet.dump()
        stop = threading.Event()
        restarted = threading.Event()
        rider_stats = {"fail": 0, "ok_after_restart": 0, "opened": 0}
        rider_lock = threading.Lock()

        def rider(gang_id: str):
            # _call_once (not the public verb): the client's internal retry
            # layer would hide the outage this lane exists to observe
            client = RendezvousClient(
                gang_endpoint(base, gang_id), node_rank=0, timeout_s=2.0
            )
            breaker = CircuitBreaker(
                failure_threshold=2, cooldown_s=0.1, name=f"rider-{gang_id}"
            )
            policy = RetryPolicy(retries=1, base_s=0.01, max_s=0.05)
            while not stop.is_set():
                try:
                    retry_call(
                        client._call_once, "/rdzv/heartbeat", {"node_rank": 0},
                        policy=policy, breaker=breaker,
                    )
                    if restarted.is_set():
                        with rider_lock:
                            rider_stats["ok_after_restart"] += 1
                except Exception:
                    with rider_lock:
                        rider_stats["fail"] += 1
                time.sleep(0.02)
            with rider_lock:
                rider_stats["opened"] += breaker.times_opened

        riders = [
            threading.Thread(target=rider, args=(g,), daemon=True)
            for g in ("alpha", "sim0")
        ]
        for t in riders:
            t.start()
        time.sleep(0.3)  # riders demonstrably healthy pre-kill
        proc.kill()  # SIGKILL: no flush, no goodbye
        proc.wait()
        time.sleep(0.6)
        with rider_lock:
            outage_failures = rider_stats["fail"]
        assert outage_failures >= 1, "riders never observed the outage"

        restarted_proc = spawn_server(_server_args(port, wal_dir), log_path)
        wait_health(base, restarted_proc, log_path)
        restarted.set()
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            with rider_lock:
                if rider_stats["ok_after_restart"] >= 5:
                    break
            time.sleep(0.05)
        stop.set()
        for t in riders:
            t.join(timeout=10.0)
        assert rider_stats["ok_after_restart"] >= 5, rider_stats
        assert rider_stats["opened"] >= 1, (
            "a hard outage must open at least one rider breaker"
        )
        post = fleet.dump()
        assert canon(post) == canon(pre), (
            "durable dump diverged across SIGKILL + WAL replay"
        )

        # -- cross-gang plan adoption, across the kill ----------------------
        metrics_path = os.path.join(workdir, "fleet_metrics.jsonl")
        if os.path.exists(metrics_path):
            os.remove(metrics_path)
        tel = Telemetry(metrics_jsonl=metrics_path)
        ddp_b = make_engine(1 << 20)  # the default-ish mega-bucket cold plan
        buckets_cold = [
            [td.name for td in b] for b in ddp_b.plan.declarations()
        ]
        assert buckets_cold != buckets_published, "plans must differ pre-adopt"
        source = adopt_fleet_plan(fleet, ddp_b, telemetry=tel)
        assert source == "fleet", f"plan_source {source!r} != 'fleet'"
        buckets_adopted = [
            [td.name for td in b] for b in ddp_b.plan.declarations()
        ]
        assert buckets_adopted == buckets_published, "adopted plan mismatch"
        tel.close()
        assert validate_metrics_file(metrics_path) == []
        with open(metrics_path) as f:
            events = [json.loads(line) for line in f if line.strip()]
        restart_events = [e for e in events if e["event"] == "restart"]
        assert restart_events and restart_events[0]["step"] == 0
        assert restart_events[0]["plan_source"] == "fleet"
        assert restart_events[0]["lost_steps"] == 0

        gangs_view = fleet.gangs()
        ddp_a.shutdown()
        ddp_b.shutdown()

        payload = {
            "generated_by": "bagua_tpu_torch/tools/fleet_load.py",
            "command": command_line(),
            "device": device_record(group),
            "server": {
                "rate": RATE, "burst": BURST, "compact_every": 400,
                "wal_backed": True,
            },
            "fleet_sim": {
                "n_gangs": report["n_gangs"],
                "ranks_per_gang": report["ranks_per_gang"],
                "windows": report["windows"],
                "healthy": sum(1 for g in report["gangs"] if g["healthy"]),
                "straggler_detections": detections,
                "flap_breaker": flap["breaker"],
                "flap_degraded_windows": flap["degraded_windows"],
                "churn_stale_ranks": churn["stale_ranks"],
            },
            "scheduler": {
                "n_gangs": sched["n_gangs"],
                "sim_verdicts": sorted(
                    {sched["gangs"][g]["verdict"] for g in sim_ids}
                ),
                "straggler": sched_straggler,
            },
            "isolation": {"probes": probes, "leaks": leaks},
            "backpressure": {
                "hammer_calls": HAMMER_THREADS * HAMMER_CALLS,
                "denials_429": len(denials),
                "retry_after_s_min": min(hints),
                "server_denial_count": gangs_view["backpressure_denials"],
                "paced_writes_ok": 25,
                "paced_breaker_opened": paced_breaker.times_opened,
            },
            "latency": {
                "n_calls": len(walls),
                "p50_ms": round(p50_ms, 3),
                "p99_ms": round(p99_ms, 3),
                "gate_ms": LATENCY_GATE_MS,
            },
            "sigkill": {
                "rider_failures": outage_failures,
                "rider_ok_after_restart": rider_stats["ok_after_restart"],
                "rider_breaker_opened": rider_stats["opened"],
                "dump_bitwise_identical": True,
                "dump_gangs": len(pre.get("gangs", {})),
            },
            "plan_adoption": {
                "plan_source": "fleet",
                "key": plan_key,
                "published_before_kill": True,
                "buckets_published": len(buckets_published),
                "buckets_cold": len(buckets_cold),
                "restart_event_step": restart_events[0]["step"],
            },
        }
        write_json(out_path, payload, indent=1)
        print(
            f"[fleet-load] fleet load lane passed ({N_SIM_GANGS} sim gangs + "
            f"alpha on one control plane, {len(denials)}x 429 paced with "
            f"breaker untripped, p99 {p99_ms:.1f} ms, 0/{probes} probes "
            f"leaked, SIGKILL->restart dump bitwise-identical with "
            f"{rider_stats['ok_after_restart']} rider recoveries, plan "
            f"adopted across the kill with plan_source=fleet -> {out_path})",
            file=sys.stderr,
        )
        return payload
    finally:
        for p in (proc, restarted_proc):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "FLEET_LOAD_TORCH.json"))
    ap.add_argument("--workdir", default=None, help="scratch directory for the WAL and logs (default: a temporary one)")
    add_device_args(ap)
    args = ap.parse_args(argv)
    group = lane_group(args.device, args.ranks, args.intra_size, cpu_intra_size=INTRA_SIZE)
    workdir = args.workdir or tempfile.mkdtemp(prefix="bagua_fleet_load_")
    run_lane(workdir, args.out, group)
    return 0


if __name__ == "__main__":
    sys.exit(main())
