"""Autotune closed loop on a measured signal (the artifact
``AUTOTUNE_RUN_TORCH.json``).

The port of the JAX package's ``ci/autotune_real_run.py``.  The reference's
CI proves its autotune end to end by training a real model with
``--autotune_level 1`` and gating on the throughput it reaches
(``.buildkite/scripts/benchmark.sh:17-20``).  This lane is that analog: an
MLP ``[256, 2048, 2048, 2048, 256]`` (about 9.4 M parameters, 38 MB in f32;
32 KiB starting buckets give 8, a bucket a weight, since a bucket never
splits a tensor, and one bucket holds it all) trains while an :class:`AutotuneSession` reports its
**measured wall-clock throughput** (the engine's ``SpeedMeter``) to a live
service; the service explores bucket sizes with its Bayesian optimizer and
locks the best.  The port's session restarts the engine's meter at every
re-bucket, so each reported speed is the throughput of the plan it is
credited to; the JAX session reports the run's average since its start,
under which the first samples decide the pick.  Before tuning, one profiled step of the seed plan
(``ProfilerSession`` and ``analyze_trace`` on the torch profiler's trace)
sends the per-bucket wire spans that the planner fits its cost model on;
after it, one profiled step of the locked plan closes the loop.

Asserted, as in the JAX lane:

* the session completes (``max_samples`` explored, the plan locked);
* the locked plan was *adopted* (the engine re-bucketed at least once);
* the locked plan has fewer buckets than the pathological 32 KiB start
  (the optimizer followed the measured signal).

At most 4000 steps and 420 s.  The JAX lane caps the steps at 400, which
its CPU run (about 60 steps) never reaches; the service samples on wall
time (1 s of warm-up, then a sample at most every 0.2 s), which at the
card's steps of about 3.5 ms takes 450-600 steps.  The trace, the device it ran on and the command go to
``--out``::

    python -m bagua_tpu_torch.tools.autotune_real_run                 # one rank a card
    python -m bagua_tpu_torch.tools.autotune_real_run --device cpu    # 8 CPU ranks
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

from bagua_tpu_torch.tools._lane import REPO, add_device_args, command_line, device_record, lane_group, wait, \
    write_json

DIMS = [256, 2048, 2048, 2048, 256]
START_BUCKET_BYTES = 1 << 15
MAX_SAMPLES = 10
MAX_STEPS = 4000
MAX_WALL_S = 420
SETTLE_STEPS = 20
#: samples a rank, a step
BATCH = 8


def measure_overlap(ddp, state, batch, label):
    """One profiled step and its trace analysis: the realized
    ``measured_overlap_frac`` (and per-bucket wire rows) of the plan the
    engine runs now."""
    from bagua_tpu_torch.observability.core import ProfilerSession
    from bagua_tpu_torch.observability.trace_analysis import analyze_trace

    with tempfile.TemporaryDirectory(prefix=f"bagua_autotune_{label}_") as prof_dir:
        state, _ = ProfilerSession(prof_dir).trace_steps(ddp.train_step, state, [batch])
        return state, analyze_trace(prof_dir)


def run(group, out_path=None, log=None) -> dict:
    """The closed loop over ``group``; returns the trace (``ok`` True) or
    raises.  The trace, with ``ok`` False and the ``error`` where it
    raised, goes to ``out_path`` when one is given."""
    from bagua_tpu_torch.algorithms.gradient_allreduce import GradientAllReduceAlgorithm
    from bagua_tpu_torch.ddp import AutotuneSession, DistributedDataParallel
    from bagua_tpu_torch.models.mlp import init_mlp, mse_loss
    from bagua_tpu_torch.observability import Telemetry
    from bagua_tpu_torch.service.autotune_client import AutotuneClient
    from bagua_tpu_torch.service.autotune_service import AutotuneService, start_autotune_server

    log = log or sys.stderr
    device = group.device
    n = group.size
    params = init_mlp(torch.Generator().manual_seed(0), DIMS, device="cpu")
    params = {k: {m: t.to(device) for m, t in v.items()} for k, v in params.items()}
    service = AutotuneService(world_size=1, autotune_level=1, max_samples=MAX_SAMPLES,
                              sampling_confidence_time_s=0.2, warmup_time_s=1.0)
    srv = start_autotune_server(service, port=0)
    trace = {"backend": device.type, "device": device_record(group), "command": command_line(),
             "samples": [], "devices": n}
    ddp = None
    try:
        client = AutotuneClient(port=srv.server_address[1])
        telemetry = Telemetry()
        ddp = DistributedDataParallel(mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.01),
                                      GradientAllReduceAlgorithm(), process_group=group,
                                      bucket_size_bytes=START_BUCKET_BYTES, telemetry=telemetry)
        state = ddp.init(params)
        session = AutotuneSession(ddp, "autotune_real", client=client, interval=5)
        n_buckets_initial = ddp.plan.num_buckets
        trace["initial_buckets"] = n_buckets_initial

        rng = np.random.RandomState(0)
        batch_sz = BATCH * n

        def draw():
            return (torch.from_numpy(rng.randn(batch_sz, DIMS[0]).astype(np.float32)).to(device),
                    torch.from_numpy(rng.randn(batch_sz, DIMS[-1]).astype(np.float32)).to(device))

        probe_batch = draw()
        # the buckets' measured arrival order -> tensor_ready spans
        session.profile_and_report(state, probe_batch)
        # the seed plan's realized overlap (one profiled step) as per-bucket
        # wire spans, so that the planner fits on a measured point first
        state, before = measure_overlap(ddp, state, probe_batch, "before")
        session.report_wire_timings(before)
        trace["overlap_frac_before"] = before["measured_overlap_frac"]
        rebuckets = 0
        last_buckets = n_buckets_initial
        t_start = time.time()
        step = 0
        completed_at = None
        while step < MAX_STEPS and time.time() - t_start < MAX_WALL_S:
            state, losses = ddp.train_step(state, draw())
            wait(device)
            # the running plan's speed: a re-bucket in the tick restarts the meter
            speed = ddp.speed_meter.speed(60.0)
            session.tick(batch_sz)
            step += 1
            if ddp.plan.num_buckets != last_buckets:
                rebuckets += 1
                trace["samples"].append({"step": step, "buckets": ddp.plan.num_buckets,
                                         "speed": round(speed, 1),
                                         "speed_of_buckets": last_buckets})
                print(f"[autotune] step {step}: {ddp.plan.num_buckets} buckets; {last_buckets} buckets ran at "
                      f"{trace['samples'][-1]['speed']} samples/s", file=log, flush=True)
                last_buckets = ddp.plan.num_buckets
            if session.completed and completed_at is None:
                completed_at = step
                # settle: measure the locked plan for SETTLE_STEPS more steps
                t0, s0 = time.time(), step
                for _ in range(SETTLE_STEPS):
                    state, losses = ddp.train_step(state, draw())
                    step += 1
                wait(device)
                trace["locked_speed_sps"] = round(batch_sz * (step - s0) / (time.time() - t0), 1)
                break

        trace["completed_at_step"] = completed_at
        trace["rebuckets"] = rebuckets
        trace["final_buckets"] = ddp.plan.num_buckets
        trace["wall_s"] = round(time.time() - t_start, 1)
        # the locked plan's realized overlap: the before/after pair closes
        # the planner's predicted-against-measured loop in the artifact
        state, after = measure_overlap(ddp, state, probe_batch, "after")
        trace["overlap_frac_after"] = after["measured_overlap_frac"]
        # the service-side planner's decision record over the HTTP surface
        # the workers use
        trace["planner_trail"] = client.get_planner_trail("autotune_real")
        tel_snap = telemetry.registry.snapshot()
        trace["telemetry"] = {k: tel_snap[k] for k in ("rebucket_total", "plan_version",
                                                       "predicted_exposed_comm_ms") if k in tel_snap}

        assert completed_at is not None, "autotune session never completed"
        assert rebuckets >= 1, "service never changed the plan (no real tuning)"
        assert ddp.plan.num_buckets < n_buckets_initial, (
            f"locked plan ({ddp.plan.num_buckets} buckets) no better than the pathological 32 KiB start "
            f"({n_buckets_initial}): the optimizer failed to follow the measured signal")
        trace["ok"] = True
    except BaseException as e:
        trace["ok"] = False
        trace["error"] = f"{type(e).__name__}: {e}"[:500]
        raise
    finally:
        if ddp is not None:
            ddp.shutdown()
        srv.shutdown()
        if out_path is not None:
            write_json(out_path, trace, indent=1)
            print(f"[autotune] wrote {out_path}: ok={trace['ok']}", file=log)
    return trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "AUTOTUNE_RUN_TORCH.json"),
                    help="where to write the trace (default: the repo's root)")
    add_device_args(ap)
    args = ap.parse_args(argv)
    # the JAX lane's default group: every rank on the intra axis
    run(lane_group(args.device, args.ranks, args.intra_size), args.out)
    print("autotune closed loop on a measured signal: OK", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
