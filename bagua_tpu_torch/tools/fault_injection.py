"""Fault-injection resilience lane: kill a live training gang, resume it,
prove parity.

The resilience subsystem's claim is end-to-end: a job that dies mid-run
restarts from the newest *complete* async snapshot and lands on a state
**bitwise identical** to an uninterrupted run — gradient_allreduce is
deterministic, so any divergence is a snapshot/restore bug, not noise.  This
lane drives the claim with real OS processes and real signals: the port's
``Trainer`` under the port's launcher
(``python -m bagua_tpu_torch.distributed.run``), the gang's four ranks held
by one process (``--processes 1``, the JAX lane's layout) or by a gang of
two launcher workers of two ranks each (``--processes 2``: the
multi-process snapshot layout, one ``proc<p>.npz`` a process, under real
signals — the case the JAX lane could not run, its CPU backend refusing
cross-process computations).  The ranks live on the card (``--device
cuda``, the default: a process's ranks on ``cuda:LOCAL_RANK``, NCCL between
processes, so ``--processes 2`` needs two cards) or on the CPU (``--device
cpu``, gloo).

Two kill modes, each followed by a resumed run:

1. **SIGTERM (preemption drain)** — every worker gets the signal; the
   watcher drains the in-flight step, forces a final synchronous snapshot,
   leaves the ``RESUMABLE.json`` marker and exits 0.  (In a gang of two,
   each process's signal reaches it on its own, so the workers stop at one
   step: each step boundary all-reduces the processes' flags and trips
   every watcher together, ``PreemptionWatcher.trigger``.)  The resumed run
   must start at exactly the drained step (**zero** lost work), re-adopt
   the saved bucket plan (``plan_source == "carried"``) and report
   ``lost_steps == 0`` in its ``restart`` event.
2. **SIGKILL (hard crash)** — one worker is killed (the last process's):
   no drain, no marker; any in-flight snapshot write is torn.  The resumed
   run must fall back to the newest *complete* cadenced snapshot (the torn
   write stays invisible), losing at most the snapshot cadence K.

Both resumed runs train to the target step and are asserted bitwise equal
(sha256 over each process's parameters + optimizer state) to an
uninterrupted reference run with identical seeds; per-step loss curves must
agree exactly on every overlapping step (continuity across the kill/resume
boundaries); every emitted JSONL telemetry stream (snapshot + restart
events included) passes the event schema.  A final single-process probe
measures steady-state ``step_wall_ms`` p50 with and without snapshotting
(cadence < half the steps) on the same device; the delta lands in the
report against the 5% target, beside the device it was read on.

The report goes to ``--out``, by default ``RESILIENCE.json`` inside
``--workdir``::

    python -m bagua_tpu_torch.tools.fault_injection
    python -m bagua_tpu_torch.tools.fault_injection --device cpu --processes 2 --workdir /tmp/fi
"""

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import textwrap
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TOTAL_STEPS = 12
SNAPSHOT_EVERY = 3
KILL_AFTER_STEPS = 7  # the worker is signaled once it has logged this many
RANKS = 4  # the gang's ranks, shared among its processes
OVERHEAD_STEPS = 60
OVERHEAD_WARMUP = 10
OVERHEAD_CHUNK = 10  # lanes alternate in chunks of this many steps
OVERHEAD_EVERY = 6  # snapshot < 1/5 of steps; state stays small vs compute
OVERHEAD_TARGET_PCT = 5.0  # the acceptance target, recorded in the artifact
OVERHEAD_HARD_PCT = 30.0  # the CI gate (a 1-core box is noisy; the p50s ride
# in the report so the 5% target stays auditable)


def _worker_env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("BAGUA_SNAPSHOT_EVERY", "BAGUA_RDZV_ENDPOINT", "BAGUA_ATTEMPT"):
        env.pop(k, None)
    env["OMP_NUM_THREADS"] = "1"
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# The gang's worker.  Deterministic everything: params from a fixed seed,
# the batch for global step s from RandomState(7919*s) — so any two runs
# that pass through step s agree bitwise from there on.  Each process
# writes its files with a ``.p<process>`` suffix.
WORKER = textwrap.dedent(
    """
    import hashlib
    import json
    import os
    import signal
    import time

    import numpy as np
    import torch

    torch.set_num_threads(1)

    from bagua_tpu_torch import communication as C
    from bagua_tpu_torch.algorithms import GradientAllReduceAlgorithm
    from bagua_tpu_torch.ddp import state_leaves
    from bagua_tpu_torch.defs import ReduceOp
    from bagua_tpu_torch.distributed import init_from_env
    from bagua_tpu_torch.models.mlp import init_mlp, mse_loss
    from bagua_tpu_torch.observability import Telemetry
    from bagua_tpu_torch.trainer import Trainer

    work = os.environ["FI_WORK"]
    total_steps = int(os.environ["FI_STEPS"])
    tag = os.environ["FI_TAG"]
    attempt = os.environ["FI_RUN"]
    step_delay = float(os.environ.get("FI_STEP_DELAY", "0"))
    snap_dir = os.path.join(work, "snapshots") if os.environ.get("FI_SNAPSHOT") == "1" else None
    processes = int(os.environ.get("WORLD_SIZE", "1"))
    if os.environ["FI_DEVICE"] == "cpu":
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)

    group = init_from_env([device] * (int(os.environ["FI_RANKS"]) // processes), intra_size=1)
    assert group.size == int(os.environ["FI_RANKS"]), group.size
    p = group.process_index

    suffix = f"{tag}_a{attempt}"
    with open(os.path.join(work, f"pid_{suffix}.p{p}"), "w") as f:
        f.write(str(os.getpid()))
    telemetry = Telemetry(metrics_jsonl=os.path.join(work, f"metrics_{suffix}.p{p}.jsonl"))
    trainer = Trainer(
        mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.05),
        GradientAllReduceAlgorithm(),
        process_group=group,
        overlap=False,
        snapshot_dir=snap_dir,
        snapshot_every=int(os.environ.get("FI_EVERY", "3")),
        watchdog_timeout_s=0,
        telemetry=telemetry,
    )
    signaled = {"set": False}
    if processes > 1 and trainer.preemption is not None:
        # each process gets its own SIGTERM: the flag is agreed on at each
        # step boundary (below) and trips every process's watcher together
        trainer.preemption.uninstall()
        signal.signal(signal.SIGTERM, lambda *_: signaled.__setitem__("set", True))
    params = init_mlp(torch.Generator().manual_seed(0), [8, 16, 4], device="cpu")
    state = trainer.init_state({k: {n: t.to(device) for n, t in v.items()} for k, v in params.items()})
    start = int(state.step)
    rr = trainer.resume_result
    status = {
        "start_step": start,
        "resumed_from": None if rr is None else rr.step,
        "plan_source": None if rr is None else rr.plan_source,
        "old_world_size": None if rr is None else rr.old_world_size,
        "new_world_size": None if rr is None else rr.new_world_size,
    }

    def batch_for(step):
        rng = np.random.RandomState(7919 * step)
        return trainer.ddp.process_rows(
            (torch.from_numpy(rng.randn(16, 8).astype(np.float32)).to(device),
             torch.from_numpy(rng.randn(16, 4).astype(np.float32)).to(device))
        )

    # Record the mean loss of this process's ranks per global step (the
    # continuity evidence) by wrapping the engine's step; also the lane's
    # progress feed for timing the kill signal.
    loss_path = os.path.join(work, f"losses_{suffix}.p{p}.txt")
    loss_f = open(loss_path, "a")
    orig_step = trainer.ddp.train_step
    counter = {"step": start}

    def recording_step(st, batch):
        st, losses = orig_step(st, batch)
        loss_f.write(f"{counter['step']} {float(losses.double().mean())!r}\\n")
        loss_f.flush()
        counter["step"] += 1
        if processes > 1:
            flags = torch.full((group.local_size, 1), float(signaled["set"]), device=device)
            if float(C.allreduce(flags, ReduceOp.MAX, group).max()) > 0 and trainer.preemption is not None:
                trainer.preemption.trigger()
        return st, losses

    trainer.ddp.train_step = recording_step

    def batches():
        s = start
        while True:
            if step_delay:
                time.sleep(step_delay)  # widen the signal window
            yield batch_for(s)
            s += 1

    state = trainer.fit(state, batches(), n_steps=total_steps - start, log_every=0)
    final_step = int(state.step)
    status["final_step"] = final_step
    status["preempted"] = trainer.preempted
    if not trainer.preempted:
        h = hashlib.sha256()
        for _, leaf in state_leaves(state):
            h.update(leaf.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
        status["digest"] = h.hexdigest()
    loss_f.close()
    trainer.close()
    telemetry.close()
    with open(os.path.join(work, f"status_{suffix}.p{p}.json"), "w") as f:
        json.dump(status, f)
    C.destroy_process_group()
    print(f"FI worker [{suffix}.p{p}] done at step {final_step}", flush=True)
    """
)

# Single-process overhead probe: two identical trainers — snapshotting off
# and on — stepped in *interleaved* chunks so OS scheduling noise (the
# dominant term on a shared 1-core box) hits both lanes equally; steady-state
# step_wall_ms p50 is read back from each lane's telemetry JSONL.
OVERHEAD_WORKER = textwrap.dedent(
    """
    import json
    import os

    import numpy as np
    import torch

    torch.set_num_threads(1)

    from bagua_tpu_torch.algorithms import GradientAllReduceAlgorithm
    from bagua_tpu_torch.communication import init_process_group
    from bagua_tpu_torch.models.mlp import init_mlp, mse_loss
    from bagua_tpu_torch.observability import Telemetry
    from bagua_tpu_torch.trainer import Trainer

    work = os.environ["FI_WORK"]
    steps = int(os.environ["FI_STEPS"])
    warmup = int(os.environ["FI_WARMUP"])
    every = int(os.environ["FI_EVERY"])
    chunk = int(os.environ["FI_CHUNK"])
    device = torch.device("cpu") if os.environ["FI_DEVICE"] == "cpu" else torch.device("cuda", 0)

    group = init_process_group([device] * 2)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(8192, 64).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.randn(8192, 64).astype(np.float32)).to(device)

    def build(name, snap_dir):
        jsonl = os.path.join(work, f"metrics_overhead_{name}.jsonl")
        telemetry = Telemetry(metrics_jsonl=jsonl)
        trainer = Trainer(
            mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.05), GradientAllReduceAlgorithm(),
            process_group=group, overlap=False, snapshot_dir=snap_dir, snapshot_every=every,
            watchdog_timeout_s=0, telemetry=telemetry,
        )
        # batch >> state: the step must cost something real for the
        # off-critical-path claim to be measurable (a 0.2 ms step makes any
        # writer-thread CPU time look enormous on a 1-core box)
        params = init_mlp(torch.Generator().manual_seed(0), [64, 128, 64], device="cpu")
        state = trainer.init_state({k: {n: t.to(device) for n, t in v.items()} for k, v in params.items()})
        return trainer, telemetry, state, jsonl

    lanes = {
        "off": build("off", None),
        "on": build("on", os.path.join(work, "overhead_snapshots")),
    }
    states = {k: v[2] for k, v in lanes.items()}
    for _ in range(steps // chunk):
        for name, (trainer, _, _, _) in lanes.items():
            states[name] = trainer.fit(
                states[name], ((x, y) for _ in range(chunk)), log_every=0
            )

    def p50(jsonl):
        walls = []
        with open(jsonl) as f:
            for line in f:
                e = json.loads(line)
                if e.get("event") == "step":
                    walls.append(e["wall_ms"])
        steady = sorted(walls[warmup:])
        return steady[len(steady) // 2]

    results = {}
    for name, (trainer, telemetry, _, jsonl) in lanes.items():
        if trainer.snapshotter is not None:
            trainer.snapshotter.drain()
        trainer.close()
        telemetry.close()
        results[name] = p50(jsonl)
    with open(os.path.join(work, "overhead.json"), "w") as f:
        json.dump({"p50_off_ms": results["off"], "p50_on_ms": results["on"],
                   "steps": steps, "warmup": warmup, "every": every,
                   "metrics_on": lanes["on"][3]}, f)
    print("overhead probe done", flush=True)
    """
)


def _spawn(workdir: str, tag: str, attempt: str, snapshot: bool,
           step_delay: float, processes: int, device: str):
    """The gang under the launcher: ``processes`` workers sharing RANKS
    ranks on ``device``, no restarts (the lane does its own)."""
    script = os.path.join(workdir, "worker.py")
    if not os.path.exists(script):
        with open(script, "w") as f:
            f.write(WORKER)
    cmd = [sys.executable, "-m", "bagua_tpu_torch.distributed.run", "--nproc_per_node", str(processes),
           "--max_restarts", "0", "--monitor_interval", "0.1", "--master_port", str(_free_port()), script]
    return subprocess.Popen(
        cmd, cwd=workdir,
        env=_worker_env(
            FI_WORK=workdir, FI_TAG=tag, FI_RUN=attempt, FI_STEPS=TOTAL_STEPS,
            FI_EVERY=SNAPSHOT_EVERY, FI_SNAPSHOT="1" if snapshot else "0",
            FI_STEP_DELAY=step_delay, FI_RANKS=RANKS, FI_DEVICE=device,
        ),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def _wait(proc, name: str, timeout: float = 300):
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(
            f"{name} failed (rc={proc.returncode}):\n{out[-2000:]}\n{err[-2000:]}"
        )
    return out, err


def _count_lines(path: str) -> int:
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        return sum(1 for line in f if line.strip())


def _read_losses(workdir: str, suffix: str) -> dict:
    losses = {}
    with open(os.path.join(workdir, f"losses_{suffix}.txt")) as f:
        text = f.read()
    lines = text.split("\n")
    if not text.endswith("\n"):
        lines = lines[:-1]  # SIGKILL can tear the final line mid-write
    for line in lines:
        if line.strip():
            step, val = line.split()
            losses[int(step)] = val  # repr-exact string compare
    return losses


def _read_status(workdir: str, suffix: str) -> dict:
    with open(os.path.join(workdir, f"status_{suffix}.json")) as f:
        return json.load(f)


def _pids(workdir: str, suffix: str, processes: int) -> list:
    return [int(open(os.path.join(workdir, f"pid_{suffix}.p{p}")).read()) for p in range(processes)]


def run_interrupted(workdir: str, kill_signal: int, processes: int, device: str) -> int:
    """Attempt 0: signal the gang once it has logged KILL_AFTER_STEPS steps
    (SIGTERM every worker; SIGKILL the last process's).  Returns the steps
    the gang had logged when the signal went out."""
    proc = _spawn(workdir, "run", "0", snapshot=True, step_delay=0.25, processes=processes, device=device)
    loss_paths = [os.path.join(workdir, f"losses_run_a0.p{p}.txt") for p in range(processes)]
    deadline = time.monotonic() + 240
    try:
        while min(_count_lines(path) for path in loss_paths) < KILL_AFTER_STEPS:
            if time.monotonic() > deadline:
                raise AssertionError("gang never reached the kill point")
            if proc.poll() is not None:
                out, err = proc.communicate()
                raise AssertionError(
                    f"launcher exited before the kill (rc={proc.returncode}):\n"
                    f"{out[-2000:]}\n{err[-2000:]}"
                )
            time.sleep(0.05)
        pids = _pids(workdir, "run_a0", processes)
        logged = max(_count_lines(path) for path in loss_paths)
        if kill_signal == signal.SIGTERM:
            for pid in pids:
                os.kill(pid, kill_signal)
            # drained exit: clean rc, a resumable marker, status on disk
            _wait(proc, "preempted gang", timeout=120)
            from bagua_tpu_torch.resilience import RESUMABLE_MARKER

            for p in range(processes):
                status = _read_status(workdir, f"run_a0.p{p}")
                assert status["preempted"], f"SIGTERM did not trip the watcher: {status}"
            marker = os.path.join(workdir, "snapshots", RESUMABLE_MARKER)
            assert os.path.exists(marker), "drained exit left no resumable marker"
        else:
            os.kill(pids[-1], kill_signal)
            proc.communicate(timeout=120)
            assert proc.returncode != 0, "the launcher of a SIGKILL'd worker exited cleanly?"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return logged


def run_to_completion(workdir: str, tag: str, attempt: str, snapshot: bool, processes: int, device: str):
    proc = _spawn(workdir, tag, attempt, snapshot=snapshot, step_delay=0.0, processes=processes, device=device)
    _wait(proc, f"{tag} gang (attempt {attempt})")
    return [_read_status(workdir, f"{tag}_a{attempt}.p{p}") for p in range(processes)]


def _restart_event(workdir: str, suffix: str) -> dict:
    events = []
    with open(os.path.join(workdir, f"metrics_{suffix}.jsonl")) as f:
        for line in f:
            if line.strip():
                e = json.loads(line)
                if e.get("event") == "restart":
                    events.append(e)
    assert len(events) == 1, f"expected one restart event, got {events}"
    return events[0]


def run_overhead_probe(workdir: str, device: str) -> dict:
    script = os.path.join(workdir, "overhead_worker.py")
    with open(script, "w") as f:
        f.write(OVERHEAD_WORKER)
    proc = subprocess.Popen(
        [sys.executable, script],
        env=_worker_env(
            FI_WORK=workdir, FI_STEPS=OVERHEAD_STEPS,
            FI_WARMUP=OVERHEAD_WARMUP, FI_EVERY=OVERHEAD_EVERY,
            FI_CHUNK=OVERHEAD_CHUNK, FI_DEVICE=device,
        ),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    _wait(proc, "overhead probe", timeout=300)
    with open(os.path.join(workdir, "overhead.json")) as f:
        return json.load(f)


def run_lane(workdir: str, out_path: str, processes: int = 1, device: str = "cuda") -> dict:
    """The full lane on ``device`` ("cuda" or "cpu"); returns the report
    (also written to ``out_path``)."""
    from bagua_tpu_torch.observability import validate_metrics_file

    os.makedirs(workdir, exist_ok=True)
    dirs = {name: os.path.join(workdir, name)
            for name in ("ref", "preempt", "crash", "overhead")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    ref = run_to_completion(dirs["ref"], "ref", "0", snapshot=False, processes=processes, device=device)
    assert all(r["final_step"] == TOTAL_STEPS for r in ref), ref
    ref_losses = [_read_losses(dirs["ref"], f"ref_a0.p{p}") for p in range(processes)]

    scenarios = {}
    for name, sig in (("preempt", signal.SIGTERM), ("crash", signal.SIGKILL)):
        d = dirs[name]
        logged = run_interrupted(d, sig, processes, device)
        resumed_all = run_to_completion(d, "run", "1", snapshot=True, processes=processes, device=device)
        resumed = resumed_all[0]
        restart = _restart_event(d, "run_a1.p0")

        # -- resume provenance ------------------------------------------------
        assert all(r["resumed_from"] == resumed["resumed_from"] for r in resumed_all), resumed_all
        assert resumed["resumed_from"] is not None, f"{name}: did not resume"
        assert resumed["plan_source"] == "carried", (
            f"{name}: saved bucket plan was not re-adopted: {resumed}"
        )
        assert resumed["final_step"] == TOTAL_STEPS and not resumed["preempted"]
        assert restart["step"] == resumed["resumed_from"], (resumed, restart)
        if sig == signal.SIGTERM:
            # the drain landed a final snapshot at the drained step: resume
            # loses ZERO work and starts exactly where the signal stopped us
            drained = _read_status(d, "run_a0.p0")
            assert resumed["resumed_from"] == drained["final_step"], (
                f"drained at {drained['final_step']} but resumed from "
                f"{resumed['resumed_from']}"
            )
            assert restart["lost_steps"] == 0, restart
        else:
            # hard kill: newest complete cadenced snapshot, torn in-flight
            # writes invisible; loss bounded by the cadence
            assert resumed["resumed_from"] % SNAPSHOT_EVERY == 0, resumed
            assert resumed["resumed_from"] >= KILL_AFTER_STEPS - 2 * SNAPSHOT_EVERY, (
                f"lost more than the cadence bounds: killed past step "
                f"{KILL_AFTER_STEPS}, resumed from {resumed['resumed_from']}"
            )

        # -- bitwise parity with the uninterrupted run ------------------------
        for p, (got, want) in enumerate(zip(resumed_all, ref)):
            assert got["digest"] == want["digest"], (
                f"{name}: process {p}'s resumed state != uninterrupted state at step "
                f"{TOTAL_STEPS} ({got['digest']} vs {want['digest']})"
            )

        # -- loss-curve continuity --------------------------------------------
        checked = 0
        for p in range(processes):
            for suffix in ("run_a0", "run_a1"):
                for step, val in _read_losses(d, f"{suffix}.p{p}").items():
                    assert ref_losses[p][step] == val, (
                        f"{name}: loss diverged at step {step} ({suffix}.p{p}): "
                        f"{val} != {ref_losses[p][step]}"
                    )
                    checked += 1
        assert checked >= TOTAL_STEPS * processes, checked

        # -- telemetry schema over every surviving stream ---------------------
        validated = []
        for fname in sorted(os.listdir(d)):
            if fname.startswith("metrics_") and fname.endswith(".jsonl"):
                problems = validate_metrics_file(os.path.join(d, fname))
                assert not problems, f"{d}/{fname}: {problems}"
                validated.append(fname)
        scenarios[name] = {
            "signal": signal.Signals(sig).name,
            "signaled_after_steps": logged,
            "resumed_step": resumed["resumed_from"],
            "lost_steps": restart["lost_steps"],
            "plan_source": resumed["plan_source"],
            "world_size": resumed["new_world_size"],
            "bitwise_identical": True,
            "loss_points_checked": checked,
            "telemetry_streams_validated": validated,
        }

    # -- async-snapshot overhead ----------------------------------------------
    # Noise on a shared 1-core box is strictly additive (scheduler spikes),
    # so the *minimum* over a few probe repetitions estimates the true cost;
    # a single loaded minute must not fail the lane.
    attempts = []
    for i in range(3):
        d = os.path.join(dirs["overhead"], f"attempt{i}")
        os.makedirs(d, exist_ok=True)
        overhead = run_overhead_probe(d, device)
        problems = validate_metrics_file(overhead["metrics_on"])
        assert not problems, f"overhead stream: {problems}"
        with open(overhead["metrics_on"]) as f:
            kinds = [json.loads(line)["event"] for line in f if line.strip()]
        assert kinds.count("snapshot") >= 2, kinds
        pct = 100.0 * (overhead["p50_on_ms"] / overhead["p50_off_ms"] - 1.0)
        attempts.append(pct)
        if pct <= OVERHEAD_TARGET_PCT:
            break
    overhead_pct = min(attempts)
    assert overhead_pct <= OVERHEAD_HARD_PCT, (
        f"async snapshotting inflates steady-state p50 by {overhead_pct:.1f}% "
        f"in the best of {len(attempts)} probes ({attempts})"
    )

    payload = {
        "fault_injection": {
            "total_steps": TOTAL_STEPS,
            "snapshot_every": SNAPSHOT_EVERY,
            "kill_after_steps": KILL_AFTER_STEPS,
            "processes": processes,
            "device": device,
            "scenarios": scenarios,
            # the tier-1 summary fields (worst case over scenarios)
            "resumed_step": min(s["resumed_step"] for s in scenarios.values()),
            "lost_steps": max(s["lost_steps"] for s in scenarios.values()),
            "plan_source": "carried",
            "bitwise_identical": True,
        },
        "overhead": {
            "device": device,
            "steps": overhead["steps"],
            "warmup_excluded": overhead["warmup"],
            "snapshot_every": overhead["every"],
            "p50_off_ms": overhead["p50_off_ms"],
            "p50_on_ms": overhead["p50_on_ms"],
            "overhead_pct": round(overhead_pct, 2),
            "attempts_pct": [round(p, 2) for p in attempts],
            "target_pct": OVERHEAD_TARGET_PCT,
            "target_met": overhead_pct <= OVERHEAD_TARGET_PCT,
            "hard_bound_pct": OVERHEAD_HARD_PCT,
        },
    }
    with open(out_path, "w") as f:
        json.dump(payload, f, indent=1)
    print(
        f"[audit] fault-injection resilience lane passed ({processes} process(es) on {device}; preempt: resume "
        f"@{scenarios['preempt']['resumed_step']} lost 0; crash: resume "
        f"@{scenarios['crash']['resumed_step']} lost <= {SNAPSHOT_EVERY}; "
        f"plan carried, bitwise-identical @step {TOTAL_STEPS}; snapshot "
        f"overhead p50 {overhead_pct:+.1f}% -> {out_path})",
        file=sys.stderr,
    )
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="the report (default: RESILIENCE.json inside --workdir)")
    ap.add_argument("--workdir", default=None,
                    help="scratch dir for gangs/snapshots (default: a tempdir)")
    ap.add_argument("--processes", type=int, default=1, choices=[1, 2],
                    help="launcher workers sharing the gang's four ranks")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the ranks' device: cuda:LOCAL_RANK over NCCL, or the CPU over gloo")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < args.processes:
            ap.error(f"--device cuda --processes {args.processes} needs {args.processes} card(s), "
                     f"{cards} visible (--device cpu runs the lane on the CPU)")
    workdir = args.workdir or tempfile.mkdtemp(prefix="bagua_fault_injection_")
    run_lane(workdir, args.out or os.path.join(workdir, "RESILIENCE.json"), args.processes, args.device)


if __name__ == "__main__":
    main()
