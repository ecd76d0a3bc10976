"""Gangs of several processes under the port's fleet control plane.

The plane runs in the test's process; its gangs are gloo gangs of OS
processes, each process holding 2 CPU ranks, the launchers pointed at a
gang's namespace (``--rdzv_endpoint <base>/g/<gang>``).  Every phase is
paced by files the workers write (markers, reports), never by sleeps.

1. Elastic 2 -> 1 -> 2 through the plane: two launcher nodes of one
   worker each train the MLP under ``gradient_allreduce`` (SGD, momentum),
   a snapshot every step.  Node 1's worker exits hard after step 3 (its
   slot benched, node 1 leaves), node 0 re-forms at world 2, resumes from
   step 3 and holds at step 5; a fresh node-1 launcher joins and the gang
   re-forms at world 4, resumes from step 5 and finishes at step 8.  Every
   step's losses and the final parameters are bitwise those of one
   controller replaying the recorded (world, resume step) sequence through
   the same ``Trainer`` and ``ElasticResumeCoordinator``; the first
   segment is within ``tests/test_torch_dist_engine.py``'s MLP bound of the
   JAX package's engine on a 4-device CPU mesh.
2. One fleet plan across processes: gang beta, 2 processes x 2 ranks under
   one launcher, adopts gang alpha's published plan at step 0 in each
   process; three steps are bitwise the single controller's on that plan,
   and the plane records beta once among the adopters and the canary
   cohort.
3. One autotune plan across processes: each process runs an
   ``AutotuneSession`` against the gang's service in the namespace; the
   plan digests agree at every step, a proposal is applied, the
   parameters agree at the end.  The service's quorum (the first
   ``world_size`` it is created with, 1 when no client sends one) is held
   against the JAX package's service through the same calls.
4. Remediation from two processes: one process stalls inside its step past
   the watchdog's timeout; both flight digests land in the namespace,
   ``remediate()`` directs a resize to one process that implicates the
   stalled rank, each process reads ``directed_world_size(2) == 1``, and
   the hang report and the directive equal the JAX package's on the same
   digests.
"""

import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import optax
import pytest
import torch

from bagua_tpu.algorithms.gradient_allreduce import GradientAllReduceAlgorithm as JaxGAR
from bagua_tpu.communication import BaguaProcessGroup as JaxGroup
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP
from bagua_tpu.models import mlp as jax_mlp

from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.examples import fleet_gang, gang
from bagua_tpu_torch.fleet import FleetClient, FleetControlPlane, gang_endpoint, start_fleet_server
from bagua_tpu_torch.resilience.snapshot import SnapshotStore

from helpers import REPO_ROOT, free_port, worker_env

FLEET_GANG = os.path.join(REPO_ROOT, "bagua_tpu_torch", "examples", "fleet_gang.py")
CPU = torch.device("cpu")
#: the plane's membership for every gang: one or two launcher nodes, a
#: settle window wide enough for two launchers started together to join
#: one generation
RDZV = {"min_nodes": 1, "max_nodes": 2, "settle_s": 3.0, "ttl_s": 30.0}
DEADLINE_S = 150


@pytest.fixture()
def one_thread():
    """The single controller computes on one thread, as each worker does."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture()
def plane():
    plane = FleetControlPlane(rdzv_kwargs=RDZV)
    server = start_fleet_server(plane, 0, host="127.0.0.1")
    try:
        yield plane, f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        plane.close()


def mlp_npz(tmp_path) -> str:
    """The JAX package's seed-0 MLP, the weights every run starts from."""
    params = jax.tree.map(np.asarray, jax_mlp.init_mlp(jax.random.PRNGKey(0), gang.MLP_SIZES))
    path = str(tmp_path / "mlp.npz")
    np.savez(path, **{f"{layer}.{leaf}": a for layer, leaves in params.items() for leaf, a in leaves.items()})
    return path


def launcher(node_rank, endpoint, master_port, worker_args, tolerance=2, nproc=1, log=None):
    cmd = [sys.executable, "-m", "bagua_tpu_torch.distributed.run", "--nnodes", "1:2", "--node_rank",
           str(node_rank), "--nproc_per_node", str(nproc), "--slot_failure_tolerance", str(tolerance),
           "--max_restarts", "4", "--monitor_interval", "0.2", "--rdzv_timeout_s", "90", "--master_port",
           str(master_port), "--rdzv_endpoint", endpoint, FLEET_GANG, "--device", "cpu"] + worker_args
    return subprocess.Popen(cmd, env=worker_env(OMP_NUM_THREADS="1"), cwd=REPO_ROOT, stdout=log,
                            stderr=subprocess.STDOUT, text=True)


def wait_for(what, cond, procs, logs=()):
    deadline = time.monotonic() + DEADLINE_S
    while not cond():
        if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
            tails = "\n".join(f"--- {log}\n{open(log).read()[-3000:]}" for log in logs if os.path.exists(log))
            raise AssertionError(f"{what}: timed out or a launcher failed "
                                 f"({[p.poll() for p in procs]})\n{tails}")
        time.sleep(0.05)


def reports(prefix):
    """Every report of a run, ``{(attempt, process): report}``."""
    out = {}
    d, base = os.path.split(prefix)
    for name in os.listdir(d):
        if name.startswith(base + ".e") and name.endswith(".json"):
            attempt, proc = name[len(base) + 2:-len(".json")].split(".p")
            out[(int(attempt), int(proc))] = json.load(open(os.path.join(d, name)))
    return out


def replay(args, segments, snap_dir):
    """One controller replaying the gang's segments ``(world, resumed
    from, last step)`` through the same Trainer, snapshots and resume."""
    out = []
    for world, resumed, last in segments:
        seg_args = fleet_gang.parse_args(args + ["--steps", str(last), "--snapshot-dir", snap_dir])
        rep = fleet_gang.run(BaguaProcessGroup([CPU] * world, intra_size=1), seg_args)
        assert rep["resumed_from"] == resumed and rep["world"] == world
        out.append(rep)
    return out


# -- 1. elastic 2 -> 1 -> 2 through the plane ----------------------------------------------


@pytest.mark.parametrize("algorithm", ["gradient_allreduce", "zero"])
def test_elastic_two_one_two_through_the_plane(plane, tmp_path, one_thread, algorithm):
    plane, base = plane
    snap, prefix = str(tmp_path / "snap"), str(tmp_path / "run")
    npz = mlp_npz(tmp_path)
    model = ["--model", "mlp", "--params", npz, "--algorithm", algorithm, "--overlap", "off"]
    worker = model + ["--steps", "8", "--snapshot-dir", snap, "--fleet", base, "--gang", "elastic",
                      "--crash", "3:1", "--hold", "4:3", "--hold", "2:5", "--report", prefix]
    endpoint, port = gang_endpoint(base, "elastic"), free_port()
    logs = [str(tmp_path / f"node{n}.log") for n in ("0", "1", "1b")]
    files = [open(log, "w") for log in logs]
    nodes = [launcher(0, endpoint, port, worker, tolerance=3, log=files[0]),
             launcher(1, endpoint, port, worker, tolerance=1, log=files[1])]
    try:
        # node 1 crashes after step 3, is benched and leaves; node 0 re-forms alone
        assert nodes[1].wait(timeout=DEADLINE_S) == 1
        wait_for("node 0 alone at step 5", lambda: os.path.exists(os.path.join(snap, "held_r2_s5.p0")),
                 nodes[:1], logs)
        nodes.append(launcher(1, endpoint, port, worker, tolerance=1, log=files[2]))
        for p in (nodes[0], nodes[2]):
            assert p.wait(timeout=DEADLINE_S) == 0, open(logs[0]).read()[-3000:]
    finally:
        for p in nodes:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()

    got = reports(prefix)
    attempts = sorted({a for a, _ in got})
    assert len(attempts) == 3, sorted(got)
    segments = []
    for i, a in enumerate(attempts):
        procs = [got[(a, p)] for p in sorted(p for b, p in got if b == a)]
        world = sum(r["local_ranks"] for r in procs)
        assert {r["world"] for r in procs} == {world}
        assert len({r["resumed_from"] for r in procs}) == 1
        last = min(r["steps"][-1]["step"] for r in procs)
        segments.append((world, procs[0]["resumed_from"], last, procs))
    assert [(w, r, last) for w, r, last, _ in segments] == [(4, None, 3), (2, 3, 5), (4, 5, 8)]
    assert segments[1][3][0]["plan_source"] == "carried" and segments[2][3][0]["exit"] == "done"

    ref = replay(model, [s[:3] for s in segments], str(tmp_path / "ref"))
    for (world, _, _, procs), want in zip(segments, ref):
        for i, step in enumerate(want["steps"]):
            losses = [x for r in procs for x in r["steps"][i]["losses"]]
            assert [r["steps"][i]["step"] for r in procs] == [step["step"]] * len(procs)
            assert losses == step["losses"], (world, step["step"])
    assert [d for r in segments[2][3] for d in r["digests"]] == ref[2]["digests"]

    # the plane saw the three generations, and every process's step summaries
    rdzv = plane.gang("elastic").rendezvous
    assert rdzv.export_membership()["generation"] == 3
    # the two-process generations agreed on their snapshot through the namespace's KV
    nonces = [procs[0]["attempt"] for w, _, _, procs in segments if len(procs) == 2]
    assert {f"resilience/resume/{n}/rank{p}" for n in nonces for p in (0, 1)} <= set(rdzv.kv_keys())
    view = plane.scheduler_view()["gangs"]["elastic"]
    assert view["ranks_reporting"] == 2 and view["max_step"] == 8

    if algorithm != "gradient_allreduce":
        return
    # the first segment against the JAX package's engine on a 4-device mesh
    store = SnapshotStore(str(tmp_path / "ref"))
    manifest, arrays = store.load_stacked(3)
    leaves = dict(zip(manifest["leaf_keys"], arrays))
    jparams = jax_mlp.init_mlp(jax.random.PRNGKey(0), gang.MLP_SIZES)
    ddp = JaxDDP(jax_mlp.mse_loss, optax.sgd(0.05, momentum=0.9), JaxGAR(),
                 process_group=JaxGroup(jax.devices()[:4], intra_size=1))
    jstate = ddp.init(jparams)
    _, _, _, batch = fleet_gang.model_parts("mlp", CPU, npz)
    for step in range(3):
        jstate, jlosses = ddp.train_step(jstate, tuple(t.numpy() for t in batch(4, step)))
        np.testing.assert_allclose(np.asarray(jlosses).reshape(-1), ref[0]["steps"][step]["losses"],
                                   rtol=0, atol=1e-5)
    want = ddp.params_unstacked(jstate)
    for layer, tensors in want.items():
        for leaf, w in tensors.items():
            got_leaf = next(a for k, a in leaves.items() if k.startswith(".params") and f"['{layer}']['{leaf}']" in k)
            np.testing.assert_allclose(got_leaf[0], np.asarray(w), rtol=0, atol=1e-5)


# -- 2. one fleet plan across processes -----------------------------------------------------


def test_fleet_plan_adopted_by_every_process(plane, tmp_path, one_thread):
    from bagua_tpu_torch.algorithms import GradientAllReduceAlgorithm
    from bagua_tpu_torch.ddp import DistributedDataParallel
    from bagua_tpu_torch.fleet import engine_plan_key, publish_engine_plan

    plane, base = plane
    npz = mlp_npz(tmp_path)
    params, loss_fn, optimizer, _ = fleet_gang.model_parts("mlp", CPU, npz)
    alpha = DistributedDataParallel(loss_fn, optimizer, GradientAllReduceAlgorithm(),
                                    BaguaProcessGroup([CPU] * 4, intra_size=1), bucket_size_bytes=256, overlap=False)
    alpha.init(params)
    fc = FleetClient(base)
    key = publish_engine_plan(fc, alpha, meta={"gang": "alpha", "plan_version": alpha.plan_version})
    alpha_names = [[td.name for td in b] for b in alpha.plan.declarations()]
    assert key is not None and len(alpha_names) > 1

    model = ["--model", "mlp", "--params", npz, "--algorithm", "gradient_allreduce", "--overlap", "off"]
    prefix = str(tmp_path / "beta")
    worker = model + ["--steps", "3", "--snapshot-dir", str(tmp_path / "snap"), "--fleet", base, "--gang", "beta",
                      "--report", prefix]
    with open(tmp_path / "beta.log", "w") as log:
        beta = launcher(0, gang_endpoint(base, "beta"), free_port(), worker, nproc=2, log=log)
        try:
            assert beta.wait(timeout=DEADLINE_S) == 0, open(tmp_path / "beta.log").read()[-3000:]
        finally:
            if beta.poll() is None:
                beta.kill()
                beta.wait()
    got = [r for _, r in sorted(reports(prefix).items())]
    assert [(r["process"], r["processes"], r["world"]) for r in got] == [(0, 2, 4), (1, 2, 4)]
    for r in got:
        assert r["adopted"] and r["plan_source"] == "fleet" and r["buckets"] == alpha_names

    ref = fleet_gang.run(BaguaProcessGroup([CPU] * 4, intra_size=1),
                         fleet_gang.parse_args(model + ["--steps", "3", "--snapshot-dir", str(tmp_path / "ref")]),
                         fleet=fc)
    assert ref["adopted"] and ref["buckets"] == alpha_names
    for i, step in enumerate(ref["steps"]):
        assert [x for r in got for x in r["steps"][i]["losses"]] == step["losses"]
    assert [d for r in got for d in r["digests"]] == ref["digests"]
    # the plane recorded beta's adoption once, in the canary's cohort once;
    # the single controller's read-only lookup recorded nothing
    status = plane.plan_statuses()[key]
    assert status["status"] == "canary" and status["adopters"] == {"beta": alpha.plan_version}
    assert status["cohort"] == ["beta"]
    assert engine_plan_key(alpha)["topology"] == "ranks4"


# -- 3. one autotune plan across processes -----------------------------------------------


def spawn_workers(job, W, tmp_path, *args, timeout=120):
    from helpers import spawn_and_collect

    port, out = str(free_port()), str(tmp_path / job)
    outs = spawn_and_collect([[sys.executable, WORKERS, job, str(p), port, out, *args] for p in range(W)],
                             worker_env(OMP_NUM_THREADS="1"), timeout=timeout)
    for code, stdout, stderr in outs:
        assert code == 0, f"{job} worker failed:\n{stdout}\n{stderr[-4000:]}"
    return [json.load(open(f"{out}.proc{p}.json")) for p in range(W)]


WORKERS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dist_workers.py")
TUNE = {"max_samples": 4, "warmup_time_s": 0.0, "sampling_confidence_time_s": 0.0}


def test_autotune_plan_agrees_across_processes(tmp_path):
    plane = FleetControlPlane(rdzv_kwargs=RDZV, autotune_kwargs=TUNE)
    server = start_fleet_server(plane, 0, host="127.0.0.1")
    try:
        got = spawn_workers("fleet_autotune", 2, tmp_path, f"http://127.0.0.1:{server.server_address[1]}",
                            "tune", "12")
        service = plane.gang("tune").autotune_service()
    finally:
        server.shutdown()
        plane.close()
    assert got[0]["plans"] == got[1]["plans"] and got[0]["versions"] == got[1]["versions"]
    # a proposal was applied (what a step exchanges changed), and both sessions saw the tuning end; the
    # plan it ends on is the best measured one, which may be the first
    assert len(set(got[0]["plans"])) > 1 and got[0]["completed"] and got[1]["completed"]
    assert got[0]["digests"] == got[1]["digests"] and len(set(got[0]["digests"])) == 1
    # no client sends a world size: the plane made the gang's service with a quorum of one
    assert service.world_size == 1 and service._managers["mlp"].sampling_counter == TUNE["max_samples"]


@pytest.mark.parametrize("pkg", ["bagua_tpu", "bagua_tpu_torch"])
def test_gang_autotune_quorum_is_its_first_world_size(pkg):
    """Both packages' per-gang service keeps the first ``world_size`` it is
    made with: one made for two processes never samples once the gang runs
    one process (the reference's behaviour, ROADMAP Queue 3); made without
    one, its quorum is one process, whatever the gang's size."""
    import importlib

    plane_cls = importlib.import_module(f"{pkg}.fleet.control_plane").GangNamespace
    decls = [{"name": f"t{i}", "num_elements": 1024, "dtype": "f32"} for i in range(4)]

    def drive(ns, asking):
        service = ns.autotune_service(world_size=2 if asking == "shrunk" else None)
        ns.autotune_service(world_size=1)  # later calls do not change it
        service.register_tensors({"model_name": "m", "tensor_list": decls})
        for it in range(1, 6):
            service.report_metrics({"model_name": "m", "rank": 0, "train_iter": it, "speed": 100.0 + it})
            service.ask_hyperparameters({"model_name": "m", "rank": 0, "train_iter": it})
        return service.world_size, service._managers["m"].sampling_counter

    kw = dict(autotune_kwargs=TUNE)
    assert drive(plane_cls("g", lambda rec: None, **kw), "shrunk") == (2, 0)
    assert drive(plane_cls("g", lambda rec: None, **kw), "default") == (1, TUNE["max_samples"])


# -- 4. remediation fed by two processes ------------------------------------------------------


def test_remediation_from_two_processes(tmp_path):
    from bagua_tpu.fleet import FleetControlPlane as JaxPlane
    from bagua_tpu.fleet import RemediationEngine as JaxRemediation
    from bagua_tpu.fleet.remediation import _pseudo_dump as jax_pseudo_dump
    from bagua_tpu.observability.flight_recorder import build_hang_report as jax_hang_report
    from bagua_tpu_torch.fleet.remediation import _pseudo_dump
    from bagua_tpu_torch.observability.flight_recorder import build_hang_report, flight_kv_key

    plane = FleetControlPlane(rdzv_kwargs=RDZV)
    server = start_fleet_server(plane, 0, host="127.0.0.1")
    dumps = tmp_path / "dumps"
    dumps.mkdir()
    try:
        got = spawn_workers("fleet_remediation", 2, tmp_path, f"http://127.0.0.1:{server.server_address[1]}",
                            "wedge", str(dumps))
        digests = plane.flight_digests("wedge")
        directive = plane.directive("wedge")
        row = plane.scheduler_view()["gangs"]["wedge"]
    finally:
        server.shutdown()
        plane.close()
    assert [r["fired"] for r in got] == [1, 1] and [r["steps"] for r in got] == [4, 4]
    assert sorted(d["rank"] for d in digests) == [0, 1]
    assert row["verdict"] == "wedged" and row["flight_ranks"] == ["rank0", "rank1"]
    assert row["remediation"]["action"] == "resize"
    (resized,) = got[0]["summary"]["resized"]
    assert resized == {"gang": "wedge", "verdict": "host_wedge", "to_world_size": 1}
    assert directive["action"] == "resize" and directive["detail"]["implicated_ranks"] == [1]
    assert [r["directed"] for r in got] == [1, 1] and all(r["directive"] == directive for r in got)

    # the same digests through the JAX package: the same report and directive
    report = build_hang_report([_pseudo_dump(d) for d in digests])
    assert report == jax_hang_report([jax_pseudo_dump(d) for d in digests])
    assert report["verdict"] == "host_wedge" and report["lagging_ranks"] == [1]
    jplane = JaxPlane(rdzv_kwargs=RDZV)
    try:
        for d in digests:
            jplane.gang("wedge").rendezvous.kv_set(flight_kv_key("0", d["rank"]), d)
        jsummary = JaxRemediation(jplane).sweep()
        assert jplane.directive("wedge") == directive
    finally:
        jplane.close()
    clock_free = [{k: v for k, v in e.items() if k != "ts"} for e in got[0]["summary"]["events"]]
    assert clock_free == [{k: v for k, v in e.items() if k != "ts"} for e in jsummary["events"]]
    assert {k: v for k, v in got[0]["summary"].items() if k != "events"} == \
        {k: v for k, v in jsummary.items() if k != "events"}


# -- chip_smoke.py's [fleet-gang] on gloo --------------------------------------------------


def test_chip_smoke_fleet_gang_runs_on_gloo(one_thread):
    """The card phase's own run, ``chip_smoke.run_fleet_gang``, at the small
    VGG's width on the CPU: two launcher workers of 2 ranks adopt alpha's
    plan, the first attempt exits hard after step 5, the launcher restarts
    the gang from the snapshot at step 4, and every gate holds (the
    kernels' launches and first-launch checks are the card's alone)."""
    import chip_smoke

    entry = chip_smoke.plan_entry(chip_smoke.small_vgg_alpha(CPU))
    got = chip_smoke.run_fleet_gang(CPU, "small-vgg", entry, 2, {})
    assert (got["W"], got["k"], got["buckets"]) == (2, 2, len(entry["names"])) and got["buckets"] > 1
    assert got["resume_bytes"] > 0 and len(got["adopt_ms"]) == len(got["resume_ms"]) == 2


@pytest.mark.parametrize("message", ["EADDRINUSE", "Address already in use"])
def test_chip_smoke_gang_launch_retries_a_taken_port(monkeypatch, capsys, message):
    """A launcher run that loses its port to another process runs again on a
    fresh one, at most twice, each retry on a line of its own; a third loss,
    or any other failure, is the run's."""
    import chip_smoke

    ports = []

    def run(cmd, lose=2, **kwargs):
        ports.append(int(cmd[cmd.index("--master_port") + 1]))
        if len(ports) <= lose:
            return subprocess.CompletedProcess(cmd, 1, "", f"RuntimeError: bind: {message}")
        report = cmd[cmd.index("--report") + 1]
        for p in range(2):
            with open(f"{report}.proc{p}.json", "w") as f:
                json.dump({"process": p, "port": ports[-1]}, f)
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(chip_smoke.subprocess, "run", run)
    got = chip_smoke._gang_workers(CPU, 2, [])
    assert [r["process"] for r in got] == [0, 1] and got[0]["port"] == ports[-1] and len(ports) == 3
    retries = [line for line in capsys.readouterr().out.splitlines() if "retry" in line]
    assert len(retries) == 2 and all("EADDRINUSE" in line for line in retries)
    ports.clear()
    monkeypatch.setattr(chip_smoke.subprocess, "run", lambda cmd, **kw: run(cmd, lose=3, **kw))
    with pytest.raises(AssertionError, match=message):
        chip_smoke._gang_workers(CPU, 2, [])
    assert len(ports) == 3
    ports.clear()
    monkeypatch.setattr(chip_smoke.subprocess, "run",
                        lambda cmd, **kw: (ports.append(0), subprocess.CompletedProcess(cmd, 1, "", "boom"))[1])
    with pytest.raises(AssertionError, match="boom"):
        chip_smoke._gang_workers(CPU, 2, [])
    assert len(ports) == 1


def test_chip_smoke_fleet_gang_retries_a_taken_port(monkeypatch, capsys, one_thread):
    """``run_fleet_gang``'s launcher run that loses its port runs again on a
    fresh port with a fresh plane and snapshot directory, the lost try's
    plane closed and its directory removed before the retry; the last try's
    are torn down too when its run fails for another cause."""
    import chip_smoke
    from bagua_tpu_torch import fleet

    planes, tries = [], []

    class Plane(FleetControlPlane):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.closed = False
            planes.append(self)

        def close(self):
            self.closed = True
            super().close()

    def run(cmd, **kwargs):
        root = os.path.dirname(cmd[cmd.index("--snapshot-dir") + 1])
        tries.append((int(cmd[cmd.index("--master_port") + 1]), root, cmd[cmd.index("--fleet") + 1]))
        assert os.path.isdir(root) and not planes[-1].closed and len(planes) == len(tries)
        assert all(p.closed for p in planes[:-1]) and not any(os.path.exists(t[1]) for t in tries[:-1])
        if len(tries) == 1:
            return subprocess.CompletedProcess(cmd, 1, "", "RuntimeError: bind: Address already in use")
        return subprocess.CompletedProcess(cmd, 1, "", "boom")

    monkeypatch.setattr(fleet, "FleetControlPlane", Plane)
    monkeypatch.setattr(chip_smoke.subprocess, "run", run)
    entry = chip_smoke.plan_entry(chip_smoke.small_vgg_alpha(CPU))
    with pytest.raises(AssertionError, match="the launcher exited 1:\nboom"):
        chip_smoke.run_fleet_gang(CPU, "small-vgg", entry, 2, {})
    assert len(tries) == len(planes) == 2 and tries[0][1] != tries[1][1]
    assert all(p.closed for p in planes) and not any(os.path.exists(t[1]) for t in tries)
    retries = [line for line in capsys.readouterr().out.splitlines() if "retry" in line]
    assert len(retries) == 1 and "[fleet-gang]" in retries[0] and "retry 1 of 2" in retries[0]
