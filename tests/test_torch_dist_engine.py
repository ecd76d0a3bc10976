"""The engine on a group that spans OS processes: gloo gangs on the CPU.

(a) The JAX package's own two-process DDP case (``tests/test_multiprocess.py
:60-137``): 2 processes x 4 ranks, the MLP ``[12, 16, 4]``, SGD 0.05,
hierarchical ``gradient_allreduce`` (intra inside a process, inter across),
each process feeding its own rows (``RandomState(100 + p)``) through
``shard_batch``, 3 steps.  The gang's parameters are bitwise the port's
single-controller group's on the same global batch, and the same across
processes; the port's agree with the JAX package's single-controller engine
on 8 CPU devices within ``tests/test_torch_slice.py``'s f32 bound (atol
1e-5: summation order only).  The JAX package's own two-process run cannot
be the oracle: this jaxlib refuses cross-process computations on the CPU.

(b) The small VGG at 4 processes x 1 rank (``intra_size=1``): f32
``gradient_allreduce``, ByteGrad monolithic and with overlap, the int8 and
int4 rings and ZeRO over the int8 ring, each bitwise the single-controller
group (ring blocks of 16, buckets of 4 KiB, so several buckets and blocks).

(c) Async model average with one process aborted: both negotiate "not
ready" on the first cycle and "ready" on the next, in the same order, and
the delta is bitwise the stacked AVG allreduce minus the parameters.  With
the averager threads cycling on their own, a process that stops first
takes its peer's averager with it in one negotiated round.

(d) ``agreed_resume_step`` across 2 processes, each writing its own
``proc<p>.npz``: a lagging process's view wins, the resumed state is
bitwise the snapshot's step, and the resumed momentum carries on to the
uninterrupted run's bits.

(e) The launcher (``python -m bagua_tpu_torch.distributed.run
--nproc_per_node 2``) forms the gang from its environment, the gang view's
summaries go through the rendezvous KV with process 0 collecting, a
failed worker restarts the gang, and too many failures stop it.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from bagua_tpu.algorithms.gradient_allreduce import GradientAllReduceAlgorithm as JaxGAR
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP
from bagua_tpu.models import mlp as jax_mlp

from bagua_tpu_torch.communication import BaguaProcessGroup, ReduceOp, allreduce
from bagua_tpu_torch.distributed import rendezvous as rdzv
from bagua_tpu_torch.examples import gang
from bagua_tpu_torch.utils import tree_leaves

from helpers import REPO_ROOT, free_port, spawn_and_collect, worker_env

WORKERS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dist_workers.py")
GANG = os.path.join(REPO_ROOT, "bagua_tpu_torch", "examples", "gang.py")
CPU = torch.device("cpu")


@pytest.fixture()
def one_thread():
    """The stacked reference computes on one thread, as each gang worker
    does: a CPU convolution's reduction order depends on the thread count,
    and the bitwise contract is about the collectives, given the same
    per-rank arithmetic."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def spawn_gang(W, args, tmp_path, timeout=240, **env):
    """``gang.py`` as W processes of a gloo gang; returns each process's
    reports."""
    port, out = str(free_port()), str(tmp_path / "gang")
    cmds, envs = [], []
    for p in range(W):
        cmds.append([sys.executable, GANG, "--device", "cpu", "--report", out] + args)
    procs = [subprocess.Popen(c, env=worker_env(OMP_NUM_THREADS="1", RANK=str(p), LOCAL_RANK=str(p),
                                                 WORLD_SIZE=str(W), MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                                                 **env),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for p, c in enumerate(cmds)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [json.load(open(f"{out}.proc{p}.json")) for p in range(W)]


def spawn_workers(job, W, tmp_path, *args, timeout=240):
    port, out = str(free_port()), str(tmp_path / job)
    outs = spawn_and_collect([[sys.executable, WORKERS, job, str(p), port, out, *args] for p in range(W)],
                             worker_env(OMP_NUM_THREADS="1"), timeout=timeout)
    for code, stdout, stderr in outs:
        assert code == 0, f"{job} worker failed:\n{stdout}\n{stderr[-4000:]}"
    return out


# -- (a) the reference's two-process case ------------------------------------------


def test_reference_two_process_mlp_case(group, tmp_path, one_thread):
    jparams = jax.tree.map(np.asarray, jax_mlp.init_mlp(jax.random.PRNGKey(0), gang.MLP_SIZES))
    npz = tmp_path / "mlp.npz"
    np.savez(npz, **{f"{layer}.{leaf}": a for layer, leaves in jparams.items() for leaf, a in leaves.items()})
    case = ["gradient_allreduce", {"hierarchical": True}, "auto"]
    reports = spawn_gang(2, ["--model", "mlp", "--params", str(npz), "--ranks-per-process", "4",
                             "--intra-size", "4", "--cases", json.dumps([case]), "--steps", "2"], tmp_path)
    got = [d for r in reports for d in r[0]["digests"]]
    assert [r[0]["local_ranks"] for r in reports] == [4, 4] and len(set(got)) == 1

    tgroup = BaguaProcessGroup([CPU] * 8, intra_size=4)
    stacked = gang.run_case(tgroup, "mlp", *case, steps=2, warmup=1, params_npz=str(npz), processes=2,
                            keep_state=True)
    assert got == stacked["digests"]

    _, _, _, _, batch_of = gang.build_model("mlp", CPU)
    ddp = JaxDDP(jax_mlp.mse_loss, optax.sgd(0.05), JaxGAR(hierarchical=True), process_group=group)
    jstate = ddp.init(jparams)
    for step in range(3):
        rows = [batch_of(p, 4, 2, step) for p in range(2)]
        batch = tuple(np.concatenate([r[i].numpy() for r in rows]) for i in range(2))
        jstate, _ = ddp.train_step(jstate, batch)
    want = jax.tree.leaves(ddp.params_unstacked(jstate))
    for t, w in zip(tree_leaves(stacked["state"].params), want):
        np.testing.assert_allclose(t[0].numpy(), np.asarray(w), rtol=0, atol=1e-5)


# -- (b) every wire at 4 x 1 ----------------------------------------------------------

WIRES = {
    "f32": ["gradient_allreduce", {}, "off"],
    "bytegrad": ["bytegrad", {}, "off"],
    "bytegrad-overlap": ["bytegrad", {}, "on"],
    "int8-ring": ["gradient_allreduce", {"wire_precision": "int8"}, "auto"],
    "int4-ring": ["gradient_allreduce", {"wire_precision": "int4"}, "off"],
    "zero-int8": ["zero", {"wire_precision": "int8"}, "auto"],
}
VGG_ARGS = ["--model", "small-vgg", "--intra-size", "1", "--steps", "2", "--bucket-bytes", "4096"]


@pytest.fixture(scope="module")
def vgg_gang(tmp_path_factory):
    return spawn_gang(4, VGG_ARGS + ["--cases", json.dumps(list(WIRES.values()))],
                      tmp_path_factory.mktemp("vgg"), BAGUA_QR_BLOCK="16")


@pytest.mark.parametrize("wire", list(WIRES))
def test_small_vgg_gang_is_bitwise_the_stacked_group(vgg_gang, wire, monkeypatch, one_thread):
    monkeypatch.setenv("BAGUA_QR_BLOCK", "16")
    i = list(WIRES).index(wire)
    algorithm, kwargs, overlap = WIRES[wire]
    reports = [r[i] for r in vgg_gang]
    assert all(r["algorithm"] == algorithm and r["algorithm_kwargs"] == kwargs for r in reports)
    assert all(r["overlap"] is {"on": True, "off": False}.get(overlap, r["overlap"]) for r in reports)
    assert reports[0]["buckets"] > 2
    stacked = gang.run_case(BaguaProcessGroup([CPU] * 4, intra_size=1), "small-vgg", algorithm, kwargs,
                            {"on": True, "off": False}.get(overlap, overlap), steps=2, warmup=1,
                            bucket_size_bytes=4096, processes=4)
    assert stacked["overlap"] == reports[0]["overlap"]
    assert [r["digests"][0] for r in reports] == stacked["digests"]
    # every process sent bytes to the others each step
    assert all(r["wire_bytes_per_step"]["to_other_processes"] > 0 for r in reports)


def test_init_refuses_different_weights_on_different_processes(tmp_path):
    out = spawn_workers("init_mismatch", 2, tmp_path)
    for p in range(2):
        assert "different parameters on different processes" in json.load(open(f"{out}.proc{p}.json"))["raised"]


def test_no_devices_on_several_cards_names_the_launcher(monkeypatch):
    """One process drives one card: with several visible and no devices
    given, the default group raises and names the launcher command."""
    from bagua_tpu_torch import communication

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(communication, "_default_group", None)
    with pytest.raises(RuntimeError, match="distributed.run --nproc_per_node"):
        communication.init_process_group()
    with pytest.raises(NotImplementedError, match="distributed.run --nproc_per_node"):
        BaguaProcessGroup([torch.device("cuda", 0), torch.device("cuda", 1)])


def test_gang_holds_each_first_launch_against_its_plain_version():
    """What a wrapper records on the card (``kernels._build.witness``, here
    called by hand with CPU tensors) is held against the plain version on
    the same operands: an exact output holds, a perturbed one does not, a
    second launch of a kernel is not recorded, and recording stops on
    leaving."""
    from bagua_tpu_torch.kernels import _build
    from bagua_tpu_torch.kernels import minmax_uint8 as mm8
    from bagua_tpu_torch.kernels import quantized_ring as qr

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(3, 64).astype(np.float32))
    q, mm = mm8.compress_minmax_uint8_plain(x)
    local = torch.from_numpy(rng.randn(3, 64).astype(np.float32))
    hop = qr.hop_dequant_add_requant_plain(q, mm, local, 8)
    held = {}
    with gang.held_against_plain(held):
        _build.witness("compress_minmax_uint8", (x,), (q, mm))
        _build.witness("compress_minmax_uint8", (x,), (q, mm + 1))
        _build.witness("decompress_minmax_uint8", (q, mm), (mm8.decompress_minmax_uint8_plain(q, mm) + 1e-3,))
        _build.witness("hop_dequant_add_requant_int8", (q, mm, local, 8), hop)
    assert _build.WITNESS is None
    assert set(held) == {"compress_minmax_uint8", "decompress_minmax_uint8", "hop_dequant_add_requant_int8"}
    assert held["compress_minmax_uint8"] == {"shapes": [[3, 64]], "max_abs_err": 0.0, "bitwise": True}
    assert held["hop_dequant_add_requant_int8"]["bitwise"]
    assert not held["decompress_minmax_uint8"]["bitwise"]
    assert held["decompress_minmax_uint8"]["max_abs_err"] == pytest.approx(1e-3, rel=1e-2)


# -- (c) async model average's abort negotiation ----------------------------------


def test_async_abort_is_negotiated_across_processes(tmp_path):
    out = spawn_workers("async_abort", 2, tmp_path)
    reports = [json.load(open(f"{out}.proc{p}.json")) for p in range(2)]
    for r in reports:
        assert r["negotiated"] == [False, True]
        assert r["after_abort_pending_empty"]
    arrays = [np.load(f"{out}.proc{p}.npz") for p in range(2)]
    group = BaguaProcessGroup([CPU] * 4, intra_size=2)
    for name in reports[0]["averaged"]:
        full = torch.from_numpy(np.concatenate([a["param" + name] for a in arrays]))
        want = allreduce(full, ReduceOp.AVG, group) - full
        got = np.concatenate([a["delta" + name] for a in arrays])
        assert np.array_equal(got.view(np.uint32), want.numpy().view(np.uint32)), name


def test_async_averager_threads_cycle_and_stop_together(tmp_path):
    """The averager threads themselves drive the rounds (every 5 ms), and a
    process that stops first takes its peer's averager with it: both
    threads end within the join timeout, in the same rounds."""
    from bagua_tpu_torch.algorithms.async_model_average import JOIN_TIMEOUT_S

    out = spawn_workers("async_threaded", 2, tmp_path)
    reports = [json.load(open(f"{out}.proc{p}.json")) for p in range(2)]
    for r in reports:
        assert r["folds"] >= 2 and r["failed"] == 0 and r["finite"], r
        assert r["left"] and not r["thread_alive"] and r["shutdown_s"] < JOIN_TIMEOUT_S, r
        assert r["negotiated"][-1] is False and True in r["negotiated"]
    assert reports[0]["negotiated"] == reports[1]["negotiated"]


# -- (d) the resume agreement ---------------------------------------------------------


def test_resume_agreement_across_processes(tmp_path):
    server_port = free_port()
    server = rdzv.start_rendezvous_server(rdzv.RendezvousState(min_nodes=1, settle_s=0.05), server_port,
                                          host="127.0.0.1")
    try:
        out = spawn_workers("resume_agree", 2, tmp_path, str(tmp_path / "snap"), f"127.0.0.1:{server_port}")
    finally:
        server.shutdown()
    reports = [json.load(open(f"{out}.proc{p}.json")) for p in range(2)]
    for r in reports:
        assert r["cold_start"] and r["files_step4"] == ["manifest.json", "proc0.npz", "proc1.npz"]
        assert r["agreed"] == 2  # process 1's scan saw step 2 only
        assert r["digests_resumed"] == r["digests_at2"] and r["digests_at2"] != r["digests_at4"]
        assert r["digests_resumed_at4"] == r["digests_at4"]
    assert reports[0]["digests_at4"] == reports[1]["digests_at4"]


# -- (e) the launcher and the gang view -------------------------------------------------


def run_launcher(tmp_path, mode, max_restarts):
    server_port = free_port()
    server = rdzv.start_rendezvous_server(rdzv.RendezvousState(min_nodes=1, settle_s=0.05), server_port,
                                          host="127.0.0.1")
    out = str(tmp_path / "launched")
    cmd = [sys.executable, "-m", "bagua_tpu_torch.distributed.run", "--nproc_per_node", "2",
           "--max_restarts", str(max_restarts), "--monitor_interval", "0.2", "--master_port", str(free_port()),
           WORKERS, "launched", out, f"127.0.0.1:{server_port}", mode]
    try:
        r = subprocess.run(cmd, env=worker_env(OMP_NUM_THREADS="1"), capture_output=True, text=True,
                           timeout=180, cwd=REPO_ROOT)
    finally:
        server.shutdown()
    return r, out


@pytest.mark.parametrize("mode", ["ok", "fail_once"])
def test_launcher_forms_the_gang_and_the_gang_view(tmp_path, mode):
    r, out = run_launcher(tmp_path, mode, max_restarts=2)
    assert r.returncode == 0, r.stderr[-4000:]
    reports = [json.load(open(f"{out}.proc{p}.json")) for p in range(2)]
    attempt = "0" if mode == "ok" else "1"
    for p, rep in enumerate(reports):
        assert rep["size"] == 4 and rep["spans"] and rep["world"] == 2 and rep["attempt"] == attempt
        assert rep["sum"] == [2.0, 2.0]  # 0 + 0 + 1 + 1 over the gang's four ranks
    view = reports[0]["view"]
    assert view["ranks_reporting"] == 2 and [s["rank"] for s in view["ranks"]] == [0, 1]
    assert view["straggler"]["rank"] == 1  # p50 30 ms against a median of 20
    assert reports[1]["view"] is None


def test_launcher_exceeds_max_restarts(tmp_path):
    r, _ = run_launcher(tmp_path, "fail_always", max_restarts=1)
    assert r.returncode == 1
    assert "exceeded max_restarts" in r.stderr + r.stdout
