"""The decentralized family on a group that spans OS processes: gloo
gangs on the CPU (``examples/gang.py``, one spawn a layout running every
case in turn).

The small VGG (``gang.SMALL_VGG``) on the legacy mesh with
``intra_size=1``, so every exchange crosses processes: decentralized SGD
(``"all"`` and ``"shift_one"``, monolithic and with overlap), low-precision
decentralized (monolithic and overlap), QAdam (warmup 2, eps 1e-3: the
smoke run's setting, ``chip_smoke.QADAM``), stale τ 2 and gossip τ 1
(``"all"`` and ``"shift_one"``) with the degradation directive on rank 2,
which lives in another process than rank 0, and
``GradientAccumulation(ByteGrad, every=2)``; 4 KiB buckets, 1 + 3 steps.
Layouts: W 2 x k 2 and W 4 x k 1.  Tolerance: none; every process's
parameters are bitwise the single-controller 4-rank run's rows on the same
global batch.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.examples import gang

from helpers import REPO_ROOT, free_port, worker_env

GANG = os.path.join(REPO_ROOT, "bagua_tpu_torch", "examples", "gang.py")
CPU = torch.device("cpu")
QADAM = {"lr": 1e-3, "warmup_steps": 2, "eps": 1e-3}
CASES = {
    "decentralized all": ["decentralized", {"peer_selection_mode": "all"}, "off"],
    "decentralized shift_one": ["decentralized", {"peer_selection_mode": "shift_one"}, "off"],
    "decentralized shift_one (overlap)": ["decentralized", {"peer_selection_mode": "shift_one"}, "on"],
    "low-precision decentralized": ["low_precision_decentralized", {}, "off"],
    "low-precision decentralized (overlap)": ["low_precision_decentralized", {}, "on"],
    "QAdam": ["qadam", {"optimizer": QADAM}, "off"],
    "stale τ=2, rank 2 stale": ["stale", {"staleness_tau": 2, "directive": [2]}, "off"],
    "gossip all τ=1, rank 2 stale": ["decentralized", {"hierarchical": False, "staleness_tau": 1,
                                                        "directive": [2]}, "off"],
    "gossip shift_one τ=1, rank 2 stale": ["decentralized", {"hierarchical": False, "peer_selection_mode": "shift_one",
                                                              "staleness_tau": 1, "directive": [2]}, "off"],
    "GradientAccumulation(ByteGrad, every=2)": ["grad_accumulation", {"inner": "bytegrad", "every": 2}, "off"],
}
ARGS = ["--model", "small-vgg", "--intra-size", "1", "--warmup", "1", "--steps", "3", "--bucket-bytes", "4096"]


@pytest.fixture()
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    done = {}

    def get(W):
        if W not in done:
            out = str(tmp_path_factory.mktemp(f"dec-W{W}") / "r")
            port = str(free_port())
            args = ARGS + ["--ranks-per-process", str(4 // W), "--cases", json.dumps(list(CASES.values()))]
            procs = [subprocess.Popen([sys.executable, GANG, "--device", "cpu", "--report", out] + args,
                                      env=worker_env(OMP_NUM_THREADS="1", RANK=str(p), LOCAL_RANK=str(p),
                                                     WORLD_SIZE=str(W), MASTER_ADDR="127.0.0.1", MASTER_PORT=port),
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for p in range(W)]
            try:
                for p in procs:
                    _, err = p.communicate(timeout=240)
                    assert p.returncode == 0, err[-4000:]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            done[W] = [json.load(open(f"{out}.proc{p}.json")) for p in range(W)]
        return done[W]
    return get


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("W", [2, 4])
def test_decentralized_family_gang_is_bitwise_the_stacked_group(gangs, W, case, one_thread):
    reports = [r[list(CASES).index(case)] for r in gangs(W)]
    algorithm, kwargs, overlap = CASES[case]
    k = 4 // W
    assert all((r["processes"], r["local_ranks"], r["algorithm"]) == (W, k, algorithm) for r in reports)
    ref = gang.run_case(BaguaProcessGroup([CPU] * 4, intra_size=1), "small-vgg", algorithm, kwargs,
                        {"on": True, "off": False}[overlap], steps=3, warmup=1, bucket_size_bytes=4096,
                        processes=W)
    assert reports[0]["overlap"] == ref["overlap"] and reports[0]["buckets"] == ref["buckets"]
    assert [d for r in reports for d in r["digests"]] == ref["digests"]
    # every process sent bytes to the others each step
    assert all(r["wire_bytes_per_step"]["to_other_processes"] > 0 for r in reports)
