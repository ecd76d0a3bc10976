"""A gang of processes over NCCL on the card(s).

These tests need a CUDA device and skip without one; they import neither
JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dist_cuda.py

``W = torch.cuda.device_count()`` workers (at most 4, a divisor of 4)
start through the launcher (``--nproc_per_node W``) and run
``examples/gang.py`` on the small VGG: ``4 / W`` ranks a process on
``cuda:LOCAL_RANK`` (``intra_size=1``), 4 KiB buckets, 1 + 2 steps, cuDNN
deterministic, the gang formed over NCCL even at W = 1.  Each process's
parameters must be bitwise the single-controller 4-rank run's rows on
``cuda:0`` (this process, cuDNN deterministic) under f32
``gradient_allreduce`` and ByteGrad, and the codec kernels bitwise their
plain versions at the gang's shapes.
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

WIRES = {"f32": ["gradient_allreduce", {}, "off"], "bytegrad": ["bytegrad", {}, "on"]}


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield torch.device("cuda", 0)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


@pytest.mark.cuda
@pytest.mark.parametrize("wire", list(WIRES))
def test_nccl_gang_is_bitwise_the_single_controller_run(cuda_device, wire, tmp_path):
    W = max(w for w in (4, 2, 1) if w <= torch.cuda.device_count())
    k = 4 // W
    out = str(tmp_path / "gang")
    cmd = [sys.executable, "-m", "bagua_tpu_torch.distributed.run", "--nproc_per_node", str(W),
           "--max_restarts", "0", "--monitor_interval", "0.2", "--master_port", str(free_port()),
           os.path.join(REPO_ROOT, "bagua_tpu_torch", "examples", "gang.py"), "--device", "cuda",
           "--model", "small-vgg", "--ranks-per-process", str(k), "--intra-size", "1", "--steps", "2",
           "--bucket-bytes", "4096", "--cases", json.dumps([WIRES[wire]]), "--report", out]
    run = subprocess.run(cmd, env=worker_env(), cwd=REPO_ROOT, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-6000:]
    reports = [json.load(open(f"{out}.proc{p}.json"))[0] for p in range(W)]
    algorithm, kwargs, overlap = WIRES[wire]
    ref = gang.run_case(BaguaProcessGroup([cuda_device] * 4, intra_size=1), "small-vgg", algorithm, kwargs,
                        overlap == "on", steps=2, warmup=1, bucket_size_bytes=4096, processes=W)
    for p, r in enumerate(reports):
        assert r["device"].startswith("cuda") and (r["processes"], r["local_ranks"]) == (W, k)
        assert r["digests"] == ref["digests"][p * k:(p + 1) * k], f"process {p}"
        assert r["launches"] == ref["launches"]
        assert all(h["bitwise"] for h in r["held"].values()), r["held"]
    if wire == "bytegrad":
        assert set(reports[0]["held"]) == {"compress_minmax_uint8", "decompress_minmax_uint8",
                                           "decompress_reduce_requantize"}
