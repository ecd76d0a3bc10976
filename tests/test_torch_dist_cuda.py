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

The twin paths of ``chip_smoke.py``'s ``[dist]`` at small width, the same
way (a gang of one over NCCL on one card): path (a), the Llama twin's
hand-scheduled tp 2 x sp 2 zigzag step with the Row projections fused
(the flash-attention kernels and the tile GEMM), and path (b), the GPT
twin's engine at dp 4 x tp 2 (``gradient_allreduce`` with overlap); each
process's parameters bitwise the single controller's rows, the launches
equal, and each first launch of rows 6-9 within its tolerance of the plain
version; path (a)'s first-step losses within 1e-5 relative of the unfused
model's (``tp_fused`` off).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.examples import gang
from bagua_tpu_torch.mesh import MeshSpec

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


TWIN_PATHS = {
    "a": ("small-llama", {"dp": 1, "tp": 2, "sp": 2}, ["stacked", {"tp_fused": True}, "auto"]),
    "b": ("small-gpt", {"dp": 4, "tp": 2}, ["gradient_allreduce", {"blocks_per_stage": 2}, "auto"]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(TWIN_PATHS))
def test_nccl_twin_gang_is_bitwise_the_single_controller_run(cuda_device, path, tmp_path):
    model, mesh, case = TWIN_PATHS[path]
    size = MeshSpec(mesh).size
    W = max(w for w in (4, 2, 1) if w <= torch.cuda.device_count() and size % w == 0)
    k = size // W
    out = str(tmp_path / "gang")
    cmd = [sys.executable, "-m", "bagua_tpu_torch.distributed.run", "--nproc_per_node", str(W),
           "--max_restarts", "0", "--monitor_interval", "0.2", "--master_port", str(free_port()),
           os.path.join(REPO_ROOT, "bagua_tpu_torch", "examples", "gang.py"), "--device", "cuda",
           "--model", model, "--mesh", json.dumps(mesh), "--steps", "2", "--cases", json.dumps([case]),
           "--report", out]
    run = subprocess.run(cmd, env=worker_env(), cwd=REPO_ROOT, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-6000:]
    reports = [json.load(open(f"{out}.proc{p}.json"))[0] for p in range(W)]
    ref = gang.run_case(BaguaProcessGroup([cuda_device] * size, mesh_spec=MeshSpec(mesh)), model, *case, steps=2,
                        warmup=1)
    for p, r in enumerate(reports):
        assert r["device"].startswith("cuda") and (r["processes"], r["local_ranks"]) == (W, k)
        assert r["digests"] == ref["digests"][p * k:(p + 1) * k], f"process {p}"
        assert r["launches"] == ref["launches"]
        assert all(h.get("within", h["bitwise"]) for h in r["held"].values()), r["held"]
    if path == "a":
        assert set(reports[0]["held"]) == {"block_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                                           "matmul_tile"}
        # the fused Row layers against the psum path: the first step's losses
        unfused = gang.run_case(BaguaProcessGroup([cuda_device] * size, mesh_spec=MeshSpec(mesh)), model,
                                case[0], {**case[1], "tp_fused": False}, case[2], steps=0, warmup=1)
        assert np.allclose(ref["losses"][0], unfused["losses"][0], rtol=1e-5, atol=0.0), (ref["losses"][0],
                                                                                           unfused["losses"][0])
