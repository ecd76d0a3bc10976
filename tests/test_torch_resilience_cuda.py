"""Snapshots and resumes on the card.

These tests need a CUDA device and skip without one; they import neither
JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_resilience_cuda.py

They run ``chip_smoke.py``'s own checks on the small VGG (cuDNN
deterministic, SGD with momentum): a cadence snapshot, whose clone is
copied to pinned host memory on a side stream, holds the state of the step
it was taken at even though the next step has already updated the
parameters in place; and a drained resume (and a checkpoint resume) of
ByteGrad, the int8 ring and ZeRO ends bitwise equal to the uninterrupted
run.  The fault-injection lane (``python -m
bagua_tpu_torch.tools.fault_injection``, on the card by default) drains and
kills a one-process gang of four ranks on the card, each resumed run
bitwise the uninterrupted one.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import chip_smoke


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda", 0)


@pytest.mark.cuda
def test_side_stream_snapshot_holds_its_own_step(cuda_device, tmp_path):
    with chip_smoke._deterministic():
        assert chip_smoke.check_snapshot_copy_on_card(cuda_device, str(tmp_path)) > 0


@pytest.mark.cuda
def test_drained_resume_is_bitwise_on_card(cuda_device):
    with chip_smoke._deterministic():
        seen = chip_smoke.check_resil_on_card(cuda_device)
    assert ("ByteGrad", "snapshot") in seen and ("ByteGrad", "checkpoint") in seen


@pytest.mark.cuda
def test_fault_injection_lane_on_card(cuda_device, tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([repo] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    run = subprocess.run([sys.executable, "-m", "bagua_tpu_torch.tools.fault_injection", "--workdir",
                          str(tmp_path / "lane")], env=env, cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    report = json.load(open(tmp_path / "lane" / "RESILIENCE.json"))
    lane = report["fault_injection"]
    assert lane["device"] == report["overhead"]["device"] == "cuda"
    assert lane["processes"] == 1 and lane["bitwise_identical"] and lane["lost_steps"] <= lane["snapshot_every"]
    assert lane["scenarios"]["preempt"]["lost_steps"] == 0
    print(json.dumps(report["overhead"]))
