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
run.
"""

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
