"""The fleet's plan adoption, a fleet gang under the launcher and
SyncBatchNorm on the card.

These tests need a CUDA device and skip without one; they import neither
JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fleet_cuda.py

They run ``chip_smoke.py``'s own checks: a small VGG's ByteGrad plan
published to an in-process fleet plane by one gang and adopted at step 0
by another, whose steps then launch rows 1-3 exactly at the adopted
plan's bucket count; ``[fleet-gang]``'s drive at the small VGG's width
(one launcher worker adopting the plan, exiting hard and resuming); and
the small ResNet with ``sync_bn=True`` on the
card against the CPU (f64 gradients and statistics under a ``vmap`` over
the ranks, the statistics the same on every rank, f32 engine steps).
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
def test_adopted_plan_launches_its_buckets_on_card(cuda_device):
    got = chip_smoke.check_fleet_adoption_on_card(cuda_device)
    assert got["adopted"] != got["fresh"]
    assert got["launches"]["compress_minmax_uint8"] == 2 * got["adopted"]


@pytest.mark.cuda
def test_sync_bn_resnet_on_card(cuda_device):
    readings = chip_smoke.check_sync_resnet_on_card(cuda_device)
    assert readings["vs_cpu"] <= chip_smoke.SMALL_RESNET_SHARE


@pytest.mark.cuda
def test_fleet_gang_on_card(cuda_device):
    """``[fleet-gang]`` at the small VGG's width: one launcher worker on the
    card adopts the plan, exits hard after step 5 and resumes from step 4;
    rows 1-3 launched exactly over both attempts, bitwise the single
    controller."""
    entry = chip_smoke.plan_entry(chip_smoke.small_vgg_alpha(cuda_device))
    got = chip_smoke.run_fleet_gang(cuda_device, "small-vgg", entry, 1, chip_smoke.SLICE_PATHS["ByteGrad"][1])
    steps = chip_smoke.FLEET_GANG_CRASH + chip_smoke.FLEET_GANG_STEPS - chip_smoke.FLEET_GANG_EVERY
    assert got["buckets"] > 1 and got["launches"]["compress_minmax_uint8"] == steps * got["buckets"]
