"""The fleet's plan adoption and SyncBatchNorm on the card.

These tests need a CUDA device and skip without one; they import neither
JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fleet_cuda.py

They run ``chip_smoke.py``'s own checks: a small VGG's ByteGrad plan
published to an in-process fleet plane by one gang and adopted at step 0
by another, whose steps then launch rows 1-3 exactly at the adopted
plan's bucket count; and the small ResNet with ``sync_bn=True`` on the
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
