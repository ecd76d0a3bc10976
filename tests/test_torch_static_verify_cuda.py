"""The static gate on the card.

These tests need a CUDA device and skip without one; they import neither
JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_static_verify_cuda.py

They run ``chip_smoke.py``'s own checks: every kernel wrapper hands a meta
tensor to its plain version (shapes only, no launch counted, nothing
allocated on the card) and still launches its kernel on a CUDA tensor; and
the strict gate of a CUDA engine (the small VGG, every ``VERIFY_PATHS``
wire) allocates nothing on the card and launches nothing, then the real
step launches exactly its kernels.
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
def test_meta_tensors_take_the_plain_versions_on_card(cuda_device):
    # one call a kernel of chip_smoke.KERNELS (the hop once for each width)
    assert chip_smoke.check_meta_wrappers_on_card(cuda_device) == len(chip_smoke.KERNELS) == 11


@pytest.mark.cuda
def test_gate_allocates_and_launches_nothing_on_card(cuda_device):
    gates = chip_smoke.check_gate_on_card(cuda_device)
    assert set(gates) == set(chip_smoke.VERIFY_PATHS)
