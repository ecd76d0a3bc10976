"""The observability layer on the card: the profiler-trace join and the
engine's inertness.

These tests need a CUDA device and skip without one; they import neither
JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_observability_cuda.py

They run ``chip_smoke.py``'s own checks: one traced ByteGrad overlap step
of the small VGG, whose CUDA kernels ``analyze_trace`` joins to the
``record_function`` labels of their launches (every bucket a
``per_bucket`` row, none unattributed, and the labeled exchange kernels
covering at least ``OBS_COVERAGE`` of the exchange stream's busy time);
and every observability knob on against off on the small VGG (ByteGrad,
the int8 ring and ZeRO, overlap, cuDNN deterministic), bitwise.
"""

import pytest
import torch

import chip_smoke
from bagua_tpu_torch.tools import benchmark_check


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda", 0)


@pytest.mark.cuda
def test_trace_join_covers_the_exchange_stream(cuda_device):
    seen = chip_smoke.check_trace_join_on_card(cuda_device)
    assert seen["side"]["coverage"] >= chip_smoke.OBS_COVERAGE
    assert all(row["spans"] > 0 for row in seen["analysis"]["per_bucket"])


@pytest.mark.cuda
def test_observability_is_bitwise_inert_on_card(cuda_device):
    with benchmark_check.deterministic():
        chip_smoke.check_obs_inert_on_card(cuda_device)
