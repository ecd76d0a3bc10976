"""The CI lanes' gates on the card: ``[ci-bench]``'s codec launches, and the
QAdam settings the benchmark gate takes at VGG16.

These tests need a CUDA device and skip without one; they import neither
JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ci_cuda.py

They run ``chip_smoke.py``'s own check: the benchmark gate
(``bagua_tpu_torch/tools/benchmark_check.py``) at full-width VGG16 over 4
ranks of the card, ``intra_size=1``, for the algorithms that compress
(ByteGrad, low-precision decentralized, QAdam): two runs each with the same
final loss bitwise, img/s a card over the reference's floors, and rows 1-3
launched exactly (runs x steps x buckets x the algorithm's count a bucket).
"""

import math

import pytest
import torch

import chip_smoke
from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.tools import benchmark_check


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda", 0)


@pytest.mark.cuda
def test_ci_bench_codec_launches_exact_on_card(cuda_device):
    got = chip_smoke.check_ci_bench_on_card(cuda_device, ["bytegrad", "low_precision_decentralized", "qadam"])
    launches = got["launches"]
    assert launches["compress_minmax_uint8"] > 0 and launches["decompress_reduce_requantize"] > 0
    assert got["cards"] == 1
    for name, r in got["results"].items():
        assert r["losses"][0] == r["losses"][1], name


@pytest.mark.cuda
def test_qadam_at_the_jax_lanes_lr_and_eps_runs_away_at_full_width_vgg16(cuda_device):
    """Why the lane's VGG16 QAdam takes lr 1e-5 and eps 1e-3
    (``benchmark_check.QADAM``): at the JAX lane's lr 1e-3 and eps 1e-8 the
    gate's run at full width (224 x 224, 1000 classes, bf16, 32 a rank, 4
    ranks of the card, ``intra_size=1``) ends on a loss that is not finite."""
    group = BaguaProcessGroup([cuda_device] * chip_smoke.RANKS, intra_size=1)
    workload = benchmark_check.build_workload("vgg16", cuda_device)
    got = benchmark_check.run_once(group, workload, "qadam", batch=benchmark_check.DEFAULT_BATCH["vgg16"],
                                   qadam={"lr": 1e-3, "eps": 1e-8})
    print(f"QAdam at lr 1e-3, eps 1e-8, VGG16 full width: {got}")
    assert not math.isfinite(got["loss"]), got
