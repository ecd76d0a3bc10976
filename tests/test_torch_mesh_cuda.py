"""Named meshes on the card against the CPU.

These tests need a CUDA device and skip without one; they import neither
JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mesh_cuda.py

They run ``chip_smoke.py``'s own ``[mesh-ref]`` checks, whose docstrings
give the tolerances: the small VGG on ``MeshSpec({"dp": 4})`` bitwise the
legacy 4-rank group and the two columns of ``dp 4 x tp 2`` bitwise that
run (f32, the int8 ring, flat ByteGrad; monolithic and overlap), and each
twin's engine mode on ``dp 4 x tp 2`` (overlap) and ``dp 4 x fsdp 2``
(ZeRO) against the CPU.  On ``dp 4 x tp 2`` the check also reads every
collective's axes: the overlap hooks run on autograd's own thread on the
card, and an exchange issued there must still ride ``("dp",)`` only.
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
def test_mesh_replicas_on_card(cuda_device):
    launches = chip_smoke.check_mesh_replicas_on_card(cuda_device)
    assert launches[("int8 ring", True)]["hop_dequant_add_requant_int8"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(chip_smoke.MESH_ENGINE_REF))
@pytest.mark.parametrize("twin", sorted(chip_smoke.MESH_TWINS))
def test_engine_mode_on_card_matches_cpu(cuda_device, twin, config):
    seen = chip_smoke.check_mesh_engine_on_card(cuda_device, twin, config)
    assert seen["exchange"] > 0
    if config == "dp 4 x tp 2":
        assert seen["hooks"] > 0  # the exchange from autograd's thread rode dp
