"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one.  They import neither
JAX nor the JAX package, so they run where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from bagua_tpu_torch.kernels import minmax_uint8 as port


@pytest.fixture()
def cuda_device():
    """The card, decided when the test runs; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for fn in port.KERNELS:
        fn.launches = 0
    return torch.device("cuda", 0)


def bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 65539), (4, 4096), (3, 7), (8, 4095), (2, 40000)])
def test_kernels_match_plain(cuda_device, shape):
    """Each kernel equals its plain version bitwise, and each wrapper
    counts one launch per call."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda_device) * 3.0
    q, mm = port.compress_minmax_uint8(x)
    q_p, mm_p = port.compress_minmax_uint8_plain(x)
    assert bitwise(q, q_p) and bitwise(mm, mm_p)
    out = port.decompress_minmax_uint8(q, mm)
    assert bitwise(out, port.decompress_minmax_uint8_plain(q, mm))
    qr, mmr = q.unsqueeze(0), mm.unsqueeze(0)  # one rank, shape[0] peers
    for average in (True, False):
        q2, mm2 = port.decompress_reduce_requantize(qr, mmr, average)
        q2_p, mm2_p = port.decompress_reduce_requantize_plain(qr, mmr, average)
        assert bitwise(q2, q2_p) and bitwise(mm2, mm2_p)
    assert [fn.launches for fn in port.KERNELS] == [1, 1, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("value", [0.0, 1.5, 2.5, -7.0, 1e32, -1e35, 3.4e38])
def test_kernels_match_plain_on_constants(cuda_device, value):
    x = torch.full((4, 4096), value, device=cuda_device)
    q, mm = port.compress_minmax_uint8(x)
    q_p, mm_p = port.compress_minmax_uint8_plain(x)
    assert bitwise(q, q_p) and bitwise(mm, mm_p)
    assert bitwise(port.decompress_minmax_uint8(q, mm), port.decompress_minmax_uint8_plain(q, mm))
    q2, mm2 = port.decompress_reduce_requantize(q[None], mm[None])
    q2_p, mm2_p = port.decompress_reduce_requantize_plain(q[None], mm[None])
    assert bitwise(q2, q2_p) and bitwise(mm2, mm2_p)
