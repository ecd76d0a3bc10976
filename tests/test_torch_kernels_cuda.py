"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one.  They import neither
JAX nor the JAX package, so they run where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from bagua_tpu_torch.kernels import minmax_uint8 as port
from bagua_tpu_torch.kernels import quantized_ring as qr


@pytest.fixture()
def cuda_device():
    """The card, decided when the test runs; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for fn in port.KERNELS + qr.KERNELS:
        fn.launches = 0
    return torch.device("cuda", 0)


def bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit; a NaN matches a NaN whatever its payload."""
    if a.dtype == torch.float32:
        nan = torch.isnan(a)
        if not torch.equal(nan, torch.isnan(b)):
            return False
        a, b = a[~nan].view(torch.int32), b[~nan].view(torch.int32)
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


def check_hop(incoming: torch.Tensor, local: torch.Tensor, bits: int) -> None:
    """The hop kernel equals its plain version bitwise on packages the
    block codec made from ``incoming``, and counts one launch."""
    comp = port.compress_minmax_uint8_plain if bits == 8 else qr.compress_minmax_uint4
    q, mm = comp(incoming)
    before = qr.hop_dequant_add_requant.launches, dict(qr.hop_dequant_add_requant.launches_by_bits)
    got = qr.hop_dequant_add_requant(q, mm, local, bits)
    want = qr.hop_dequant_add_requant_plain(q, mm, local, bits)
    torch.cuda.synchronize()
    assert qr.hop_dequant_add_requant.launches == before[0] + 1
    assert qr.hop_dequant_add_requant.launches_by_bits == {**before[1], bits: before[1][bits] + 1}
    for g, w in zip(got, want):
        assert bitwise(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("shape", [(64, 4096), (5, 2), (7, 6), (9, 130), (3, 4098), (2, 8192),
                                   (2, 8194), (2, 12288), (2, 65538)])
def test_hop_matches_plain(cuda_device, bits, shape):
    """Random blocks at the ring's block size and at ragged ones: vector
    and scalar loads, s in shared memory and recomputed."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    incoming = torch.randn(shape, generator=gen, device=cuda_device) * 3.0
    local = torch.randn(shape, generator=gen, device=cuda_device)
    check_hop(incoming, local, bits)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("value", [0.0, 1.5, 2.5, -7.0, 1e32, -1e35, 3.4e38, 8.8e33])
def test_hop_matches_plain_on_constants(cuda_device, bits, value):
    """A constant sum: the requantize's upper - levels may round, where the
    u8 convert saturates; at 3.4e38 the sum overflows to inf."""
    x = torch.full((4, 4096), value, device=cuda_device)
    check_hop(x, x.clone(), bits)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_hop_matches_plain_on_nan_and_signed_zeros(cuda_device, bits):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn((3, 258), generator=gen, device=cuda_device)
    local = torch.randn((3, 258), generator=gen, device=cuda_device)
    local[1, 200] = float("nan")
    check_hop(x, local, bits)
    zeros = torch.tensor([[0.0, -0.0, 0.0, -0.0], [-0.0, -0.0, -0.0, -0.0]], device=cuda_device)
    check_hop(zeros, -zeros, bits)
