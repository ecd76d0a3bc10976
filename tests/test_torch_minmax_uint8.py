"""The port's MinMaxUInt8 codec against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages.  On the
CPU the port's wrappers run their plain PyTorch versions; every output
(``q``, ``minmax``, decompressed values) must equal ``bagua_tpu``'s jnp
functions bit for bit, and the Pallas entries in interpret mode where the
chunk is aligned.  The CUDA kernels are held against the plain versions in
``test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bagua_tpu.kernels import minmax_uint8 as ref
from bagua_tpu_torch.kernels import minmax_uint8 as port


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    for fn in port.KERNELS:
        fn.launches = 0
    yield
    assert [fn.launches for fn in port.KERNELS] == [0, 0, 0]


def assert_bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == np.float32:
        got, want = got.view(np.uint32), want.view(np.uint32)
    np.testing.assert_array_equal(got, want)


def check_roundtrip(chunks: np.ndarray, pallas: bool):
    """Compress and decompress ``chunks`` in both packages; bitwise."""
    q, mm = port.compress_minmax_uint8(torch.from_numpy(chunks))
    q_ref, mm_ref = ref.compress_minmax_uint8(jnp.asarray(chunks))
    assert_bitwise(q.numpy(), q_ref)
    assert_bitwise(mm.numpy(), mm_ref)
    x = port.decompress_minmax_uint8(q, mm)
    assert_bitwise(x.numpy(), ref.decompress_minmax_uint8(q_ref, mm_ref))
    if pallas:
        q_pl, mm_pl = ref.compress_minmax_uint8_pallas(jnp.asarray(chunks), interpret=True)
        assert_bitwise(q.numpy(), q_pl)
        assert_bitwise(mm.numpy(), mm_pl)
        x_pl = ref.decompress_minmax_uint8_pallas(q_pl, mm_pl, interpret=True)
        assert_bitwise(x.numpy(), x_pl)


@pytest.mark.parametrize("scale", [1e-6, 1e-2, 1.0, 1e3, 1e20])
def test_random_chunks_bitwise(scale):
    rng = np.random.RandomState(0)
    chunks = (rng.randn(4, 4096) * scale).astype(np.float32)
    check_roundtrip(chunks, pallas=True)


@pytest.mark.parametrize(
    "shape", [(3, 100), (1, 7), (5, 129), (2, 4095)], ids=["3x100", "1x7", "5x129", "2x4095"]
)
def test_unaligned_chunks_bitwise(shape):
    rng = np.random.RandomState(5)
    check_roundtrip((rng.randn(*shape) * 3.0).astype(np.float32), pallas=True)


@pytest.mark.parametrize("value", [0.0, 2.5, -7.0], ids=["zero", "pos", "neg"])
def test_constant_chunk_bitwise(value):
    check_roundtrip(np.full((2, 4096), value, np.float32), pallas=True)


@pytest.mark.parametrize("value", [1e32, -1e35, 3.4e38], ids=["1e32", "-1e35", "f32max"])
def test_constant_huge_magnitude_bitwise(value):
    check_roundtrip(np.full((2, 4096), value, np.float32), pallas=True)


def test_mixed_constant_and_varying_chunks_bitwise():
    rng = np.random.RandomState(8)
    chunks = rng.randn(4, 4096).astype(np.float32)
    chunks[1] = 0.0
    chunks[3] = -2.5e33
    check_roundtrip(chunks, pallas=True)


@pytest.mark.parametrize("shape", [(3, 100), (1, 7), (5, 129)], ids=["3x100", "1x7", "5x129"])
def test_constant_unaligned_bitwise(shape):
    check_roundtrip(np.full(shape, 1.7e33, np.float32), pallas=True)


def test_signed_zero_min_max_bitwise():
    """XLA's min orders -0 below +0 whatever the element order; the plain
    version does too, so the sign of a zero min/max matches."""
    rows = [
        [0.0, -0.0, 1.0, 2.0],
        [-0.0, 0.0, 1.0, 2.0],
        [-1.0, 0.0, -0.0, -2.0],
        [-1.0, -0.0, 0.0, -2.0],
        [0.0, 0.0, 0.0, 0.0],
        [-0.0, -0.0, -0.0, -0.0],
    ]
    check_roundtrip(np.array(rows, np.float32), pallas=False)


def test_nan_element():
    """A NaN propagates into its chunk's min and max, so the whole chunk
    decompresses to NaN; the other chunks are untouched.  Bitwise, NaNs
    included."""
    rng = np.random.RandomState(9)
    chunks = rng.randn(3, 257).astype(np.float32)
    chunks[1, 100] = np.nan
    check_roundtrip(chunks, pallas=False)
    q, mm = port.compress_minmax_uint8(torch.from_numpy(chunks))
    assert torch.isnan(mm[1]).all() and not torch.isnan(mm[[0, 2]]).any()
    assert torch.isnan(port.decompress_minmax_uint8(q, mm)[1]).all()


def check_fused(x: np.ndarray, average: bool, pallas: bool):
    """``x`` is (R, n, chunk): each rank's n received chunks, compressed in
    the JAX package first; the fused reduce must match per rank."""
    ranks, n, chunk = x.shape
    qs, mms = [], []
    for r in range(ranks):
        q_r, mm_r = ref.compress_minmax_uint8(jnp.asarray(x[r]))
        qs.append(np.asarray(q_r))
        mms.append(np.asarray(mm_r))
    q2, mm2 = port.decompress_reduce_requantize(
        torch.from_numpy(np.stack(qs)), torch.from_numpy(np.stack(mms)), average=average
    )
    assert q2.shape == (ranks, 1, chunk) and mm2.shape == (ranks, 1, 2)
    for r in range(ranks):
        q_ref, mm_ref = ref.decompress_reduce_requantize(
            jnp.asarray(qs[r]), jnp.asarray(mms[r]), average=average
        )
        assert_bitwise(q2[r].numpy(), q_ref)
        assert_bitwise(mm2[r].numpy(), mm_ref)
        if pallas:
            q_pl, mm_pl = ref.decompress_reduce_requantize_pallas(
                jnp.asarray(qs[r]), jnp.asarray(mms[r]), average=average, interpret=True
            )
            assert_bitwise(q2[r].numpy(), q_pl)
            assert_bitwise(mm2[r].numpy(), mm_pl)


@pytest.mark.parametrize("average", [True, False], ids=["avg", "sum"])
def test_fused_reduce_random_bitwise(average):
    rng = np.random.RandomState(6)
    check_fused(rng.randn(2, 4, 4096).astype(np.float32), average, pallas=True)


@pytest.mark.parametrize("average", [True, False], ids=["avg", "sum"])
@pytest.mark.parametrize("shape", [(1, 3, 100), (3, 2, 7), (2, 5, 129), (1, 8, 4095)])
def test_fused_reduce_unaligned_bitwise(shape, average):
    rng = np.random.RandomState(7)
    check_fused((rng.randn(*shape) * 10.0).astype(np.float32), average, pallas=False)


@pytest.mark.parametrize("value", [8.8e33, 0.0, -3.0e38])
def test_fused_reduce_constant_bitwise(value):
    check_fused(np.full((1, 4, 4096), value, np.float32), True, pallas=True)


def test_fused_reduce_constant_saturates_as_jnp():
    """A constant 1.5 chunk requantizes to ``d = upper - (upper - 255) =
    256``, since ``upper - 255`` rounds in f32 at that magnitude.  The jnp
    reference converts to u8 with saturation (255); the JAX package's Pallas
    kernel goes through int32 and wraps (0).  The port follows jnp."""
    x = np.full((1, 4, 4096), 1.5, np.float32)
    check_fused(x, True, pallas=False)
    q, mm = ref.compress_minmax_uint8(jnp.asarray(x[0]))
    q_pl, _ = ref.decompress_reduce_requantize_pallas(q, mm, average=True, interpret=True)
    q_port, _ = port.decompress_reduce_requantize(
        torch.from_numpy(np.array(q))[None], torch.from_numpy(np.array(mm))[None]
    )
    assert (q_port == 255).all() and (np.asarray(q_pl) == 0).all()
