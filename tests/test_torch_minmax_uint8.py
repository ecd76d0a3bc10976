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


# ---------------------------------------------------------------------------
# The identities the CUDA kernels lean on
# ---------------------------------------------------------------------------


def level_sidecars():
    """(min, max) rows of several kinds: random ranges, constant chunks, huge
    (3.4e38) and tiny (1e-38) magnitudes."""
    rng = np.random.RandomState(12)
    lo = (rng.randn(6) * 3.0).astype(np.float32)
    return {
        "random": np.stack([lo, lo + np.abs(rng.randn(6)).astype(np.float32) * 5.0], 1),
        "constant": np.array([[1.5, 1.5], [0.0, 0.0], [-7.0, -7.0], [2.5, 2.5]], np.float32),
        "huge": np.array([[3.4e38, 3.4e38], [-3.4e38, 3.4e38], [1e32, 3.4e38], [-3.4e38, -1e30]],
                         np.float32),
        "tiny": np.array([[1e-38, 1e-38], [-1e-38, 1e-38], [0.0, 1e-38], [-1e-38, 0.0]], np.float32),
    }


@pytest.mark.parametrize("case", list(level_sidecars()))
def test_level_table_is_the_dequantize(case):
    """The fused kernel looks each peer's values up in a table of its 256
    levels instead of dividing: the table equals the JAX package's
    dequantize of those levels, bit for bit."""
    mm = level_sidecars()[case]
    levels = np.tile(np.arange(256, dtype=np.uint8), (mm.shape[0], 1))
    want = ref.decompress_minmax_uint8(jnp.asarray(levels), jnp.asarray(mm))
    assert_bitwise(port.level_table_plain(torch.from_numpy(mm)).numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
def test_divide_by_power_of_two_is_multiply_by_reciprocal(n):
    """Where n is a power of two the fused kernel averages by multiplying by
    1/n: both round the same exact quotient, subnormals included.  Checked
    in IEEE arithmetic (numpy, torch), as the kernel computes it (no
    fast-math, no flush to zero); XLA's CPU backend flushes subnormals, so
    it cannot witness the identity."""
    rng = np.random.RandomState(13)
    bits = rng.randint(0, 2 ** 32, size=1 << 16, dtype=np.uint64).astype(np.uint32)
    x = bits.view(np.float32)
    x = np.concatenate([x[~np.isnan(x)], np.array([1e-45, -1e-45, 3e-39, -1.2e-38, 0.0, -0.0], np.float32)])
    recip = np.float32(1.0) / np.float32(n)
    assert_bitwise(x * recip, x / np.float32(n))
    t = torch.from_numpy(x)
    assert_bitwise((t * recip).numpy(), (t / torch.full_like(t, n)).numpy())


#: MinMax's keys (csrc/minmax_uint8.cu): the identities of its lo and hi
K_POS_INF, K_NEG_INF = np.int32(0x7F800000), np.int32(-0x7F800001)


def keys_minmax(x: np.ndarray):
    """A numpy mirror of the CUDA kernels' ``MinMax``: each element's key
    ``b ^ ((b >> 31) & 0x7fffffff)`` of its bits ``b`` orders as the floats
    do, -0 below +0 and NaNs beyond the infinities; the row's integer min
    and max of the keys (from +inf's and -inf's keys) turn back into floats,
    and a NaN anywhere makes both results NaN."""
    b = np.ascontiguousarray(x, np.float32).view(np.int32)
    key = b ^ ((b >> 31) & np.int32(0x7FFFFFFF))
    lo = np.minimum(key.min(axis=1), K_POS_INF)
    hi = np.maximum(key.max(axis=1), K_NEG_INF)
    nan = (lo < K_NEG_INF) | (hi > K_POS_INF)
    mn, mx = ((k ^ ((k >> 31) & np.int32(0x7FFFFFFF))).view(np.float32) for k in (lo, hi))
    mn[nan] = mx[nan] = np.nan
    return mn, mx


def flush_subnormals(v: np.ndarray) -> np.ndarray:
    v = np.array(v, np.float32)
    sub = (v != 0) & (np.abs(v) < np.finfo(np.float32).tiny)
    v[sub] = np.copysign(np.float32(0.0), v[sub])
    return v


def assert_same_floats(got, want):
    """Bitwise, a NaN matching a NaN whatever its sign and payload."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(got)
    np.testing.assert_array_equal(nan, np.isnan(want))
    np.testing.assert_array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))


@pytest.mark.parametrize("width", [1, 2, 3, 8, 33, 256])
def test_integer_keys_are_xla_min_max(width):
    """Compress, the fused reduce and its one-tile kernel fold a row's
    min/max as integer keys instead of XLA's NaN- and sign-aware float
    min/max.  Over rows of random bit patterns, most elements replaced by
    NaNs of both signs, infinities, signed zeros, subnormals and normals,
    the mirror of that fold equals ``jnp.min``/``jnp.max``.  XLA's CPU
    backend flushes subnormals where it compares two values (a one-element
    row keeps its subnormal), so there both sides are flushed before they
    are compared; unflushed, the mirror equals the port's plain
    ``_row_min``/``_row_max``, which the kernels are held against on the
    card in IEEE arithmetic."""
    rng = np.random.RandomState(20 + width)
    special = np.array([np.nan, np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, -1e-45, 3e-39,
                        -1.2e-38, 1.0, -2.0, 3.4e38, -3.4e38], np.float32)
    special[1] = np.uint32(0xFFC00001).view(np.float32)  # a NaN with the sign bit set
    rows = 2000
    x = rng.randint(0, 2 ** 32, size=(rows, width), dtype=np.uint64).astype(np.uint32).view(np.float32)
    share = rng.choice([0.0, 0.5, 0.9, 1.0], size=(rows, 1))  # rows with no special value, too
    pick = rng.rand(rows, width) < share
    x = np.where(pick, special[rng.randint(0, len(special), (rows, width))], x)
    mn, mx = keys_minmax(x)
    want_mn, want_mx = jnp.min(jnp.asarray(x), axis=1), jnp.max(jnp.asarray(x), axis=1)
    assert_same_floats(flush_subnormals(mn), flush_subnormals(want_mn))
    assert_same_floats(flush_subnormals(mx), flush_subnormals(want_mx))
    t = torch.from_numpy(x)
    assert_same_floats(mn, port._row_min(t)[:, 0].numpy())
    assert_same_floats(mx, port._row_max(t)[:, 0].numpy())
    assert np.isnan(mn).any() and not np.isnan(mn).all()
