"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one.  They import neither
JAX nor the JAX package, so they run where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import math

import pytest
import torch

from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.kernels import collective_matmul as cm
from bagua_tpu_torch.kernels import flash_attention as fa
from bagua_tpu_torch.kernels import minmax_uint8 as port
from bagua_tpu_torch.kernels import quantized_ring as qr
from bagua_tpu_torch.parallel.ring_attention import ring_attention
from bagua_tpu_torch.parallel.tensor_parallel import ColumnParallelDense, RowParallelDense


@pytest.fixture()
def cuda_device():
    """The card, decided when the test runs; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for fn in port.KERNELS + qr.KERNELS + fa.KERNELS + cm.KERNELS:
        fn.launches = 0
    qr.hop_dequant_add_requant.launches_by_bits.update({8: 0, 4: 0})
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


def check_compress(x: torch.Tensor) -> None:
    """Compress equals its plain version bitwise and counts one launch a
    call."""
    before = port.compress_minmax_uint8.launches
    q, mm = port.compress_minmax_uint8(x)
    q_p, mm_p = port.compress_minmax_uint8_plain(x)
    torch.cuda.synchronize()
    assert port.compress_minmax_uint8.launches == before + 1
    assert bitwise(q, q_p) and bitwise(mm, mm_p)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 7, 16, 250, 4095, 4096, 4097, 16384, 16385, 65539])
def test_compress_on_both_sides_of_each_path(cuda_device, chunk):
    """Chunks held by one CTA of 32 to 256 threads (up to 4096 elements),
    of up to 1024 (up to 16384), and walked in two passes beyond; vector
    and scalar loads."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    for rows in (1, 3, 16):
        check_compress(torch.randn((rows, chunk), generator=gen, device=cuda_device) * 3.0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [6 * 132 + 1, 3000])
def test_compress_ring_blocks(cuda_device, rows):
    """The int8 ring's (rows, 4096) blocks, more rows than one wave of the
    one-pass kernel."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    check_compress(torch.randn((rows, 4096), generator=gen, device=cuda_device))


def _scatter_specials(chunk: int, device) -> torch.Tensor:
    """Rows whose NaN, signed zeros and infinities sit far apart (in other
    tiles and, for long rows, other CTAs of the two-pass kernels)."""
    gen = torch.Generator(device=device).manual_seed(7)
    x = torch.rand((7, chunk), generator=gen, device=device) + 0.5
    far = [chunk // 7, chunk // 2, chunk - 1]
    x[0, far[1]] = float("nan")
    x.view(torch.int32)[1, far[2]] = 0xFFC00001 - 2 ** 32  # a NaN with the sign bit set
    x[2, far[0]], x[2, far[2]] = -0.0, 0.0  # min -0 (XLA orders -0 below +0)
    x[3] = -x[3]
    x[3, far[0]], x[3, far[2]] = 0.0, -0.0  # max +0
    x[4, far[0]], x[4, far[2]] = float("inf"), float("-inf")
    x[5] = 0.0
    x[5, far[1]] = -0.0
    x[6, far[0]], x[6, far[1]] = float("-inf"), float("nan")
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [4096, 16384, 300_000, 2_000_003])
def test_compress_specials_in_far_tiles(cuda_device, chunk):
    x = _scatter_specials(chunk, cuda_device)
    assert torch.isnan(x[1]).any() and torch.signbit(x[1][torch.isnan(x[1])]).all()
    check_compress(x)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [4096, 16384, 40000])
def test_compress_reads_unaligned_views(cuda_device, chunk):
    """x one element off a 16-byte boundary: the scalar path of each."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    x = torch.randn((5, chunk), generator=gen, device=cuda_device)
    buf = torch.empty(x.numel() + 1, device=cuda_device)
    off = buf[1:].view(x.shape)
    off.copy_(x)
    assert off.is_contiguous() and off.data_ptr() % 16
    check_compress(off)


def check_fused(q: torch.Tensor, mm: torch.Tensor, average: bool) -> None:
    """The fused reduce equals its plain version bitwise and counts one
    launch a call."""
    before = port.decompress_reduce_requantize.launches
    got = port.decompress_reduce_requantize(q, mm, average)
    want = port.decompress_reduce_requantize_plain(q, mm, average)
    torch.cuda.synchronize()
    assert port.decompress_reduce_requantize.launches == before + 1
    assert bitwise(got[0], want[0]) and bitwise(got[1], want[1])


def fused_inputs(device, ranks: int, n: int, chunk: int, seed: int = 3):
    """Each rank's n received chunks, compressed by the plain codec."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((ranks * n, chunk), generator=gen, device=device) * 3.0
    q, mm = port.compress_minmax_uint8_plain(x)
    return q.reshape(ranks, n, chunk), mm.reshape(ranks, n, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("average", [True, False], ids=["avg", "sum"])
@pytest.mark.parametrize("shape", [
    # (R, n, chunk): R > 1; n on both sides of the recompute/scratch choice
    # (n < 8 recomputes the sums, n >= 8 stores them), powers of two and
    # not; 33 and 64 peers (tables beyond one group of 32); chunks of one
    # element and at the 4096-element tile (one launch) and one past it
    (3, 4, 40000), (2, 1, 9000), (1, 3, 20000), (2, 5, 8208), (1, 8, 12288), (1, 9, 5000),
    (1, 16, 4100), (1, 64, 9000), (1, 33, 4097), (1, 64, 300), (4, 4, 1), (1, 4, 4095),
    (2, 4, 4096), (2, 4, 4097), (1, 9, 4096),
])
def test_fused_reduce_matches_plain(cuda_device, shape, average):
    check_fused(*fused_inputs(cuda_device, *shape), average)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [40000, 4096])
def test_fused_reduce_reads_unaligned_views(cuda_device, chunk):
    """q one byte off a 16-byte boundary: the scalar path."""
    q, mm = fused_inputs(cuda_device, 2, 4, chunk)
    buf = torch.empty(q.numel() + 1, dtype=torch.uint8, device=cuda_device)
    off = buf[1:].view(q.shape)
    off.copy_(q)
    assert off.is_contiguous() and off.data_ptr() % 16
    for average in (True, False):
        check_fused(off, mm, average)


def check_hop(incoming: torch.Tensor, local: torch.Tensor, bits: int) -> None:
    """The hop kernel equals its plain version bitwise on packages the
    block codec made from ``incoming``, and counts one launch."""
    comp = port.compress_minmax_uint8_plain if bits == 8 else qr.compress_minmax_uint4_plain
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
                                   (2, 8194), (2, 12288), (2, 65538), (1, 4096), (800, 4096),
                                   (3000, 4096), (5, 32), (4, 16), (3, 4112), (2, 16384), (2, 16386)])
def test_hop_matches_plain(cuda_device, bits, shape):
    """Random blocks at the ring's block size and at ragged ones: vector
    and scalar loads; one row to several waves of CTAs (6 or 5 a SM); rows
    held in registers by 256 threads (B <= 4096) and by up to 1024 (B <=
    16384), and longer rows walked twice."""
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


# ---------------------------------------------------------------------------
# The int4 block codec: compress and decompress, bitwise their plain versions
# ---------------------------------------------------------------------------


def check_codec4(x: torch.Tensor) -> None:
    """Both codec kernels equal their plain versions bitwise on ``x`` (the
    decompress on the plain compress's output) and count one launch a call."""
    before = qr.compress_minmax_uint4.launches, qr.decompress_minmax_uint4.launches
    packed, mm = qr.compress_minmax_uint4(x)
    packed_p, mm_p = qr.compress_minmax_uint4_plain(x)
    out = qr.decompress_minmax_uint4(packed_p, mm_p)
    torch.cuda.synchronize()
    assert bitwise(packed, packed_p) and bitwise(mm, mm_p)
    assert bitwise(out, qr.decompress_minmax_uint4_plain(packed_p, mm_p))
    assert (qr.compress_minmax_uint4.launches, qr.decompress_minmax_uint4.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 4096), (5, 2), (7, 6), (9, 130), (3, 258), (3, 4098), (2, 8192),
                                   (2, 8194), (2, 16384), (2, 16386), (2, 65536), (2, 65538), (1, 4096),
                                   (3000, 4096), (5, 32), (4, 16), (3, 4112), (3, 4104), (2, 24),
                                   (2, 1 << 20)])
def test_codec4_matches_plain(cuda_device, shape):
    """Random blocks at the ring's block size and at ragged ones: the vector
    paths (B/2 a whole number of 8 bytes for compress, of 4 for
    decompress) and the scalar ones; rows of up to 4096 held in registers
    and longer rows walked twice (compress); one row to many sections of a
    long row (decompress)."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    check_codec4(torch.randn(shape, generator=gen, device=cuda_device) * 3.0)


@pytest.mark.cuda
@pytest.mark.parametrize("value", [0.0, 1.5, 2.5, -7.0, 1e32, -1e35, 3.4e38, 8.8e33])
def test_codec4_matches_plain_on_constants(cuda_device, value):
    """A constant block: upper - 15 may round; at 3.4e38 the range is the
    bounded denominator's."""
    check_codec4(torch.full((4, 4096), value, device=cuda_device))
    check_codec4(torch.full((3, 258), value, device=cuda_device))


@pytest.mark.cuda
def test_codec4_matches_plain_on_nan_and_signed_zeros(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn((3, 258), generator=gen, device=cuda_device)
    x[1, 200] = float("nan")
    check_codec4(x)
    mixed = torch.randn((4, 4096), generator=gen, device=cuda_device)
    mixed[1], mixed[3] = 0.0, -2.5e33
    check_codec4(mixed)
    check_codec4(torch.tensor([[0.0, -0.0, 1.0, 2.0], [-0.0, 0.0, -1.0, -2.0], [-0.0] * 4, [0.0] * 4],
                              device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("block", [4096, 258])
def test_codec4_reads_unaligned_views(cuda_device, block):
    """Contiguous views off a 16-byte boundary take the scalar paths."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    buf = torch.randn(3 * block + 1, generator=gen, device=cuda_device)
    x = buf[1:].view(3, block)
    assert x.is_contiguous() and x.data_ptr() % 16
    check_codec4(x)
    packed, mm = qr.compress_minmax_uint4_plain(x)
    pbuf = torch.empty(packed.numel() + 1, dtype=torch.uint8, device=cuda_device)
    off = pbuf[1:].view(packed.shape)
    off.copy_(packed)
    assert bitwise(qr.decompress_minmax_uint4(off, mm), qr.decompress_minmax_uint4_plain(packed, mm))


@pytest.mark.cuda
def test_codec4_refuses_what_its_kernels_do_not_take(cuda_device):
    """A CUDA operand of another dtype or shape, or an odd B, raises before
    any launch."""
    x = torch.randn((4, 8), device=cuda_device)
    packed, mm = qr.compress_minmax_uint4_plain(x)
    bad = [
        (qr.compress_minmax_uint4, (torch.randn((4, 7), device=cuda_device),)),
        (qr.compress_minmax_uint4, (x.double(),)),
        (qr.compress_minmax_uint4, (x.bfloat16(),)),
        (qr.compress_minmax_uint4, (x.reshape(32),)),
        (qr.decompress_minmax_uint4, (packed.float(), mm)),
        (qr.decompress_minmax_uint4, (packed, mm.double())),
        (qr.decompress_minmax_uint4, (packed.reshape(1, 4, 4), mm)),
        (qr.decompress_minmax_uint4, (packed, mm[:3])),
        (qr.decompress_minmax_uint4, (packed, torch.zeros((4, 3), device=cuda_device))),
    ]
    for fn, args in bad:
        with pytest.raises(ValueError):
            fn(*args)
    assert qr.compress_minmax_uint4.launches == qr.decompress_minmax_uint4.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("block", [4096, 258])
def test_int4_ring_on_card_matches_cpu(cuda_device, block):
    """``quantized_ring_allreduce(bits=4)`` over 4 ranks on the card, bitwise
    the same call on CPU tensors (shards not a whole number of blocks), with
    2 compresses, 2 decompresses and 2 int4 hops."""
    x = torch.randn((4, 4 * (3 * block + 7)), generator=torch.Generator().manual_seed(11))
    got = qr.quantized_ring_allreduce(x.to(cuda_device), BaguaProcessGroup([cuda_device] * 4, intra_size=1),
                                      bits=4, block=block)
    torch.cuda.synchronize()
    launches = (qr.compress_minmax_uint4.launches, qr.decompress_minmax_uint4.launches,
                qr.hop_dequant_add_requant.launches_by_bits[4])
    qr.hop_dequant_add_requant.launches_by_bits.update({8: 0, 4: 0})
    want = qr.quantized_ring_allreduce(x, BaguaProcessGroup([torch.device("cpu")] * 4, intra_size=1),
                                       bits=4, block=block)
    assert launches == (2, 2, 2)
    for g, w in zip(got, want):
        assert bitwise(g.cpu(), w)


@pytest.mark.cuda
def test_zero_int4_step_on_card_matches_cpu(cuda_device):
    """One ZeRO int4 exchange (``transform_gradients``: the reduce-scatter
    leg with error feedback) over 4 ranks on the card, bitwise the same
    step on CPU tensors: every bucket's shards and residuals; per bucket 1
    compress, 1 decompress and 2 int4 hops."""
    from bagua_tpu_torch.algorithms.base import StepContext
    from bagua_tpu_torch.sharded import ZeroAlgorithm
    from bagua_tpu_torch.utils import tree_map

    gen = torch.Generator().manual_seed(12)
    shapes = {"Dense_0": {"kernel": (300, 70), "bias": (70,)}, "Dense_1": {"kernel": (70, 9), "bias": (9,)}}
    params = {m: {n: torch.randn(shape, generator=gen) for n, shape in leaves.items()} for m, leaves in shapes.items()}
    grads = tree_map(lambda t: torch.randn((4, *t.shape), generator=gen), params)
    outs = []
    for device in (cuda_device, torch.device("cpu")):
        group = BaguaProcessGroup([device] * 4, intra_size=1)
        impl = ZeroAlgorithm(wire_precision="int4").reify(group)
        impl.bind_plan(impl.tensors_to_buckets(params, bucket_size_bytes=1 << 14))
        plan = impl._bound_plan
        state = impl.init_state(tree_map(lambda t: t.to(device), params))
        resid = torch.Generator().manual_seed(13)
        state["qr_residual"] = tuple(torch.randn(r.shape, generator=resid).to(device) * 1e-2
                                     for r in state["qr_residual"])
        shards, _, state = impl.transform_gradients(tree_map(lambda t: t.to(device), grads), None, state,
                                                    StepContext(group, 1, plan))
        outs.append([t.cpu() for t in shards + list(state["qr_residual"])])
        if device.type == "cuda":
            torch.cuda.synchronize()
            nb = plan.num_buckets
            assert nb > 1
            assert (qr.compress_minmax_uint4.launches, qr.decompress_minmax_uint4.launches,
                    qr.hop_dequant_add_requant.launches_by_bits[4]) == (nb, nb, 2 * nb)
    for g, w in zip(*outs):
        assert bitwise(g, w)


# ---------------------------------------------------------------------------
# Flash attention: a tolerance, not bitwise (sums in another order; the
# kernels fuse multiply-adds).  o, l and dq/dk/dv within 2e-4 and 3e-4 of
# max(1, |value|), m within 2e-5: the JAX package's bounds for its Pallas
# kernels (tests/test_parallel.py:291-293, 423).  bf16 dk/dv: one bf16
# rounding step (2^-8 of the value) more.
# ---------------------------------------------------------------------------


def close(got: torch.Tensor, want: torch.Tensor, tol: float) -> bool:
    """Every element within ``tol * max(1, |want|)`` (plus one rounding
    step of a bf16 or f16 ``got``)."""
    g, w = got.double(), want.double()
    step = 2.0 ** -8 if got.dtype in (torch.bfloat16, torch.float16) else 0.0
    return bool(((g - w).abs() <= tol * w.abs().clamp(min=1.0) + step * w.abs()).all())


def attention_inputs(device, b, tq, tk, h, h_kv, d, kind, kv_dtype=torch.float32, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    qf = torch.randn((b, tq, h, d), generator=gen, device=device) / d ** 0.5
    k = torch.randn((b, tk, h_kv, d), generator=gen, device=device).to(kv_dtype)
    v = torch.randn((b, tk, h_kv, d), generator=gen, device=device).to(kv_dtype)
    if kind == "causal":
        mask = torch.ones((tq, tk), dtype=torch.bool, device=device).tril(tk - tq).expand(b, tq, tk)
    elif kind == "full":
        mask = torch.ones((b, tq, tk), dtype=torch.bool, device=device)
    elif kind == "dead":
        mask = torch.zeros((b, tq, tk), dtype=torch.bool, device=device)
    elif kind == "firstcol":  # only the first key survives
        mask = torch.zeros((b, tq, tk), dtype=torch.bool, device=device)
        mask[:, :, 0] = True
    elif kind == "gaps":  # q tiles 1 and 3 of 64 rows dead: live tiles not contiguous
        mask = torch.rand((b, tq, tk), generator=gen, device=device) < 0.5
        mask[:, 64:128] = False
        mask[:, 192:256] = False
    elif kind == "keygaps":  # k tiles 1 and 3 dead for every query: live k tiles not contiguous
        mask = torch.rand((b, tq, tk), generator=gen, device=device) < 0.5
        mask[:, :, 64:128] = False
        mask[:, :, 192:256] = False
    elif kind == "deadqtile":  # queries 128:256 see no key, beside live ones
        mask = torch.rand((b, tq, tk), generator=gen, device=device) < 0.5
        mask[:, 128:256] = False
    else:
        mask = torch.rand((b, tq, tk), generator=gen, device=device) < 0.5
        mask[:, 1] = False  # a fully masked row
    dl = torch.randn((b, h, tq), generator=gen, device=device)
    do = torch.randn((b, h, tq, d), generator=gen, device=device)
    return qf, k, v, mask, dl, do


ATTENTION_CASES = [
    # (b, tq, tk, h, h_kv, d, mask, K/V type)
    (2, 128, 128, 2, 2, 128, "causal", torch.float32),
    (1, 64, 64, 4, 1, 64, "full", torch.float32),
    (1, 200, 300, 4, 2, 24, "random", torch.float32),
    (2, 37, 100, 2, 2, 64, "firstcol", torch.float32),
    (1, 96, 80, 8, 2, 128, "causal", torch.bfloat16),
    (1, 50, 70, 2, 1, 8, "random", torch.float16),
    (2, 64, 64, 2, 2, 32, "dead", torch.float32),
    # the dk/dv kernel's staging: tq not a multiple of its 64-query step; live
    # q tiles with dead ones between (a wrongly prefetched tile would show);
    # GQA g = 4 with bf16 K/V at d 128; rows off 16-byte boundaries (4-byte
    # copies of q and do, byte reads of the mask)
    (1, 100, 128, 2, 2, 128, "causal", torch.float32),
    (1, 320, 128, 4, 2, 64, "gaps", torch.float32),
    (1, 128, 128, 8, 2, 128, "causal", torch.bfloat16),
    (1, 70, 90, 3, 1, 7, "random", torch.float32),
    # the forward's and dq's staging of k tiles: live k tiles with dead ones
    # between (a wrongly prefetched K/V tile would show); tk not a multiple
    # of 64 with aligned views; 128 queries whose keys are all dead beside
    # live ones (a dead CTA of each kernel); GQA g = 4 with bf16 K/V at d 128 over 4 k
    # tiles (the stages alternate more than once); bf16 rows 16-byte aligned
    # with d not a multiple of 8; K/V rows off 16-byte boundaries (4-byte
    # copies of f32, plain loads of f16)
    (1, 128, 320, 2, 2, 64, "keygaps", torch.float32),
    (1, 128, 208, 2, 1, 128, "random", torch.float32),
    (1, 320, 192, 2, 2, 64, "deadqtile", torch.float32),
    (1, 128, 256, 8, 2, 128, "causal", torch.bfloat16),
    (1, 64, 130, 2, 2, 24, "random", torch.bfloat16),
    (1, 64, 200, 2, 1, 6, "random", torch.float32),
    (1, 70, 150, 2, 1, 7, "random", torch.float16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTENTION_CASES, ids=lambda c: f"{c[1]}x{c[2]}-h{c[3]}kv{c[4]}-d{c[5]}-{c[6]}-{str(c[7])[6:]}")
def test_flash_attention_kernels_match_plain(cuda_device, case):
    """Forward, dq and dk/dv kernels against their plain versions on the
    card (TF32 off), each counting one launch per call."""
    b, tq, tk, h, h_kv, d, kind, kv_dtype = case
    qf, k, v, mask, dl, do = attention_inputs(cuda_device, b, tq, tk, h, h_kv, d, kind, kv_dtype)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = fa.block_attention(qf, k, v, mask)
        want = fa.block_attention_plain(qf, k, v, mask)
        m = want[2]
        dq = fa.flash_attention_bwd_dq(qf, k, v, mask, m, dl, do)
        dk, dv = fa.flash_attention_bwd_dkv(qf, k, v, mask, m, dl, do)
        dq_w = fa.flash_attention_bwd_dq_plain(qf, k, v, mask, m, dl, do)
        # dk and dv against the f32 values that the K/V type rounds (K/V
        # widened exactly): a bf16 or f16 result may round the other way
        # than the plain version's own cast, so it is held to the value
        # itself, within the tolerance plus its one rounding step
        dk_w, dv_w = fa.flash_attention_bwd_dkv_plain(qf, k.float(), v.float(), mask, m, dl, do)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    for name, g, w, tol in zip("olm", got, want, (2e-4, 2e-4, 2e-5)):
        assert g.shape == w.shape and close(g, w, tol), name
    assert dq.dtype == torch.float32 and dk.dtype == dv.dtype == kv_dtype
    for name, g, w in (("dq", dq, dq_w), ("dk", dk, dk_w), ("dv", dv, dv_w)):
        assert g.shape == w.shape and close(g, w, 3e-4), name
    if kind == "dead":
        assert torch.all(got[2] == fa.NEG) and not got[0].any() and not got[1].any()
        assert not dq.any() and not dk.any() and not dv.any()
    if kind == "deadqtile":
        o, l, m = (t[:, :, 128:256] for t in got)
        assert torch.all(m == fa.NEG) and not o.any() and not l.any() and not dq[:, 128:256].any()
    assert [fn.launches for fn in fa.KERNELS] == [1, 1, 1]


@pytest.mark.cuda
def test_flash_attention_reads_strided_views(cuda_device):
    """The ring hands the kernels half-block views of its (b, t, h, d)
    tensors: strided, not copied."""
    qf, k, v, mask, dl, do = attention_inputs(cuda_device, 2, 128, 128, 2, 2, 64, "causal")
    halves = (qf[:, 64:], k[:, :64], v[:, :64], mask[:, 64:, :64].contiguous())
    got = fa.block_attention(*halves)
    want = fa.block_attention_plain(*(x.contiguous() for x in halves))
    for g, w in zip(got, want):
        assert close(g, w, 2e-4)
    do_t = do[:, :, 64:].transpose(1, 2).contiguous().transpose(1, 2)  # (b, h, tq, d) view
    back = fa.flash_attention_bwd(*halves, want[2], dl[:, :, 64:], do_t)
    back_w = fa.flash_attention_bwd(*(x.contiguous().cpu() for x in halves), want[2].cpu(),
                                    dl[:, :, 64:].cpu(), do_t.cpu())
    for g, w in zip(back, back_w):
        assert close(g.cpu(), w, 3e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_ring_attention_on_card_matches_cpu(cuda_device, layout):
    """Causal GQA ring over 4 ranks on the card (the kernels, backward on
    autograd's thread) against the same ring on the CPU (plain versions):
    output and the gradients of sum(sin(y)), within 3e-4."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((4, 1, 96, h, 32), generator=gen) for h in (4, 2, 2))
    outs = []
    for device in (cuda_device, torch.device("cpu")):
        group = BaguaProcessGroup([device] * 4)
        xs = [x.to(device).requires_grad_() for x in (q, k, v)]
        y = ring_attention(*xs, group, "intra", causal=True, layout=layout, kv_groups=2)
        torch.sin(y).sum().backward()
        outs.append([y.detach().cpu()] + [x.grad.cpu() for x in xs])
    for g, w in zip(*outs):
        assert close(g, w, 3e-4)
    # sp 4: the zigzag ring's 2 sp + 1 live pairs, the contiguous ring's sp steps
    assert fa.block_attention.launches == (9 if layout == "zigzag" else 4)
    assert fa.flash_attention_bwd_dq.launches == fa.flash_attention_bwd_dkv.launches == fa.block_attention.launches


@pytest.mark.cuda
@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_ring_attention_on_card_skips_dead_blocks(cuda_device, layout, sp):
    """Causal GQA ring with a key-padding mask over dp 2 x sp ranks on the
    card against the same ring on the CPU (output and the gradients of
    sum(sin(y)) within 3e-4) and against the CPU's witness of the rows a
    call serves: zigzag launches each kernel 2 sp + 1 times a pass, the
    contiguous ring sp times, each call over its live ranks only."""
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn((2 * sp, 2, 64, h, 32), generator=gen) for h in (4, 2, 2))
    kv_mask = torch.rand((2 * sp, 2, 64), generator=gen) < 0.7
    kv_mask[..., 0] = True
    outs, rows = [], []
    apply = fa.BlockAttentionFn.apply
    for device in (cuda_device, torch.device("cpu")):
        group = BaguaProcessGroup([device] * (2 * sp), intra_size=sp)
        seen = []
        fa.BlockAttentionFn.apply = lambda *a: seen.append(a[0].shape[0]) or apply(*a)
        try:
            xs = [x.to(device).requires_grad_() for x in (q, k, v)]
            y = ring_attention(*xs, group, "intra", causal=True, kv_mask=kv_mask.to(device), layout=layout,
                               kv_groups=2)
            torch.sin(y).sum().backward()
        finally:
            fa.BlockAttentionFn.apply = apply
        outs.append([y.detach().cpu()] + [x.grad.cpu() for x in xs])
        rows.append(seen)
    for g, w in zip(*outs):
        assert close(g, w, 3e-4)
    assert rows[0] == rows[1]
    calls = 2 * sp + 1 if layout == "zigzag" else sp
    assert fa.block_attention.launches == fa.flash_attention_bwd_dq.launches == \
        fa.flash_attention_bwd_dkv.launches == calls
    if layout == "contiguous":
        assert rows[0] == [2 * (sp - i) * 2 for i in range(sp)]


def matmul_close(got: torch.Tensor, x: torch.Tensor, w: torch.Tensor) -> bool:
    """The tile kernel's contract: every element within 2 sqrt(K) 2^-24
    (|x| |w|) of ``torch.matmul`` in f32 (TF32 off): with rounding errors of
    random sign each of the two K-term dot products is within about
    sqrt(K) 2^-24 of the exact one (Higham and Mary's probabilistic bound)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = x @ w
        scale = x.abs() @ w.abs()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    tol = 2 * math.sqrt(x.shape[-1]) * 2.0 ** -24
    return got.shape == want.shape and bool(((got - want).abs() <= tol * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(9, 7, 10), (1, 1, 1), (16, 32, 48), (300, 1000, 130),
                                   (128, 4096, 256), (257, 5, 129),
                                   (129, 20, 129), (129, 37, 257), (128, 48, 128)])
def test_matmul_tile_matches_torch(cuda_device, shape):
    """Edge shapes (ragged m, n and k, tiles larger than the operands; m
    one past a 128-row tile, n one past 128 and 256 columns; k under one
    16-deep stage, not a multiple of it, and fewer chunks than the 4
    pipeline stages), 2-D and as a batch of 3 ranks; a second launch gives
    the same bits; one launch per call."""
    m, k, n = shape
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn((3, m, k), generator=gen, device=cuda_device)
    w = torch.randn((3, k, n), generator=gen, device=cuda_device)
    got = cm.matmul_tile(x, w)
    torch.cuda.synchronize()
    assert got.is_contiguous() and matmul_close(got, x, w)
    one = cm.matmul_tile(x[1], w[1])
    assert torch.equal(one, got[1])  # a rank's result does not depend on the batch
    assert torch.equal(cm.matmul_tile(x, w), got)  # deterministic: no split k, no atomics
    assert cm.matmul_tile.launches == 3


@pytest.mark.cuda
def test_matmul_tile_reads_strides(cuda_device):
    """The backward's transposed operands, the ring's per-rank block views
    and an expanded (stride 0) operand go in uncopied and agree; so do all
    four layouts of (a, b) (each of k or m/n with stride 1), aligned and one
    element off a 16-byte boundary (no 16-byte copies), and views with no
    dim of stride 1."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    x = torch.randn((4, 96, 200), generator=gen, device=cuda_device)
    w = torch.randn((4, 200, 72), generator=gen, device=cuda_device)
    g = torch.randn((4, 96, 72), generator=gen, device=cuda_device)

    def layout(shape, transposed, offset):
        """A (4, *shape) operand: row-major or a transposed view, starting
        `offset` elements into its storage."""
        rows, cols = shape[::-1] if transposed else shape
        t = torch.randn(4 * rows * cols + offset, generator=gen, device=cuda_device)[offset:]
        t = t.view(4, rows, cols)
        return t.transpose(1, 2) if transposed else t

    cases = [
        (g, w.transpose(1, 2)),                  # dx = g . w^T
        (x.transpose(1, 2), g),                  # dw = x^T . g
        (x[:, 32:64], w),                        # a row block of every rank
        (x.transpose(1, 2)[:, 7:150], x[:, :, 7:150]),  # both transposed, offset
        (x[:1].expand(4, -1, -1), w),            # batch stride 0
        (x[:, :, ::2], w[:, ::2]),               # no dim of stride 1
    ]
    for ta in (False, True):
        for tb in (False, True):
            for offset in (0, 1):
                cases.append((layout((131, 45), ta, offset), layout((45, 133), tb, offset)))
    for a, b in cases:
        got = cm.matmul_tile(a, b)
        torch.cuda.synchronize()
        assert matmul_close(got, a, b), (tuple(a.shape), a.stride(), tuple(b.shape), b.stride())
    x.requires_grad_()
    w.requires_grad_()
    torch.sin(cm.tile_matmul(x, w)).sum().backward()
    xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
    torch.sin(xr @ wr).sum().backward()
    assert torch.allclose(x.grad, xr.grad, rtol=1e-4, atol=1e-4)
    assert torch.allclose(w.grad, wr.grad, rtol=1e-4, atol=1e-4)
    assert cm.matmul_tile.launches == len(cases) + 3


@pytest.mark.cuda
def test_matmul_tile_other_types_take_x_at_w(cuda_device):
    """Operands that are not both f32 take ``x @ w`` on the card, the same
    dtype and bits, with no launch: the reference's ``matmul_tile_pallas``
    sends them to ``jnp.dot`` outside its kernel.  A fused bf16
    Row(scatter_output) -> Column(gather_input) pair over tp 2 runs forward
    and backward on the card and agrees with the same pair on the CPU:
    outputs and gradients within 2^-5 of each tensor's largest magnitude (8
    bf16 rounding steps there; the two devices accumulate each product's
    f32 sums in other orders before rounding to bf16)."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    x = torch.randn((3, 40, 24), generator=gen, device=cuda_device)
    w = torch.randn((3, 24, 56), generator=gen, device=cuda_device)
    for dtype in (torch.bfloat16, torch.float16, torch.float64):
        a, b = x.to(dtype), w.to(dtype)
        got = cm.matmul_tile(a, b)
        assert got.dtype == dtype and torch.equal(got, a @ b)
        assert torch.equal(cm.matmul_tile(a[0], b[0].t().contiguous().t()), a[0] @ b[0])

    tp, tokens = 2, 32
    cpu = torch.Generator().manual_seed(9)
    leaves = {"row": (torch.randn((tp, 16, 24), generator=cpu), torch.randn((tp, 24), generator=cpu)),
              "col": (torch.randn((tp, 24, 16), generator=cpu), torch.randn((tp, 16), generator=cpu))}
    x = torch.randn((tp, tokens, 16), generator=cpu)
    outs = []
    for device in (cuda_device, torch.device("cpu")):
        kw = dict(fused=True, dtype=torch.bfloat16, group=BaguaProcessGroup([device] * tp), device=device)
        row = RowParallelDense(16, 24, tp, "intra", scatter_output=True, **kw)
        col = ColumnParallelDense(24, 32, tp, "intra", gather_input=True, **kw)
        params = {name: {"kernel": k.to(device, torch.bfloat16).requires_grad_(),
                         "bias": b.to(device, torch.bfloat16).requires_grad_()}
                  for name, (k, b) in leaves.items()}
        y = col(params["col"], row(params["row"], x.to(device)))
        (y.float() ** 2).sum().backward()
        outs.append([y.detach()] + [t.grad for p in params.values() for t in p.values()])
    for g, want in zip(*outs):
        assert g.dtype == want.dtype == torch.bfloat16 and g.shape == want.shape
        g, want = g.cpu().float(), want.float()
        assert (g - want).abs().max() <= 2.0 ** -5 * want.abs().max()
    assert cm.matmul_tile.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("ring", ["uni", "bidir"])
def test_rings_on_card_match_cpu(cuda_device, ring):
    """Both rings over 4 ranks on the card against the same rings on the
    CPU, with their gradients; ag bidir bitwise equal to uni on the card."""
    gen = torch.Generator().manual_seed(7)
    x, w = torch.randn((4, 32, 48), generator=gen), torch.randn((4, 48, 40), generator=gen)
    outs = []
    for device in (cuda_device, torch.device("cpu")):
        group = BaguaProcessGroup([device] * 4)
        xs, ws = x.to(device).requires_grad_(), w.to(device).requires_grad_()
        ag = cm.ag_matmul(xs, ws, group, "intra", ring=ring)
        rs = cm.matmul_rs(xs, ws, group, "intra", ring=ring)
        (torch.sin(ag).sum() + torch.sin(rs).sum()).backward()
        outs.append([ag.detach().cpu(), rs.detach().cpu(), xs.grad.cpu(), ws.grad.cpu()])
        if device.type == "cuda":
            uni = cm.ag_matmul(xs.detach(), ws.detach(), group, "intra", ring="uni")
            assert torch.equal(uni, ag.detach())
    for g, want in zip(*outs):
        assert torch.allclose(g, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("batched_weight", [True, False], ids=["batched", "unbatched"])
def test_rank_conv2d_on_card_matches_per_rank_loop(cuda_device, dtype, batched_weight):
    """``rank_conv2d`` under ``vmap`` on the card, cuDNN deterministic: the
    output and the input and weight gradients bitwise equal to a loop of
    ``F.conv2d`` over the ranks; each rank's NHWC input and output stay
    channels_last; each stacked leaf's hook fires once."""
    import torch.nn.functional as F

    from bagua_tpu_torch.models._rank_ops import rank_conv2d

    ranks = 4
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((ranks, 8, 28, 28, 64), generator=gen, device=cuda_device).to(dtype)  # NHWC
    w = (torch.randn((ranks, 3, 3, 64, 128), generator=gen, device=cuda_device) * 0.05).to(dtype)  # HWIO
    if not batched_weight:
        w = w[0]
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        fired = []
        wl.register_post_accumulate_grad_hook(lambda _t: fired.append("w"))

        def conv(xr, wr):  # vmap refuses is_contiguous: the layout is read outside it
            return rank_conv2d(xr.permute(0, 3, 1, 2), wr.permute(3, 2, 0, 1), 1)

        y = torch.func.vmap(conv, in_dims=(0, 0 if batched_weight else None))(xl, wl)
        (y.float() ** 2).sum().backward()
        assert fired == ["w"]
        gws = []
        for r in range(ranks):
            xr = x[r].clone().requires_grad_(True)
            wr = (w[r] if batched_weight else w).clone().requires_grad_(True)
            yr = F.conv2d(xr.permute(0, 3, 1, 2), wr.permute(3, 2, 0, 1), padding=1)
            assert yr.is_contiguous(memory_format=torch.channels_last)
            assert y[r].is_contiguous(memory_format=torch.channels_last)
            assert bitwise(y[r], yr)
            (yr.float() ** 2).sum().backward()
            assert bitwise(xl.grad[r], xr.grad)
            if batched_weight:
                assert bitwise(wl.grad[r], wr.grad)
            else:
                gws.append(wr.grad)
        if not batched_weight:  # the expanded weight's gradient: a sum over the ranks
            assert bitwise(wl.grad, torch.stack(gws).sum(0))
    finally:
        torch.backends.cudnn.deterministic = saved


# ---------------------------------------------------------------------------
# Low-precision decentralized and QAdam at VGG16's full width
# ---------------------------------------------------------------------------

#: low-precision decentralized's row: every VGG16 parameter (138,357,544,
#: padded to 4 ranks) one row per rank, 2.2 GB of f32 over the 4 rows
LP_ROWS = (4, 138_357_544)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [LP_ROWS, (3, 2**27 + 1)], ids=["vgg16-rows", "ragged"])
def test_codec_at_long_rows(cuda_device, shape):
    """Compress and decompress bitwise at the low-precision row (past 2^31
    bytes of input) and at a ragged long row (the scalar paths), one
    launch a call."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    x = torch.randn(shape, generator=gen, device=cuda_device) * 1e-3
    x[-1, -1] = 0.5  # the last row's range set by its last element
    check_compress(x)
    q, mm = port.compress_minmax_uint8_plain(x)
    del x
    out = port.decompress_minmax_uint8(q, mm)
    assert port.decompress_minmax_uint8.launches == 1
    assert bitwise(out, port.decompress_minmax_uint8_plain(q, mm))


def _vgg16_stacked(gen, device, ranks=4, scale=1.0):
    """Random rank-stacked tensors of VGG16's parameter shapes."""
    from bagua_tpu_torch.models.vgg import module_params, vgg16

    shapes = module_params(vgg16(device="meta"))
    return {m: {n: torch.randn((ranks, *t.shape), generator=gen, device=device) * scale
                for n, t in leaves.items()} for m, leaves in shapes.items()}


def _plain_codec(monkeypatch, module, names):
    for name in names:
        monkeypatch.setattr(module, name, getattr(port, f"{name}_plain"))


@pytest.mark.cuda
def test_low_precision_step_at_full_width_matches_plain_codec(cuda_device, monkeypatch):
    """One low-precision decentralized ``on_step_end`` on VGG16's whole
    model (one bucket, 4 ranks) with the kernels, and again with the plain
    codec on the card, on the same post-optimizer parameters and replicas:
    bit for bit; 1 compress and 3 decompresses."""
    from bagua_tpu_torch.algorithms import LowPrecisionDecentralizedAlgorithm
    from bagua_tpu_torch.algorithms import decentralized as dec
    from bagua_tpu_torch.algorithms.base import StepContext

    group = BaguaProcessGroup([cuda_device] * 4, intra_size=1)
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    params = _vgg16_stacked(gen, cuda_device, scale=1e-2)
    impl = LowPrecisionDecentralizedAlgorithm().reify(group)
    impl.bind_plan(impl.tensors_to_buckets({m: {n: t[0] for n, t in v.items()} for m, v in params.items()}))
    plan = impl._bound_plan
    assert plan.num_buckets == 1 and plan.specs[0].numel == LP_ROWS[1]
    flat = plan.bucketize(params)[0]
    state = {k: [flat + torch.randn(flat.shape, generator=gen, device=cuda_device) * 1e-3]
             for k in ("weight", "left", "right")}
    del flat
    ctx = StepContext(group, 0, plan)
    got_p, got = impl.on_step_end(params, state, ctx)
    got_p = plan.bucketize(got_p)[0]
    torch.cuda.synchronize()
    assert [port.compress_minmax_uint8.launches, port.decompress_minmax_uint8.launches] == [1, 3]
    _plain_codec(monkeypatch, dec, ("compress_minmax_uint8", "decompress_minmax_uint8"))
    want_p, want = impl.on_step_end(params, state, ctx)
    assert bitwise(got_p, plan.bucketize(want_p)[0])
    for key in ("weight", "left", "right"):
        assert bitwise(got[key][0], want[key][0])


@pytest.mark.cuda
def test_qadam_compression_step_at_full_width_matches_plain_codec(cuda_device, monkeypatch):
    """One QAdam compression step (``transform_gradients`` past warmup) on
    VGG16's gradients over 4 ranks in 10 MiB buckets with the kernels, and
    again with the plain codec on the card: the direction and the
    exchanged momentum bit for bit; one compress, fused reduce and
    decompress per bucket."""
    from bagua_tpu_torch.algorithms import QAdamAlgorithm, QAdamOptimizer, bytegrad
    from bagua_tpu_torch.algorithms.base import StepContext
    from bagua_tpu_torch.utils import tree_leaves

    group = BaguaProcessGroup([cuda_device] * 4, intra_size=1)
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    grads = _vgg16_stacked(gen, cuda_device, scale=1e-3)
    impl = QAdamAlgorithm(QAdamOptimizer(warmup_steps=2)).reify(group)
    impl.bind_plan(impl.tensors_to_buckets({m: {n: t[0] for n, t in v.items()} for m, v in grads.items()}))
    plan = impl._bound_plan
    state = {"exp_avg": _vgg16_stacked(gen, cuda_device, scale=1e-4),
             "exp_avg_sq": _vgg16_stacked(gen, cuda_device, scale=1e-4)}
    state["exp_avg_sq"] = {m: {n: t * t for n, t in v.items()} for m, v in state["exp_avg_sq"].items()}
    ctx = StepContext(group, 2, plan)
    got_d, _, got = impl.transform_gradients(grads, None, state, ctx)
    torch.cuda.synchronize()
    assert [fn.launches for fn in port.KERNELS] == [plan.num_buckets] * 3
    _plain_codec(monkeypatch, bytegrad, ("compress_minmax_uint8", "decompress_minmax_uint8",
                                         "decompress_reduce_requantize"))
    want_d, _, want = impl.transform_gradients(grads, None, state, ctx)
    for a, b in zip(tree_leaves(got_d) + tree_leaves(got["exp_avg"]), tree_leaves(want_d) + tree_leaves(want["exp_avg"])):
        assert bitwise(a, b)


# ---------------------------------------------------------------------------
# The relaxations on the card: async model average's streams, gossip's
# overlap, accumulation's launches
# ---------------------------------------------------------------------------


def _mlp_engine(device, algorithm, lr=0.05, overlap=False, bucket=1 << 7, ranks=4):
    from bagua_tpu_torch.ddp import DistributedDataParallel
    from bagua_tpu_torch.models import mlp

    group = BaguaProcessGroup([device] * ranks, intra_size=1)
    return DistributedDataParallel(mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=lr), algorithm, group,
                                   bucket_size_bytes=bucket, overlap=overlap)


def _spread_mlp(device, ranks=4, seed=0):
    """Rank-stacked MLP [10, 16, 3] parameters, rank r's copy shifted by r."""
    from bagua_tpu_torch.models import mlp
    from bagua_tpu_torch.utils import tree_map

    base = mlp.init_mlp(torch.Generator(device=device).manual_seed(seed), [10, 16, 3], device=device)
    return tree_map(lambda t: torch.stack([t + r for r in range(ranks)]), base)


def _mlp_batch(device, seed, rows=32):
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn((rows, 10), generator=gen, device=device),
            torch.randn((rows, 3), generator=gen, device=device))


@pytest.mark.cuda
def test_async_delta_waits_for_the_step_and_the_optimizer_waits_for_it(cuda_device, monkeypatch):
    """The delta runs on the averager's own stream, made slow here (the
    stream spins first), while the next step is enqueued: the delta still
    reads the parameters of the step before it (the training stream waits
    for its ``done`` before the optimizer writes them), it is not marked
    ready while in flight, and it is folded only once ``done`` has
    completed."""
    from bagua_tpu_torch.algorithms import AsyncModelAverageAlgorithm
    from bagua_tpu_torch.utils import tree_leaves, tree_map

    ddp = _mlp_engine(cuda_device, AsyncModelAverageAlgorithm(sync_interval_ms=10 ** 9), lr=0.05)
    impl = ddp.impl
    state = ddp.init(stacked_params=_spread_mlp(cuda_device))
    delta_of = impl._delta

    def slow_delta(snapshot):
        torch.cuda._sleep(200_000_000)  # about 0.1 s on the averager's stream
        return delta_of(snapshot)

    folded_after_done = []
    fold = impl._fold

    def checked_fold(params, delta, done):
        folded_after_done.append(done.query())
        return fold(params, delta, done)

    monkeypatch.setattr(impl, "_delta", slow_delta)
    monkeypatch.setattr(impl, "_fold", checked_fold)
    try:
        state, _ = ddp.train_step(state, _mlp_batch(cuda_device, 0))
        torch.cuda.synchronize()
        snapshot = tree_map(torch.clone, state.params)
        impl._cycle(wait=False)
        gen, delta, done = impl._pending
        assert not impl._pending_ready and not done.query()
        state, _ = ddp.train_step(state, _mlp_batch(cuda_device, 1))  # in flight: no fold
        assert impl.folds_applied == 0 and impl._pending is not None
        impl._watch_pending(impl._stop_event)
        assert impl._pending_ready and done.query()
        torch.cuda.synchronize()
        want = delta_of(snapshot)
        for got, w in zip(tree_leaves(delta), tree_leaves(want)):
            assert bitwise(got, w)
        state, _ = ddp.train_step(state, _mlp_batch(cuda_device, 2))
        assert impl.folds_applied == 1 and folded_after_done == [True]
    finally:
        ddp.shutdown()


@pytest.mark.cuda
def test_async_training_thread_never_waits_for_the_card(cuda_device, monkeypatch):
    """With the averager thread running (every 5 ms), the training thread's
    steps call no synchronize and query no event: only the averager thread
    does; the averages fold, and shutdown leaves no thread alive."""
    import threading
    import time

    from bagua_tpu_torch.algorithms import AsyncModelAverageAlgorithm

    ddp = _mlp_engine(cuda_device, AsyncModelAverageAlgorithm(sync_interval_ms=5), lr=0.0)
    state = ddp.init(stacked_params=_spread_mlp(cuda_device, seed=1))
    batch = _mlp_batch(cuda_device, 3)
    calls = []
    main = threading.current_thread()

    def recording(cls, name):
        orig = getattr(cls, name)

        def fn(*args, **kwargs):
            calls.append((threading.current_thread() is main, f"{cls.__name__}.{name}"))
            return orig(*args, **kwargs)
        monkeypatch.setattr(cls, name, fn)

    for cls, name in ((torch.cuda.Event, "synchronize"), (torch.cuda.Event, "query"),
                      (torch.cuda.Stream, "synchronize"), (torch.cuda.Stream, "query")):
        recording(cls, name)
    sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: (calls.append((threading.current_thread() is main, "synchronize")),
                                         sync(*a, **k))[1])
    try:
        deadline = time.monotonic() + 20.0
        while ddp.impl.folds_applied < 3 and time.monotonic() < deadline:
            state, _ = ddp.train_step(state, batch)
        on_main = [c for is_main, c in calls if is_main]
        assert ddp.impl.folds_applied >= 3 and ddp.impl.folds_failed == 0
        assert not on_main, on_main
        assert any(not is_main for is_main, _ in calls)
    finally:
        ddp.shutdown()
    assert not [t for t in threading.enumerate() if t.name == "bagua-async-averager"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["all", "shift_one"])
def test_gossip_overlap_equals_monolithic_on_card(cuda_device, mode):
    """Gossip decentralized SGD (τ 1, rank 2 under the directive) on a
    small VGG, cuDNN deterministic: the weight-mode overlap run (each
    bucket's round on the side stream, its published flat stashed there)
    equals the monolithic run bit for bit, parameters, published replicas
    and counters."""
    from bagua_tpu_torch.algorithms import DecentralizedAlgorithm
    from bagua_tpu_torch.ddp import DistributedDataParallel
    from bagua_tpu_torch.models.vgg import VGG, module_params, vgg_loss_fn
    from bagua_tpu_torch.utils import tree_leaves

    small = dict(num_classes=10, cfg=(16, "M", 32, "M"), classifier_width=64, image_size=32)
    params = module_params(VGG(device=cuda_device, generator=torch.Generator(device=cuda_device).manual_seed(2),
                               **small))
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    batch = (torch.rand((32, 32, 32, 3), generator=gen, device=cuda_device),
             torch.randint(0, 10, (32,), generator=gen, device=cuda_device))
    runs = {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for overlap in (False, True):
            ddp = DistributedDataParallel(
                vgg_loss_fn(VGG(device=cuda_device, **small)), lambda ps: torch.optim.SGD(ps, lr=0.05),
                DecentralizedAlgorithm(hierarchical=False, peer_selection_mode=mode, staleness_tau=1),
                BaguaProcessGroup([cuda_device] * 4, intra_size=1), bucket_size_bytes=1 << 16, overlap=overlap)
            state = ddp.apply_degradation_directive(ddp.init(params), (2,))
            for _ in range(4):
                state, _ = ddp.train_step(state, batch)
            published = ddp.plan.debucketize(list(state.algo_state["published"]), state.params)
            runs[overlap] = (ddp, tree_leaves(state.params) + tree_leaves(published), state.algo_state["staleness"])
    finally:
        torch.backends.cudnn.deterministic = saved
    assert runs[True][0].overlap_enabled and runs[True][0].plan.num_buckets > 1
    assert all(bitwise(a, b) for a, b in zip(runs[False][1], runs[True][1]))
    assert runs[False][2].tolist() == runs[True][2].tolist() == [0, 0, 0, 0]


@pytest.mark.cuda
def test_accumulated_bytegrad_launches(cuda_device):
    """GradientAccumulation(ByteGrad, every=2), 6 steps: ByteGrad's three
    kernels launch once a bucket on the 3 boundary steps only, and the
    ranks stay bitwise equal."""
    from bagua_tpu_torch.algorithms import ByteGradAlgorithm, GradientAccumulation
    from bagua_tpu_torch.models import mlp
    from bagua_tpu_torch.utils import tree_leaves

    ddp = _mlp_engine(cuda_device, GradientAccumulation(ByteGradAlgorithm(), every=2))
    state = ddp.init(mlp.init_mlp(torch.Generator(device=cuda_device).manual_seed(4), [10, 16, 3],
                                  device=cuda_device))
    for i in range(6):
        state, _ = ddp.train_step(state, _mlp_batch(cuda_device, 10 + i))
        if i == 0:
            assert [fn.launches for fn in port.KERNELS] == [0, 0, 0]
    assert ddp.plan.num_buckets > 1
    assert [fn.launches for fn in port.KERNELS] == [3 * ddp.plan.num_buckets] * 3
    for leaf in tree_leaves(state.params):
        assert all(torch.equal(leaf[0], leaf[r]) for r in range(1, 4))
