"""The port's quantized ring against the JAX package's, on an 8-rank CPU group.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
side runs its ring under ``group.shard_map`` with the jnp hop, as
``tests/test_quantized_ring.py`` does; the port runs the same group as
``[cpu] * 8``, where its wrappers take their plain versions.  The int4
codec, the hop, the ring collectives and the bucket exchange must agree bit
for bit; training agrees within a tolerance derived from the quantization
level width.  The CUDA hop is held against its plain version in
``test_torch_kernels_cuda.py``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from bagua_tpu.algorithms.base import StepContext as JaxStepContext
from bagua_tpu.algorithms.gradient_allreduce import GradientAllReduceAlgorithm as JaxGAR
from bagua_tpu.communication import ALL_AXES, ppermute_shift as jax_ppermute_shift, rank_id as jax_rank_id
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP
from bagua_tpu.kernels import quantized_ring as ref
from bagua_tpu.models import mlp as jax_mlp

from bagua_tpu_torch.algorithms import GradientAllReduceAlgorithm
from bagua_tpu_torch.algorithms.base import StepContext
from bagua_tpu_torch.communication import BaguaProcessGroup, ppermute_shift, rank_id
from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.kernels import minmax_uint8, quantized_ring as port
from bagua_tpu_torch.models import mlp
from bagua_tpu_torch.trainer import Trainer
from bagua_tpu_torch.utils import tree_leaves


@pytest.fixture()
def tgroup():
    return BaguaProcessGroup([torch.device("cpu")] * 8, intra_size=4)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    kernels = port.KERNELS + minmax_uint8.KERNELS
    for fn in kernels:
        fn.launches = 0
    yield
    assert [fn.launches for fn in kernels] == [0] * len(kernels)
    assert port.hop_dequant_add_requant.launches_by_bits == {8: 0, 4: 0}


def assert_bitwise(got, want):
    """Bit for bit; a NaN matches a NaN whatever its sign and payload, which
    the CPU's instructions choose (an inf - inf gives either sign)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    if got.dtype == np.float32:
        nan = np.isnan(got)
        np.testing.assert_array_equal(nan, np.isnan(want))
        got, want = got[~nan].view(np.uint32), want[~nan].view(np.uint32)
    np.testing.assert_array_equal(got, want)


def per_rank_jax(group, fn, *xs, n_out=1):
    """Run ``fn`` on each rank's slices of the stacked ``xs`` under
    shard_map; returns the stacked outputs as numpy arrays."""
    spec = P(ALL_AXES)
    f = jax.jit(group.shard_map(
        lambda *v: tuple(o[None] for o in fn(*(a[0] for a in v))),
        in_specs=(spec,) * len(xs), out_specs=(spec,) * n_out,
    ))
    return [np.asarray(o) for o in f(*(jnp.asarray(x) for x in xs))]


# ---------------------------------------------------------------------------
# Ring shift and member index
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axis", [None, "inter", "intra"])
def test_ppermute_shift_and_rank_id_match_jax(group, tgroup, axis):
    x = np.random.RandomState(0).randn(8, 5).astype(np.float32)
    axes = ALL_AXES if axis is None else axis
    for shift in (1, 3):
        want, = per_rank_jax(group, lambda v: (jax_ppermute_shift(v, shift, axes),), x)
        assert_bitwise(ppermute_shift(torch.from_numpy(x), shift, tgroup, axis).numpy(), want)
    want, = per_rank_jax(group, lambda v: (jax_rank_id(axes) + 0 * v[0].astype(jnp.int32),), x)
    np.testing.assert_array_equal(rank_id(tgroup, axis).numpy(), want)


# ---------------------------------------------------------------------------
# The int4 codec and the hop
# ---------------------------------------------------------------------------


def _int4_cases():
    rng = np.random.RandomState(1)
    nan = rng.randn(3, 64).astype(np.float32)
    nan[1, 40] = np.nan
    mixed = rng.randn(4, 128).astype(np.float32)
    mixed[1], mixed[3] = 0.0, -2.5e33
    return {
        "random": (rng.randn(4, 512) * 3.0).astype(np.float32),
        "ragged B=6": rng.randn(5, 6).astype(np.float32),
        "ragged B=130": rng.randn(3, 130).astype(np.float32),
        "one NaN": nan,
        "constant 1.5": np.full((2, 64), 1.5, np.float32),
        "constant 2.7e33": np.full((2, 64), 2.7e33, np.float32),
        "constant -8e31": np.full((2, 64), -8e31, np.float32),
        "constant f32 max": np.full((2, 8), 3.4e38, np.float32),
        "mixed": mixed,
        "signed zeros": np.array([[0.0, -0.0, 1.0, 2.0], [-0.0, 0.0, -1.0, -2.0],
                                  [-0.0] * 4, [0.0] * 4], np.float32),
    }


@pytest.mark.parametrize("case", list(_int4_cases()))
def test_uint4_codec_bitwise(case):
    x = _int4_cases()[case]
    packed, mm = port.compress_minmax_uint4(torch.from_numpy(x))
    packed_ref, mm_ref = ref.compress_minmax_uint4(jnp.asarray(x))
    assert_bitwise(packed.numpy(), packed_ref)
    assert_bitwise(mm.numpy(), mm_ref)
    assert_bitwise(port.decompress_minmax_uint4(packed, mm).numpy(),
                   ref.decompress_minmax_uint4(packed_ref, mm_ref))


def test_int32_convert_follows_xla():
    """XLA's f32 -> s32 convert saturates and sends NaN to 0; the int4
    codec packs through it."""
    v = np.array([np.nan, 1e10, -1e10, 3.7, -3.7, 16.0], np.float32)
    want = np.asarray(jnp.asarray(v).astype(jnp.int32))
    np.testing.assert_array_equal(port._to_int32(torch.from_numpy(v)).numpy(), want)


def level_sidecars():
    """(min, max) rows of several kinds: random ranges, constant blocks, huge
    (3.4e38) and tiny (1e-38) magnitudes."""
    rng = np.random.RandomState(14)
    lo = (rng.randn(6) * 3.0).astype(np.float32)
    return {
        "random": np.stack([lo, lo + np.abs(rng.randn(6)).astype(np.float32) * 5.0], 1),
        "constant": np.array([[1.5, 1.5], [0.0, 0.0], [-7.0, -7.0], [2.5, 2.5]], np.float32),
        "huge": np.array([[3.4e38, 3.4e38], [-3.4e38, 3.4e38], [1e32, 3.4e38], [-3.4e38, -1e30]],
                         np.float32),
        "tiny": np.array([[1e-38, 1e-38], [-1e-38, 1e-38], [0.0, 1e-38], [-1e-38, 0.0]], np.float32),
    }


@pytest.mark.parametrize("case", list(level_sidecars()))
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_hop_level_table_is_the_dequantize(bits, case):
    """The hop kernel looks the incoming package's values (and, after the
    min/max, the requantized levels' values for err) up in a table of the
    row's 256 or 16 levels instead of dividing: the table equals the JAX
    package's dequantize of those levels, bit for bit.  int4 packs level j
    into both nibbles of byte j, so both halves of the block read the table."""
    mm = level_sidecars()[case]
    rows, count = mm.shape[0], 256 if bits == 8 else 16
    got = minmax_uint8.level_table_plain(torch.from_numpy(mm), 255.0 if bits == 8 else port.LEVELS4)
    if bits == 8:
        levels = np.tile(np.arange(count, dtype=np.uint8), (rows, 1))
        want = ref.decompress_minmax_uint8(jnp.asarray(levels), jnp.asarray(mm))
    else:
        packed = np.tile((np.arange(count) * 0x11).astype(np.uint8), (rows, 1))
        want = np.asarray(ref.decompress_minmax_uint4(jnp.asarray(packed), jnp.asarray(mm)))
        assert_bitwise(want[:, :count], want[:, count:])
        want = want[:, :count]
    assert_bitwise(got.numpy(), want)


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("case", list(_int4_cases()))
def test_hop_plain_bitwise(bits, case):
    """The hop on the same incoming packages and local partials, bitwise:
    the incoming blocks are compressed by the JAX package first."""
    incoming = _int4_cases()[case]
    local = np.random.RandomState(2).randn(*incoming.shape).astype(np.float32) * 2.0
    if case.startswith("constant"):
        local = incoming.copy()  # the sum stays constant: the degenerate requantize
    comp = ref.compress_minmax_uint8 if bits == 8 else ref.compress_minmax_uint4
    q, mm = comp(jnp.asarray(incoming))
    want = ref.hop_dequant_add_requant(q, mm, jnp.asarray(local), bits=bits)
    got = port.hop_dequant_add_requant(
        torch.from_numpy(np.array(q)), torch.from_numpy(np.array(mm)), torch.from_numpy(local), bits
    )
    for g, w in zip(got, want):
        assert_bitwise(g.numpy(), w)


def test_hop_refuses_other_devices():
    """A tensor neither on the CPU nor on a card reaches no plain version."""
    with pytest.raises(ValueError, match="CPU or CUDA"):
        port.hop_dequant_add_requant(
            torch.empty((2, 8), dtype=torch.uint8, device="meta"),
            torch.empty((2, 2), device="meta"), torch.empty((2, 8), device="meta"), 8,
        )


# ---------------------------------------------------------------------------
# The ring collectives
# ---------------------------------------------------------------------------

RING_CASES = [(64, None), (4096, None), (64, "inter"), (64, "intra")]
RING_IDS = ["b64-all", "b4096-all", "b64-inter", "b64-intra"]


def _ring_input(block, axis, seed):
    """Per-rank flats whose shard is not a whole number of blocks."""
    n = {None: 8, "inter": 2, "intra": 4}[axis]
    S = 96 if block == 64 else block + 100
    return np.random.RandomState(seed).randn(8, n * S).astype(np.float32), n


@pytest.mark.parametrize("block,axis", RING_CASES, ids=RING_IDS)
@pytest.mark.parametrize("average", [True, False], ids=["avg", "sum"])
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_ring_reduce_scatter_bitwise(group, tgroup, bits, average, block, axis):
    x, _ = _ring_input(block, axis, seed=3)
    axes = ALL_AXES if axis is None else axis
    want = per_rank_jax(group, lambda v: ref.quantized_ring_reduce_scatter(
        v, axes, bits=bits, average=average, block=block), x, n_out=2)
    got = port.quantized_ring_reduce_scatter(
        torch.from_numpy(x), tgroup, axis, bits=bits, average=average, block=block)
    for g, w in zip(got, want):
        assert_bitwise(g.numpy(), w)


@pytest.mark.parametrize("block,axis", [(64, None), (64, "inter")], ids=["b64-all", "b64-inter"])
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_quantized_allgather_bitwise(group, tgroup, bits, block, axis):
    shards = np.random.RandomState(4).randn(8, 96).astype(np.float32)
    axes = ALL_AXES if axis is None else axis
    want = per_rank_jax(group, lambda v: ref.quantized_allgather(v, axes, bits=bits, block=block),
                        shards, n_out=2)
    got = port.quantized_allgather(torch.from_numpy(shards), tgroup, axis, bits=bits, block=block)
    for g, w in zip(got, want):
        assert_bitwise(g.numpy(), w)


@pytest.mark.parametrize("block,axis", RING_CASES, ids=RING_IDS)
@pytest.mark.parametrize("average", [True, False], ids=["avg", "sum"])
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_ring_allreduce_bitwise_and_tally(group, tgroup, bits, average, block, axis):
    """The allreduce, bitwise; and the bytes the ring's shifts and gathers
    carry for one rank equal ``ring_wire_bytes`` exactly."""
    x, n = _ring_input(block, axis, seed=5)
    axes = ALL_AXES if axis is None else axis
    want = per_rank_jax(group, lambda v: ref.quantized_ring_allreduce(
        v, axes, bits=bits, average=average, block=block), x, n_out=2)
    port.TALLY.bytes_per_rank = 0
    got = port.quantized_ring_allreduce(
        torch.from_numpy(x), tgroup, axis, bits=bits, average=average, block=block)
    for g, w in zip(got, want):
        assert_bitwise(g.numpy(), w)
    assert port.TALLY.bytes_per_rank == port.ring_wire_bytes(x.shape[1], n, bits, block)
    assert port.TALLY.bytes_per_rank == ref.ring_wire_bytes(x.shape[1], n, bits, block)


# ---------------------------------------------------------------------------
# The bucket exchange and the precision plumbing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["int8", "int4"])
@pytest.mark.parametrize("hierarchical", [False, True], ids=["flat", "hier"])
def test_quantized_bucket_allreduce_bitwise(group, tgroup, monkeypatch, hierarchical, precision):
    """One bucket's exchange on the same per-rank flats and residuals,
    bitwise: the hierarchical leg's f32 intra sum of 4 peers rounds the same
    in both packages on these inputs."""
    monkeypatch.setenv("BAGUA_QR_BLOCK", "64")
    rng = np.random.RandomState(6)
    x = rng.randn(8, 8 * 96).astype(np.float32)
    resid = (rng.randn(8, 8 * 96) * 1e-2).astype(np.float32)
    spec = types.SimpleNamespace(numel=x.shape[1], dtype="f32")
    jimpl = JaxGAR(hierarchical=hierarchical, wire_precision=precision).reify(group)
    timpl = GradientAllReduceAlgorithm(hierarchical=hierarchical, wire_precision=precision).reify(tgroup)
    want = per_rank_jax(group, lambda v, r: jimpl._quantized_bucket_allreduce([v], spec, precision, r),
                        x, resid, n_out=2)
    got = timpl._quantized_bucket_allreduce(torch.from_numpy(x), precision, torch.from_numpy(resid))
    for g, w in zip(got, want):
        assert_bitwise(g.numpy(), w)
    want_out, = per_rank_jax(
        group, lambda v: jimpl._quantized_bucket_allreduce([v], spec, precision, None)[:1], x)
    out, none = timpl._quantized_bucket_allreduce(torch.from_numpy(x), precision, None)
    assert none is None
    assert_bitwise(out.numpy(), want_out)


LAYERS = [10, 16, 4]  # 512-byte buckets: 3 buckets (16, 160, 72 elements)
PLAN = ["int8", "f32", "int4"]


def test_precision_plumbing_matches_jax(group, tgroup, monkeypatch):
    """``bucket_precisions``, plan validation and ``wire_bytes_by_precision``
    agree with the JAX mixin on the same plan; ``apply_precision_plan``
    reports whether anything changed."""
    monkeypatch.setenv("BAGUA_DEFAULT_BUCKET_SIZE", "512")
    jparams = jax.tree.map(np.asarray, jax_mlp.init_mlp(jax.random.PRNGKey(0), LAYERS))
    jimpl = JaxGAR(wire_precision="auto").reify(group)
    jplan = jimpl.tensors_to_buckets(jparams)
    jimpl.bind_plan(jplan)
    trainer = Trainer(mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.1),
                      GradientAllReduceAlgorithm(wire_precision="auto"), tgroup)
    trainer.init_state(params_from_jax(jparams))
    timpl, tplan = trainer.ddp.impl, trainer.ddp.plan
    assert tplan.num_buckets == len(PLAN)
    assert timpl.bucket_precisions(tplan) == jimpl.bucket_precisions(jplan) == ["f32"] * 3
    assert timpl.wire_bytes_by_precision(tplan) == jimpl.wire_bytes_by_precision(jplan)
    assert trainer.ddp.apply_precision_plan(PLAN)
    assert not trainer.ddp.apply_precision_plan(PLAN)
    jimpl.set_bucket_precision(PLAN)
    assert timpl.bucket_precisions(tplan) == PLAN
    assert timpl.wire_bytes_by_precision(tplan) == jimpl.wire_bytes_by_precision(jplan)
    with pytest.raises(ValueError, match="entries for 3 buckets"):
        timpl.set_bucket_precision(["int8"])
    with pytest.raises(ValueError, match="unknown wire precisions"):
        timpl.set_bucket_precision(["int2"] * 3)
    assert trainer.ddp.apply_precision_plan(None, reason="health:nan")
    pinned = GradientAllReduceAlgorithm(wire_precision="int8").reify(tgroup)
    with pytest.raises(ValueError, match="auto"):
        pinned.set_bucket_precision(PLAN)
    from bagua_tpu_torch.algorithms import ByteGradAlgorithm

    bg = Trainer(mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.1), ByteGradAlgorithm(), tgroup)
    with pytest.raises(AttributeError, match="no wire_precision knob"):
        bg.ddp.apply_precision_plan(PLAN)


ALGOS = {
    "int8": dict(wire_precision="int8"),
    "int4": dict(wire_precision="int4"),
    "hier_int8": dict(hierarchical=True, wire_precision="int8"),
    "hier_int4": dict(hierarchical=True, wire_precision="int4"),
    "auto_plan": dict(wire_precision="auto"),
}


@pytest.mark.parametrize("algo", list(ALGOS))
def test_transform_gradients_threads_state_bitwise(group, tgroup, monkeypatch, algo):
    """Three steps of ``transform_gradients`` on the same per-rank gradients,
    each package threading its own algorithm state: the reduced gradients
    and the int4 ``qr_residual`` carried from step to step agree bit for
    bit.  Under ``auto`` the plan mixes int8, f32 and int4 buckets."""
    monkeypatch.setenv("BAGUA_DEFAULT_BUCKET_SIZE", "512")
    monkeypatch.setenv("BAGUA_QR_BLOCK", "16")
    jparams = jax.tree.map(np.asarray, jax_mlp.init_mlp(jax.random.PRNGKey(0), LAYERS))
    jimpl = JaxGAR(**ALGOS[algo]).reify(group)
    jplan = jimpl.tensors_to_buckets(jparams)
    jimpl.bind_plan(jplan)
    jstate = jax.tree.map(lambda a: np.stack([np.asarray(a)] * 8), jimpl.init_state(jparams))
    trainer = Trainer(mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.1),
                      GradientAllReduceAlgorithm(**ALGOS[algo]), tgroup)
    tstate = trainer.init_state(params_from_jax(jparams)).algo_state
    timpl, tplan = trainer.ddp.impl, trainer.ddp.plan
    if algo == "auto_plan":
        jimpl.set_bucket_precision(PLAN)
        timpl.set_bucket_precision(PLAN)
    assert timpl.bucket_precisions(tplan) == jimpl.bucket_precisions(jplan)

    spec = P(ALL_AXES)

    def local(g, s):
        g, s = jax.tree.map(lambda a: a[0], (g, s))
        ctx = JaxStepContext(group=group, step=jnp.int32(0), plan=jplan)
        g, _, s = jimpl.transform_gradients(g, None, s, ctx)
        return jax.tree.map(lambda a: a[None], (g, s))

    jax_step = jax.jit(group.shard_map(local, in_specs=(spec, spec), out_specs=(spec, spec)))
    rng = np.random.RandomState(12)
    for step in range(3):
        grads = jax.tree.map(lambda a: rng.randn(8, *a.shape).astype(np.float32), jparams)
        want, jstate = jax_step(grads, jstate)
        got, _, tstate = timpl.transform_gradients(
            params_from_jax(grads), None, tstate, StepContext(group=tgroup, step=step, plan=tplan))
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert_bitwise(g.numpy(), np.asarray(w))
        assert sorted(tstate) == sorted(jstate)
        for g, w in zip(tstate.get("qr_residual", ()), jstate.get("qr_residual", ())):
            assert_bitwise(g.numpy(), np.asarray(w))
    if "int4" in algo or algo == "auto_plan":
        resid = tstate["qr_residual"]
        int4 = [i for i, p in enumerate(timpl.bucket_precisions(tplan)) if p == "int4"]
        assert int4 and all(bool(resid[i].abs().max() > 0) for i in int4)


def test_resolve_block(monkeypatch):
    assert port.resolve_block() == 4096
    monkeypatch.setenv("BAGUA_QR_BLOCK", "512")
    assert port.resolve_block() == 512
    assert port.resolve_block(128) == 128
    for bad in (7, 0):
        with pytest.raises(ValueError, match="even"):
            port.resolve_block(bad)
    monkeypatch.setenv("BAGUA_QR_BLOCK", "9")
    with pytest.raises(ValueError, match="even"):
        port.resolve_block()


# ---------------------------------------------------------------------------
# Trainer.fit against the JAX package's DDP
# ---------------------------------------------------------------------------

LR, STEPS = 0.05, 3


def _batches():
    rng = np.random.RandomState(7)
    return [
        (rng.randn(32, LAYERS[0]).astype(np.float32), rng.randn(32, LAYERS[-1]).astype(np.float32))
        for _ in range(STEPS)
    ]


def _level_width(trainer, state, batch) -> float:
    """The widest quantization level the ring can meet this step, in units
    of the averaged gradient: every partial sum of a bucket lies within plus
    or minus the sum over ranks of each rank's largest |gradient +
    residual|, cut into 15 levels (int4) or 255 (int8) and divided by the
    n = 8 ranks of the average."""
    _, grads = trainer.ddp._rank_grads(state.params, batch)
    impl = trainer.ddp.impl
    resid = state.algo_state.get("qr_residual")
    width = 0.0
    for i, (flat, prec) in enumerate(zip(trainer.ddp.plan.bucketize(grads),
                                         impl.bucket_precisions(trainer.ddp.plan))):
        if prec == "f32":
            continue
        if resid is not None and prec == "int4":
            flat = flat + resid[i]
        levels = 255.0 if prec == "int8" else 15.0
        width = max(width, 2.0 * float(flat.abs().amax(1).sum()) / levels / flat.shape[0])
    return width


def assert_within_levels(got, want, level: float, what: str) -> None:
    """``got`` against ``want`` where the two runs' gradients differ only in
    their last bits.  Where no quantization level flipped, that moves an
    element far less than a thousandth of ``level``; a flip moves it by at
    most ``level`` and disturbs only its block, so at most 5% of the
    elements may lie beyond the thousandth.  A run that skips the update,
    the quantization or the error feedback moves nearly every element by a
    sizeable part of a level and fails."""
    d = np.concatenate([np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64)).ravel()
                        for g, w in zip(got, want)])
    flipped = int((d > 1e-3 * level).sum())
    assert d.max() <= level, f"{what}: {d.max():.3e} apart, more than a level {level:.3e}"
    assert flipped <= 0.05 * d.size, f"{what}: {flipped} of {d.size} elements beyond rounding"


@pytest.mark.parametrize("algo", ["int8", "int4", "hier_int8", "auto_plan"])
def test_trainer_fit_matches_jax_ddp(group, tgroup, monkeypatch, algo):
    """Both engines train the same MLP on the same batches; the matmuls sum
    in another order, so the gradients differ in their last bits.  The
    parameters agree within STEPS x LR x the widest averaged level, the
    int4 residuals within one level in sum space (n = 8 averaged levels),
    each as :func:`assert_within_levels` reads it.  The ranks stay bitwise
    equal; int4 and auto carry non-zero residuals."""
    monkeypatch.setenv("BAGUA_DEFAULT_BUCKET_SIZE", "512")
    monkeypatch.setenv("BAGUA_QR_BLOCK", "16")
    kw = ALGOS[algo]
    jparams = jax_mlp.init_mlp(jax.random.PRNGKey(11), LAYERS)
    ddp = JaxDDP(jax_mlp.mse_loss, optax.sgd(LR), JaxGAR(**kw), process_group=group)
    jstate = ddp.init(jparams)
    trainer = Trainer(mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=LR),
                      GradientAllReduceAlgorithm(**kw), tgroup)
    state = trainer.init_state(params_from_jax(jax.tree.map(np.asarray, jparams)))
    if algo == "auto_plan":
        assert ddp.apply_precision_plan(PLAN) and trainer.ddp.apply_precision_plan(PLAN)
    assert trainer.ddp.impl.bucket_precisions(trainer.ddp.plan) == ddp.impl.bucket_precisions(ddp.plan)

    width = 0.0
    for x, y in _batches():
        jstate, _ = ddp.train_step(jstate, (jnp.asarray(x), jnp.asarray(y)))
        batch = (torch.from_numpy(x), torch.from_numpy(y))
        width = max(width, _level_width(trainer, state, batch))
        state = trainer.fit(state, [batch], n_steps=1)
    assert state.step == STEPS and width > 0

    for leaf in tree_leaves(state.params):
        for r in range(1, 8):
            assert torch.equal(leaf[0], leaf[r])
    assert_within_levels(tree_leaves(trainer.ddp.params_unstacked(state)),
                         jax.tree.leaves(ddp.params_unstacked(jstate)), STEPS * LR * width, "parameters")

    resid = state.algo_state.get("qr_residual")
    if algo in ("int4", "auto_plan"):
        assert len(resid) == trainer.ddp.plan.num_buckets
        for r, spec in zip(resid, trainer.ddp.plan.specs):
            assert r.shape == (8, spec.numel) and r.dtype == torch.float32
        assert any(bool(r.abs().max() > 0) for r in resid)
        assert_within_levels(resid, jstate.algo_state["qr_residual"], 8 * width, "residuals")
    else:
        assert resid is None
