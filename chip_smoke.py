#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bagua_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Phases, in order; the first that fails ends the run with a non-zero exit
and no result line:

1. device  -- a CUDA device must be visible; prints the card's name and
   power limit as ``nvidia-smi`` gives them.
2. build   -- builds the CUDA sources of ``bagua_tpu_torch/kernels/csrc``
   with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per source, in parallel).
3. kernels -- holds each kernel against its plain PyTorch version at the
   main paths' shapes, at ragged and at degenerate ones: the codec and hop
   kernels bitwise (VGG16's 10 MiB buckets over 4 ranks: ByteGrad's chunks
   and the quantized ring's blocks of 4096, where the int8 ring compresses
   and decompresses twice a step; those four calls are summed per int8-ring
   step on ``[kernels]`` lines of their own; low-precision decentralized's
   whole-model row a rank, ``(4, 138,357,544)``, each 10 MiB bucket one
   row a rank as its overlap run compresses it, and a ragged ``(3, 2^27 +
   1)``, its compress and three decompresses summed per step, monolithic
   and overlap, on lines of their own), the three attention kernels
   within ATTENTION_TOLS (the Llama slice's half-blocks, 4 ranks folded
   into the batch, 32 heads of 128; GQA, bf16 K/V, 200x300 with d 24 and
   64, a fully masked block, first-key-only rows), the tile GEMM of the
   collective-matmul rings within ``matmul_tol`` of ``x @ w`` (path (a)'s
   five products, the backward's through transposed views, the rings'
   row-block views; edge shapes; a rank batch with a stride-0 operand),
   a tolerance that TF32-rounded inputs miss at path (a)'s shapes; bf16,
   f16 and f64 operands take ``x @ w`` with no launch (the reference's rule).
   Times them with CUDA events (the median of 5 batches of 10 back-to-back
   calls, each batch enqueued while the card is kept busy, after 3 warm-up
   calls) beside the least time the card could take (bytes over 3.35 TB/s,
   or operations over 67 TFLOP/s f32), summed over one step of its slice;
   the attention kernels also beside ``F.scaled_dot_product_attention`` on
   the same blocks (forward; forward + backward less the forward), the
   tile GEMM beside ``torch.matmul``.  Then the two rings at path (a)'s
   shapes: ``ag_matmul`` bidir bitwise equal to uni, both rings equal to
   ``allgather`` + matmul and ``allreduce`` + slice.
4. reference -- trains a small f32 VGG with ByteGrad, with the int8 ring,
   with the int4 ring, with the f32 wire and with ZeRO on each of the four,
   a small Llama over 4 zigzag ranks and at tp 2 x sp 2, and the fused
   sequence-parallel MLP pair at tp 4, on the card and on the CPU (plain
   versions) from the same weights and data, and holds each pair of runs'
   losses and parameters together within stated tolerances; the small
   VGG's runs but int4's take the overlap mode (the engine's default), and
   on the card (cuDNN deterministic, this phase only) they equal the
   monolithic runs bit for bit, and ZeRO's f32 and ByteGrad runs the
   unsharded f32 and ByteGrad runs; then decentralized SGD (``all``,
   ``shift_one``), low-precision decentralized and QAdam on the small VGG,
   card against CPU, each also with overlap on the card (bitwise equal to
   monolithic; low precision within ``LP_OVERLAP_TOL``).
5. slice   -- trains full-width VGG16 (224x224, 1000 classes, bf16
   compute, f32 parameters, batch 32 per rank) over 4 ranks on this one
   card through ``Trainer.fit`` with the monolithic step (``overlap=False``),
   5 steps each with ByteGrad (``intra_size=1``:
   every rank its own node, so the whole exchange is compressed) and with
   ``GradientAllReduceAlgorithm(wire_precision="int8")`` and ``"int4"``
   (flat: a ring of 4, 2 hops per bucket); then through the synthetic
   benchmark's twin (``examples/synthetic_benchmark.run``) with ByteGrad,
   the int8 ring and the f32 wire (``fuse="tuple"``), 5 steps monolithic
   and 5 with every bucket's exchange issued from inside the backward pass
   on a side stream (overlap), checking that each bucket is exchanged once
   a step in ``backward_order()``; then ZeRO through the twin (reduce-scatter,
   an optimizer step on each rank's shards, the parameters' all-gather at
   the next step's start): the f32 wire, ByteGrad and the int8 ring with
   overlap, ByteGrad and the int4 ring monolithic, 5 steps each, with the
   optimizer state per rank; then the decentralized pair and QAdam through
   the twin, 6 steps each (``DP_PATHS``: launches per step and bucket, the
   census, the algorithm state per rank); then the MNIST twin
   (``gradient_allreduce`` + Adam and ``"none"``); then Llama at ``llama_7b_config``'s
   width (2 layers, one sequence of 4096 tokens, f32) over 4 ranks, 5 AdamW
   steps of ``examples.llama_pretrain.train_step``, once as 4 zigzag ring
   ranks (sp 4) and once at tp 2 x sp 2 (path (b)); then path (a): the
   fused sequence-parallel MLP pair (``ColumnParallelDense(gather_input)``
   -> GELU -> ``RowParallelDense(scatter_output)``) at the 7B widths over
   tp 4, 5 SGD steps, held against the unfused pair, and one
   ``ParallelMLP(fused=True)`` against ``fused=False``.  Checks the loss
   is finite, the ranks' parameters are bitwise equal (Llama) and every
   kernel's launch count, per path.  ``--profile`` then traces one more
   step of each with ``torch.profiler``; for an overlap step also the
   exchange's kernel time (its side stream, found by marker kernels
   launched on it before and after the step) and the part of it that ran
   while a kernel of the main stream ran.
6. prints one JSON line naming each kernel with its launches and times,
   then the result line ``{"ok": true, "device": {...}}``.
"""

import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import math
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from bagua_tpu_torch import BaguaProcessGroup, init_process_group
from bagua_tpu_torch.algorithms import (
    ByteGradAlgorithm, DecentralizedAlgorithm, GradientAllReduceAlgorithm, LowPrecisionDecentralizedAlgorithm,
    QAdamAlgorithm, QAdamOptimizer,
)
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.examples import llama_pretrain as lp
from bagua_tpu_torch.examples import mnist
from bagua_tpu_torch.examples import synthetic_benchmark as sb
from bagua_tpu_torch.communication import allgather, allreduce
from bagua_tpu_torch.defs import ReduceOp
from bagua_tpu_torch.kernels import _build
from bagua_tpu_torch.kernels import collective_matmul as cm
from bagua_tpu_torch.kernels import flash_attention as fa
from bagua_tpu_torch.kernels import minmax_uint8 as mm8
from bagua_tpu_torch.kernels import quantized_ring as qr
from bagua_tpu_torch.models.llama import LlamaConfig, LlamaModel, init_llama, llama_7b_config, llama_loss_fn
from bagua_tpu_torch.models.vgg import VGG, init_vgg16, module_params, vgg16, vgg_loss_fn
from bagua_tpu_torch.parallel.ring_attention import zigzag_order
from bagua_tpu_torch.parallel.tensor_parallel import (
    ColumnParallelDense, ParallelMLP, RowParallelDense, gelu,
)
from bagua_tpu_torch.sharded import ZeroAlgorithm
from bagua_tpu_torch.trainer import Trainer
from bagua_tpu_torch.utils import tree_flatten_with_names, tree_leaves, tree_map, tree_unflatten

RANKS = 4
STEPS = 5
BATCH_PER_RANK = 32
IMAGE_SIZE = 224
NUM_CLASSES = 1000
BLOCK = qr.DEFAULT_BLOCK
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BUSY_CYCLES = 40_000_000  # about 20 ms of the card's clock: longer than enqueueing a timed batch
MM8_SOURCE = "bagua_tpu_torch/kernels/csrc/minmax_uint8.cu"
QR_SOURCE = "bagua_tpu_torch/kernels/csrc/quantized_ring.cu"
FA_SOURCE = "bagua_tpu_torch/kernels/csrc/flash_attention.cu"
FA_TPU = "bagua_tpu/kernels/flash_attention.py"
CM_SOURCE = "bagua_tpu_torch/kernels/csrc/collective_matmul.cu"
KERNELS = {
    # name: (wrapper, plain version, source, TPU kernel it replaces)
    "compress_minmax_uint8": (
        mm8.compress_minmax_uint8, mm8.compress_minmax_uint8_plain, MM8_SOURCE,
        "bagua_tpu/kernels/minmax_uint8.py:195",
    ),
    "decompress_minmax_uint8": (
        mm8.decompress_minmax_uint8, mm8.decompress_minmax_uint8_plain, MM8_SOURCE,
        "bagua_tpu/kernels/minmax_uint8.py:232",
    ),
    "decompress_reduce_requantize": (
        mm8.decompress_reduce_requantize, mm8.decompress_reduce_requantize_plain, MM8_SOURCE,
        "bagua_tpu/kernels/minmax_uint8.py:318",
    ),
    "hop_dequant_add_requant_int8": (
        functools.partial(qr.hop_dequant_add_requant, bits=8),
        functools.partial(qr.hop_dequant_add_requant_plain, bits=8), QR_SOURCE,
        "bagua_tpu/kernels/quantized_ring.py:200",
    ),
    "hop_dequant_add_requant_int4": (
        functools.partial(qr.hop_dequant_add_requant, bits=4),
        functools.partial(qr.hop_dequant_add_requant_plain, bits=4), QR_SOURCE,
        "bagua_tpu/kernels/quantized_ring.py:211",
    ),
    "block_attention": (fa.block_attention, fa.block_attention_plain, FA_SOURCE, f"{FA_TPU}:314"),
    "flash_attention_bwd_dq": (
        fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dq_plain, FA_SOURCE, f"{FA_TPU}:510",
    ),
    "flash_attention_bwd_dkv": (
        fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dkv_plain, FA_SOURCE, f"{FA_TPU}:543",
    ),
    "matmul_tile": (
        cm.matmul_tile, cm.matmul_tile_plain, CM_SOURCE, "bagua_tpu/kernels/collective_matmul.py:299",
    ),
}
#: attention's contract is a tolerance (the JAX package's bounds for its
#: Pallas kernels, tests/test_parallel.py:291-293, 423): each output within
#: tol * max(1, |plain value|), bf16 or f16 outputs one rounding step (2^-8
#: of the value) more; inputs at unit variance, q pre-scaled
ATTENTION_TOLS = {
    "block_attention": (2e-4, 2e-4, 2e-5),  # o, l, m
    "flash_attention_bwd_dq": (3e-4,),
    "flash_attention_bwd_dkv": (3e-4, 3e-4),
}


def reset_launches() -> None:
    for fn in mm8.KERNELS + qr.KERNELS + fa.KERNELS + cm.KERNELS:
        fn.launches = 0
    qr.hop_dequant_add_requant.launches_by_bits.update({8: 0, 4: 0})


def read_launches() -> dict:
    """Each kernel's launches since :func:`reset_launches`, by KERNELS name."""
    counts = {fn.__name__: fn.launches for fn in mm8.KERNELS + fa.KERNELS + cm.KERNELS}
    for bits, n in qr.hop_dequant_add_requant.launches_by_bits.items():
        counts[f"hop_dequant_add_requant_int{bits}"] = n
    return counts


def log(msg: str) -> None:
    print(msg, flush=True)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal; NaNs count as equal to NaNs whatever their payload."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]
    )


def close(got: torch.Tensor, want: torch.Tensor, tol: float) -> bool:
    """Every element within ``tol * max(1, |want|)``, plus one rounding step
    of a bf16 or f16 ``got``."""
    g, w = got.double(), want.double()
    step = 2.0 ** -8 if got.dtype in (torch.bfloat16, torch.float16) else 0.0
    return bool(((g - w).abs() <= tol * w.abs().clamp(min=1.0) + step * w.abs()).all())


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    ok = torch.isfinite(a) & torch.isfinite(b)
    return float((a[ok] - b[ok]).abs().max()) if ok.any() else 0.0


def median_ms(fn, reps: int = 5, calls: int = 10, warm: int = 3) -> float:
    """The card's time for one call of ``fn``: the median over ``reps``
    batches of ``calls`` back-to-back calls.  Each batch is enqueued while
    the card spins (``BUSY_CYCLES``), so the card runs the calls without
    waiting for the host between them: a wrapper's host time is hidden, as
    it is on the main path, where the host runs ahead of the card."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(BUSY_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


class Ledger:
    """Per kernel: comparisons made, worst error, summed times per step."""

    def __init__(self):
        self.rows = {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                                bound_by="bytes", library_ms=None, checks=0) for name in KERNELS}
        #: sums over the steps of other slices than the kernel's own:
        #: step -> kernel -> {ms, plain_ms, bound_ms}
        self.other_steps = {}

    def compare(self, name: str, case: str, *args, **kwargs):
        """The kernel against its plain version: bitwise, or within
        ATTENTION_TOLS for the attention kernels."""
        wrapper, plain, _, _ = KERNELS[name]
        got, want = wrapper(*args, **kwargs), plain(*args, **kwargs)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        row = self.rows[name]
        row["checks"] += 1
        tols = ATTENTION_TOLS.get(name, (None,) * len(got))
        for g, w, tol in zip(got, want, tols):
            row["max_abs_err"] = max(row["max_abs_err"], abs_err(g, w))
            ok = same(g, w) if tol is None else g.shape == w.shape and g.dtype == w.dtype and close(g, w, tol)
            if not ok:
                raise AssertionError(f"{name} differs from its plain version on {case} "
                                     f"(max abs error {abs_err(g, w):.3e}, tolerance {tol})")
        return got if len(got) > 1 else got[0]

    def compare_matmul(self, case: str, x: torch.Tensor, w: torch.Tensor) -> float:
        """The tile kernel against ``x @ w`` (TF32 off): every element within
        ``matmul_tol(K)`` times ``(|x| |w|)`` there.  Returns the largest
        share of that bound an element used."""
        got, want = cm.matmul_tile(x, w), cm.matmul_tile_plain(x, w)
        torch.cuda.synchronize()
        row = self.rows["matmul_tile"]
        row["checks"] += 1
        row["max_abs_err"] = max(row["max_abs_err"], abs_err(got, want))
        share = matmul_share(got, want, x, w)
        if got.shape != want.shape or share > 1.0:
            raise AssertionError(f"matmul_tile differs from x @ w on {case}: max abs error "
                                 f"{abs_err(got, want):.3e}, {share:.3f} of the bound "
                                 f"{matmul_tol(x.shape[-1]):.3e} (|x| |w|)")
        return share

    def time(self, name: str, nbytes: int, ops: int, *args, per_step: int = 1, library=None,
             step=None, **kwargs):
        """Times one call; adds ``per_step`` times it (the calls one step
        makes at this shape) to the kernel's per-step sums, or, where
        ``step`` names another slice's step, to ``other_steps[step]``.
        ``library``: a callable whose time is the library call's for the
        same work."""
        wrapper, plain, _, _ = KERNELS[name]
        row = self.rows[name] if step is None else self.other_steps.setdefault(step, {}).setdefault(
            name, dict(ms=0.0, plain_ms=0.0, bound_ms=0.0))
        ms = median_ms(lambda: wrapper(*args, **kwargs))
        plain_ms = median_ms(lambda: plain(*args, **kwargs))
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        row["ms"] += per_step * ms
        row["plain_ms"] += per_step * plain_ms
        row["bound_ms"] += per_step * max(bytes_ms, ops_ms)
        if ops_ms > bytes_ms and step is None:
            row["bound_by"] = "operations"
        if library is not None:
            row["library_ms"] = (row["library_ms"] or 0.0) + per_step * library()
        return ms, plain_ms, max(bytes_ms, ops_ms)


def matmul_share(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor, w: torch.Tensor) -> float:
    """The largest share of ``matmul_tol(K) (|x| |w|)_ij`` that an element
    of ``got - want`` uses."""
    if not got.numel():
        return 0.0
    bound = matmul_tol(x.shape[-1]) * (x.abs() @ w.abs())
    return float(((got - want).abs() / bound.clamp(min=1e-30)).max())


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32's 10 mantissa bits (to nearest, ties to even),
    as a tensor-core kernel reads f32 operands."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def matmul_tol(k: int) -> float:
    """The tile kernel's elementwise tolerance, relative to ``(|x| |w|)_ij``:
    with rounding errors of random sign, a K-term f32 dot product lies
    within about sqrt(K) 2^-24 of the exact one (Higham and Mary's
    probabilistic bound, lambda = 1; the worst case is K 2^-24), so two
    within 2 sqrt(K) 2^-24 of each other.  Inputs rounded to TF32 (2^-11)
    miss it at path (a)'s shapes: ``phase_matmul_kernels`` shows that."""
    return 2 * math.sqrt(k) * 2.0 ** -24


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build(["minmax_uint8", "quantized_ring", "flash_attention", "collective_matmul"])
    for name, path, seconds in built:
        with open(f"{path}.log") as f:
            regs = [line.split("ptxas info    : ")[-1] for line in f if "registers" in line]
        log(f"[build] {name}.cu in {seconds:.1f} s -> {path}; ptxas: {' | '.join(regs)}")
    log(f"[build] done in {time.perf_counter() - t0:.1f} s")


def slice_shapes(plan):
    """(numel, chunk) of each bucket exchanged over RANKS ranks."""
    return [(spec.numel, spec.numel // RANKS) for spec in plan.specs]


def pipeline_inputs(x: torch.Tensor, n: int):
    """ByteGrad's three kernel inputs for stacked flats ``x`` (R, n*chunk):
    what compress, the fused reduce and decompress see in one exchange."""
    ranks, chunk = x.shape[0], x.shape[1] // n
    q, mm = mm8.compress_minmax_uint8_plain(x.reshape(ranks * n, chunk))
    q_recv = q.reshape(ranks, n, chunk).transpose(0, 1).contiguous()
    mm_recv = mm.reshape(ranks, n, 2).transpose(0, 1).contiguous()
    q2, mm2 = mm8.decompress_reduce_requantize_plain(q_recv, mm_recv)
    qg = q2.reshape(1, n * chunk).expand(ranks, -1).reshape(ranks * n, chunk).contiguous()
    mmg = mm2.reshape(1, n * 2).expand(ranks, -1).reshape(ranks * n, 2).contiguous()
    return x.reshape(ranks * n, chunk), (q_recv, mm_recv), (qg, mmg)


def ring_codec_inputs(x: torch.Tensor, block: int):
    """The int8 ring's codec inputs for stacked flats ``x`` (R, L) over R
    ranks, each blocked as ``quantized_ring._pad_to_blocks`` pads it: the
    reduce-scatter's step-0 blocks (rank i's shard (i - 1) mod R) and the
    all-gather's shard blocks (the shards' sums), which it compresses; the
    reduce-scatter's one decompress (its step-0 and arrived packages, 2
    blocks a block) and the all-gather's (every rank's copy of all R
    shards' packages)."""
    ranks = x.shape[0]
    shards = x.reshape(ranks, ranks, -1)
    idx = torch.arange(ranks, device=x.device)
    blocks = lambda t: qr._pad_to_blocks(t, block)[0].reshape(-1, block)
    local0, owned = blocks(shards[idx, (idx - 1) % ranks]), blocks(shards.sum(0))
    q, mm = mm8.compress_minmax_uint8_plain(torch.cat([local0, owned]))
    rows = owned.shape[0]
    return (local0, owned), (q, mm), (q[rows:].repeat(ranks, 1), mm[rows:].repeat(ranks, 1))


def codec_cost(rows: int, chunk: int, ops_per_element: int):
    """(bytes, f32 operations) of compress or decompress over (rows, chunk):
    4 + 1 bytes an element and the 8-byte sidecar a row, each moved once."""
    return rows * chunk * 5 + rows * 8, rows * chunk * ops_per_element


def hop_inputs(incoming: torch.Tensor, local: torch.Tensor, block: int, bits: int):
    """The hop's inputs for every rank's shard, ``(RANKS, S)`` each, padded
    to blocks as the ring pads them: the incoming packages (compressed by
    the plain codec) and the local partials."""
    comp, _ = qr._compressors(bits, plain=True)
    blocks = lambda t: qr._pad_to_blocks(t, block)[0].reshape(-1, block)
    q, mm = comp(blocks(incoming))
    return q, mm, blocks(local)


def hop_cost(rows: int, bits: int):
    """(bytes, f32 operations) of one hop call over ``rows`` blocks: q, the
    sidecar and the local partial read once, q2, its sidecar and err
    written once; about 12 operations per element."""
    cols = BLOCK if bits == 8 else BLOCK // 2
    return rows * (2 * cols + 2 * BLOCK * 4 + 16), rows * BLOCK * 12


def phase_kernels(ledger: Ledger, plan, device) -> None:
    gen = torch.Generator(device=device).manual_seed(1)
    # the main paths' shapes: every bucket of VGG16 over 4 ranks, timed
    for numel, chunk in slice_shapes(plan):
        x = torch.randn((RANKS, numel), generator=gen, device=device) * 1e-3
        flat, fused_in, dec_in = pipeline_inputs(x, RANKS)
        rows = RANKS * RANKS
        case = f"bucket of {numel} elements"
        ledger.compare("compress_minmax_uint8", case, flat)
        ledger.compare("decompress_reduce_requantize", case, *fused_in)
        ledger.compare("decompress_reduce_requantize", case + " (sum)", *fused_in, average=False)
        ledger.compare("decompress_minmax_uint8", case, *dec_in)
        t = {
            "compress": ledger.time("compress_minmax_uint8", *codec_cost(rows, chunk, 6), flat),
            "fused reduce": ledger.time("decompress_reduce_requantize",
                                        rows * chunk + rows * 8 + RANKS * (chunk + 8),
                                        rows * chunk * 3 + RANKS * chunk * 5, *fused_in),
            "decompress": ledger.time("decompress_minmax_uint8", *codec_cost(rows, chunk, 2), *dec_in),
        }
        # ZeRO's ByteGrad decompresses each rank's own reduced chunk only
        own = [a.reshape(RANKS, -1) for a in mm8.decompress_reduce_requantize_plain(*fused_in)]
        ledger.compare("decompress_minmax_uint8", f"{case}, ZeRO's own chunk", *own)
        t["decompress, ZeRO's own chunk"] = ledger.time(
            "decompress_minmax_uint8", *codec_cost(RANKS, chunk, 2), *own, step="ZeRO ByteGrad")
        del flat, fused_in, dec_in, own
        # low-precision decentralized with overlap: the bucket one row a rank,
        # one compress and three decompresses a step
        lp = f"{case}, low-precision overlap row"
        q, mm = ledger.compare("compress_minmax_uint8", lp, x)
        ledger.compare("decompress_minmax_uint8", lp, q, mm)
        step = "low-precision decentralized (overlap)"
        t["compress, low-precision overlap row"] = ledger.time(
            "compress_minmax_uint8", *codec_cost(RANKS, numel, 6), x, step=step)
        t["decompress, low-precision overlap row"] = ledger.time(
            "decompress_minmax_uint8", *codec_cost(RANKS, numel, 2), q, mm, per_step=3, step=step)
        del q, mm
        # the int8 ring's codec calls, one of each a step at this bucket
        comp_in, rs_dec, ag_dec = ring_codec_inputs(x, BLOCK)
        for what, blocks in zip(("reduce-scatter step 0", "all-gather"), comp_in):
            ledger.compare("compress_minmax_uint8", f"{case}, int8 ring {what}", blocks)
            t[f"compress, int8 ring {what}"] = ledger.time(
                "compress_minmax_uint8", *codec_cost(*blocks.shape, 6), blocks, step="int8 ring")
        for what, dec in (("reduce-scatter", rs_dec), ("all-gather", ag_dec)):
            ledger.compare("decompress_minmax_uint8", f"{case}, int8 ring {what}", *dec)
            t[f"decompress, int8 ring {what}"] = ledger.time(
                "decompress_minmax_uint8", *codec_cost(*dec[0].shape, 2), *dec, step="int8 ring")
        del comp_in, rs_dec, ag_dec
        # the ring's hop: each rank's shard of chunk elements in blocks, the
        # incoming partial sum of a few ranks' gradients and the local one
        incoming = x[:, :chunk] + x[:, chunk:2 * chunk]
        for bits in (8, 4):
            name = f"hop_dequant_add_requant_int{bits}"
            q, mm, local = hop_inputs(incoming, x[:, 2 * chunk:3 * chunk], BLOCK, bits)
            ledger.compare(name, case, q, mm, local)
            t[f"hop int{bits}"] = ledger.time(name, *hop_cost(local.shape[0], bits), q, mm, local,
                                              per_step=RANKS - 2)
            del q, mm, local
        if numel == max(s[0] for s in slice_shapes(plan)):
            for name, (ms, plain_ms, bound_ms) in t.items():
                log(f"[kernels] {case}, chunk {chunk}: {name} {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {bound_ms:.4f} ms")
    # ragged chunks
    for chunk in (7, 4095, 65539):
        x = torch.randn((RANKS, RANKS * chunk), generator=gen, device=device) * 3.0
        flat, fused_in, dec_in = pipeline_inputs(x, RANKS)
        ledger.compare("compress_minmax_uint8", f"chunk {chunk}", flat)
        ledger.compare("decompress_reduce_requantize", f"chunk {chunk}", *fused_in)
        ledger.compare("decompress_minmax_uint8", f"chunk {chunk}", *dec_in)
    # ragged blocks, with a last shard that is not a whole number of blocks
    for block in (2, 6, 130, 4098, 65538):
        shard = 3 * block + 1
        x = torch.randn((2, RANKS, shard), generator=gen, device=device)
        for bits in (8, 4):
            ledger.compare(f"hop_dequant_add_requant_int{bits}", f"block {block}",
                           *hop_inputs(x[0], x[1], block, bits))
    # degenerate inputs (tests/test_bytegrad.py:87-236), a NaN, signed zeros
    cases = {f"constant {v}": torch.full((4, 4096), v, device=device)
             for v in (0.0, 1.5, 2.5, -7.0, 1e32, -1e35, 3.4e38, 8.8e33)}
    mixed = torch.randn((4, 4096), generator=gen, device=device)
    mixed[1], mixed[3] = 0.0, -2.5e33
    cases["mixed"] = mixed
    cases["constant 1.7e33, chunk 129"] = torch.full((5, 129), 1.7e33, device=device)
    nan = torch.randn((3, 258), generator=gen, device=device)
    nan[1, 100] = float("nan")
    cases["one NaN"] = nan
    cases["signed zeros"] = torch.tensor(
        [[0.0, -0.0, 1.0, 2.0], [-0.0, 0.0, 1.0, 2.0], [-1.0, 0.0, -0.0, -2.0],
         [-1.0, -0.0, 0.0, -2.0], [-0.0] * 4, [0.0] * 4], device=device)
    for case, x in cases.items():
        q, mm = ledger.compare("compress_minmax_uint8", case, x)
        ledger.compare("decompress_minmax_uint8", case, q, mm)
        for average in (True, False):
            ledger.compare("decompress_reduce_requantize", case, q[None], mm[None], average=average)
        for bits in (8, 4):
            # the same block as incoming sum and as local partial: a constant
            # sum requantizes where upper - levels may round
            ledger.compare(f"hop_dequant_add_requant_int{bits}", case,
                           *hop_inputs(x, x, x.shape[1] + x.shape[1] % 2, bits))
    phase_lp_kernels(ledger, plan, device, gen)
    for name, row in ledger.rows.items():
        if name in ATTENTION_TOLS or name == "matmul_tile":
            continue
        log(f"[kernels] {name}: {row['checks']} comparisons bitwise, per step over "
            f"{plan.num_buckets} buckets {row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms)")
    for step, sums in ledger.other_steps.items():
        over = "one bucket" if step == "low-precision decentralized" else f"{plan.num_buckets} buckets"
        for name, row in sums.items():
            log(f"[kernels] {name} per {step} step over {over} {row['ms']:.4f} ms "
                f"(plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms)")


def lp_row_elements(plan) -> int:
    """Elements of low-precision decentralized's one bucket for the model
    of ``plan``: every parameter, padded to the RANKS ranks."""
    total = sum(s.numel for spec in plan.specs for s in spec.slots)
    return -(-total // RANKS) * RANKS


def phase_lp_kernels(ledger: Ledger, plan, device, gen) -> None:
    """Compress and decompress at low-precision decentralized's shape: the
    whole model one row per rank, ``(RANKS, lp_row_elements)`` (f32 past
    2^31 bytes), bitwise, and timed per step (1 compress, 3 decompresses)
    under ``other_steps``; then a ragged long row, ``(3, 2^27 + 1)`` (the
    scalar paths)."""
    numel = lp_row_elements(plan)
    x = torch.randn((RANKS, numel), generator=gen, device=device) * 1e-3
    case = f"low-precision decentralized row of {numel} elements"
    q, mm = ledger.compare("compress_minmax_uint8", case, x)
    ledger.compare("decompress_minmax_uint8", case, q, mm)
    step = "low-precision decentralized"
    t = {"compress": ledger.time("compress_minmax_uint8", *codec_cost(RANKS, numel, 6), x, step=step),
         "decompress (x3)": ledger.time("decompress_minmax_uint8", *codec_cost(RANKS, numel, 2), q, mm,
                                        per_step=3, step=step)}
    for name, (ms, plain_ms, bound_ms) in t.items():
        log(f"[kernels] {case} x {RANKS} ranks: {name} {ms:.4f} ms a call, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms")
    del x, q, mm
    torch.cuda.empty_cache()
    x = torch.randn((3, 2**27 + 1), generator=gen, device=device)
    q, mm = ledger.compare("compress_minmax_uint8", "ragged long row (3, 2^27 + 1)", x)
    ledger.compare("decompress_minmax_uint8", "ragged long row (3, 2^27 + 1)", q, mm)
    del x, q, mm
    torch.cuda.empty_cache()


#: the Llama slice: llama_7b_config at its published width, cut to 2 layers
#: and a global batch of 1 sequence of 4096 tokens, zigzag ring over RANKS
LLAMA_LAYERS = 2
LLAMA_BATCH = 1
LLAMA_SEQ = 4096
LLAMA_STEPS = 5
LLAMA_LR = 3e-3


def llama_slice_config() -> LlamaConfig:
    return llama_7b_config(num_layers=LLAMA_LAYERS, sp_axis="intra", sp_layout="zigzag")


def zigzag_pair_masks(sp: int, t2: int, device):
    """The causal masks of the zigzag ring's block calls, in its order (ring
    step, q half, k half), each ``(sp, t2, t2)``: member r's queries are
    global half-blocks (r, 2sp-1-r), and at step i it holds the K/V of
    member (r - i) mod sp."""
    ranks, pos = torch.arange(sp, device=device), torch.arange(t2, device=device)
    masks = []
    for i in range(sp):
        src = (ranks - i) % sp
        q_gid, k_gid = (ranks, 2 * sp - 1 - ranks), (src, 2 * sp - 1 - src)
        for qh in range(2):
            for kh in range(2):
                q_pos, k_pos = q_gid[qh][:, None] * t2 + pos, k_gid[kh][:, None] * t2 + pos
                masks.append(q_pos[:, :, None] >= k_pos[:, None, :])
    return masks


def attention_inputs(gen, device, b, tq, tk, h, h_kv, d, kv_dtype=torch.float32):
    """Unit-variance q (pre-scaled), k, v and the backward's cotangents."""
    qf = torch.randn((b, tq, h, d), generator=gen, device=device) / d ** 0.5
    k = torch.randn((b, tk, h_kv, d), generator=gen, device=device).to(kv_dtype)
    v = torch.randn((b, tk, h_kv, d), generator=gen, device=device).to(kv_dtype)
    dl = torch.randn((b, h, tq), generator=gen, device=device)
    do = torch.randn((b, h, tq, d), generator=gen, device=device)
    return qf, k, v, dl, do


def check_attention(ledger: Ledger, case: str, qf, k, v, mask, dl, do):
    """The three kernels against their plain versions on one block."""
    _, _, m = ledger.compare("block_attention", case, qf, k, v, mask)
    ledger.compare("flash_attention_bwd_dq", case, qf, k, v, mask, m, dl, do)
    ledger.compare("flash_attention_bwd_dkv", case, qf, k, v, mask, m, dl, do)


def attention_cost(qf, k, mask, d):
    """(bytes, f32 operations) of the forward, dq and dk/dv on one block: each
    live (query, key) pair and head costs 4d, 6d and 8d operations (two,
    three and four products of d multiply-adds); the inputs count once
    where the block has a live pair, the mask and the outputs always."""
    b, tq, h, _ = qf.shape
    live = int(mask.sum()) * h
    f32 = 4
    q_bytes, kv_bytes = qf.numel() * f32, 2 * k.numel() * k.element_size()
    row_bytes = b * h * tq * f32  # one of l, m, dl
    read = (q_bytes + kv_bytes) if live else 0
    fwd = (mask.numel() + q_bytes + 2 * row_bytes + read, 4 * d * live)
    dq = (mask.numel() + q_bytes + 2 * row_bytes + (read + q_bytes if live else 0), 6 * d * live)
    dkv = (mask.numel() + kv_bytes + 2 * row_bytes + (read + q_bytes if live else 0), 8 * d * live)
    return fwd, dq, dkv


def sdpa_ms(qf, k, v, mask, do):
    """The library's time for the same attention, a near-equivalent (it
    normalizes and returns no l or m): ``F.scaled_dot_product_attention``,
    forward, and forward + backward less the forward."""
    q_t, k_t, v_t = (x.transpose(1, 2) for x in (qf, k, v))
    kw = dict(attn_mask=mask[:, None], scale=1.0, enable_gqa=qf.shape[2] != k.shape[2])
    fwd = median_ms(lambda: F.scaled_dot_product_attention(q_t, k_t, v_t, **kw))
    leaves = [x.detach().requires_grad_() for x in (q_t, k_t, v_t)]
    both = median_ms(lambda: F.scaled_dot_product_attention(*leaves, **kw).backward(do))
    return fwd, max(both - fwd, 0.0)


def phase_attention_kernels(ledger: Ledger, device) -> None:
    """The three attention kernels against their plain versions (TF32 off)
    at the Llama slice's shapes and at GQA, bf16 K/V, ragged and degenerate
    ones; timed per slice step at its blocks: RANKS ranks folded into the
    batch, half-blocks of LLAMA_SEQ / (2 RANKS) tokens, 32 heads of 128, one
    call per (ring step, q half, k half) and layer."""
    cfg = llama_slice_config()
    h, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    t2 = LLAMA_SEQ // (2 * RANKS)
    gen = torch.Generator(device=device).manual_seed(4)
    qf, k, v, dl, do = attention_inputs(gen, device, RANKS * LLAMA_BATCH, t2, t2, h, cfg.num_kv_heads, d)
    # the slice's blocks, by distinct mask, with the calls a step makes of each
    blocks = {}
    for mask in zigzag_pair_masks(RANKS, t2, device):
        key = mask.cpu().numpy().tobytes()
        blocks.setdefault(key, [mask.repeat_interleave(LLAMA_BATCH, 0).contiguous(), 0])[1] += LLAMA_LAYERS
    with _no_tf32():
        for n, (mask, calls) in enumerate(blocks.values()):
            live = float(mask.float().mean())
            check_attention(ledger, f"slice block {n} (live share {live:.3f})", qf, k, v, mask, dl, do)
            m = fa.block_attention_plain(qf, k, v, mask)[2]
            lib_fwd, lib_bwd = sdpa_ms(qf, k, v, mask, do)
            costs = attention_cost(qf, k, mask, d)
            ledger.time("block_attention", *costs[0], qf, k, v, mask, per_step=calls,
                        library=lambda: lib_fwd)
            for name, cost in zip(("flash_attention_bwd_dq", "flash_attention_bwd_dkv"), costs[1:]):
                # one library backward computes dq, dk and dv together
                ledger.time(name, *cost, qf, k, v, mask, m, dl, do, per_step=calls,
                            library=lambda: lib_bwd)
        log(f"[kernels] attention: {len(blocks)} distinct blocks of the slice's "
            f"{len(zigzag_pair_masks(RANKS, t2, 'cpu'))} per layer")
        full = torch.ones((RANKS, t2, t2), dtype=torch.bool, device=device)
        diag = full.tril()
        # GQA (a K/V head per 4 query heads: 8 at the slice) and bf16 K/V at
        # the slice's widths
        gqa = attention_inputs(gen, device, RANKS, t2, t2, h, h // 4, d)
        for name, mask in (("diagonal", diag), ("full", full)):
            check_attention(ledger, f"GQA h_kv {h // 4}, {name}", *gqa[:3], mask, *gqa[3:])
        bf16 = attention_inputs(gen, device, RANKS, t2, t2, h, h, d, torch.bfloat16)
        check_attention(ledger, "bf16 K/V, diagonal", *bf16[:3], diag, *bf16[3:])
        # ragged lengths and narrow heads; a fully masked block; rows where
        # only the first key survives
        for d_small in (24, 64):
            x = attention_inputs(gen, device, 2, 200, 300, 4, 2, d_small)
            mask = torch.rand((2, 200, 300), generator=gen, device=device) < 0.5
            mask[:, 7] = False
            check_attention(ledger, f"200x300, d {d_small}", *x[:3], mask, *x[3:])
            first = torch.zeros((2, 200, 300), dtype=torch.bool, device=device)
            first[:, :, 0] = True
            check_attention(ledger, f"200x300, d {d_small}, first key only", *x[:3], first, *x[3:])
            check_attention(ledger, f"200x300, d {d_small}, all masked", *x[:3],
                            torch.zeros_like(first), *x[3:])
    for name in ATTENTION_TOLS:
        row = ledger.rows[name]
        log(f"[kernels] {name}: {row['checks']} comparisons within {ATTENTION_TOLS[name]} "
            f"(max abs error {row['max_abs_err']:.3e}); per Llama slice step {row['ms']:.4f} ms "
            f"(plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms by "
            f"{row['bound_by']}, SDPA {row['library_ms']:.4f} ms)")


#: path (a), the kernel's path: the sequence-parallel Megatron MLP pair at
#: llama_7b_config's widths (hidden 4096, MLP 11008), one sequence of 4096
#: tokens over SP_MLP_TP tensor-parallel ranks on this one card, f32
SP_MLP_TP = 4
SP_MLP_TOKENS = 4096
SP_MLP_STEPS = 5
SP_MLP_LR = 0.01


def sp_mlp_gemms(hidden: int, inter: int, tp: int, tokens: int):
    """The tile products one step of path (a) makes, by shape: ``name ->
    (m, k, n, transposed operand, launches a step)``, each for all tp
    ranks at once.  Forward: tp ``ag_matmul`` blocks (Column) and tp
    ``matmul_rs`` blocks (Row); backward: the Column's ``dw`` (its input is
    data: no ``dx``) and the Row's ``dx`` and ``dw``, tp each."""
    t, i = tokens // tp, inter // tp
    return {
        "Column fwd (ag_matmul)": (t, hidden, i, None, tp),
        "Column dw = x^T g": (hidden, t, i, "x", tp),
        "Row fwd (matmul_rs)": (t, i, hidden, None, tp),
        "Row dx = g w^T": (t, hidden, i, "w", tp),
        "Row dw = x^T g": (i, t, hidden, "x", tp),
    }


def phase_matmul_kernels(ledger: Ledger, device) -> None:
    """The tile kernel against ``x @ w`` (TF32 off for both) at every
    product of path (a), the backward's through transposed views and the
    Row's inputs through the ring's per-rank block views; at edge shapes;
    on a rank batch with a stride-0 operand.  At each path (a) product the
    plain product of the operands rounded to TF32 must miss the tolerance,
    so it is shown to tell the precisions apart at those K.  Timed per path
    (a) step beside its bound (2 m n k per rank over 67 TFLOP/s) and
    ``torch.matmul`` (the plain version is that call too)."""
    cfg = llama_7b_config()
    tp, gen = SP_MLP_TP, torch.Generator(device=device).manual_seed(6)
    shares, tf32_shares = {}, {}
    with _no_tf32():
        for name, (m, k, n, trans, per_step) in sp_mlp_gemms(
                cfg.hidden_size, cfg.intermediate_size, tp, SP_MLP_TOKENS).items():
            if trans == "x":  # x^T: a (k, m) row-major tensor read transposed
                x = torch.randn((tp, k, m), generator=gen, device=device).transpose(1, 2)
            else:  # a row block of a (tp, tp * m, k) tensor, as the rings slice it
                x = torch.randn((tp, tp, m, k), generator=gen, device=device)[:, 1]
            w = (torch.randn((tp, n, k), generator=gen, device=device).transpose(1, 2)
                 if trans == "w" else torch.randn((tp, k, n), generator=gen, device=device))
            shares[name] = ledger.compare_matmul(name, x, w)
            # the gate separates precisions here: the product of the
            # operands rounded to TF32 must miss it
            tf32_shares[name] = matmul_share(cm.matmul_tile_plain(round_tf32(x), round_tf32(w)),
                                             cm.matmul_tile_plain(x, w), x, w)
            if tf32_shares[name] <= 1.0:
                raise AssertionError(f"matmul_tile's tolerance does not reject TF32 inputs on {name}: "
                                     f"{tf32_shares[name]:.3f} of the bound")
            ms, plain_ms, bound_ms = ledger.time(
                "matmul_tile", 4 * tp * (m * k + k * n + m * n), 2 * tp * m * n * k, x, w,
                per_step=per_step, library=lambda: median_ms(lambda: torch.matmul(x, w)))
            log(f"[kernels] matmul_tile {name}: {tp} x ({m}, {k}) @ ({k}, {n}), {per_step} a step: "
                f"{ms:.4f} ms = {2 * tp * m * n * k / ms / 1e9:.1f} TFLOP/s (torch.matmul {plain_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms); error {shares[name]:.2e} of the bound, "
                f"TF32 inputs {tf32_shares[name]:.2f}")
            del x, w
        for m, k, n in ((9, 7, 10), (1, 1, 1), (16, 32, 48)):
            x = torch.randn((k, m), generator=gen, device=device)
            w = torch.randn((n, k), generator=gen, device=device)
            shares[f"{m}x{k}x{n}"] = ledger.compare_matmul(f"{m}x{k}x{n}", x.t().contiguous(), w.t().contiguous())
            shares[f"{m}x{k}x{n} transposed"] = ledger.compare_matmul(f"{m}x{k}x{n} transposed", x.t(), w.t())
        x = torch.randn((1, 300, 1000), generator=gen, device=device).expand(3, -1, -1)
        w = torch.randn((3, 1000, 130), generator=gen, device=device)
        shares["3 ranks, stride-0 x"] = ledger.compare_matmul("3 ranks, stride-0 x", x, w)
        # the reference's dtype rule: operands that are not both f32 take
        # x @ w (jnp.dot there) and launch nothing
        launches = cm.matmul_tile.launches
        for dtype in (torch.bfloat16, torch.float16, torch.float64):
            xd, wd = x[:, :40, :64].to(dtype), w[:, :64, :56].to(dtype)
            if not same(cm.matmul_tile(xd, wd), xd @ wd):
                raise AssertionError(f"matmul_tile on {dtype} operands is not x @ w")
        if cm.matmul_tile.launches != launches:
            raise AssertionError("matmul_tile launched its f32 kernel for other types")
    row = ledger.rows["matmul_tile"]
    log(f"[kernels] matmul_tile: {row['checks']} comparisons within {matmul_tol(1):.3e} sqrt(K) "
        f"(|x| |w|) (max abs error {row['max_abs_err']:.3e}, at most {max(shares.values()):.2e} of "
        f"the bound; TF32 inputs at least {min(tf32_shares.values()):.2f} of it at path (a)'s shapes); "
        f"per path (a) step {row['ms']:.4f} ms (torch.matmul {row['plain_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms by {row['bound_by']})")


def phase_rings(device) -> None:
    """The two rings on the card at path (a)'s shapes: ``ag_matmul`` bidir
    bitwise equal to uni (the same block products, no atomics);
    ``matmul_rs`` bidir equal to uni, and both rings equal to ``allgather``
    + ``torch.matmul`` and ``allreduce(SUM)`` + the rank's row block, within
    ``matmul_tol`` of the whole contraction times the ``|x| |w|`` sums."""
    cfg = llama_7b_config()
    tp, gen = SP_MLP_TP, torch.Generator(device=device).manual_seed(7)
    group = BaguaProcessGroup([device] * tp)
    t, i = SP_MLP_TOKENS // tp, cfg.intermediate_size // tp
    rank = torch.arange(tp, device=device)
    with _no_tf32():
        x = torch.randn((tp, t, cfg.hidden_size), generator=gen, device=device)
        w = torch.randn((tp, cfg.hidden_size, i), generator=gen, device=device)
        uni, bidir = (cm.ag_matmul(x, w, group, "intra", ring=r) for r in ("uni", "bidir"))
        if not same(uni, bidir):
            raise AssertionError(f"ag_matmul bidir differs from uni by up to {abs_err(uni, bidir):.3e}")
        want, bound = allgather(x, group) @ w, allgather(x.abs(), group) @ w.abs()
        ag_share = float(((uni - want).abs() / (matmul_tol(cfg.hidden_size) * bound)).max())
        del x, w, uni, bidir, want, bound
        x = torch.randn((tp, SP_MLP_TOKENS, i), generator=gen, device=device)
        w = torch.randn((tp, i, cfg.hidden_size), generator=gen, device=device)
        uni, bidir = (cm.matmul_rs(x, w, group, "intra", ring=r) for r in ("uni", "bidir"))
        blocks = lambda y: y.reshape(tp, tp, t, -1)[rank, rank]  # noqa: E731
        want = blocks(allreduce(x @ w, ReduceOp.SUM, group))
        bound = matmul_tol(tp * i) * blocks(allreduce(x.abs() @ w.abs(), ReduceOp.SUM, group))
        rs_share = max(float(((got - want).abs() / bound).max()) for got in (uni, bidir))
        bidir_share = float(((bidir - uni).abs() / bound).max())
    if max(ag_share, rs_share, bidir_share) > 1.0:
        raise AssertionError(f"rings vs the plain collectives: ag {ag_share:.3e}, rs {rs_share:.3e}, "
                             f"rs bidir vs uni {bidir_share:.3e} of the bound")
    log(f"[rings] tp {tp} at path (a)'s shapes: ag_matmul bidir bitwise equal to uni, within "
        f"{ag_share:.2e} of the bound of allgather + matmul; matmul_rs uni and bidir within "
        f"{rs_share:.2e} of allreduce + slice, bidir within {bidir_share:.2e} of uni")


REF_STEPS, REF_LR = 3, 0.05
REF_VGG = dict(num_classes=10, cfg=(16, "M", 32, "M"), classifier_width=64, image_size=32)
#: the reference phase's algorithms: name -> (algorithm, quantizations one
#: element meets per exchange, levels); 0 quantizations for the f32 wire.
#: ZeRO's reduce-scatter quantizes as the ring's first leg or ByteGrad's
#: scatter stage; its parameter all-gather is exact
REF_ALGORITHMS = {
    "ByteGrad": (ByteGradAlgorithm, 2, 255.0),
    "int8 ring": (functools.partial(GradientAllReduceAlgorithm, wire_precision="int8"), RANKS, 255.0),
    "int4 ring": (functools.partial(GradientAllReduceAlgorithm, wire_precision="int4"), RANKS + 1, 15.0),
    "f32": (GradientAllReduceAlgorithm, 0, None),
    "ZeRO f32": (ZeroAlgorithm, 0, None),
    "ZeRO ByteGrad": (functools.partial(ZeroAlgorithm, compression="bytegrad"), 2, 255.0),
    "ZeRO int8 ring": (functools.partial(ZeroAlgorithm, wire_precision="int8"), RANKS - 1, 255.0),
    "ZeRO int4 ring": (functools.partial(ZeroAlgorithm, wire_precision="int4"), RANKS, 15.0),
}
#: ZeRO runs that must equal an unsharded one on the card bit for bit
ZERO_TWINS = {"ZeRO f32": "f32", "ZeRO ByteGrad": "ByteGrad"}
#: the share of elements that may lie beyond rounding: those a flipped level
#: moved (a flip disturbs at most its own block)
FLIPPED_SHARE = 0.05
#: the f32 wires: each step's averaged gradient differs from the CPU's by at
#: most the gradient noise at equal parameters; the parameters' own
#: differences may grow it over the steps, by this factor at most
F32_GROWTH = 4


def _level_width(name, trainer, state, batch) -> float:
    """The widest quantization level the exchange can meet this step, in
    units of the averaged gradient.  ByteGrad: over each rank's chunks and
    the chunks of their mean.  The ring: every partial sum of a bucket lies
    within plus or minus the sum over ranks of each rank's largest
    |gradient + residual|, divided by the RANKS of the average.  The f32
    wire: 0."""
    levels = REF_ALGORITHMS[name][2]
    if levels is None:
        return 0.0
    state = trainer.ddp.finalize_pending_updates(state)
    _, grads = trainer.ddp._rank_grads(state.params, batch)
    resid = state.algo_state.get("qr_residual") if isinstance(state.algo_state, dict) else None
    width = 0.0
    for i, flat in enumerate(trainer.ddp.plan.bucketize(grads)):
        if name.endswith("ByteGrad"):
            for chunks in (flat.reshape(-1, flat.shape[1] // RANKS), flat.mean(0).reshape(RANKS, -1)):
                width = max(width, float((chunks.amax(1) - chunks.amin(1)).max()) / levels)
            continue
        if resid is not None:
            flat = flat + resid[i]
        width = max(width, 2.0 * float(flat.abs().amax(1).sum()) / levels / RANKS)
    return width


@contextlib.contextmanager
def _no_tf32():
    """f32 convolutions and matmuls on the card, as on the CPU."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@contextlib.contextmanager
def _deterministic():
    """cuDNN's deterministic algorithms: the same convolution gradients
    from one run to the next."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def _small_trainer(name, device, overlap="auto"):
    group = BaguaProcessGroup([device] * RANKS, intra_size=1)
    return Trainer(vgg_loss_fn(VGG(device=device, **REF_VGG)),
                   lambda ps: torch.optim.SGD(ps, lr=REF_LR), REF_ALGORITHMS[name][0](), group,
                   overlap=overlap)


def _train_small_vgg(name, device, params, batch, overlap="auto"):
    """REF_STEPS steps of the small f32 VGG over RANKS ranks (``intra_size=1``)
    with algorithm ``name`` (overlap as the engine resolves ``overlap``).
    Returns every step's per-rank losses, the final rank-0 parameters, the
    widest quantization level the exchange met and the int4 residuals
    carried into the next step."""
    trainer = _small_trainer(name, device, overlap)
    state = trainer.init_state(tree_map(lambda t: t.to(device), params))
    batch = tuple(t.to(device) for t in batch)
    width, losses = 0.0, []
    for _ in range(REF_STEPS):
        width = max(width, _level_width(name, trainer, state, batch))
        state = trainer.fit(state, [batch], n_steps=1)
        losses.append(trainer.losses.cpu())
    resid = [r.cpu() for r in state.algo_state.get("qr_residual", ())] \
        if isinstance(state.algo_state, dict) else []
    state = trainer.ddp.finalize_pending_updates(state)
    return losses, tree_map(lambda t: t.cpu(), trainer.ddp.params_unstacked(state)), width, resid


def _gradient_noise(device, params, batch) -> float:
    """The largest difference between the card's and the CPU's per-rank
    gradients at the same parameters and data: cuDNN sums the convolutions
    in another order than the CPU."""
    grads = []
    for dev in (device, torch.device("cpu")):
        trainer = _small_trainer("ByteGrad", dev)
        state = trainer.init_state(tree_map(lambda t: t.to(dev), params))
        grads.append(tree_leaves(trainer.ddp._rank_grads(state.params, tuple(t.to(dev) for t in batch))[1]))
    return max(float((g.cpu() - w).abs().max()) for g, w in zip(*grads))


def _within(name, what, got, want, tight, loose):
    """``got`` against ``want``, elementwise: every element within ``loose``
    (the most the flipped levels allow), and all but FLIPPED_SHARE of them
    within ``tight`` (rounding, where no level flipped).  Returns the
    largest difference and how many of how many elements lie beyond
    ``tight``."""
    d = torch.cat([(g.double() - w.double()).abs().flatten() for g, w in zip(got, want)])
    err, beyond = float(d.max()), int((d > tight).sum())
    if not (err <= loose and beyond <= FLIPPED_SHARE * d.numel()):
        raise AssertionError(
            f"{name}: {what} differ from the CPU run by up to {err:.3e} (tolerance {loose:.3e}), "
            f"{beyond} of {d.numel()} by more than {tight:.3e} (at most a share of {FLIPPED_SHARE})")
    return err, f"{beyond} of {d.numel()} beyond {tight:.3e}"


def phase_reference(device) -> None:
    """The slice's output against a reference on a small input: a small f32
    VGG trained on the card (the CUDA kernels) and on the CPU (the plain
    versions) from the same weights and data, once per algorithm.  TF32 is
    off.  ``noise`` is the largest card-vs-CPU difference of a gradient at
    the same parameters.

    - Losses: the first step's (before any exchange) within rtol 1e-5; the
      last step's, on parameters the exchanges made, within rtol 1e-4.
    - Parameters: a gradient that differs by ``noise`` may land one level
      away at each of the k quantizations an element meets (ByteGrad 2:
      compress and requantize; the ring RANKS: the first compress, RANKS - 2
      hops and the all-gather's compress; int4 one more, for the error
      carried over in the residual; ZeRO's reduce-scatter one quantization
      fewer than the ring, none in its exact all-gather).  So every element
      lies within REF_STEPS x REF_LR x k x the widest averaged level; where
      no level flipped, within REF_STEPS x REF_LR x (noise + a thousandth of
      that level), and at most FLIPPED_SHARE of the elements lie beyond.
      The f32 wires (``gradient_allreduce`` and ZeRO's) within REF_STEPS x
      REF_LR x F32_GROWTH x noise, all but FLIPPED_SHARE within REF_STEPS x
      REF_LR x noise.
    - int4 residuals: each element is one quantization's error, within half
      a level in sum space (RANKS averaged levels) on either device, so the
      two lie within one such level; where no level flipped, the residual
      carries the partial sums' noise, at most RANKS x noise a step, plus a
      thousandth of the level.  A residual that is not carried over, not
      fed back or zero fails this.

    Every wire but int4 runs with overlap (the engine's ``"auto"``) on both
    devices; on the card each also runs monolithic (``overlap=False``), and
    the two card runs' losses and parameters must be bitwise equal.  ZeRO's
    f32 and ByteGrad runs must also equal the unsharded f32 and (flat)
    ByteGrad runs on the card bit for bit (ZERO_TWINS).  The whole phase
    runs with cuDNN's deterministic algorithms."""
    with _deterministic():
        _reference_vgg(device)


def _reference_vgg(device) -> None:
    gen = torch.Generator().manual_seed(2)
    params = module_params(VGG(device="cpu", generator=gen, **REF_VGG))
    side = REF_VGG["image_size"]
    batch = (torch.rand((RANKS * 8, side, side, 3), generator=gen),
             torch.randint(0, REF_VGG["num_classes"], (RANKS * 8,), generator=gen))
    with _no_tf32():
        noise = _gradient_noise(device, params, batch)
    log(f"[reference] card vs CPU gradients at the same parameters within {noise:.3e}")
    card = {}

    def equal_runs(a, b):
        return all(same(x, y) for x, y in zip(a[0], b[0])) and \
            all(same(x, y) for x, y in zip(tree_leaves(a[1]), tree_leaves(b[1])))

    for name, (_, k, _) in REF_ALGORITHMS.items():
        with _no_tf32():
            got_losses, got, _, got_resid = _train_small_vgg(name, device, params, batch)
            card[name] = (got_losses, got)
            overlap = _small_trainer(name, device).ddp.overlap_enabled
            if overlap:
                mono_losses, mono, _, _ = _train_small_vgg(name, device, params, batch, overlap=False)
                if not equal_runs(card[name], (mono_losses, mono)):
                    raise AssertionError(f"{name}: overlap and monolithic runs on the card differ")
        if name in ZERO_TWINS and not equal_runs(card[name], card[ZERO_TWINS[name]]):
            raise AssertionError(f"{name}: differs on the card from the unsharded {ZERO_TWINS[name]} run")
        want_losses, want, width, want_resid = _train_small_vgg(name, torch.device("cpu"), params, batch)
        for step, rtol in ((0, 1e-5), (REF_STEPS - 1, 1e-4)):
            if not torch.allclose(got_losses[step], want_losses[step], rtol=rtol, atol=0.0):
                raise AssertionError(f"{name}: step {step + 1} losses {got_losses[step].tolist()} "
                                     f"vs CPU {want_losses[step].tolist()}")
        tight = REF_STEPS * REF_LR * (noise + 1e-3 * width)
        loose = REF_STEPS * REF_LR * (k * width if k else F32_GROWTH * noise)
        err, beyond = _within(name, "parameters", tree_leaves(got), tree_leaves(want), tight, loose)
        carry = ""
        if want_resid:
            level = RANKS * width
            if not all(bool(g.abs().max() > 0) for g in got_resid):
                raise AssertionError(f"{name}: a bucket's residual is zero on the card")
            r_max = max(float(g.abs().max()) for g in got_resid)
            r_err, r_beyond = _within(name, "residuals", got_resid, want_resid,
                                     REF_STEPS * RANKS * noise + 1e-3 * level, level)
            carry = (f"; residuals carried over up to {r_max:.3e}, card vs "
                     f"CPU within {r_err:.3e} (level {level:.3e}), {r_beyond}")
        if overlap:
            carry += "; overlap on the card bitwise equal to monolithic"
        if name in ZERO_TWINS:
            carry += f"; bitwise equal on the card to the unsharded {ZERO_TWINS[name]} run"
        log(f"[reference] small VGG, {REF_STEPS} {name} steps{' (overlap)' if overlap else ''}, "
            f"card vs CPU: losses "
            f"{got_losses[0].mean():.6f} -> {got_losses[-1].mean():.6f} vs "
            f"{want_losses[0].mean():.6f} -> {want_losses[-1].mean():.6f}; parameters within "
            f"{err:.3e} (tolerance {loose:.3e}), {beyond}{carry}")


#: the slice's paths: name -> (algorithm, launches per step and bucket of
#: each kernel that runs on it; every other kernel must not launch)
SLICE_PATHS = {
    "ByteGrad": (ByteGradAlgorithm, {"compress_minmax_uint8": 1, "decompress_minmax_uint8": 1,
                                     "decompress_reduce_requantize": 1}),
    "int8 ring": (functools.partial(GradientAllReduceAlgorithm, wire_precision="int8"),
                  {"compress_minmax_uint8": 2, "decompress_minmax_uint8": 2,
                   "hop_dequant_add_requant_int8": RANKS - 2}),
    "int4 ring": (functools.partial(GradientAllReduceAlgorithm, wire_precision="int4"),
                  {"hop_dequant_add_requant_int4": RANKS - 2}),
}


def _union(spans):
    """Sorted, disjoint intervals covering ``spans`` (start, end) pairs."""
    merged = []
    for start, stop in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], stop)
        else:
            merged.append([start, stop])
    return merged


def _length(intervals) -> float:
    return sum(stop - start for start, stop in intervals)


def _overlap_length(a, b) -> float:
    """The length of the intersection of two disjoint sorted interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def profile_step(name: str, step, side=None) -> None:
    """Traces one call of ``step`` with ``torch.profiler``: the card's
    kernels by time, its busy time (the union of its activities' intervals)
    and idle share of the wall time.  With ``side``, the stream an overlap
    step's exchange runs on (found in the trace by marker kernels launched
    on it before and after the step; the trace may miss its first kernel,
    so the second is launched after the step and the side stream is
    synchronized before the trace stops): that stream's busy time and the
    part of it during which an activity of another stream (the backward's:
    the main stream and cuDNN's own) also ran."""
    from torch.profiler import ProfilerActivity, profile as trace

    def mark():
        if side is not None:
            with torch.cuda.stream(side):
                torch.cuda._sleep(1)
            side.synchronize()

    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        mark()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        mark()
    log(f"[profile] {name}:\n" + prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    marker = [e for e in events if "spin_kernel" in e.name]
    events = [e for e in events if "spin_kernel" not in e.name]
    busy = _length(_union((e.time_range.start, e.time_range.end) for e in events)) / 1e3
    log(f"[profile] {name}, one traced step: {wall_ms:.1f} ms wall, card busy {busy:.1f} ms, "
        f"idle share {1 - busy / wall_ms:.3f}; streams {sorted({e.device_resource_id for e in events})}")
    if side is None:
        return
    streams = {e.device_resource_id for e in marker}
    if len(streams) != 1:
        log(f"[profile] {name}: {len(marker)} marker kernels on streams {sorted(streams)} in the trace, "
            "want 1 or 2 on one stream; the exchange's stream not measured")
        return
    stream, = streams
    log(f"[profile] {name}: {len(marker)} of 2 marker kernels in the trace")
    exchange = _union((e.time_range.start, e.time_range.end) for e in events if e.device_resource_id == stream)
    others = _union((e.time_range.start, e.time_range.end) for e in events if e.device_resource_id != stream)
    side_ms, hidden_ms = _length(exchange) / 1e3, _overlap_length(exchange, others) / 1e3
    log(f"[profile] {name}: the exchange's stream {stream} busy {side_ms:.1f} ms, of which "
        f"{hidden_ms:.1f} ms ({hidden_ms / max(side_ms, 1e-9):.3f}) while another stream ran; the "
        f"other streams busy {_length(others) / 1e3:.1f} ms")


def phase_slice(device, profile: bool, name: str):
    """STEPS steps of full-width VGG16 with the path ``name``; returns the
    launch counts of this run."""
    algorithm, per_bucket = SLICE_PATHS[name]
    group = init_process_group(devices=[device] * RANKS, intra_size=1)
    gen = torch.Generator(device=device).manual_seed(0)
    model, params = init_vgg16(gen, image_size=IMAGE_SIZE, num_classes=NUM_CLASSES,
                               compute_dtype=torch.bfloat16, device=device)
    trainer = Trainer(
        vgg_loss_fn(model), lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
        algorithm(), group, overlap=False,
    )
    state = trainer.init_state(params)
    del params
    plan = trainer.ddp.plan
    n = RANKS * BATCH_PER_RANK
    x = torch.rand((n, IMAGE_SIZE, IMAGE_SIZE, 3), generator=gen, device=device)
    y = torch.randint(0, NUM_CLASSES, (n,), generator=gen, device=device)
    batches = itertools.repeat((x, y))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state = trainer.fit(state, batches, n_steps=1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state = trainer.fit(state, batches, n_steps=STEPS - 1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_launches()

    losses = trainer.losses
    if not torch.isfinite(losses).all():
        raise AssertionError(f"{name}: non-finite loss {losses.tolist()}")
    for leaf in tree_leaves(state.params):
        if not all(torch.equal(leaf[0], leaf[r]) for r in range(1, RANKS)):
            raise AssertionError(f"{name}: ranks' parameters differ after the steps")
    want = {kernel: STEPS * plan.num_buckets * per_bucket.get(kernel, 0) for kernel in KERNELS}
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches}, want {want}")
    step_s = (t2 - t1) / (STEPS - 1)
    log(f"[slice] VGG16 bf16, {RANKS} ranks x batch {BATCH_PER_RANK}, {name}, "
        f"{plan.num_buckets} buckets: first step {t1 - t0:.3f} s, then {step_s * 1e3:.1f} ms/step "
        f"= {BATCH_PER_RANK / step_s:.1f} img/s per rank, {n / step_s:.1f} img/s on the card; "
        f"loss {losses.tolist()}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; launches {launches}")
    if profile:
        profile_step(name, lambda: trainer.fit(state, batches, n_steps=1))
    return launches


#: the overlap paths, through the synthetic benchmark's twin: name ->
#: (algorithm name, its arguments, launches per step and bucket)
OVERLAP_PATHS = {
    "ByteGrad": ("bytegrad", {}, SLICE_PATHS["ByteGrad"][1]),
    "int8 ring": ("gradient_allreduce", {"wire_precision": "int8"}, SLICE_PATHS["int8 ring"][1]),
    "f32 tuple": ("gradient_allreduce", {"fuse": "tuple"}, {}),
}


def phase_overlap(device, profile: bool, name: str) -> dict:
    """STEPS steps of full-width VGG16 through the synthetic benchmark's
    twin (``sb.run``: 1 warm-up step, STEPS - 1 timed) with the wire
    ``name``, monolithic and then with overlap, each from the same weights.
    Checks finite losses, the ranks' parameters bitwise equal, the launch
    counts (STEPS x buckets x per bucket) and, with overlap, that every
    bucket was exchanged once a step in ``backward_order()``.  Returns the
    two runs' summed launch counts."""
    algorithm, kwargs, per_bucket = OVERLAP_PATHS[name]
    group = init_process_group(devices=[device] * RANKS, intra_size=1)
    total, times = {}, {}
    for overlap in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        model, params = sb.build("vgg16", torch.bfloat16, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        result = sb.run(model, params, group, algorithm, kwargs, batch_size=BATCH_PER_RANK,
                        num_iters=STEPS - 1, num_warmup=1, overlap=overlap)
        launches = read_launches()
        del params
        ddp, what = result.ddp, f"{name} ({'overlap' if overlap else 'monolithic'})"
        if ddp.overlap_enabled is not overlap:
            raise AssertionError(f"{what}: the engine resolved overlap={ddp.overlap_enabled}")
        if not torch.isfinite(result.losses).all():
            raise AssertionError(f"{what}: non-finite loss {result.losses.tolist()}")
        for leaf in tree_leaves(result.state.params):
            if not all(torch.equal(leaf[0], leaf[r]) for r in range(1, RANKS)):
                raise AssertionError(f"{what}: ranks' parameters differ after the steps")
        buckets = ddp.plan.num_buckets
        want = {kernel: STEPS * buckets * per_bucket.get(kernel, 0) for kernel in KERNELS}
        if launches != want:
            raise AssertionError(f"{what}: launch counts {launches}, want {want}")
        exchanges = [STEPS if overlap else 0] * buckets
        order = ddp.plan.backward_order() if overlap else []
        if ddp.exchange_counts != exchanges or ddp.exchange_order != order:
            raise AssertionError(f"{what}: exchanges per bucket {ddp.exchange_counts}, want {exchanges}; "
                                 f"last step's order {ddp.exchange_order}, want {order}")
        times[overlap] = (result.step_seconds * 1e3, torch.cuda.max_memory_allocated() / 2**30)
        total = {k: total.get(k, 0) + n for k, n in launches.items()}
        log(f"[overlap] VGG16 bf16, {RANKS} ranks x batch {BATCH_PER_RANK}, {what}, {buckets} buckets: "
            f"warm-up step {result.warmup_seconds:.3f} s, then {times[overlap][0]:.1f} ms/step, peak memory "
            f"{times[overlap][1]:.1f} GiB, optimizer state {ddp.optimizer_state_bytes(result.state)} B per "
            f"rank; exchanges per bucket {ddp.exchange_counts} in order {ddp.exchange_order}; "
            f"launches {launches}")
        if profile:
            profile_step(what, lambda: ddp.train_step(result.state, result.batch), ddp.side_stream)
        del result, ddp, model
    log(f"[overlap] {name}: overlap {times[True][0]:.1f} ms/step against monolithic {times[False][0]:.1f} "
        f"(ratio {times[True][0] / times[False][0]:.3f}); peak memory {times[True][1]:.1f} against "
        f"{times[False][1]:.1f} GiB")
    return total


#: ZeRO through the synthetic benchmark's twin: name -> (ZeroAlgorithm's
#: arguments, overlap, launches per step and bucket).  The reduce-scatter
#: legs only: ByteGrad decompresses its own chunk, the ring runs its first
#: compress, RANKS - 2 hops and one decompress; the parameter all-gather
#: launches nothing
ZERO_PATHS = {
    "ZeRO f32": ({}, True, {}),
    "ZeRO ByteGrad": ({"compression": "bytegrad"}, True, SLICE_PATHS["ByteGrad"][1]),
    "ZeRO int8 ring": ({"wire_precision": "int8"}, True,
                       {"compress_minmax_uint8": 1, "decompress_minmax_uint8": 1,
                        "hop_dequant_add_requant_int8": RANKS - 2}),
    "ZeRO ByteGrad (monolithic)": ({"compression": "bytegrad"}, False, SLICE_PATHS["ByteGrad"][1]),
    "ZeRO int4 ring (monolithic)": ({"wire_precision": "int4"}, False,
                                    {"hop_dequant_add_requant_int4": RANKS - 2}),
}


def phase_zero(device, profile: bool, name: str) -> dict:
    """STEPS steps of full-width VGG16 under ZeRO through the synthetic
    benchmark's twin (``sb.run(..., "zero", ...)``: 1 warm-up step, STEPS -
    1 timed) on the path ``name``.  Checks finite losses, the ranks'
    parameters bitwise equal after the last gather, the launch counts, the
    census (with overlap, each bucket once a step in ``backward_order()``)
    and the optimizer state per rank (SGD momentum over each rank's shards:
    4 bytes an element of the padded buckets over RANKS).  Returns the
    launch counts."""
    kwargs, overlap, per_bucket = ZERO_PATHS[name]
    group = init_process_group(devices=[device] * RANKS, intra_size=1)
    gc.collect()
    torch.cuda.empty_cache()
    model, params = sb.build("vgg16", torch.bfloat16, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    result = sb.run(model, params, group, "zero", kwargs, batch_size=BATCH_PER_RANK,
                    num_iters=STEPS - 1, num_warmup=1, overlap=overlap)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params
    ddp = result.ddp
    if ddp.overlap_enabled is not overlap:
        raise AssertionError(f"{name}: the engine resolved overlap={ddp.overlap_enabled}")
    if not torch.isfinite(result.losses).all():
        raise AssertionError(f"{name}: non-finite loss {result.losses.tolist()}")
    state = ddp.finalize_pending_updates(result.state)
    for leaf in tree_leaves(state.params):
        if not all(torch.equal(leaf[0], leaf[r]) for r in range(1, RANKS)):
            raise AssertionError(f"{name}: ranks' parameters differ after the last gather")
    buckets = ddp.plan.num_buckets
    want = {kernel: STEPS * buckets * per_bucket.get(kernel, 0) for kernel in KERNELS}
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches}, want {want}")
    exchanges = [STEPS if overlap else 0] * buckets
    order = ddp.plan.backward_order() if overlap else []
    if ddp.exchange_counts != exchanges or ddp.exchange_order != order:
        raise AssertionError(f"{name}: exchanges per bucket {ddp.exchange_counts}, want {exchanges}; "
                             f"last step's order {ddp.exchange_order}, want {order}")
    opt_bytes = ddp.optimizer_state_bytes(state)
    if opt_bytes != 4 * sum(spec.numel for spec in ddp.plan.specs) // RANKS:
        raise AssertionError(f"{name}: optimizer state {opt_bytes} B per rank")
    step_ms = result.step_seconds * 1e3
    log(f"[zero] VGG16 bf16, {RANKS} ranks x batch {BATCH_PER_RANK}, {name}, {buckets} buckets: warm-up "
        f"step {result.warmup_seconds:.3f} s, then {step_ms:.1f} ms/step = "
        f"{BATCH_PER_RANK / result.step_seconds:.1f} img/s per rank, "
        f"{RANKS * BATCH_PER_RANK / result.step_seconds:.1f} img/s on the card; loss "
        f"{result.losses.tolist()}; peak memory {peak:.1f} GiB; optimizer state {opt_bytes} B per rank "
        f"(shard rows {sum(r.numel() * r.element_size() for r in state.optimizer.rows) // RANKS} B); "
        f"exchanges per bucket {ddp.exchange_counts} in order {ddp.exchange_order}; launches {launches}")
    if profile:
        profile_step(name, lambda: ddp.train_step(state, result.batch), ddp.side_stream)
    return launches


#: QAdam on the small VGG: the twin's lr, the compression phase from step 2
#: on, and eps 1e-3, not the default 1e-8.  After a warmup this short the
#: second moment has seen one gradient (the moments update on the first
#: warmup step only): a weight whose gradient was zero or tiny then steps
#: by m / (bc1 (sqrt(v) + eps)) once it gets a larger one.  At 1e-8 the
#: loss runs away within 6 steps in both packages
#: (tests/test_torch_q_adam.py::test_short_warmup_runs_away_at_the_default_eps)
QADAM = dict(lr=1e-3, warmup_steps=2, eps=1e-3)
#: QAdam at full width: full-width VGG16's loss is NaN by its sixth step at
#: the twin's lr (1e-3) and eps 1e-8, and 1.8e16 at eps 1e-3, so lr 1e-5.
#: The step's work does not depend on the values
QADAM_FULL = dict(QADAM, lr=1e-5)
#: the decentralized pair and QAdam on the small VGG: name -> (algorithm
#: factory, steps); QAdam crosses its warmup -> compression switch
REF_DP = {
    "decentralized all": (functools.partial(DecentralizedAlgorithm, peer_selection_mode="all"), REF_STEPS),
    "decentralized shift_one": (functools.partial(DecentralizedAlgorithm, peer_selection_mode="shift_one"),
                                REF_STEPS),
    "low-precision decentralized": (LowPrecisionDecentralizedAlgorithm, REF_STEPS),
    "QAdam": (lambda: QAdamAlgorithm(QAdamOptimizer(**QADAM)), 5),
}
#: small buckets, so that the small VGG's overlap runs have several
REF_DP_BUCKET = 1 << 16
#: low-precision decentralized with overlap against monolithic: every
#: element of every replica quantizes otherwise (per-bucket min/max), and
#: the trajectories part through the gradients; the JAX package's bound
#: for this pair (tests/test_overlap_compressed.py:148-151)
LP_OVERLAP_TOL = 2e-2


def _train_small_dp(name, device, params, batch, overlap):
    """The small f32 VGG over RANKS ranks (``intra_size=1``) with the
    algorithm ``name`` of REF_DP: every step's per-rank losses, every
    rank's final parameters and, for low-precision decentralized, the
    widest level of the weight differences it compressed (the range of
    each rank's replica update over 255)."""
    factory, steps = REF_DP[name]
    group = BaguaProcessGroup([device] * RANKS, intra_size=1)
    optimizer = None if name == "QAdam" else (lambda ps: torch.optim.SGD(ps, lr=REF_LR))
    ddp = DistributedDataParallel(vgg_loss_fn(VGG(device=device, **REF_VGG)), optimizer, factory(), group,
                                  bucket_size_bytes=REF_DP_BUCKET, overlap=overlap)
    state = ddp.init(tree_map(lambda t: t.to(device), params))
    batch = tuple(t.to(device) for t in batch)
    losses, width = [], 0.0
    for _ in range(steps):
        before = list(state.algo_state["weight"]) if isinstance(state.algo_state, dict) and \
            "weight" in state.algo_state else []
        state, step_losses = ddp.train_step(state, batch)
        losses.append(step_losses.cpu())
        for new, old in zip(state.algo_state["weight"] if before else [], before):
            d = new - old
            width = max(width, float((d.amax(1) - d.amin(1)).max()) / 255.0)
    return losses, [t.cpu() for t in tree_leaves(state.params)], width, ddp


def phase_reference_dp(device) -> None:
    """Decentralized SGD (``all`` and ``shift_one``), low-precision
    decentralized and QAdam on the small f32 VGG, on the card and on the
    CPU (plain versions) from the same weights and data, every rank's
    parameters held together (decentralized leaves the ranks apart):

    - decentralized: f32 rounding only, as the f32 wire's bound:
      REF_STEPS x REF_LR x F32_GROWTH x noise, all but FLIPPED_SHARE within
      REF_STEPS x REF_LR x noise;
    - low-precision decentralized: a difference one rounding away may land
      one level away at each replica's update, carried into the next step:
      REF_STEPS x (3 levels + REF_LR x F32_GROWTH x noise), all but
      FLIPPED_SHARE within REF_STEPS x (REF_LR x noise + a thousandth of a
      level), the level the widest of either run;
    - QAdam: each step moves a parameter by about lr (Adam's normalized
      step), the momentum quantized: within 5 x lr, all but FLIPPED_SHARE
      within a thousandth of that.

    On the card each runs monolithic and with overlap (small buckets, so
    several): decentralized's and QAdam's overlap runs equal their
    monolithic runs bit for bit (cuDNN deterministic); low-precision
    decentralized's per-bucket min/max is another quantization, within
    LP_OVERLAP_TOL of the monolithic run and not equal to it."""
    gen = torch.Generator().manual_seed(2)
    params = module_params(VGG(device="cpu", generator=gen, **REF_VGG))
    side = REF_VGG["image_size"]
    batch = (torch.rand((RANKS * 8, side, side, 3), generator=gen),
             torch.randint(0, REF_VGG["num_classes"], (RANKS * 8,), generator=gen))
    with _no_tf32():
        noise = _gradient_noise(device, params, batch)
    with _deterministic(), _no_tf32():
        for name, (_, steps) in REF_DP.items():
            got_losses, got, width, ddp = _train_small_dp(name, device, params, batch, overlap=False)
            ov_losses, ov, ov_width, ov_ddp = _train_small_dp(name, device, params, batch, overlap=True)
            want_losses, want, want_width, _ = _train_small_dp(name, torch.device("cpu"), params, batch, False)
            if not ov_ddp.overlap_enabled or ov_ddp.plan.num_buckets < 2:
                raise AssertionError(f"{name}: the overlap run has {ov_ddp.plan.num_buckets} buckets")
            width = max(width, ov_width, want_width)
            lr = QADAM["lr"] if name == "QAdam" else REF_LR
            if name == "QAdam":
                loose, tight = steps * lr, steps * lr * 1e-3
            elif name.startswith("low-precision"):
                loose = steps * (3 * width + lr * F32_GROWTH * noise)
                tight = steps * (lr * noise + 1e-3 * width)
            else:
                loose, tight = steps * lr * F32_GROWTH * noise, steps * lr * noise
            for step, rtol in ((0, 1e-5), (steps - 1, 1e-4 if name != "QAdam" else 1e-3)):
                if not torch.allclose(got_losses[step], want_losses[step], rtol=rtol, atol=0.0):
                    raise AssertionError(f"{name}: step {step + 1} losses {got_losses[step].tolist()} "
                                         f"vs CPU {want_losses[step].tolist()}")
            err, beyond = _within(name, "parameters", got, want, tight, loose)
            if name.startswith("low-precision"):
                ov_err = max(abs_err(a, b) for a, b in zip(ov, got))
                if all(same(a, b) for a, b in zip(ov, got)) or not all(
                        torch.allclose(a, b, rtol=LP_OVERLAP_TOL, atol=LP_OVERLAP_TOL) for a, b in zip(ov, got)):
                    raise AssertionError(f"{name}: overlap differs from monolithic by {ov_err:.3e}; want "
                                         f"within rtol and atol {LP_OVERLAP_TOL} and not bit for bit")
                mode = (f"overlap ({ov_ddp.plan.num_buckets} buckets) within {ov_err:.3e} of monolithic "
                        f"(tolerance {LP_OVERLAP_TOL}), level {width:.3e}")
            else:
                if not (all(same(a, b) for a, b in zip(ov, got)) and
                        all(same(a, b) for a, b in zip(ov_losses, got_losses))):
                    raise AssertionError(f"{name}: overlap and monolithic runs on the card differ")
                mode = f"overlap ({ov_ddp.plan.num_buckets} buckets) bitwise equal to monolithic"
            log(f"[reference] small VGG, {steps} {name} steps, card vs CPU: losses "
                f"{got_losses[0].mean():.6f} -> {got_losses[-1].mean():.6f} vs "
                f"{want_losses[0].mean():.6f} -> {want_losses[-1].mean():.6f}; parameters within "
                f"{err:.3e} (tolerance {loose:.3e}), {beyond}; {mode}")


def algo_state_bytes(state) -> int:
    """Bytes of algorithm state one rank holds: the distinct tensors of the
    state over the ranks (they are rank-stacked)."""
    seen = {}
    for t in tree_leaves(state.algo_state):
        if torch.is_tensor(t):
            seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values()) // RANKS


#: the decentralized pair and QAdam through the synthetic benchmark's twin:
#: name -> (algorithm, its arguments, overlap, launches per step and bucket
#: of each kernel on the steps that run it).  Low-precision decentralized
#: compresses its bucket's (RANKS, numel) difference once and decompresses
#: three times a step; QAdam runs ByteGrad's pipeline on its compression
#: steps only (every step from QADAM_FULL's warmup on)
DP_STEPS = 6
LP_PER_BUCKET = {"compress_minmax_uint8": 1, "decompress_minmax_uint8": 3}
DP_PATHS = {
    "decentralized shift_one": ("decentralized", {"peer_selection_mode": "shift_one"}, False, {}),
    "decentralized shift_one (overlap)": ("decentralized", {"peer_selection_mode": "shift_one"}, True, {}),
    "decentralized all": ("decentralized", {"peer_selection_mode": "all"}, False, {}),
    "low-precision decentralized": ("low_precision_decentralized", {}, False, LP_PER_BUCKET),
    "low-precision decentralized (overlap)": ("low_precision_decentralized", {}, True, LP_PER_BUCKET),
    "QAdam": ("qadam", {}, False, SLICE_PATHS["ByteGrad"][1]),
    "QAdam (overlap)": ("qadam", {}, True, SLICE_PATHS["ByteGrad"][1]),
}


def phase_dp(device, profile: bool, name: str) -> dict:
    """DP_STEPS steps of full-width VGG16 through the synthetic benchmark's
    twin (1 warm-up step, DP_STEPS - 1 timed) with the path ``name`` of
    DP_PATHS; QAdam with ``QAdamOptimizer(**QADAM_FULL)``.  Checks finite
    losses, the launch counts (per bucket, on every step or on QAdam's
    compression steps), the census (overlap in the weight and gradient
    modes: each bucket once a step in
    ``backward_order()``; low precision's post-step mode issues nothing
    from the backward) and, for the centralized QAdam, the ranks'
    parameters bitwise equal.  Prints ms/step, img/s per rank, the peak
    memory and the algorithm's state per rank; returns the launch counts."""
    algorithm, kwargs, overlap, per_bucket = DP_PATHS[name]
    if algorithm == "qadam":
        kwargs = {"q_adam_optimizer": QAdamOptimizer(**QADAM_FULL)}
    group = init_process_group(devices=[device] * RANKS, intra_size=1)
    gc.collect()
    torch.cuda.empty_cache()
    model, params = sb.build("vgg16", torch.bfloat16, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    result = sb.run(model, params, group, algorithm, kwargs, batch_size=BATCH_PER_RANK,
                    num_iters=DP_STEPS - 1, num_warmup=1, overlap=overlap)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params
    ddp = result.ddp
    if ddp.overlap_enabled is not overlap:
        raise AssertionError(f"{name}: the engine resolved overlap={ddp.overlap_enabled}")
    if not torch.isfinite(result.losses).all():
        raise AssertionError(f"{name}: non-finite loss {result.losses.tolist()}")
    if algorithm == "qadam":
        for leaf in tree_leaves(result.state.params):
            if not all(torch.equal(leaf[0], leaf[r]) for r in range(1, RANKS)):
                raise AssertionError(f"{name}: ranks' parameters differ after the steps")
    buckets = ddp.plan.num_buckets
    steps = DP_STEPS - QADAM_FULL["warmup_steps"] if algorithm == "qadam" else DP_STEPS
    want = {kernel: steps * buckets * per_bucket.get(kernel, 0) for kernel in KERNELS}
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches}, want {want}")
    if algorithm == "low_precision_decentralized":
        # the kernels phase held the codec at these rows
        kernels_plan = vgg16_plan()
        checked = [n for n, _ in slice_shapes(kernels_plan)] if overlap else [lp_row_elements(kernels_plan)]
        if [spec.numel for spec in ddp.plan.specs] != checked:
            raise AssertionError(f"{name}: buckets of {[spec.numel for spec in ddp.plan.specs]} elements, "
                                 f"the kernels phase checked rows of {checked}")
    hooked = overlap and algorithm != "low_precision_decentralized"
    exchanges = [DP_STEPS if hooked else 0] * buckets
    order = ddp.plan.backward_order() if hooked else []
    if ddp.exchange_counts != exchanges or ddp.exchange_order != order:
        raise AssertionError(f"{name}: exchanges per bucket {ddp.exchange_counts}, want {exchanges}; "
                             f"last step's order {ddp.exchange_order}, want {order}")
    step_ms = result.step_seconds * 1e3
    log(f"[dp] VGG16 bf16, {RANKS} ranks x batch {BATCH_PER_RANK}, {name}, {buckets} bucket(s): warm-up "
        f"step {result.warmup_seconds:.3f} s, then {step_ms:.1f} ms/step = "
        f"{BATCH_PER_RANK / result.step_seconds:.1f} img/s per rank, "
        f"{RANKS * BATCH_PER_RANK / result.step_seconds:.1f} img/s on the card; loss "
        f"{result.losses.tolist()}; peak memory {peak:.1f} GiB; algorithm state "
        f"{algo_state_bytes(result.state)} B per rank, optimizer state "
        f"{ddp.optimizer_state_bytes(result.state)} B per rank; exchanges per bucket "
        f"{ddp.exchange_counts}; launches {launches}")
    if profile:
        profile_step(name, lambda: ddp.train_step(result.state, result.batch), ddp.side_stream if hooked else None)
    return launches


def phase_mnist(device) -> dict:
    """The MNIST twin (``examples/mnist.py``) on the card, 3 steps over
    RANKS ranks with ``gradient_allreduce`` and Adam, then with ``"none"``:
    finite losses, no kernel launched.  Returns the launch counts."""
    reset_launches()
    for algorithm in ("gradient_allreduce", "none"):
        t0 = time.perf_counter()
        loss, acc = mnist.main(["--algorithm", algorithm, "--ranks", str(RANKS), "--steps", "3",
                                "--epochs", "1", "--batch-size", "256"])
        if not math.isfinite(loss):
            raise AssertionError(f"MNIST twin, {algorithm}: non-finite loss {loss}")
        log(f"[mnist] {algorithm}, {RANKS} ranks, 3 steps: loss {loss:.4f}, train accuracy {acc:.3f}, "
            f"{time.perf_counter() - t0:.1f} s with the data and the evaluation")
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"MNIST twin: launch counts {launches}, want none")
    return launches


REF_LLAMA = LlamaConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
                        intermediate_size=512, max_position_embeddings=256, sp_axis="intra",
                        sp_layout="zigzag")
REF_LLAMA_BATCH, REF_LLAMA_LR = 2, 0.5


def _train_small_llama(device, params, ids, cfg=REF_LLAMA, layout=(1, 1, RANKS)):
    """REF_STEPS SGD steps of a small Llama on the example's ``(dp, tp, sp)``
    ``layout``, from ``params`` on ``ids`` (global, zigzag-permuted).
    Returns every step's per-rank losses and the final rank-0 parameters,
    on the CPU."""
    axes = lp.mesh_axes(*layout)
    group = BaguaProcessGroup([device] * RANKS, intra_size=axes["intra_size"])
    model = LlamaModel(cfg, group, device=device)
    stacked = lp.replicate(tree_map(lambda t: t.to(device), params), RANKS)
    optimizer = torch.optim.SGD(tree_leaves(stacked), lr=REF_LLAMA_LR)
    loss_fn = llama_loss_fn(model)
    shards = lp.shard_ids(ids, group, device, axes["dp_axis"], axes["sp_axis"])
    losses = [lp.train_step(stacked, optimizer, shards, loss_fn, group, axes["avg_axis"]).cpu()
              for _ in range(REF_STEPS)]
    return losses, tree_map(lambda t: t[0].detach().cpu(), stacked)


def phase_llama_reference(device, cfg=REF_LLAMA, layout=(1, 1, RANKS)) -> None:
    """The Llama slice's output against a reference on a small input: a
    small Llama (hidden 256, 4 heads, 2 K/V heads, 2 layers, vocab 512,
    global sequence 256 over RANKS ranks on the example's ``(dp, tp, sp)``
    ``layout``: zigzag sp 4, or tp 2 x sp 2) trained REF_STEPS SGD steps on
    the card (the CUDA kernels) and on the CPU (the plain versions) from the
    same weights and ids, TF32 off.  SGD, not Adam, so that a gradient off by
    a factor shows in the parameters.

    - Losses: the first step's within rtol 1e-5 (f32 sums in another
      order), the last step's within rtol 1e-4.
    - Parameters: every element within 1e-5 + 1e-4 |value| of the CPU run:
      REF_STEPS steps of REF_LLAMA_LR times gradients that agree to about
      1e-6 (the kernels' and cuBLAS's sums against the CPU's)."""
    gen = torch.Generator().manual_seed(5)
    _, params = init_llama(cfg, gen, device="cpu")
    seq = cfg.max_position_embeddings
    sp = layout[2]
    ids = torch.randint(0, cfg.vocab_size, (REF_LLAMA_BATCH, seq), generator=gen)
    ids = ids[:, zigzag_order(seq, sp)]
    reset_launches()
    with _no_tf32():
        got_losses, got = _train_small_llama(device, params, ids, cfg, layout)
    launches = read_launches()
    want_losses, want = _train_small_llama(torch.device("cpu"), params, ids, cfg, layout)
    calls = REF_STEPS * cfg.num_layers * sp * 4
    what = f"small Llama (dp {layout[0]} x tp {layout[1]} x sp {sp})"
    for name in ATTENTION_TOLS:
        if launches[name] != calls:
            raise AssertionError(f"{what}: {name} launched {launches[name]} times, want {calls}")
    for step, rtol in ((0, 1e-5), (REF_STEPS - 1, 1e-4)):
        if not torch.allclose(got_losses[step], want_losses[step], rtol=rtol, atol=0.0):
            raise AssertionError(f"{what}: step {step + 1} losses {got_losses[step].tolist()} "
                                 f"vs CPU {want_losses[step].tolist()}")
    err = 0.0
    for (name, g), w in zip(tree_flatten_with_names(got), tree_leaves(want)):
        err = max(err, float((g - w).abs().max()))
        if not torch.allclose(g, w, rtol=1e-4, atol=1e-5):
            raise AssertionError(f"{what}: parameter {name} differs from the CPU run by up to "
                                 f"{float((g - w).abs().max()):.3e}")
    moved = max(float((w - p).abs().max()) for w, p in zip(tree_leaves(want), tree_leaves(params)))
    log(f"[reference] {what}, {REF_STEPS} SGD steps over {RANKS} ranks, card vs CPU: "
        f"losses {got_losses[0].mean():.6f} -> {got_losses[-1].mean():.6f} vs "
        f"{want_losses[0].mean():.6f} -> {want_losses[-1].mean():.6f}; parameters within "
        f"{err:.3e} (they moved up to {moved:.3e}); {calls} launches of each attention kernel")


#: the tensor-parallel reference's small Llama: REF_LLAMA at tp 2 (tp =
#: inter) x sp 2 (sp = intra)
REF_LLAMA_TP = dataclasses.replace(REF_LLAMA, tp_size=2, tp_axis="inter")
REF_SP_MLP = dict(hidden=64, inter=128, tokens=32)


class SPMLP(torch.nn.Module):
    """Path (a)'s model: ``ColumnParallelDense(gather_input)`` -> GELU (tanh,
    as ``jax.nn.gelu``) -> ``RowParallelDense(scatter_output)``, with
    biases, over the ``intra`` axis of ``group``; tokens arrive and leave
    row-sharded (the sequence-parallel layout)."""

    def __init__(self, hidden, inter, tp, fused, group, device, generator=None):
        super().__init__()
        kw = dict(fused=fused, group=group, device=device, generator=generator)
        self.ColumnParallelDense_0 = ColumnParallelDense(hidden, inter, tp, "intra", gather_input=True, **kw)
        self.RowParallelDense_0 = RowParallelDense(inter // tp, hidden, tp, "intra", scatter_output=True, **kw)

    def forward(self, params, x):
        h = self.ColumnParallelDense_0(params["ColumnParallelDense_0"], x)
        return self.RowParallelDense_0(params["RowParallelDense_0"], gelu(h))


def sp_mlp_setup(hidden, inter, tp, tokens, device):
    """Path (a)'s parameters, per rank (rank r's drawn from seed r, as
    ``tests/test_parallel.py:545-560`` draws them), stacked; each rank's
    row block of a global input and of a target, seeded."""
    trees = []
    for r in range(tp):
        gen = torch.Generator(device=device).manual_seed(r)
        trees.append(module_params(SPMLP(hidden, inter, tp, False, None, device, gen)))
    params = tree_unflatten(trees[0], [torch.stack(leaves) for leaves in zip(*map(tree_leaves, trees))])
    del trees
    gen = torch.Generator(device=device).manual_seed(tp)
    x = torch.randn((tp, tokens // tp, hidden), generator=gen, device=device)
    target = torch.randn((tp, tokens // tp, hidden), generator=gen, device=device)
    return params, x, target


def sp_mlp_step(model, params, x, target, optimizer=None):
    """Each rank's mean squared error against its target rows; the gradient
    of their sum; an SGD step if ``optimizer``.  Returns the per-rank
    losses."""
    losses = ((model(params, x) - target) ** 2).mean(dim=(1, 2))
    losses.sum().backward()
    if optimizer is not None:
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
    return losses.detach()


def _train_sp_mlp(device, params, x, target, fused, steps, lr, widths):
    group = BaguaProcessGroup([device] * SP_MLP_TP)
    model = SPMLP(widths["hidden"], widths["inter"], SP_MLP_TP, fused, group, "meta")
    params = tree_map(lambda t: t.detach().to(device, copy=True).requires_grad_(), params)
    optimizer = torch.optim.SGD(tree_leaves(params), lr=lr)
    x, target = x.to(device), target.to(device)
    losses = [sp_mlp_step(model, params, x, target, optimizer).cpu() for _ in range(steps)]
    return losses, tree_map(lambda t: t.detach().cpu(), params)


def phase_tp_reference(device) -> None:
    """The tensor-parallel slice's outputs against references on small
    inputs, card (the tile kernel) vs CPU (the plain version), TF32 off:
    path (a)'s fused pair at tp 4 (hidden 64, MLP 128, 32 tokens), REF_STEPS
    SGD steps at lr 0.5, losses within rtol 1e-5 / 1e-4 (first / last step)
    and parameters within 1e-5 + 1e-4 |value|; then the small Llama at tp 2
    x sp 2 as :func:`phase_llama_reference` holds it."""
    w = REF_SP_MLP
    params, x, target = sp_mlp_setup(w["hidden"], w["inter"], SP_MLP_TP, w["tokens"], torch.device("cpu"))
    reset_launches()
    with _no_tf32():
        got_losses, got = _train_sp_mlp(device, params, x, target, True, REF_STEPS, 0.5, w)
    launches = read_launches()["matmul_tile"]
    want_losses, want = _train_sp_mlp(torch.device("cpu"), params, x, target, True, REF_STEPS, 0.5, w)
    if launches != REF_STEPS * 5 * SP_MLP_TP:
        raise AssertionError(f"small SP MLP: {launches} matmul_tile launches, want {REF_STEPS * 5 * SP_MLP_TP}")
    for step, rtol in ((0, 1e-5), (REF_STEPS - 1, 1e-4)):
        if not torch.allclose(got_losses[step], want_losses[step], rtol=rtol, atol=0.0):
            raise AssertionError(f"small SP MLP: step {step + 1} losses {got_losses[step].tolist()} "
                                 f"vs CPU {want_losses[step].tolist()}")
    err = 0.0
    for (name, g), wt in zip(tree_flatten_with_names(got), tree_leaves(want)):
        err = max(err, float((g - wt).abs().max()))
        if not torch.allclose(g, wt, rtol=1e-4, atol=1e-5):
            raise AssertionError(f"small SP MLP: parameter {name} differs from the CPU run by up to "
                                 f"{float((g - wt).abs().max()):.3e}")
    moved = max(float((wt - p).abs().max()) for wt, p in zip(tree_leaves(want), tree_leaves(params)))
    log(f"[reference] small fused SP MLP pair, tp {SP_MLP_TP}, {REF_STEPS} SGD steps, card vs CPU: "
        f"losses {got_losses[0].mean():.6f} -> {got_losses[-1].mean():.6f} vs "
        f"{want_losses[0].mean():.6f} -> {want_losses[-1].mean():.6f}; parameters within {err:.3e} "
        f"(they moved up to {moved:.3e}); {launches} matmul_tile launches")
    phase_llama_reference(device, REF_LLAMA_TP, (1, 2, 2))


def phase_llama_slice(device, profile: bool, layout=(1, 1, RANKS)) -> dict:
    """LLAMA_STEPS AdamW steps of the Llama slice: llama_7b_config's width, 2
    layers, one sequence of LLAMA_SEQ tokens over RANKS ranks on this one
    card on the example's ``(dp, tp, sp)`` ``layout`` (zigzag sp 4, or tp 2
    x sp 2: tp = inter, sp = intra), f32.  Checks the loss is finite, the
    ranks' parameters are bitwise equal (the tp ranks are replicas of one
    shard, as in JAX) and each kernel's launch count; returns the counts."""
    axes = lp.mesh_axes(*layout)
    tp, sp = layout[1], layout[2]
    cfg = llama_7b_config(num_layers=LLAMA_LAYERS, tp_size=tp, tp_axis=axes["tp_axis"] or "intra",
                          sp_axis=axes["sp_axis"], sp_layout="zigzag")
    group = init_process_group(devices=[device] * RANKS, intra_size=axes["intra_size"])
    gen = torch.Generator(device=device).manual_seed(0)
    model, params = init_llama(cfg, gen, device, group)
    stacked = lp.replicate(params, RANKS)
    del params
    optimizer = lp.make_optimizer(stacked, LLAMA_LR)
    loss_fn = llama_loss_fn(model)
    ids_gen = torch.Generator().manual_seed(0)
    zz = zigzag_order(LLAMA_SEQ, sp)
    batches = [lp.shard_ids(torch.randint(0, cfg.vocab_size, (LLAMA_BATCH, LLAMA_SEQ),
                                          generator=ids_gen)[:, zz], group, device,
                            axes["dp_axis"], axes["sp_axis"])
               for _ in range(LLAMA_STEPS + 1)]
    step = functools.partial(lp.train_step, stacked, optimizer, loss_fn=loss_fn, group=group,
                             axis=axes["avg_axis"])
    n_params = sum(p[0].numel() for p in tree_leaves(stacked))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    losses = [step(batches[0])]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for ids in batches[1:LLAMA_STEPS]:
        losses.append(step(ids))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_launches()

    what = f"Llama (dp {layout[0]} x tp {tp} x sp {sp})"
    losses = torch.stack(losses).cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"{what}: non-finite loss {losses.tolist()}")
    for leaf in tree_leaves(stacked):
        if not all(torch.equal(leaf[0], leaf[r]) for r in range(1, RANKS)):
            raise AssertionError(f"{what}: ranks' parameters differ after the steps")
    # every (ring step, q half, k half) pair is launched, for all ranks at once
    calls = LLAMA_STEPS * LLAMA_LAYERS * sp * 4
    want = {kernel: calls if kernel in ATTENTION_TOLS else 0 for kernel in KERNELS}
    if launches != want:
        raise AssertionError(f"{what}: launch counts {launches}, want {want}")
    step_s = (t2 - t1) / (LLAMA_STEPS - 1)
    tokens = LLAMA_BATCH * LLAMA_SEQ
    log(f"[slice] {what} at 7B width ({cfg.hidden_size} hidden, {cfg.num_heads} heads, "
        f"{cfg.intermediate_size} MLP, vocab {cfg.vocab_size}), {LLAMA_LAYERS} layers, "
        f"{n_params} parameters per rank, f32; {LLAMA_BATCH} x {LLAMA_SEQ} tokens over {RANKS} "
        f"ranks: first step {t1 - t0:.3f} s, then {step_s * 1e3:.1f} ms/step = "
        f"{tokens / step_s:.1f} tokens/s on the card; loss {losses[:, 0].tolist()}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; launches {launches} "
        f"({calls} each expected: {LLAMA_STEPS} steps x {LLAMA_LAYERS} layers x {sp} ring steps "
        f"x 4 half-block pairs)")
    if profile:
        profile_step(what, lambda: step(batches[-1]))
    return launches


def _sp_mlp_grads(model, params, x, target):
    """Per-rank losses and parameter gradients of one step, no update."""
    params = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    losses = sp_mlp_step(model, params, x, target)
    return losses, tree_map(lambda t: t.grad, params)


def phase_sp_mlp_slice(device, profile: bool) -> dict:
    """Path (a): SP_MLP_STEPS SGD steps of the fused sequence-parallel MLP
    pair at llama_7b_config's widths, SP_MLP_TP ranks of SP_MLP_TOKENS /
    SP_MLP_TP tokens each on this one card, f32.  Checks that the first
    step's losses and gradients equal the unfused pair's (all-gather +
    ``torch.matmul``, ``psum``) within 1e-5 relative (losses) and 1e-4 of
    each leaf's largest gradient (f32 sums of up to 11,008 terms in another
    order: typically sqrt(K) 2^-24, 6e-6); the loss is finite; exactly 20
    ``matmul_tile`` launches a step and no other kernel.  Then one forward
    and backward of ``ParallelMLP(fused=True)`` against ``fused=False`` on
    the whole replicated sequence, with its own exact count.  Returns the
    steps' launch counts."""
    cfg, tp = llama_7b_config(), SP_MLP_TP
    hidden, inter = cfg.hidden_size, cfg.intermediate_size
    group = init_process_group(devices=[device] * tp)
    params, x, target = sp_mlp_setup(hidden, inter, tp, SP_MLP_TOKENS, device)
    fused, unfused = (SPMLP(hidden, inter, tp, f, group, "meta") for f in (True, False))
    with _no_tf32():
        want_losses, want_grads = _sp_mlp_grads(unfused, params, x, target)
        reset_launches()
        got_losses, got_grads = _sp_mlp_grads(fused, params, x, target)
    per_step = read_launches()["matmul_tile"]
    if not torch.allclose(got_losses, want_losses, rtol=1e-5, atol=0.0):
        raise AssertionError(f"path (a): fused losses {got_losses.tolist()} vs unfused {want_losses.tolist()}")
    grad_err = 0.0
    for (name, g), wg in zip(tree_flatten_with_names(got_grads), tree_leaves(want_grads)):
        rel = float((g - wg).abs().max() / wg.abs().max())
        grad_err = max(grad_err, rel)
        if rel > 1e-4:
            raise AssertionError(f"path (a): fused gradient {name} differs from unfused by {rel:.3e} "
                                 f"of its largest element")
    del want_grads, got_grads
    log(f"[slice] path (a) first step: fused losses {got_losses.tolist()} vs unfused "
        f"{want_losses.tolist()}; gradients within {grad_err:.3e} of each leaf's largest; "
        f"{per_step} matmul_tile launches")

    params = tree_map(lambda t: t.requires_grad_(), params)
    optimizer = torch.optim.SGD(tree_leaves(params), lr=SP_MLP_LR)
    step = functools.partial(sp_mlp_step, fused, params, x, target, optimizer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with _no_tf32():
        t0 = time.perf_counter()
        losses = [step()]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses += [step() for _ in range(SP_MLP_STEPS - 1)]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launches = read_launches()
    losses = torch.stack(losses).cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"path (a): non-finite loss {losses.tolist()}")
    calls = SP_MLP_STEPS * 5 * tp
    want = {kernel: calls if kernel == "matmul_tile" else 0 for kernel in KERNELS}
    if launches != want:
        raise AssertionError(f"path (a): launch counts {launches}, want {want}")
    step_s = (t2 - t1) / (SP_MLP_STEPS - 1)
    gemm_tflop = 10 * SP_MLP_TOKENS * hidden * inter / 1e12  # 5 products of 2 T H I
    log(f"[slice] path (a): fused SP MLP pair at 7B width ({hidden} -> {inter} -> {hidden}), tp {tp}, "
        f"{SP_MLP_TOKENS // tp} tokens per rank, f32: first step {t1 - t0:.3f} s, then "
        f"{step_s * 1e3:.1f} ms/step ({gemm_tflop:.3f} TFLOP of tile GEMMs a step, "
        f"{gemm_tflop / step_s:.1f} TFLOP/s end to end); loss {losses.mean(1).tolist()}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; launches {launches['matmul_tile']} "
        f"({calls} expected: {SP_MLP_STEPS} steps x {5 * tp}: {2 * tp} forward, {tp} Column dw, "
        f"{2 * tp} Row dx and dw)")
    if profile:
        with _no_tf32():
            profile_step("path (a)", step)

    # ParallelMLP: a replicated input; the Row's matmul_rs ring + all-gather
    with _no_tf32():
        mlp_x = allgather(x, group)
        outs = []
        for f in (False, True):
            gen = torch.Generator(device=device).manual_seed(0)
            mlp = ParallelMLP(hidden, inter, hidden, tp, "intra", fused=f, group=group, device=device,
                              generator=gen)
            mlp_params = tree_map(lambda t: t[None].repeat(tp, *([1] * t.dim())).requires_grad_(),
                                  module_params(mlp))
            reset_launches()
            out = mlp(mlp_params, mlp_x)
            (out ** 2).mean().backward()
            torch.cuda.synchronize()
            outs.append((out.detach(), [t.grad for t in tree_leaves(mlp_params)], read_launches()["matmul_tile"]))
            del out, mlp_params
    (y_u, g_u, n_u), (y_f, g_f, n_f) = outs
    y_err = float((y_f - y_u).abs().max() / y_u.abs().max())
    g_err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_f, g_u))
    if n_u != 0 or n_f != 3 * tp or y_err > 1e-4 or g_err > 1e-4:
        raise AssertionError(f"ParallelMLP fused vs unfused: output {y_err:.3e}, gradients {g_err:.3e} "
                             f"of their largest; launches {n_f} fused (want {3 * tp}), {n_u} unfused")
    log(f"[slice] ParallelMLP({hidden} -> {inter} -> {hidden}, tp {tp}, fused) on {SP_MLP_TOKENS} "
        f"replicated tokens: output within {y_err:.3e}, gradients within {g_err:.3e} of the unfused "
        f"layer's (relative to the largest); {n_f} matmul_tile launches (forward {tp}, backward {2 * tp})")
    return launches


def vgg16_plan():
    """The bucket plan of VGG16 over RANKS ranks, from the model's shapes
    alone (built on the meta device); every algorithm here aligns its
    buckets to the same exchange size."""
    group = BaguaProcessGroup([torch.device("cpu")] * RANKS, intra_size=1)
    params = module_params(vgg16(device="meta"))
    return ByteGradAlgorithm().reify(group).tensors_to_buckets(params)


def main(argv) -> int:
    profile = "--profile" in argv
    phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    ledger = Ledger()
    phase_kernels(ledger, vgg16_plan(), device)
    phase_attention_kernels(ledger, device)
    phase_matmul_kernels(ledger, device)
    phase_rings(device)
    torch.cuda.empty_cache()
    phase_reference(device)
    phase_reference_dp(device)
    phase_llama_reference(device)
    phase_tp_reference(device)
    per_path = {}
    for name in SLICE_PATHS:
        per_path[name] = phase_slice(device, profile, name)
        torch.cuda.empty_cache()
    for name in OVERLAP_PATHS:
        per_path[f"{name} via the synthetic benchmark"] = phase_overlap(device, profile, name)
    for name in ZERO_PATHS:
        per_path[name] = phase_zero(device, profile, name)
    for name in DP_PATHS:
        per_path[name] = phase_dp(device, profile, name)
    torch.cuda.empty_cache()
    per_path["MNIST"] = phase_mnist(device)
    per_path["Llama"] = phase_llama_slice(device, profile)
    torch.cuda.empty_cache()
    per_path["Llama tp"] = phase_llama_slice(device, profile, (1, 2, 2))
    torch.cuda.empty_cache()
    per_path["SP MLP"] = phase_sp_mlp_slice(device, profile)
    kernels = []
    for name, (_, _, source, replaces) in KERNELS.items():
        row = ledger.rows[name]
        launches = sum(counts[name] for counts in per_path.values())
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
        for step, sums in ledger.other_steps.items():
            if name in sums:
                kernels[-1].setdefault("other_steps", {})[step] = sums[name]
        if name == "matmul_tile":
            kernels[-1]["library"] = "torch.matmul in f32, TF32 off (the plain version is the same call)"
        elif row["library_ms"] is not None:
            kernels[-1]["library"] = ("F.scaled_dot_product_attention, a near-equivalent: it "
                                      "normalizes and returns no l or m" + (
                                          "; its one backward computes dq, dk and dv"
                                          if name != "block_attention" else ""))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
