#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bagua_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Phases, in order; the first that fails ends the run with a non-zero exit
and no result line:

1. device  -- a CUDA device must be visible; prints the card's name and
   power limit as ``nvidia-smi`` gives them.
2. build   -- builds the CUDA sources of ``bagua_tpu_torch/kernels/csrc``
   with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per source, in parallel).
3. kernels -- holds each kernel against its plain PyTorch version, bitwise,
   at the main paths' shapes (VGG16's 10 MiB buckets over 4 ranks: ByteGrad's
   chunks and the quantized ring's blocks of 4096), at ragged chunks and
   blocks and on degenerate inputs; times both with CUDA events (the
   median of 5 batches of 10 back-to-back calls, each batch enqueued while
   the card is kept busy, after 3 warm-up calls) beside the least time the
   card could take (bytes over 3.35 TB/s, or operations over 67 TFLOP/s
   f32), summed over one VGG16 step.
4. reference -- trains a small f32 VGG with ByteGrad, with the int8 ring and
   with the int4 ring on the card and on the CPU (plain versions) from the
   same weights and data, and holds each pair of runs' losses and
   parameters together within stated tolerances.
5. slice   -- trains full-width VGG16 (224x224, 1000 classes, bf16
   compute, f32 parameters, batch 32 per rank) over 4 ranks on this one
   card through ``Trainer.fit``, 5 steps each with ByteGrad (``intra_size=1``:
   every rank its own node, so the whole exchange is compressed) and with
   ``GradientAllReduceAlgorithm(wire_precision="int8")`` and ``"int4"``
   (flat: a ring of 4, 2 hops per bucket); checks the loss is finite, the
   ranks' parameters are bitwise equal and every kernel's launch count.
   ``--profile`` then traces one more step of each with ``torch.profiler``.
6. prints one JSON line naming each kernel with its launches and times,
   then the result line ``{"ok": true, "device": {...}}``.
"""

import contextlib
import functools
import itertools
import json
import statistics
import subprocess
import sys
import time

import torch

from bagua_tpu_torch import BaguaProcessGroup, init_process_group
from bagua_tpu_torch.algorithms import ByteGradAlgorithm, GradientAllReduceAlgorithm
from bagua_tpu_torch.kernels import _build
from bagua_tpu_torch.kernels import minmax_uint8 as mm8
from bagua_tpu_torch.kernels import quantized_ring as qr
from bagua_tpu_torch.models.vgg import VGG, init_vgg16, module_params, vgg16, vgg_loss_fn
from bagua_tpu_torch.trainer import Trainer
from bagua_tpu_torch.utils import tree_leaves, tree_map

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
}


def reset_launches() -> None:
    for fn in mm8.KERNELS + qr.KERNELS:
        fn.launches = 0
    qr.hop_dequant_add_requant.launches_by_bits.update({8: 0, 4: 0})


def read_launches() -> dict:
    """Each kernel's launches since :func:`reset_launches`, by KERNELS name."""
    counts = {fn.__name__: fn.launches for fn in mm8.KERNELS}
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
                                bound_by="bytes", checks=0) for name in KERNELS}

    def compare(self, name: str, case: str, *args, **kwargs):
        wrapper, plain, _, _ = KERNELS[name]
        got, want = wrapper(*args, **kwargs), plain(*args, **kwargs)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        row = self.rows[name]
        row["checks"] += 1
        for g, w in zip(got, want):
            row["max_abs_err"] = max(row["max_abs_err"], abs_err(g, w))
            if not same(g, w):
                raise AssertionError(f"{name} differs from its plain version on {case}")
        return got if len(got) > 1 else got[0]

    def time(self, name: str, nbytes: int, ops: int, *args, per_step: int = 1, **kwargs):
        """Times one call; adds ``per_step`` times it (the calls one step
        makes at this shape) to the kernel's per-step sums."""
        wrapper, plain, _, _ = KERNELS[name]
        row = self.rows[name]
        ms = median_ms(lambda: wrapper(*args, **kwargs))
        plain_ms = median_ms(lambda: plain(*args, **kwargs))
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        row["ms"] += per_step * ms
        row["plain_ms"] += per_step * plain_ms
        row["bound_ms"] += per_step * max(bytes_ms, ops_ms)
        if ops_ms > bytes_ms:
            row["bound_by"] = "operations"
        return ms, plain_ms, max(bytes_ms, ops_ms)


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
    built = _build.build(["minmax_uint8", "quantized_ring"])
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
            "compress": ledger.time("compress_minmax_uint8", rows * chunk * 5 + rows * 8,
                                    rows * chunk * 6, flat),
            "fused reduce": ledger.time("decompress_reduce_requantize",
                                        rows * chunk + rows * 8 + RANKS * (chunk + 8),
                                        rows * chunk * 3 + RANKS * chunk * 5, *fused_in),
            "decompress": ledger.time("decompress_minmax_uint8", rows * chunk * 5 + rows * 8,
                                      rows * chunk * 2, *dec_in),
        }
        del flat, fused_in, dec_in
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
    for name, row in ledger.rows.items():
        log(f"[kernels] {name}: {row['checks']} comparisons bitwise, per step over "
            f"{plan.num_buckets} buckets {row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms)")


REF_STEPS, REF_LR = 3, 0.05
REF_VGG = dict(num_classes=10, cfg=(16, "M", 32, "M"), classifier_width=64, image_size=32)
#: the reference phase's algorithms: name -> (algorithm, quantizations one
#: element meets per exchange, levels)
REF_ALGORITHMS = {
    "ByteGrad": (ByteGradAlgorithm, 2, 255.0),
    "int8 ring": (functools.partial(GradientAllReduceAlgorithm, wire_precision="int8"), RANKS, 255.0),
    "int4 ring": (functools.partial(GradientAllReduceAlgorithm, wire_precision="int4"), RANKS + 1, 15.0),
}
#: the share of elements that may lie beyond rounding: those a flipped level
#: moved (a flip disturbs at most its own block)
FLIPPED_SHARE = 0.05


def _level_width(name, trainer, state, batch) -> float:
    """The widest quantization level the exchange can meet this step, in
    units of the averaged gradient.  ByteGrad: over each rank's chunks and
    the chunks of their mean.  The ring: every partial sum of a bucket lies
    within plus or minus the sum over ranks of each rank's largest
    |gradient + residual|, divided by the RANKS of the average."""
    _, grads = trainer.ddp._rank_grads(state.params, batch)
    resid = state.algo_state.get("qr_residual") if isinstance(state.algo_state, dict) else None
    levels = REF_ALGORITHMS[name][2]
    width = 0.0
    for i, flat in enumerate(trainer.ddp.plan.bucketize(grads)):
        if name == "ByteGrad":
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


def _small_trainer(name, device):
    group = BaguaProcessGroup([device] * RANKS, intra_size=1)
    return Trainer(vgg_loss_fn(VGG(device=device, **REF_VGG)),
                   lambda ps: torch.optim.SGD(ps, lr=REF_LR), REF_ALGORITHMS[name][0](), group)


def _train_small_vgg(name, device, params, batch):
    """REF_STEPS steps of the small f32 VGG over RANKS ranks (``intra_size=1``)
    with algorithm ``name``.  Returns every step's per-rank losses, the
    final rank-0 parameters, the widest quantization level the exchange met
    and the int4 residuals carried into the next step."""
    trainer = _small_trainer(name, device)
    state = trainer.init_state(tree_map(lambda t: t.to(device), params))
    batch = tuple(t.to(device) for t in batch)
    width, losses = 0.0, []
    for _ in range(REF_STEPS):
        width = max(width, _level_width(name, trainer, state, batch))
        state = trainer.fit(state, [batch], n_steps=1)
        losses.append(trainer.losses.cpu())
    resid = [r.cpu() for r in state.algo_state.get("qr_residual", ())] \
        if isinstance(state.algo_state, dict) else []
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
      carried over in the residual).  So every element lies within
      REF_STEPS x REF_LR x k x the widest averaged level; where no level
      flipped, within REF_STEPS x REF_LR x (noise + a thousandth of that
      level), and at most FLIPPED_SHARE of the elements lie beyond.
    - int4 residuals: each element is one quantization's error, within half
      a level in sum space (RANKS averaged levels) on either device, so the
      two lie within one such level; where no level flipped, the residual
      carries the partial sums' noise, at most RANKS x noise a step, plus a
      thousandth of the level.  A residual that is not carried over, not
      fed back or zero fails this."""
    gen = torch.Generator().manual_seed(2)
    params = module_params(VGG(device="cpu", generator=gen, **REF_VGG))
    side = REF_VGG["image_size"]
    batch = (torch.rand((RANKS * 8, side, side, 3), generator=gen),
             torch.randint(0, REF_VGG["num_classes"], (RANKS * 8,), generator=gen))
    with _no_tf32():
        noise = _gradient_noise(device, params, batch)
    log(f"[reference] card vs CPU gradients at the same parameters within {noise:.3e}")
    for name, (_, k, _) in REF_ALGORITHMS.items():
        with _no_tf32():
            got_losses, got, _, got_resid = _train_small_vgg(name, device, params, batch)
        want_losses, want, width, want_resid = _train_small_vgg(name, torch.device("cpu"), params, batch)
        for step, rtol in ((0, 1e-5), (REF_STEPS - 1, 1e-4)):
            if not torch.allclose(got_losses[step], want_losses[step], rtol=rtol, atol=0.0):
                raise AssertionError(f"{name}: step {step + 1} losses {got_losses[step].tolist()} "
                                     f"vs CPU {want_losses[step].tolist()}")
        err, beyond = _within(name, "parameters", tree_leaves(got), tree_leaves(want),
                             REF_STEPS * REF_LR * (noise + 1e-3 * width), REF_STEPS * REF_LR * k * width)
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
        log(f"[reference] small VGG, {REF_STEPS} {name} steps, card vs CPU: losses "
            f"{got_losses[0].mean():.6f} -> {got_losses[-1].mean():.6f} vs "
            f"{want_losses[0].mean():.6f} -> {want_losses[-1].mean():.6f}; parameters within "
            f"{err:.3e} (tolerance {REF_STEPS * REF_LR * k * width:.3e}), {beyond}{carry}")


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


def _busy_ms(prof) -> float:
    """The card is busy while any of its activities runs: the union of
    their intervals (milliseconds)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy_us, end = busy_us + stop - max(start, end), stop
    return busy_us / 1e3


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
        algorithm(), group,
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
        from torch.profiler import ProfilerActivity, profile as trace

        with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state = trainer.fit(state, batches, n_steps=1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        log(f"[profile] {name}:\n" + prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
        busy = _busy_ms(prof)
        log(f"[profile] {name}, one traced step: {wall_ms:.1f} ms wall, card busy {busy:.1f} ms, "
            f"idle share {1 - busy / wall_ms:.3f}")
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
    phase_reference(device)
    per_path = {}
    for name in SLICE_PATHS:
        per_path[name] = phase_slice(device, profile, name)
        torch.cuda.empty_cache()
    kernels = []
    for name, (_, _, source, replaces) in KERNELS.items():
        row = ledger.rows[name]
        launches = sum(counts[name] for counts in per_path.values())
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
