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
   at the main path's shapes (VGG16's 10 MiB buckets over 4 ranks), at
   ragged chunks and on degenerate inputs; times both with CUDA events
   (median of 20 after 3 warm-up calls) beside the least time the card
   could take (bytes over 3.35 TB/s, or operations over 67 TFLOP/s f32).
4. reference -- trains a small f32 VGG with ByteGrad on the card and on
   the CPU (plain versions) from the same weights and data, and holds the
   two runs' losses and parameters together within stated tolerances.
5. slice   -- trains full-width VGG16 (224x224, 1000 classes, bf16
   compute, f32 parameters, batch 32 per rank) with ByteGrad over 4 ranks
   on this one card (``intra_size=1``: every rank its own node, so the
   whole exchange is compressed) for 5 steps through ``Trainer.fit``;
   checks the loss is finite, the ranks' parameters are bitwise equal and
   every kernel's launch count is steps x buckets.  ``--profile`` then
   traces one more step with ``torch.profiler``.
6. prints one JSON line naming each kernel with its launches and times,
   then the result line ``{"ok": true, "device": {...}}``.
"""

import itertools
import json
import statistics
import subprocess
import sys
import time

import torch

from bagua_tpu_torch import BaguaProcessGroup, init_process_group
from bagua_tpu_torch.algorithms import ByteGradAlgorithm
from bagua_tpu_torch.kernels import _build
from bagua_tpu_torch.kernels import minmax_uint8 as mm8
from bagua_tpu_torch.models.vgg import VGG, init_vgg16, module_params, vgg16, vgg_loss_fn
from bagua_tpu_torch.trainer import Trainer
from bagua_tpu_torch.utils import tree_leaves, tree_map

RANKS = 4
STEPS = 5
BATCH_PER_RANK = 32
IMAGE_SIZE = 224
NUM_CLASSES = 1000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SOURCE = "bagua_tpu_torch/kernels/csrc/minmax_uint8.cu"
KERNELS = {
    # name: (wrapper, plain version, TPU kernel it replaces)
    "compress_minmax_uint8": (
        mm8.compress_minmax_uint8, mm8.compress_minmax_uint8_plain,
        "bagua_tpu/kernels/minmax_uint8.py:195",
    ),
    "decompress_minmax_uint8": (
        mm8.decompress_minmax_uint8, mm8.decompress_minmax_uint8_plain,
        "bagua_tpu/kernels/minmax_uint8.py:232",
    ),
    "decompress_reduce_requantize": (
        mm8.decompress_reduce_requantize, mm8.decompress_reduce_requantize_plain,
        "bagua_tpu/kernels/minmax_uint8.py:318",
    ),
}


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


def median_ms(fn, reps: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class Ledger:
    """Per kernel: comparisons made, worst error, summed times per step."""

    def __init__(self):
        self.rows = {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                                bound_by="bytes", checks=0) for name in KERNELS}

    def compare(self, name: str, case: str, *args, **kwargs):
        wrapper, plain, _ = KERNELS[name]
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

    def time(self, name: str, nbytes: int, ops: int, *args, **kwargs):
        wrapper, plain, _ = KERNELS[name]
        row = self.rows[name]
        ms = median_ms(lambda: wrapper(*args, **kwargs))
        plain_ms = median_ms(lambda: plain(*args, **kwargs))
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["bound_ms"] += max(bytes_ms, ops_ms)
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
    built = _build.build(["minmax_uint8"])
    for name, path, seconds in built:
        with open(f"{path}.log") as f:
            regs = [line.split("ptxas info    : ")[-1] for line in f if "registers" in line]
        log(f"[build] {name}.cu in {seconds:.1f} s -> {path}; ptxas: {' | '.join(regs)}")
    log(f"[build] done in {time.perf_counter() - t0:.1f} s")


def slice_shapes(plan):
    """(numel, chunk) of each bucket ByteGrad exchanges over RANKS ranks."""
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


def phase_kernels(ledger: Ledger, plan, device) -> None:
    gen = torch.Generator(device=device).manual_seed(1)
    # the main path's shapes: every bucket of VGG16 over 4 ranks, timed
    for numel, chunk in slice_shapes(plan):
        x = torch.randn((RANKS, numel), generator=gen, device=device) * 1e-3
        flat, fused_in, dec_in = pipeline_inputs(x, RANKS)
        rows = RANKS * RANKS
        case = f"bucket of {numel} elements"
        ledger.compare("compress_minmax_uint8", case, flat)
        ledger.compare("decompress_reduce_requantize", case, *fused_in)
        ledger.compare("decompress_reduce_requantize", case + " (sum)", *fused_in, average=False)
        ledger.compare("decompress_minmax_uint8", case, *dec_in)
        t = [
            ledger.time("compress_minmax_uint8", rows * chunk * 5 + rows * 8, rows * chunk * 6, flat),
            ledger.time("decompress_reduce_requantize", rows * chunk + rows * 8 + RANKS * (chunk + 8),
                        rows * chunk * 3 + RANKS * chunk * 5, *fused_in),
            ledger.time("decompress_minmax_uint8", rows * chunk * 5 + rows * 8, rows * chunk * 2, *dec_in),
        ]
        if numel == max(s[0] for s in slice_shapes(plan)):
            for name, (ms, plain_ms, bound_ms) in zip(
                ("compress", "fused reduce", "decompress"), t
            ):
                log(f"[kernels] {case}, chunk {chunk}: {name} {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {bound_ms:.4f} ms")
    # ragged chunks
    for chunk in (7, 4095, 65539):
        x = torch.randn((RANKS, RANKS * chunk), generator=gen, device=device) * 3.0
        flat, fused_in, dec_in = pipeline_inputs(x, RANKS)
        ledger.compare("compress_minmax_uint8", f"chunk {chunk}", flat)
        ledger.compare("decompress_reduce_requantize", f"chunk {chunk}", *fused_in)
        ledger.compare("decompress_minmax_uint8", f"chunk {chunk}", *dec_in)
    # degenerate inputs (tests/test_bytegrad.py:87-236), a NaN, signed zeros
    cases = {f"constant {v}": torch.full((4, 4096), v, device=device)
             for v in (0.0, 1.5, 2.5, -7.0, 1e32, -1e35, 3.4e38, 8.8e33)}
    mixed = torch.randn((4, 4096), generator=gen, device=device)
    mixed[1], mixed[3] = 0.0, -2.5e33
    cases["mixed"] = mixed
    cases["constant 1.7e33, chunk 129"] = torch.full((5, 129), 1.7e33, device=device)
    nan = torch.randn((3, 257), generator=gen, device=device)
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
    for name, row in ledger.rows.items():
        log(f"[kernels] {name}: {row['checks']} comparisons bitwise, per step over "
            f"{plan.num_buckets} buckets {row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms)")


REF_STEPS, REF_LR = 3, 0.05
REF_VGG = dict(num_classes=10, cfg=(16, "M", 32, "M"), classifier_width=64, image_size=32)


def _train_small_vgg(device, params, batch):
    """REF_STEPS ByteGrad steps of the small f32 VGG over RANKS ranks
    (``intra_size=1``).  Returns the first step's per-rank losses, the
    final rank-0 parameters, and the widest quantization level the
    exchange met: over each rank's chunks and the chunks of their mean."""
    group = BaguaProcessGroup([device] * RANKS, intra_size=1)
    trainer = Trainer(vgg_loss_fn(VGG(device=device, **REF_VGG)),
                      lambda ps: torch.optim.SGD(ps, lr=REF_LR), ByteGradAlgorithm(), group)
    state = trainer.init_state(tree_map(lambda t: t.to(device), params))
    batch = tuple(t.to(device) for t in batch)
    width, first_losses = 0.0, None
    for _ in range(REF_STEPS):
        _, grads = trainer.ddp._rank_grads(state.params, batch)
        for flat in trainer.ddp.plan.bucketize(grads):
            for chunks in (flat.reshape(-1, flat.shape[1] // RANKS), flat.mean(0).reshape(RANKS, -1)):
                width = max(width, float((chunks.amax(1) - chunks.amin(1)).max()) / 255.0)
        state = trainer.fit(state, [batch], n_steps=1)
        first_losses = trainer.losses.cpu() if first_losses is None else first_losses
    return first_losses, tree_map(lambda t: t.cpu(), trainer.ddp.params_unstacked(state)), width


def phase_reference(device) -> None:
    """The slice's output against a reference on a small input: a small f32
    VGG trained with ByteGrad on the card (the CUDA kernels) and on the CPU
    (the plain versions) from the same weights and data.  TF32 is off.  The
    first step's losses agree within rtol 1e-5 (cuDNN sums the convolutions
    in another order than the CPU); the parameters within REF_STEPS x REF_LR
    x 2 levels of the widest chunk, since a gradient that differs in its last
    bit may land one level away at the compress and one at the requantize."""
    gen = torch.Generator().manual_seed(2)
    params = module_params(VGG(generator=gen, **REF_VGG))
    side = REF_VGG["image_size"]
    batch = (torch.rand((RANKS * 8, side, side, 3), generator=gen),
             torch.randint(0, REF_VGG["num_classes"], (RANKS * 8,), generator=gen))
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got_loss, got, _ = _train_small_vgg(device, params, batch)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    want_loss, want, width = _train_small_vgg(torch.device("cpu"), params, batch)
    if not torch.allclose(got_loss, want_loss, rtol=1e-5, atol=0.0):
        raise AssertionError(f"first-step losses {got_loss.tolist()} vs CPU {want_loss.tolist()}")
    atol = REF_STEPS * REF_LR * 2 * width
    err = max(float((g - w).abs().max()) for g, w in zip(tree_leaves(got), tree_leaves(want)))
    if not err <= atol:
        raise AssertionError(f"parameters differ from the CPU run by {err:.3e} > {atol:.3e}")
    log(f"[reference] small VGG, {REF_STEPS} ByteGrad steps, card vs CPU: first-step loss "
        f"{got_loss.mean():.6f} vs {want_loss.mean():.6f}; parameters within {err:.3e} "
        f"(tolerance {atol:.3e})")


def phase_slice(device, profile: bool):
    group = init_process_group(devices=[device] * RANKS, intra_size=1)
    gen = torch.Generator(device=device).manual_seed(0)
    model, params = init_vgg16(gen, image_size=IMAGE_SIZE, num_classes=NUM_CLASSES,
                               compute_dtype=torch.bfloat16, device=device)
    trainer = Trainer(
        vgg_loss_fn(model), lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
        ByteGradAlgorithm(), group,
    )
    state = trainer.init_state(params)
    plan = trainer.ddp.plan
    n = RANKS * BATCH_PER_RANK
    x = torch.rand((n, IMAGE_SIZE, IMAGE_SIZE, 3), generator=gen, device=device)
    y = torch.randint(0, NUM_CLASSES, (n,), generator=gen, device=device)
    batches = itertools.repeat((x, y))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in mm8.KERNELS:
        fn.launches = 0
    t0 = time.perf_counter()
    state = trainer.fit(state, batches, n_steps=1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state = trainer.fit(state, batches, n_steps=STEPS - 1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {fn.__name__: fn.launches for fn in mm8.KERNELS}

    losses = trainer.losses
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite loss {losses.tolist()}")
    for leaf in tree_leaves(state.params):
        if not all(torch.equal(leaf[0], leaf[r]) for r in range(1, RANKS)):
            raise AssertionError("ranks' parameters differ after ByteGrad steps")
    want = STEPS * plan.num_buckets
    if any(c != want for c in launches.values()):
        raise AssertionError(f"launch counts {launches}, want {want} each")
    step_s = (t2 - t1) / (STEPS - 1)
    log(f"[slice] VGG16 bf16, {RANKS} ranks x batch {BATCH_PER_RANK}, ByteGrad, "
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
        log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
        # the card is busy while any of its activities runs: the union of
        # their intervals (microseconds)
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        busy_us, end = 0.0, float("-inf")
        for start, stop in spans:
            if stop > end:
                busy_us, end = busy_us + stop - max(start, end), stop
        log(f"[profile] one traced step: {wall_ms:.1f} ms wall, card busy {busy_us / 1e3:.1f} ms, "
            f"idle share {1 - busy_us / 1e3 / wall_ms:.3f}")
    return launches


def vgg16_plan():
    """The bucket plan ByteGrad uses for VGG16 over RANKS ranks, from the
    model's shapes alone (built on the meta device)."""
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
    launches = phase_slice(device, profile)
    kernels = []
    for name, (_, _, replaces) in KERNELS.items():
        row = ledger.rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[name], "max_abs_err": row["max_abs_err"],
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
