#!/usr/bin/env python3
"""Times two versions of the port's tile GEMM and three flash-attention
kernels on one card, in turns, at the main paths' shapes.

    git archive <commit> | tar -x -C _chipcheck/parent
    python3 chip_kernel_ab.py --parent _chipcheck/parent [--variant="-DNAME=VALUE ..." ...]

``--parent`` is an unpacked tree of another commit of this repository.
Its ``collective_matmul.cu`` and ``flash_attention.cu`` are built with this
tree's ``nvcc`` flags into ``<parent>/ab_build/``; both versions keep the
same C interface, so this tree's wrappers drive either library.  Each
``--variant`` builds this tree's ``collective_matmul.cu`` once more with
its ``nvcc`` flags (space-separated; ``-DMATMUL_MIN_BLOCKS=1`` is
``__launch_bounds__(256, 1)``, the other knobs are at the top of the
source) and times it beside the others.  Every timing is ``chip_smoke``'s
``median_ms``, taken in the order parent, this tree, this tree, parent (and
each variant after), at each of path (a)'s five tile products
(``chip_smoke.sp_mlp_gemms``) and, for the forward (``block_attention``),
dq and dk/dv, at each distinct block of the Llama sp 4 slice
(``chip_smoke.zigzag_pair_masks``), with f32 K/V as the slice runs them
and again with bf16 K/V; then summed per step as ``chip_smoke.py`` sums
them.  Each library's output is first held to ``chip_smoke.py``'s gates
(``matmul_tol``; ``ATTENTION_TOLS``).  Prints each build's ``ptxas``
lines, one line per shape and one JSON line of the sums; exits non-zero
without a card.
"""

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys

import torch

import chip_smoke as cs
from bagua_tpu_torch.kernels import _build
from bagua_tpu_torch.kernels import collective_matmul as cm
from bagua_tpu_torch.kernels import flash_attention as fa
from bagua_tpu_torch.models.llama import llama_7b_config

SOURCES = {"collective_matmul": cm, "flash_attention": fa}


def build(src: str, out: str, extra=()) -> subprocess.Popen:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    name = os.path.basename(src)[:-3]
    cmd = [_build.nvcc_path(), *_build.flags(name), *extra, "-o", out, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def typed(module, path: str) -> ctypes.CDLL:
    """The library at ``path``, its C functions typed as ``module._lib()``
    types this tree's."""
    lib = ctypes.CDLL(path)
    saved = _build.load
    _build.load = lambda name: lib
    try:
        return module._lib()
    finally:
        _build.load = saved


@contextlib.contextmanager
def using(module, lib):
    """``module``'s wrappers launch ``lib``'s kernels."""
    saved = module._lib
    module._lib = lambda: lib
    try:
        yield
    finally:
        module._lib = saved


def turns(libs: dict, module, call, check) -> dict:
    """``call``'s time with each library, in the order parent, this tree,
    this tree, parent, then each variant: name -> [ms, ...].  Each
    library's output must pass ``check(output)`` first."""
    for name, lib in libs.items():
        with using(module, lib):
            check(name, call())
    order = ["parent", "tree", "tree", "parent"] + [n for n in libs if n not in ("parent", "tree")]
    times = {}
    for name in order:
        with using(module, libs[name]):
            times.setdefault(name, []).append(cs.median_ms(call))
    return times


def gemm_cases(device):
    """Path (a)'s five products, with the operands as chip_smoke's kernels
    phase builds them."""
    cfg, tp = llama_7b_config(), cs.SP_MLP_TP
    gen = torch.Generator(device=device).manual_seed(6)
    for name, (m, k, n, trans, per_step) in cs.sp_mlp_gemms(
            cfg.hidden_size, cfg.intermediate_size, tp, cs.SP_MLP_TOKENS).items():
        if trans == "x":
            x = torch.randn((tp, k, m), generator=gen, device=device).transpose(1, 2)
        else:
            x = torch.randn((tp, tp, m, k), generator=gen, device=device)[:, 1]
        w = (torch.randn((tp, n, k), generator=gen, device=device).transpose(1, 2)
             if trans == "w" else torch.randn((tp, k, n), generator=gen, device=device))
        yield name, per_step, x, w


def attention_cases(device, kv_dtype=torch.float32):
    """The Llama sp 4 slice's distinct blocks, with the calls a step makes of
    each, as chip_smoke's attention phase builds them (K/V in ``kv_dtype``)."""
    cfg = cs.llama_slice_config()
    h, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    t2 = cs.LLAMA_SEQ // (2 * cs.RANKS)
    gen = torch.Generator(device=device).manual_seed(4)
    qf, k, v, dl, do = cs.attention_inputs(gen, device, cs.RANKS * cs.LLAMA_BATCH, t2, t2, h,
                                           cfg.num_kv_heads, d, kv_dtype)
    blocks = {}
    for mask in cs.zigzag_pair_masks(cs.RANKS, t2, device):
        key = mask.cpu().numpy().tobytes()
        blocks.setdefault(key, [mask.repeat_interleave(cs.LLAMA_BATCH, 0).contiguous(), 0])[1] += \
            cs.LLAMA_LAYERS
    for n, (mask, calls) in enumerate(blocks.values()):
        m = fa.block_attention_plain(qf, k, v, mask)[2]
        yield f"block {n} (live share {float(mask.float().mean()):.3f})", calls, (qf, k, v, mask, m, dl, do)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="an unpacked tree of the commit to compare with")
    ap.add_argument("--variant", action="append", default=[],
                    help="nvcc flags (space-separated) for one more build of this tree's tile GEMM")
    args = ap.parse_args(argv)
    smi = cs.phase_device()
    device = torch.device("cuda", 0)

    _build.build(list(SOURCES))
    jobs = {}
    for name in SOURCES:
        src = os.path.join(args.parent, "bagua_tpu_torch", "kernels", "csrc", f"{name}.cu")
        out = os.path.join(args.parent, "ab_build", f"lib{name}.so")
        jobs[("parent", name)] = (out, build(src, out))
    for i, flag in enumerate(args.variant):
        out = os.path.join(args.parent, "ab_build", f"libcollective_matmul-variant{i}.so")
        jobs[(flag, "collective_matmul")] = (out, build(os.path.join(_build.CSRC_DIR, "collective_matmul.cu"),
                                                         out, flag.split()))
    libs = {name: {"tree": module._lib()} for name, module in SOURCES.items()}
    for name in SOURCES:
        with open(f"{_build.library_path(name)}.log") as f:
            regs = [line.split("ptxas info    : ")[-1].strip() for line in f if "registers" in line]
        cs.log(f"[build] tree {name}.cu: {' | '.join(regs)}")
    for (who, name), (out, proc) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {who} {name}.cu:\n{text}")
        regs = [line.split("ptxas info    : ")[-1].strip() for line in text.splitlines() if "registers" in line]
        cs.log(f"[build] {who} {name}.cu: {' | '.join(regs)}")
        libs[name][who] = typed(SOURCES[name], out)

    sums = {}

    def record(kernel, case, per_step, times):
        row = sums.setdefault(kernel, {})
        for who, ms in times.items():
            row[who] = row.get(who, 0.0) + per_step * min(ms)
        cs.log(f"[ab] {kernel} {case}, {per_step} a step: " + ", ".join(
            f"{who} {' / '.join(f'{t:.4f}' for t in ms)} ms" for who, ms in times.items()))

    with cs._no_tf32():
        for case, per_step, x, w in gemm_cases(device):
            want = cm.matmul_tile_plain(x, w)

            def check_gemm(who, got):
                share = cs.matmul_share(got, want, x, w)
                if share > 1.0:
                    raise AssertionError(f"{who} matmul_tile on {case}: {share:.3f} of the bound")
                cs.log(f"[ab] {who} matmul_tile on {case}: {share:.2e} of the bound, "
                       f"bitwise torch.matmul: {cs.same(got, want)}")

            record("matmul_tile", case, per_step,
                   turns(libs["collective_matmul"], cm, lambda: cm.matmul_tile(x, w), check_gemm))
            del x, w, want
        for kv_dtype, suffix in ((torch.float32, ""), (torch.bfloat16, " (bf16 K/V)")):
            for case, per_step, args_ in attention_cases(device, kv_dtype):
                for kernel, plain, n_args in ((fa.block_attention, fa.block_attention_plain, 4),
                                              (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dq_plain, 7),
                                              (fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dkv_plain, 7)):
                    name, call_args = kernel.__name__, args_[:n_args]
                    # against the f32 values (K/V widened exactly): a bf16 dk or dv may
                    # round the other way than the plain version's own cast
                    want = plain(*(a.float() if i in (1, 2) else a for i, a in enumerate(call_args)))
                    want = want if isinstance(want, tuple) else (want,)

                    def check(who, got):
                        got = got if isinstance(got, tuple) else (got,)
                        if not all(g.shape == w.shape and cs.close(g, w, tol) for g, w, tol in
                                   zip(got, want, cs.ATTENTION_TOLS[name])):
                            raise AssertionError(f"{who} {name} on {case}{suffix}: outside the tolerance")

                    record(name + suffix, case, per_step,
                           turns(libs["flash_attention"], fa, lambda: kernel(*call_args), check))
                    del want
    cs.log(smi)
    print(json.dumps({"per_step_ms": sums, "note": "sum over a step of the faster of each "
                      "version's timings at each shape"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
