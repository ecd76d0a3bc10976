#!/usr/bin/env python3
"""Times two versions of the port's CUDA kernels on one card, in turns, at
the main paths' shapes.

    git archive <commit> | tar -x -C _chipcheck/parent
    python3 chip_kernel_ab.py --parent _chipcheck/parent [--kernels codec,attention,gemm] \
        [--variant="[source:]-DNAME=VALUE ..." ...] [--ring-block 4096]

``--parent`` is an unpacked tree of another commit of this repository.
The sources of the chosen kernel families (``--kernels``, all three by
default: ``codec`` is ``minmax_uint8.cu`` and ``quantized_ring.cu``,
``attention`` ``flash_attention.cu``, ``gemm`` ``collective_matmul.cu``)
are built from that tree with this tree's ``nvcc`` flags into
``<parent>/ab_build/``; both versions keep the same C interface, so this
tree's wrappers drive either library.  Each ``--variant`` builds one of
this tree's sources once more with extra ``nvcc`` flags (space-separated,
after ``source:``; no source means ``collective_matmul``, where
``-DMATMUL_MIN_BLOCKS=1`` is ``__launch_bounds__(256, 1)``; each source's
knobs are at its top: ``FUSED_CTAS_PASS1``/``FUSED_CTAS_PASS2`` in
``minmax_uint8.cu``, ``HOP_MIN_BLOCKS_8``/``HOP_MIN_BLOCKS_4`` in
``quantized_ring.cu``) and times it beside the others.  Every
timing is ``chip_smoke``'s ``median_ms``, taken in the order parent, this
tree, this tree, parent (and each variant after):

- codec: compress, the fused reduce, decompress and the int8 and int4
  hops at every bucket of VGG16 over 4 ranks (``chip_smoke.slice_shapes``,
  inputs from ``pipeline_inputs`` and ``hop_inputs``), the hops twice a
  step (RANKS - 2); and compress and decompress at the int8 ring's blocks
  (``ring_codec_inputs``: two calls of each a step), summed apart as
  ``compress_minmax_uint8 (int8 ring)`` and ``decompress_minmax_uint8
  (int8 ring)``; the ring's blocks and the hops' are ``--ring-block``
  elements (``chip_smoke.BLOCK``, the ring's default, unless given);
- gemm: path (a)'s five tile products (``chip_smoke.sp_mlp_gemms``);
- attention: the forward (``block_attention``), dq and dk/dv at each
  distinct block of the Llama sp 4 slice (``chip_smoke.zigzag_pair_masks``),
  with f32 K/V as the slice runs them and again with bf16 K/V;

then summed per step as ``chip_smoke.py`` sums them.  Each library's
output is first held to ``chip_smoke.py``'s gates (codecs and hops
bitwise; ``matmul_tol``; ``ATTENTION_TOLS``).  Prints each build's
``ptxas`` lines, one line per shape and one JSON line: the per-step sums,
each kernel's time at its largest shape (VGG16's Dense_0 bucket for the
codecs), and each kernel's worst ratio of this tree's time to the
parent's over its shapes.  Exits non-zero without a card.
"""

import argparse
import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

import chip_smoke as cs
from bagua_tpu_torch.kernels import _build
from bagua_tpu_torch.kernels import collective_matmul as cm
from bagua_tpu_torch.kernels import flash_attention as fa
from bagua_tpu_torch.kernels import minmax_uint8 as mm8
from bagua_tpu_torch.kernels import quantized_ring as qr
from bagua_tpu_torch.models.llama import llama_7b_config

SOURCES = {"collective_matmul": cm, "flash_attention": fa, "minmax_uint8": mm8, "quantized_ring": qr}
#: the sources of each kernel family
FAMILIES = {"gemm": ("collective_matmul",), "attention": ("flash_attention",),
            "codec": ("minmax_uint8", "quantized_ring")}


def build(src: str, out: str, extra=()) -> subprocess.Popen:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    name = os.path.basename(src)[:-3]
    cmd = [_build.nvcc_path(), *_build.flags(name), *extra, "-o", out, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas(text: str) -> str:
    """Each kernel's registers, stack frame and spills, from ``nvcc -Xptxas
    -v``'s output."""
    rows, name = [], "?"
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+", "", line.split("'")[1])
            name = name[:name.find("Ev")] if "Ev" in name else name
        elif "bytes stack frame" in line:
            stack, stores, loads = re.findall(r"(\d+) bytes", line)[:3]
            spill = f", {stack} B stack, {stores}/{loads} B spilled" if int(stack) or int(stores) else ""
        elif "registers" in line:
            rows.append(f"{name} {re.search(r'Used (\d+) registers', line).group(1)} regs{spill}")
    return " | ".join(rows)


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


def codec_cases(device, block=cs.BLOCK):
    """Every bucket of VGG16 over RANKS ranks with the codec and hop calls a
    step makes of it, as chip_smoke's kernels phase builds them: ByteGrad's
    compress, fused reduce and decompress, the int8 ring's two compresses
    and two decompresses (summed apart, as ``<kernel> (int8 ring)``), and
    the hops, the ring's in blocks of ``block`` elements: (case, [(kernel,
    sum, calls a step, source, arguments)])."""
    gen = torch.Generator(device=device).manual_seed(1)
    ring = " (int8 ring)"
    for numel, chunk in cs.slice_shapes(cs.vgg16_plan()):
        x = torch.randn((cs.RANKS, numel), generator=gen, device=device) * 1e-3
        flat, fused_in, dec_in = cs.pipeline_inputs(x, cs.RANKS)
        calls = [("compress_minmax_uint8", "compress_minmax_uint8", 1, "minmax_uint8", (flat,)),
                 ("decompress_reduce_requantize", "decompress_reduce_requantize", 1, "minmax_uint8",
                  fused_in),
                 ("decompress_minmax_uint8", "decompress_minmax_uint8", 1, "minmax_uint8", dec_in)]
        comp_in, rs_dec, ag_dec = cs.ring_codec_inputs(x, block)
        calls += [("compress_minmax_uint8", "compress_minmax_uint8" + ring, 1, "minmax_uint8", (b,))
                  for b in comp_in]
        calls += [("decompress_minmax_uint8", "decompress_minmax_uint8" + ring, 1, "minmax_uint8", d)
                  for d in (rs_dec, ag_dec)]
        incoming = x[:, :chunk] + x[:, chunk:2 * chunk]
        for bits in (8, 4):
            name = f"hop_dequant_add_requant_int{bits}"
            calls.append((name, name, cs.RANKS - 2, "quantized_ring",
                          cs.hop_inputs(incoming, x[:, 2 * chunk:3 * chunk], block, bits)))
        yield f"bucket of {numel} elements", calls
        del x, flat, fused_in, dec_in, comp_in, rs_dec, ag_dec, incoming, calls


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="an unpacked tree of the commit to compare with")
    ap.add_argument("--kernels", default=",".join(FAMILIES),
                    help=f"comma-separated kernel families to time, of {', '.join(FAMILIES)}")
    ap.add_argument("--variant", action="append", default=[],
                    help="[source:]nvcc flags (space-separated) for one more build of this tree's "
                         "source (collective_matmul where none is named)")
    ap.add_argument("--ring-block", type=int, default=cs.BLOCK,
                    help="elements of a block of the quantized ring's codec and hop cases")
    args = ap.parse_args(argv)
    families = args.kernels.split(",")
    if not set(families) <= set(FAMILIES):
        ap.error(f"--kernels takes {', '.join(FAMILIES)}, got {args.kernels}")
    sources = [name for f in families for name in FAMILIES[f]]
    smi = cs.phase_device()
    device = torch.device("cuda", 0)

    _build.build(sources)
    jobs = {}
    for name in sources:
        src = os.path.join(args.parent, "bagua_tpu_torch", "kernels", "csrc", f"{name}.cu")
        out = os.path.join(args.parent, "ab_build", f"lib{name}.so")
        jobs[("parent", name)] = (out, build(src, out))
    for i, variant in enumerate(args.variant):
        name, flag = variant.split(":", 1) if ":" in variant else ("collective_matmul", variant)
        if name not in sources:
            ap.error(f"--variant {variant!r}: {name} is not among the sources timed")
        out = os.path.join(args.parent, "ab_build", f"lib{name}-variant{i}.so")
        jobs[(flag, name)] = (out, build(os.path.join(_build.CSRC_DIR, f"{name}.cu"), out, flag.split()))
    libs = {name: {"tree": SOURCES[name]._lib()} for name in sources}
    for name in sources:
        with open(f"{_build.library_path(name)}.log") as f:
            cs.log(f"[build] tree {name}.cu: {ptxas(f.read())}")
    for (who, name), (out, proc) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {who} {name}.cu:\n{text}")
        cs.log(f"[build] {who} {name}.cu: {ptxas(text)}")
        libs[name][who] = typed(SOURCES[name], out)

    sums, largest, worst = {}, {}, {}

    def record(kernel, case, per_step, times, size=0):
        row = sums.setdefault(kernel, {})
        for who, ms in times.items():
            row[who] = row.get(who, 0.0) + per_step * min(ms)
        if size >= largest.get(kernel, (-1, None))[0]:
            largest[kernel] = (size, {who: min(ms) for who, ms in times.items()})
        ratio = min(times["tree"]) / min(times["parent"])
        worst[kernel] = max(worst.get(kernel, 0.0), ratio)
        cs.log(f"[ab] {kernel} {case}, {per_step} a step: " + ", ".join(
            f"{who} {' / '.join(f'{t:.4f}' for t in ms)} ms" for who, ms in times.items()) +
            f"; tree / parent {ratio:.4f}")

    if "codec" in families:
        for case, calls in codec_cases(device, args.ring_block):
            for kernel, sum_name, per_step, source, call_args in calls:
                wrapper, plain = cs.KERNELS[kernel][:2]
                want = plain(*call_args)
                want = want if isinstance(want, tuple) else (want,)

                def check_codec(who, got):
                    got = got if isinstance(got, tuple) else (got,)
                    if not all(cs.same(g, w) for g, w in zip(got, want)):
                        raise AssertionError(f"{who} {kernel} on {case}: not bitwise its plain version")

                record(sum_name, case, per_step,
                       turns(libs[source], SOURCES[source], lambda: wrapper(*call_args), check_codec),
                       size=call_args[0].numel())
                del want
    with cs._no_tf32():
        for case, per_step, x, w in ([] if "gemm" not in families else gemm_cases(device)):
            want = cm.matmul_tile_plain(x, w)

            def check_gemm(who, got):
                share = cs.matmul_share(got, want, x, w)
                if share > 1.0:
                    raise AssertionError(f"{who} matmul_tile on {case}: {share:.3f} of the bound")
                cs.log(f"[ab] {who} matmul_tile on {case}: {share:.2e} of the bound, "
                       f"bitwise torch.matmul: {cs.same(got, want)}")

            record("matmul_tile", case, per_step,
                   turns(libs["collective_matmul"], cm, lambda: cm.matmul_tile(x, w), check_gemm),
                   size=x.numel() * w.shape[-1])
            del x, w, want
        for kv_dtype, suffix in ((torch.float32, ""), (torch.bfloat16, " (bf16 K/V)")) \
                if "attention" in families else ():
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
                           turns(libs["flash_attention"], fa, lambda: kernel(*call_args), check),
                           size=int(call_args[3].sum()))
                    del want
    cs.log(smi)
    print(json.dumps({"per_step_ms": sums, "largest_shape_ms": {k: v[1] for k, v in largest.items()},
                      "worst_tree_over_parent": worst,
                      "note": "sums over a step of the faster of each version's timings at each "
                              "shape; the largest shape is VGG16's Dense_0 bucket for the codecs"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
