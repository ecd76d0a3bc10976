"""Modeled step-time and goodput sweep (committed as
``MODELED_BENCH_TORCH.json``).

The port of the JAX package's ``ci/bench_modeled.py``.  Every number here is
a model, not a measurement: for each registered algorithm x wire precision
{f32, int8, int4} x overlap {off, on} on the lane's group, the perf lab
(:mod:`bagua_tpu_torch.perflab`) runs the engine's step dry on the ``meta``
device (nothing dispatches), prices the collective IR's exact per-leg wire
bytes through the planner's alpha-beta legs, counts one rank's matmul
FLOPs for the compute span, and composes them under the stated
overlap-window assumption into ``modeled_step_ms`` / ``modeled_goodput``.

The legs are the planner's priors (``CostModel()``, as ``chip_smoke.py``'s
``[verify]`` phase prices its cells): no spans are fitted, since the only
recorded spans in the repo are a TPU trace.  The link model and the peak are
the H100's (:mod:`bagua_tpu_torch.perflab.topology`,
``observability.goodput.PEAK_FLOPS_PER_CHIP``).  The artifact states the
model's measured miss against the card beside its rows (``MEASURED_MISS``).

Hard per-row invariant: the priced wire bytes equal the IR census bytes
exactly, and every cell the static verifier passes prices to a nonzero step.

Cell statuses are ``tools/static_verify.py``'s: ``pass``/``fail``,
``skipped`` (no ``wire_precision`` knob), ``fenced`` (the engine refuses
the combination at construction).

``--check`` models the sweep again and gates it against the committed
artifact: any status flip, any wire-byte drift (exact), or a
``modeled_step_ms`` drift beyond 2% fails.  ``--quick`` restricts the sweep
to the modeled algorithms (``gradient_allreduce``, ``zero``)::

    python -m bagua_tpu_torch.tools.bench_modeled --device cpu
    python -m bagua_tpu_torch.tools.bench_modeled --device cpu --quick --check
"""

import argparse
import os
import sys

from bagua_tpu_torch.tools._lane import REPO, add_device_args, command_line, device_record, lane_group, \
    mesh_of, write_json
from bagua_tpu_torch.tools.static_verify import BUCKET_BYTES, INTRA_SIZE, LAYERS, WIRE_KNOB_ALGOS, WIRES, \
    build_ddp, init_params, make_batch

#: the named-mesh cells: the modeled algorithms again on 2-D meshes, keyed
#: by mesh shape
MESH_SPECS = ({"dp": 4, "tp": 2}, {"dp": 4, "fsdp": 2})
MESH_WIRES = ("f32", "int8")
#: the MLP's compute is f32 on the card (TF32 off)
CHIP = "h100-sxm-f32"
#: VGG16 trains in bf16 on the card (the synthetic benchmark's dtype)
VGG16_CHIP = "h100-sxm-bf16"
MFU_ASSUMED = 0.3
#: --check tolerance on modeled_step_ms (bytes and statuses are exact)
STEP_MS_RTOL = 0.02
#: the model against the card: ``chip_smoke.py``'s ``[verify]`` phase prices
#: the full-width VGG16 step (bf16, 4 ranks on one card, ``intra_size=1``,
#: batch 32 a rank, the engine's own buckets) with this cost model at MFU
#: 0.3 of the f32 and of the bf16 peak, and measures the same step with the
#: gate strict (the mean of 10 steps through ``Trainer.fit``); the ratios
#: are modeled over measured, from that phase's lines on 2026-10-19
MEASURED_MISS = {
    "source": "chip_smoke.py [verify]: modeled (planner priors) against measured VGG16 ms/step",
    "card": "NVIDIA H100 80GB HBM3, 700.00 W",
    "ranks": 4,
    "paths": {
        "f32": {"modeled_ms_f32": 147.5, "modeled_ms_bf16": 24.784, "measured_ms": 62.05,
                  "modeled_over_measured_f32": 2.377, "modeled_over_measured_bf16": 0.399},
        "ByteGrad": {"modeled_ms_f32": 147.5, "modeled_ms_bf16": 10.022, "measured_ms": 63.39,
                  "modeled_over_measured_f32": 2.327, "modeled_over_measured_bf16": 0.158},
        "int8 ring": {"modeled_ms_f32": 147.5, "modeled_ms_bf16": 9.992, "measured_ms": 79.13,
                  "modeled_over_measured_f32": 1.864, "modeled_over_measured_bf16": 0.126},
        "ZeRO int8": {"modeled_ms_f32": 147.5, "modeled_ms_bf16": 11.635, "measured_ms": 69.04,
                  "modeled_over_measured_f32": 2.136, "modeled_over_measured_bf16": 0.169},
    },
    "summary": "the modeled step is 1.86-2.38x the measured one at the f32 peak and "
               "0.13-0.40x at the bf16 peak: the compute span at an assumed MFU decides it",
}


def mesh_key(shape) -> str:
    """The row key of one mesh shape: ``inter2xintra4``, ``dp4xtp2``."""
    return "x".join(f"{k}{int(v)}" for k, v in shape.items())


def sweep_cell(group, params, batch, cost_model, name, wire, overlap):
    from bagua_tpu_torch.perflab import DEFAULT_TOPOLOGY, model_step_cell

    row = {"algo": name, "wire": wire, "overlap": overlap, "mesh_key": mesh_key(mesh_of(group))}
    if wire != "f32" and name not in WIRE_KNOB_ALGOS:
        row["status"] = "skipped"
        row["reason"] = "algorithm has no wire_precision knob"
        return row
    try:
        ddp = build_ddp(group, name, wire, overlap)
    except ValueError as e:
        row["status"] = "fenced"
        row["reason"] = str(e)
        return row
    try:
        state = ddp.init(params)
        cell = model_step_cell(ddp, state, batch, cost_model, topology=DEFAULT_TOPOLOGY, chip=CHIP,
                               mfu=MFU_ASSUMED, wire=wire)
    finally:
        ddp.shutdown()
    cell_json = cell.to_json()
    # the row's key stays the registry name; the engine's scope label is
    # provenance
    cell_json["engine_algo"] = cell_json.pop("algo")
    row.update(cell_json)
    row["status"] = "pass" if cell.verified else "fail"
    # a modeled number is admissible only where its bytes are the census's
    if cell.modeled_wire_bytes != cell.census_wire_bytes:
        row["status"] = "fail"
        row.setdefault("findings", []).append(
            f"priced bytes {cell.modeled_wire_bytes} != census {cell.census_wire_bytes}")
    if row["status"] == "pass" and not row["modeled_step_ms"] > 0:
        row["status"] = "fail"
        row.setdefault("findings", []).append("modeled_step_ms is zero")
    return row


def vgg16_grad_bytes() -> int:
    """VGG16's f32 gradient bytes at 224 x 224 and 1000 classes, from the
    port's model built on ``meta``."""
    from bagua_tpu_torch.models.vgg import module_params, vgg16
    from bagua_tpu_torch.utils import tree_leaves

    return sum(t.numel() * 4 for t in tree_leaves(module_params(vgg16(device="meta"))))


def vgg16_projection(local_batch: int = 32, n_cards: int = 8) -> dict:
    """The benchmark's headline metrics, modeled: VGG16 data-parallel img/s
    a card and 1 -> 8 weak-scaling efficiency, from the model's parameter
    census, the analytic FLOPs model, the bf16 peak at the assumed MFU and
    the H100 link model."""
    from bagua_tpu_torch.observability.goodput import PEAK_FLOPS_PER_CHIP, model_flops_per_sample
    from bagua_tpu_torch.perflab import DEFAULT_TOPOLOGY, t_collective

    topo = DEFAULT_TOPOLOGY
    grad_bytes = vgg16_grad_bytes()
    flops_per_step = model_flops_per_sample("vgg16") * local_batch
    compute_s = flops_per_step / (PEAK_FLOPS_PER_CHIP[VGG16_CHIP] * MFU_ASSUMED)
    wire_s = t_collective("allreduce", grad_bytes, n_cards, topo)
    exposed_s = max(0.0, wire_s - topo.overlap_window_frac * compute_s)
    t_n = compute_s + exposed_s
    return {
        "model": "vgg16",
        "algo": "gradient_allreduce",
        "chip": VGG16_CHIP,
        "local_batch": local_batch,
        "n_cards": n_cards,
        "grad_bytes": grad_bytes,
        "flops_per_step_per_card": flops_per_step,
        "compute_ms": round(compute_s * 1e3, 6),
        "wire_ms": round(wire_s * 1e3, 6),
        "exposed_wire_ms": round(exposed_s * 1e3, 6),
        "modeled_step_ms": round(t_n * 1e3, 6),
        "modeled_img_per_s_per_card": round(local_batch / t_n, 3),
        # weak scaling: one card has no wire term at all
        "modeled_scaling_efficiency_8": round(compute_s / t_n, 6),
        "modeled_scaling_efficiency_8_no_overlap": round(compute_s / (compute_s + wire_s), 6),
    }


def run_sweep(group, quick: bool = False, algo=None, log=None) -> dict:
    """The sweep on ``group`` (and on MESH_SPECS's meshes of its devices);
    returns the report."""
    from bagua_tpu_torch.algorithms import GlobalAlgorithmRegistry
    from bagua_tpu_torch.communication import BaguaProcessGroup
    from bagua_tpu_torch.mesh import MeshSpec
    from bagua_tpu_torch.observability.goodput import PEAK_FLOPS_PER_CHIP
    from bagua_tpu_torch.perflab import DEFAULT_TOPOLOGY
    from bagua_tpu_torch.service.planner import CostModel

    log = log or sys.stderr
    cost_model = CostModel()
    params = init_params(group.device)
    batch = make_batch(group.device)
    names = [n for n in GlobalAlgorithmRegistry.keys()
             if (not quick or n in WIRE_KNOB_ALGOS) and (algo is None or n == algo)]

    def sweep(g, wires, names, tag=""):
        rows = []
        for name in names:
            for wire in wires:
                for overlap in (False, True):
                    row = sweep_cell(g, params, batch, cost_model, name, wire, overlap)
                    rows.append(row)
                    extra = (f" {row['modeled_step_ms']:.3f} ms, {row['modeled_wire_bytes']} B wire"
                             if "modeled_step_ms" in row else "")
                    print(f"[bench-modeled] {name:28s} wire={wire:4s} overlap={int(overlap)}{tag} "
                          f"-> {row['status']}{extra}", file=log)
        return rows

    rows = sweep(group, WIRES, names)
    # the named-mesh cells: the same dry run -> census -> alpha-beta chain
    # on 2-D meshes, for the fully modeled algorithms only, each row keyed
    # by its mesh shape
    mesh_names = [n for n in names if n in WIRE_KNOB_ALGOS]
    for spec_axes in MESH_SPECS:
        mesh_group = BaguaProcessGroup(group.devices, mesh_spec=MeshSpec(spec_axes))
        rows += sweep(mesh_group, MESH_WIRES, mesh_names, f" mesh={mesh_key(spec_axes)}")
    summary = {s: sum(1 for r in rows if r["status"] == s) for s in ("pass", "fail", "skipped", "fenced")}
    return {
        "schema": 1,
        "generated_by": "bagua_tpu_torch/tools/bench_modeled.py",
        "command": command_line(),
        "device": device_record(group),
        "mode": "modeled: no number here was measured",
        "mesh": mesh_of(group),
        "meshes": [mesh_of(group)] + [dict(s) for s in MESH_SPECS],
        "model": {"layers": LAYERS, "bucket_size_bytes": BUCKET_BYTES},
        "assumptions": {
            "chip": CHIP,
            "peak_flops_per_chip": PEAK_FLOPS_PER_CHIP[CHIP],
            "mfu": MFU_ASSUMED,
            "topology": DEFAULT_TOPOLOGY.describe(),
            "cost_model": cost_model.describe(),
            "cost_model_source": "the planner's priors (CostModel(); no spans fitted)",
            "provenance": {
                "wire_bytes": "proved: CollectiveIR census == the planner's analytic models "
                              "(check_wire_exactness)",
                "alpha_beta": "stated: the planner's prior legs",
                "compute": "stated: counted matmul FLOPs at the assumed MFU of the card's peak",
                "overlap": "stated: overlap_window_frac of the compute span can hide wire time",
            },
        },
        "measured_miss": MEASURED_MISS,
        "summary": summary,
        "rows": rows,
        "vgg16_projection": vgg16_projection(),
    }


def row_key(r):
    return (r.get("mesh_key", "inter2xintra4"), r["algo"], r["wire"], r["overlap"])


def check_against(report, committed_path):
    """The regression gate: the fresh model against the committed artifact."""
    import json

    try:
        with open(committed_path) as f:
            committed = json.load(f)
    except OSError as e:
        return [f"committed artifact unreadable: {e}"]
    old = {row_key(r): r for r in committed.get("rows", [])}
    problems = []
    for r in report["rows"]:
        key = row_key(r)
        ref = old.get(key)
        if ref is None:
            continue  # a new cell is additive, not a regression
        if r["status"] != ref["status"]:
            problems.append(f"{key}: status {ref['status']} -> {r['status']}")
            continue
        if r["status"] != "pass":
            continue
        if r["modeled_wire_bytes"] != ref["modeled_wire_bytes"]:
            problems.append(f"{key}: wire bytes {ref['modeled_wire_bytes']} -> {r['modeled_wire_bytes']} "
                            "(must be exact)")
        ref_ms = ref["modeled_step_ms"]
        if abs(r["modeled_step_ms"] - ref_ms) > STEP_MS_RTOL * ref_ms:
            problems.append(f"{key}: modeled_step_ms {ref_ms} -> {r['modeled_step_ms']} "
                            f"(> {STEP_MS_RTOL:.0%} drift)")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "MODELED_BENCH_TORCH.json"),
                    help="where to write the modeled sweep (default: the repo's root)")
    ap.add_argument("--check", action="store_true",
                    help="gate against the committed artifact instead of rewriting it")
    ap.add_argument("--quick", action="store_true",
                    help="restrict to the modeled algorithms (gradient_allreduce, zero)")
    ap.add_argument("--algo", default=None, help="restrict the sweep to one algorithm")
    add_device_args(ap)
    args = ap.parse_args(argv)

    group = lane_group(args.device, args.ranks, args.intra_size, cpu_intra_size=INTRA_SIZE)
    # the artifact must not depend on who launches the lane: the ring's
    # block size changes its padding and sidecar bytes
    os.environ["BAGUA_QR_BLOCK"] = "4096"
    report = run_sweep(group, quick=args.quick, algo=args.algo)
    summary = report["summary"]
    if args.check:
        problems = check_against(report, args.out)
        for p in problems:
            print(f"[bench-modeled] REGRESSION: {p}", file=sys.stderr)
        if summary["fail"] or problems:
            print(f"[bench-modeled] check failed: {summary['fail']} cell failure(s), {len(problems)} "
                  "regression(s)", file=sys.stderr)
            return 1
        print(f"[bench-modeled] check passed vs {args.out}: {summary}", file=sys.stderr)
        return 0
    write_json(args.out, report)
    print(f"[bench-modeled] wrote {args.out}: {summary}", file=sys.stderr)
    if summary["fail"]:
        print(f"[bench-modeled] {summary['fail']} failure(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
