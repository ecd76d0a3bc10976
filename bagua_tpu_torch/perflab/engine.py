"""Modeled step-time engine: one dry run → census bytes → α–β legs → ms.

The port of ``bagua_tpu/perflab/engine.py``.  :func:`model_step_cell` runs
a live engine's step dry on the ``meta`` device (the static verifier's
:func:`~bagua_tpu_torch.analysis.verify.dry_run`: nothing dispatches, nothing
is allocated), runs the four checkers over the captured CollectiveIR,
prices the IR's wire bytes through the planner's per-leg cost model
(:mod:`~bagua_tpu_torch.perflab.costbridge`), counts one rank's matmul and
convolution FLOPs (:mod:`~bagua_tpu_torch.perflab.compute`) and composes
the two spans under the explicit overlap-window assumption of
:class:`~bagua_tpu_torch.perflab.topology.TopologyAssumptions`:

    ``exposed = max(0, wire − window·compute)``   (overlap on)
    ``exposed = wire``                            (overlap off)
    ``modeled_step = compute + exposed``

Every number in the chain is either *proved* (bytes:
``check_wire_exactness`` holds them equal to the planner's analytic
models), *fitted* (α–β legs from recorded spans, priors when a leg has
none) or *stated* (MFU, overlap window, the card's peak).

:func:`kernel_basis` names the hand-written kernels a cell's wire program
runs: ``cuda`` on a card's group (the kernels launch), ``plain`` on a CPU
group (their plain versions), ``none`` where the wire runs none.

:func:`modeled_bench_rows` reads the committed ``MODELED_BENCH_TORCH.json``
(``python -m bagua_tpu_torch.tools.bench_modeled``) into rows a bench
harness can print, each marked modeled and carrying the model's measured
miss against the card.
"""

import dataclasses
import json
import os
from typing import Dict, List, Optional

from bagua_tpu_torch.analysis.checks import WireModelConfig
from bagua_tpu_torch.analysis.verify import dry_run, verify_collective_program
from bagua_tpu_torch.perflab.compute import compute_time_s, step_flops_census
from bagua_tpu_torch.perflab.costbridge import census_wire_bytes, price_program
from bagua_tpu_torch.perflab.topology import DEFAULT_TOPOLOGY, TopologyAssumptions
from bagua_tpu_torch.service.planner import CostModel
from bagua_tpu_torch.utils import tree_leaves

__all__ = [
    "ModeledCell",
    "kernel_basis",
    "model_step_cell",
    "modeled_bench_rows",
]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclasses.dataclass
class ModeledCell:
    """One algorithm × wire × overlap configuration, modeled."""

    algo: str
    wire: str
    overlap: bool
    verified: bool                  #: the four checkers passed on this dry run
    modeled_step_ms: float
    modeled_samples_per_s: float    #: global batch / modeled step
    modeled_goodput_frac: float     #: compute span / modeled step
    modeled_mfu: float              #: counted FLOPs / (modeled step · peak)
    compute_ms: float
    wire_ms: float
    exposed_wire_ms: float
    modeled_wire_bytes: int         #: priced bytes (== census, asserted)
    census_wire_bytes: int          #: branch-deduped IR bytes
    flops_per_step: float
    num_collectives: int
    legs_used: List[str]
    leg_breakdown: Dict[str, Dict]
    kernel_basis: Dict
    findings: List[str]
    #: the engine's mesh shape (``{"inter": 2, "intra": 4}`` or
    #: ``{"dp": 4, "tp": 2}``)
    mesh: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: axes the cell's gradient exchange rode (provenance for per-axis legs)
    exchange_axes: List[str] = dataclasses.field(default_factory=list)

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        for k in ("modeled_step_ms", "compute_ms", "wire_ms", "exposed_wire_ms"):
            d[k] = round(d[k], 6)
        d["modeled_samples_per_s"] = round(d["modeled_samples_per_s"], 3)
        d["modeled_goodput_frac"] = round(d["modeled_goodput_frac"], 6)
        d["modeled_mfu"] = round(d["modeled_mfu"], 6)
        for leg in d["leg_breakdown"].values():
            leg["seconds"] = round(leg["seconds"], 9)
        return d


def kernel_basis(algo: str, wire: str, device_type: str) -> Dict:
    """The hand-written kernels the cell's wire program runs, and what runs
    them: ``cuda`` on a card (``device_type == "cuda"``), ``plain`` (their
    plain versions) elsewhere, ``none`` when the wire runs no kernel."""
    kernels: List[str] = []
    if wire == "int8":
        kernels = ["compress_minmax_uint8", "decompress_minmax_uint8", "hop_dequant_add_requant(bits=8)"]
    elif wire == "int4":
        kernels = ["compress_minmax_uint4", "decompress_minmax_uint4", "hop_dequant_add_requant(bits=4)"]
    elif algo == "bytegrad" or (algo == "zero" and wire == "bytegrad"):
        kernels = ["compress_minmax_uint8", "decompress_minmax_uint8"]
        if algo == "bytegrad":
            kernels.append("decompress_reduce_requantize")
    if not kernels:
        return {"basis": "none", "kernels": []}
    return {"basis": "cuda" if device_type == "cuda" else "plain", "kernels": kernels}


def model_step_cell(
    ddp,
    state,
    batch,
    cost_model: CostModel,
    topology: TopologyAssumptions = DEFAULT_TOPOLOGY,
    chip: str = "h100-sxm-f32",
    mfu: float = 0.3,
    wire: str = "f32",
) -> ModeledCell:
    """Model one live engine's step from a single dry run on ``meta``.
    ``wire`` names the cell's wire (``f32``, ``int8``, ``int4``,
    ``bytegrad``); the caller owns the engine."""
    from bagua_tpu_torch.observability.goodput import PEAK_FLOPS_PER_CHIP

    variant = ddp.impl.step_variant(state.step)
    cfg = WireModelConfig.from_engine(ddp)
    program, events = dry_run(ddp, state, batch)
    captured = list(ddp._flight_finalize(variant, events))
    report = verify_collective_program(program, cfg, captured=captured, variant=variant)

    priced = price_program(program, cost_model, cfg)
    census = census_wire_bytes(program, cfg)
    flops = step_flops_census(ddp, batch)
    compute_s = compute_time_s(flops["flops"], chip=chip, mfu=mfu)
    wire_s = priced.total_wire_s
    if ddp.overlap_enabled:
        exposed_s = max(0.0, wire_s - topology.overlap_window_frac * compute_s)
    else:
        exposed_s = wire_s
    step_s = compute_s + exposed_s
    global_batch = int(tree_leaves(batch)[0].shape[0])
    return ModeledCell(
        algo=cfg.algo,
        wire=wire,
        overlap=bool(ddp.overlap_enabled),
        verified=report.ok,
        modeled_step_ms=step_s * 1e3,
        modeled_samples_per_s=global_batch / step_s,
        modeled_goodput_frac=compute_s / step_s,
        modeled_mfu=flops["flops"] / (step_s * PEAK_FLOPS_PER_CHIP[chip]),
        compute_ms=compute_s * 1e3,
        wire_ms=wire_s * 1e3,
        exposed_wire_ms=exposed_s * 1e3,
        modeled_wire_bytes=priced.total_wire_bytes,
        census_wire_bytes=census,
        flops_per_step=flops["flops"],
        num_collectives=len(program.collectives),
        legs_used=priced.legs_used,
        leg_breakdown=priced.by_leg(),
        kernel_basis=kernel_basis(cfg.algo, wire, ddp.group.device.type),
        findings=[str(f) for f in report.errors],
        mesh={k: int(v) for k, v in zip(ddp.group.all_axes, ddp.group.shape)},
        exchange_axes=list(cfg.exchange_axes),
    )


def modeled_bench_rows(metric: str, artifact_path: Optional[str] = None) -> List[Dict]:
    """A bench harness's modeled rows, read from the committed
    ``MODELED_BENCH_TORCH.json`` (JSON only: no engine, no card).

    Returns ``{"mode": "modeled", ...}`` rows for ``metric``
    (``vgg16_img_per_sec_per_chip``, ``vgg16_dp_scaling_efficiency``);
    empty when the artifact is missing or has no projection.  Each row
    names the artifact, the command that made it and the model's measured
    miss against the card, so a modeled number never passes for a
    measurement."""
    path = artifact_path or os.path.join(_REPO, "MODELED_BENCH_TORCH.json")
    try:
        with open(path) as f:
            art = json.load(f)
    except (OSError, ValueError):
        return []
    prov = {
        "mode": "modeled",
        "provenance": "perflab: census-proved wire bytes x the planner's prior alpha-beta legs",
        "artifact": os.path.basename(path),
        "generated_by": art.get("generated_by", "bagua_tpu_torch/tools/bench_modeled.py"),
        "measured_miss": art.get("measured_miss"),
    }
    proj = art.get("vgg16_projection") or {}
    rows: List[Dict] = []
    if metric == "vgg16_img_per_sec_per_chip" and proj:
        rows.append({"metric": metric, "value": proj.get("modeled_img_per_s_per_card", 0.0),
                     "unit": "img/s/card", "model": "vgg16", "algo": "gradient_allreduce", **prov})
    elif metric == "vgg16_dp_scaling_efficiency" and proj:
        rows.append({"metric": metric, "value": proj.get("modeled_scaling_efficiency_8", 0.0),
                     "unit": "ratio", "model": "vgg16", "n_cards": 8, **prov})
    # the MLP sweep's trend rides along: its ranking across algorithms and
    # wires is the falsifiable content
    trend = [
        {"algo": r["algo"], "wire": r["wire"], "overlap": r["overlap"],
         "modeled_step_ms": r["modeled_step_ms"], "modeled_wire_bytes": r["modeled_wire_bytes"]}
        for r in art.get("rows", []) if r.get("status") == "pass"
    ]
    if rows and trend:
        rows[0]["trend"] = trend
    return rows
