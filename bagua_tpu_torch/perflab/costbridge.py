"""Price a CollectiveIR through the planner's fitted α–β cost model.

The port of ``bagua_tpu/perflab/costbridge.py``, a copy over the port's
captured IR and planner.

This is the provenance hinge of the modeled bench: the *bytes* come from
the static verifier's captured CollectiveIR (per-descriptor ring-model wire bytes,
proved equal to the planner's analytic models by ``check_wire_exactness``),
and the *seconds* come from the planner's per-leg
:class:`~bagua_tpu_torch.service.planner.CostModel` (fitted from recorded
:class:`~bagua_tpu_torch.service.planner.WireSample` spans, priors otherwise).
Each issued collective pays its leg's α once; the branch-deduped wire bytes
pay β.  :func:`census_wire_bytes` and :func:`price_program` walk the same
grouping and the same cond-sibling dedup (the verifier's: only one branch
executes, so siblings contribute their max), so summed modeled bytes equal
the census bytes *by construction*.

Leg mapping (the planner's :class:`WireSample` vocabulary):

* quantized-ring hops (``qr`` scope) → ``qr8`` / ``qr4``
* ``reduce_scatter`` → ``rs``; ``all_gather`` → ``ag`` (zero's two legs)
* bare ``ppermute`` → ``pp`` (collective-matmul / decentralized rings)
* ``psum``/``pmax``/``pmin``/``all_to_all`` → ``flat`` (or ``intra`` /
  ``inter`` when the descriptor spans exactly that hierarchical axis)
"""

import dataclasses
from typing import Dict, List, Optional, Tuple

from bagua_tpu_torch.analysis.checks import WireModelConfig, _branch_deduped_bytes
from bagua_tpu_torch.analysis.collective_ir import (
    CollectiveDescriptor,
    CollectiveProgram,
)
from bagua_tpu_torch.service.planner import CostModel

__all__ = [
    "LEG_FOR_PRIMITIVE",
    "PricedProgram",
    "census_wire_bytes",
    "classify_leg",
    "price_program",
]

#: primitive → default α–β leg (before qr/hierarchy refinement)
LEG_FOR_PRIMITIVE = {
    "psum": "flat",
    "pmax": "flat",
    "pmin": "flat",
    "all_to_all": "flat",
    "reduce_scatter": "rs",
    "all_gather": "ag",
    "ppermute": "pp",
}


def classify_leg(d: CollectiveDescriptor, cfg: Optional[WireModelConfig]) -> str:
    """The cost-model leg one descriptor's bytes travel on."""
    if d.qr is not None:
        return "qr8" if d.qr["bits"] == 8 else "qr4"
    leg = LEG_FOR_PRIMITIVE[d.primitive]
    if (
        leg == "flat"
        and cfg is not None
        and cfg.hierarchical
        and len(d.axes) == 1
        and d.axes[0] in ("intra", "inter")
    ):
        return d.axes[0]
    if (
        leg == "flat"
        and cfg is not None
        and len(d.axes) == 1
        and d.axes[0] in getattr(cfg, "mesh_axes", ())
    ):
        # Named-mesh engines: a single-axis collective rides that axis's
        # link (dp ring on DCN, tp ring on ICI, ...); price it on the
        # per-axis fitted leg (CostModel.axis_leg falls back to flat).
        return f"axis:{d.axes[0]}"
    return leg


def _cond_path(d: CollectiveDescriptor) -> Tuple[str, ...]:
    return tuple(p for p in d.path if p.startswith("cond#"))


def _grouped(
    program: CollectiveProgram, cfg: Optional[WireModelConfig]
) -> Dict[Tuple, List[CollectiveDescriptor]]:
    """Shared grouping for census and pricing: ``(algo, bucket, phase,
    leg)`` for labeled descriptors (the verifier's wire-census groups,
    refined by leg), ``(None, None, primitive, leg)`` for unlabeled ones."""
    groups: Dict[Tuple, List[CollectiveDescriptor]] = {}
    for d in program.collectives:
        leg = classify_leg(d, cfg)
        if d.scope is not None:
            key = (d.scope["algo"], d.scope["bucket"], d.scope["phase"], leg)
        else:
            key = (None, None, d.primitive, leg)
        groups.setdefault(key, []).append(d)
    return groups


def _deduped(descs: List[CollectiveDescriptor], value_fn) -> int:
    return _branch_deduped_bytes([(_cond_path(d), value_fn(d)) for d in descs])


def census_wire_bytes(
    program: CollectiveProgram, cfg: Optional[WireModelConfig] = None
) -> int:
    """Branch-deduped per-chip wire bytes of one traced step, summed over
    the same groups :func:`price_program` charges — the modeled-bytes ==
    census-bytes equality is definitional, and within each labeled group
    the dedup is exactly the verifier's wire-table dedup."""
    return sum(
        _deduped(descs, lambda d: d.wire_bytes)
        for descs in _grouped(program, cfg).values()
    )


@dataclasses.dataclass
class PricedProgram:
    """One step program priced leg by leg."""

    rows: List[Dict]          #: per (scope, leg) group: bytes, count, seconds
    total_wire_bytes: int     #: branch-deduped; == :func:`census_wire_bytes`
    total_wire_s: float
    legs_used: List[str]

    def by_leg(self) -> Dict[str, Dict]:
        out: Dict[str, Dict] = {}
        for r in self.rows:
            agg = out.setdefault(
                r["leg"], {"wire_bytes": 0, "collectives": 0, "seconds": 0.0}
            )
            agg["wire_bytes"] += r["wire_bytes"]
            agg["collectives"] += r["collectives"]
            agg["seconds"] += r["seconds"]
        return out


def price_program(
    program: CollectiveProgram,
    cost_model: CostModel,
    cfg: Optional[WireModelConfig] = None,
) -> PricedProgram:
    """Charge every collective of one traced step to its α–β leg.

    Within a group the cond-sibling dedup runs over bytes *and* issue
    counts, then ``seconds = count·α + bytes/β``.
    """
    legs = {
        "flat": cost_model.flat, "intra": cost_model.intra,
        "inter": cost_model.inter, "rs": cost_model.rs, "ag": cost_model.ag,
        "pp": cost_model.pp, "qr8": cost_model.qr8, "qr4": cost_model.qr4,
    }
    rows: List[Dict] = []
    total_bytes = 0
    total_s = 0.0
    for (algo, bucket, phase, leg), descs in _grouped(program, cfg).items():
        nbytes = _deduped(descs, lambda d: d.wire_bytes)
        count = _deduped(descs, lambda d: 1)
        if leg.startswith("axis:"):
            ab = cost_model.axis_leg(leg[len("axis:"):])
        else:
            ab = legs[leg]
        seconds = count * ab.alpha + nbytes / ab.beta
        rows.append({
            "algo": algo, "bucket": bucket, "phase": phase, "leg": leg,
            "collectives": count, "wire_bytes": nbytes,
            "seconds": seconds,
        })
        total_bytes += nbytes
        total_s += seconds
    return PricedProgram(
        rows=rows,
        total_wire_bytes=total_bytes,
        total_wire_s=total_s,
        legs_used=sorted({r["leg"] for r in rows}),
    )
