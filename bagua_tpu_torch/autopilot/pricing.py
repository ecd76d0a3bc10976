"""Configuration pricing: the autopilot's candidate set and its α–β costs.

The port of ``bagua_tpu/autopilot/pricing.py``, a copy.

A *configuration* here is the joint relaxation choice BAGUA treats as
composable — {algorithm, wire precision} — priced against the planner's
fitted :class:`~bagua_tpu_torch.service.planner.CostModel` on the live bucket
plan's payload sizes.  The model is the same one the bucket planner
minimizes, so "cheapest" means the same thing to both controllers:

* ``gradient_allreduce`` / ``f32`` — one flat (or hierarchical) allreduce
  per bucket, priced on the ``flat`` (``intra``+``inter``) legs.
* ``gradient_allreduce`` / ``int8|int4`` — the blockwise-quantized ring,
  ``2(n-1)`` hops of compressed shards on the ``qr8``/``qr4`` legs.
* ``zero`` / ``f32`` — reduce-scatter (``rs`` leg) plus the deferred
  parameter all-gather (``ag`` leg; it rides the next step's forward, but
  a whole-step cost ranking must still pay for it).
* ``zero`` / ``int8|int4`` — the quantized ring's reduce-scatter half plus
  a full-precision all-gather.
* ``bytegrad`` — fixed int8 compression, priced like the quantized ring.

Bucket sizes are taken from the CURRENT plan — candidate algorithms would
re-bucket slightly differently, but the payload total (the β term that
dominates under a bandwidth collapse) is identical, and only the *ranking*
of candidates feeds decisions.

``bandwidth_factor`` models the collapse itself: it divides every fitted
leg's β (bytes/second) while leaving α (launch latency) untouched — that is
what a congested link physically does, and it is what lets the ranking
*flip*.  At nominal bandwidth a small-payload gang is α-dominated and the
quantized ring's ``2(n-1)`` sequential hops price above one flat allreduce
(so re-promotion is the cheapest move); under a collapse the β term
dominates and the compressed wire wins.  The autopilot derives the factor
from the incident's measured/expected ratio, turning the sentinel's attribution
verdict into the operating point the candidates are priced at.  Cost
models without α–β legs (test fakes) fall back to scaling the whole wire
term.
"""

import copy
import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Configuration",
    "candidate_configurations",
    "degraded_cost_model",
    "wire_ms",
    "modeled_step_ms",
    "price_configurations",
]

#: the fitted α–β legs a bandwidth collapse degrades
_COST_MODEL_LEGS = ("flat", "intra", "inter", "rs", "ag", "pp", "qr8", "qr4")

#: precision rungs a quantized-wire configuration can sit on, cheap → safe
PRECISION_RUNGS = ("int4", "int8", "f32")


@dataclasses.dataclass(frozen=True)
class Configuration:
    """One point in the relaxation space the autopilot moves the gang over.

    ``staleness`` is the bounded-staleness budget τ (0 = bulk synchronous).
    It only exists as a knob on the algorithms that implement it
    (``stale``'s error-feedback replay, the gossip decentralized mode);
    ``as_dict``/``label`` omit it at 0 so existing consumers of the
    two-field shape are unchanged."""

    algorithm: str = "gradient_allreduce"
    precision: str = "f32"
    staleness: int = 0

    def as_dict(self) -> Dict:
        d: Dict = {"algorithm": self.algorithm, "precision": self.precision}
        if self.staleness:
            d["staleness"] = int(self.staleness)
        return d

    def label(self) -> str:
        base = f"{self.algorithm}/{self.precision}"
        return f"{base}/tau={self.staleness}" if self.staleness else base


def candidate_configurations(
    algorithms: Sequence[str] = ("gradient_allreduce", "zero"),
    precisions: Sequence[str] = ("f32", "int8"),
    staleness_taus: Sequence[int] = (0,),
) -> List[Configuration]:
    """The cross product, minus combinations that don't exist as knobs
    (``bytegrad`` compresses unconditionally — its precision is pinned;
    nonzero ``staleness`` only composes with the algorithms that carry the
    ``set_staleness_tau`` knob: ``stale`` and the gossip ``decentralized``
    mode — and those exchange at f32 only)."""
    out = []
    for algo, prec, tau in itertools.product(algorithms, precisions, staleness_taus):
        if algo == "bytegrad":
            prec = "int8"
        if tau and algo not in ("stale", "decentralized"):
            continue
        if algo in ("stale", "decentralized"):
            prec = "f32"  # bounded-staleness exchanges are f32-only
        cfg = Configuration(algorithm=algo, precision=prec, staleness=int(tau))
        if cfg not in out:
            out.append(cfg)
    return out


def degraded_cost_model(cost_model, bandwidth_factor: float = 1.0,
                        axis: Optional[str] = None,
                        exchange_axes: Sequence[str] = ()):
    """``cost_model`` at ``bandwidth_factor`` times nominal wire cost: every
    recognizable α–β leg keeps its α and has its β divided by the factor.
    Returns the model unchanged at factor 1.0 or when no leg could be
    scaled (the caller falls back to scaling the whole term — unless the
    degradation was axis-scoped, see below).

    ``axis`` scopes the collapse to one named mesh axis — the incident's
    indicted axis.  When that axis is one of ``exchange_axes`` (the axes
    the gradient exchange actually rides, ``group.data_axes``), the
    exchange legs degrade exactly as in the uniform case — the relaxation
    knobs *can* relieve the congested traffic, so the candidate ranking
    may flip.  When the indicted axis is NOT an exchange axis (a tp/NVLink
    brownout under a dp-exchange gang), only that axis's ``axis_legs``
    entry degrades: the exchange pricing is untouched at any factor, the
    ranking cannot flip, and the controller correctly holds — demoting the
    dp wire precision does nothing for a tp collapse."""
    f = max(1e-6, float(bandwidth_factor))
    if abs(f - 1.0) < 1e-9:
        return cost_model
    axis_scoped = axis is not None
    degrade_exchange = (not axis_scoped) or axis in tuple(exchange_axes)
    degraded = copy.copy(cost_model)
    scaled = False
    if degrade_exchange:
        for leg in _COST_MODEL_LEGS:
            ab = getattr(cost_model, leg, None)
            if ab is not None and dataclasses.is_dataclass(ab) and hasattr(ab, "beta"):
                setattr(degraded, leg, dataclasses.replace(ab, beta=ab.beta / f))
                scaled = True
    axis_legs = getattr(cost_model, "axis_legs", None)
    if isinstance(axis_legs, dict):
        degraded.axis_legs = {}
        for ax, ab in axis_legs.items():
            hit = (ax == axis) if axis_scoped else True
            if hit and dataclasses.is_dataclass(ab) and hasattr(ab, "beta"):
                degraded.axis_legs[ax] = dataclasses.replace(ab, beta=ab.beta / f)
                scaled = True
            else:
                degraded.axis_legs[ax] = ab
    return degraded if scaled else cost_model


def wire_ms(
    cost_model,
    plan,
    n_ranks: int,
    config: Configuration,
    hierarchical: bool = False,
    bandwidth_factor: float = 1.0,
    axis: Optional[str] = None,
    exchange_axes: Sequence[str] = (),
) -> float:
    """Modeled per-step wire milliseconds of ``config`` on ``plan``'s
    buckets, at ``bandwidth_factor`` times nominal wire cost (β-degraded
    when the model exposes α–β legs, uniformly scaled otherwise).  With
    ``axis``, the degradation is scoped to the indicted axis's legs
    (see :func:`degraded_cost_model`) — a collapse on a non-exchange axis
    leaves the exchange pricing untouched, and the whole-term uniform
    fallback is suppressed (it would smear the collapse over traffic that
    never rides the indicted axis)."""
    degraded = degraded_cost_model(cost_model, bandwidth_factor,
                                   axis=axis, exchange_axes=exchange_axes)
    uniform = (degraded is cost_model and float(bandwidth_factor) != 1.0
               and axis is None)
    cost_model = degraded
    total = 0.0
    for spec in plan.specs:
        if config.algorithm == "zero":
            if config.precision in ("int8", "int4"):
                rs = cost_model.quantized_ring_wire_time(
                    spec.numel, n_ranks, config.precision
                ) / 2.0
            else:
                rs = cost_model.bucket_wire_time(spec.nbytes, wire_pattern="sharded")
            total += rs + cost_model.ag_time(spec.nbytes)
        elif config.algorithm == "bytegrad" or config.precision in ("int8", "int4"):
            prec = "int8" if config.algorithm == "bytegrad" else config.precision
            total += cost_model.quantized_ring_wire_time(spec.numel, n_ranks, prec)
        else:
            total += cost_model.bucket_wire_time(spec.nbytes, hierarchical=hierarchical)
    if uniform:
        total *= max(1e-6, float(bandwidth_factor))
    return total * 1e3


def modeled_step_ms(
    cost_model,
    plan,
    n_ranks: int,
    config: Configuration,
    compute_ms: float,
    hierarchical: bool = False,
    bandwidth_factor: float = 1.0,
    axis: Optional[str] = None,
    exchange_axes: Sequence[str] = (),
    straggler_excess_ms: float = 0.0,
) -> float:
    """``compute + wire`` — the modeled-step-style whole-step prediction
    decisions are ranked on (overlap hides part of the wire in practice;
    the hidden fraction is configuration-independent enough that it cancels
    in the ranking).

    ``straggler_excess_ms`` is the per-step excess the gang's worst rank
    adds over the gang-median pace (straggler-score incidents carry the
    measurement).  Under bulk sync the whole gang pays it every step; a
    bounded-staleness configuration lets the indicted rank skip up to τ
    consecutive rounds, so the barrier only lands the excess every τ+1
    rounds — the modeled charge is ``excess / (τ + 1)``.  At τ=0 this is
    exactly the bulk-sync cost, so the term is inert for every legacy
    candidate."""
    excess = max(0.0, float(straggler_excess_ms)) / (int(config.staleness) + 1)
    return float(compute_ms) + excess + wire_ms(
        cost_model, plan, n_ranks, config,
        hierarchical=hierarchical, bandwidth_factor=bandwidth_factor,
        axis=axis, exchange_axes=exchange_axes,
    )


def price_configurations(
    cost_model,
    plan,
    n_ranks: int,
    candidates: Sequence[Configuration],
    compute_ms: float,
    hierarchical: bool = False,
    bandwidth_factor: float = 1.0,
    axis: Optional[str] = None,
    exchange_axes: Sequence[str] = (),
    straggler_excess_ms: float = 0.0,
) -> List[Tuple[Configuration, float]]:
    """Every candidate with its modeled step-ms, cheapest first.  Cost ties
    break toward lower staleness — never pay a convergence tax for goodput
    the model says is free."""
    priced = [
        (
            cfg,
            modeled_step_ms(
                cost_model, plan, n_ranks, cfg, compute_ms,
                hierarchical=hierarchical, bandwidth_factor=bandwidth_factor,
                axis=axis, exchange_axes=exchange_axes,
                straggler_excess_ms=straggler_excess_ms,
            ),
        )
        for cfg in candidates
    ]
    priced.sort(key=lambda it: (it[1], int(it[0].staleness)))
    return priced
