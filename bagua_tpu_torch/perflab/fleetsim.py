"""Fleet-scale fault injection against the real host-side machinery.

A discrete-event simulation of N gangs, each gang a set of per-rank modeled
step clocks (compute span + wire span from the perf lab's model, plus
deterministic seeded jitter).  The *clocks* are simulated; everything they
drive is the production code path, unmodified:

* per-rank :class:`~bagua_tpu_torch.observability.aggregate.StepSummary` pushes
  through a **live** rendezvous KV service
  (:func:`~bagua_tpu_torch.distributed.rendezvous.start_rendezvous_server`),
* rank-0 :class:`~bagua_tpu_torch.observability.aggregate.GangAggregator`
  collect/aggregate with its straggler scoring and local-only degradation,
* :func:`~bagua_tpu_torch.observability.flight_recorder.push_flight_digest`
  breadcrumbs,
* the shared :class:`~bagua_tpu_torch.resilience.retry.CircuitBreaker` open →
  half-open-probe → reclose arc.

Faults are injected at the only two honest seams: the step clocks
(:class:`Straggler`, :class:`BandwidthCollapse`, :class:`Preemption`) and
the KV transport (:class:`KVFlap`, via :class:`FlakyClient`).  If a fault's
signature fails to surface in the gang view — or a KV flap leaks an
exception into the "training" loop — that is a real bug in the production
observability/resilience code, found without a TPU.

Everything in :func:`run_fleet`'s report is deterministic under a fixed
seed (no wall-clock, no real port numbers), so two runs diff clean.
"""

import dataclasses
import random
import statistics
from typing import Callable, Dict, List, Optional, Tuple

from bagua_tpu_torch.observability.aggregate import GangAggregator, StepSummary
from bagua_tpu_torch.observability.flight_recorder import (
    FlightRecorder,
    push_flight_digest,
)
from bagua_tpu_torch.resilience.retry import CircuitBreaker

__all__ = [
    "BandwidthCollapse",
    "FleetConfig",
    "FlakyClient",
    "KVFlap",
    "KVFlapStorm",
    "Preemption",
    "PreemptionStorm",
    "Straggler",
    "churn_schedule",
    "run_fleet",
]


# ---------------------------------------------------------------------------
# Fault vocabulary
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Straggler:
    """One rank's phase runs ``factor`` slow over ``[start, end)`` windows.

    ``ramp_windows`` makes the fault *transient-shaped*: instead of landing
    at the full factor on its first active window, the slowdown climbs
    linearly over ``ramp_windows`` windows before plateauing (onset →
    ramp → plateau → heal at ``end_window``).  The straggler-tolerance
    lane uses this to prove the degradation ladder rides the whole arc:
    indictment on the ramp, bounded-staleness at the plateau, and the
    guardrail's return to bulk sync after the fault clears."""

    gang: int
    rank: int
    factor: float = 2.0
    phase: str = "wire"  #: "wire" or "compute" — attribution target
    start_window: int = 0
    end_window: Optional[int] = None
    ramp_windows: int = 0

    def active(self, window: int) -> bool:
        return self.start_window <= window and (
            self.end_window is None or window < self.end_window
        )

    def effective_factor(self, window: int) -> float:
        """The slowdown this window actually applies: 1.0 outside the
        active span, a linear climb toward ``factor`` during the ramp,
        the full factor at the plateau."""
        if not self.active(window):
            return 1.0
        elapsed = window - self.start_window
        if elapsed < self.ramp_windows:
            frac = (elapsed + 1) / (self.ramp_windows + 1)
            return 1.0 + (self.factor - 1.0) * frac
        return self.factor


@dataclasses.dataclass(frozen=True)
class BandwidthCollapse:
    """A gang's wire span inflates by ``factor`` (ICI brownout / DCN
    congestion).  With ``axis`` set — and the fleet configured with per-axis
    wire spans (:attr:`FleetConfig.axis_wire_ms`) — only that mesh axis's
    modeled wire leg collapses, so the gang view's per-axis medians carry
    the axis signature a per-axis regression sentinel must attribute."""

    gang: int
    factor: float = 4.0
    start_window: int = 0
    end_window: Optional[int] = None
    axis: Optional[str] = None

    def active(self, window: int) -> bool:
        return self.start_window <= window and (
            self.end_window is None or window < self.end_window
        )


@dataclasses.dataclass(frozen=True)
class Preemption:
    """One rank stops reporting from ``window`` on (host reclaimed).  Its
    last KV summary stays behind — the gang view must surface the
    staleness, not silently average a ghost."""

    gang: int
    rank: int
    window: int

    def active(self, window: int) -> bool:
        return window >= self.window


@dataclasses.dataclass(frozen=True)
class KVFlap:
    """The gang's KV transport fails over ``[start, end)`` windows.  The
    breaker must absorb it (open, then reclose on the first post-flap
    probe) with zero exceptions reaching the step loop."""

    gang: int
    start_window: int = 0
    end_window: Optional[int] = None

    def active(self, window: int) -> bool:
        return self.start_window <= window and (
            self.end_window is None or window < self.end_window
        )


@dataclasses.dataclass(frozen=True)
class PreemptionStorm:
    """Fleet-scale churn profile: a seeded ``fraction`` of all gangs each
    lose one rank at ``window`` (a zone reclaim hitting many tenants at
    once).  :meth:`expand` materializes the concrete per-gang
    :class:`Preemption` faults — deterministic under the seed, so a storm
    at 1000 gangs diffs clean across runs."""

    fraction: float = 0.1
    window: int = 2
    rank: int = 1

    def expand(self, n_gangs: int, seed: int = 0) -> List[Preemption]:
        rng = random.Random(1_000_033 * seed + 7)
        hit = rng.sample(range(n_gangs), max(1, int(n_gangs * self.fraction)))
        return [Preemption(gang=g, rank=self.rank, window=self.window)
                for g in sorted(hit)]


@dataclasses.dataclass(frozen=True)
class KVFlapStorm:
    """Fleet-scale churn profile: a seeded ``fraction`` of all gangs lose
    their KV transport over ``[start, end)`` windows simultaneously (a
    control-plane brownout as seen from the tenants)."""

    fraction: float = 0.1
    start_window: int = 1
    end_window: Optional[int] = 2

    def expand(self, n_gangs: int, seed: int = 0) -> List[KVFlap]:
        rng = random.Random(1_000_037 * seed + 11)
        hit = rng.sample(range(n_gangs), max(1, int(n_gangs * self.fraction)))
        return [KVFlap(gang=g, start_window=self.start_window,
                       end_window=self.end_window)
                for g in sorted(hit)]


def churn_schedule(
    n_gangs: int,
    seed: int = 0,
    preempt_fraction: float = 0.1,
    flap_fraction: float = 0.1,
    windows: int = 3,
) -> Tuple:
    """The default storm mix the 1000-gang scale lane drives: a preemption
    storm mid-run plus a KV-flap brownout in the first window (disjoint
    RNG streams, so the two storms hit independent gang subsets).  Returns
    a concrete fault tuple for :attr:`FleetConfig.faults`."""
    storm = PreemptionStorm(
        fraction=preempt_fraction, window=max(2, windows // 2 + 1)
    )
    flap = KVFlapStorm(fraction=flap_fraction, start_window=1, end_window=2)
    return tuple(storm.expand(n_gangs, seed) + flap.expand(n_gangs, seed))


class FlakyClient:
    """A rendezvous client wrapper whose transport can be failed on demand.

    Injection lives here — the wrapped client and everything above it is
    production code.  While ``failing`` every KV verb raises, exactly like
    a dead coordinator mid-``urlopen``."""

    def __init__(self, inner):
        self._inner = inner
        self.failing = False
        self.calls = 0
        self.injected_failures = 0

    def _gate(self):
        self.calls += 1
        if self.failing:
            self.injected_failures += 1
            raise ConnectionError("injected KV flap")

    def kv_set(self, key, value):
        self._gate()
        return self._inner.kv_set(key, value)

    def kv_get(self, key):
        self._gate()
        return self._inner.kv_get(key)

    def heartbeat(self):
        self._gate()
        return self._inner.heartbeat()


# ---------------------------------------------------------------------------
# Fleet configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetConfig:
    """One fleet run: N gangs × M ranks × W windows of modeled clocks."""

    n_gangs: int = 4
    ranks_per_gang: int = 4
    windows: int = 3
    seed: int = 0
    #: baseline modeled spans per step, ms (e.g. a ModeledCell's
    #: ``compute_ms`` / ``exposed_wire_ms``); jitter is ±3% seeded
    compute_ms: float = 6.0
    wire_ms: float = 4.0
    #: optional per-mesh-axis split of the wire span (ms per axis).  When
    #: set it REPLACES ``wire_ms`` as the modeled wire (the base wire is the
    #: sum of the axis spans) and every rank summary's ``phase_ms`` gains
    #: ``wire_<axis>`` sub-spans, so an axis-scoped
    #: :class:`BandwidthCollapse` surfaces per axis in the gang view.
    axis_wire_ms: Optional[Dict[str, float]] = None
    steps_per_window: int = 20
    global_batch: int = 256
    straggler_factor: float = 1.5  #: detection threshold, not injection
    #: tight breaker so one flap window exercises the full open/reclose arc
    breaker_threshold: int = 2
    breaker_cooldown_s: float = 0.0
    faults: Tuple = ()

    def base_wire_ms(self) -> float:
        """The fault-free modeled wire span (the sum of the axis spans when
        the wire is split per axis)."""
        if self.axis_wire_ms:
            return float(sum(self.axis_wire_ms[ax]
                             for ax in sorted(self.axis_wire_ms)))
        return float(self.wire_ms)

    def fault_descriptions(self) -> List[Dict]:
        return [
            {"kind": type(f).__name__, **dataclasses.asdict(f)}
            for f in self.faults
        ]


def _rank_step_ms(
    cfg: FleetConfig, gang: int, rank: int, window: int, rng: random.Random
) -> Tuple[float, Dict[str, float]]:
    """One rank's modeled step p50 for one window, faults applied."""
    compute = cfg.compute_ms
    axis_parts = (
        {str(ax): float(cfg.axis_wire_ms[ax]) for ax in sorted(cfg.axis_wire_ms)}
        if cfg.axis_wire_ms else None
    )
    wire = sum(axis_parts.values()) if axis_parts else cfg.wire_ms
    for f in cfg.faults:
        if not f.active(window) or getattr(f, "gang", None) != gang:
            continue
        if isinstance(f, BandwidthCollapse):
            if axis_parts is not None:
                # axis-scoped collapse hits only the indicted axis's span;
                # an axis-less collapse browns out every leg
                hit = [f.axis] if f.axis else list(axis_parts)
                for ax in hit:
                    if ax in axis_parts:
                        axis_parts[ax] *= f.factor
                wire = sum(axis_parts.values())
            else:
                wire *= f.factor
        elif isinstance(f, Straggler) and f.rank == rank:
            eff = f.effective_factor(window)
            if f.phase == "compute":
                compute *= eff
            else:
                wire *= eff
                if axis_parts is not None:
                    for ax in axis_parts:
                        axis_parts[ax] *= eff
    jitter = 1.0 + 0.03 * (2.0 * rng.random() - 1.0)
    phase_ms = {"compute": round(compute * jitter, 6),
                "wire": round(wire * jitter, 6)}
    if axis_parts is not None:
        for ax in sorted(axis_parts):
            phase_ms[f"wire_{ax}"] = round(axis_parts[ax] * jitter, 6)
    return (compute + wire) * jitter, phase_ms


def _is_preempted(cfg: FleetConfig, gang: int, rank: int, window: int) -> bool:
    return any(
        isinstance(f, Preemption)
        and f.gang == gang and f.rank == rank and f.active(window)
        for f in cfg.faults
    )


def _kv_flapping(cfg: FleetConfig, gang: int, window: int) -> bool:
    return any(
        isinstance(f, KVFlap) and f.gang == gang and f.active(window)
        for f in cfg.faults
    )


# ---------------------------------------------------------------------------
# The simulation loop
# ---------------------------------------------------------------------------


def run_fleet(
    cfg: FleetConfig,
    endpoint: Optional[str] = None,
    gang_endpoint: Optional[Callable[[int], str]] = None,
) -> Dict:
    """Run the fleet; returns a deterministic per-gang verdict report.

    When ``endpoint`` is None a private rendezvous server is started on a
    loopback ephemeral port and torn down before returning.  Clients use
    the KV verbs only (never ``join``), so the shared server's membership
    machine is untouched and ``heartbeat`` deterministically reports no
    member ages.

    ``gang_endpoint`` maps a gang index to its own endpoint — how the fleet
    load lane points each simulated gang at its ``/g/<gang_id>`` namespace
    on one multi-tenant control plane.  Overrides ``endpoint`` per gang.
    """
    from bagua_tpu_torch.distributed.rendezvous import (
        RendezvousState,
        start_rendezvous_server,
    )

    server = None
    if endpoint is None and gang_endpoint is None:
        state = RendezvousState(min_nodes=1, settle_s=0.05)
        server = start_rendezvous_server(state, 0, host="127.0.0.1")
        endpoint = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        return _run(cfg, endpoint, gang_endpoint)
    finally:
        if server is not None:
            server.shutdown()


def _run(
    cfg: FleetConfig,
    endpoint: Optional[str],
    gang_endpoint: Optional[Callable[[int], str]] = None,
) -> Dict:
    from bagua_tpu_torch.distributed.rendezvous import RendezvousClient

    gangs = []
    for g in range(cfg.n_gangs):
        client = FlakyClient(
            RendezvousClient(
                gang_endpoint(g) if gang_endpoint is not None else endpoint,
                node_rank=0,
                timeout_s=10.0,
            )
        )
        # one aggregator per rank, all sharing the gang's transport and a
        # per-gang attempt nonce so KV keys never collide across gangs
        attempt = f"sim-g{g}"
        aggs = [
            GangAggregator(
                client,
                rank=r,
                world_size=cfg.ranks_per_gang,
                attempt=attempt,
                window=cfg.steps_per_window,
                straggler_factor=cfg.straggler_factor,
                breaker=CircuitBreaker(
                    failure_threshold=cfg.breaker_threshold,
                    cooldown_s=cfg.breaker_cooldown_s,
                    name=f"sim-g{g}r{r}",
                ),
            )
            for r in range(cfg.ranks_per_gang)
        ]
        rngs = [
            random.Random(1_000_003 * cfg.seed + 1_009 * g + r)
            for r in range(cfg.ranks_per_gang)
        ]
        recorder = FlightRecorder(
            capacity=8, rank=0, world_size=cfg.ranks_per_gang
        )
        gangs.append({
            "client": client, "aggs": aggs, "rngs": rngs,
            "recorder": recorder, "attempt": attempt,
            "windows": [], "errors": [],
        })

    for window in range(1, cfg.windows + 1):
        step = window * cfg.steps_per_window
        for g, gang in enumerate(gangs):
            gang["client"].failing = _kv_flapping(cfg, g, window)
            view = None
            try:
                # non-coordinator ranks push first, then rank 0 aggregates
                # — one simulated window boundary
                for r in range(1, cfg.ranks_per_gang):
                    if _is_preempted(cfg, g, r, window):
                        continue
                    p50, phase_ms = _rank_step_ms(
                        cfg, g, r, window, gang["rngs"][r]
                    )
                    gang["aggs"][r].push(_summary(cfg, r, step, window,
                                                  p50, phase_ms))
                p50, phase_ms = _rank_step_ms(cfg, g, 0, window,
                                              gang["rngs"][0])
                view = gang["aggs"][0].aggregate(
                    _summary(cfg, 0, step, window, p50, phase_ms)
                )
            except Exception as exc:  # must never happen: the step loop saw it
                gang["errors"].append(f"window {window}: {exc!r}")
            gang["windows"].append(_window_verdict(cfg, g, window, step, view))

    # post-run: one flight-digest push per gang, transport healthy again
    for gang in gangs:
        gang["client"].failing = False
        gang["digest_pushed"] = push_flight_digest(
            gang["client"], gang["recorder"],
            attempt=gang["attempt"], breaker=gang["aggs"][0].breaker,
        )

    return {
        "n_gangs": cfg.n_gangs,
        "ranks_per_gang": cfg.ranks_per_gang,
        "windows": cfg.windows,
        "seed": cfg.seed,
        "faults": cfg.fault_descriptions(),
        "gangs": [_gang_verdict(cfg, g, gang) for g, gang in enumerate(gangs)],
    }


def _summary(cfg: FleetConfig, rank: int, step: int, window: int,
             p50: float, phase_ms: Dict[str, float]) -> StepSummary:
    return StepSummary(
        rank=rank,
        step=step,
        window=cfg.steps_per_window,
        p50_ms=round(p50, 6),
        p99_ms=round(p50 * 1.15, 6),
        wire_bytes=int(phase_ms["wire"] * 1e6),  # nominal: bytes ∝ wire span
        mfu=round(0.3 * phase_ms["compute"] / p50, 6),
        samples_per_s=round(cfg.global_batch * 1e3 / p50, 3),
        phase_ms=phase_ms,
        health={},
    )


def _window_verdict(cfg: FleetConfig, gang: int, window: int, step: int,
                    view) -> Dict:
    if view is None:
        return {"window": window, "view": None}
    stale_ranks = sorted(
        s.rank for s in view.summaries if s.step < step
    )
    out = {
        "window": window,
        "ranks_reporting": view.ranks_reporting,
        "local_only": view.local_only,
        # absolute gang pace, not just skew: what an autopilot driver feeds
        # its regression sentinel to see a fault window's wire collapse
        "gang_p50_ms": round(view.p50_median, 4),
        "p50_skew": round(view.skew, 4),
        "straggler": view.straggler,
        "stale_ranks": stale_ranks,
    }
    # per-axis gang wire medians, present iff ranks report wire_<axis>
    # phase sub-spans — the per-axis sentinel's measured-wire feed
    axis_keys = sorted({
        k for s in view.summaries
        for k in (s.phase_ms or {}) if k.startswith("wire_")
    })
    if axis_keys:
        out["gang_wire_axis_ms"] = {
            k[len("wire_"):]: round(statistics.median(
                s.phase_ms[k] for s in view.summaries
                if k in (s.phase_ms or {})
            ), 4)
            for k in axis_keys
        }
    return out


def _gang_verdict(cfg: FleetConfig, g: int, gang: Dict) -> Dict:
    breaker = gang["aggs"][0].breaker
    detections = [
        {"window": w["window"], **w["straggler"]}
        for w in gang["windows"]
        if w.get("straggler")
    ]
    # detection is on the whole-step p50 ratio, not the phase factor: a
    # 2x-wire straggler with a large compute span may stay under threshold.
    # The 1.07 guard keeps ±3% jitter from flipping a marginal verdict.
    expected_stragglers = sorted({
        (f.rank, f.phase) for f in gang_faults(cfg, g, Straggler)
        if _expected_ratio(cfg, f) >= cfg.straggler_factor * 1.07
    })
    detected_pairs = sorted({(d["rank"], d["phase"]) for d in detections})
    flapped = bool(gang_faults(cfg, g, KVFlap))
    degraded_windows = [
        w["window"] for w in gang["windows"] if w.get("local_only")
    ]
    healthy = (
        not gang["errors"]
        and detected_pairs == expected_stragglers
        and breaker.state == "closed"
        and (breaker.times_opened >= 1) == flapped
        and gang["digest_pushed"]
    )
    return {
        "gang": g,
        "attempt": gang["attempt"],
        "errors": gang["errors"],
        "windows": gang["windows"],
        "straggler_detections": detections,
        "expected_stragglers": [list(p) for p in expected_stragglers],
        "kv_flap_injected": flapped,
        "degraded_windows": degraded_windows,
        "breaker": {
            "times_opened": breaker.times_opened,
            "final_state": breaker.state,
        },
        "kv_calls": gang["client"].calls,
        "kv_injected_failures": gang["client"].injected_failures,
        "flight_digest_pushed": gang["digest_pushed"],
        "healthy": healthy,
    }


def gang_faults(cfg: FleetConfig, gang: int, kind) -> List:
    return [f for f in cfg.faults
            if isinstance(f, kind) and f.gang == gang]


def _expected_ratio(cfg: FleetConfig, f: Straggler) -> float:
    """Peak whole-step slowdown this fault reaches inside the simulated
    window range (a transient straggler whose ramp never plateaus before
    ``end_window`` — or whose active span misses the run — peaks lower
    than its nominal factor)."""
    wire = cfg.base_wire_ms()
    base = cfg.compute_ms + wire
    peak = max(
        f.effective_factor(w) for w in range(1, cfg.windows + 1)
    )
    if f.phase == "compute":
        return (cfg.compute_ms * peak + wire) / base
    return (cfg.compute_ms + wire * peak) / base
