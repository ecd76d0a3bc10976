"""Goodput / MFU accounting: how much of the wall clock trained the model.

BAGUA's throughput-vs-convergence tradeoff is an *observed* quantity; this
module makes the observation first-class instead of hand-math in
``ci/perf_audit.py``.  Three pieces, all host-side and opt-in:

* **FLOPs estimator** — an analytic per-model registry (VGG16 / MLP built
  in, :func:`register_model_flops` for user models) cross-checkable against
  PyTorch's own count of one step (``torch.utils.flop_counter``,
  :func:`flops_from_cost_analysis`, where the JAX package reads XLA's
  ``compiled.cost_analysis()``).
  The FLOP convention matches the perf-audit roofline: one multiply-accumulate
  counts as one FLOP (VGG16 fwd at 224² = 15.5 GFLOP, ×3 for fwd+bwd).
* **:class:`GoodputMeter`** — per-step ``mfu`` (model FLOPs / wall /
  peak) and ``wire_efficiency`` (α–β-predicted wire time from the planner's
  fitted :class:`~bagua_tpu_torch.service.planner.CostModel` over the live bucket
  plan, divided by the measured wire time a device-trace analysis supplies)
  gauges, fed by the :class:`~bagua_tpu_torch.observability.telemetry.Telemetry`
  hub.
* **:class:`GoodputLedger`** — classifies every wall-second of the run as
  ``productive`` / ``compile`` / ``snapshot`` / ``drain`` / ``data`` /
  ``lost_restart`` from the existing ``compile``/``snapshot``/``restart``
  telemetry events plus the hub's phase transitions, so ``goodput_frac`` is
  a live gauge, not a post-hoc trace read.  The ledger is a state machine
  over the host clock: exactly one bucket owns any instant, so the buckets
  sum to the elapsed wall time by construction (pinned ±1% in tests).
"""

import threading
import time
from typing import Callable, Dict, Optional, Sequence

__all__ = [
    "GoodputLedger",
    "GoodputMeter",
    "LEDGER_BUCKETS",
    "DEFAULT_PEAK",
    "PEAK_FLOPS_PER_CHIP",
    "TRAIN_FLOPS_MULTIPLIER",
    "flops_from_cost_analysis",
    "mlp_fwd_flops",
    "model_flops_per_sample",
    "predicted_axis_wire_time",
    "predicted_wire_time",
    "register_model_flops",
    "vgg16_fwd_flops",
]

#: per-card peak throughput (FLOP/s), the denominators MFU is quoted
#: against: NVIDIA's data sheet for the H100 SXM5, dense (no sparsity)
#: tensor-core rates at its full 700 W power limit; a card set below 700 W
#: (``nvidia-smi --query-gpu=name,power.limit``) peaks lower.  The data sheet
#: counts a multiply-accumulate as two FLOPs, the estimators below as one
#: (the JAX package's convention, kept so the two packages' MFU agree): an
#: MFU of 0.5 here is a card at its data-sheet peak.
PEAK_FLOPS_PER_CHIP = {
    "h100-sxm-bf16": 989e12,
    "h100-sxm-tf32": 495e12,
    "h100-sxm-f32": 67e12,
}

#: the default MFU denominator: the H100's dense bf16 tensor-core peak
DEFAULT_PEAK = "h100-sxm-bf16"

#: training FLOPs ≈ 3× the forward pass (backward re-computes both the
#: activation and the weight gradient) — the perf-audit convention
#: ("15.5 fwd ×3 for fwd+bwd").
TRAIN_FLOPS_MULTIPLIER = 3.0


# -- analytic FLOPs estimators (1 MAC = 1 FLOP, matching the audit) ----------


def vgg16_fwd_flops(
    image_size: int = 224,
    num_classes: int = 1000,
    classifier_width: int = 4096,
    cfg: Optional[Sequence] = None,
) -> float:
    """Forward-pass FLOPs per image for the VGG16 of
    :mod:`bagua_tpu_torch.models.vgg` (3×3 convs + 2×2 pools + 3 dense layers).
    224²/1000 classes ⇒ 15.5 GFLOP — the operand of the perf-audit
    hand-math (``32 img × 46.5 GFLOP = 1.49 TF/step/chip``)."""
    from bagua_tpu_torch.models.vgg import VGG16_CFG

    cfg = VGG16_CFG if cfg is None else cfg
    h = w = int(image_size)
    cin = 3
    flops = 0.0
    for v in cfg:
        if v == "M":
            h //= 2
            w //= 2
        else:
            flops += float(h * w) * 9.0 * cin * int(v)
            cin = int(v)
    features = h * w * cin
    for width in (classifier_width, classifier_width, num_classes):
        flops += float(features) * width
        features = width
    return flops


def mlp_fwd_flops(sizes: Sequence[int]) -> float:
    """Forward-pass FLOPs per sample for the dense MLP of
    :mod:`bagua_tpu_torch.models.mlp` (``sizes`` = layer widths incl. input)."""
    return float(sum(a * b for a, b in zip(sizes[:-1], sizes[1:])))


_MODEL_FLOPS: Dict[str, Callable[..., float]] = {
    "vgg16": vgg16_fwd_flops,
    "mlp": mlp_fwd_flops,
}


def register_model_flops(name: str, fwd_flops_fn: Callable[..., float]) -> None:
    """Register an analytic forward-FLOPs-per-sample estimator for a model
    name (``fn(**kwargs) -> float``); :func:`model_flops_per_sample` and
    :class:`GoodputMeter` resolve through this registry."""
    _MODEL_FLOPS[name] = fwd_flops_fn


def model_flops_per_sample(name: str, train: bool = True, **kwargs) -> float:
    """Per-sample FLOPs for a registered model (forward pass ×
    :data:`TRAIN_FLOPS_MULTIPLIER` when ``train``)."""
    if name not in _MODEL_FLOPS:
        raise KeyError(
            f"no FLOPs estimator registered for model {name!r} "
            f"(known: {sorted(_MODEL_FLOPS)}); use register_model_flops"
        )
    fwd = float(_MODEL_FLOPS[name](**kwargs))
    return fwd * TRAIN_FLOPS_MULTIPLIER if train else fwd


def flops_from_cost_analysis(step_fn) -> Optional[float]:
    """PyTorch's own FLOP count of one call of ``step_fn`` (a zero-argument
    callable that runs one step), counted by
    ``torch.utils.flop_counter.FlopCounterMode``; None when it counts
    nothing.  The counterpart of the JAX package's read of XLA's
    ``compiled.cost_analysis()``, and like it the cross-check for the
    analytic registry: the counter takes a multiply-accumulate as two
    FLOPs, so expect about twice the analytic number for a model of
    convolutions and matmuls.  The call runs the step: count on a copy of
    the state, or on a step whose update is wanted."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        step_fn()
    flops = float(counter.get_total_flops())
    return flops if flops > 0 else None


def predicted_wire_time(
    cost_model,
    bucket_bytes: Sequence[float],
    hierarchical: bool = False,
    wire_pattern: str = "allreduce",
) -> float:
    """α–β-predicted wire seconds for one step's bucketed exchange: the
    planner's fitted :class:`~bagua_tpu_torch.service.planner.CostModel` applied
    to every live bucket — the denominator-side input of the
    ``wire_efficiency`` gauge."""
    return float(
        sum(
            cost_model.bucket_wire_time(b, hierarchical=hierarchical,
                                        wire_pattern=wire_pattern)
            for b in bucket_bytes
        )
    )


def predicted_axis_wire_time(
    cost_model,
    bucket_bytes: Sequence[float],
    axes: Sequence[str],
) -> Dict[str, float]:
    """Per-mesh-axis α–β-predicted wire seconds for one step's bucketed
    exchange: each bucket's bytes split evenly across the exchange axes and
    priced on each axis's fitted leg
    (:meth:`~bagua_tpu_torch.service.planner.CostModel.axis_leg`, falling back to
    ``flat`` on legacy 1-D meshes).  Returns ``{axis: seconds}``."""
    axes = [str(a) for a in axes if a]
    if not axes:
        return {}
    out: Dict[str, float] = {}
    for b in bucket_bytes:
        share = float(b) / len(axes)
        for ax in axes:
            out[ax] = out.get(ax, 0.0) + cost_model.axis_leg(ax).predict(share)
    return out


# -- the wall-clock ledger ----------------------------------------------------

#: every wall-second of the run lands in exactly one of these
LEDGER_BUCKETS = (
    "startup",       # init -> first step activity
    "productive",    # step dispatch + device wait
    "data",          # input pipeline / host idle between steps
    "compile",       # step-function (re)compiles, re-attributed out of productive
    "snapshot",      # blocking state snapshots (anomaly/forced)
    "drain",         # preemption drain (block + final snapshot)
    "lost_restart",  # steps a previous incarnation ran past its last snapshot
)


class GoodputLedger:
    """State machine over the host clock: :meth:`enter` switches the active
    bucket and charges the closed interval to the previous one, so the
    buckets partition the elapsed wall time exactly.  ``lost_restart`` is
    the one synthetic bucket — :meth:`charge` adds the estimated wall of
    steps lost to a restart (they happened in a *previous* incarnation's
    wall clock).  Thread-safe: the async snapshotter's writer thread
    re-attributes blocking snapshot time concurrently with the step loop."""

    def __init__(self, registry=None, clock: Callable[[], float] = time.perf_counter):
        self.registry = registry
        self._clock = clock
        self._lock = threading.Lock()
        self._t0 = clock()
        self._cur = "startup"
        self._t_cur = self._t0
        self.buckets: Dict[str, float] = {b: 0.0 for b in LEDGER_BUCKETS}
        self._synthetic = 0.0  # charged (not clocked) seconds: lost_restart

    def enter(self, bucket: str) -> None:
        """Close the open interval into the active bucket and switch."""
        with self._lock:
            self._flush_locked()
            self._cur = bucket

    def _flush_locked(self) -> None:
        now = self._clock()
        self.buckets[self._cur] = self.buckets.get(self._cur, 0.0) + (now - self._t_cur)
        self._t_cur = now

    def charge(self, bucket: str, seconds: float) -> None:
        """Add synthetic seconds (wall of a *previous* incarnation — the
        lost-restart bucket); tracked separately so the clocked buckets
        still sum to this run's wall time."""
        with self._lock:
            self.buckets[bucket] = self.buckets.get(bucket, 0.0) + float(seconds)
            self._synthetic += float(seconds)

    def reattribute(self, src: str, dst: str, seconds: float) -> None:
        """Move up to ``seconds`` from ``src`` to ``dst`` (e.g. the compile
        embedded in a first dispatch out of ``productive``) — flushing the
        open interval first so ``src`` is current."""
        with self._lock:
            self._flush_locked()
            moved = min(float(seconds), self.buckets.get(src, 0.0))
            if moved <= 0:
                return
            self.buckets[src] -= moved
            self.buckets[dst] = self.buckets.get(dst, 0.0) + moved

    def wall_s(self) -> float:
        return self._clock() - self._t0

    def goodput_frac(self) -> float:
        with self._lock:
            self._flush_locked()
            wall = self._clock() - self._t0
            return self.buckets.get("productive", 0.0) / wall if wall > 0 else 0.0

    def report(self) -> Dict:
        """Bucket seconds + ``goodput_frac``; updates the ``goodput_frac``
        and ``ledger_<bucket>_s`` gauges when a registry is attached.  The
        clocked buckets sum to ``wall_s`` exactly (synthetic lost-restart
        seconds are reported but excluded from the identity)."""
        with self._lock:
            self._flush_locked()
            wall = self._clock() - self._t0
            buckets = {b: round(v, 6) for b, v in sorted(self.buckets.items())}
            synthetic = self._synthetic
        frac = (buckets.get("productive", 0.0) / wall) if wall > 0 else 0.0
        if self.registry is not None:
            self.registry.gauge(
                "goodput_frac", help="fraction of wall time spent in productive steps"
            ).set(round(frac, 6))
            for b, v in buckets.items():
                self.registry.gauge(
                    f"ledger_{b}_s", help=f"wall seconds classified as {b}"
                ).set(v)
        return {
            "wall_s": round(wall, 6),
            "buckets": buckets,
            "synthetic_s": round(synthetic, 6),
            "goodput_frac": round(frac, 6),
        }


#: hub phase -> ledger bucket (phases the engine/trainer already tag)
_PHASE_BUCKET = {
    "dispatch": "productive",
    "wait": "productive",
    "data": "data",
    "init": "startup",
    "drain": "drain",
}


class GoodputMeter:
    """Per-step MFU + wire-efficiency gauges and the goodput ledger, fed by
    the telemetry hub (``Telemetry(goodput=...)``).

    Args:
        model: a name registered with :func:`register_model_flops`
            (``"vgg16"``/``"mlp"`` built in); with ``model_kwargs``
            forwarded to the estimator.  Alternatively pass
            ``flops_per_sample`` directly (wins over ``model``), or
            calibrate later by counting one step
            (:meth:`calibrate_from_compiled`).
        peak_flops_per_chip: the MFU denominator (a number, or a key of
            :data:`PEAK_FLOPS_PER_CHIP`; by default :data:`DEFAULT_PEAK`,
            the H100's dense bf16 peak).
        n_chips: chips the ``n_samples`` global batch spreads over — MFU is
            quoted per chip.
        cost_model: the planner's fitted
            :class:`~bagua_tpu_torch.service.planner.CostModel`; with
            ``bucket_bytes`` (the live plan's per-bucket bytes) it prices
            the predicted wire time for ``wire_efficiency``.
        registry: metrics registry for the gauges (the hub injects its own
            when attached with ``Telemetry(goodput=...)``).
    """

    def __init__(
        self,
        model: Optional[str] = None,
        model_kwargs: Optional[Dict] = None,
        flops_per_sample: Optional[float] = None,
        peak_flops_per_chip=DEFAULT_PEAK,
        n_chips: int = 1,
        cost_model=None,
        bucket_bytes: Optional[Sequence[float]] = None,
        hierarchical: bool = False,
        wire_pattern: str = "allreduce",
        exchange_axes: Optional[Sequence[str]] = None,
        registry=None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        if flops_per_sample is None and model is not None:
            flops_per_sample = model_flops_per_sample(model, **(model_kwargs or {}))
        self.flops_per_sample = flops_per_sample
        if isinstance(peak_flops_per_chip, str):
            peak_flops_per_chip = PEAK_FLOPS_PER_CHIP[peak_flops_per_chip]
        self.peak_flops_per_chip = float(peak_flops_per_chip)
        self.n_chips = max(1, int(n_chips))
        self.cost_model = cost_model
        self.bucket_bytes = list(bucket_bytes) if bucket_bytes else None
        self.hierarchical = hierarchical
        self.wire_pattern = wire_pattern
        #: named mesh axes the live plan's exchange rides (the engine's
        #: ``group.data_axes``); set, the wire prediction routes through the
        #: per-axis α–β legs instead of the flat leg
        self.exchange_axes = tuple(str(a) for a in exchange_axes or () if a)
        self.registry = registry
        self.ledger = GoodputLedger(registry=registry, clock=clock)
        self.last_mfu: Optional[float] = None
        self.last_wire_efficiency: Optional[float] = None
        self._step_walls = []  # recent step walls: prices lost_restart

    def bind_registry(self, registry) -> None:
        """Point the gauges (and the ledger's) at a registry — called by the
        telemetry hub when the meter is attached."""
        self.registry = registry
        self.ledger.registry = registry

    # -- per-step gauges ------------------------------------------------------

    def step_flops(self, n_samples: int) -> Optional[float]:
        if self.flops_per_sample is None:
            return None
        return self.flops_per_sample * max(0, int(n_samples))

    def calibrate_from_compiled(self, step_fn, n_samples: int) -> Optional[float]:
        """Adopt PyTorch's FLOP count of one call of ``step_fn`` (see
        :func:`flops_from_cost_analysis`; the JAX package reads XLA's count
        of the compiled step) as the per-sample estimate (``n_samples`` =
        the global batch of that step).  Returns the adopted per-sample
        FLOPs, or None (keeping any analytic estimate) when nothing was
        counted."""
        flops = flops_from_cost_analysis(step_fn)
        if flops is None or n_samples <= 0:
            return None
        self.flops_per_sample = flops / n_samples
        return self.flops_per_sample

    def on_step(self, wall_s: float, n_samples: int) -> Optional[float]:
        """One dispatched step: update ``mfu`` (and remember the wall for
        lost-restart pricing).  Returns the step's MFU, or None without a
        FLOPs estimate."""
        self._step_walls.append(float(wall_s))
        if len(self._step_walls) > 256:
            del self._step_walls[: len(self._step_walls) - 256]
        flops = self.step_flops(n_samples)
        if flops is None or wall_s <= 0:
            return None
        mfu = flops / self.n_chips / wall_s / self.peak_flops_per_chip
        self.last_mfu = mfu
        if self.registry is not None:
            self.registry.gauge(
                "mfu", help="model FLOPs utilization per chip (analytic estimator)"
            ).set(round(mfu, 6))
            self.registry.gauge(
                "model_flops_per_step", help="estimated model FLOPs per step (global)"
            ).set(flops)
        return mfu

    def predicted_wire_s(self) -> Optional[float]:
        if self.cost_model is None or not self.bucket_bytes:
            return None
        by_axis = self.predicted_wire_by_axis_s()
        if by_axis:
            # named mesh: the expected wire is the sum of the per-axis legs'
            # predictions, NOT the flat leg's — the flat leg mis-prices a
            # dp×tp/dp×fsdp plan and the error lands in ``unattributed``
            return float(sum(by_axis[ax] for ax in sorted(by_axis)))
        return predicted_wire_time(
            self.cost_model, self.bucket_bytes,
            hierarchical=self.hierarchical, wire_pattern=self.wire_pattern,
        )

    def predicted_wire_by_axis_s(self) -> Optional[Dict[str, float]]:
        """Per-axis α–β-predicted wire seconds for the live plan, or None
        when the plan is axis-blind (no ``exchange_axes``)."""
        if (self.cost_model is None or not self.bucket_bytes
                or not self.exchange_axes
                or not hasattr(self.cost_model, "axis_leg")):
            return None
        return predicted_axis_wire_time(
            self.cost_model, self.bucket_bytes, self.exchange_axes,
        )

    def observe_wire(self, measured_wire_s: float,
                     by_axis: Optional[Dict[str, float]] = None
                     ) -> Optional[float]:
        """Feed a *measured* per-step wire time (e.g. the device-trace
        analysis' ``collective_ms``) and update ``wire_efficiency`` =
        predicted / measured — 1.0 means the fabric delivered exactly what
        the fitted α–β model promised; below 1.0 the wire underdelivered
        (congestion, stragglers); above 1.0 the model is stale.  With
        ``by_axis`` (per-axis measured seconds) each axis additionally gets
        a ``wire_efficiency_<axis>`` gauge — the flat-name analog of a
        ``wire_efficiency{axis=...}`` labeled family."""
        predicted = self.predicted_wire_s()
        if predicted is None or measured_wire_s <= 0:
            return None
        eff = predicted / measured_wire_s
        self.last_wire_efficiency = eff
        if self.registry is not None:
            self.registry.gauge(
                "wire_efficiency",
                help="alpha-beta-predicted wire time / measured wire time",
            ).set(round(eff, 6))
            if by_axis:
                predicted_by_axis = self.predicted_wire_by_axis_s() or {}
                for ax, measured_ax in sorted(by_axis.items()):
                    pred_ax = predicted_by_axis.get(ax)
                    if pred_ax is None or measured_ax <= 0:
                        continue
                    self.registry.gauge(
                        f"wire_efficiency_{ax}",
                        help=("alpha-beta-predicted / measured wire time on "
                              f"mesh axis {ax}"),
                    ).set(round(pred_ax / measured_ax, 6))
        return eff

    # -- ledger feed (driven by the telemetry hub) ----------------------------

    def on_phase(self, phase: str) -> None:
        self.ledger.enter(_PHASE_BUCKET.get(phase, "data"))

    def on_compile(self, wall_s: float) -> None:
        """A (re)compile rode inside a dispatch: re-attribute its wall out
        of ``productive`` into ``compile``."""
        self.ledger.reattribute("productive", "compile", wall_s)

    def on_snapshot(self, kind: str, wall_ms: float) -> None:
        """Cadenced (``"async"``) snapshots ride the background writer —
        zero critical-path seconds, nothing to re-attribute.  Blocking kinds
        (anomaly/forced) stalled the step loop for the write."""
        if kind != "async":
            self.ledger.reattribute(self.ledger._cur, "snapshot", wall_ms / 1e3)

    def on_restart(self, lost_steps: int) -> None:
        walls = sorted(self._step_walls)
        p50 = walls[len(walls) // 2] if walls else 0.0
        self.ledger.charge("lost_restart", max(0, int(lost_steps)) * p50)

    def report(self) -> Dict:
        out = {
            "flops_per_sample": self.flops_per_sample,
            "peak_flops_per_chip": self.peak_flops_per_chip,
            "n_chips": self.n_chips,
            "mfu": self.last_mfu,
            "wire_efficiency": self.last_wire_efficiency,
            "predicted_wire_s": self.predicted_wire_s(),
            "predicted_wire_by_axis_s": self.predicted_wire_by_axis_s(),
            "ledger": self.ledger.report(),
        }
        return out
