"""Training-health guardrail: cheap in-graph scalars, a host-side anomaly
detector, and actions that close the loop.

BAGUA's relaxed algorithms (quantized wire, decentralized topologies) trade
convergence risk for throughput; that trade is only safe while something is
*watching* the optimization.  This module is that watcher:

* :func:`health_scalars` — loss, global grad L2 norm, and a nonfinite
  element count, computed once per step on the device by the engine
  (``ddp._step``) from values the step already produced, one ``(size, 3)``
  row per rank, read on the host once.  The count takes several passes
  over the gradients and is zero wherever the norm is finite, so the
  engine counts only after reading a non-finite norm.  Pure reads: the parameter path is
  untouched, so training with the monitor on vs off is bitwise-identical
  (pinned in tests, same discipline as the ``record_function`` labels).
* :class:`HealthMonitor` — host-side detector over the per-step scalars:
  EWMA z-score loss-spike, grad-norm explosion vs its own EWMA, and a NaN
  latch.  Each anomaly emits a schema-validated ``health_alert`` JSONL
  event through the telemetry hub and invokes registered actions.
* Shipped actions: :class:`PrecisionDemotionAction` (int4→int8→f32 via
  ``DistributedDataParallel.apply_precision_plan`` — the planner's
  aggressive wire choice backs off before it diverges) and
  :class:`SnapshotOnAnomalyAction` (a blocking snapshot of the
  still-healthy-enough state on the *first* anomaly, via the
  ``AsyncSnapshotter``).

Everything host-side is opt-in and failure-isolated: a raising action is
logged and skipped, never allowed to take the step loop down.
"""

import dataclasses
import logging
import math
from typing import Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

__all__ = [
    "HealthConfig",
    "HealthMonitor",
    "PrecisionDemotionAction",
    "SnapshotOnAnomalyAction",
    "health_scalars",
]

#: order of the scalars in the in-graph health vector
HEALTH_KEYS = ("loss", "grad_norm", "nonfinite")


def health_scalars(loss, grads):
    """``[loss, global_grad_l2_norm, nonfinite_count]`` in f32 from a step's
    loss and gradient tree (the JAX package's in-graph vector).  ``loss``
    of shape ``()`` gives a ``(3,)`` vector for one rank; a rank-stacked
    ``(size,)`` loss with rank-stacked gradients (leading axis ``size``)
    gives ``(size, 3)``, one row a rank, on the gradients' device.  Pure
    reads of values the step already computed: it never feeds back into
    parameters (bitwise-inert, pinned in tests).  The engine computes the
    two reductions apart (:func:`grad_norms`, then
    :func:`nonfinite_counts` only where a norm is not finite)."""
    import torch

    loss = torch.as_tensor(loss)
    return torch.stack([loss.to(torch.float32), grad_norms(loss, grads), nonfinite_counts(loss, grads)], dim=-1)


def _float_leaves(loss, grads):
    """``(leaf, the dims after the loss's)`` of every floating leaf."""
    import torch

    from bagua_tpu_torch.utils import tree_leaves

    lead = torch.as_tensor(loss).dim()
    return [(leaf, tuple(range(lead, leaf.dim()))) for leaf in tree_leaves(grads)
            if torch.is_tensor(leaf) and (leaf.is_floating_point() or leaf.is_complex())]


def grad_norms(loss, grads):
    """The f32 L2 norm of the gradients a rank (shaped as ``loss``): one
    read of each leaf.  A NaN or an infinity in a rank's gradients makes
    its norm non-finite."""
    import torch

    loss = torch.as_tensor(loss)
    sq = torch.zeros(loss.shape, dtype=torch.float32, device=loss.device)
    for leaf, dims in _float_leaves(loss, grads):
        if dims:
            sq = sq + torch.square(torch.linalg.vector_norm(leaf, dim=dims, dtype=torch.float32))
        else:  # one element a rank (a reduction over no dim would take them all)
            sq = sq + torch.square(leaf.to(torch.float32))
    return torch.sqrt(sq)


def nonfinite_counts(loss, grads):
    """The number of non-finite gradient elements a rank, f32, shaped as
    ``loss``.  Several passes over each leaf (``isfinite``, its mask, a
    sum) where :func:`grad_norms` takes one, which is why the engine runs
    it only after a non-finite norm."""
    import torch

    loss = torch.as_tensor(loss)
    count = torch.zeros(loss.shape, dtype=torch.float32, device=loss.device)
    for leaf, dims in _float_leaves(loss, grads):
        bad = torch.logical_not(torch.isfinite(leaf))
        count = count + (bad.sum(dim=dims, dtype=torch.float32) if dims else bad.to(torch.float32))
    return count


@dataclasses.dataclass
class HealthConfig:
    """Detector thresholds.  Warmup suppresses alerts while the EWMA
    statistics are still meaningless; ``min_std`` floors the z-score
    denominator so a perfectly flat loss cannot alert on noise."""

    ewma_alpha: float = 0.2          # EWMA smoothing for loss mean/var and grad norm
    loss_z_threshold: float = 6.0    # |z| of loss vs its EWMA above which we alert
    grad_norm_factor: float = 10.0   # grad_norm > factor * EWMA(grad_norm) alerts
    warmup_steps: int = 5            # observations before the detector may alert
    min_std: float = 1e-6            # floor for the loss z-score denominator
    max_alerts: int = 64             # retained alert dicts (history ring)
    #: clean observations after which latched actions (and the NaN latch)
    #: re-arm automatically; None keeps the historical latch-forever behavior
    rearm_windows: Optional[int] = None


class HealthMonitor:
    """Host-side anomaly detector over the per-step health scalars.

    Attach to the engine via ``DistributedDataParallel(...,
    health_monitor=...)`` (or ``Trainer(health_monitor=...)``): the engine
    computes :func:`health_scalars` in-graph and calls :meth:`observe` after
    every dispatched step.  Detected anomalies (kinds ``loss_spike``,
    ``grad_norm_explosion``, ``nonfinite``) are emitted as ``health_alert``
    events through the telemetry hub and handed to registered actions in
    registration order; an action returning True is recorded as applied,
    a raising action is logged and skipped.
    """

    def __init__(self, telemetry=None, registry=None, config: Optional[HealthConfig] = None,
                 actions=()):
        self.telemetry = telemetry
        self.registry = registry if registry is not None else (
            telemetry.registry if telemetry is not None else None)
        self.config = config or HealthConfig()
        self.actions: List[Callable] = list(actions)
        self.alerts: List[Dict] = []
        self.nan_latched = False
        self._n = 0
        self._loss_mean = 0.0
        self._loss_var = 0.0
        self._grad_ewma = 0.0
        #: consecutive clean (finite, alert-free) observations since the
        #: last anomaly — the stabilization signal re-promotion keys off
        self._clean_streak = 0
        self._rearmed = True  # no alert episode open yet

    def bind_telemetry(self, telemetry) -> None:
        """Adopt the engine's telemetry hub (and its registry) when the
        monitor was constructed before the hub existed."""
        if telemetry is None:
            return
        self.telemetry = telemetry
        if self.registry is None:
            self.registry = telemetry.registry

    def register_action(self, action: Callable) -> None:
        """``action(alert: dict, state) -> bool`` — True means applied.
        ``state`` is the freshly-produced training state (read-only use:
        e.g. snapshot it); may be None for detector-only callers."""
        self.actions.append(action)

    # -- detection ------------------------------------------------------------

    def observe(self, step: int, loss: float, grad_norm: float, nonfinite: int,
                state=None) -> List[Dict]:
        """Feed one step's aggregated scalars; returns the alerts raised
        (empty list when healthy).  Never raises: action/emission failures
        are logged and swallowed — the guardrail must not take down the
        step loop it guards."""
        cfg = self.config
        loss = float(loss)
        grad_norm = float(grad_norm)
        nonfinite = int(nonfinite)
        alerts: List[Dict] = []

        finite = math.isfinite(loss) and math.isfinite(grad_norm)
        if nonfinite > 0 or not finite:
            if not self.nan_latched:
                self.nan_latched = True
                alerts.append({
                    "kind": "nonfinite",
                    "value": float(nonfinite),
                    "threshold": 0.0,
                    "detail": f"nonfinite_leaves={nonfinite} loss={loss} grad_norm={grad_norm}",
                })
            if self.registry is not None:
                self.registry.counter(
                    "health_nonfinite_total",
                    help="gradient leaves observed nonfinite",
                ).inc(max(1, nonfinite))
        elif self._n >= cfg.warmup_steps:
            std = math.sqrt(max(self._loss_var, 0.0))
            z = (loss - self._loss_mean) / max(std, cfg.min_std)
            if abs(z) > cfg.loss_z_threshold:
                alerts.append({
                    "kind": "loss_spike",
                    "value": loss,
                    "threshold": cfg.loss_z_threshold,
                    "detail": f"z={z:.2f} ewma_mean={self._loss_mean:.6g} ewma_std={std:.6g}",
                })
            if self._grad_ewma > 0 and grad_norm > cfg.grad_norm_factor * self._grad_ewma:
                alerts.append({
                    "kind": "grad_norm_explosion",
                    "value": grad_norm,
                    "threshold": cfg.grad_norm_factor * self._grad_ewma,
                    "detail": f"ewma_grad_norm={self._grad_ewma:.6g}",
                })

        if finite:
            # EWMA update (mean + variance via the standard recurrence);
            # skipped on nonfinite steps so one NaN can't poison the stats.
            a = cfg.ewma_alpha
            delta = loss - self._loss_mean
            self._loss_mean += a * delta
            self._loss_var = (1.0 - a) * (self._loss_var + a * delta * delta)
            self._grad_ewma = grad_norm if self._n == 0 else (
                (1.0 - a) * self._grad_ewma + a * grad_norm)
            self._n += 1

        if self.registry is not None:
            try:
                self.registry.gauge("health_loss", help="last observed loss").set(loss)
                self.registry.gauge(
                    "health_grad_norm", help="last observed global grad L2 norm"
                ).set(grad_norm)
                self.registry.gauge(
                    "health_nan_latched", help="1 once any nonfinite value was seen"
                ).set(1 if self.nan_latched else 0)
            except Exception:
                logger.exception("health gauge update failed")

        for alert in alerts:
            alert["step"] = int(step)
            alert["actions"] = self._run_actions(alert, state)
            self.alerts.append(alert)
            if len(self.alerts) > self.config.max_alerts:
                del self.alerts[: len(self.alerts) - self.config.max_alerts]
            if self.registry is not None:
                self.registry.counter(
                    "health_alerts_total", help="health anomalies detected"
                ).inc()
            if self.telemetry is not None:
                try:
                    self.telemetry.on_health_alert(
                        step=int(step), kind=alert["kind"], value=alert["value"],
                        threshold=alert["threshold"], detail=alert["detail"],
                        actions=alert["actions"],
                    )
                except Exception:
                    logger.exception("health_alert emission failed")
        if alerts or nonfinite > 0 or not finite:
            self._clean_streak = 0
            self._rearmed = False
        else:
            self._clean_streak += 1
            if (
                not self._rearmed
                and self.config.rearm_windows is not None
                and self._clean_streak >= self.config.rearm_windows
            ):
                self.rearm()
        return alerts

    # -- stabilization / re-arm ----------------------------------------------

    def stabilized(self, n_windows: int) -> bool:
        """True once ``n_windows`` consecutive clean (finite, alert-free)
        observations have accumulated since the last anomaly — the signal
        the autopilot's precision re-promotion and the auto-re-arm key off.
        A monitor that has never observed anything is not stabilized."""
        return self._clean_streak >= max(1, int(n_windows))

    def rearm(self) -> None:
        """Re-arm latched state after a clean stretch: clear the NaN latch
        and call ``rearm()`` on every registered action that has one
        (``SnapshotOnAnomalyAction`` un-fires; actions without the method
        are untouched).  Called automatically once ``config.rearm_windows``
        clean observations accumulate, or explicitly by a controller that
        watched :meth:`stabilized`."""
        self.nan_latched = False
        self._rearmed = True
        for action in self.actions:
            rearm = getattr(action, "rearm", None)
            if rearm is None:
                continue
            try:
                rearm()
            except Exception:
                name = getattr(action, "name", type(action).__name__)
                logger.exception("health action %s failed to rearm", name)

    def _run_actions(self, alert: Dict, state) -> List[str]:
        applied = []
        for action in self.actions:
            name = getattr(action, "name", type(action).__name__)
            try:
                if action(alert, state):
                    applied.append(name)
            except Exception:
                logger.exception("health action %s failed on %s", name, alert["kind"])
        return applied

    def report(self) -> Dict:
        return {
            "observed_steps": self._n,
            "nan_latched": self.nan_latched,
            "alerts": list(self.alerts),
            "ewma_loss": self._loss_mean,
            "ewma_grad_norm": self._grad_ewma,
            "clean_streak": self._clean_streak,
        }


class PrecisionDemotionAction:
    """Demote every bucket one rung on the wire-precision ladder
    (int4→int8, int8→f32) via ``apply_precision_plan`` — the corrective the
    planner's guardrail allow-list deliberately left to a human; the
    health monitor now closes that loop.  No-op (returns False) when the
    algorithm has no precision knob, everything is already f32, or the
    precision is user-pinned (a uniform ``wire_precision="int8"`` is an
    explicit operator choice — only planner-chosen per-bucket plans under
    ``"auto"`` are demotable, the same rule ``set_bucket_precision``
    enforces)."""

    name = "precision_demotion"
    DEMOTE = {"int4": "int8", "int8": "f32"}

    def __init__(self, ddp):
        self.ddp = ddp

    def __call__(self, alert: Dict, state=None) -> bool:
        ddp = self.ddp
        impl = getattr(ddp, "impl", None)
        if ddp.plan is None or impl is None or not hasattr(impl, "bucket_precisions"):
            return False
        try:
            current = list(impl.bucket_precisions(ddp.plan))
        except Exception:
            logger.exception("precision demotion: could not read bucket precisions")
            return False
        demoted = [self.DEMOTE.get(p, p) for p in current]
        if demoted == current:
            return False
        try:
            return bool(ddp.apply_precision_plan(
                demoted, reason=f"health:{alert.get('kind', 'anomaly')}"))
        except (AttributeError, ValueError) as e:
            # no precision knob, or user-pinned precision: not ours to touch
            logger.debug("precision demotion not applicable: %s", e)
            return False


class SnapshotOnAnomalyAction:
    """Blocking snapshot of the training state on the *first* anomaly
    (``kind="anomaly"`` in the snapshot store), so a diverging run leaves a
    restorable point from before the damage compounds.  Fires once."""

    name = "snapshot_on_anomaly"

    def __init__(self, snapshotter):
        self.snapshotter = snapshotter
        self.fired = False

    def rearm(self) -> None:
        """Allow the next anomaly (after a clean stretch) its own snapshot —
        called by ``HealthMonitor.rearm`` once the run re-stabilizes."""
        self.fired = False

    def __call__(self, alert: Dict, state=None) -> bool:
        if self.fired or state is None or self.snapshotter is None:
            return False
        self.fired = True
        self.snapshotter.snapshot(state, int(alert.get("step", 0)),
                                  blocking=True, kind="anomaly")
        return True
