"""High-level training loop (the port of ``bagua_tpu/trainer.py``): the fit
loop with its observability (telemetry, health monitor, hang watchdog, one
profiler capture).  Checkpoints, snapshots, autotune, the autopilot and
the gang aggregator come with ROADMAP Queue 1 items 7 and 9."""

import logging
from typing import Callable, Iterable, Optional, Tuple

from bagua_tpu_torch.algorithms.base import Algorithm
from bagua_tpu_torch.ddp import DistributedDataParallel, TrainState
from bagua_tpu_torch.observability.core import ProfilerSession, StepTimer, Watchdog, _synchronize
from bagua_tpu_torch.utils import tree_leaves

logger = logging.getLogger(__name__)


class Trainer:
    """Minimal fit loop over :class:`~bagua_tpu_torch.ddp.DistributedDataParallel`.

    ``loss_fn``, ``optimizer``, ``algorithm``, ``process_group``,
    ``bucket_size_bytes``, ``overlap``, ``telemetry`` and ``health_monitor``
    are as for the engine (overlap ``"auto"`` by default, as the JAX
    ``Trainer``; ``overlap=False`` pins the monolithic step), and so are
    ``dp_axis``, ``fsdp_axis`` and ``tp_axis``, checked against the group's
    mesh axes.  After :meth:`fit`, ``self.losses`` holds the last step's
    per-rank losses.

    Args:
        telemetry: a :class:`~bagua_tpu_torch.observability.telemetry.Telemetry`
            hub, passed to the engine.  The fit loop also tags the
            watchdog's heartbeats with its phase (``data`` while pulling the
            next batch) and points the watchdog's hang dump at the hub's
            snapshot, flight recorder and ``hang`` event.
        health_monitor: a
            :class:`~bagua_tpu_torch.observability.health.HealthMonitor`,
            passed to the engine.
        watchdog_timeout_s: the hang detector's timeout (0, the default,
            disables it; ``BAGUA_WATCHDOG_TIMEOUT_S`` in the environment
            overrides a non-zero value).  The JAX ``Trainer`` starts one
            at 300 s by default; the port leaves it to the caller, because
            a watchdog that a caller never closes kills its process 300 s
            after its last step.
        profile_dir: if set, captures ONE ``torch.profiler`` trace of fit
            loop iterations ``[profile_steps[0], profile_steps[1])``
            (half-open; by default iterations 10-12) into this directory
            (:class:`~bagua_tpu_torch.observability.core.ProfilerSession`;
            the file is ``self.profile_path``).  One capture per Trainer,
            even across several ``fit()`` calls; a window cut short by the
            end of the batches is closed and kept.
        gang_window: the JAX ``Trainer``'s cross-rank step summaries and
            flight digests go through the rendezvous KV client, which comes
            with ROADMAP Queue 1 item 7; a value above 0 raises.
    """

    def __init__(self, loss_fn: Callable, optimizer: Callable, algorithm: Algorithm, process_group=None,
                 bucket_size_bytes: Optional[int] = None, overlap="auto", dp_axis=None, fsdp_axis=None,
                 tp_axis=None, telemetry=None, health_monitor=None, watchdog_timeout_s: float = 0.0,
                 profile_dir: Optional[str] = None, profile_steps: Tuple[int, int] = (10, 13),
                 gang_window: int = 0):
        if gang_window > 0:
            raise NotImplementedError(
                "gang_window needs the rendezvous KV client, which is not ported yet "
                "(ROADMAP Queue 1 item 7)"
            )
        self.ddp = DistributedDataParallel(
            loss_fn, optimizer, algorithm, process_group=process_group,
            bucket_size_bytes=bucket_size_bytes, overlap=overlap,
            telemetry=telemetry, health_monitor=health_monitor,
            dp_axis=dp_axis, fsdp_axis=fsdp_axis, tp_axis=tp_axis,
        )
        self.telemetry = telemetry
        self.health_monitor = health_monitor
        self.losses = None
        self.timer = StepTimer(speed_meter=self.ddp.speed_meter)
        self.watchdog = Watchdog(watchdog_timeout_s).start() if watchdog_timeout_s > 0 else None
        if self.watchdog is not None and telemetry is not None:
            telemetry.bind_watchdog(self.watchdog)
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        self.profile_path: Optional[str] = None
        self._profiler: Optional[ProfilerSession] = None
        self._profiled = False
        self._closed = False

    def close(self) -> None:
        """Release background machinery: the profiler, the hang watchdog,
        the telemetry's buffers and the algorithm's background machinery
        (the async averager's thread).  Idempotent, and every teardown runs
        even when an earlier one fails."""
        if self._closed:
            return
        self._closed = True
        for what, teardown in (
            ("profiler", self._stop_profiler),
            ("watchdog", lambda: self.watchdog and self.watchdog.stop()),
            ("telemetry", lambda: self.telemetry and self.telemetry.flush()),
            ("ddp", self.ddp.shutdown),
        ):
            try:
                teardown()
            except Exception:
                logger.exception("error closing %s (continuing teardown)", what)

    def _stop_profiler(self) -> None:
        if self._profiler is not None:
            _synchronize()
            self._profiler.stop()
            self.profile_path = self._profiler.trace_path
            self._profiler = None
            logger.info("profiler trace captured to %s", self.profile_path)

    def init_state(self, params) -> TrainState:
        return self.ddp.init(params)

    def fit(self, state: TrainState, batches: Iterable, n_steps: Optional[int] = None,
            log_every: int = 100) -> TrainState:
        """Run the training loop; returns the final state."""
        for i, batch in enumerate(batches):
            if n_steps is not None and i >= n_steps:
                break
            if self.profile_dir is not None and i == self.profile_steps[0] and not self._profiled:
                _synchronize()  # a clean capture window
                self._profiler = ProfilerSession(self.profile_dir)
                self._profiler.start()
                self._profiled = True
            n_samples = tree_leaves(batch)[0].shape[0]
            with self.timer.step(n_samples):
                state, self.losses = self.ddp.train_step(state, batch)
            if self._profiler is not None and i == self.profile_steps[1] - 1:
                self._stop_profiler()
            if self.watchdog is not None:
                self.watchdog.beat()
            if log_every and state.step % log_every == 0:
                logger.info(
                    "step %d loss %.5f (%.1f samples/s)", state.step,
                    float(self.losses.mean()), self.ddp.speed_meter.speed(30.0),
                )
            if self.telemetry is not None:
                # about to pull the next batch: a hang here is the input
                # pipeline's, not the card's
                self.telemetry.enter_phase("data")
        # the batches ended inside the capture window: close it here
        self._stop_profiler()
        return state
