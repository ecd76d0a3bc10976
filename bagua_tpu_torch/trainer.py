"""High-level training loop (the port of ``bagua_tpu/trainer.py``): the fit
loop with its observability (telemetry, health monitor, hang watchdog, one
profiler capture, the gang view), its resilience (async snapshots, the
preemption drain, the elastic resume, checkpoints), the autotune session
and the gang autopilot."""

import logging
import os
import time
from typing import Callable, Iterable, Optional, Tuple

from bagua_tpu_torch.algorithms.base import Algorithm
from bagua_tpu_torch.ddp import AutotuneSession, DistributedDataParallel, TrainState, state_leaves
from bagua_tpu_torch.env import get_node_rank, get_rank, get_world_size
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
            snapshot, flight recorder and ``hang`` event; the dump pushes
            the flight digest through the rendezvous KV when there is one.
        health_monitor: a
            :class:`~bagua_tpu_torch.observability.health.HealthMonitor`,
            passed to the engine.  With a snapshotter as well, the first
            anomaly takes a blocking snapshot of the pre-divergence state
            (:class:`~bagua_tpu_torch.observability.health.SnapshotOnAnomalyAction`).
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
        gang_window: if > 0 (with a telemetry hub), every ``gang_window``
            fit steps this process pushes its step summary through the
            rendezvous KV and process 0 exports the joined gang view
            (:class:`~bagua_tpu_torch.observability.aggregate.GangAggregator`,
            best effort: without a KV, as on one controller, the view is
            local-only).
        ckpt_dir: if set, a checkpoint every ``ckpt_interval`` steps
            (:func:`~bagua_tpu_torch.checkpoint.save_checkpoint`), and
            :meth:`init_state` resumes from the latest one when no snapshot
            was resumed.
        snapshot_dir: if set, the state is snapshotted every
            ``snapshot_every`` steps off the critical path
            (:class:`~bagua_tpu_torch.resilience.AsyncSnapshotter`, keeping
            ``snapshot_keep``; ``BAGUA_SNAPSHOT_EVERY`` overrides the
            cadence), a SIGTERM watcher is installed (on the main thread;
            elsewhere ``self.preemption.trigger()`` only) that makes
            :meth:`fit` drain the step, force a final snapshot and leave a
            resumable marker (``self.preempted``), and :meth:`init_state`
            resumes from the newest complete snapshot, carrying its bucket
            plan over (``self.resume_result``).
        autotune_model_name: if set, an
            :class:`~bagua_tpu_torch.ddp.AutotuneSession` runs the
            report / ask / re-bucket cycle against the autotune service the
            environment names (``AUTO_TUNE_SERVER_ADDR``, or
            ``MASTER_ADDR`` and ``BAGUA_SERVICE_PORT``).
        autopilot: opt-in
            :class:`~bagua_tpu_torch.autopilot.GangAutopilot` bound to this
            trainer's engine (or a callable taking the engine and returning
            one).  The fit loop ticks it once per step with the step's mean
            loss; the controller may switch the gang's algorithm or
            precision (the state it returns replaces the loop's), each move
            statically verified before dispatch under
            ``BAGUA_STATIC_VERIFY``.

    The best-effort paths are the JAX ``Trainer``'s, and log a warning: a
    snapshot resume that fails starts fresh, an autotune service that
    cannot be reached disables tuning, and the gang view degrades to
    local-only.
    """

    def __init__(self, loss_fn: Callable, optimizer: Callable, algorithm: Algorithm, process_group=None,
                 bucket_size_bytes: Optional[int] = None, overlap="auto", dp_axis=None, fsdp_axis=None,
                 tp_axis=None, telemetry=None, health_monitor=None, watchdog_timeout_s: float = 0.0,
                 profile_dir: Optional[str] = None, profile_steps: Tuple[int, int] = (10, 13),
                 gang_window: int = 0, ckpt_dir: Optional[str] = None, ckpt_interval: int = 1000,
                 snapshot_dir: Optional[str] = None, snapshot_every: int = 10, snapshot_keep: int = 2,
                 autotune_model_name: Optional[str] = None, autopilot=None):
        self.ddp = DistributedDataParallel(
            loss_fn, optimizer, algorithm, process_group=process_group,
            bucket_size_bytes=bucket_size_bytes, overlap=overlap,
            telemetry=telemetry, health_monitor=health_monitor,
            dp_axis=dp_axis, fsdp_axis=fsdp_axis, tp_axis=tp_axis,
        )
        self.telemetry = telemetry
        self.health_monitor = health_monitor
        if callable(autopilot) and not hasattr(autopilot, "tick"):
            autopilot = autopilot(self.ddp)
        elif autopilot is not None:
            autopilot.ddp = self.ddp
        self.autopilot = autopilot
        self.losses = None
        self.gang_window = int(gang_window)
        self.gang = None  # built in init_state
        self.ckpt_dir = ckpt_dir
        self.ckpt_interval = ckpt_interval
        self.autotune_model_name = autotune_model_name
        self._session: Optional[AutotuneSession] = None
        self.timer = StepTimer(speed_meter=self.ddp.speed_meter)
        self.watchdog = Watchdog(watchdog_timeout_s).start() if watchdog_timeout_s > 0 else None
        if self.watchdog is not None and telemetry is not None:
            telemetry.bind_watchdog(self.watchdog)
            if self.watchdog.digest_pusher is None:
                self.watchdog.digest_pusher = self._push_flight_digest
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        self.profile_path: Optional[str] = None
        self._profiler: Optional[ProfilerSession] = None
        self._profiled = False
        self.snapshot_dir = snapshot_dir
        self.snapshotter = None
        self.preemption = None
        self.preempted = False
        #: the drain's wall time (the flight dump, the final snapshot and
        #: the marker), set by a preemption
        self.drain_ms: Optional[float] = None
        self.resume_result = None
        self._closed = False
        if snapshot_dir:
            from bagua_tpu_torch.env import get_snapshot_every
            from bagua_tpu_torch.resilience import AsyncSnapshotter, PreemptionWatcher

            self.snapshotter = AsyncSnapshotter(
                snapshot_dir, get_snapshot_every() or snapshot_every,
                leaves_fn=state_leaves,
                world_size=self.ddp.group.size,
                # each process writes its own ranks' rows (proc<p>.npz)
                process_index=self.ddp.group.process_index,
                num_processes=self.ddp.group.process_count,
                telemetry=telemetry,
                keep=snapshot_keep,
                # the live bucket plan rides every manifest, so a resume
                # never cold-starts the planner
                manifest_extra_fn=lambda: {"plan": self.ddp.export_plan_payload()},
            )
            if health_monitor is not None:
                from bagua_tpu_torch.observability.health import SnapshotOnAnomalyAction

                health_monitor.register_action(SnapshotOnAnomalyAction(self.snapshotter))
            self.preemption = PreemptionWatcher()
            try:
                self.preemption.install()
            except ValueError:
                # signal handlers install on the main thread only
                logger.warning("not on the main thread: the preemption watcher responds to "
                               "trigger() only, not SIGTERM")

    def close(self) -> None:
        """Release background machinery: the profiler, the snapshotter, the
        preemption handler, the hang watchdog, the telemetry's buffers and
        the algorithm's background machinery (the async averager's thread).
        Idempotent, and every teardown runs even when an earlier one
        fails."""
        if self._closed:
            return
        self._closed = True
        for what, teardown in (
            ("profiler", self._stop_profiler),
            ("snapshotter", lambda: self.snapshotter and self.snapshotter.close()),
            ("preemption watcher", lambda: self.preemption and self.preemption.uninstall()),
            ("watchdog", lambda: self.watchdog and self.watchdog.stop()),
            ("telemetry", lambda: self.telemetry and self.telemetry.flush()),
            ("ddp", self.ddp.shutdown),
        ):
            try:
                teardown()
            except Exception:
                logger.exception("error closing %s (continuing teardown)", what)

    def __enter__(self) -> "Trainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _stop_profiler(self) -> None:
        if self._profiler is not None:
            _synchronize()
            self._profiler.stop()
            self.profile_path = self._profiler.trace_path
            self._profiler = None
            logger.info("profiler trace captured to %s", self.profile_path)

    def init_state(self, params=None, stacked_params=None) -> TrainState:
        """The engine's initial state, replaced by the newest complete
        snapshot (``snapshot_dir``) or else the latest checkpoint
        (``ckpt_dir``) when there is one; then the autotune session and the
        gang aggregator."""
        state = self.ddp.init(params, stacked_params=stacked_params)
        resumed = False
        if self.snapshotter is not None:
            from bagua_tpu_torch.resilience import ElasticResumeCoordinator

            coordinator = ElasticResumeCoordinator(
                self.snapshotter.store, rendezvous_client=self._rendezvous_client(),
                telemetry=self.telemetry,
            )
            try:
                result = coordinator.resume(self.ddp, state, nonce=os.environ.get("BAGUA_ATTEMPT", "0"))
            except Exception as e:
                logger.warning("snapshot resume failed (%s); starting fresh", e)
                # the attempt may have adopted the snapshot's bucket plan:
                # build the state again, on a fresh plan
                state, result = self.ddp.init(params, stacked_params=stacked_params), None
            if result is not None:
                state, resumed = result.state, True
                self.resume_result = result
        if not resumed and self.ckpt_dir:
            from bagua_tpu_torch.checkpoint import get_latest_iteration, load_checkpoint

            if get_latest_iteration(self.ckpt_dir) is not None:
                state, it = load_checkpoint(self.ckpt_dir, target=state)
                self.ddp._host_step = state.step
                logger.info("resumed from checkpoint at iteration %d", it)
        if self.snapshotter is not None and self.snapshotter.every > 0:
            # pin the host buffers now, not at the first cadence tick
            self.snapshotter.prepare(state)
        if self.autotune_model_name:
            try:
                self._session = AutotuneSession(self.ddp, self.autotune_model_name)
            except Exception as e:  # the service is not reachable: train without tuning
                logger.warning("autotune disabled: %s", e)
        if self.gang_window > 0 and self.telemetry is not None and self.gang is None:
            from bagua_tpu_torch.observability.aggregate import GangAggregator

            # a None client (no endpoint, one process) runs local-only
            self.gang = GangAggregator(self._rendezvous_client(), rank=get_rank(),
                                       world_size=get_world_size(), window=self.gang_window,
                                       registry=self.telemetry.registry)
        return state

    def _rendezvous_client(self):
        """A store client for the cross-rank agreements, when the launcher
        exported an endpoint (``BAGUA_RDZV_ENDPOINT``) and the job spans
        processes."""
        endpoint = os.environ.get("BAGUA_RDZV_ENDPOINT")
        if not endpoint or get_world_size() <= 1:
            return None
        try:
            from bagua_tpu_torch.distributed.rendezvous import RendezvousClient

            return RendezvousClient(endpoint, node_rank=get_node_rank())
        except Exception as e:
            logger.warning("rendezvous client unavailable (%s)", e)
            return None

    def _push_flight_digest(self) -> bool:
        """Best-effort push of this process's flight-ring digest through the
        rendezvous KV: the watchdog's evidence dump and the preemption
        drain call it."""
        fr = getattr(self.telemetry, "flight", None) if self.telemetry else None
        if fr is None:
            return False
        from bagua_tpu_torch.observability.flight_recorder import push_flight_digest

        return push_flight_digest(self._rendezvous_client(), fr)

    def fit(self, state: TrainState, batches: Iterable, n_steps: Optional[int] = None,
            log_every: int = 100) -> TrainState:
        """Run the training loop; returns the final state (the drained one
        after a preemption, with ``self.preempted`` set)."""
        for i, batch in enumerate(batches):
            if n_steps is not None and i >= n_steps:
                break
            if self._session is not None and not self._session.profiled:
                # the one-time measured gradient-arrival order for autotune
                try:
                    self._session.profile_and_report(state, batch)
                except Exception as e:
                    logger.warning("bucket-order profiling failed: %s", e)
                    self._session.profiled = True
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
            if self._session is not None:
                self._session.tick(n_samples)
            step = state.step
            if self.autopilot is not None:
                # the controller may remap the state (an algorithm switch);
                # the mean loss feeds its canary parity check
                state = self.autopilot.tick(state, step, float(self.losses.mean()))
            if self.snapshotter is not None:
                self.snapshotter.maybe_snapshot(state, step)
            if self.gang is not None:
                # window-cadenced and best effort
                ov = self.ddp.host_overhead
                denom = max(1, int(ov.get("steps", 1)))
                self.gang.tick(step, self.telemetry,
                               phase_ms={k: 1e3 * v / denom for k, v in ov.items() if k != "steps"})
            if self.preemption is not None and self.preemption.should_stop():
                self._drain_and_exit(state, step)
                return state
            if self.ckpt_dir and step % self.ckpt_interval == 0:
                from bagua_tpu_torch.checkpoint import save_checkpoint

                save_checkpoint(step, self.ckpt_dir, state)
            if log_every and step % log_every == 0:
                logger.info(
                    "step %d loss %.5f (%.1f samples/s)", step,
                    float(self.losses.mean()), self.ddp.speed_meter.speed(30.0),
                )
            if self.telemetry is not None:
                # about to pull the next batch: a hang here is the input
                # pipeline's, not the card's
                self.telemetry.enter_phase("data")
        # the batches ended inside the capture window: close it here
        self._stop_profiler()
        return state

    def _drain_and_exit(self, state: TrainState, step: int) -> None:
        """The preemption path: the in-flight step has completed (the loop
        polls between steps), so dump the flight ring, push its digest,
        force a synchronous final snapshot and leave a resumable marker:
        the restarted gang loses no step instead of up to K."""
        from bagua_tpu_torch.resilience import write_resumable_marker

        t0 = time.perf_counter()
        logger.warning("preemption signal received: draining at step %d", step)
        if self.telemetry is not None:
            # the goodput ledger charges the rest (the final snapshot) to drain
            self.telemetry.enter_phase("drain")
            fr = getattr(self.telemetry, "flight", None)
            if fr is not None:
                try:
                    from bagua_tpu_torch.env import get_dump_dir
                    from bagua_tpu_torch.observability.flight_recorder import flight_dump_path

                    fr.dump(flight_dump_path(get_dump_dir(), fr.rank), reason="sigterm",
                            telemetry=self.telemetry.snapshot())
                    self._push_flight_digest()
                except Exception:
                    logger.exception("flight dump on preemption failed")
        try:
            self.snapshotter.force_snapshot(state, step)
            write_resumable_marker(self.snapshot_dir, step)
        except Exception:
            logger.exception("final snapshot failed; the newest complete snapshot still bounds the lost work")
        self.preempted = True
        self.drain_ms = (time.perf_counter() - t0) * 1e3
