"""Tracing, metrics and hang detection (the port of the JAX package's
``observability/core.py``).

The analog of the reference's auxiliary subsystems (SURVEY §5.1-5.2):

* **Spans** (reference: Rust OTel ``tensor_ready`` spans POSTed to the
  autotune server, ``bagua-opentelemetry/src/exporter/mod.rs:15-62``): a
  host-side :class:`SpanRecorder` collects ``(action, tensor_name, start,
  end)`` records — e.g. bucket execution order measured on the step —
  and ships them to the autotune service to learn tensor ordering.
* **Step timing** (reference: CUDA-event pairs + ``StatisticalAverage``,
  ``bagua_distributed.py:113-131``): :class:`StepTimer` feeds step wall
  times into the engine's ``SpeedMeter``.
* **Hang watchdog** (reference: comm monitor thread panicking after 300 s,
  ``src/lib.rs:255-265``, and the panic→process-exit hook,
  ``bagua-core-py/src/lib.rs:547-553``): :class:`Watchdog` kills the process
  with a full thread dump if no heartbeat arrives within the timeout, so a
  wedged worker can't hang a gang-scheduled job.
* **Device traces**: :class:`ProfilerSession` captures
  ``torch.profiler`` traces (host ops and CUDA kernels) as Chrome traces
  that :mod:`~bagua_tpu_torch.observability.trace_analysis` reads.
"""

import faulthandler
import logging
import math
import os
import sys
import threading
import time
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)


class SpanRecorder:
    """Collects spans; thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self.spans: List[Dict] = []

    def record(self, action: str, tensor_name: str, start_time: float, end_time: float):
        with self._lock:
            self.spans.append(
                {
                    "action": action,
                    "tensor_name": tensor_name,
                    "start_time": start_time,
                    "end_time": end_time,
                }
            )

    def record_measured_order(self, plan, bucket_times) -> None:
        """Convert measured per-bucket readiness costs (seconds, aligned with
        ``plan.specs`` — see ``DistributedDataParallel.profile_bucket_order``)
        into ``tensor_ready`` spans: a tensor's start time is its bucket's
        measured cost, with a sub-microsecond offset keeping slots within a
        bucket in a stable order.  The autotune service sorts by start time,
        so cheap (early-ready) buckets come first."""
        for spec, cost in zip(plan.specs, bucket_times):
            for j, slot in enumerate(spec.slots):
                start = cost + j * 1e-9
                self.record("tensor_ready", slot.name, start, start + 1e-9)

    def record_wire_timings(
        self, plan, analysis: Dict, intra_size: int = 1, hierarchical: bool = False,
        leg: Optional[str] = None,
    ) -> None:
        """Convert a device-trace analysis
        (:func:`~bagua_tpu_torch.observability.trace_analysis.analyze_trace`) into
        ``bucket_wire`` spans — the planner's α–β cost-model input.  Each
        attributed per-bucket row becomes one sample carrying the bucket's
        wire bytes (from the plan), measured collective seconds and hidden
        fraction; hierarchical captures tag the leg so intra/inter paths are
        fitted separately.  An explicit ``leg`` overrides the tag — sharded
        exchanges pass ``"rs"``/``"ag"`` so the planner fits the
        reduce-scatter and all-gather wire paths independently."""
        for row in analysis.get("per_bucket", []):
            bi = row.get("bucket")
            if bi is None or bi >= len(plan.specs):
                continue
            seconds = float(row.get("collective_ms", 0.0)) / 1e3
            if seconds <= 0.0:
                continue
            with self._lock:
                self.spans.append(
                    {
                        "action": "bucket_wire",
                        "tensor_name": f"bucket{bi}",
                        "start_time": 0.0,
                        "end_time": seconds,
                        "nbytes": int(plan.specs[bi].nbytes),
                        "seconds": seconds,
                        "leg": leg or ("intra" if hierarchical else "flat"),
                        "hidden_frac": float(row.get("overlap_frac", 0.0)),
                        "intra_size": int(intra_size),
                    }
                )

    def drain(self) -> List[Dict]:
        with self._lock:
            out, self.spans = self.spans, []
        return out

    def report_to_autotune(self, client, model_name: str) -> None:
        spans = self.drain()
        if spans:
            client.report_tensor_execution_order(model_name, spans)


class StepTimer:
    """Times steps; feeds a SpeedMeter and keeps simple aggregates.

    Use ``with timer.step(n_samples): ...`` around dispatch+wait, or call
    ``tick`` manually.  ``tick`` is thread-safe (the async averager's
    background thread and the fit loop may both time work), and the last
    ``window`` step times are kept in a ring buffer so
    :meth:`percentiles` can report p50/p95/p99 tail latency — the number
    that catches a stalling input pipeline or a periodic retrace long
    before the mean moves.
    """

    def __init__(self, speed_meter=None, window: int = 1024):
        self.speed_meter = speed_meter
        self.n_steps = 0
        self.total_time = 0.0
        self.last_step_time = 0.0
        self._lock = threading.Lock()
        self._ring = [0.0] * max(1, window)
        self._ring_n = 0  # total ticks ever; ring holds the last len(_ring)

    class _Ctx:
        def __init__(self, timer, n_samples):
            self.timer = timer
            self.n_samples = n_samples

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.timer.tick(time.perf_counter() - self.t0, self.n_samples)
            return False

    def step(self, n_samples: int = 0) -> "_Ctx":
        return StepTimer._Ctx(self, n_samples)

    def tick(self, elapsed: float, n_samples: int = 0) -> None:
        with self._lock:
            self.n_steps += 1
            self.total_time += elapsed
            self.last_step_time = elapsed
            self._ring[self._ring_n % len(self._ring)] = elapsed
            self._ring_n += 1
        if self.speed_meter is not None and n_samples:
            self.speed_meter.record(n_samples)

    @property
    def mean_step_time(self) -> float:
        return self.total_time / self.n_steps if self.n_steps else 0.0

    def percentiles(self) -> Dict[str, float]:
        """p50/p95/p99 over the ring-buffered recent step times (seconds);
        empty dict until the first tick.  Nearest-rank indexing: the p-th
        percentile of n samples is the ``ceil(p*n)``-th smallest, so the
        p50 of a 2-sample ring is the *lower* sample (the old ``int(p*n)``
        truncation returned the max)."""
        with self._lock:
            n = min(self._ring_n, len(self._ring))
            recent = sorted(self._ring[:n]) if n else []
        if not recent:
            return {}
        def q(p):
            n = len(recent)
            return recent[min(n - 1, max(0, math.ceil(p * n) - 1))]
        return {"p50": q(0.50), "p95": q(0.95), "p99": q(0.99)}


class Watchdog:
    """Fail-fast hang detector.

    Call :meth:`beat` at least every ``timeout_s`` seconds (typically once
    per training step).  If the heartbeat stops — a wedged collective, a
    deadlocked host thread — the watchdog dumps every thread's stack and
    kills the process (exit code 42), letting the launcher's restart logic
    take over.  ``on_timeout`` can override the kill for tests.

    ``BAGUA_WATCHDOG_TIMEOUT_S`` in the environment overrides ``timeout_s``
    (an operator knob for gang-scheduled jobs whose launch script can't be
    edited).  ``beat(phase=...)`` tags each heartbeat with the step phase
    the host was in (``dispatch``/``wait``/``data``), and
    ``snapshot_provider`` — a zero-arg callable returning a dict, normally
    :meth:`Telemetry.snapshot <bagua_tpu_torch.observability.telemetry.Telemetry.snapshot>`
    — is queried at timeout so the dump says *where* the step was stuck
    (step number, phase, bucket), not just that it stopped.
    """

    def __init__(self, timeout_s: float = 300.0, check_interval_s: Optional[float] = None,
                 on_timeout=None, snapshot_provider=None):
        env = os.environ.get("BAGUA_WATCHDOG_TIMEOUT_S")
        if env:
            try:
                timeout_s = float(env)
                logger.info("watchdog timeout overridden by BAGUA_WATCHDOG_TIMEOUT_S=%s", env)
            except ValueError:
                logger.warning("ignoring non-numeric BAGUA_WATCHDOG_TIMEOUT_S=%r", env)
        self.timeout_s = timeout_s
        self.check_interval_s = check_interval_s or min(10.0, timeout_s / 3)
        self.on_timeout = on_timeout
        self.snapshot_provider = snapshot_provider
        # Hang-evidence wiring (all optional; see _dump_evidence): where the
        # dumps land (None = BAGUA_DUMP_DIR or CWD), the rank's flight
        # recorder, a hook the telemetry hub binds to emit the ``hang``
        # JSONL event, and a zero-arg digest pusher (rendezvous KV,
        # best-effort) the trainer binds.
        self.dump_dir: Optional[str] = None
        self.flight_recorder = None
        self.hang_hook = None
        self.digest_pusher = None
        self.last_dump_paths: Dict[str, str] = {}
        self.last_phase: Optional[str] = None
        self._last_beat = time.monotonic()
        self._armed = False
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Watchdog":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True, name="bagua-watchdog")
            self._thread.start()
        return self

    def beat(self, phase: Optional[str] = None) -> None:
        if phase is not None:
            self.last_phase = phase
        self._last_beat = time.monotonic()
        self._armed = True

    def stop(self) -> None:
        self._stopped.set()

    def _timeout_context(self) -> Dict:
        """What the host was doing when the heartbeat stopped."""
        ctx: Dict = {"last_phase": self.last_phase}
        if self.snapshot_provider is not None:
            try:
                ctx["telemetry"] = self.snapshot_provider()
            except Exception as e:  # the dump must never be lost to a bad hook
                ctx["telemetry_error"] = f"{type(e).__name__}: {e}"
        return ctx

    def _dump_evidence(self, silent: float, ctx: Dict) -> Dict[str, str]:
        """Persist the hang's evidence before any exit path: an atomic
        ``watchdog_dump.json`` (the timeout context), the rank's flight-
        recorder ring as ``flight_<rank>.json``, the best-effort digest push
        and the hub's ``hang`` JSONL event.  Every stage is fenced — a
        failing disk or KV must not stop the stack dump / process kill."""
        from bagua_tpu_torch.observability.flight_recorder import (
            flight_dump_path, write_json_atomic,
        )

        if self.dump_dir is not None:
            d = self.dump_dir
        else:
            from bagua_tpu_torch.env import get_dump_dir

            d = get_dump_dir()
        paths: Dict[str, str] = {}
        try:
            path = os.path.join(d, "watchdog_dump.json")
            write_json_atomic(path, {
                "reason": "watchdog_timeout",
                "silent_s": round(silent, 3),
                "timeout_s": self.timeout_s,
                "mono_at_dump": time.monotonic(),
                "unix_at_dump": time.time(),
                **ctx,
            })
            paths["watchdog_dump"] = path
        except Exception:
            logger.exception("watchdog dump failed")
        fr = self.flight_recorder
        if fr is not None:
            try:
                path = flight_dump_path(d, fr.rank)
                fr.dump(path, reason="watchdog_timeout",
                        telemetry=ctx.get("telemetry"))
                paths["flight_dump"] = path
            except Exception:
                logger.exception("flight dump failed")
            if self.digest_pusher is not None:
                try:
                    self.digest_pusher()
                except Exception:
                    logger.exception("flight digest push failed")
        if self.hang_hook is not None:
            try:
                self.hang_hook("watchdog_timeout", ctx, paths)
            except Exception:
                logger.exception("hang hook failed")
        self.last_dump_paths = paths
        return paths

    def _run(self) -> None:
        while not self._stopped.wait(self.check_interval_s):
            if not self._armed:
                continue
            silent = time.monotonic() - self._last_beat
            if silent > self.timeout_s:
                ctx = self._timeout_context()
                logger.error(
                    "watchdog: no heartbeat for %.1fs (timeout %.1fs); last known "
                    "position: %s; dumping threads",
                    silent,
                    self.timeout_s,
                    ctx,
                )
                # evidence first — the dump files and the hub's ``hang``
                # event must exist before any exit path (on_timeout or the
                # os._exit below) can erase the scene
                self._dump_evidence(silent, ctx)
                if self.on_timeout is not None:
                    self.on_timeout(silent)
                    self._armed = False
                    continue
                print(f"bagua watchdog timeout context: {ctx}", file=sys.stderr)
                faulthandler.dump_traceback(file=sys.stderr)
                sys.stderr.flush()
                os._exit(42)


class ProfilerSession:
    """A ``torch.profiler`` capture written as a Chrome trace (the JAX
    package's XLA-profiler session; the reference's Jaeger tracing and
    per-op OTel spans, ``bagua-net/src/lib.rs:66-80``).  It records the host
    ops with their ``record_function`` labels and, where CUDA is available,
    every CUDA kernel with the correlation id that joins it to its launch.

        prof = ProfilerSession("/tmp/bagua_trace")
        prof.start()
        ... a few training steps ...
        prof.stop()           # trace at prof.trace_path, under log_dir

    Or scoped::

        with ProfilerSession("/tmp/bagua_trace"):
            state, _ = ddp.train_step(state, batch)

    ``trace_steps(fn, state, batches)`` captures exactly the supplied steps
    with a ``torch.cuda.synchronize()`` on each side (where JAX blocks on
    the state), so device work from outside the window never bleeds into
    the capture.  Each capture writes one new
    ``bagua_trace_<pid>_<n>.json`` into ``log_dir``.
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.trace_path: Optional[str] = None
        self._prof = None
        self._captures = 0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.log_dir, exist_ok=True)
        self._prof = profile(activities=activities)
        self._prof.__enter__()

    def stop(self) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self._captures += 1
        path = os.path.join(self.log_dir, f"bagua_trace_{os.getpid()}_{self._captures}.json")
        prof.export_chrome_trace(path)
        self.trace_path = path

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def trace_steps(self, step_fn, state, batches):
        """Run ``state, aux = step_fn(state, batch)`` over ``batches`` inside
        one clean capture window; returns the final ``(state, aux)``."""
        _synchronize()
        aux = None
        with self:
            for batch in batches:
                state, aux = step_fn(state, batch)
            _synchronize()
        return state, aux


def _synchronize() -> None:
    """Wait for the card's queued work; nothing to wait for without CUDA."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
