"""Preemption watcher: turn SIGTERM into a drained, resumable exit.

Preemptible pools deliver a termination signal with a short grace
window.  The naive outcome is a worker killed mid-step: the newest snapshot
is up to K steps old and anything in flight is lost.  The watcher converts
the signal into a *cooperative* stop:

1. the handler only sets a flag (async-signal-safe; no I/O, no CUDA calls —
   the runtime is not reentrant from a signal context);
2. the training loop polls :meth:`should_stop` once per step, finishes the
   in-flight step (drain), forces a final synchronous snapshot, and writes a
   **resumable marker** before exiting cleanly;
3. the restarted gang (same or different size) finds the marker + the final
   snapshot and resumes with *zero* lost steps instead of up-to-K.

The marker is advisory — resume never requires it (a hard kill leaves no
marker, and the newest complete snapshot still bounds the loss at K) — but
CI asserts it to prove the drain path ran.
"""

import json
import logging
import os
import signal
import threading
import time
from typing import Iterable, Optional

logger = logging.getLogger(__name__)

RESUMABLE_MARKER = "RESUMABLE.json"

__all__ = [
    "PreemptionWatcher",
    "RESUMABLE_MARKER",
    "write_resumable_marker",
    "read_resumable_marker",
    "clear_resumable_marker",
]


class PreemptionWatcher:
    """Installable signal → flag bridge (SIGTERM by default; pass e.g.
    ``(signal.SIGTERM, signal.SIGUSR1)`` for pools that deliver a distinct
    maintenance signal).  Chains any previously installed Python handler so
    stacking watchers (or test harnesses) keeps both behaviors."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._prior = {}
        self._installed = False
        self.signaled_at: Optional[float] = None
        self.signum: Optional[int] = None

    def install(self) -> "PreemptionWatcher":
        """Must run on the main thread (CPython restricts ``signal.signal``);
        idempotent."""
        if self._installed:
            return self
        for sig in self.signals:
            self._prior[sig] = signal.signal(sig, self._handle)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for sig, prior in self._prior.items():
            try:
                signal.signal(sig, prior)
            except (ValueError, TypeError):  # non-main thread / exotic prior
                pass
        self._prior.clear()
        self._installed = False

    def _handle(self, signum, frame) -> None:
        # Flag only — everything else happens on the training thread.
        self.signaled_at = time.monotonic()
        self.signum = signum
        self._event.set()
        prior = self._prior.get(signum)
        if callable(prior):
            prior(signum, frame)

    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    def should_stop(self) -> bool:
        """Poll point for the training loop (one ``Event.is_set`` — ns)."""
        return self._event.is_set()

    def trigger(self) -> None:
        """Programmatic preemption (tests; also lets an orchestrator sidecar
        flip the flag without a signal)."""
        self.signaled_at = time.monotonic()
        self._event.set()


def write_resumable_marker(directory: str, step: int, reason: str = "preempted") -> str:
    """Atomically record that this exit drained + snapshotted and the job can
    be resumed with no lost steps."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, RESUMABLE_MARKER)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(
            {"step": int(step), "reason": reason, "pid": os.getpid(), "ts": time.time()},
            f,
        )
    os.replace(tmp, path)
    logger.info("resumable marker written at step %d (%s)", step, reason)
    return path


def read_resumable_marker(directory: str) -> Optional[dict]:
    try:
        with open(os.path.join(directory, RESUMABLE_MARKER)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def clear_resumable_marker(directory: str) -> None:
    """Resume consumes the marker (it describes the *previous* incarnation)."""
    try:
        os.remove(os.path.join(directory, RESUMABLE_MARKER))
    except OSError:
        pass
