"""Resilience: preemption-aware async snapshots and elastic resume (the
port of ``bagua_tpu/resilience/``).  Four pieces:

* :class:`AsyncSnapshotter` / :class:`SnapshotStore`: double-buffered
  device-to-host copies of the train state every K steps, off the critical
  path, with atomic (write-temp and rename) manifests;
* :class:`PreemptionWatcher`: SIGTERM -> drain the in-flight step, force a
  final snapshot, exit with a resumable marker;
* :class:`ElasticResumeCoordinator`: ranks agree on the newest complete
  snapshot, remap it into the (possibly resized) gang and carry the tuned
  bucket plan over;
* :func:`retry_call` / :class:`CircuitBreaker`: jittered exponential
  retries with circuit breaking for the autotune and rendezvous RPCs.
"""

from bagua_tpu_torch.resilience.preemption import (
    RESUMABLE_MARKER,
    PreemptionWatcher,
    clear_resumable_marker,
    read_resumable_marker,
    write_resumable_marker,
)
from bagua_tpu_torch.resilience.resume import ElasticResumeCoordinator, ResumeResult
from bagua_tpu_torch.resilience.retry import (
    CircuitBreaker,
    CircuitOpenError,
    RetryPolicy,
    retry_call,
    seed_backoff,
)
from bagua_tpu_torch.resilience.snapshot import MANIFEST_FILENAME, AsyncSnapshotter, SnapshotStore

__all__ = [
    "AsyncSnapshotter",
    "SnapshotStore",
    "MANIFEST_FILENAME",
    "PreemptionWatcher",
    "RESUMABLE_MARKER",
    "write_resumable_marker",
    "read_resumable_marker",
    "clear_resumable_marker",
    "ElasticResumeCoordinator",
    "ResumeResult",
    "RetryPolicy",
    "CircuitBreaker",
    "CircuitOpenError",
    "retry_call",
    "seed_backoff",
]
