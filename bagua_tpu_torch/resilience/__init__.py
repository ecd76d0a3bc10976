"""Resilience (the port of ``bagua_tpu/resilience/``): so far the retry
policy and circuit breaker that the observability hub and the gang
aggregator use (:mod:`bagua_tpu_torch.resilience.retry`, a copy).  The
snapshotter, the preemption watcher and the elastic resume come with the
checkpoint layer (ROADMAP Queue 1 item 7)."""

from bagua_tpu_torch.resilience.retry import (
    CircuitBreaker,
    CircuitOpenError,
    RetryPolicy,
    retry_call,
    seed_backoff,
)

__all__ = ["CircuitBreaker", "CircuitOpenError", "RetryPolicy", "retry_call", "seed_backoff"]
