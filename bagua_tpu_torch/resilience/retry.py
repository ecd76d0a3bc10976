"""Jittered-exponential retry + circuit breaking for service RPCs.

The resilience contract for every out-of-process dependency (the autotune
service, the rendezvous store): a *transient* failure is retried with
jittered exponential backoff; a *persistent* failure trips a circuit
breaker so subsequent calls fail fast instead of stacking timeouts — a
flapping sidecar service must degrade the job to its local defaults, never
hang the gang (the reference's autotune client likewise treats the service
as advisory).

Knobs are env-carried like everything else (``bagua_tpu_torch.env``):
``BAGUA_RPC_RETRIES``, ``BAGUA_RPC_BACKOFF_BASE_S``,
``BAGUA_RPC_BACKOFF_MAX_S``, ``BAGUA_RPC_BREAKER_THRESHOLD``,
``BAGUA_RPC_BREAKER_COOLDOWN_S``.
"""

import logging
import random
import threading
import time
from typing import Callable, Optional, Tuple, Type

logger = logging.getLogger(__name__)

__all__ = [
    "CircuitOpenError",
    "BackpressureError",
    "retry_after_hint",
    "CircuitBreaker",
    "RetryPolicy",
    "retry_call",
    "seed_backoff",
    "set_retry_observer",
    "get_retry_observer",
]

#: process-wide backoff jitter source.  Every seedless :class:`RetryPolicy`
#: draws from this one RNG (instead of re-seeding a private ``Random`` per
#: call site), so a test can pin the whole process's retry timing with one
#: :func:`seed_backoff` call.  An explicit ``RetryPolicy(seed=...)`` still
#: gets its own isolated stream.
_backoff_rng = random.Random()


def seed_backoff(seed: Optional[int]) -> None:
    """Re-seed the process-wide backoff jitter RNG (deterministic retry
    timing for tests; ``None`` re-seeds from the OS)."""
    _backoff_rng.seed(seed)


#: process-wide retry observer: ``observer(endpoint, attempt, delay_s,
#: reason, retry_after_s)`` called on every backoff sleep.  The Telemetry
#: hub installs one so retry sleeps — otherwise invisible dead time — land
#: in the metrics/event stream; None (default) keeps retry_call silent.
_retry_observer: Optional[Callable] = None


def set_retry_observer(observer: Optional[Callable]) -> None:
    global _retry_observer
    _retry_observer = observer


def get_retry_observer() -> Optional[Callable]:
    return _retry_observer


class CircuitOpenError(ConnectionError):
    """Raised (fast, no I/O) while a circuit breaker is open."""


class BackpressureError(ConnectionError):
    """The server answered 429: alive but shedding load.

    Carries the server-supplied ``Retry-After`` hint so :func:`retry_call`
    can pace itself to the server's recovery estimate.  Deliberately *not*
    a breaker-counted failure — a 429 proves the service is up, and opening
    the circuit on it would turn transient overload into a full outage for
    this client."""

    def __init__(self, message: str = "backpressure", retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = max(0.0, float(retry_after_s))


def retry_after_hint(exc: BaseException) -> Optional[float]:
    """Extract a server-supplied backpressure hint from an exception.

    Returns the Retry-After delay in seconds, or None when the exception
    carries no backpressure signal.  Understands :class:`BackpressureError`
    (``retry_after_s`` attribute) and raw ``urllib.error.HTTPError`` 429s
    (``Retry-After`` header; absent/garbled headers degrade to 0.0 — still
    backpressure, just no pacing hint)."""
    hint = getattr(exc, "retry_after_s", None)
    if hint is not None:
        try:
            return max(0.0, float(hint))
        except (TypeError, ValueError):
            return 0.0
    if getattr(exc, "code", None) == 429:
        headers = getattr(exc, "headers", None)
        raw = headers.get("Retry-After") if headers is not None else None
        try:
            return max(0.0, float(raw))
        except (TypeError, ValueError):
            return 0.0
    return None


class CircuitBreaker:
    """Consecutive-failure circuit breaker (thread-safe).

    CLOSED: calls pass through; ``failure_threshold`` consecutive failures
    open the circuit.  OPEN: :meth:`before_call` raises
    :class:`CircuitOpenError` immediately.  After ``cooldown_s`` the next
    call is admitted as a half-open probe — its success closes the circuit,
    its failure re-opens it for another cooldown.  ``failure_threshold <= 0``
    disables the breaker entirely.

    ``listener`` (or :meth:`bagua_tpu_torch.observability.telemetry.Telemetry.bind_breaker`)
    receives ``(name, old_state, new_state)`` on every evented transition —
    closed→open, open→half-open (probe admission), half-open→closed,
    half-open→open — fired outside the breaker lock.
    """

    def __init__(
        self,
        failure_threshold: int = 5,
        cooldown_s: float = 30.0,
        name: str = "rpc",
        clock: Callable[[], float] = time.monotonic,
        listener: Optional[Callable[[str, str, str], None]] = None,
    ):
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.name = name
        self.listener = listener
        self._clock = clock
        self._lock = threading.Lock()
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._probing = False
        self.times_opened = 0

    def _state_locked(self) -> str:
        if self._opened_at is None:
            return "closed"
        if self._probing or self._clock() - self._opened_at >= self.cooldown_s:
            return "half-open"
        return "open"

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _notify(self, old_state: str, new_state: str) -> None:
        # Called with the lock released; a listener that RPCs or logs must
        # never be able to deadlock the breaker or its callers.
        if self.listener is None or old_state == new_state:
            return
        try:
            self.listener(self.name, old_state, new_state)
        except Exception:
            logger.exception("breaker %s transition listener failed", self.name)

    def before_call(self) -> None:
        """Gate one call attempt; raises :class:`CircuitOpenError` while
        open.  In the half-open window exactly one probe is admitted at a
        time (concurrent callers keep failing fast until it resolves)."""
        if self.failure_threshold <= 0:
            return
        with self._lock:
            if self._opened_at is None:
                return
            if self._clock() - self._opened_at < self.cooldown_s or self._probing:
                raise CircuitOpenError(
                    f"{self.name} circuit open "
                    f"({self._consecutive_failures} consecutive failures); "
                    f"failing fast for {self.cooldown_s}s cooldowns"
                )
            self._probing = True  # half-open: admit this caller as the probe
        self._notify("open", "half-open")

    def record_success(self) -> None:
        with self._lock:
            old = self._state_locked()
            self._consecutive_failures = 0
            self._opened_at = None
            self._probing = False
        self._notify(old, "closed")

    def record_failure(self) -> None:
        if self.failure_threshold <= 0:
            return
        notify = None
        with self._lock:
            old = self._state_locked()
            self._consecutive_failures += 1
            was_open = self._opened_at is not None
            if self._probing or self._consecutive_failures >= self.failure_threshold:
                self._opened_at = self._clock()
                self._probing = False
                notify = (old, "open")
                if not was_open or self._consecutive_failures == self.failure_threshold:
                    self.times_opened += 1
                    logger.warning(
                        "%s circuit OPEN after %d consecutive failures; "
                        "degrading to local defaults for %.1fs",
                        self.name, self._consecutive_failures, self.cooldown_s,
                    )
        if notify is not None:
            self._notify(*notify)


class RetryPolicy:
    """Jittered exponential backoff: attempt ``i`` (0-based) sleeps
    ``uniform(0, min(max_s, base_s * 2**i))`` before retrying — full jitter,
    so a gang of workers retrying a recovering service doesn't stampede it
    in lockstep."""

    def __init__(
        self,
        retries: Optional[int] = None,
        base_s: Optional[float] = None,
        max_s: Optional[float] = None,
        seed: Optional[int] = None,
    ):
        from bagua_tpu_torch.env import (
            get_rpc_backoff_base_s, get_rpc_backoff_max_s, get_rpc_retries,
        )

        self.retries = get_rpc_retries() if retries is None else retries
        self.base_s = get_rpc_backoff_base_s() if base_s is None else base_s
        self.max_s = get_rpc_backoff_max_s() if max_s is None else max_s
        # seedless policies share the module-level RNG (seed_backoff pins
        # it); an explicit seed keeps a private, isolated stream
        self._rng = _backoff_rng if seed is None else random.Random(seed)

    def backoff_s(self, attempt: int) -> float:
        return self._rng.uniform(0.0, min(self.max_s, self.base_s * (2 ** attempt)))


def retry_call(
    fn: Callable,
    *args,
    policy: Optional[RetryPolicy] = None,
    breaker: Optional[CircuitBreaker] = None,
    retry_on: Tuple[Type[BaseException], ...] = (OSError, ConnectionError),
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    label: str = "rpc",
    **kwargs,
):
    """Call ``fn(*args, **kwargs)`` under the retry policy + breaker.

    :class:`CircuitOpenError` from the breaker is never retried (the whole
    point is to fail fast); any other ``retry_on`` exception is retried up
    to ``policy.retries`` times with jittered backoff, and every outcome is
    reported to the breaker so persistent flapping opens the circuit.

    Server-signalled backpressure (:func:`retry_after_hint` returns a value:
    a :class:`BackpressureError` or a raw HTTP 429) is special-cased: it is
    recorded as a breaker *success* (the server is alive — a 429 must never
    push the circuit open), and the backoff becomes
    ``min(max(hint, jitter), policy.max_s)`` so the client honors the
    server's Retry-After estimate while the cap bounds a hostile hint.

    ``label`` names the endpoint in telemetry: every backoff sleep is
    reported to the process-wide observer (:func:`set_retry_observer`) and
    annotated onto the ambient trace span when tracing is on — both fenced
    so instrumentation can never break a live retry."""
    policy = policy or RetryPolicy()
    last: Optional[BaseException] = None
    for attempt in range(policy.retries + 1):
        if breaker is not None:
            breaker.before_call()  # raises CircuitOpenError while open
        try:
            out = fn(*args, **kwargs)
        except retry_on as e:
            hint = retry_after_hint(e)
            if breaker is not None:
                if hint is None:
                    breaker.record_failure()
                else:
                    breaker.record_success()  # alive, just shedding load
            last = e
            if attempt >= policy.retries:
                break
            delay = policy.backoff_s(attempt)
            if hint is not None:
                delay = min(max(hint, delay), policy.max_s)
            reason = "backpressure" if hint is not None else "error"
            observer = _retry_observer
            if observer is not None:
                try:
                    observer(label, attempt, delay, reason, hint)
                except Exception:
                    logger.exception("retry observer failed for %s", label)
            try:
                from bagua_tpu_torch.observability.tracing import get_global_tracer

                tracer = get_global_tracer()
                sp = tracer.current_span() if tracer is not None else None
                if sp is not None:
                    ann = {"attempt": attempt, "delay_s": round(delay, 4)}
                    if hint is not None:
                        ann["retry_after_s"] = round(hint, 3)
                    sp.annotate(f"retry:{reason}", **ann)
            except Exception:
                logger.exception("retry span annotation failed for %s", label)
            if on_retry is not None:
                on_retry(attempt, e)
            logger.debug(
                "retry %d/%d after %s (backoff %.3fs)",
                attempt + 1, policy.retries, e, delay,
            )
            sleep(delay)
        else:
            if breaker is not None:
                breaker.record_success()
            return out
    assert last is not None
    raise last
