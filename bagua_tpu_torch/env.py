"""Environment/config accessors (the port of ``bagua_tpu/env.py``)."""

import os
import sys
from typing import Optional


def get_default_bucket_size() -> int:
    """Default communication bucket size in bytes (10 MiB, like the reference)."""
    return int(os.environ.get("BAGUA_DEFAULT_BUCKET_SIZE", 10 * 1024 ** 2))


def _gang():
    """The default process group where it spans processes (a live
    ``torch.distributed`` gang), else None."""
    comm = sys.modules.get("bagua_tpu_torch.communication")
    group = getattr(comm, "_default_group", None)
    return group if group is not None and group.distributed else None


def get_world_size() -> int:
    """Processes in the job: the live gang's, else ``WORLD_SIZE``, else 1
    (one controller drives every rank of a group)."""
    gang = _gang()
    return gang.process_count if gang is not None else int(os.environ.get("WORLD_SIZE", 1))


def get_rank() -> int:
    """This process's index in the job: the live gang's, else ``RANK``,
    else 0."""
    gang = _gang()
    return gang.process_index if gang is not None else int(os.environ.get("RANK", 0))


def get_local_rank() -> int:
    """This process's index on its node: ``LOCAL_RANK`` (the launcher's),
    else the live gang's process index, else 0."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    gang = _gang()
    return gang.process_index if gang is not None else 0


def get_local_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", 1))


def get_node_rank() -> int:
    return int(os.environ.get("NODE_RANK", get_rank() // max(get_local_size(), 1)))


def get_master_addr() -> str:
    return os.environ.get("MASTER_ADDR", "127.0.0.1")


def get_bagua_service_port() -> int:
    return int(os.environ.get("BAGUA_SERVICE_PORT", -1))


def set_bagua_service_port(port: int) -> None:
    os.environ["BAGUA_SERVICE_PORT"] = str(port)


def get_autotune_level() -> int:
    return int(os.environ.get("BAGUA_AUTOTUNE", 0))


def get_autotune_planner_mode() -> str:
    """``BAGUA_AUTOTUNE_PLANNER``: how the trace-driven bucket planner
    takes part in autotune (``bagua_tpu_torch/service/planner.py``).

    * ``"warmstart"`` (default): once measured spans arrive, the Bayesian
      optimizer's initial points are the planner's top-k proposals instead
      of a cold grid walk; the bucket assignment stays the greedy split.
    * ``"on"``: warm start, and each proposal's bucket assignment is the
      planner's DP-optimal contiguous partition (capped at the proposed
      bucket size) instead of the greedy byte-threshold split.
    * ``"off"``: pure Bayesian optimization, no planner.

    Unknown values fall back to ``"warmstart"``; with no spans reported the
    planner never activates, so every mode degrades to pure BO."""
    mode = os.environ.get("BAGUA_AUTOTUNE_PLANNER", "warmstart").strip().lower()
    return mode if mode in ("on", "off", "warmstart") else "warmstart"


def get_autotune_max_samples() -> int:
    return int(os.environ.get("BAGUA_AUTOTUNE_MAX_SAMPLES", 60))


def get_autotune_warmup_time_s() -> float:
    return float(os.environ.get("BAGUA_AUTOTUNE_WARMUP_TIME_S", 30.0))


def get_autotune_sampling_confidence_time_s() -> float:
    return float(os.environ.get("BAGUA_AUTOTUNE_SAMPLING_CONFIDENCE_TIME_S", 5.0))


def get_autotune_server_wait_time_s() -> float:
    return float(os.environ.get("BAGUA_AUTOTUNE_SERVER_WAIT_TIME", 60.0))


def is_report_metrics_switch_on() -> bool:
    return int(os.environ.get("BAGUA_REPORT_METRICS", 0)) == 1


def get_autotune_logfile_path() -> str:
    return os.environ.get("BAGUA_AUTOTUNE_LOGFILE_PATH", "/tmp/bagua_autotune.log")


def get_snapshot_every() -> int:
    """``BAGUA_SNAPSHOT_EVERY``: the async snapshot cadence in steps (0
    leaves the ``Trainer``'s ``snapshot_every``; a value overrides it, so an
    operator can retune the lost-work bound without editing the script)."""
    return int(os.environ.get("BAGUA_SNAPSHOT_EVERY", 0))


def get_metrics_max_mb() -> float:
    """``BAGUA_METRICS_MAX_MB``: size-based rotation threshold (MiB) for the
    telemetry JSONL event stream — the live file rotates to ``path.N`` when
    it would exceed this.  0 (the default) disables rotation."""
    return float(os.environ.get("BAGUA_METRICS_MAX_MB", 0) or 0)


def get_flight_recorder_enabled() -> bool:
    """``BAGUA_FLIGHT_RECORDER``: the collective flight recorder — the
    per-rank black-box ring of one record per collective the engine issues
    (``bagua_tpu_torch/observability/flight_recorder.py``).  On by default whenever a
    telemetry hub is attached; ``0``/``false``/``off`` disables.  The
    recorder is bitwise-inert either way — the knob trades the (tiny)
    host-side replay cost for hang forensics."""
    return os.environ.get("BAGUA_FLIGHT_RECORDER", "1").strip().lower() not in (
        "0", "false", "off", ""
    )


def get_tracing_enabled() -> bool:
    """``BAGUA_TRACING``: the distributed tracer — causal spans from the
    train step through the RPC tier to the fleet control plane
    (``bagua_tpu_torch/observability/tracing.py``).  Off by default (unlike the flight
    recorder: tracing writes a span stream, not just a ring); any of
    ``1``/``true``/``on`` enables.  Bitwise-inert either way — the knob
    trades host-side span bookkeeping for a queryable timeline."""
    return os.environ.get("BAGUA_TRACING", "0").strip().lower() in (
        "1", "true", "on", "yes"
    )


def get_trace_sample_every() -> int:
    """``BAGUA_TRACE_SAMPLE``: step-sampling cadence for the tracer — a
    root span is opened every Nth step (1, the default, traces every step;
    RPCs issued outside a sampled step still get root client spans).
    Clamped to ≥ 1."""
    try:
        return max(1, int(os.environ.get("BAGUA_TRACE_SAMPLE", 1)))
    except ValueError:
        return 1


def get_trace_path() -> Optional[str]:
    """``BAGUA_TRACE_PATH``: where the tracer appends its span JSONL
    (one ``bagua.span.v1`` object per line — what ``ci/export_timeline.py``
    renders to Perfetto).  None (default) keeps spans in the in-memory ring
    only."""
    return os.environ.get("BAGUA_TRACE_PATH") or None


def get_regression_sentinel_enabled() -> bool:
    """``BAGUA_REGRESSION_SENTINEL``: the performance-regression sentinel —
    per-step budget attribution plus CUSUM changepoint detection over the
    step-wall and goodput streams (``bagua_tpu_torch/observability/regression.py``).  Off
    by default (it emits ``perf_regression`` incidents, an operator-facing
    stream); any of ``1``/``true``/``on`` enables.  Bitwise-inert either
    way — the knob trades host-side arithmetic for a slowdown verdict."""
    return os.environ.get("BAGUA_REGRESSION_SENTINEL", "0").strip().lower() in (
        "1", "true", "on", "yes"
    )


def get_regression_warmup() -> int:
    """``BAGUA_REGRESSION_WARMUP``: steps the sentinel's CUSUM baselines
    settle before a trip is possible (the health monitor's warmup
    discipline).  Clamped to ≥ 1."""
    try:
        return max(1, int(os.environ.get("BAGUA_REGRESSION_WARMUP", 30)))
    except ValueError:
        return 30


def get_regression_threshold() -> float:
    """``BAGUA_REGRESSION_THRESHOLD``: the CUSUM trip threshold ``h`` in
    baseline-σ units of accumulated drift.  Higher = fewer, surer
    incidents; the default (8) holds a clean jittery run tripless while a
    sustained few-σ shift still trips within a handful of steps."""
    try:
        return max(1.0, float(os.environ.get("BAGUA_REGRESSION_THRESHOLD", 8.0)))
    except ValueError:
        return 8.0


def get_regression_cooldown() -> int:
    """``BAGUA_REGRESSION_COOLDOWN``: steps after a sentinel trip before
    it may trip again — one sustained regression becomes one incident, not
    a stream of them."""
    try:
        return max(0, int(os.environ.get("BAGUA_REGRESSION_COOLDOWN", 50)))
    except ValueError:
        return 50


def get_static_verify_mode() -> str:
    """``BAGUA_STATIC_VERIFY``: the pre-dispatch static collective-program
    verifier (:mod:`bagua_tpu_torch.analysis`).  ``off`` (default) skips
    it; ``warn`` logs the findings and dispatches anyway; ``strict`` raises
    :class:`~bagua_tpu_torch.analysis.StaticVerifyError` before any
    dispatch.  Any unrecognized value degrades to ``off``."""
    mode = os.environ.get("BAGUA_STATIC_VERIFY", "off").strip().lower()
    return mode if mode in ("warn", "strict") else "off"


def get_flight_ring_size() -> int:
    """``BAGUA_FLIGHT_RING``: flight-recorder ring capacity in records.
    The default (4096) covers hundreds of steps of a typical bucket plan —
    far past any watchdog timeout — in ~a few MB of host memory."""
    return int(os.environ.get("BAGUA_FLIGHT_RING", 4096))


def get_dump_dir() -> str:
    """``BAGUA_DUMP_DIR``: where hang evidence lands (the watchdog's
    ``watchdog_dump.json``, the flight recorder's ``flight_<rank>.json``).
    Defaults to the working directory."""
    return os.environ.get("BAGUA_DUMP_DIR") or "."


def get_rpc_retries() -> int:
    """``BAGUA_RPC_RETRIES``: attempts (1 + retries) for service RPCs
    (autotune client, rendezvous KV) before the error surfaces."""
    return int(os.environ.get("BAGUA_RPC_RETRIES", 3))


def get_rpc_backoff_base_s() -> float:
    return float(os.environ.get("BAGUA_RPC_BACKOFF_BASE_S", 0.1))


def get_rpc_backoff_max_s() -> float:
    return float(os.environ.get("BAGUA_RPC_BACKOFF_MAX_S", 2.0))


def get_rpc_breaker_threshold() -> int:
    """``BAGUA_RPC_BREAKER_THRESHOLD``: consecutive RPC failures before the
    circuit opens and calls fail fast (0 disables circuit breaking)."""
    return int(os.environ.get("BAGUA_RPC_BREAKER_THRESHOLD", 5))


def get_rpc_breaker_cooldown_s() -> float:
    return float(os.environ.get("BAGUA_RPC_BREAKER_COOLDOWN_S", 30.0))


def get_rpc_timeout_s() -> float:
    """``BAGUA_RPC_TIMEOUT_S``: per-attempt socket timeout for service RPCs
    (the rendezvous store, the autotune service, the fleet control plane).
    One knob for every client; the retry layer (``BAGUA_RPC_RETRIES``)
    multiplies it into the worst-case blocking time."""
    return float(os.environ.get("BAGUA_RPC_TIMEOUT_S", 10.0))


def get_fleet_lease_ttl_s() -> float:
    """``BAGUA_FLEET_LEASE_TTL_S``: gang-lease TTL on the fleet control
    plane.  A gang whose lease goes this long without any request is
    considered dead and its namespace is garbage-collected."""
    return float(os.environ.get("BAGUA_FLEET_LEASE_TTL_S", 300.0))


def get_fleet_rate_limit() -> float:
    """``BAGUA_FLEET_RATE``: per-gang admission rate (requests/second) on
    the fleet control plane's token bucket.  0 disables backpressure."""
    return float(os.environ.get("BAGUA_FLEET_RATE", 0) or 0)


def get_fleet_burst() -> float:
    """``BAGUA_FLEET_BURST``: per-gang token-bucket burst capacity (requests
    admitted at full speed before the rate limit engages)."""
    return float(os.environ.get("BAGUA_FLEET_BURST", 200.0))
