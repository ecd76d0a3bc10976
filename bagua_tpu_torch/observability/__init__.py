"""Observability (the port of ``bagua_tpu/observability/``): spans, step
timing, hang watchdog, exchange labels, profiler-trace overlap analysis,
structured metrics export, the flight recorder, health, goodput and the
regression sentinel.

The package splits by layer — :mod:`~bagua_tpu_torch.observability.core` is
the host-side primitives (spans/timer/watchdog/profiler),
:mod:`~bagua_tpu_torch.observability.annotations` the labels,
:mod:`~bagua_tpu_torch.observability.trace_analysis` the trace parser,
:mod:`~bagua_tpu_torch.observability.metrics` the registry/JSONL/Prometheus
plumbing, and :mod:`~bagua_tpu_torch.observability.telemetry` the hub tying
them to the engine — but the public names all live here, the JAX
package's names.  Where the port replaces what a JAX name did, its
docstring says so: :class:`ProfilerSession` (``torch.profiler``, Chrome
traces), :func:`bucket_scope` / :func:`step_scope` / :func:`mp_scope`
(``record_function`` in place of ``jax.named_scope``),
:func:`analyze_trace` (kernels joined to labels through their launches, in
place of XLA's HLO table), :func:`flops_from_cost_analysis`
(``torch.utils.flop_counter`` in place of XLA's cost analysis),
:func:`health_scalars` (torch, rank-stacked), :func:`capture_program`
(re-entered on the overlap hooks' thread) and the
:class:`RecompileDetector` (step-cache misses, not jit's).  Everything else
is a copy.
"""

from bagua_tpu_torch.observability.core import (
    ProfilerSession,
    SpanRecorder,
    StepTimer,
    Watchdog,
)
from bagua_tpu_torch.observability.annotations import (
    EXCHANGE_PREFIX,
    STEP_PREFIX,
    bucket_scope,
    mp_scope,
    parse_exchange_label,
    parse_mp_label,
    parse_step_phase,
    step_scope,
)
from bagua_tpu_torch.observability.metrics import (
    Counter,
    Gauge,
    Histogram,
    JsonlSink,
    MetricsRegistry,
    rotated_metrics_files,
    validate_metrics_event,
    validate_metrics_file,
)
from bagua_tpu_torch.observability.telemetry import RecompileDetector, Telemetry
from bagua_tpu_torch.observability.attribution import (
    BUDGET_COMPONENTS,
    BudgetModel,
    StepBudget,
)
from bagua_tpu_torch.observability.regression import Cusum, RegressionSentinel
from bagua_tpu_torch.observability.goodput import (
    GoodputLedger,
    GoodputMeter,
    flops_from_cost_analysis,
    model_flops_per_sample,
    predicted_wire_time,
    register_model_flops,
)
from bagua_tpu_torch.observability.health import (
    HealthConfig,
    HealthMonitor,
    PrecisionDemotionAction,
    SnapshotOnAnomalyAction,
    health_scalars,
)
from bagua_tpu_torch.observability.aggregate import (
    GangAggregator,
    GangView,
    StepSummary,
    straggler_score,
    summarize_telemetry,
)
from bagua_tpu_torch.observability.flight_recorder import (
    FLIGHT_DUMP_SCHEMA,
    HANG_REPORT_SCHEMA,
    VERDICTS,
    FlightRecorder,
    build_hang_report,
    capture_program,
    flight_dump_path,
    push_flight_digest,
    validate_flight_dump,
    validate_hang_report,
)
from bagua_tpu_torch.observability.trace_analysis import (
    COLLECTIVE_OPS,
    analyze_trace,
    attribute_device_events,
    find_trace_file,
    hlo_op_labels,
    load_trace_events,
)
from bagua_tpu_torch.observability.tracing import (
    SPAN_SCHEMA,
    Span,
    Tracer,
    client_span,
    format_traceparent,
    get_global_tracer,
    new_span_id,
    new_trace_id,
    parse_traceparent,
    set_global_tracer,
    validate_span,
)

__all__ = [
    # core
    "ProfilerSession",
    "SpanRecorder",
    "StepTimer",
    "Watchdog",
    # annotations
    "EXCHANGE_PREFIX",
    "STEP_PREFIX",
    "bucket_scope",
    "mp_scope",
    "step_scope",
    "parse_exchange_label",
    "parse_mp_label",
    "parse_step_phase",
    # metrics
    "Counter",
    "Gauge",
    "Histogram",
    "JsonlSink",
    "MetricsRegistry",
    "rotated_metrics_files",
    "validate_metrics_event",
    "validate_metrics_file",
    # telemetry
    "RecompileDetector",
    "Telemetry",
    # budget attribution / regression sentinel
    "BUDGET_COMPONENTS",
    "BudgetModel",
    "StepBudget",
    "Cusum",
    "RegressionSentinel",
    # goodput / MFU
    "GoodputLedger",
    "GoodputMeter",
    "flops_from_cost_analysis",
    "model_flops_per_sample",
    "predicted_wire_time",
    "register_model_flops",
    # health guardrail
    "HealthConfig",
    "HealthMonitor",
    "PrecisionDemotionAction",
    "SnapshotOnAnomalyAction",
    "health_scalars",
    # gang aggregation
    "GangAggregator",
    "GangView",
    "StepSummary",
    "straggler_score",
    "summarize_telemetry",
    # flight recorder / hang forensics
    "FLIGHT_DUMP_SCHEMA",
    "HANG_REPORT_SCHEMA",
    "VERDICTS",
    "FlightRecorder",
    "build_hang_report",
    "capture_program",
    "flight_dump_path",
    "push_flight_digest",
    "validate_flight_dump",
    "validate_hang_report",
    # trace analysis
    "COLLECTIVE_OPS",
    "analyze_trace",
    "attribute_device_events",
    "find_trace_file",
    "hlo_op_labels",
    "load_trace_events",
    # distributed tracing
    "SPAN_SCHEMA",
    "Span",
    "Tracer",
    "client_span",
    "format_traceparent",
    "get_global_tracer",
    "new_span_id",
    "new_trace_id",
    "parse_traceparent",
    "set_global_tracer",
    "validate_span",
]
