"""Gang autopilot: online relaxation control over {algorithm, precision,
staleness}.

The controller consumes attributed ``perf_regression`` incidents, the
health monitor's stability signal and the planner's fitted α–β cost model,
and moves the gang to the cheapest healthy configuration through the
engine's statically-verified single-recompile switch actions.  The
staleness director runs the per-rank arm of the same loop: straggler
attribution in, bounded-staleness degradation (with a convergence
guardrail) out.  The port of ``bagua_tpu/autopilot/``: pure Python over
the engine's knobs, the same policy as the JAX package's.
"""

from bagua_tpu_torch.autopilot.controller import AutopilotConfig, GangAutopilot
from bagua_tpu_torch.autopilot.pricing import (
    PRECISION_RUNGS,
    Configuration,
    candidate_configurations,
    degraded_cost_model,
    modeled_step_ms,
    price_configurations,
    wire_ms,
)
from bagua_tpu_torch.autopilot.staleness import (
    StalenessConfig,
    StalenessDirector,
    StalenessTightenAction,
)

__all__ = [
    "AutopilotConfig",
    "GangAutopilot",
    "Configuration",
    "PRECISION_RUNGS",
    "StalenessConfig",
    "StalenessDirector",
    "StalenessTightenAction",
    "candidate_configurations",
    "degraded_cost_model",
    "modeled_step_ms",
    "price_configurations",
    "wire_ms",
]
