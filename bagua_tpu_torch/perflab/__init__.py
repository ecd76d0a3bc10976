"""The modeled step and the fleet simulator: performance evidence without
the card.

The port of ``bagua_tpu/perflab/``.  :mod:`~bagua_tpu_torch.perflab.engine` runs the engine's step dry on the
``meta`` device (the static verifier's dry run), takes the CollectiveIR's
exact per-leg wire bytes, prices each leg through the planner's α–β
:class:`~bagua_tpu_torch.service.planner.CostModel`, counts one rank's
matmul and convolution FLOPs for the compute span, and composes them under
an explicit overlap-window assumption into ``modeled_step_ms``.  The one
link model of the port, NVLink inside an H100 host and the network
between hosts, lives in :mod:`~bagua_tpu_torch.perflab.topology`; the
regression sentinel takes its default from it.

:mod:`~bagua_tpu_torch.perflab.fleetsim` (a copy) is a discrete-event
simulation of N gangs of modeled step clocks with injectable stragglers,
bandwidth collapse, preemption and KV flaps, driving the real host-side
machinery (:class:`~bagua_tpu_torch.observability.aggregate.GangAggregator`
pushes, straggler scoring, flight-recorder digests, the breaker and retry
paths) against a live rendezvous service, on the CPU.
"""

from bagua_tpu_torch.perflab.compute import compute_time_s, flops_census, step_flops_census
from bagua_tpu_torch.perflab.costbridge import (
    LEG_FOR_PRIMITIVE,
    PricedProgram,
    census_wire_bytes,
    price_program,
)
from bagua_tpu_torch.perflab.engine import ModeledCell, kernel_basis, model_step_cell, modeled_bench_rows
from bagua_tpu_torch.perflab.fleetsim import (
    BandwidthCollapse,
    FleetConfig,
    FlakyClient,
    KVFlap,
    Preemption,
    Straggler,
    run_fleet,
)
from bagua_tpu_torch.perflab.topology import (
    DEFAULT_TOPOLOGY,
    TopologyAssumptions,
    ring_hops,
    t_axis_collective,
    t_collective,
)

__all__ = [
    "BandwidthCollapse",
    "DEFAULT_TOPOLOGY",
    "FleetConfig",
    "FlakyClient",
    "KVFlap",
    "LEG_FOR_PRIMITIVE",
    "ModeledCell",
    "Preemption",
    "PricedProgram",
    "Straggler",
    "TopologyAssumptions",
    "census_wire_bytes",
    "compute_time_s",
    "flops_census",
    "kernel_basis",
    "model_step_cell",
    "modeled_bench_rows",
    "price_program",
    "ring_hops",
    "run_fleet",
    "step_flops_census",
    "t_axis_collective",
    "t_collective",
]
