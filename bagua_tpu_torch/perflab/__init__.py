"""The modeled step: modeled performance evidence from a dry run.

The port of ``bagua_tpu/perflab/`` without its fleet simulator
(``fleetsim.py``, which drives the ``fleet/`` control plane, not ported):
:mod:`~bagua_tpu_torch.perflab.engine` runs the engine's step dry on the
``meta`` device (the static verifier's dry run), takes the CollectiveIR's
exact per-leg wire bytes, prices each leg through the planner's α–β
:class:`~bagua_tpu_torch.service.planner.CostModel`, counts one rank's
matmul and convolution FLOPs for the compute span, and composes them under
an explicit overlap-window assumption into ``modeled_step_ms``.  The one
link model of the port, NVLink inside an H100 host and the network
between hosts, lives in :mod:`~bagua_tpu_torch.perflab.topology`; the
regression sentinel takes its default from it.
"""

from bagua_tpu_torch.perflab.compute import compute_time_s, flops_census, step_flops_census
from bagua_tpu_torch.perflab.costbridge import (
    LEG_FOR_PRIMITIVE,
    PricedProgram,
    census_wire_bytes,
    price_program,
)
from bagua_tpu_torch.perflab.engine import ModeledCell, kernel_basis, model_step_cell
from bagua_tpu_torch.perflab.topology import (
    DEFAULT_TOPOLOGY,
    TopologyAssumptions,
    ring_hops,
    t_axis_collective,
    t_collective,
)

__all__ = [
    "DEFAULT_TOPOLOGY",
    "LEG_FOR_PRIMITIVE",
    "ModeledCell",
    "PricedProgram",
    "TopologyAssumptions",
    "census_wire_bytes",
    "compute_time_s",
    "flops_census",
    "kernel_basis",
    "model_step_cell",
    "price_program",
    "ring_hops",
    "step_flops_census",
    "t_axis_collective",
    "t_collective",
]
