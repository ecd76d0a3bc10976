"""Static analysis of the step's collective program.

The port of ``bagua_tpu/analysis/``: the configuration space {algorithm ×
wire precision × overlap mode × bucket plan}, mutable mid-training,
multiplies the distinct collective programs a gang can run; this package
proves a program gang-consistent **before dispatch**.
:mod:`~bagua_tpu_torch.analysis.collective_ir` captures a canonical IR of
the collectives a step issues, :mod:`~bagua_tpu_torch.analysis.checks`
runs the four checkers (rank invariance, wire-byte exactness, plan
conformance, static/dynamic agreement with the flight recorder), and
:mod:`~bagua_tpu_torch.analysis.verify` runs the step dry, on the ``meta``
device, for the engine's ``BAGUA_STATIC_VERIFY`` pre-dispatch gate.
"""

from bagua_tpu_torch.analysis.collective_ir import (
    COLLECTIVE_PRIMITIVES,
    CollectiveDescriptor,
    CollectiveProgram,
    capture_collectives,
    label_scope,
    primitive_wire_bytes,
)
from bagua_tpu_torch.analysis.checks import (
    CHECK_NAMES,
    MODELED_ALGOS,
    Finding,
    StaticVerifyError,
    WireModelConfig,
    canonical_records,
    check_plan_conformance,
    check_rank_invariance,
    check_static_dynamic,
    check_wire_exactness,
)
from bagua_tpu_torch.analysis.verify import (
    VerifyReport,
    dry_run,
    meta_state,
    on_meta,
    predict_flight_program,
    verify_collective_program,
    verify_step_program,
)

__all__ = [
    "CHECK_NAMES",
    "COLLECTIVE_PRIMITIVES",
    "MODELED_ALGOS",
    "CollectiveDescriptor",
    "CollectiveProgram",
    "Finding",
    "StaticVerifyError",
    "VerifyReport",
    "WireModelConfig",
    "canonical_records",
    "capture_collectives",
    "check_plan_conformance",
    "check_rank_invariance",
    "check_static_dynamic",
    "check_wire_exactness",
    "dry_run",
    "label_scope",
    "meta_state",
    "on_meta",
    "predict_flight_program",
    "primitive_wire_bytes",
    "verify_collective_program",
    "verify_step_program",
]
