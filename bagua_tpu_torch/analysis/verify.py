"""Entry points: verify a step program before it ever dispatches.

The port of ``bagua_tpu/analysis/verify.py``.  The JAX package traces its
un-jitted step over ``ShapeDtypeStruct``s; the port's counterpart is a
**dry run on the** ``meta`` **device**: :func:`dry_run` runs the engine's
own step (``DistributedDataParallel._step``) on meta copies of the state
and the batch, where every operation computes shapes and dtypes only.
Inside :class:`on_meta` every tensor factory and every ``.to(device)``
lands on ``meta`` too (the algorithms make their scratch on the group's
device), so nothing is allocated on the card and no kernel launches: the
kernel wrappers hand a meta tensor to their plain versions, which count
no launch.  The dry run issues the step's collectives under
:class:`~bagua_tpu_torch.analysis.collective_ir.capture_collectives` (the
static program) and the flight recorder's
:class:`~bagua_tpu_torch.observability.flight_recorder.capture_program`
(the dynamic one) in the same pass.

What the dry run leaves out, as the JAX package's trace leaves it out: the
algorithm's host hooks (``host_pre_dispatch``/``host_post_dispatch``, the
async averager's thread), the health monitor's host read, and the
optimizer's update, which issues no collective (a sharded update's
all-gather is the next step's ``on_step_start``, and the dry run's
``on_step_start`` issues it).  Nothing the real step computes changes.

:func:`verify_step_program` is the pre-dispatch gate; over the captured
:class:`~bagua_tpu_torch.analysis.collective_ir.CollectiveProgram` it runs
the four checkers (:mod:`bagua_tpu_torch.analysis.checks`) and returns a
:class:`VerifyReport`; ``report.raise_if_failed()`` is what
``BAGUA_STATIC_VERIFY=strict`` calls.

:func:`predict_flight_program` renders the IR into the exact record
templates ``ddp._flight_finalize`` produces from a live capture, which is
what lets check 4 compare the two subsystems record-for-record.
"""

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._device import _device_constructors

from bagua_tpu_torch.analysis.checks import (
    MODELED_ALGOS,
    Finding,
    StaticVerifyError,
    WireModelConfig,
    check_plan_conformance,
    check_rank_invariance,
    check_static_dynamic,
    check_wire_exactness,
)
from bagua_tpu_torch.analysis.collective_ir import CollectiveProgram, capture_collectives
from bagua_tpu_torch.observability.flight_recorder import capture_program
from bagua_tpu_torch.observability.scope_grammar import format_exchange_label

__all__ = [
    "VerifyReport",
    "dry_run",
    "meta_state",
    "on_meta",
    "predict_flight_program",
    "verify_collective_program",
    "verify_step_program",
]


@dataclasses.dataclass
class VerifyReport:
    """One verification run: every finding plus the evidence tables."""

    algo: str
    variant: str
    findings: List[Finding]
    wire_table: List[Dict]
    predicted: List[Dict]
    captured: List[Dict]
    num_collectives: int

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def raise_if_failed(self) -> "VerifyReport":
        if self.errors:
            raise StaticVerifyError(self.findings)
        return self

    def summary(self) -> str:
        if self.ok:
            return (
                f"static verify ok: algo={self.algo} variant={self.variant} "
                f"{self.num_collectives} collectives, "
                f"{len(self.wire_table)} bucket-phases"
            )
        return "; ".join(str(f) for f in self.errors)

    def to_json(self) -> Dict:
        return {
            "algo": self.algo,
            "variant": self.variant,
            "ok": self.ok,
            "num_collectives": self.num_collectives,
            "findings": [f.to_json() for f in self.findings],
            "wire_table": self.wire_table,
            "predicted_records": len(self.predicted),
            "captured_records": len(self.captured),
        }


# ---------------------------------------------------------------------------
# The dry run on the meta device
# ---------------------------------------------------------------------------


#: the tensor factories (what ``with torch.device(...)`` redirects)
_CONSTRUCTORS = frozenset(_device_constructors())
_META = torch.device("meta")


def _is_device(a) -> bool:
    return isinstance(a, torch.device) or (isinstance(a, str) and a.split(":")[0] in ("cpu", "cuda", "meta"))


class on_meta(TorchFunctionMode):
    """Within, every tensor factory and every ``.to(device)`` lands on the
    ``meta`` device: the dry run's guarantee that nothing is allocated on
    the card, whatever device the algorithms name for their scratch.
    Thread-local, as every torch function mode (the engine's overlap hooks
    re-enter it)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func in _CONSTRUCTORS:
            kwargs["device"] = _META
        elif func is torch.Tensor.to:
            if "device" in kwargs:
                kwargs["device"] = _META
            args = tuple(_META if i and _is_device(a) else a for i, a in enumerate(args))
        return func(*args, **kwargs)


def _to_meta(x):
    if torch.is_tensor(x):
        return torch.empty_like(x, device=_META)
    if isinstance(x, dict):
        return {k: _to_meta(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        out = [_to_meta(v) for v in x]
        return type(x)(out) if not hasattr(x, "_fields") else type(x)(*out)
    return x


def meta_state(ddp, state):
    """The train state the next step of ``ddp`` runs on, on ``meta``: the
    parameters and the algorithm's state of ``state`` as meta tensors, no
    optimizer (the dry run steps none).  While a shard-layout migration is
    pending (a ``rebucket`` under a sharded update) ``state`` still holds
    the old layout, so the algorithm's state is built anew in the CURRENT
    layout (``init_state`` on meta), as the JAX gate traces over
    ``state_template()``; with ``state`` None (a re-verification after a
    switch) so is everything."""
    from bagua_tpu_torch.communication import default_axes
    from bagua_tpu_torch.ddp import TrainState
    from bagua_tpu_torch.utils import tree_map

    n = ddp.group.local_size
    if state is not None:
        params = _to_meta(state.params)
        step = state.step
    else:
        params = tree_map(lambda p: torch.empty((n, *p.shape), dtype=p.dtype, device=_META), ddp._tree_template)
        step = ddp._host_step
    if state is None or ddp._pending_reshard is not None:
        with on_meta(), default_axes(ddp.group.data_axes):
            algo_state = ddp.impl.init_state(tree_map(lambda p: p[0], params))
    else:
        algo_state = _to_meta(state.algo_state)
    return TrainState(params=params, optimizer=None, algo_state=algo_state, step=step)


def dry_run(ddp, state, batch):
    """Run one step of ``ddp`` on meta copies of ``state`` (a
    :func:`meta_state`, or a live state) and ``batch``, capturing its
    collectives and its flight-recorder events.  Returns
    ``(CollectiveProgram, events)``."""
    from bagua_tpu_torch.communication import default_axes
    from bagua_tpu_torch.utils import tree_map

    group = ddp.group
    if state.optimizer is not None:
        state = meta_state(ddp, state)
    batch = tree_map(lambda t: torch.empty_like(t, device=_META), batch)
    prev = (ddp._capture, ddp._ir_capture)
    with on_meta(), capture_program() as events, capture_collectives() as descriptors, \
            default_axes(group.data_axes):
        # the engine's overlap hooks re-enter both captures and the meta
        # mode; its step skips the health read and the update under a capture
        ddp._capture, ddp._ir_capture = events, descriptors
        try:
            ddp._step(state, batch)
        finally:
            ddp._capture, ddp._ir_capture = prev
    program = CollectiveProgram(collectives=list(descriptors), axis_sizes=dict(zip(group.all_axes, group.shape)))
    return program, list(events)


def predict_flight_program(
    program: CollectiveProgram, cfg: WireModelConfig, variant: str = "default"
) -> List[Dict]:
    """The flight program the IR implies, in ``_flight_finalize``'s record
    shape: one annotate record per ``(bucket, phase)`` exchange scope, plus
    one ``phase="hop"`` ring record per quantized reduce-scatter/all-gather
    leg (bytes = the leg's summed ring-model wire bytes)."""
    plan, pv = cfg.plan, cfg.plan_version
    records: List[Dict] = []
    for (algo, b, phase), descs in program.by_bucket_phase().items():
        spec = plan.specs[b] if 0 <= b < len(plan.specs) else None
        prec = (
            cfg.precisions[b]
            if b < len(cfg.precisions) and spec is not None else "f32"
        )
        if spec is not None and spec.dtype not in ("f32", "f16", "bf16"):
            prec = "f32"
        rec = {
            "algo": algo, "bucket": b, "phase": phase,
            "nbytes": int(spec.nbytes) if spec is not None else 0,
            "precision": prec,
            "plan_version": pv, "variant": str(variant),
            "label": format_exchange_label(algo, b, phase),
        }
        if cfg.exchange_axes:
            # annotate() stamps the mesh axes the exchange rides; the
            # prediction must carry the same field for the record-for-record
            # static/dynamic comparison.
            rec["axes"] = list(cfg.exchange_axes)
        records.append(rec)
        hop_descs = [d for d in descs if d.qr and d.qr["stage"] == "hop"]
        ag_descs = [d for d in descs if d.qr and d.qr["stage"] == "ag"]
        for ring_kind, leg in (("rs", hop_descs), ("ag", ag_descs)):
            if not leg:
                continue
            bits = leg[0].qr["bits"]
            records.append({
                "algo": algo, "bucket": b, "phase": "hop",
                "ring": ring_kind, "bits": bits,
                "hops": leg[0].ring_size - 1,
                "nbytes": sum(d.wire_bytes for d in leg),
                "precision": f"int{bits}",
                "plan_version": pv, "variant": str(variant),
                "label": format_exchange_label(algo, b, "hop"),
            })
    return records


def verify_collective_program(
    program: CollectiveProgram,
    cfg: WireModelConfig,
    payload: Optional[Dict] = None,
    captured: Optional[Sequence[Dict]] = None,
    variant: str = "default",
) -> VerifyReport:
    """Run the four checkers over an already-captured IR.  ``captured`` is
    the flight recorder's (finalized) record list for the same pass; when
    omitted — or when the algorithm's record program is not modeled — check
    4 reports an info finding instead of comparing."""
    findings = list(check_rank_invariance(program))
    wire_findings, wire_table = check_wire_exactness(program, cfg)
    findings += wire_findings
    findings += check_plan_conformance(program, cfg, payload=payload)
    predicted = predict_flight_program(program, cfg, variant=variant)
    if captured is not None and cfg.algo in MODELED_ALGOS:
        findings += check_static_dynamic(predicted, captured)
    else:
        findings.append(
            Finding(
                check="static_dynamic",
                severity="info",
                message=(
                    "no flight capture supplied"
                    if captured is None
                    else f"record program for {cfg.algo!r} is not modeled; "
                         "comparison skipped"
                ),
            )
        )
    return VerifyReport(
        algo=cfg.algo,
        variant=str(variant),
        findings=findings,
        wire_table=wire_table,
        predicted=predicted,
        captured=list(captured or ()),
        num_collectives=len(program.collectives),
    )


def verify_step_program(
    ddp,
    state,
    batch,
    variant: str = "default",
    payload: Optional[Dict] = None,
) -> VerifyReport:
    """Statically verify one step variant of a live engine, pre-dispatch.

    A :func:`dry_run` of the engine's step on meta copies of ``state``
    (a live state, or a :func:`meta_state`) and ``batch`` captures the IR
    and the flight program in one pass; the capture is finalized through
    the engine's own ``_flight_finalize`` (single source of truth for
    record enrichment) and all four checks run."""
    cfg = WireModelConfig.from_engine(ddp)
    program, events = dry_run(ddp, state, batch)
    captured = list(ddp._flight_finalize(variant, events))
    return verify_collective_program(
        program, cfg, payload=payload, captured=captured, variant=variant
    )
