"""The four static checkers over a :class:`~bagua_tpu_torch.analysis.collective_ir.CollectiveProgram`.

The port of ``bagua_tpu/analysis/checks.py``, the same checkers over the
port's captured IR; only the engine-facing reads of
:meth:`WireModelConfig.from_engine` differ (the group's axes and sizes,
a torch ``wire_dtype``).

Each checker returns a list of :class:`Finding`; a ``severity="error"``
finding is what ``BAGUA_STATIC_VERIFY=strict`` turns into a
:class:`StaticVerifyError` *before dispatch*:

1. :func:`check_rank_invariance` — no collective may sit under a ``cond``/
   ``while`` whose predicate can depend on ``axis_index``-derived values.
   Different ranks taking different branches around a collective is the
   first-desync class the flight recorder can only attribute post-mortem;
   here it is an error before dispatch naming the branch label (the
   port's flag: :mod:`~bagua_tpu_torch.analysis.collective_ir`).
2. :func:`check_wire_exactness` — per ``(bucket, phase)`` the IR's summed
   ring-model bytes must equal the planner's analytic wire model
   **exactly** (``ring_wire_bytes`` for quantized buckets, the
   ``2N(n-1)/n`` / ``N(n-1)/n`` / ``N(n-1)`` α–β legs otherwise).  The
   perf-audit wire census measures this; the checker proves it.
3. :func:`check_plan_conformance` — the traced per-bucket precision and
   phase sequence must match the adopted plan: every bucket present, the
   quantized-ring bits per bucket equal to the planner's
   ``bucket_precisions``, the int4 error-feedback fence
   (``holds_bucketized_state`` ⇒ no overlap, no int4 ring in an
   ``overlap`` phase), zero's rs+ag-no-allreduce contract, and — when an
   exported plan payload is supplied — a matching ``plan_version``.
4. :func:`check_static_dynamic` — the verifier's *predicted* flight
   program must equal the flight recorder's *captured* one
   record-for-record (label, bytes, precision, plan version), so the two
   subsystems certify each other.

The wire models are driven by an explicit :class:`WireModelConfig` rather
than a live engine, so adversarial tests can describe a program that was
never constructed; :meth:`WireModelConfig.from_engine` derives one from a
running :class:`~bagua_tpu_torch.ddp.DistributedDataParallel`.

Scope: the byte/conformance contracts cover the algorithms whose wire
programs the planner prices — ``gradient_allreduce`` and ``zero`` (any
``wire_precision``, fuse mode, hierarchy).  Other algorithms' buckets are
reported as ``modeled: false`` rows (checks 1 still covers them; 3/4 run
where their contracts apply).
"""

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from bagua_tpu_torch.analysis.collective_ir import CollectiveProgram

__all__ = [
    "CHECK_NAMES",
    "MODELED_ALGOS",
    "Finding",
    "StaticVerifyError",
    "WireModelConfig",
    "check_rank_invariance",
    "check_wire_exactness",
    "check_plan_conformance",
    "check_static_dynamic",
    "canonical_records",
]

CHECK_NAMES = (
    "rank_invariance",
    "wire_exactness",
    "plan_conformance",
    "static_dynamic",
)

#: algorithms whose full per-bucket wire/conformance contract is modeled
MODELED_ALGOS = ("gradient_allreduce", "zero")

_FLOAT_DTYPES = ("f32", "f16", "bf16")
_PRECISION_BITS = {"int8": 8, "int4": 4}


@dataclasses.dataclass
class Finding:
    """One verifier result.  ``check`` is a :data:`CHECK_NAMES` entry,
    ``label`` the source named-scope label the failure attributes to."""

    check: str
    severity: str  # "error" | "info"
    message: str
    label: str = ""
    bucket: Optional[int] = None

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        at = f" [{self.label}]" if self.label else ""
        return f"{self.check}: {self.message}{at}"


class StaticVerifyError(RuntimeError):
    """Raised under ``BAGUA_STATIC_VERIFY=strict`` — the program never
    dispatches.  Carries the error findings with check name + source label."""

    def __init__(self, findings: Sequence[Finding]):
        self.findings = [f for f in findings if f.severity == "error"]
        lines = "\n".join(f"  - {f}" for f in self.findings)
        super().__init__(
            f"static collective-program verification failed "
            f"({len(self.findings)} error(s)):\n{lines}"
        )


# ---------------------------------------------------------------------------
# Wire model configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WireModelConfig:
    """Everything the analytic wire models need, detached from any engine."""

    algo: str
    plan: Any                       #: BucketPlan (specs with numel/nbytes/slots)
    n: int                          #: exchange-ring size (== gang size on 1-D meshes)
    n_intra: int = 1                #: intra-axis size (hierarchical legs)
    n_inter: int = 1
    #: mesh axes the engine's exchange is allowed to ride (named meshes);
    #: empty = unconstrained (legacy 1-D config).  The axis-conformance arm
    #: of check_plan_conformance errors on any exchange-scope collective
    #: touching an axis outside this set — "dp collectives on the dp axis
    #: only".
    exchange_axes: Tuple[str, ...] = ()
    #: every axis of a NAMED mesh (empty on legacy (inter, intra) groups) —
    #: the perflab cost bridge routes single-axis collectives to per-axis
    #: ``axis:<name>`` cost legs when this is set.
    mesh_axes: Tuple[str, ...] = ()
    precisions: Sequence[str] = ()  #: resolved per-bucket wire precision
    fuse: str = "tuple"
    hierarchical: bool = False
    wire_itemsize: Optional[int] = None  #: wire_dtype itemsize for float buckets
    compression: Optional[str] = None    #: zero's "bytegrad" (unmodeled)
    plan_version: int = 0
    overlap_enabled: bool = False
    holds_bucketized_state: bool = False
    #: the algorithm's overlap execution mode ("gradient" | "weight" |
    #: "post_step") — the bucketized-state fence only applies to the
    #: stateless per-bucket backward hook ("gradient")
    overlap_mode: str = "gradient"

    @classmethod
    def from_engine(cls, ddp) -> "WireModelConfig":
        impl, plan, group = ddp.impl, ddp.plan, ddp.group
        if plan is None:
            raise ValueError("engine has no bucket plan yet; call init() first")
        if hasattr(impl, "bucket_precisions"):
            precisions = list(impl.bucket_precisions(plan))
        else:
            precisions = ["f32"] * len(plan.specs)
        wd = getattr(impl, "wire_dtype", None)
        mesh = dict(zip(group.all_axes, group.shape))
        # The ring the exchange rides: every axis on legacy meshes, the data
        # axes only on named meshes (tp/sp peers each keep a full ring).
        exchange_size = getattr(group, "exchange_size", group.size)
        exchange_axes = tuple(getattr(group, "data_axes", ()) or ())
        mesh_axes = (
            tuple(group.all_axes)
            if getattr(group, "mesh_spec", None) is not None else ()
        )
        return cls(
            algo=getattr(impl, "algo_name", type(impl).__name__),
            plan=plan,
            n=exchange_size,
            n_intra=int(mesh.get("intra", 1)),
            n_inter=int(mesh.get("inter", 1)),
            exchange_axes=exchange_axes,
            mesh_axes=mesh_axes,
            precisions=precisions,
            fuse=getattr(impl, "fuse", "tuple"),
            hierarchical=bool(getattr(impl, "hierarchical", False)),
            wire_itemsize=None if wd is None else int(wd.itemsize),
            compression=getattr(impl, "compression", None),
            plan_version=int(ddp.plan_version),
            overlap_enabled=bool(ddp.overlap_enabled),
            holds_bucketized_state=bool(
                getattr(impl, "holds_bucketized_state", False)
            ),
            overlap_mode=getattr(impl, "overlap_mode", "gradient"),
        )

    # -- per-bucket analytic models -----------------------------------------

    def _itemsize(self, spec) -> int:
        from bagua_tpu_torch.defs import dtype_itemsize

        native = dtype_itemsize(spec.dtype)
        if self.wire_itemsize is not None and spec.dtype in _FLOAT_DTYPES:
            return self.wire_itemsize
        return native

    def _allreduce_legs(self, payload: int) -> int:
        if self.hierarchical:
            ni, ne = self.n_intra, self.n_inter
            return (
                2 * payload * (ni - 1) // ni + 2 * payload * (ne - 1) // ne
            )
        return 2 * payload * (self.n - 1) // self.n

    def expected_bucket_bytes(self, bucket: int, phase: str) -> Optional[int]:
        """The planner's analytic wire bytes for one ``(bucket, phase)`` of
        this config's algorithm — None when the phase is unmodeled."""
        # imported here: the ring's module imports the collectives, which
        # import this package's capture
        from bagua_tpu_torch.kernels.quantized_ring import ring_wire_bytes

        spec = self.plan.specs[bucket]
        prec = (
            self.precisions[bucket]
            if bucket < len(self.precisions) else "f32"
        )
        if self.algo == "gradient_allreduce" and phase in ("mono", "overlap"):
            if prec in _PRECISION_BITS:
                bits = _PRECISION_BITS[prec]
                if self.hierarchical:
                    # exact f32 intra sum of the flat + quantized inter ring
                    intra = 2 * spec.numel * 4 * (self.n_intra - 1) // self.n_intra
                    return intra + ring_wire_bytes(spec.numel, self.n_inter, bits)
                return ring_wire_bytes(spec.numel, self.n, bits)
            itemsize = self._itemsize(spec)
            mixed = any(p in _PRECISION_BITS for p in self.precisions)
            # variadic (unpadded) payload unless the flat buffer is
            # materialized: flat fuse on the all-f32 paths
            variadic = self.fuse == "tuple" or (mixed and phase == "mono")
            payload = (
                sum(s.numel for s in spec.slots) * itemsize
                if variadic else spec.numel * itemsize
            )
            return self._allreduce_legs(payload)
        if self.algo == "zero":
            if self.compression is not None:
                return None  # bytegrad's alltoall program: unmodeled
            if phase == "ag":
                # tiled all_gather of the (numel/n,) pending shard
                return (spec.nbytes // self.n) * (self.n - 1)
            if phase == "rs":
                if prec in _PRECISION_BITS and spec.dtype in _FLOAT_DTYPES:
                    # the quantized ring's reduce-scatter leg only
                    return ring_wire_bytes(
                        spec.numel, self.n, _PRECISION_BITS[prec]
                    ) // 2
                return spec.nbytes * (self.n - 1) // self.n
        return None


# ---------------------------------------------------------------------------
# Check 1: rank invariance
# ---------------------------------------------------------------------------


def _stale_sanctioned_ids(program: CollectiveProgram) -> set:
    """Descriptor ids the bounded-staleness sanction clears.

    A rank-conditional collective is tolerated — downgraded from error to
    info — only when (a) it carries the ``bagua_stale/tau=<k>`` scope
    marker (:func:`~bagua_tpu_torch.observability.scope_grammar.format_stale_scope`),
    and (b) **every** sibling branch of its innermost rank-conditional
    ``cond`` moves identical wire bytes.  Under those conditions the
    branches differ in *payload* (fresh vs last-published buckets), not in
    whether the exchange runs, so ranks stay in lockstep on the wire and
    the per-round byte census is preserved exactly.  Note the engine's own
    staleness modes never trip this path at all — they gate payloads with
    elementwise ``where`` selects, not ``cond`` — so the sanction exists
    for hand-rolled bounded-staleness programs the descriptor marks
    explicitly."""
    sanctioned: set = set()
    by_cond: Dict[str, Dict[str, List]] = {}
    for d in program.collectives:
        if not d.rank_conditional or d.stale is None:
            continue
        conds = [p for p in d.path if p.startswith("cond#")]
        if not conds:
            continue
        cid, _, branch = conds[-1].partition("@")
        by_cond.setdefault(cid, {}).setdefault(branch, []).append(d)
    for branches in by_cond.values():
        if len(branches) < 2:
            continue  # single-branch: ranks could skip the exchange outright
        signatures = {
            tuple(sorted((d.primitive, d.wire_bytes) for d in descs))
            for descs in branches.values()
        }
        if len(signatures) == 1:
            for descs in branches.values():
                sanctioned.update(id(d) for d in descs)
    return sanctioned


def check_rank_invariance(program: CollectiveProgram) -> List[Finding]:
    """No collective under a control-flow predicate that can depend on
    rank-varying (``axis_index``-derived) values.

    One sanctioned exception: a collective carrying the bounded-staleness
    scope marker whose innermost rank-conditional ``cond`` has ≥2 sibling
    branches moving identical wire bytes (see
    :func:`_stale_sanctioned_ids`) is reported as ``info`` instead —
    the wire program is byte-identical either way the predicate falls."""
    out = []
    sanctioned = _stale_sanctioned_ids(program)
    for d in program.collectives:
        if not d.rank_conditional:
            continue
        if id(d) in sanctioned:
            out.append(
                Finding(
                    check="rank_invariance",
                    severity="info",
                    message=(
                        f"{d.primitive} over axes {d.axes} is "
                        f"rank-conditional but sanctioned: bounded-staleness "
                        f"marker tau={d.stale} with byte-identical sibling "
                        "branches — wire census preserved per round"
                    ),
                    label=d.label,
                    bucket=d.bucket,
                )
            )
            continue
        out.append(
            Finding(
                check="rank_invariance",
                severity="error",
                message=(
                    f"{d.primitive} over axes {d.axes} executes under a "
                    f"rank-conditional predicate ({d.cond_label or 'cond'}): "
                    "ranks can disagree on whether this collective runs — "
                    "guaranteed desync"
                ),
                label=d.label,
                bucket=d.bucket,
            )
        )
    return out


# ---------------------------------------------------------------------------
# Check 2: wire-byte exactness
# ---------------------------------------------------------------------------


def _branch_deduped_bytes(items: List[Tuple[Tuple[str, ...], int]]) -> int:
    """Wire bytes one runtime execution of a descriptor group moves.

    The walker records *every* branch of a ``cond`` but only one executes,
    so summing naively double-counts an exchange scope whose collectives
    appear in sibling branches.  ``items`` pairs each descriptor's
    cond-frames path (the ``"cond#<eqn>@<branch>"`` entries of
    ``CollectiveDescriptor.path``) with its wire bytes; descriptors in
    sibling branches of the same cond contribute the **max** across
    branches — exact when the branches move equal bytes (the only layout
    the exactness contract can hold for anyway), best-effort otherwise."""
    total = 0
    by_cond: Dict[str, Dict[str, List[Tuple[Tuple[str, ...], int]]]] = {}
    for path, nbytes in items:
        if not path:
            total += nbytes
            continue
        cid, _, branch = path[0].partition("@")
        by_cond.setdefault(cid, {}).setdefault(branch, []).append(
            (path[1:], nbytes)
        )
    for branches in by_cond.values():
        total += max(_branch_deduped_bytes(sub) for sub in branches.values())
    return total


def check_wire_exactness(
    program: CollectiveProgram, cfg: WireModelConfig
) -> Tuple[List[Finding], List[Dict]]:
    """Summed IR wire bytes per ``(bucket, phase)`` vs the analytic model
    (mutually-exclusive cond branches de-duplicated, see
    :func:`_branch_deduped_bytes`).

    Returns ``(findings, table)`` — the table has one row per labeled
    bucket-phase group with ``observed``/``expected``/``modeled`` fields
    (the report's evidence)."""
    findings: List[Finding] = []
    table: List[Dict] = []
    for (algo, bucket, phase), descs in program.by_bucket_phase().items():
        observed = _branch_deduped_bytes([
            (
                tuple(p for p in d.path if p.startswith("cond#")),
                d.wire_bytes,
            )
            for d in descs
        ])
        expected = (
            cfg.expected_bucket_bytes(bucket, phase)
            if algo == cfg.algo and bucket < len(cfg.plan.specs) else None
        )
        row = {
            "algo": algo,
            "bucket": bucket,
            "phase": phase,
            "collectives": len(descs),
            "observed_bytes": observed,
            "expected_bytes": expected,
            "modeled": expected is not None,
        }
        table.append(row)
        if expected is not None and observed != expected:
            findings.append(
                Finding(
                    check="wire_exactness",
                    severity="error",
                    message=(
                        f"bucket {bucket} phase {phase!r}: traced wire bytes "
                        f"{observed} != planner model {expected} "
                        f"(delta {observed - expected:+d})"
                    ),
                    label=descs[0].label,
                    bucket=bucket,
                )
            )
    return findings, table


# ---------------------------------------------------------------------------
# Check 3: plan conformance
# ---------------------------------------------------------------------------


def _observed_precisions(program: CollectiveProgram, cfg: WireModelConfig) -> Dict[int, str]:
    """Per-bucket precision the trace actually uses: the quantized-ring
    sub-scopes' bit width, f32 in their absence."""
    out: Dict[int, str] = {}
    for d in program.labeled():
        if d.algo != cfg.algo:
            continue
        b = d.bucket
        if d.qr is not None:
            out[b] = f"int{d.qr['bits']}"
        else:
            out.setdefault(b, "f32")
    return out


def check_plan_conformance(
    program: CollectiveProgram,
    cfg: WireModelConfig,
    payload: Optional[Dict] = None,
) -> List[Finding]:
    """Traced precision/phase sequence vs the adopted plan (+ optional
    exported plan payload for version conformance)."""
    findings: List[Finding] = []
    groups = program.by_bucket_phase()

    # stale / mismatched plan payload
    if payload is not None:
        pv = int(payload.get("plan_version", -1))
        if pv != cfg.plan_version:
            findings.append(
                Finding(
                    check="plan_conformance",
                    severity="error",
                    message=(
                        f"plan payload carries plan_version={pv} but the "
                        f"engine adopted plan_version={cfg.plan_version}: "
                        "stale plan — re-export before verifying against it"
                    ),
                )
            )
        buckets = payload.get("buckets")
        if buckets is not None and len(buckets) != len(cfg.plan.specs):
            findings.append(
                Finding(
                    check="plan_conformance",
                    severity="error",
                    message=(
                        f"plan payload declares {len(buckets)} buckets, "
                        f"engine plan has {len(cfg.plan.specs)}"
                    ),
                )
            )

    # the int4 error-feedback fence: bucketized residual state cannot ride
    # the stateless per-bucket backward hook.  Only the "gradient" overlap
    # mode uses that hook — "post_step"/"weight" algorithms keep their
    # bucketized state on the ordinary step path and overlap legitimately.
    if (
        cfg.holds_bucketized_state
        and cfg.overlap_enabled
        and cfg.overlap_mode == "gradient"
    ):
        findings.append(
            Finding(
                check="plan_conformance",
                severity="error",
                message=(
                    "algorithm holds bucketized state (int4 qr_residual) "
                    "with overlap enabled — the residual cannot thread "
                    "through the stateless backward hook"
                ),
            )
        )
    for (algo, bucket, phase), descs in groups.items():
        if algo != cfg.algo:
            continue
        if phase == "overlap" and any(
            d.qr is not None and d.qr["bits"] == 4 for d in descs
        ):
            findings.append(
                Finding(
                    check="plan_conformance",
                    severity="error",
                    message=(
                        f"bucket {bucket}: int4 quantized ring inside an "
                        "overlap phase — int4 error feedback is fenced to "
                        "the monolithic path"
                    ),
                    label=descs[0].label,
                    bucket=bucket,
                )
            )

    # axis conformance (named meshes): every collective inside one of this
    # algorithm's exchange scopes must ride the exchange axes only — a dp
    # collective leaking onto a model axis (tp/sp) would silently average
    # across tensor-parallel shards.
    if cfg.exchange_axes:
        allowed = set(cfg.exchange_axes)
        for (algo, bucket, phase), descs in groups.items():
            if algo != cfg.algo:
                continue
            for d in descs:
                stray = [a for a in d.axes if a not in allowed]
                if stray:
                    findings.append(
                        Finding(
                            check="plan_conformance",
                            severity="error",
                            message=(
                                f"bucket {bucket} phase {phase!r}: "
                                f"{d.primitive} rides mesh axes "
                                f"{tuple(d.axes)} but the exchange is "
                                f"confined to {cfg.exchange_axes} — stray "
                                f"axes {tuple(stray)}"
                            ),
                            label=d.label,
                            bucket=bucket,
                        )
                    )

    if cfg.algo not in MODELED_ALGOS:
        return findings

    # per-bucket precision vs the planner's resolution
    observed = _observed_precisions(program, cfg)
    for b, spec in enumerate(cfg.plan.specs):
        planned = cfg.precisions[b] if b < len(cfg.precisions) else "f32"
        if cfg.algo == "zero" and (
            spec.dtype not in _FLOAT_DTYPES or cfg.compression is not None
        ):
            planned = "f32"
        got = observed.get(b)
        if got is None:
            findings.append(
                Finding(
                    check="plan_conformance",
                    severity="error",
                    message=(
                        f"bucket {b} never appears in the traced exchange "
                        "program (missing collective)"
                    ),
                    bucket=b,
                )
            )
            continue
        if got != planned:
            findings.append(
                Finding(
                    check="plan_conformance",
                    severity="error",
                    message=(
                        f"bucket {b}: traced wire precision {got} != "
                        f"planned {planned}"
                    ),
                    bucket=b,
                )
            )

    # zero's contract: one rs + one ag per bucket, and never an all-reduce
    # inside an exchange scope (the whole point of sharding the update)
    if cfg.algo == "zero":
        for b in range(len(cfg.plan.specs)):
            for ph in ("rs", "ag"):
                if (cfg.algo, b, ph) not in groups:
                    findings.append(
                        Finding(
                            check="plan_conformance",
                            severity="error",
                            message=f"bucket {b}: zero is missing its "
                                    f"{ph!r} leg",
                            bucket=b,
                        )
                    )
        for (algo, bucket, phase), descs in groups.items():
            bad = [d for d in descs if d.primitive in ("psum", "pmax", "pmin")]
            if algo == cfg.algo and bad:
                findings.append(
                    Finding(
                        check="plan_conformance",
                        severity="error",
                        message=(
                            f"bucket {bucket} phase {phase!r}: {bad[0].primitive} "
                            "(all-reduce) inside a zero exchange scope — the "
                            "rs+ag contract forbids full-bucket reductions"
                        ),
                        label=bad[0].label,
                        bucket=bucket,
                    )
                )
    return findings


# ---------------------------------------------------------------------------
# Check 4: static/dynamic agreement
# ---------------------------------------------------------------------------


def canonical_records(records: Sequence[Dict]) -> List[Dict]:
    """Order-insensitive canonical form of a flight program: the capture's
    order and the prediction's legitimately differ (the overlap hooks issue
    buckets in the backward's order), so both sides sort on the stable
    identity key before the record-for-record comparison."""
    return sorted(
        (dict(r) for r in records),
        key=lambda r: (
            int(r.get("bucket", -1)),
            str(r.get("phase", "")),
            str(r.get("ring", "")),
            int(r.get("bits", 0)),
            str(r.get("label", "")),
        ),
    )


def check_static_dynamic(
    predicted: Sequence[Dict], captured: Sequence[Dict]
) -> List[Finding]:
    """Predicted flight program (from the IR) vs the recorder's captured
    one — must agree label-for-label, byte-for-byte."""
    pred = canonical_records(predicted)
    capt = canonical_records(captured)
    findings: List[Finding] = []
    if len(pred) != len(capt):
        findings.append(
            Finding(
                check="static_dynamic",
                severity="error",
                message=(
                    f"predicted program has {len(pred)} records, flight "
                    f"recorder captured {len(capt)}"
                ),
            )
        )
    for p, c in zip(pred, capt):
        if p == c:
            continue
        keys = sorted(set(p) | set(c))
        diffs = [
            f"{k}: predicted={p.get(k)!r} captured={c.get(k)!r}"
            for k in keys
            if p.get(k) != c.get(k)
        ]
        findings.append(
            Finding(
                check="static_dynamic",
                severity="error",
                message=(
                    f"record mismatch ({'; '.join(diffs)})"
                ),
                label=str(c.get("label", p.get("label", ""))),
                bucket=c.get("bucket", p.get("bucket")),
            )
        )
    return findings
