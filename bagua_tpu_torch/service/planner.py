"""Trace-driven bucket planner: an analytical partitioner over measured spans.

BAGUA's central claim (arXiv:2107.01499) is that bucket partitioning should
be tuned from *execution telemetry*, not a fixed byte threshold.  The service
already learns tensor-ready order from reported spans; this module closes
the loop analytically, T3-style (arXiv:2401.16677: schedule collectives
against the measured compute timeline):

* **Inputs** — per-tensor cotangent arrival times (seconds into the
  backward pass, from ``DistributedDataParallel.profile_bucket_order``'s
  single-probe capture) and per-bucket measured wire timings / hidden
  fractions (from ``observability.trace_analysis`` rows, shipped as
  ``bucket_wire`` spans).
* **Cost model** — an α–β fit per wire path (latency + bytes/bandwidth);
  hierarchical reduction is modeled as two legs (intra-axis psum + inter-axis
  exchange over ``bytes/intra_size``) fitted separately from leg-tagged
  samples.
* **Solver** — dynamic programming over *contiguous* partitions of the
  arrival-ordered tensor timeline, minimizing predicted **exposed**
  (un-hidden) communication time.  Buckets stay dtype-homogeneous
  (``BucketPlan.from_declarations`` rejects mixed dtypes) and a
  ``max_bucket_bytes`` cap can constrain the partition so the Bayesian
  optimizer's ``bucket_size_2p`` dimension keeps meaning.

The exposed-time model: collectives serialize on the wire; bucket *b* may
start once its last tensor has arrived and the previous collective finished,
so with arrival-sorted buckets::

    finish_b = max(finish_{b-1}, ready_b) + wire_time(bytes_b)
    tail     = max(0, finish_last - backward_end)

``tail`` is what the overlap of exchange and backward cannot hide.  A measured
``overlap_efficiency`` η ∈ [0, 1] (aggregate ``measured_overlap_frac`` from
the device trace) calibrates how much of the in-backward wire time the
backend actually hides::

    predicted_exposed = η · tail + (1 − η) · total_wire

η = 1 (default) trusts the scheduler fully — minimize the tail; η = 0 models
a backend that serializes everything — minimize total wire (fewest launches).
The DP tracks a Pareto frontier over (cost, finish) per prefix, so the
returned partition is optimal for this objective, not just greedy.

``holds_bucketized_state`` algorithms cannot re-bucket mid-training
(``DistributedDataParallel.rebucket`` raises); callers gate on that before
adopting a plan — the :class:`~bagua_tpu_torch.ddp.AutotuneSession` already does.
"""

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from bagua_tpu_torch.defs import TensorDeclaration, dtype_itemsize

__all__ = [
    "WireSample",
    "AlphaBeta",
    "CostModel",
    "BucketPlanner",
    "PlanResult",
    "fit_alpha_beta",
    "quantized_hop_bytes",
]


@dataclasses.dataclass(frozen=True)
class WireSample:
    """One measured collective: ``nbytes`` on the wire took ``seconds``.

    ``leg`` tags the wire path: ``"flat"`` (single-level exchange),
    ``"intra"`` (hierarchical intra-axis reduce), ``"inter"``
    (hierarchical cross-axis exchange), ``"rs"`` (sharded reduce-scatter,
    the ``zero`` algorithm's in-backward leg), ``"ag"`` (the deferred
    parameter all-gather riding the next step's forward), ``"pp"`` (one
    neighbor ``ppermute`` hop of a fused collective-matmul ring — see
    :mod:`bagua_tpu_torch.kernels.collective_matmul`) or ``"qr8"`` / ``"qr4"``
    (one hop of the blockwise-quantized ring — the compressed-payload
    ``ppermute`` plus the fused dequant-reduce-requant kernel, see
    :mod:`bagua_tpu_torch.kernels.quantized_ring`; ``nbytes`` is the hop's
    compressed payload + sidecar).  ``hidden_frac`` is the span's measured
    overlap fraction from the device trace, if attributed.

    ``axis`` tags the named mesh axis the collective rode (``"dp"``,
    ``"tp"``, ...) on named-mesh engines; :meth:`CostModel.from_samples`
    fits one α–β leg per tagged axis so a dp-ring exchange and a tp
    activation exchange are priced on their own links.  ``None`` (legacy
    meshes) keeps the sample on its ``leg`` fit."""

    nbytes: float
    seconds: float
    leg: str = "flat"
    hidden_frac: Optional[float] = None
    axis: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class AlphaBeta:
    """``time(n) = alpha + n / beta`` — launch latency plus bandwidth term."""

    alpha: float  # seconds
    beta: float  # bytes / second
    n_samples: int = 0

    def predict(self, nbytes: float) -> float:
        return self.alpha + max(0.0, nbytes) / self.beta


# Priors used until measurements arrive: the JAX package's (set for its
# TPU: ~100 µs collective launch, ~40 GB/s effective ring bandwidth; the
# intra leg fast, the inter leg slower), kept as they are and not measured
# on a GPU.  Only the *relative* ranking of partitions matters before real
# samples are reported, and ``report_wire_timings`` replaces them.
DEFAULT_FLAT = AlphaBeta(alpha=100e-6, beta=40e9)
DEFAULT_INTRA = AlphaBeta(alpha=30e-6, beta=100e9)
DEFAULT_INTER = AlphaBeta(alpha=200e-6, beta=25e9)
# Sharded (ZeRO) legs: a reduce-scatter or all-gather moves (n-1)/n of the
# payload around the ring — half an allreduce's traffic each — so the
# effective bandwidth prior sits above the flat allreduce prior.
DEFAULT_RS = AlphaBeta(alpha=100e-6, beta=80e9)
DEFAULT_AG = AlphaBeta(alpha=100e-6, beta=80e9)
# One ring hop of a fused collective matmul: a single neighbor-to-neighbor
# ppermute — no reduction tree, no cross-rank synchronization beyond
# the neighbor, so the launch latency prior sits well below a full collective
# and the bandwidth prior at the per-link rate.
DEFAULT_PP = AlphaBeta(alpha=20e-6, beta=90e9)
# One hop of the blockwise-quantized ring: the same neighbor ppermute as pp
# but carrying a compressed payload AND running the fused
# dequant-reduce-requant kernel before the send, so the latency prior sits
# above pp (quantization math per hop) while the bandwidth prior stays near
# the per-link rate.  int4 pays extra nibble pack/unpack arithmetic per byte.
DEFAULT_QR8 = AlphaBeta(alpha=30e-6, beta=90e9)
DEFAULT_QR4 = AlphaBeta(alpha=40e-6, beta=80e9)

#: quantization block size mirrored from
#: :data:`bagua_tpu_torch.kernels.quantized_ring.DEFAULT_BLOCK` — the planner is
#: deliberately free of torch, so it re-states the constant instead of importing
#: the kernel module (parity is pinned by ``tests/test_planner.py``).
QR_BLOCK = 4096


def quantized_hop_bytes(numel: int, n_ranks: int, bits: int, block: int = QR_BLOCK) -> int:
    """Bytes of one quantized-ring hop (compressed shard payload + f32
    min/max sidecar) — the pure-Python mirror of
    :func:`bagua_tpu_torch.kernels.quantized_ring.ring_wire_bytes` divided by its
    ``2 * (n - 1)`` hops, kept import-free so the planner stays device-less."""
    n = int(n_ranks)
    if n <= 1:
        return 0
    shard = -(-(int(numel) // n) // block) * block  # padded shard elems
    nblocks = shard // block
    payload = shard // (1 if bits == 8 else 2)
    return payload + nblocks * 8


def fit_alpha_beta(
    samples: Sequence[WireSample], default: AlphaBeta = DEFAULT_FLAT
) -> AlphaBeta:
    """Least-squares α–β fit over measured (bytes, seconds) pairs.

    Degenerate inputs degrade gracefully: no samples → the prior; all
    samples at one size → keep the prior's α and solve β from the mean;
    a fit with negative α is re-solved through the origin-latency clamp."""
    pts = [(float(s.nbytes), float(s.seconds)) for s in samples if s.seconds > 0]
    if not pts:
        return default
    n = len(pts)
    mean_b = sum(b for b, _ in pts) / n
    mean_t = sum(t for _, t in pts) / n
    var_b = sum((b - mean_b) ** 2 for b, _ in pts) / n
    if var_b <= 0.0:
        # single operating point: attribute the prior's latency, rest is wire
        bw_t = max(mean_t - default.alpha, 1e-9)
        return AlphaBeta(alpha=min(default.alpha, mean_t), beta=max(mean_b / bw_t, 1e3), n_samples=n)
    cov = sum((b - mean_b) * (t - mean_t) for b, t in pts) / n
    inv_beta = cov / var_b
    alpha = mean_t - inv_beta * mean_b
    if inv_beta <= 0.0:
        # bandwidth term indistinguishable from noise: pure-latency model
        return AlphaBeta(alpha=max(mean_t, 1e-9), beta=default.beta, n_samples=n)
    if alpha < 0.0:
        alpha, inv_beta = 0.0, mean_t / max(mean_b, 1.0)
    return AlphaBeta(alpha=alpha, beta=1.0 / max(inv_beta, 1e-15), n_samples=n)


class CostModel:
    """Per-wire-path α–β models; hierarchical legs are modeled separately.

    ``bucket_wire_time(nbytes, hierarchical)`` predicts one bucket's
    collective: the flat path is a single exchange; the hierarchical path is
    an intra-axis reduce over the full payload followed by an inter-axis
    exchange over ``nbytes / intra_size`` (each intra group contributes one
    reduced copy to the cross-axis leg).  ``wire_pattern="sharded"`` models
    the ``zero`` algorithm's in-backward leg instead — one reduce-scatter
    per bucket (the deferred all-gather rides the *next* step's forward and
    is priced separately by :meth:`ag_time`, not charged to the backward
    tail this planner minimizes)."""

    def __init__(
        self,
        flat: AlphaBeta = DEFAULT_FLAT,
        intra: AlphaBeta = DEFAULT_INTRA,
        inter: AlphaBeta = DEFAULT_INTER,
        intra_size: int = 1,
        rs: AlphaBeta = DEFAULT_RS,
        ag: AlphaBeta = DEFAULT_AG,
        pp: AlphaBeta = DEFAULT_PP,
        qr8: AlphaBeta = DEFAULT_QR8,
        qr4: AlphaBeta = DEFAULT_QR4,
        axis_legs: Optional[Dict[str, AlphaBeta]] = None,
    ):
        self.flat = flat
        self.intra = intra
        self.inter = inter
        self.intra_size = max(1, int(intra_size))
        self.rs = rs
        self.ag = ag
        self.pp = pp
        self.qr8 = qr8
        self.qr4 = qr4
        #: per-named-mesh-axis α–β legs (``{"dp": ..., "tp": ...}``); a
        #: collective riding exactly one named axis is priced on its axis
        #: leg when one was fitted, the generic ``flat`` leg otherwise.
        self.axis_legs: Dict[str, AlphaBeta] = dict(axis_legs or {})

    def axis_leg(self, axis: str) -> AlphaBeta:
        """The α–β model for a collective riding one named mesh axis —
        the fitted per-axis leg, falling back to ``flat``."""
        return self.axis_legs.get(axis, self.flat)

    @classmethod
    def from_samples(
        cls, samples: Sequence[WireSample], intra_size: int = 1
    ) -> "CostModel":
        by_leg: Dict[str, List[WireSample]] = {}
        by_axis: Dict[str, List[WireSample]] = {}
        for s in samples:
            if getattr(s, "axis", None):
                by_axis.setdefault(s.axis, []).append(s)
            else:
                by_leg.setdefault(s.leg, []).append(s)
        return cls(
            flat=fit_alpha_beta(by_leg.get("flat", []), DEFAULT_FLAT),
            intra=fit_alpha_beta(by_leg.get("intra", []), DEFAULT_INTRA),
            inter=fit_alpha_beta(by_leg.get("inter", []), DEFAULT_INTER),
            intra_size=intra_size,
            rs=fit_alpha_beta(by_leg.get("rs", []), DEFAULT_RS),
            ag=fit_alpha_beta(by_leg.get("ag", []), DEFAULT_AG),
            pp=fit_alpha_beta(by_leg.get("pp", []), DEFAULT_PP),
            qr8=fit_alpha_beta(by_leg.get("qr8", []), DEFAULT_QR8),
            qr4=fit_alpha_beta(by_leg.get("qr4", []), DEFAULT_QR4),
            axis_legs={
                ax: fit_alpha_beta(ss, DEFAULT_FLAT)
                for ax, ss in by_axis.items()
            },
        )

    def bucket_wire_time(
        self,
        nbytes: float,
        hierarchical: bool = False,
        wire_pattern: str = "allreduce",
    ) -> float:
        if wire_pattern == "sharded":
            return self.rs.predict(nbytes)
        if hierarchical:
            return self.intra.predict(nbytes) + self.inter.predict(
                nbytes / self.intra_size
            )
        return self.flat.predict(nbytes)

    def ag_time(self, nbytes: float) -> float:
        """Predicted time of the deferred parameter all-gather for one
        bucket's full payload (the sharded pattern's second leg)."""
        return self.ag.predict(nbytes)

    def quantized_ring_wire_time(
        self, numel: int, n_ranks: int, precision: str, block: int = QR_BLOCK
    ) -> float:
        """Predicted wire time of one bucket's blockwise-quantized ring
        allreduce (:func:`~bagua_tpu_torch.kernels.quantized_ring.quantized_ring_allreduce`)
        over ``n_ranks``: ``2 * (n - 1)`` sequential hops (reduce-scatter then
        all-gather), each a neighbor exchange of the compressed shard priced
        through the fitted ``qr8`` / ``qr4`` leg."""
        leg = {"int8": self.qr8, "qr8": self.qr8, "int4": self.qr4, "qr4": self.qr4}[
            precision
        ]
        n = int(n_ranks)
        if n <= 1:
            return 0.0
        bits = 8 if leg is self.qr8 else 4
        hop = quantized_hop_bytes(numel, n, bits, block)
        return 2 * (n - 1) * leg.predict(hop)

    def ring_matmul_wire_time(self, nbytes: float, ring_size: int) -> float:
        """Total wire time of one fused collective-matmul ring
        (:func:`~bagua_tpu_torch.kernels.collective_matmul.ag_matmul` /
        :func:`~bagua_tpu_torch.kernels.collective_matmul.matmul_rs` over a
        ``ring_size`` axis): ``ring_size - 1`` neighbor ``ppermute`` hops,
        each carrying the per-rank shard (``nbytes / ring_size``).  This is
        the quantity the ring can hide under tile compute — compare it
        against ``flat.predict(nbytes)`` (the exposed psum it replaces) to
        decide whether fusing pays at a given payload size."""
        n = int(ring_size)
        if n <= 1:
            return 0.0
        return (n - 1) * self.pp.predict(nbytes / n)

    def describe(self) -> Dict:
        named = tuple(
            (f"axis:{ax}", m) for ax, m in sorted(self.axis_legs.items())
        )
        return {
            leg: {
                "alpha_us": round(m.alpha * 1e6, 3),
                "beta_gbps": round(m.beta / 1e9, 3),
                "n_samples": m.n_samples,
            }
            for leg, m in (
                ("flat", self.flat),
                ("intra", self.intra),
                ("inter", self.inter),
                ("rs", self.rs),
                ("ag", self.ag),
                ("pp", self.pp),
                ("qr8", self.qr8),
                ("qr4", self.qr4),
            ) + named
        }


@dataclasses.dataclass
class PlanResult:
    """A proposed partition plus its predicted timeline."""

    buckets: List[List[TensorDeclaration]]
    predicted_exposed_s: float
    predicted_tail_s: float
    total_wire_s: float
    n_buckets: int
    per_bucket: List[Dict]

    def summary(self) -> Dict:
        return {
            "n_buckets": self.n_buckets,
            "predicted_exposed_ms": round(self.predicted_exposed_s * 1e3, 4),
            "predicted_tail_ms": round(self.predicted_tail_s * 1e3, 4),
            "total_wire_ms": round(self.total_wire_s * 1e3, 4),
        }


def _decl_bytes(td: TensorDeclaration) -> int:
    return td.num_elements * dtype_itemsize(td.dtype)


class BucketPlanner:
    """DP bucket partitioner over the measured cotangent-arrival timeline.

    Args:
        declarations: communicable tensors (the registered tensor list).
        arrivals: ``{tensor_name: arrival_seconds}`` — when each cotangent
            becomes available in the backward pass.  Tensors without a
            measurement are conservatively placed at the latest arrival.
        cost_model: fitted :class:`CostModel` (default: priors only).
        overlap_efficiency: η calibration from the measured aggregate
            overlap fraction (see module docstring); clamped to [0, 1].
        wire_pattern: ``"allreduce"`` (default) or ``"sharded"`` — which
            per-bucket collective the cost model prices (the ``zero``
            algorithm's in-backward leg is a reduce-scatter).
    """

    def __init__(
        self,
        declarations: Sequence[TensorDeclaration],
        arrivals: Dict[str, float],
        cost_model: Optional[CostModel] = None,
        overlap_efficiency: float = 1.0,
        wire_pattern: str = "allreduce",
    ):
        self.declarations = list(declarations)
        self.cost_model = cost_model or CostModel()
        self.eta = min(1.0, max(0.0, float(overlap_efficiency)))
        self.wire_pattern = wire_pattern
        latest = max(arrivals.values(), default=0.0)
        self.arrivals = {
            td.name: float(arrivals.get(td.name, latest)) for td in self.declarations
        }
        # arrival-ordered timeline (stable on ties by declaration order)
        self.timeline: List[TensorDeclaration] = [
            td
            for _, td in sorted(
                enumerate(self.declarations),
                key=lambda it: (self.arrivals[it[1].name], it[0]),
            )
        ]
        self.compute_end = max(self.arrivals.values(), default=0.0)

    # -- evaluation ----------------------------------------------------------

    def evaluate(
        self, buckets: Sequence[Sequence[TensorDeclaration]], hierarchical: bool = False
    ) -> PlanResult:
        """Predicted exposed time of an *arbitrary* partition (it need not be
        contiguous on the arrival timeline — the seed greedy byte-threshold
        plan is evaluated through this same simulator, so DP-vs-greedy
        comparisons share one clock)."""
        rows = []
        for bi, bucket in enumerate(buckets):
            nbytes = sum(_decl_bytes(td) for td in bucket)
            ready = max((self.arrivals.get(td.name, self.compute_end) for td in bucket), default=0.0)
            rows.append({"bucket": bi, "nbytes": nbytes, "ready_s": ready})
        rows.sort(key=lambda r: r["ready_s"])
        t = 0.0
        total_wire = 0.0
        for r in rows:
            w = self.cost_model.bucket_wire_time(
                r["nbytes"], hierarchical, wire_pattern=self.wire_pattern
            )
            start = max(t, r["ready_s"])
            t = start + w
            total_wire += w
            r.update(
                {
                    "wire_s": round(w, 9),
                    "start_s": round(start, 9),
                    "finish_s": round(t, 9),
                }
            )
        tail = max(0.0, t - self.compute_end)
        exposed = self.eta * tail + (1.0 - self.eta) * total_wire
        return PlanResult(
            buckets=[list(b) for b in buckets],
            predicted_exposed_s=exposed,
            predicted_tail_s=tail,
            total_wire_s=total_wire,
            n_buckets=len(rows),
            per_bucket=rows,
        )

    # -- the DP solver -------------------------------------------------------

    def plan(
        self,
        max_bucket_bytes: Optional[int] = None,
        hierarchical: bool = False,
    ) -> PlanResult:
        """Optimal contiguous partition of the arrival timeline.

        Pareto DP: state per prefix is a frontier of (cost, finish) pairs —
        a prefix finishing later may still enable a cheaper total when η < 1,
        so a scalar DP would be lossy.  Buckets never span a dtype boundary
        and respect ``max_bucket_bytes`` (a single oversized tensor still
        gets its own bucket — the cap bounds fusion, not tensors)."""
        items = self.timeline
        n = len(items)
        if n == 0:
            return self.evaluate([])
        arr = [self.arrivals[td.name] for td in items]
        nbytes = [_decl_bytes(td) for td in items]
        t_end = self.compute_end
        eta = self.eta
        # frontier[j]: list of (cost, finish, i, parent_state) for prefix j
        frontier: List[List[Tuple[float, float, int, int]]] = [[] for _ in range(n + 1)]
        frontier[0] = [(0.0, 0.0, -1, -1)]
        for j in range(1, n + 1):
            cands: List[Tuple[float, float, int, int]] = []
            size = 0
            dtype = items[j - 1].dtype
            for i in range(j - 1, -1, -1):
                if items[i].dtype != dtype:
                    break  # dtype-homogeneous buckets only
                size += nbytes[i]
                if max_bucket_bytes and size > max_bucket_bytes and i < j - 1:
                    break  # cap bounds fusion; singletons are always feasible
                ready = arr[j - 1]  # arrival-sorted: last tensor arrives last
                w = self.cost_model.bucket_wire_time(
                    size, hierarchical, wire_pattern=self.wire_pattern
                )
                for si, (cost_i, fin_i, _, _) in enumerate(frontier[i]):
                    fin = max(fin_i, ready) + w
                    # tail increment telescopes to max(fin_n, T) - T
                    inc = eta * (max(fin, t_end) - max(fin_i, t_end)) + (1.0 - eta) * w
                    cands.append((cost_i + inc, fin, i, si))
            # Pareto-prune: keep states no other state beats on both axes
            cands.sort(key=lambda c: (c[0], c[1]))
            kept: List[Tuple[float, float, int, int]] = []
            best_fin = float("inf")
            for c in cands:
                if c[1] < best_fin - 1e-12:
                    kept.append(c)
                    best_fin = c[1]
            frontier[j] = kept
        # reconstruct from the min-cost final state (tiebreak: earliest finish)
        state = min(frontier[n], key=lambda c: (c[0], c[1]))
        cuts = []
        j = n
        while j > 0:
            _, _, i, si = state
            cuts.append((i, j))
            state = frontier[i][si] if i > 0 else frontier[0][0]
            j = i
        cuts.reverse()
        buckets = [[items[k] for k in range(i, j)] for i, j in cuts]
        return self.evaluate(buckets, hierarchical)

    # -- per-bucket wire precision (the quantized-ring chooser) --------------

    #: dtypes the quantized ring can carry (mirrors the engines' float set)
    QUANTIZABLE_DTYPES = ("f32", "f16", "bf16")

    def plan_precision(
        self,
        buckets: Sequence[Sequence[TensorDeclaration]],
        n_ranks: int,
        allowed: Sequence[str] = ("f32",),
        hierarchical: bool = False,
        block: int = QR_BLOCK,
    ) -> Dict:
        """Choose a wire precision per bucket, gated by a convergence
        allow-list.

        For every bucket of an (already chosen) partition, price the exact
        exchange each precision would run — the engine's f32 collective
        (flat / hierarchical / sharded, whatever this planner's
        ``wire_pattern`` says) against the blockwise-quantized ring through
        the fitted ``qr8`` / ``qr4`` legs — and pick the cheapest precision
        **from the allow-list**.  ``allowed`` is the convergence guardrail:
        only precisions that passed the loss-parity gate
        (``ci/perf_audit.py`` ``--wire`` lane) may be chosen; everything else
        is still priced and recorded as ``blocked`` so the decision trail
        shows what the guardrail cost.  ``"f32"`` is always implicitly
        allowed — exact exchange needs no parity evidence.

        Non-float buckets and degenerate rings (``n_ranks < 2``) stay f32,
        matching the engines' own resolution rules.  Returns a JSON-ready
        record: ``precisions`` (the adoptable per-bucket plan, in bucket
        order) plus per-bucket candidate timings and aggregate savings."""
        n = int(n_ranks)
        allow = {"f32"} | {p for p in allowed if p != "f32"}
        unknown = allow - {"f32", "int8", "int4"}
        if unknown:
            raise ValueError(f"unknown wire precisions in allow-list: {sorted(unknown)}")
        rows: List[Dict] = []
        precisions: List[str] = []
        total_f32 = total_chosen = 0.0
        for bi, bucket in enumerate(buckets):
            nbytes = sum(_decl_bytes(td) for td in bucket)
            numel = sum(td.num_elements for td in bucket)
            dtypes = {td.dtype for td in bucket}
            f32_time = self.cost_model.bucket_wire_time(
                nbytes, hierarchical, wire_pattern=self.wire_pattern
            )
            cand = {"f32": f32_time}
            quantizable = (
                n >= 2 and dtypes and dtypes <= set(self.QUANTIZABLE_DTYPES)
            )
            if quantizable:
                for prec in ("int8", "int4"):
                    ring = self.cost_model.quantized_ring_wire_time(
                        numel, n, prec, block
                    )
                    if self.wire_pattern == "sharded":
                        # zero's gradient leg is the reduce-scatter half of
                        # the ring (n-1 of the 2(n-1) hops); the deferred
                        # param all-gather stays f32 regardless of precision
                        t = ring / 2.0
                    elif hierarchical:
                        # exact f32 sum intra-node, quantized ring inter-node
                        t = self.cost_model.intra.predict(nbytes)
                        t += self.cost_model.quantized_ring_wire_time(
                            numel, max(1, n // self.cost_model.intra_size), prec, block
                        )
                    else:
                        t = ring
                    cand[prec] = t
            chosen = min(
                (p for p in cand if p in allow), key=lambda p: (cand[p], p)
            )
            precisions.append(chosen)
            total_f32 += f32_time
            total_chosen += cand[chosen]
            rows.append(
                {
                    "bucket": bi,
                    "nbytes": nbytes,
                    "numel": numel,
                    "dtype": sorted(dtypes)[0] if len(dtypes) == 1 else sorted(dtypes),
                    "candidate_us": {p: round(t * 1e6, 3) for p, t in cand.items()},
                    "chosen": chosen,
                    "blocked": sorted(
                        p for p in cand if p not in allow and cand[p] < cand[chosen]
                    ),
                }
            )
        return {
            "allow_list": sorted(allow),
            "n_ranks": n,
            "wire_pattern": self.wire_pattern,
            "hierarchical": bool(hierarchical),
            "precisions": precisions,
            "per_bucket": rows,
            "total_wire_ms_f32": round(total_f32 * 1e3, 4),
            "total_wire_ms": round(total_chosen * 1e3, 4),
            "saved_frac": round(1.0 - total_chosen / total_f32, 4) if total_f32 else 0.0,
        }

    # -- candidate ranking (warm-start input) --------------------------------

    def rank_caps(
        self,
        caps_2p: Iterable[int],
        hierarchical_options: Sequence[bool] = (False, True),
    ) -> List[Dict]:
        """Predicted cost of the DP plan at each ``2**p`` bucket-size cap ×
        hierarchical setting, best first — the planner's top-k proposals for
        warm-starting the Bayesian optimizer."""
        out = []
        for p in caps_2p:
            for hier in hierarchical_options:
                res = self.plan(max_bucket_bytes=1 << int(p), hierarchical=bool(hier))
                out.append(
                    {
                        "bucket_size_2p": int(p),
                        "is_hierarchical_reduce": int(bool(hier)),
                        **res.summary(),
                    }
                )
        out.sort(key=lambda c: c["predicted_exposed_ms"])
        return out
