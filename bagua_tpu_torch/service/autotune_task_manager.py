"""Per-model autotune state machine.

Analog of the reference's ``AutotuneServiceTaskManager``
(``service/autotune_task_manager.py``): owns the Bayesian optimizer over
``bucket_size_2p ∈ [10, 31]`` × ``is_hierarchical_reduce``, the greedy
dtype-grouped bucket split, and the tensor re-ordering learned from reported
execution order.

Since the trace-driven planner (``service/planner.py``) landed, reported
spans do more than re-order: ``tensor_ready`` spans carry measured cotangent
arrival times and ``bucket_wire`` spans carry measured per-bucket wire
timings, from which the manager fits an α–β cost model and *warm-starts* the
Bayesian optimizer with the planner's top-k ranked proposals instead of a
cold grid walk (``BAGUA_AUTOTUNE_PLANNER=warmstart``, the default).  In
``"on"`` mode each proposal's bucket assignment is additionally the
planner's DP-optimal contiguous partition under the proposed size cap.  With
no spans reported the planner never activates and everything falls back to
pure BO — measured signal is a strict upgrade, never a requirement.
"""

import logging
from typing import Dict, List, Optional

from bagua_tpu_torch.bucket import split_declarations
from bagua_tpu_torch.defs import BaguaHyperparameter, TensorDeclaration
from bagua_tpu_torch.env import get_autotune_logfile_path, get_autotune_planner_mode
from bagua_tpu_torch.service.bayesian_optimizer import BayesianOptimizer, BoolParam, IntParam
from bagua_tpu_torch.service.planner import BucketPlanner, CostModel, WireSample

logger = logging.getLogger(__name__)


class AutotuneTaskManager:
    def __init__(
        self,
        model_name: str,
        is_output_autotune_log: bool = False,
        tune_wire_dtype: bool = False,
        tune_overlap: bool = False,
        planner_mode: Optional[str] = None,
    ):
        self.model_name = model_name
        self.tensor_list: List[TensorDeclaration] = []
        self.hyperparameter = BaguaHyperparameter()
        self.tune_wire_dtype = tune_wire_dtype
        self.tune_overlap = tune_overlap
        params = [IntParam("bucket_size_2p", 10, 31), BoolParam("is_hierarchical_reduce")]
        if tune_wire_dtype:
            # opt-in third dimension: bf16 wire exchange trades ~3 decimal
            # digits of gradient mantissa for half the allreduce bytes —
            # a numerics-affecting knob, so never explored silently
            params.append(BoolParam("wire_bf16"))
        if tune_overlap:
            # execution-mode dimension: backward-overlapped per-bucket
            # collectives vs one monolithic exchange.  Numerically neutral
            # but interacts with bucket_size (more buckets = finer overlap,
            # more collective launches), so it is worth co-tuning.
            params.append(BoolParam("overlap"))
        self._size_param = params[0]
        self.optimizer = BayesianOptimizer(params)
        self.sampling_counter = 0
        self.best_score = float("-inf")
        self.best_hyperparameter = self.hyperparameter
        self.tensor_partial_order: Dict[str, int] = {}
        # -- trace-driven planner state --------------------------------------
        self.planner_mode = planner_mode or get_autotune_planner_mode()
        self.planner: Optional[BucketPlanner] = None
        self.tensor_arrivals: Dict[str, float] = {}
        self.wire_samples: List[WireSample] = []
        self._intra_size = 1
        self._world_size = 1
        #: convergence guardrail for the quantized-ring wire: only precisions
        #: that passed the loss-parity gate (``ci/perf_audit.py`` ``--wire``
        #: lane, or an operator override) may be chosen per bucket.  "f32"
        #: alone = never quantize, the safe default.
        self.precision_allow_list: List[str] = ["f32"]
        #: the full planner decision record, surfaced over the
        #: ``planner_trail`` endpoint and into ``AUTOTUNE_RUN.json``
        self.decision_trail: Dict = {
            "mode": self.planner_mode,
            "spans_reported": False,
            "cost_model": None,
            "overlap_efficiency": None,
            "candidates": [],
            "warm_start": [],
            "dp_plan": None,
            "greedy_plan": None,
            "precision_plan": None,
            "proposals": [],
            "chosen": None,
        }
        # the sample log (``BAGUA_AUTOTUNE_LOGFILE_PATH``), written only
        # when asked for
        self._log_path = get_autotune_logfile_path() if is_output_autotune_log else None

    # -- bucket computation ---------------------------------------------

    def ordered_tensor_list(self) -> List[TensorDeclaration]:
        if not self.tensor_partial_order:
            return self.tensor_list
        order = self.tensor_partial_order
        return sorted(self.tensor_list, key=lambda td: order.get(td.name, 1 << 30))

    def recommended_from_param_dict(self, param_dict: Dict[str, int]) -> BaguaHyperparameter:
        bucket_size = (1 << int(param_dict["bucket_size_2p"]))
        hierarchical = bool(param_dict["is_hierarchical_reduce"])
        predicted_ms: Optional[float] = None
        if self.planner_mode == "on" and self.planner is not None:
            # DP-optimal contiguous partition under the proposed size cap —
            # the BO keeps tuning bucket_size, but *within* each cap the
            # split is trace-optimal instead of greedy byte-threshold.
            res = self.planner.plan(
                max_bucket_bytes=bucket_size, hierarchical=hierarchical
            )
            buckets = res.buckets
            predicted_ms = round(res.predicted_exposed_s * 1e3, 4)
        else:
            decls = self.ordered_tensor_list()
            shapes = {td.name: (td.num_elements,) for td in decls}
            specs = split_declarations(decls, shapes, bucket_size)
            buckets = [spec.declarations() for spec in specs]
            if self.planner is not None:
                predicted_ms = round(
                    self.planner.evaluate(buckets, hierarchical).predicted_exposed_s
                    * 1e3,
                    4,
                )
        hp = BaguaHyperparameter(
            buckets=buckets,
            bucket_size=bucket_size,
            is_hierarchical_reduce=hierarchical,
            # None = dimension not tuned; the client must not touch a
            # user-configured wire dtype in that case
            wire_bf16=bool(param_dict.get("wire_bf16", 0)) if self.tune_wire_dtype else None,
            overlap=bool(param_dict.get("overlap", 0)) if self.tune_overlap else None,
            predicted_exposed_ms=predicted_ms,
        )
        if self.planner is not None:
            record = {
                "param_dict": {k: int(v) for k, v in param_dict.items()},
                "n_buckets": len(buckets),
                "predicted_exposed_ms": predicted_ms,
            }
            self.decision_trail["proposals"].append(record)
            self.decision_trail["chosen"] = record
        return hp

    # -- optimizer loop ----------------------------------------------------

    def tell_and_ask(
        self,
        score: float,
        train_iter: int,
        measured_hp: Optional[BaguaHyperparameter] = None,
    ) -> BaguaHyperparameter:
        """Record the score of the measured hyperparameters and propose new ones.

        ``measured_hp`` is the configuration the score was actually observed
        under.  With the effective-from history, proposals reach workers one
        ask-round late, so the service passes the hp in force at
        ``train_iter`` — crediting ``self.hyperparameter`` (the newest
        proposal) would shift every score onto the *next* sample and the
        optimizer would converge on a point one step away from the optimum."""
        measured = measured_hp or self.hyperparameter
        current = {
            "bucket_size_2p": max(10, measured.bucket_size.bit_length() - 1),
            "is_hierarchical_reduce": int(measured.is_hierarchical_reduce),
        }
        if self.tune_wire_dtype:
            current["wire_bf16"] = int(bool(measured.wire_bf16))
        if self.tune_overlap:
            current["overlap"] = int(bool(measured.overlap))
        self.optimizer.tell(current, score)
        self.sampling_counter += 1
        if score > self.best_score:
            self.best_score = score
            self.best_hyperparameter = measured
        if self._log_path:
            with open(self._log_path, "a") as f:
                f.write(f"{train_iter},{current},{score}\n")
        proposal = self.optimizer.ask()
        self.hyperparameter = self.recommended_from_param_dict(proposal)
        return self.hyperparameter

    def lock_best(self) -> BaguaHyperparameter:
        self.hyperparameter = self.best_hyperparameter
        return self.hyperparameter

    # -- execution-order learning -------------------------------------------

    def report_spans(self, spans: List[Dict]) -> None:
        """Distill tensor order AND planner inputs from reported spans.

        ``tensor_ready`` spans (reference ``autotune_service.py:274-294``
        consumes OTel spans; here any ordered (name, start) record works)
        give the partial order *and* the measured arrival times;
        ``bucket_wire`` spans (``SpanRecorder.record_wire_timings``) carry
        measured per-bucket wire seconds, bytes, leg tags and hidden
        fractions for the α–β cost model."""
        ready = [
            (s["start_time"], s["tensor_name"])
            for s in spans
            if s.get("action") == "tensor_ready" and "tensor_name" in s
        ]
        for i, (_, name) in enumerate(sorted(ready)):
            self.tensor_partial_order[name] = i
        for start, name in ready:
            self.tensor_arrivals[name] = float(start)
        for s in spans:
            if s.get("action") != "bucket_wire":
                continue
            try:
                self.wire_samples.append(
                    WireSample(
                        nbytes=float(s["nbytes"]),
                        seconds=float(s["seconds"]),
                        leg=str(s.get("leg", "flat")),
                        hidden_frac=(
                            float(s["hidden_frac"])
                            if s.get("hidden_frac") is not None
                            else None
                        ),
                    )
                )
            except (KeyError, TypeError, ValueError):
                logger.warning("ignoring malformed bucket_wire span: %r", s)
            if s.get("intra_size"):
                self._intra_size = max(1, int(s["intra_size"]))
            if s.get("world_size"):
                self._world_size = max(1, int(s["world_size"]))
        if ready or any(s.get("action") == "bucket_wire" for s in spans):
            self._refresh_planner()

    # -- planner integration --------------------------------------------------

    def set_precision_allow_list(self, allowed: List[str]) -> None:
        """Install the convergence-guardrail allow-list (the precisions the
        loss-parity gate certified) and refresh the precision plan in the
        decision trail if a planner is already live."""
        allow = sorted({"f32"} | set(allowed))
        unknown = set(allow) - {"f32", "int8", "int4"}
        if unknown:
            raise ValueError(f"unknown wire precisions: {sorted(unknown)}")
        self.precision_allow_list = allow
        if self.planner is not None:
            self._refresh_precision_plan()

    def _refresh_precision_plan(self) -> None:
        """Re-choose per-bucket wire precision over the DP partition at the
        live bucket-size cap and record it (allow-list included) in the
        decision trail."""
        dp = self.planner.plan(max_bucket_bytes=self.hyperparameter.bucket_size)
        self.decision_trail["precision_plan"] = self.planner.plan_precision(
            dp.buckets,
            n_ranks=self._world_size,
            allowed=self.precision_allow_list,
        )

    def _overlap_efficiency(self) -> float:
        """Aggregate measured overlap fraction across wire samples (η in the
        planner's exposed-time objective); 1.0 when nothing was measured —
        trust the latency-hiding scheduler until the trace says otherwise."""
        num = den = 0.0
        for s in self.wire_samples:
            if s.hidden_frac is not None and s.seconds > 0:
                num += s.hidden_frac * s.seconds
                den += s.seconds
        return num / den if den else 1.0

    def _refresh_planner(self) -> None:
        if self.planner_mode == "off" or not self.tensor_arrivals or not self.tensor_list:
            return
        cost_model = CostModel.from_samples(self.wire_samples, intra_size=self._intra_size)
        eta = self._overlap_efficiency()
        self.planner = BucketPlanner(
            self.tensor_list,
            self.tensor_arrivals,
            cost_model=cost_model,
            overlap_efficiency=eta,
        )
        trail = self.decision_trail
        trail["spans_reported"] = True
        trail["cost_model"] = cost_model.describe()
        trail["overlap_efficiency"] = round(eta, 4)
        # Rank the BO's bucket_size grid by the planner's predicted exposed
        # time and warm-start with the top-k (k = the optimizer's initial
        # sampling budget) — replacing the cold grid walk with measured-span
        # proposals, VERBATIM the points BO would otherwise burn recompiles
        # discovering.
        size = self._size_param
        candidates = self.planner.rank_caps(range(size.low, size.high + 1))
        trail["candidates"] = candidates[:16]
        warm = []
        for cand in candidates[: self.optimizer.n_initial_points]:
            point = {
                "bucket_size_2p": cand["bucket_size_2p"],
                "is_hierarchical_reduce": cand["is_hierarchical_reduce"],
            }
            if self.tune_wire_dtype:
                point["wire_bf16"] = int(bool(self.hyperparameter.wire_bf16))
            if self.tune_overlap:
                # the planner's objective is overlap-aware; propose overlap on
                point["overlap"] = 1
            warm.append(point)
        self.optimizer.warm_start(warm)
        trail["warm_start"] = warm
        # Record the unconstrained DP optimum and the seed greedy plan's
        # predicted cost — the decision the CI gate audits.
        dp = self.planner.plan()
        trail["dp_plan"] = dp.summary()
        self._refresh_precision_plan()
        decls = self.ordered_tensor_list()
        shapes = {td.name: (td.num_elements,) for td in decls}
        greedy_specs = split_declarations(decls, shapes, self.hyperparameter.bucket_size)
        greedy = self.planner.evaluate([s.declarations() for s in greedy_specs])
        trail["greedy_plan"] = greedy.summary()
        logger.info(
            "planner[%s] refreshed: dp %s vs greedy %s (eta=%.3f)",
            self.model_name, trail["dp_plan"], trail["greedy_plan"], eta,
        )
