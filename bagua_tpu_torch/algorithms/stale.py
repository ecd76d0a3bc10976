"""Stale-sync: a bounded-staleness relaxation of the gradient allreduce
(the port of ``bagua_tpu/algorithms/stale.py``), on rank-stacked tensors.

The run stays bulk-synchronous: every rank enters every exchange every
step, so the collectives and their bytes are ``gradient_allreduce``'s on
the f32 wire.  But a rank under the *degradation directive* may contribute
its previous payload, for at most ``τ`` consecutive rounds, in place of its
fresh gradient.

State (rank-stacked, laid out on the bound plan):

* ``directive`` -- ``(size,)`` int32, flipped by the engine's
  ``apply_degradation_directive`` (a tensor swap between steps).
* ``staleness`` -- ``(size,)`` int32, each rank's consecutive stale rounds.
  A rank replays only while ``directive > 0 and staleness < τ``; at
  ``staleness == τ`` the gate closes and the next round is fresh, so
  divergence is bounded by construction.
* ``stale`` -- per bucket ``(size, numel)`` f32: the payload a replay sends.
* ``residual`` -- per bucket ``(size, numel)`` f32 error feedback: what a
  stale round did not send re-enters the next fresh contribution.  The
  update is uniform, with no branch on a rank:

      contrib   = where(use_stale, stale, g + residual)
      residual' = residual + g - contrib     # fresh: 0; stale: accrues g
      stale'    = where(use_stale, stale, g)

  The replay payload is the rank's last *raw fresh gradient*, never
  ``contrib``: replaying the correction would feed it into the next
  correction (``B_k = S_k - 2 B_{k-1}``, an exponentially divergent
  recursion), while the raw gradient keeps the telescoping sum exact and
  every payload bounded by a gradient that was measured.

At ``τ == 0`` the stage is the parent's, verbatim: bitwise
``gradient_allreduce``.  The exchange is f32 only (``set_bucket_precision``
refuses): stacking wire quantization's error feedback on this one would
compound two loops.  Every exchange runs under a ``bagua_stale/tau=<τ>``
``record_function`` inside its bucket's label, as the JAX package traces it
under that frame for its static verifier (which the port does not have
yet).
"""

import torch
from torch.profiler import record_function

from bagua_tpu_torch.algorithms.base import Algorithm, OverlapCapability, StepContext
from bagua_tpu_torch.algorithms.gradient_allreduce import GradientAllReduceAlgorithmImpl
from bagua_tpu_torch.communication import ReduceOp, allreduce, hierarchical_allreduce
from bagua_tpu_torch.observability.scope_grammar import format_stale_scope


def _check_tau(tau) -> int:
    tau = int(tau)
    if tau < 0:
        raise ValueError(f"staleness_tau must be >= 0, got {tau}")
    return tau


class StaleSyncAlgorithmImpl(GradientAllReduceAlgorithmImpl):
    algo_name = "stale"
    #: the replicas are laid out on the bound plan: a rebucket would desync them
    holds_bucketized_state = True
    #: the exchange is the monolithic one with overlap on or off; overlap
    #: only keeps the engine's multi-bucket plan
    overlap_mode = "post_step"

    def __init__(self, process_group, hierarchical: bool = False, average: bool = True,
                 fuse: str = "tuple", staleness_tau: int = 0):
        super().__init__(process_group, hierarchical=hierarchical, average=average, fuse=fuse,
                         wire_precision="f32")
        self.staleness_tau = _check_tau(staleness_tau)

    def set_staleness_tau(self, tau) -> None:
        """The engine's ``apply_staleness``; the next step uses it."""
        self.staleness_tau = _check_tau(tau)

    def set_bucket_precision(self, precisions) -> None:
        raise ValueError(
            "StaleSyncAlgorithmImpl exchanges are f32-only: the stale-replay "
            "error-feedback algebra is defined on exact flat buckets; use "
            "gradient_allreduce for wire quantization"
        )

    def overlap_capability(self) -> OverlapCapability:
        """Per-bucket state would refuse overlap, but the exchange is the
        same either way: overlap only keeps the multi-bucket plan, so
        ``auto`` may take it."""
        return OverlapCapability(True, mode="post_step", auto=True)

    def init_state(self, params):
        """Allocated whatever τ (even 0), so that a later ``apply_staleness``
        finds it: zeros on the group's device."""
        group = self.process_group
        n, device = group.local_size, group.device
        zeros = tuple(torch.zeros((n, spec.numel), dtype=torch.float32, device=device)
                      for spec in self._bound_plan.specs)
        return {
            "stale": zeros,
            "residual": zeros,
            "staleness": torch.zeros((n,), dtype=torch.int32, device=device),
            "directive": torch.zeros((n,), dtype=torch.int32, device=device),
        }

    def transform_gradients(self, grads, params, state, ctx: StepContext):
        if self.staleness_tau <= 0:
            # bulk synchronous: the parent's stage, the state untouched
            return super().transform_gradients(grads, params, state, ctx)
        op = ReduceOp.AVG if self.average else ReduceOp.SUM
        reduce = hierarchical_allreduce if self.hierarchical else allreduce
        staleness = state["staleness"]
        use_stale = (state["directive"] > 0) & (staleness < self.staleness_tau)
        gate = use_stale[:, None]
        out, new_stale, new_resid = [], [], []
        for i, flat in enumerate(ctx.plan.bucketize(grads)):
            g = flat.to(torch.float32)
            contrib = torch.where(gate, state["stale"][i], g + state["residual"][i])
            with self.annotate(i, "mono"), record_function(format_stale_scope(self.staleness_tau)):
                avg = reduce(contrib, op, self.process_group)
            out.append(avg.to(flat.dtype))
            new_stale.append(torch.where(gate, state["stale"][i], g))
            new_resid.append(state["residual"][i] + g - contrib)
        state = {
            **state,
            "stale": tuple(new_stale),
            "residual": tuple(new_resid),
            "staleness": torch.where(use_stale, staleness + 1, torch.zeros_like(staleness)),
        }
        return ctx.plan.debucketize(out, grads), params, state


class StaleSyncAlgorithm(Algorithm):
    def __init__(self, hierarchical: bool = False, average: bool = True, fuse: str = "tuple",
                 staleness_tau: int = 0):
        self.hierarchical = hierarchical
        self.average = average
        self.fuse = fuse
        self.staleness_tau = staleness_tau

    def reify(self, process_group) -> StaleSyncAlgorithmImpl:
        return StaleSyncAlgorithmImpl(
            process_group, hierarchical=self.hierarchical, average=self.average, fuse=self.fuse,
            staleness_tau=self.staleness_tau,
        )
