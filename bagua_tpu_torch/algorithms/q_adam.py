"""QAdam: Adam with a quantized momentum exchange (the port of
``bagua_tpu/algorithms/q_adam.py``), on rank-stacked tensors.

Two phases, picked by the Python step:

* **warmup** (``step < warmup_steps``): the gradients are averaged in f32
  (one AVG allreduce per bucket) and both Adam moments update.  As in the
  reference, the moments update only while ``step + 1 < warmup_steps``, so
  the last warmup step averages the gradients and leaves them untouched.
* **compression**: the first moment is updated from each rank's own
  gradient, then exchanged with ByteGrad's compressed allreduce
  (hierarchical by default: an f32 intra sum, the compressed pipeline over
  ``inter``); the second moment stays frozen.  ``weight_decay`` acts in
  warmup only, as there.

The update ``p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)``
is plain SGD (``QAdamOptimizer.to_torch()``) on the direction this
algorithm returns in place of the gradients.  The bias corrections are f32
tensors, ``1 - torch.pow(f32(b), f32(t))``, as ``jnp.power`` computes them.
"""

import dataclasses
from typing import Tuple

import torch

from bagua_tpu_torch.algorithms.base import Algorithm, AlgorithmImpl, StepContext
from bagua_tpu_torch.algorithms.bytegrad import compressed_allreduce
from bagua_tpu_torch.bucket import flatten_bucket_leaves, split_bucket_flat, tree_leaf_names
from bagua_tpu_torch.communication import INTER_AXIS, INTRA_AXIS, ReduceOp, allreduce
from bagua_tpu_torch.utils import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class QAdamOptimizer:
    """The hyperparameters of the reference's ``QAdamOptimizer``."""

    lr: float = 1e-3
    warmup_steps: int = 100
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0

    def __post_init__(self):
        if self.lr < 0:
            raise ValueError(f"Invalid learning rate: {self.lr}")
        if self.eps < 0:
            raise ValueError(f"Invalid epsilon value: {self.eps}")
        for i, b in enumerate(self.betas):
            if not 0.0 <= b < 1.0:
                raise ValueError(f"Invalid beta parameter at index {i}: {b}")
        if self.warmup_steps <= 0:
            raise ValueError(
                f"Invalid warmup_steps parameter, must be larger than 0: {self.warmup_steps}"
            )

    def to_torch(self):
        """The engine's optimizer factory: plain SGD on the direction."""
        return lambda params: torch.optim.SGD(params, lr=self.lr)


class QAdamAlgorithmImpl(AlgorithmImpl):
    algo_name = "q_adam"
    supports_overlap = True

    def __init__(self, process_group, q_adam_optimizer: QAdamOptimizer, hierarchical: bool = True):
        super().__init__(process_group, hierarchical=hierarchical)
        self.optimizer = q_adam_optimizer
        self.warmup_steps = q_adam_optimizer.warmup_steps

    def init_state(self, params):
        """Both moments, zeros of each parameter's shape, rank-stacked on
        the group's device."""
        group = self.process_group
        zeros = lambda p: torch.zeros((group.local_size, *p.shape), dtype=p.dtype, device=group.device)  # noqa: E731
        return {"exp_avg": tree_map(zeros, params), "exp_avg_sq": tree_map(zeros, params)}

    def _exchange_flat(self, flat: torch.Tensor, compressed: bool) -> torch.Tensor:
        """One bucket's wire, shared by the monolithic and overlap paths."""
        group = self.process_group
        if not compressed:
            return allreduce(flat, ReduceOp.AVG, group)
        if self.hierarchical and group.intra_size > 1:
            intra = allreduce(flat, ReduceOp.SUM, group, INTRA_AXIS)
            red = compressed_allreduce(intra, group, INTER_AXIS, average=False)
            return red / torch.full_like(red, group.size)
        return compressed_allreduce(flat, group, None, average=True)

    def _allreduce_tree(self, tree, ctx: StepContext, compressed: bool):
        """Each bucket of ``tree`` exchanged; a leaf outside every bucket
        (``dp_filter``) keeps its local value."""
        out = []
        for i, flat in enumerate(ctx.plan.bucketize(tree)):
            with self.annotate(i, "mono"):
                out.append(self._exchange_flat(flat, compressed))
        return ctx.plan.debucketize(out, tree)

    def _momentum(self, m, g):
        b1 = self.optimizer.betas[0]
        return b1 * m + (1 - b1) * g

    def _warmup_moments(self, g, params, m, v, ctx: StepContext):
        """Both moments from the averaged gradients, but on the last warmup
        step (the reference's off-by-one)."""
        if ctx.step + 1 >= self.warmup_steps:
            return m, v
        b2, wd = self.optimizer.betas[1], self.optimizer.weight_decay
        if wd != 0.0:
            g = tree_map(lambda gg, p: gg + wd * p, g, params)
        m = tree_map(self._momentum, m, g)
        v = tree_map(lambda vv, gg: b2 * vv + (1 - b2) * gg * gg, v, g)
        return m, v

    def _direction(self, m, v, ctx: StepContext):
        """``m / (bc1 * (sqrt(v) / sqrt(bc2) + eps))``, the bias corrections
        f32 tensors on the group's device."""
        device = self.process_group.device
        t = torch.tensor(ctx.step + 1, dtype=torch.float32, device=device)
        b1, b2 = (torch.tensor(b, dtype=torch.float32, device=device) for b in self.optimizer.betas)
        bc1, bc2 = 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)
        eps = self.optimizer.eps
        return tree_map(lambda mm, vv: mm / (bc1 * (torch.sqrt(vv) / torch.sqrt(bc2) + eps)), m, v)

    def transform_gradients(self, grads, params, state, ctx: StepContext):
        m, v = state["exp_avg"], state["exp_avg_sq"]
        if ctx.step < self.warmup_steps:
            g = self._allreduce_tree(grads, ctx, compressed=False)
            m, v = self._warmup_moments(g, params, m, v, ctx)
        else:
            m = self._allreduce_tree(tree_map(self._momentum, m, grads), ctx, compressed=True)
        return self._direction(m, v, ctx), params, {"exp_avg": m, "exp_avg_sq": v}

    # -- overlap execution mode ---------------------------------------------

    def overlap_exchange(self, bucket_idx: int, grads, ctx: StepContext, params_leaves=None):
        """One bucket from inside the backward: in warmup its gradients
        averaged, in compression its momentum (from
        ``ctx.extras["algo_state"]``) updated and exchanged, on the very flat
        tensor :meth:`BucketPlan.bucketize` builds: the monolithic path's
        bits."""
        spec = ctx.plan.specs[bucket_idx]
        with self.annotate(bucket_idx, "overlap"):
            if ctx.step < self.warmup_steps:
                flat = flatten_bucket_leaves(grads, spec)
                return split_bucket_flat(self._exchange_flat(flat, compressed=False), spec)
            m = ctx.plan.group_leaves(ctx.extras["algo_state"]["exp_avg"])[bucket_idx]
            m2 = [self._momentum(m[s.name], g) for s, g in zip(spec.slots, grads)]
            return split_bucket_flat(self._exchange_flat(flatten_bucket_leaves(m2, spec), compressed=True),
                                     spec)

    def finalize_overlap(self, grads, params, state, ctx: StepContext):
        """``grads`` holds the exchanges' outputs: the averaged gradients in
        warmup, the exchanged momentum in compression.  A leaf outside
        every bucket (``dp_filter``) carries its local gradient, as the
        monolithic path leaves it; in compression its momentum is updated
        from it here, as the monolithic path does before its exchange."""
        m, v = state["exp_avg"], state["exp_avg_sq"]
        if ctx.step < self.warmup_steps:
            m, v = self._warmup_moments(grads, params, m, v, ctx)
        else:
            covered = ctx.plan.covered()
            names = tree_leaf_names(grads)
            m = tree_unflatten(grads, [
                e if name in covered else self._momentum(mm, e)
                for name, e, mm in zip(names, tree_leaves(grads), tree_leaves(m))])
        return self._direction(m, v, ctx), params, {"exp_avg": m, "exp_avg_sq": v}


class QAdamAlgorithm(Algorithm):
    def __init__(self, q_adam_optimizer: QAdamOptimizer, hierarchical: bool = True):
        self.optimizer = q_adam_optimizer
        self.hierarchical = hierarchical

    def reify(self, process_group) -> QAdamAlgorithmImpl:
        return QAdamAlgorithmImpl(process_group, q_adam_optimizer=self.optimizer, hierarchical=self.hierarchical)
