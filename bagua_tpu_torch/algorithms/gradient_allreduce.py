"""Centralized synchronous full-precision gradient allreduce.

The port of ``bagua_tpu/algorithms/gradient_allreduce.py``: one f32
allreduce per bucket, flat or hierarchical (intra-axis reduce, then
inter-axis), averaging or summing.  The quantized wires (``wire_precision``
int8/int4) wait for the quantized-ring kernels.
"""

from bagua_tpu_torch.algorithms.base import Algorithm, AlgorithmImpl, StepContext
from bagua_tpu_torch.communication import ReduceOp, allreduce, hierarchical_allreduce


class GradientAllReduceAlgorithmImpl(AlgorithmImpl):
    algo_name = "gradient_allreduce"

    def __init__(
        self, process_group, hierarchical: bool = False, average: bool = True,
        wire_precision: str = "f32",
    ):
        super().__init__(process_group, hierarchical=hierarchical)
        if wire_precision != "f32":
            raise NotImplementedError(
                f"wire_precision={wire_precision!r} needs the quantized-ring kernels, "
                "which are not ported yet; use 'f32'"
            )
        self.average = average

    def transform_gradients(self, grads, params, state, ctx: StepContext):
        op = ReduceOp.AVG if self.average else ReduceOp.SUM
        group = self.process_group
        out = []
        for flat in ctx.plan.bucketize(grads):
            if self.hierarchical:
                out.append(hierarchical_allreduce(flat, op, group))
            else:
                out.append(allreduce(flat, op, group))
        return ctx.plan.debucketize(out), params, state


class GradientAllReduceAlgorithm(Algorithm):
    def __init__(
        self, hierarchical: bool = False, average: bool = True, wire_precision: str = "f32"
    ):
        self.hierarchical = hierarchical
        self.average = average
        self.wire_precision = wire_precision

    def reify(self, process_group) -> GradientAllReduceAlgorithmImpl:
        return GradientAllReduceAlgorithmImpl(
            process_group, hierarchical=self.hierarchical, average=self.average,
            wire_precision=self.wire_precision,
        )
