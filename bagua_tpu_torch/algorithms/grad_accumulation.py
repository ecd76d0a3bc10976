"""Gradient accumulation without communication, the ``no_sync`` analog
(the port of ``bagua_tpu/algorithms/grad_accumulation.py``).

The reference's DDP wrapper has ``no_sync()``: gradients accumulate
locally for k-1 steps with no exchange, and the k-th step exchanges the
accumulated gradient and updates once.  Here the same contract is a
wrapper around any inner algorithm::

    ddp = DistributedDataParallel(
        loss_fn, lambda ps: torch.optim.Adam(ps, lr=1e-3),
        GradientAccumulation(Algorithm.init("bytegrad"), every=4),
    )

Each step adds the local gradient to an f32 accumulator in the algorithm
state (rank-stacked).  Off the boundary nothing communicates and the
engine does not call the optimizer (``skips_optimizer_update`` and
:meth:`GradientAccumulationImpl.is_update_step`).  On every ``every``-th
step the inner algorithm's stages run on the accumulated mean, with
``ctx.step // every`` (its schedules count optimizer steps), and the
optimizer steps once.  For a mean loss, k accumulated micro-batches equal
one step on their concatenation.  The JAX package picks the branch with
``lax.cond`` on the traced step; here the step is a Python int.
"""

import dataclasses
from typing import Any

import torch

from bagua_tpu_torch.algorithms.base import Algorithm, AlgorithmImpl, StepContext
from bagua_tpu_torch.utils import tree_map


class GradientAccumulationImpl(AlgorithmImpl):
    #: the engine skips the optimizer off the boundary
    skips_optimizer_update = True

    def __init__(self, inner: AlgorithmImpl, every: int):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        # before super().__init__: it sets self.hierarchical, which lands on
        # the inner algorithm (its own value: a no-op)
        self.inner = inner
        self.every = every
        super().__init__(inner.process_group, hierarchical=inner.hierarchical)

    def is_update_step(self, step: int) -> bool:
        """Does this step exchange and update?"""
        return step % self.every == self.every - 1

    def _inner_ctx(self, ctx: StepContext) -> StepContext:
        return dataclasses.replace(ctx, step=ctx.step // self.every)

    # -- what the engine reads, delegated ---------------------------------------

    @property
    def holds_bucketized_state(self):
        return getattr(self.inner, "holds_bucketized_state", False)

    @property
    def optimizer(self):
        """The inner algorithm's bundled optimizer (QAdam's), if any."""
        return getattr(self.inner, "optimizer", None)

    @property
    def hierarchical(self):
        return self.inner.hierarchical

    @hierarchical.setter
    def hierarchical(self, value):
        self.inner.hierarchical = value

    @property
    def host_dispatch_lock(self):
        return self.inner.host_dispatch_lock

    def tensors_to_buckets(self, tree, bucket_size_bytes=None, filter_fn=None):
        return self.inner.tensors_to_buckets(tree, bucket_size_bytes, filter_fn)

    def bind_plan(self, plan) -> None:
        super().bind_plan(plan)
        self.inner.bind_plan(plan)

    def init_state(self, params) -> Any:
        """The accumulator, f32 zeros of each parameter rank-stacked, and
        the inner algorithm's state."""
        group = self.process_group
        return {
            "acc": tree_map(lambda p: torch.zeros((group.local_size, *p.shape), dtype=torch.float32,
                                                  device=group.device), params),
            "inner": self.inner.init_state(params),
        }

    # -- the stages ------------------------------------------------------------

    def on_step_start(self, params, state, ctx: StepContext):
        if not self.is_update_step(ctx.step):
            return params, state
        params, inner = self.inner.on_step_start(params, state["inner"], self._inner_ctx(ctx))
        return params, {**state, "inner": inner}

    def transform_gradients(self, grads, params, state, ctx: StepContext):
        """Accumulate (in place: the accumulator belongs to this state);
        on the boundary hand the inner stage the mean and zero the
        accumulator.  Off it the gradients go back as they came: the engine
        does not step the optimizer."""
        acc = state["acc"]
        tree_map(lambda a, g: a.add_(g.to(torch.float32)), acc, grads)
        if not self.is_update_step(ctx.step):
            return grads, params, state
        # XLA turns the JAX package's ``acc / every`` into a multiply by the
        # reciprocal; so does this, bit for bit
        mean = tree_map(lambda a: a * (1.0 / self.every), acc)
        g, params, inner = self.inner.transform_gradients(mean, params, state["inner"], self._inner_ctx(ctx))
        tree_map(torch.Tensor.zero_, acc)
        return tree_map(lambda g_, t: g_.to(t.dtype), g, grads), params, {**state, "inner": inner}

    def on_step_end(self, params, state, ctx: StepContext):
        if not self.is_update_step(ctx.step):
            return params, state
        params, inner = self.inner.on_step_end(params, state["inner"], self._inner_ctx(ctx))
        return params, {**state, "inner": inner}

    # -- control and the host hooks, delegated -----------------------------------

    def need_reset(self, step: int) -> bool:
        return self.inner.need_reset(step // self.every)

    def step_variant(self, step: int) -> str:
        return self.inner.step_variant(step // self.every)

    def abort(self) -> None:
        self.inner.abort()

    def resume(self) -> None:
        self.inner.resume()

    def host_pre_dispatch(self, state):
        return self.inner.host_pre_dispatch(state)

    def host_post_dispatch(self, state, step: int) -> None:
        # the inner algorithm counts optimizer steps (async's warmup gate)
        self.inner.host_post_dispatch(state, step // self.every)

    def host_shutdown(self) -> None:
        self.inner.host_shutdown()


class GradientAccumulation(Algorithm):
    """Wrap ``inner`` so that the exchange and the optimizer update run on
    every ``every``-th step, on the accumulated gradient mean."""

    def __init__(self, inner: Algorithm, every: int):
        self.inner = inner
        self.every = every

    def reify(self, process_group) -> GradientAccumulationImpl:
        inner = self.inner.reify(process_group) if isinstance(self.inner, Algorithm) else self.inner
        return GradientAccumulationImpl(inner, self.every)
