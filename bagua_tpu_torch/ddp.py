"""The data-parallel training engine (the port of ``bagua_tpu/ddp.py``,
its core only).

One controller drives every rank of the group.  The train state is
rank-stacked as in the JAX package: each parameter is one tensor whose
leading axis has one slice per rank.  A step runs, on the monolithic path:

    per rank: forward + backward on its slice of the batch
    → transform_gradients (the bucketed exchange) → optimizer step

The optimizer is a factory, ``lambda params: torch.optim.SGD(params, ...)``,
called once on the stacked parameter tensors; an elementwise optimizer
updates each rank's slice on its own, as ``vmap`` of the optax update does.
The step updates the parameters and the optimizer state in place.
"""

import dataclasses
from typing import Any, Callable, Optional

import torch

from bagua_tpu_torch.algorithms.base import Algorithm, AlgorithmImpl, StepContext
from bagua_tpu_torch.bucket import BucketPlan
from bagua_tpu_torch.communication import BaguaProcessGroup, get_default_group
from bagua_tpu_torch.env import get_default_bucket_size
from bagua_tpu_torch.utils import SpeedMeter, tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class TrainState:
    params: Any  # tree of rank-stacked tensors, leading axis = group.size
    optimizer: torch.optim.Optimizer  # over the stacked leaves; its state is stacked too
    algo_state: Any
    step: int


class DistributedDataParallel:
    """Wrap a loss function, an optimizer factory and an algorithm into a
    distributed train step.

    Args:
        loss_fn: ``loss_fn(params, batch) -> scalar`` on one rank's batch.
        optimizer: ``optimizer(list_of_tensors) -> torch.optim.Optimizer``.
        algorithm: an :class:`~bagua_tpu_torch.algorithms.base.Algorithm`.
        process_group: defaults to the global group.
        bucket_size_bytes: communication bucket size.
        overlap: ``False`` or ``"auto"`` (which resolves to ``False``): the
            exchange runs once, after every rank's backward pass.  Running
            it from inside the backward pass is not ported yet.
    """

    def __init__(
        self,
        loss_fn: Callable,
        optimizer: Callable,
        algorithm: Algorithm,
        process_group: Optional[BaguaProcessGroup] = None,
        bucket_size_bytes: Optional[int] = None,
        overlap="auto",
    ):
        if overlap not in (False, "auto"):
            raise NotImplementedError(
                "overlap=True (the exchange inside the backward pass) is not ported "
                "yet; pass overlap=False or 'auto'"
            )
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.group = process_group or get_default_group()
        self.impl: AlgorithmImpl = algorithm.reify(self.group)
        self.bucket_size_bytes = bucket_size_bytes or get_default_bucket_size()
        self.plan: Optional[BucketPlan] = None
        self.speed_meter = SpeedMeter()

    def init(self, params) -> TrainState:
        """Replicate one copy of ``params`` to every rank (the reference
        broadcasting from rank 0) and build the optimizer over the stacks."""
        n, device = self.group.size, self.group.device
        self.plan = self.impl.tensors_to_buckets(params, self.bucket_size_bytes)
        self.impl.bind_plan(self.plan)
        stacked = tree_map(
            lambda p: p.detach().to(device).unsqueeze(0).repeat(n, *([1] * p.dim())), params
        )
        return TrainState(
            params=stacked,
            optimizer=self.optimizer(tree_leaves(stacked)),
            algo_state=self.impl.init_state(params),
            step=0,
        )

    def _rank_grads(self, params, batch):
        """Each rank's loss and gradients on its slice of the global batch,
        stacked: ``(losses (size,), grads tree of (size, ...))``."""
        n = self.group.size
        leaves = tree_leaves(params)
        per_rank = [[] for _ in leaves]
        losses = []
        for r in range(n):
            local = [leaf[r].detach().requires_grad_(True) for leaf in leaves]
            local_batch = tree_map(lambda t: t.chunk(n)[r], batch)
            with torch.enable_grad():
                loss = self.loss_fn(tree_unflatten(params, local), local_batch)
                grads = torch.autograd.grad(loss, local)
            losses.append(loss.detach())
            for acc, g in zip(per_rank, grads):
                acc.append(g)
        stacked = [torch.stack(gs) for gs in per_rank]
        return torch.stack(losses), tree_unflatten(params, stacked)

    def train_step(self, state: TrainState, batch):
        """One training step.  ``batch`` leaves have a leading global-batch
        dim divisible by ``group.size``; rank r takes the r-th slice.
        Returns ``(state, losses)``, ``losses`` the per-rank local loss of
        shape ``(size,)``."""
        for t in tree_leaves(batch):
            if t.shape[0] % self.group.size:
                raise ValueError(
                    f"global batch {t.shape[0]} not divisible by group size {self.group.size}"
                )
        batch = tree_map(lambda t: t.to(self.group.device, non_blocking=True), batch)
        ctx = StepContext(group=self.group, step=state.step, plan=self.plan)
        losses, grads = self._rank_grads(state.params, batch)
        grads, params, algo_state = self.impl.transform_gradients(
            grads, state.params, state.algo_state, ctx
        )
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            p.grad = g
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        return TrainState(params, state.optimizer, algo_state, state.step + 1), losses

    def apply_precision_plan(self, precisions, reason: str = "planner") -> bool:
        """Adopt a per-bucket wire-precision plan (one of ``"f32"``,
        ``"int8"``, ``"int4"`` per bucket) on an algorithm built with
        ``wire_precision="auto"``; ``None`` clears it.  The next step uses
        it.  Returns True when the resolved per-bucket precisions changed.
        An algorithm without the ``wire_precision`` knob raises
        AttributeError.  ``reason`` is accepted for the JAX package's
        signature and not read: the JAX engine also re-jits the step,
        re-verifies it statically and emits a telemetry event tagged with
        it here; the port runs eagerly and has neither verifier nor
        telemetry yet."""
        impl = self.impl
        if not hasattr(impl, "set_bucket_precision"):
            raise AttributeError(
                f"{type(impl).__name__} has no wire_precision knob; "
                "precision plans apply to gradient_allreduce"
            )
        old = impl.bucket_precisions(self.plan) if self.plan is not None else None
        impl.set_bucket_precision(precisions)
        new = impl.bucket_precisions(self.plan) if self.plan is not None else None
        return new != old

    def record_speed(self, n_samples: int) -> None:
        self.speed_meter.record(n_samples)

    def params_unstacked(self, state: TrainState, rank: int = 0):
        """One rank's parameter copy."""
        return tree_map(lambda x: x[rank], state.params)
