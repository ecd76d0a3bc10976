"""The data-parallel training engine (the port of ``bagua_tpu/ddp.py``,
its core, the overlap mode and the bucket plan's management).

One controller drives every rank of the group.  The train state is
rank-stacked as in the JAX package: each parameter is one tensor whose
leading axis has one slice per rank.  The ranks' forward and backward run
as ONE pass: ``torch.func.vmap`` of the loss over the stacked parameters
and the batch cut into ``(size, B / size, ...)``, then ``backward()`` of the
summed losses, so the backward walks the layers once for all ranks, as the
JAX package's ``shard_map`` does.  A step then runs either

    monolithic: backward → transform_gradients (every bucket) → optimizer
                → on_step_end
    overlap, by the algorithm's mode (``overlap_capability().mode``):
      gradient: backward, each bucket's gradients exchanged by
                overlap_exchange from a gradient hook as the backward
                completes them → finalize_overlap → optimizer → on_step_end
      weight:   the same hooks exchange each bucket's *weights*
                (decentralized SGD); the exchanged weights are what the
                optimizer steps, with the local gradients
      post_step: the monolithic stages on the multi-bucket plan the
                algorithm picks under overlap (``overlap_hint``), then
                finalize_overlap before the optimizer (low-precision
                decentralized exchanges in on_step_end)

Overlap hooks: one ``register_post_accumulate_grad_hook`` per stacked
leaf, registered for the step and removed after it.  A bucket counts the
leaves still to arrive; once none is left it is ready, and ready buckets
are exchanged in :meth:`BucketPlan.backward_order`, each as soon as it and
every bucket before it in that order are ready.  On the card the exchange
runs on a side CUDA stream, so its kernels can run while the backward's
do; the optimizer's stream waits for it.

The optimizer is a factory, ``lambda params: torch.optim.SGD(params, ...)``,
called once on the stacked parameter tensors; an elementwise optimizer
updates each rank's slice on its own, as ``vmap`` of the optax update does.
The step updates the parameters and the optimizer state in place.  A stage
that returns new parameter tensors (decentralized's averaged weights,
low-precision decentralized's ``on_step_end``) has them copied into those
stacked tensors, before the optimizer step and again after
``on_step_end``, so the optimizer always steps what the algorithm made.
``optimizer=None`` takes the algorithm's bundled one (QAdam's
``QAdamOptimizer.to_torch()``).

Sharded update: an algorithm with ``sharded_update`` (``zero``) leaves each
rank the reduced gradients of its shard of every bucket only, and its
exchange returns those shards, bucket by bucket, in place of a gradient
tree.  The engine
then calls the factory once on the shard rows of a
:class:`~bagua_tpu_torch.sharded.updater.ShardedOptimizerUpdater` in place
of the stacked parameters, steps it in place of the optimizer, and hands the
updated shards to the algorithm, which gathers them into the parameters at
the next step's start (:meth:`DistributedDataParallel.finalize_pending_updates`
does it at once).
"""

import dataclasses
import time
from typing import Any, Callable, List, Optional, Union

import torch

from bagua_tpu_torch.algorithms.base import Algorithm, AlgorithmImpl, StepContext
from bagua_tpu_torch.bucket import BucketPlan, tree_leaf_names
from bagua_tpu_torch.communication import BaguaProcessGroup, get_default_group
from bagua_tpu_torch.defs import TensorDeclaration
from bagua_tpu_torch.env import get_default_bucket_size
from bagua_tpu_torch.sharded.layout import ShardLayout
from bagua_tpu_torch.sharded.updater import ShardedOptimizerUpdater, ShardedOptState
from bagua_tpu_torch.utils import SpeedMeter, tree_leaves, tree_map, tree_unflatten

#: who asked for a configuration switch (``rebucket``, ``apply_precision_plan``):
#: ``planner`` and ``manual`` bare, ``health:<kind>`` and ``autopilot:<incident>``
#: with a detail (the JAX package's ``observability/metrics.py`` vocabulary)
SWITCH_REASON_FAMILIES = ("planner", "health", "autopilot", "manual")


def validate_switch_reason(reason: str) -> str:
    """``reason`` unchanged if it speaks the switch vocabulary, else ValueError."""
    reason = str(reason)
    family, sep, detail = reason.partition(":")
    if family not in SWITCH_REASON_FAMILIES:
        raise ValueError(
            f"switch reason {reason!r} is not in the validated vocabulary "
            f"(families: {'|'.join(SWITCH_REASON_FAMILIES)})"
        )
    if family in ("health", "autopilot") and not detail:
        raise ValueError(
            f"switch reason {reason!r} needs a detail suffix "
            f"({family}:<{'kind' if family == 'health' else 'incident'}>)"
        )
    if family in ("planner", "manual") and sep:
        raise ValueError(f"switch reason {reason!r} must be bare ({family!r} takes no detail suffix)")
    return reason


@dataclasses.dataclass
class TrainState:
    params: Any  # tree of rank-stacked tensors, leading axis = group.size
    #: over the stacked leaves, its state stacked too; under a sharded-update
    #: algorithm the updater's state, over each rank's shards
    optimizer: Union[torch.optim.Optimizer, ShardedOptState]
    algo_state: Any
    step: int


class DistributedDataParallel:
    """Wrap a loss function, an optimizer factory and an algorithm into a
    distributed train step.

    Args:
        loss_fn: ``loss_fn(params, batch) -> scalar`` on one rank's batch;
            it runs under ``torch.func.vmap`` over the ranks.
        optimizer: ``optimizer(list_of_tensors) -> torch.optim.Optimizer``,
            or None for an algorithm that bundles its own (QAdam); any
            other algorithm raises ValueError then.
        algorithm: an :class:`~bagua_tpu_torch.algorithms.base.Algorithm`.
        process_group: defaults to the global group.
        bucket_size_bytes: communication bucket size.
        overlap: ``True``, ``False`` or ``"auto"``: exchange each bucket from
            inside the backward pass.  ``"auto"`` turns it on where the
            algorithm's :meth:`~bagua_tpu_torch.algorithms.base.AlgorithmImpl.overlap_capability`
            says ``supported`` and ``auto``; ``True`` on an algorithm that
            cannot overlap raises ValueError with its reason.
    """

    def __init__(
        self,
        loss_fn: Callable,
        optimizer: Optional[Callable],
        algorithm: Algorithm,
        process_group: Optional[BaguaProcessGroup] = None,
        bucket_size_bytes: Optional[int] = None,
        overlap="auto",
    ):
        self.loss_fn = loss_fn
        self.group = process_group or get_default_group()
        self.impl: AlgorithmImpl = algorithm.reify(self.group)
        if optimizer is None:
            bundled = getattr(self.impl, "optimizer", None)
            if bundled is None or not hasattr(bundled, "to_torch"):
                raise ValueError(
                    "optimizer is required unless the algorithm bundles one "
                    "(e.g. QAdamAlgorithm)"
                )
            optimizer = bundled.to_torch()
        self.optimizer = optimizer
        self.bucket_size_bytes = bucket_size_bytes or get_default_bucket_size()
        if overlap not in (True, False, "auto"):
            raise ValueError(f"overlap must be True, False or 'auto', got {overlap!r}")
        if overlap is True:
            cap = self.impl.overlap_capability()
            if not cap.supported:
                raise ValueError(cap.reason)
        self.overlap = overlap
        self.impl.overlap_hint = self.overlap_enabled
        self.plan: Optional[BucketPlan] = None
        #: set when the algorithm reports ``sharded_update`` (zero): the
        #: shard-only optimizer phase runs in place of the optimizer step
        self._sharded_updater: Optional[ShardedOptimizerUpdater] = None
        #: the shard layout the live state was built under, kept by the
        #: first rebucket since the state was last migrated; the next
        #: train_step migrates the state to the current layout
        self._pending_reshard: Optional[ShardLayout] = None
        #: 0 for init()'s plan, +1 per rebucket()
        self.plan_version = 0
        #: the reason family of the last configuration switch
        self._plan_source = "manual"
        self._tree_template = None  # the parameters' names, shapes and dtypes (meta tensors)
        #: overlap exchanges per bucket since the plan was set, and the
        #: bucket order of the last overlap step's exchanges
        self.exchange_counts: List[int] = []
        self.exchange_order: List[int] = []
        #: the CUDA stream the overlap exchange runs on, made at the first
        #: overlap step on the card
        self.side_stream = None
        self.speed_meter = SpeedMeter()

    @property
    def overlap_enabled(self) -> bool:
        """The resolved execution mode of the next step."""
        if self.overlap == "auto":
            cap = self.impl.overlap_capability()
            return cap.supported and cap.auto
        return bool(self.overlap)

    def init(self, params) -> TrainState:
        """Replicate one copy of ``params`` to every rank (the reference
        broadcasting from rank 0) and build the optimizer over the stacks
        (under a sharded-update algorithm, over each rank's shards)."""
        n, device = self.group.size, self.group.device
        self._tree_template = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"), params)
        self.impl.overlap_hint = self.overlap_enabled
        self._adopt_plan(self.impl.tensors_to_buckets(params, self.bucket_size_bytes))
        self._pending_reshard = None
        stacked = tree_map(
            lambda p: p.detach().to(device).unsqueeze(0).repeat(n, *([1] * p.dim())), params
        )
        updater = self._sharded_updater
        return TrainState(
            params=stacked,
            optimizer=updater.init(stacked) if updater else self.optimizer(tree_leaves(stacked)),
            algo_state=self.impl.init_state(params),
            step=0,
        )

    def _adopt_plan(self, plan: BucketPlan) -> None:
        self.plan = plan
        self.impl.bind_plan(plan)
        if getattr(self.impl, "sharded_update", False):
            self._sharded_updater = ShardedOptimizerUpdater(self.optimizer, plan, self.group)
        self.exchange_counts = [0] * plan.num_buckets

    # -- the backward pass ------------------------------------------------------

    @staticmethod
    def _grad_leaves(params) -> List[torch.Tensor]:
        """Fresh leaves over the stacked parameters' storage, to take this
        step's gradients and hooks."""
        return [leaf.detach().requires_grad_(True) for leaf in tree_leaves(params)]

    @staticmethod
    def _grad(leaf: torch.Tensor) -> torch.Tensor:
        """The leaf's gradient; zeros for a parameter the loss does not use."""
        return leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)

    def _forward(self, params, leaves, batch) -> torch.Tensor:
        """Every rank's loss on its slice of the global batch, ``(size,)``,
        in one ``vmap`` over the ranks."""
        n = self.group.size
        local = tree_map(lambda t: t.reshape(n, t.shape[0] // n, *t.shape[1:]), batch)
        with torch.enable_grad():
            return torch.func.vmap(self.loss_fn)(tree_unflatten(params, leaves), local)

    def _rank_grads(self, params, batch):
        """Each rank's loss and gradients on its slice of the global batch,
        stacked: ``(losses (size,), grads tree of (size, ...))``; a
        parameter the loss does not use gets zeros."""
        leaves = self._grad_leaves(params)
        losses = self._forward(params, leaves, batch)
        losses.sum().backward()
        return losses.detach(), tree_unflatten(params, [self._grad(leaf) for leaf in leaves])

    def _hook_buckets(self, params, leaves, on_ready):
        """Register one post-accumulate hook per leaf; ``on_ready(bucket)``
        runs when the last of a bucket's leaves has its gradient.  Returns
        the bucket's leaf indices and the hook handles."""
        index = {name: i for i, name in enumerate(tree_leaf_names(params))}
        slots = [[index[s.name] for s in spec.slots] for spec in self.plan.specs]
        pending = [len(s) for s in slots]

        def hook(bi):
            def fn(_leaf):
                pending[bi] -= 1
                if pending[bi] == 0:
                    on_ready(bi)
            return fn

        handles = [leaves[i].register_post_accumulate_grad_hook(hook(bi))
                   for bi, idx in enumerate(slots) for i in idx]
        return slots, handles

    def _overlapped(self, params, batch, ctx: StepContext, weight: bool = False):
        """One backward with each bucket's exchange issued from inside it.
        Returns ``(losses, grads, params)``: gradient mode, the exchanged
        gradients tree (under a sharded update, the buckets' shards) and
        ``params`` as given; weight mode, the local gradients and the
        exchanged parameters.  On the card the exchange runs on the side
        stream, which reads the weights beside the backward; the main
        stream waits for it before anything writes them.  A gradient
        exchange waits for the backward queued so far; a weight exchange
        reads no gradient and waits only for the step's start."""
        plan, impl, device = self.plan, self.impl, self.group.device
        if device.type == "cuda" and self.side_stream is None:
            self.side_stream = torch.cuda.Stream(device)
        side = self.side_stream if device.type == "cuda" else None
        leaves = self._grad_leaves(params)
        weights = tree_leaves(params)
        order = plan.backward_order()
        ready = [False] * plan.num_buckets
        exchanged: List[Optional[list]] = [None] * plan.num_buckets
        self.exchange_order = []
        start = torch.cuda.current_stream(device).record_event() if side is not None else None

        def issue(bi):
            grads = [self._grad(leaves[i]) for i in slots[bi]]
            kwargs = {"params_leaves": [weights[i] for i in slots[bi]]} if weight else {}
            if side is None:
                exchanged[bi] = impl.overlap_exchange(bi, grads, ctx, **kwargs)
            else:
                # autograd runs hooks on its own thread, with the backward's
                # stream current there
                main = torch.cuda.current_stream(device)
                if weight:
                    side.wait_event(start)
                else:
                    side.wait_stream(main)
                with torch.cuda.stream(side):
                    out = impl.overlap_exchange(bi, grads, ctx, **kwargs)
                for g in grads:
                    g.record_stream(side)
                for t in out:
                    t.record_stream(main)
                exchanged[bi] = out
            self.exchange_order.append(bi)
            self.exchange_counts[bi] += 1

        def on_ready(bi):
            ready[bi] = True
            while len(self.exchange_order) < len(order) and ready[order[len(self.exchange_order)]]:
                issue(order[len(self.exchange_order)])

        slots, handles = self._hook_buckets(params, leaves, on_ready)
        losses = self._forward(params, leaves, batch)
        losses.sum().backward()
        for h in handles:
            h.remove()
        # buckets with a leaf the loss does not use: its gradient is zeros
        for bi in order[len(self.exchange_order):]:
            issue(bi)
        if side is not None:
            torch.cuda.current_stream(device).wait_stream(side)
        if self._sharded_updater is not None:
            # a sharded update's exchange is each bucket's shard alone
            return losses.detach(), [out[0] for out in exchanged], params
        groups = plan.ungroup_leaves(
            [dict(zip((s.name for s in spec.slots), out)) for spec, out in zip(plan.specs, exchanged)])
        if weight:
            return losses.detach(), tree_unflatten(params, [self._grad(leaf) for leaf in leaves]), groups
        return losses.detach(), groups, params

    @staticmethod
    @torch.no_grad()
    def _write_params(stacked, params) -> None:
        """Copy each parameter a stage returned as a new tensor into the
        stacked tensor of ``stacked`` the optimizer holds."""
        for dst, src in zip(tree_leaves(stacked), tree_leaves(params)):
            if src is not dst:
                dst.copy_(src)

    # -- the step -----------------------------------------------------------------

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
        if self._pending_reshard is not None:
            state = self._apply_pending_reshard(state)
        impl = self.impl
        ctx = StepContext(group=self.group, step=state.step, plan=self.plan)
        params, algo_state = impl.on_step_start(state.params, state.algo_state, ctx)
        mode = impl.overlap_capability().mode if self.overlap_enabled else None
        if mode in ("gradient", "weight"):
            # the per-bucket exchanges that read the algorithm's state
            # (QAdam's momentum) find it here
            ctx.extras["algo_state"] = algo_state
            losses, grads, params = self._overlapped(params, batch, ctx, weight=mode == "weight")
        else:
            losses, grads = self._rank_grads(params, batch)
            grads, params, algo_state = impl.transform_gradients(grads, params, algo_state, ctx)
        if mode is not None:
            grads, params, algo_state = impl.finalize_overlap(grads, params, algo_state, ctx)
        self._write_params(state.params, params)
        if self._sharded_updater is not None:
            pending, _, params = self._sharded_updater.update_shards(grads, state.params, state.optimizer)
            algo_state = impl.stash_updates(algo_state, pending)
        else:
            for p, g in zip(tree_leaves(state.params), tree_leaves(grads)):
                p.grad = g
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
        params, algo_state = impl.on_step_end(state.params, algo_state, ctx)
        self._write_params(state.params, params)
        return TrainState(state.params, state.optimizer, algo_state, state.step + 1), losses

    # -- the bucket plan ----------------------------------------------------------

    def rebucket(self, plan: BucketPlan, predicted_exposed_ms: Optional[float] = None,
                 reason: str = "planner") -> None:
        """Adopt a new bucket plan; the next step's hooks and exchanges
        follow it, and under a sharded-update algorithm the next step first
        migrates the optimizer's shards and the pending parameter shards to
        the new layout.  ``reason`` speaks the switch vocabulary
        (``planner | health:<kind> | autopilot:<incident> | manual``).
        ``predicted_exposed_ms`` is the planner's prediction for the plan,
        which the JAX engine's telemetry records; the port has no telemetry
        yet and does not read it."""
        validate_switch_reason(reason)
        if getattr(self.impl, "holds_bucketized_state", False):
            raise ValueError(
                f"{type(self.impl).__name__} keeps per-bucket state; re-bucketing "
                "mid-training would desync it"
            )
        if self._sharded_updater is not None and self._pending_reshard is None:
            # the layout the live state was built under: the first of a
            # burst of rebuckets keeps it
            self._pending_reshard = self._sharded_updater.layout
        self.impl.overlap_hint = self.overlap_enabled
        self._adopt_plan(plan)
        self.plan_version += 1
        self._plan_source = reason.partition(":")[0]

    def export_plan_payload(self) -> Optional[dict]:
        """The live bucket plan and the configuration adopted with it (the
        algorithm, the overlap knob, the wire precisions and who chose them)
        as a JSON-serializable payload, for :meth:`adopt_plan_payload`."""
        if self.plan is None:
            return None
        config = {
            "algorithm": self.impl.algo_name or type(self.impl).__name__,
            "overlap": self.overlap if isinstance(self.overlap, str) else bool(self.overlap),
            "source": self._plan_source,
        }
        wp = getattr(self.impl, "wire_precision", None)
        if wp is not None:
            config["wire_precision"] = str(wp)
            config["bucket_precisions"] = [str(p) for p in self.impl.bucket_precisions(self.plan)]
        payload = {
            "plan_version": self.plan_version,
            "bucket_size_bytes": int(self.bucket_size_bytes),
            "buckets": [[dataclasses.asdict(td) for td in bucket] for bucket in self.plan.declarations()],
            "config": config,
        }
        if self._sharded_updater is not None:
            # the shard geometry, so that a resume can re-shard the
            # per-rank optimizer state it finds
            payload["shard"] = self._sharded_updater.layout.payload()
        return payload

    def adopt_plan_payload(self, payload: dict) -> bool:
        """Adopt an exported plan payload (an elastic resume).  Returns True
        when the engine now runs the saved plan, by :meth:`rebucket` or
        because the live plan already is it; False for a payload without
        buckets.  Raises when the payload names another algorithm, no
        longer fits the model, or the algorithm holds per-bucket state.
        The carried configuration (overlap, per-bucket precisions) is
        re-applied on top."""
        cfg = payload.get("config") or {}
        mine = self.impl.algo_name or type(self.impl).__name__
        if cfg.get("algorithm") and cfg["algorithm"] != mine:
            raise ValueError(
                f"snapshot was written under algorithm {cfg['algorithm']!r} but this "
                f"engine runs {mine!r}; construct the engine with the snapshot's algorithm"
            )
        buckets = [[TensorDeclaration(**td) for td in bucket] for bucket in payload.get("buckets", [])]
        if not buckets:
            return False
        names = [[td.name for td in b] for b in buckets]
        if self.plan is None or names != [[td.name for td in b] for b in self.plan.declarations()]:
            self.rebucket(BucketPlan.from_declarations(
                buckets, self._tree_template, align_elems=self.group.exchange_size
            ))
            if payload.get("bucket_size_bytes"):
                self.bucket_size_bytes = int(payload["bucket_size_bytes"])
        self._adopt_config(cfg)
        return True

    def _adopt_config(self, cfg: dict) -> None:
        """Re-apply a carried configuration's knobs this algorithm has; an
        ``overlap=True`` it cannot run is skipped."""
        if not cfg:
            return
        source = str(cfg.get("source", "manual"))
        reason = source if source in ("planner", "manual") else f"{source}:resume"
        ov = cfg.get("overlap")
        if ov is not None and ov != self.overlap:
            if not (ov is True and not self.impl.overlap_capability().supported):
                self.overlap = ov
                self.impl.overlap_hint = self.overlap_enabled
        precisions = cfg.get("bucket_precisions")
        if precisions and getattr(self.impl, "wire_precision", None) == "auto":
            self.apply_precision_plan(list(precisions), reason=reason)
        if source in SWITCH_REASON_FAMILIES:
            self._plan_source = source

    def apply_precision_plan(self, precisions, reason: str = "planner") -> bool:
        """Adopt a per-bucket wire-precision plan (one of ``"f32"``,
        ``"int8"``, ``"int4"`` per bucket) on an algorithm built with
        ``wire_precision="auto"``; ``None`` clears it.  The next step uses
        it.  Returns True when the resolved per-bucket precisions changed.
        An algorithm without the ``wire_precision`` knob raises
        AttributeError.  ``reason`` speaks the switch vocabulary and is
        recorded as the plan's source; the JAX engine also re-verifies the
        step statically and emits a telemetry event here, which the port
        does not have yet."""
        validate_switch_reason(reason)
        impl = self.impl
        if not hasattr(impl, "set_bucket_precision"):
            raise AttributeError(
                f"{type(impl).__name__} has no wire_precision knob; "
                "precision plans apply to gradient_allreduce"
            )
        old = impl.bucket_precisions(self.plan) if self.plan is not None else None
        impl.set_bucket_precision(precisions)
        new = impl.bucket_precisions(self.plan) if self.plan is not None else None
        self._plan_source = reason.partition(":")[0]
        return new != old

    # -- the sharded update --------------------------------------------------------

    def clear_pending_reshard(self) -> None:
        """Drop a queued shard-layout migration: for a resume whose state is
        already in the just-adopted plan's layout (the rebucket inside
        :meth:`adopt_plan_payload` queued one for live state that is about
        to be replaced)."""
        self._pending_reshard = None

    def _apply_pending_reshard(self, state: TrainState) -> TrainState:
        """Migrate the live sharded state from the layout it was built under
        to the current plan's (queued by :meth:`rebucket`): the optimizer's
        rows and state and the pending shards, value for value by tensor
        name, on the host.  One host round trip per plan swap."""
        old, self._pending_reshard = self._pending_reshard, None
        new = self._sharded_updater.layout
        return TrainState(
            params=state.params,
            optimizer=self._sharded_updater.reshard_state(state.optimizer, old),
            algo_state=self.impl.reshard_host_state(state.algo_state, old, new),
            step=state.step,
        )

    def finalize_pending_updates(self, state: TrainState) -> TrainState:
        """Gather the last step's updated parameter shards into the
        parameters now instead of at the next step's start.  Call it before
        reading the parameters (``params_unstacked``, eval, a checkpoint)
        under a sharded-update algorithm: until then they lag their update
        by one step.  The identity for other algorithms; idempotent, since
        the gather replaces the parameters with the same shards each time."""
        if self._sharded_updater is None:
            return state
        if self._pending_reshard is not None:
            state = self._apply_pending_reshard(state)
        ctx = StepContext(group=self.group, step=state.step, plan=self.plan)
        params, algo_state = self.impl.on_step_start(state.params, state.algo_state, ctx)
        return TrainState(params, state.optimizer, algo_state, state.step)

    def optimizer_state_bytes(self, state: TrainState) -> int:
        """Bytes of optimizer state one rank holds: the state tensors' bytes
        over the group size (they are rank-stacked).  A sharded update's
        parameter rows are parameters, not state, and are not counted."""
        opt = state.optimizer
        opts = (opt.sharded, opt.local) if isinstance(opt, ShardedOptState) else (opt,)
        total = sum(v.numel() * v.element_size() for o in opts if o is not None
                    for st in o.state.values() for v in st.values() if torch.is_tensor(v))
        return total // self.group.size

    # -- convenience --------------------------------------------------------------

    def profile_bucket_order(self, state: TrainState, batch) -> List[float]:
        """Each bucket's gradient arrival, in seconds from the start of the
        backward pass, aligned with ``plan.specs``: one forward and backward
        (no exchange, no update) with the overlap hooks marking when each
        bucket's last leaf arrives.  On the card, CUDA events on the
        backward's stream; on the CPU, the host clock (an order, not a
        schedule).  A bucket with a leaf the loss does not use arrives when
        the backward ends."""
        device = self.group.device
        batch = tree_map(lambda t: t.to(device), batch)
        leaves = self._grad_leaves(state.params)
        marks: List[Any] = [None] * self.plan.num_buckets
        if device.type == "cuda":
            def mark():
                event = torch.cuda.Event(enable_timing=True)
                event.record(torch.cuda.current_stream(device))
                return event
        else:
            mark = time.perf_counter

        def on_ready(bi):
            marks[bi] = mark()

        _, handles = self._hook_buckets(state.params, leaves, on_ready)
        losses = self._forward(state.params, leaves, batch)
        start = mark()
        losses.sum().backward()
        for h in handles:
            h.remove()
        end = mark()
        marks = [end if m is None else m for m in marks]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            return [start.elapsed_time(m) / 1e3 for m in marks]
        return [m - start for m in marks]

    def shard_batch(self, local_batch):
        """The global batch from this process's rows.  The group is
        single-controller (one process drives every rank), so the batch
        passes through."""
        return local_batch

    def record_speed(self, n_samples: int) -> None:
        self.speed_meter.record(n_samples)

    def params_unstacked(self, state: TrainState, rank: int = 0):
        """One rank's parameter copy."""
        return tree_map(lambda x: x[rank], state.params)
