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

On a named mesh (a group built with a :class:`~bagua_tpu_torch.mesh.MeshSpec`)
the global batch shards over the group's data axes only and is replicated
over its model axes (JAX's ``P(data_axes)``): rank r takes the block of its
index within the data axes, and its tp peers take the same rows.  Every
stage of the algorithm runs under
:func:`~bagua_tpu_torch.communication.default_axes` of the data axes, so
its ``axis=None`` collectives ride them only (the JAX engine's
``default_axes`` inside its ``shard_map``); the overlap hooks, which
autograd runs on its own thread on the card, enter it again.

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

Around the step (:meth:`DistributedDataParallel.train_step`) the
algorithm's host hooks run: ``host_pre_dispatch`` (async model average
folds a landed average there), then the step and ``host_post_dispatch``
under the algorithm's ``host_dispatch_lock``, which its background thread
takes too.  An accumulating algorithm (``skips_optimizer_update``) has
no optimizer call off its boundary steps.  The knobs of a live run:
``apply_staleness``, ``apply_degradation_directive`` and
``reset_staleness_state`` (bounded staleness), ``switch_algorithm``
(between ``gradient_allreduce``, ``zero`` and ``bytegrad``) and
``shutdown`` / ``abort`` / ``resume`` (the algorithm's background
machinery).

Observability (``telemetry=``, ``health_monitor=``): a
:class:`~bagua_tpu_torch.observability.telemetry.Telemetry` hub sees each
step in the JAX engine's order (``on_step_start``, ``on_compile`` on a
step-cache miss, ``enter_phase("dispatch")``, the flight recorder's replay
around the step, ``on_compile_done``, ``enter_phase("wait")``,
``on_step``), and every plan, precision, staleness or algorithm switch.
The port has no jit cache: a "miss" is the first step of a variant after
a reset (the engine's start, a switch, the algorithm's ``need_reset``).
The flight recorder's program of a variant is captured on the first step
after the engine's start or a switch (the overlap hooks re-enter the
capture on autograd's thread) and replayed into the ring on every step.
A :class:`~bagua_tpu_torch.observability.health.HealthMonitor` gets each
step's loss, gradient norm and non-finite count, the columns of
``health_scalars``: the losses and norms are read on the host once a
step (on the card through pinned memory as soon as they are made, while
the optimizer's kernels stay queued), and the count, several passes over
the gradients and zero wherever a norm is finite, is taken only after a
non-finite norm.  Both
are host-side readers: the step's tensors are the same with them on or
off.

The static gate (``BAGUA_STATIC_VERIFY=warn|strict``, off by default): on
the first step of a variant, before it runs, the engine's step runs dry on
the ``meta`` device under the collective capture
(:func:`bagua_tpu_torch.analysis.verify_step_program`), and the four
checkers rule on the captured program; ``strict`` raises before anything
is dispatched and leaves the variant unseen, ``warn`` logs and steps.  A
rebucket, a precision, staleness or algorithm switch re-verifies the new
program at once (rolling back on a rejection), and the flight recorder's
live capture of a verified variant is held against its prediction.
"""

import contextlib
import dataclasses
import functools
import hashlib
import logging
import re
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from bagua_tpu_torch.algorithms.base import Algorithm, AlgorithmImpl, StepContext
from bagua_tpu_torch.bucket import BucketPlan, tree_leaf_names
from bagua_tpu_torch.communication import BaguaProcessGroup, allgather, default_axes, get_default_group, rank_id
from bagua_tpu_torch.defs import TensorDeclaration
from bagua_tpu_torch.env import get_default_bucket_size, get_static_verify_mode
from bagua_tpu_torch.mesh import _none_of_declared
from bagua_tpu_torch.models._rank_ops import over_ranks
from bagua_tpu_torch.observability.core import StepTimer
from bagua_tpu_torch.observability.flight_recorder import capture_program
from bagua_tpu_torch.observability.health import grad_norms, nonfinite_counts
from bagua_tpu_torch.observability.metrics import (
    SWITCH_REASON_FAMILIES,
    switch_reason_family,
    validate_switch_reason,
)
from bagua_tpu_torch.observability.scope_grammar import format_exchange_label
from bagua_tpu_torch.sharded.layout import ShardLayout
from bagua_tpu_torch.sharded.updater import ShardedOptimizerUpdater, ShardedOptState
from bagua_tpu_torch.utils import SpeedMeter, tree_flatten_with_names, tree_leaves, tree_map, tree_unflatten

logger = logging.getLogger(__name__)

def _on_data_axes(method):
    """Run an engine method with ``axis=None`` collectives resolving to the
    group's data axes."""
    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        with default_axes(self.group.data_axes):
            return method(self, *args, **kwargs)
    return wrapped


def _hierarchical_on_named_mesh(group, impl, remedy: str) -> None:
    if group.mesh_spec is not None and getattr(impl, "hierarchical", False):
        raise ValueError(f"hierarchical algorithms assume the legacy (inter, intra) mesh; {remedy}")


@dataclasses.dataclass
class TrainState:
    params: Any  # tree of rank-stacked tensors, leading axis = group.size
    #: over the stacked leaves, its state stacked too; under a sharded-update
    #: algorithm the updater's state, over each rank's shards
    optimizer: Union[torch.optim.Optimizer, ShardedOptState]
    algo_state: Any
    step: int


# -- the train state as flat leaves (snapshots, checkpoints, resume) -------------
#
# One flattening serves the snapshotter, the checkpoint and the resume: the
# parameters keyed by the paths the JAX snapshot's ``leaf_keys`` gives them
# (``.params['Dense_0']['kernel']``), then every tensor of the optimizer's
# ``state_dict()`` (parameter order, keys sorted; a step count is a 0-d
# tensor), under a sharded update the updater's rows first, then the
# algorithm's state and the step.

_OPT_KEY = re.compile(r"^\['state'\]\[(\d+)\]\['([^']+)'\]$")


def _optimizer_leaves(prefix: str, opt: torch.optim.Optimizer) -> List[Tuple[str, torch.Tensor]]:
    state = opt.state_dict()["state"]
    out = []
    for i in sorted(state):
        for k in sorted(state[i]):
            v = state[i][k]
            if torch.is_tensor(v):
                out.append((f"{prefix}['state'][{i}][{k!r}]", v))
    return out


def _param_leaves(state: "TrainState") -> List[Tuple[str, torch.Tensor]]:
    return [(".params" + n, t) for n, t in tree_flatten_with_names(state.params)]


def _row_leaves(state: "TrainState") -> List[Tuple[str, torch.Tensor]]:
    opt = state.optimizer
    return [(f".optimizer.rows[{gi}]", r) for gi, r in enumerate(opt.rows)] if isinstance(opt, ShardedOptState) else []


def _algo_leaves(state: "TrainState") -> List[Tuple[str, torch.Tensor]]:
    return [(".algo_state" + n, t) for n, t in tree_flatten_with_names(state.algo_state) if torch.is_tensor(t)]


def _structural_leaves(state: "TrainState") -> List[Tuple[str, torch.Tensor]]:
    """The leaves whose keys and shapes a state's definition fixes (the
    optimizer's state is made lazily, at its first step)."""
    return _param_leaves(state) + _row_leaves(state) + _algo_leaves(state)


def state_leaves(state: "TrainState") -> List[Tuple[str, torch.Tensor]]:
    """The train state as ``[(key, tensor), ...]``: references to the live
    tensors, not copies (the snapshotter clones them)."""
    opt = state.optimizer
    if isinstance(opt, ShardedOptState):
        optimizer = _optimizer_leaves(".optimizer.sharded", opt.sharded)
        if opt.local is not None:
            optimizer += _optimizer_leaves(".optimizer.local", opt.local)
    else:
        optimizer = _optimizer_leaves(".optimizer", opt)
    return (_param_leaves(state) + _row_leaves(state) + optimizer + _algo_leaves(state)
            + [(".step", torch.tensor(int(state.step), dtype=torch.int64))])


def _host_tensor(a, dtype_name: Optional[str], like_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A stored leaf as a host tensor of its recorded dtype (bfloat16 from
    its 16-bit pattern)."""
    a = np.asarray(a)
    t = torch.from_numpy(a if a.flags.c_contiguous and a.flags.writeable else a.copy())
    dtype = getattr(torch, dtype_name) if dtype_name else like_dtype
    if dtype == torch.bfloat16 and t.dtype == torch.int16:
        return t.view(torch.bfloat16)
    return t if dtype is None else t.to(dtype)


def _optimizer_state(opt: torch.optim.Optimizer, prefix: str, leaves, dtypes) -> Dict[int, dict]:
    """The stored optimizer leaves under ``prefix`` as a ``state_dict()``
    ``state`` for ``opt``, each checked against its parameter's shape."""
    params = [p for g in opt.param_groups for p in g["params"]]
    state: Dict[int, dict] = {}
    for key, a in leaves.items():
        if not key.startswith(prefix + "['state']"):
            continue
        m = _OPT_KEY.match(key[len(prefix):])
        if m is None or int(m.group(1)) >= len(params):
            raise ValueError(f"snapshot optimizer leaf {key} does not fit this optimizer "
                             f"({len(params)} parameters)")
        i = int(m.group(1))
        t = _host_tensor(a, dtypes.get(key))
        if t.dim() and t.shape != params[i].shape:
            raise ValueError(f"snapshot optimizer leaf {key} has shape {tuple(t.shape)}; "
                             f"its parameter has {tuple(params[i].shape)}")
        state.setdefault(i, {})[m.group(2)] = t
    return state


@torch.no_grad()
def load_state_leaves(state: "TrainState", leaves: Dict[str, Any], dtypes: Optional[Dict[str, str]] = None):
    """Load stored leaves (``{key: host array}`` as :func:`state_leaves`
    keyed them; ``dtypes`` their torch dtype names) into ``state``, a
    freshly built state of the same definition and layout: the parameters
    and the updater's rows are copied into its tensors in place (onto
    their device, at their dtypes), the algorithm's state is replaced, the
    optimizer is loaded through ``load_state_dict`` (its hyperparameters
    stay the live ones) and the step is set.  Returns the loaded state.  A
    snapshot of another definition (leaf keys or shapes) raises
    ValueError; every leaf is checked before anything is written, so
    ``state`` is then left as it was."""
    dtypes = dtypes or {}
    mine = _structural_leaves(state)
    want = {k for k, _ in mine}
    have = {k for k in leaves if k.startswith((".params", ".algo_state", ".optimizer.rows"))}
    if want != have or ".step" not in leaves:
        missing, extra = sorted(want - have), sorted(have - want)
        raise ValueError(
            f"the snapshot holds {len(leaves)} leaves that do not match the engine's state "
            f"({len(want)} parameter, row and algorithm-state leaves; missing {missing[:3]}, "
            f"unexpected {extra[:3]}): the model or optimizer definition changed since it was taken"
        )
    host = {}
    for key, like in mine:
        t = host[key] = _host_tensor(leaves[key], dtypes.get(key), like.dtype)
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"snapshot leaf {key} shape {tuple(t.shape)} != engine state {tuple(like.shape)}")
    opt = state.optimizer
    if isinstance(opt, ShardedOptState):
        parts = [(opt.sharded, ".optimizer.sharded")]
        if opt.local is not None:
            parts.append((opt.local, ".optimizer.local"))
    else:
        parts = [(opt, ".optimizer")]
    optimizers = [(o, _optimizer_state(o, prefix, leaves, dtypes)) for o, prefix in parts]
    for o, opt_state in optimizers:
        o.load_state_dict({"state": opt_state, "param_groups": o.state_dict()["param_groups"]})
    loaded = {}
    for key, like in mine:
        if key.startswith(".algo_state"):
            # replaced, not written in place: a fresh state's tensors may
            # be views of the parameters (a ZeRO bucket of one leaf)
            loaded[key] = host[key].to(like.device, like.dtype)
        else:
            like.copy_(host[key].to(like.dtype))
    algo_state = tree_unflatten(state.algo_state, [
        loaded.get(".algo_state" + name, leaf) for name, leaf in tree_flatten_with_names(state.algo_state)])
    return TrainState(state.params, state.optimizer, algo_state, int(np.asarray(leaves[".step"])))


class DistributedDataParallel:
    """Wrap a loss function, an optimizer factory and an algorithm into a
    distributed train step.

    Args:
        loss_fn: ``loss_fn(params, batch) -> scalar`` on one rank's batch;
            it runs under ``torch.func.vmap`` over the ranks.
        optimizer: ``optimizer(list_of_tensors) -> torch.optim.Optimizer``,
            or None for an algorithm that bundles its own (QAdam); any
            other algorithm raises ValueError then.
        algorithm: an :class:`~bagua_tpu_torch.algorithms.base.Algorithm`,
            or an :class:`~bagua_tpu_torch.algorithms.base.AlgorithmImpl`
            already bound to the group.
        process_group: defaults to the global group.
        bucket_size_bytes: communication bucket size.
        dp_filter: ``filter(leaf_name) -> bool``; a leaf for which it
            returns False is in no bucket and never communicated: it keeps
            its local gradient (monolithic, overlap, and under ZeRO a
            replicated optimizer of its own).  The JAX package's MoE
            integration passes ``lambda name: "experts" not in name``.
        overlap: ``True``, ``False`` or ``"auto"``: exchange each bucket from
            inside the backward pass.  ``"auto"`` turns it on where the
            algorithm's :meth:`~bagua_tpu_torch.algorithms.base.AlgorithmImpl.overlap_capability`
            says ``supported`` and ``auto``; ``True`` on an algorithm that
            cannot overlap raises ValueError with its reason.
        dp_axis, fsdp_axis, tp_axis: assert the roles of the group's mesh
            axes: each must name declared axes of that role (data for
            ``dp_axis`` and ``fsdp_axis``, model for ``tp_axis``), else
            ValueError.  They assert, they do not assign: roles are the
            :class:`~bagua_tpu_torch.mesh.MeshSpec`'s.
        telemetry: an optional
            :class:`~bagua_tpu_torch.observability.telemetry.Telemetry` hub.
            When attached the engine reports every step-cache miss (the
            recompile detector), tags the host's position in the step
            (watchdog phase heartbeats), replays each step's collective
            program into the hub's flight recorder and feeds per-step wall
            time, samples/s, wire bytes and host overhead into the metrics
            pipeline.  Host-side only: the step's tensors are the same with
            or without it.
        health_monitor: an optional
            :class:`~bagua_tpu_torch.observability.health.HealthMonitor`,
            fed each step the ranks' mean loss, largest gradient norm and
            non-finite count (the columns of
            :func:`~bagua_tpu_torch.observability.health.health_scalars` on
            the exchanged gradients: pure reads, one device-to-host copy a
            step; the count only after a non-finite norm).
    """

    def __init__(
        self,
        loss_fn: Callable,
        optimizer: Optional[Callable],
        algorithm: Algorithm,
        process_group: Optional[BaguaProcessGroup] = None,
        bucket_size_bytes: Optional[int] = None,
        dp_filter: Optional[Callable[[str], bool]] = None,
        overlap="auto",
        telemetry=None,
        health_monitor=None,
        dp_axis=None,
        fsdp_axis=None,
        tp_axis=None,
    ):
        self.loss_fn = loss_fn
        self.group = process_group or get_default_group()
        self._validate_mesh_axes(dp_axis=dp_axis, fsdp_axis=fsdp_axis, tp_axis=tp_axis)
        self.impl: AlgorithmImpl = algorithm.reify(self.group) if isinstance(algorithm, Algorithm) else algorithm
        _hierarchical_on_named_mesh(self.group, self.impl, "construct the group without a MeshSpec "
                                    "(intra_size=...) to use them")
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
        self.dp_filter = dp_filter
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
        #: each rank's index within the data axes: the batch block it takes
        self._data_rank = rank_id(self.group, self.group.data_axes)
        #: the batch's blocks and each local rank's block (None: in order)
        self._batch_blocks = self._blocks_of_batch()
        #: the step variants run since the last reset: the port's
        #: counterpart of the JAX engine's jit cache, whose misses the
        #: telemetry's recompile detector counts
        self._variants_seen = set()
        #: per-variant collective programs for the flight recorder: captured
        #: on the variant's first step, replayed into the ring every step;
        #: cleared wherever the collective sequence changes (a rebucket, a
        #: precision, staleness or algorithm switch)
        self._flight_programs = {}
        #: the events list of the capture in progress, re-entered by the
        #: overlap hooks (autograd's thread on the card)
        self._capture: Optional[list] = None
        #: the static verifier's collective capture in progress: set only
        #: while the step runs dry on meta (re-entered, with the meta mode,
        #: by the overlap hooks)
        self._ir_capture: Optional[list] = None
        #: per-variant flight programs the static gate predicted; the live
        #: capture is held against them
        self._predicted_programs = {}
        #: the last verified batch, on meta: what a switch re-verifies with
        self._verify_batch_template = None
        #: steps completed as the engine last saw them: the step the
        #: switch events name
        self._host_step = 0
        #: cumulative host-side seconds per train_step phase: pre
        #: (host_pre_dispatch), lock_wait (host_dispatch_lock acquisition),
        #: dispatch (the step's host work and kernel launches), post
        #: (host_post_dispatch); read/reset via host_overhead_snapshot()
        self.host_overhead = {"pre": 0.0, "lock_wait": 0.0, "dispatch": 0.0, "post": 0.0, "steps": 0}
        self.telemetry = telemetry
        self.health_monitor = health_monitor
        if health_monitor is not None and telemetry is not None:
            health_monitor.bind_telemetry(telemetry)
        #: host-observed train_step wall times (ring-buffered), whose
        #: p50/p95/p99 host_overhead_snapshot reports
        self.step_timer = StepTimer()

    def _validate_mesh_axes(self, **axis_kwargs):
        """Check the ``dp_axis``/``fsdp_axis``/``tp_axis`` keywords against the
        group's declared mesh axes (mirrors ``_check_ep_axes`` in
        parallel/moe/layer.py): a typo'd name raises here, not deep in a step.
        The keywords assert roles, they don't reassign them -- declare roles
        on the :class:`~bagua_tpu_torch.mesh.MeshSpec` itself."""
        spec = self.group.mesh_spec
        declared = self.group.all_axes
        roles = {"dp_axis": "data", "fsdp_axis": "data", "tp_axis": "model"}
        for kw, value in axis_kwargs.items():
            if value is None:
                continue
            tup = (value,) if isinstance(value, str) else tuple(value)
            for a in tup:
                if a not in declared:
                    raise _none_of_declared(kw, a, declared)
                if spec is not None:
                    want = spec.data_axes if roles[kw] == "data" else spec.model_axes
                    if a not in want:
                        raise ValueError(
                            f"mesh axis {a!r} is declared but carries the "
                            f"{'model' if roles[kw] == 'data' else 'data'} role on "
                            f"{spec!r} — {kw} must name one of its "
                            f"{roles[kw]} axes; assign roles on the MeshSpec "
                            f"(dp_axis/fsdp_axis/tp_axis at spec construction)"
                        )

    def _blocks_of_batch(self):
        """``(blocks, pick)``: the batch a step takes cut into ``blocks``
        equal blocks, local rank i taking block ``pick[i]`` (None: block
        i).  Single-controller, the global batch in ``exchange_size``
        blocks; on a group that spans processes, this process's rows: one
        block for each data index its ranks hold, in order."""
        group = self.group
        if not group.distributed:
            e = group.exchange_size
            return e, (None if e == group.size else self._data_rank)
        ranks = self._data_rank.cpu()
        distinct = torch.unique(ranks)
        if len(distinct) == group.local_size and bool((ranks == distinct).all()):
            return len(distinct), None
        return len(distinct), torch.searchsorted(distinct, ranks).to(group.device)

    @property
    def overlap_enabled(self) -> bool:
        """The resolved execution mode of the next step."""
        if self.overlap == "auto":
            cap = self.impl.overlap_capability()
            return cap.supported and cap.auto
        return bool(self.overlap)

    @_on_data_axes
    def init(self, params=None, stacked_params=None) -> TrainState:
        """Build the rank-stacked train state and the optimizer over the
        stacks (under a sharded-update algorithm, over each rank's shards).

        Pass ``params`` (one copy, replicated to every rank: the reference
        broadcasting from rank 0) OR ``stacked_params``, a tree whose leaves
        have a leading ``group.size`` axis, taken as it is, when the ranks
        must start from different values.  The algorithm's state is then
        built from each rank's own slice (one ``init_state`` call a rank).

        On a group that spans processes each process stacks its own ranks
        (``stacked_params`` holds its ``local_size`` rows), and ``params``
        must be the same on every process (the same seed, as the JAX
        package's multi-process test makes them): one all-gather of a digest
        of them checks it and raises ValueError on a mismatch."""
        n, device = self.group.local_size, self.group.device
        if stacked_params is not None and params is not None:
            raise ValueError("pass either params or stacked_params, not both")
        if stacked_params is not None:
            for name, leaf in tree_flatten_with_names(stacked_params):
                if leaf.dim() == 0 or leaf.shape[0] != n:
                    where = (f"the {n} ranks this process holds" if self.group.distributed
                             else f"the group size {n}")
                    raise ValueError(f"stacked_params leaf {name} has shape {tuple(leaf.shape)}; "
                                     f"its leading axis must be {where}")
            template = tree_map(lambda p: p[0], stacked_params)
        elif params is None:
            raise ValueError("pass params or stacked_params")
        else:
            template = params
            if self.group.distributed:
                self._check_same_params(params)
        self._tree_template = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"), template)
        self.impl.overlap_hint = self.overlap_enabled
        self._adopt_plan(self.impl.tensors_to_buckets(template, self.bucket_size_bytes, filter_fn=self.dp_filter))
        self._pending_reshard = None
        if stacked_params is not None:
            stacked = tree_map(lambda p: p.detach().to(device, copy=True), stacked_params)
            per_rank = [self.impl.init_state(tree_map(lambda p: p[r], stacked)) for r in range(n)]
            algo_state = tree_map(lambda *rows: torch.stack([t[r] for r, t in enumerate(rows)]), *per_rank)
        else:
            stacked = tree_map(
                lambda p: p.detach().to(device).unsqueeze(0).repeat(n, *([1] * p.dim())), params
            )
            algo_state = self.impl.init_state(params)
        updater = self._sharded_updater
        return TrainState(
            params=stacked,
            optimizer=updater.init(stacked) if updater else self.optimizer(tree_leaves(stacked)),
            algo_state=algo_state,
            step=0,
        )

    def _check_same_params(self, params) -> None:
        """Raise unless every process passed the same ``params``: a SHA-256
        of their bytes, all-gathered over the group."""
        digest = hashlib.sha256()
        for name, leaf in tree_flatten_with_names(params):
            host = leaf.detach().cpu().contiguous()
            digest.update(name.encode())
            digest.update(host.reshape(-1).view(torch.uint8).numpy().tobytes())
        mine = int.from_bytes(digest.digest()[:8], "little", signed=True)
        k = self.group.local_size
        rows = torch.full((k, 1), mine, dtype=torch.int64, device=self.group.device)
        seen = allgather(rows, self.group, self.group.all_axes)[0].cpu()
        if not bool((seen == mine).all()):
            raise ValueError("init(params=...) got different parameters on different processes: "
                             "make them from the same seed on every process, or pass each "
                             "process's own rows as stacked_params")

    def _adopt_plan(self, plan: BucketPlan) -> None:
        self.plan = plan
        self.impl.bind_plan(plan)
        self._reset_programs()
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
        in one ``vmap`` over the ranks: the batch in ``exchange_size``
        blocks, rank r taking the block of its index within the data axes."""
        blocks_of, pick = self._batch_blocks

        def shard(t):
            blocks = t.reshape(blocks_of, t.shape[0] // blocks_of, *t.shape[1:])
            return blocks if pick is None else blocks[pick.to(t.device)]

        local = tree_map(shard, batch)
        with torch.enable_grad(), over_ranks(self.group):
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
        Returns ``(losses, grads, params, local)``: gradient mode, the
        exchanged gradients tree (under a sharded update, the buckets'
        shards) and ``params`` as given; weight mode, the local gradients
        and the exchanged parameters; ``local`` the local gradients tree
        either way (a leaf outside every bucket keeps its local gradient,
        and its weights in weight mode).  On the card the exchange runs on the side
        stream, which reads the weights beside the backward; the main
        stream waits for it before anything writes them.  A gradient
        exchange waits for the backward queued so far; a weight exchange
        reads no gradient and waits only for the step's start."""
        plan, impl = self.plan, self.impl
        weights = tree_leaves(params)
        # by the tensors' device: a dry run of a card's engine is on meta
        device = weights[0].device
        if device.type == "cuda" and self.side_stream is None:
            self.side_stream = torch.cuda.Stream(device)
        side = self.side_stream if device.type == "cuda" else None
        leaves = self._grad_leaves(params)
        order = plan.backward_order()
        ready = [False] * plan.num_buckets
        exchanged: List[Optional[list]] = [None] * plan.num_buckets
        self.exchange_order = []
        start = torch.cuda.current_stream(device).record_event() if side is not None else None

        def issue(bi):
            # the hooks run on autograd's thread on the card: enter the data
            # axes and the captures there again
            with default_axes(self.group.data_axes), self._hook_captures():
                exchange(bi)
            self.exchange_order.append(bi)
            self.exchange_counts[bi] += 1

        def exchange(bi):
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
        local = tree_unflatten(params, [self._grad(leaf) for leaf in leaves])
        if self._sharded_updater is not None:
            # a sharded update's exchange is each bucket's shard alone
            return losses.detach(), [out[0] for out in exchanged], params, local
        groups = [dict(zip((s.name for s in spec.slots), out)) for spec, out in zip(plan.specs, exchanged)]
        if weight:
            return losses.detach(), local, plan.ungroup_leaves(groups, params), local
        return losses.detach(), plan.ungroup_leaves(groups, local), params, local

    def _hook_captures(self) -> contextlib.ExitStack:
        """The captures (and a dry run's meta mode) active on the step's
        thread, for an overlap hook to enter on its own."""
        stack = contextlib.ExitStack()
        if self._capture is not None:
            stack.enter_context(capture_program(self._capture))
        if self._ir_capture is not None:
            from bagua_tpu_torch.analysis import capture_collectives, on_meta

            stack.enter_context(capture_collectives(self._ir_capture))
            stack.enter_context(on_meta())
        return stack

    @staticmethod
    @torch.no_grad()
    def _write_params(stacked, params) -> None:
        """Copy each parameter a stage returned as a new tensor into the
        stacked tensor of ``stacked`` the optimizer holds."""
        for dst, src in zip(tree_leaves(stacked), tree_leaves(params)):
            if src is not dst:
                dst.copy_(src)

    # -- the step -----------------------------------------------------------------

    @_on_data_axes
    def train_step(self, state: TrainState, batch):
        """One training step.  ``batch`` leaves have a leading global-batch
        dim divisible by ``group.exchange_size``; rank r takes the slice of
        its index within the data axes (the r-th on the legacy mesh).  On a
        group that spans processes ``batch`` is this process's rows
        (:meth:`shard_batch`): its ranks' blocks, in rank order.
        Returns ``(state, losses)``, ``losses`` the per-rank local loss of
        shape ``(size,)``.

        Around the step the algorithm's host hooks run: ``host_pre_dispatch``
        first (async model average folds a landed delta there), then the
        whole step and ``host_post_dispatch`` under ``host_dispatch_lock``
        where the algorithm has one (its background thread takes it too).
        The telemetry and the health monitor, when attached, are fed as the
        module docstring says."""
        blocks = self._batch_blocks[0]
        for t in tree_leaves(batch):
            if t.shape[0] % blocks:
                raise ValueError(
                    f"batch {t.shape[0]} not divisible into the {blocks} blocks of this "
                    f"process's ranks (exchange size {self.group.exchange_size})"
                )
        batch = tree_map(lambda t: t.to(self.group.device, non_blocking=True), batch)
        impl, step = self.impl, state.step
        if impl.need_reset(step):
            self._variants_seen = set()
        variant = impl.step_variant(step)
        tel = self.telemetry
        if tel is not None:
            tel.on_step_start(step, variant=variant)
        missed = variant not in self._variants_seen
        if missed:
            if tel is not None:
                tel.on_compile(variant, step)
            # the pre-dispatch gate, before the variant counts as seen: a
            # strict rejection leaves nothing behind, so a retry verifies
            # again (a no-op with BAGUA_STATIC_VERIFY off)
            self._maybe_static_verify(variant, state, batch)
            self._variants_seen.add(variant)
        ov, step_ov = self.host_overhead, {}
        t0 = time.perf_counter()
        if self._pending_reshard is not None:
            state = self._apply_pending_reshard(state)
        state = impl.host_pre_dispatch(state)
        t1 = time.perf_counter()
        step_ov["pre"] = t1 - t0
        if tel is not None:
            tel.enter_phase("dispatch")
        flight = tel.flight if tel is not None else None
        lock = impl.host_dispatch_lock
        with lock if lock is not None else contextlib.nullcontext():
            t2 = time.perf_counter()
            if lock is not None:
                step_ov["lock_wait"] = t2 - t1
            new_state, losses, health = self._flight_dispatch(state, batch, variant, flight)
            t3 = time.perf_counter()
            step_ov["dispatch"] = t3 - t2
            impl.host_post_dispatch(new_state, new_state.step)
            step_ov["post"] = time.perf_counter() - t3
        self._host_step = new_state.step
        for k, v in step_ov.items():
            ov[k] += v
        ov["steps"] += 1
        wall = time.perf_counter() - t0
        self.step_timer.tick(wall)
        if tel is not None:
            if missed:
                # the miss step's dispatch wall: the JAX engine's compile wall
                tel.on_compile_done(variant, step, wall_ms=step_ov["dispatch"] * 1e3)
            tel.enter_phase("wait")
            self._report_step(tel, step, wall, batch, variant, step_ov)
        if health is not None:
            self._observe_health(step, new_state, *health)
        return new_state, losses

    @staticmethod
    def _health_rows(losses, grads):
        """The step's losses and gradient norms, ``(2, size)``, pure reads of
        the loss and the exchanged gradients, on their way to the host: on
        the card a copy into pinned memory behind an event, so that reading
        them waits for these rows, not for the optimizer's kernels queued
        after them.  Returns ``(losses, grads, rows, event)``."""
        rows = torch.stack([losses.to(torch.float32), grad_norms(losses, grads)])
        if not rows.is_cuda:
            return losses, grads, rows, None
        host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
        host.copy_(rows, non_blocking=True)
        return losses, grads, host, torch.cuda.current_stream(rows.device).record_event()

    def _observe_health(self, step: int, state: TrainState, losses, grads, rows, copied) -> None:
        """Feed the health monitor the ranks' mean loss, largest gradient
        norm and summed non-finite count (``health_scalars``' columns, as the
        JAX engine's ``_read_health`` aggregates them): one device-to-host
        read of the losses and norms; the count, which is zero wherever a
        norm is finite, only after a non-finite norm."""
        if copied is not None:
            copied.synchronize()
        rows = rows.double()
        nonfinite = 0 if bool(torch.isfinite(rows[1]).all()) else int(nonfinite_counts(losses, grads).sum())
        self.health_monitor.observe(step=step, loss=float(rows[0].mean()), grad_norm=float(rows[1].max()),
                                    nonfinite=nonfinite, state=state)

    def _report_step(self, tel, step: int, wall: float, batch, variant: str, step_ov: dict) -> None:
        """The step's ``on_step`` event: samples, the plan's wire bytes, by
        leg under a sharded update (a reduce-scatter and an all-gather of N
        bytes move N (n - 1) / n each), by precision, and on a named mesh by
        axis (from the variant's captured program, each record's bytes
        split evenly over its axes, else the plan's bytes over the data
        axes)."""
        leaves = tree_leaves(batch)
        n_samples = int(leaves[0].shape[0]) if leaves and leaves[0].dim() else 0
        plan = self.plan
        by_leg = by_precision = by_axis = None
        if self._sharded_updater is not None:
            n = self.group.exchange_size
            leg = plan.total_bytes() * (n - 1) // n
            by_leg = {"rs": leg, "ag": leg}
        if hasattr(self.impl, "wire_bytes_by_precision"):
            by_precision = self.impl.wire_bytes_by_precision(plan)
        if self.group.mesh_spec is not None:
            by_axis = {}
            for rec in self._flight_programs.get(variant) or ():
                axes = [a for a in (rec.get("axes") or ()) if a]
                for ax in axes:
                    by_axis[ax] = by_axis.get(ax, 0) + int(rec.get("nbytes") or 0) // len(axes)
            if not by_axis:
                axes = [a for a in self.group.data_axes if a]
                by_axis = {ax: plan.total_bytes() // len(axes) for ax in axes} if axes else {}
            by_axis = by_axis or None
        tel.on_step(
            step=step, wall_s=wall, n_samples=n_samples, wire_bytes=plan.total_bytes(),
            variant=variant, host_overhead=step_ov, wire_bytes_by_leg=by_leg,
            wire_bytes_by_precision=by_precision, wire_bytes_by_axis=by_axis,
        )

    def host_overhead_snapshot(self, reset: bool = False) -> dict:
        """Per-step host-side milliseconds by phase (see ``host_overhead``)
        and the p50/p95/p99 of the step wall."""
        ov = dict(self.host_overhead)
        n = max(1, ov.pop("steps"))
        out = {f"{k}_ms_per_step": round(v * 1e3 / n, 3) for k, v in ov.items()}
        out["steps"] = n
        out["step_wall_ms"] = {k: round(v * 1e3, 3) for k, v in self.step_timer.percentiles().items()}
        if reset:
            for k in self.host_overhead:
                self.host_overhead[k] = 0.0 if k != "steps" else 0
        return out

    # -- the flight recorder: capture once, replay every step ---------------------

    def _flight_dispatch(self, state: TrainState, batch, variant: str, flight):
        """Run one step, feeding the flight recorder: the variant's program
        is captured on its first step (every ``annotate`` and ring call of
        the step notifies the capture), then replayed into the ring before
        every step and retired after it, so a host that wedges inside the
        step leaves unretired records as evidence."""
        if flight is None:
            return self._step(state, batch)
        prog = self._flight_programs.get(variant)
        if prog is None:
            with capture_program() as events:
                self._capture = events
                try:
                    out = self._step(state, batch)
                finally:
                    self._capture = None
            prog = self._flight_programs[variant] = self._flight_finalize(variant, events)
            self._flight_crosscheck(variant, prog)
            flight.retire(flight.record_program(prog, step=state.step))
            return out
        if not prog:
            return self._step(state, batch)
        seqs = flight.record_program(prog, step=state.step)
        out = self._step(state, batch)
        flight.retire(seqs)
        return out

    def _flight_finalize(self, variant: str, events) -> tuple:
        """The captured descriptors as replayable record templates: each
        bucket's plan bytes and wire precision, the plan version, the
        variant and the label in the scope grammar, so ring records and
        trace labels join on one key."""
        plan = self.plan
        precisions = self.impl.bucket_precisions(plan) if hasattr(self.impl, "bucket_precisions") else None
        out = []
        for ev in events:
            rec = dict(ev)
            b = int(rec.get("bucket", -1))
            if "nbytes" not in rec:
                rec["nbytes"] = int(plan.specs[b].nbytes) if 0 <= b < len(plan.specs) else 0
            if "precision" not in rec:
                rec["precision"] = str(precisions[b]) if precisions and 0 <= b < len(precisions) else "f32"
            rec["plan_version"] = int(self.plan_version)
            rec["variant"] = str(variant)
            rec["label"] = format_exchange_label(rec["algo"], b, rec["phase"])
            out.append(rec)
        return tuple(out)

    def _reset_programs(self) -> None:
        """The collective sequence changed: the next step of every variant
        counts as a miss and captures its program again."""
        self._variants_seen = set()
        self._flight_programs = {}
        self._predicted_programs = {}

    # -- the static gate -----------------------------------------------------------

    def _maybe_static_verify(self, variant: str, state: TrainState, batch) -> None:
        """The ``BAGUA_STATIC_VERIFY`` pre-dispatch gate: run the variant's
        step dry on meta (nothing reaches the card), capture its collective
        program and run the four checkers.  ``strict`` raises before
        dispatch; ``warn`` logs and proceeds.  The meta batch is kept so a
        switch can re-verify its new program at once."""
        mode = get_static_verify_mode()
        if mode == "off" or self.plan is None:
            return
        from bagua_tpu_torch import analysis as _an

        self._verify_batch_template = tree_map(lambda t: torch.empty_like(t, device="meta"), batch)
        where = f"variant={variant!r}"
        report = self._run_verify(_an, lambda: _an.meta_state(self, state), variant, mode, where)
        if report is None:
            return
        self._verify_report(report, mode, where)
        # committed only once the gate passed (or warn proceeds): a strict
        # rejection leaves no prediction behind
        self._predicted_programs[variant] = report.predicted

    def _static_reverify(self, reason: str) -> None:
        """Re-run the gate on the CURRENT plan, precision and algorithm over
        a meta state built in the current layout and the kept batch.  A
        no-op until the gate has seen a batch."""
        mode = get_static_verify_mode()
        if mode == "off" or self.plan is None or self._verify_batch_template is None:
            return
        from bagua_tpu_torch import analysis as _an

        variant = self.impl.step_variant(self._host_step)
        with default_axes(self.group.data_axes):
            report = self._run_verify(_an, lambda: _an.meta_state(self, None), variant, mode, reason)
        if report is None:
            return
        self._verify_report(report, mode, reason)
        self._predicted_programs[variant] = report.predicted

    def _run_verify(self, _an, meta, variant: str, mode: str, where: str):
        """Dry-run and check one step variant.  A failure of the dry run
        itself (not a checker's finding) raises under strict and is logged
        under warn, where the gate is advisory; returns None then."""
        try:
            return _an.verify_step_program(self, meta(), self._verify_batch_template, variant=variant)
        except _an.StaticVerifyError:
            raise
        except Exception as e:
            if mode == "strict":
                raise
            logger.warning("static verify (%s): dry run failed, gate skipped: %s", where, e)
            return None

    @staticmethod
    def _verify_report(report, mode: str, where: str) -> None:
        if report.ok:
            logger.debug("static verify (%s): %s", where, report.summary())
            return
        if mode == "strict":
            report.raise_if_failed()
        for f in report.errors:
            logger.warning("static verify (%s): %s", where, f)

    def _flight_crosscheck(self, variant: str, prog) -> None:
        """Static/dynamic agreement on the real step: the program the flight
        recorder just captured must equal the one the gate predicted.  Only
        where the gate ran for this variant."""
        predicted = self._predicted_programs.get(variant)
        mode = get_static_verify_mode()
        if predicted is None or mode == "off":
            return
        from bagua_tpu_torch.analysis import StaticVerifyError, check_static_dynamic

        findings = check_static_dynamic(predicted, prog)
        if not findings:
            return
        if mode == "strict":
            raise StaticVerifyError(findings)
        for f in findings:
            logger.warning("static verify (flight capture, variant=%r): %s", variant, f)

    def _step(self, state: TrainState, batch):
        impl = self.impl
        ctx = StepContext(group=self.group, step=state.step, plan=self.plan)
        params, algo_state = impl.on_step_start(state.params, state.algo_state, ctx)
        mode = impl.overlap_capability().mode if self.overlap_enabled else None
        if mode in ("gradient", "weight"):
            # the per-bucket exchanges that read the algorithm's state
            # (QAdam's momentum) find it here
            ctx.extras["algo_state"] = algo_state
            losses, grads, params, local = self._overlapped(params, batch, ctx, weight=mode == "weight")
        else:
            losses, local = self._rank_grads(params, batch)
            grads, params, algo_state = impl.transform_gradients(local, params, algo_state, ctx)
        if mode is not None:
            grads, params, algo_state = impl.finalize_overlap(grads, params, algo_state, ctx)
        dry = self._ir_capture is not None
        health = self._health_rows(losses, grads) if self.health_monitor is not None and not dry else None
        self._write_params(state.params, params)
        if dry:
            # the static gate's dry run: the update issues no collective (a
            # sharded update's gather is the next step's on_step_start)
            pass
        elif self._sharded_updater is not None:
            covered = self.plan.covered()
            local_grads = {n: g for n, g in tree_flatten_with_names(local) if n not in covered}
            pending, _, params = self._sharded_updater.update_shards(
                grads, state.params, state.optimizer, local_grads)
            algo_state = impl.stash_updates(algo_state, pending)
        elif not impl.skips_optimizer_update or impl.is_update_step(state.step):
            for p, g in zip(tree_leaves(state.params), tree_leaves(grads)):
                p.grad = g
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
        # else: an accumulating algorithm's step off its boundary: no
        # optimizer call at all, so Adam's count and moments stay as they are
        params, algo_state = impl.on_step_end(state.params, algo_state, ctx)
        self._write_params(state.params, params)
        return TrainState(state.params, state.optimizer, algo_state, state.step + 1), losses, health

    # -- the bucket plan ----------------------------------------------------------

    def rebucket(self, plan: BucketPlan, predicted_exposed_ms: Optional[float] = None,
                 reason: str = "planner") -> None:
        """Adopt a new bucket plan; the next step's hooks and exchanges
        follow it, and under a sharded-update algorithm the next step first
        migrates the optimizer's shards and the pending parameter shards to
        the new layout.  ``reason`` speaks the switch vocabulary
        (``planner | health:<kind> | autopilot:<incident> | manual``) and
        rides the telemetry's ``rebucket`` event with
        ``predicted_exposed_ms``, the planner's prediction for the plan.
        Under ``BAGUA_STATIC_VERIFY`` the new program is verified at once;
        a rejection re-adopts the previous plan and raises."""
        validate_switch_reason(reason)
        if getattr(self.impl, "holds_bucketized_state", False):
            raise ValueError(
                f"{type(self.impl).__name__} keeps per-bucket state; re-bucketing "
                "mid-training would desync it"
            )
        prev_plan, prev_pending = self.plan, self._pending_reshard
        if self._sharded_updater is not None and self._pending_reshard is None:
            # the layout the live state was built under: the first of a
            # burst of rebuckets keeps it
            self._pending_reshard = self._sharded_updater.layout
        self.impl.overlap_hint = self.overlap_enabled
        self._adopt_plan(plan)
        self.plan_version += 1
        try:
            self._static_reverify("rebucket")
        except Exception:
            # the engine keeps dispatching the last good program (the
            # version moves on again: a version names one configuration)
            if prev_plan is not None:
                self._adopt_plan(prev_plan)
            self._pending_reshard = prev_pending
            self.plan_version += 1
            raise
        self._plan_source = switch_reason_family(reason)
        if self.telemetry is not None:
            self.telemetry.on_rebucket(
                plan_version=self.plan_version, n_buckets=plan.num_buckets, step=self._host_step,
                predicted_exposed_ms=predicted_exposed_ms, reason=reason,
            )

    def export_plan_payload(self) -> Optional[dict]:
        """The live bucket plan and the configuration adopted with it (the
        algorithm, the overlap knob, the wire precisions, the staleness
        bound and who chose them)
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
        tau = getattr(self.impl, "staleness_tau", None)
        if hasattr(self.impl, "set_staleness_tau") and tau is not None:
            config["staleness_tau"] = int(tau)
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
        The carried configuration (overlap, per-bucket precisions, the
        staleness bound) is re-applied on top."""
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
        tau = cfg.get("staleness_tau")
        if (tau is not None and hasattr(self.impl, "set_staleness_tau")
                and getattr(self.impl, "staleness_tau", None) is not None):
            self.apply_staleness(int(tau), reason=reason)
        if source in SWITCH_REASON_FAMILIES:
            self._plan_source = source

    def apply_precision_plan(self, precisions, reason: str = "planner") -> bool:
        """Adopt a per-bucket wire-precision plan (one of ``"f32"``,
        ``"int8"``, ``"int4"`` per bucket) on an algorithm built with
        ``wire_precision="auto"``; ``None`` clears it.  The next step uses
        it.  Returns True when the resolved per-bucket precisions changed.
        An algorithm without the ``wire_precision`` knob raises
        AttributeError.  ``reason`` speaks the switch vocabulary and is
        recorded as the plan's source; a change emits the telemetry's
        ``precision_switch`` event.  Under ``BAGUA_STATIC_VERIFY`` the new
        program is verified at once; a rejection restores the previous
        precisions and raises."""
        validate_switch_reason(reason)
        impl = self.impl
        if not hasattr(impl, "set_bucket_precision"):
            raise AttributeError(
                f"{type(impl).__name__} has no wire_precision knob; "
                "precision plans apply to gradient_allreduce"
            )
        prev_raw = getattr(impl, "bucket_precision", None)
        old = impl.bucket_precisions(self.plan) if self.plan is not None else None
        impl.set_bucket_precision(precisions)
        new = impl.bucket_precisions(self.plan) if self.plan is not None else None
        self._plan_source = switch_reason_family(reason)
        if new == old:
            return False
        self._reset_programs()
        try:
            self._static_reverify("apply_precision_plan")
        except Exception:
            impl.set_bucket_precision(prev_raw)
            self._reset_programs()
            raise
        if self.telemetry is not None:
            self.telemetry.on_precision_switch(
                step=self._host_step, plan_version=self.plan_version,
                old_precisions=old or [], new_precisions=new or [], reason=reason,
            )
        return True

    # -- bounded staleness ---------------------------------------------------------
    #
    # The JAX engine re-traces the step on a τ switch; the port runs its
    # stages eagerly (nothing to re-trace).  Both re-verify the new program
    # statically under ``BAGUA_STATIC_VERIFY`` and emit the telemetry's
    # ``staleness_switch`` event.

    def _staleness_impl(self, what: str) -> AlgorithmImpl:
        """The algorithm, if it has the staleness knob; ``what`` names the
        caller's subject in the AttributeError otherwise."""
        impl = self.impl
        if not hasattr(impl, "set_staleness_tau"):
            raise AttributeError(
                f"{type(impl).__name__} has no staleness knob; {what} to the "
                "stale and gossip-decentralized algorithms"
            )
        return impl

    def apply_staleness(self, tau: int, reason: str = "planner") -> bool:
        """Re-bound the staleness knob of a bounded-staleness algorithm
        (``stale``, or ``decentralized`` built with ``staleness_tau``); the
        next step uses it.  Returns True when τ changed.  An algorithm
        without the knob raises AttributeError; an instance whose staleness
        state was never allocated (``staleness_tau=None``) raises
        ValueError from the algorithm.  ``reason`` speaks the switch
        vocabulary and is recorded as the plan's source."""
        validate_switch_reason(reason)
        impl = self._staleness_impl("bounded staleness applies")
        tau = int(tau)
        if tau < 0:
            raise ValueError(f"staleness tau must be >= 0, got {tau}")
        old_tau = int(getattr(impl, "staleness_tau", None) or 0)
        impl.set_staleness_tau(tau)
        if old_tau == tau:
            return False
        self._reset_programs()
        try:
            self._static_reverify("apply_staleness")
        except Exception:
            impl.set_staleness_tau(old_tau)
            self._reset_programs()
            raise
        self._plan_source = switch_reason_family(reason)
        if self.telemetry is not None:
            self.telemetry.on_staleness_switch(
                step=self._host_step, plan_version=self.plan_version, old_tau=old_tau, new_tau=tau,
                reason=reason,
            )
        return True

    def apply_degradation_directive(self, state: TrainState, ranks) -> TrainState:
        """Flip the per-rank degradation directive of a bounded-staleness
        algorithm: ``ranks`` are the ranks allowed to run stale (empty:
        every rank bulk-synchronous).  The directive is a rank-stacked
        ``(size,)`` int32 tensor of the algorithm state; the flip swaps
        that tensor and nothing else, and returns the new train state."""
        self._staleness_impl("degradation directives apply")
        algo_state = state.algo_state
        if not (isinstance(algo_state, dict) and "directive" in algo_state):
            raise ValueError(
                "algorithm state carries no 'directive' leaf — was the "
                "engine initialized with the staleness state allocated?"
            )
        n = self.group.size
        flags = torch.zeros((n,), dtype=torch.int32)
        for r in ranks:
            r = int(r)
            if not 0 <= r < n:
                raise ValueError(f"rank {r} out of range for world size {n}")
            flags[r] = 1
        # the directive holds this process's ranks
        directive = flags[list(self.group.local_rows)].to(algo_state["directive"].device)
        if self.telemetry is not None:
            for r in range(n):
                self.telemetry.registry.gauge(
                    f"staleness_directive_rank{r}", help="1 while this rank is allowed to run stale",
                ).set(int(flags[r]))
        return dataclasses.replace(state, algo_state={**algo_state, "directive": directive})

    def reset_staleness_state(self, state: TrainState) -> TrainState:
        """Re-prime the replay state after :meth:`apply_staleness` raises τ
        from 0: every rank's staleness counter is set to the current τ, so
        a rank under a directive makes a fresh contribution on its next
        round (which rewrites the replay payload before anything can replay
        it), and the error-feedback ``residual`` restarts at zero."""
        impl = self._staleness_impl("staleness state applies")
        algo_state = state.algo_state
        if not (isinstance(algo_state, dict) and "staleness" in algo_state):
            raise ValueError(
                "algorithm state carries no 'staleness' leaf — was the "
                "engine initialized with the staleness state allocated?"
            )
        tau = int(getattr(impl, "staleness_tau", None) or 0)
        new_state = {**algo_state, "staleness": torch.full_like(algo_state["staleness"], tau)}
        if "residual" in algo_state:
            new_state["residual"] = tree_map(torch.zeros_like, algo_state["residual"])
        return dataclasses.replace(state, algo_state=new_state)

    # -- switching the algorithm of a live run --------------------------------------

    #: algorithms a live run can move between: their state is the
    #: optimizer's over the parameters plus zero-initialized scratch
    #: (residuals, pending shards), so a switch is a re-layout.  The
    #: decentralized family holds per-rank weights and would need a
    #: consensus step.
    SWITCHABLE_ALGORITHMS = ("gradient_allreduce", "zero", "bytegrad")

    @_on_data_axes
    def switch_algorithm(self, state: TrainState, algorithm, reason: str = "manual", **algo_kwargs) -> TrainState:
        """Move the live run to another algorithm of
        :data:`SWITCHABLE_ALGORITHMS` (a registry name, built with
        ``algo_kwargs``; or an :class:`Algorithm` or a reified impl).

        Re-buckets under the new algorithm's plan, then maps the optimizer
        state value for value: into ZeRO the full state is scattered into
        the updater's rows (``scatter_full_state``) and both the rows and
        the pending shards are seeded from the live parameters, so the next
        step's all-gather gives them back bit for bit; out of ZeRO the
        pending update is gathered into the parameters first
        (:meth:`finalize_pending_updates`), then the state is gathered
        whole (``gather_full_state``).  The optimizer is rebuilt over the
        same stacked parameter tensors.  Residuals restart at zero.  On any
        exception the engine rolls back its algorithm, plan, updater,
        overlap knob and plan version, and the caller keeps ``state``.  A
        switch to the running algorithm returns ``state`` itself.  A switch
        emits the telemetry's ``rebucket`` event naming the new algorithm.
        Under ``BAGUA_STATIC_VERIFY`` the new program is verified before
        the switch completes; a rejection rolls back as any exception
        does."""
        from bagua_tpu_torch.algorithms import build_algorithm

        validate_switch_reason(reason)
        if self.plan is None:
            raise ValueError("call init() before switch_algorithm()")
        if isinstance(algorithm, str):
            if algorithm not in self.SWITCHABLE_ALGORITHMS:
                raise ValueError(
                    f"cannot switch a live gang to {algorithm!r}: supported "
                    f"targets are {self.SWITCHABLE_ALGORITHMS} (the "
                    "decentralized family holds per-rank weights and needs a "
                    "consensus step, not a state remap)"
                )
            new_impl = build_algorithm(algorithm, **algo_kwargs).reify(self.group)
        elif isinstance(algorithm, Algorithm):
            new_impl = algorithm.reify(self.group)
        else:
            new_impl = algorithm
        cur_name = self.impl.algo_name or type(self.impl).__name__
        new_name = new_impl.algo_name or type(new_impl).__name__
        if cur_name not in self.SWITCHABLE_ALGORITHMS:
            raise ValueError(
                f"cannot switch a live gang OFF {cur_name!r}: its state is "
                "not a pure re-layout of the switchable family's"
            )
        if new_name == cur_name:
            return state
        _hierarchical_on_named_mesh(self.group, new_impl, "pass hierarchical=False to switch under a MeshSpec")
        sharded_src = self._sharded_updater is not None
        sharded_dst = bool(getattr(new_impl, "sharded_update", False))
        if (sharded_src or sharded_dst) and self.group.exchange_size != self.group.size:
            raise ValueError(
                "switching into/out of a sharded-update algorithm is "
                "undefined when model axes are present (shard rows are per "
                "exchange-ring rank, state rows per mesh rank)"
            )

        pending_before = self._pending_reshard
        if self._pending_reshard is not None:
            state = self._apply_pending_reshard(state)
        if sharded_src:
            state = self.finalize_pending_updates(state)
            full_opt = self._sharded_updater.gather_full_state(state.optimizer, state.params)
        else:
            full_opt = state.optimizer.state_dict()

        prev = (self.impl, self.plan, self._sharded_updater, self.overlap, self.exchange_counts,
                self.plan_version)
        try:
            self.impl = new_impl
            if self.overlap is True:
                cap = new_impl.overlap_capability()
                if not cap.supported:
                    logger.warning("switch_algorithm(%s): overlap=True unsupported (%s); "
                                   "demoting to overlap='auto'", new_name, cap.reason)
                    self.overlap = "auto"
            new_impl.overlap_hint = self.overlap_enabled
            self._sharded_updater = None
            self._adopt_plan(new_impl.tensors_to_buckets(
                self._tree_template, self.bucket_size_bytes, filter_fn=self.dp_filter))
            self._pending_reshard = None
            self.plan_version += 1
            algo_state = new_impl.init_state(tree_map(lambda p: p[0], state.params))
            if sharded_dst:
                # the rows are seeded from the parameters, and the pending
                # shards are views of them: the next step's gather is a no-op
                optimizer = self._sharded_updater.scatter_full_state(full_opt, state.params)
                algo_state = new_impl.stash_updates(algo_state, self._sharded_updater.pending(optimizer))
            else:
                optimizer = self.optimizer(tree_leaves(state.params))
                optimizer.load_state_dict(full_opt)
            # prove the new program before anything can dispatch it
            self._static_reverify("switch_algorithm")
        except Exception:
            self.impl, self.plan, self._sharded_updater, self.overlap, self.exchange_counts, version = prev
            self.impl.overlap_hint = self.overlap_enabled
            self.impl.bind_plan(self.plan)
            self._pending_reshard = pending_before
            self.plan_version = version + 1  # a version names one configuration: never reuse one
            self._reset_programs()
            raise
        self._plan_source = switch_reason_family(reason)
        if self.telemetry is not None:
            self.telemetry.on_rebucket(
                plan_version=self.plan_version, n_buckets=self.plan.num_buckets, step=self._host_step,
                reason=reason, algorithm=new_name,
            )
        return TrainState(state.params, optimizer, algo_state, state.step)

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
        if self.group.exchange_size != self.group.size:
            raise ValueError(
                "host-side shard migration is undefined when model axes are "
                "present (shard rows are per exchange-ring rank, state rows "
                "per mesh rank); run rebucket before init or drop the tp axis"
            )
        old, self._pending_reshard = self._pending_reshard, None
        new = self._sharded_updater.layout
        return TrainState(
            params=state.params,
            optimizer=self._sharded_updater.reshard_state(state.optimizer, old),
            algo_state=self.impl.reshard_host_state(state.algo_state, old, new),
            step=state.step,
        )

    @_on_data_axes
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

    # -- the train state on the host: snapshots, checkpoints, elastic resume -------

    def state_template(self, state: TrainState) -> TrainState:
        """A fresh state of the CURRENT layout over ``state``'s parameter
        tensors: the optimizer (under a sharded update, the updater's rows
        and the optimizer over them) and the algorithm's state built anew
        as :meth:`init` builds them, without re-planning.  What a resume
        loads a snapshot into after adopting its plan (the state built by
        ``init`` before that may describe another shard layout)."""
        updater = self._sharded_updater
        one = tree_map(lambda p: p[0], state.params)
        with default_axes(self.group.data_axes):
            algo_state = self.impl.init_state(one)
            optimizer = updater.init(state.params) if updater else self.optimizer(tree_leaves(state.params))
        return TrainState(state.params, optimizer, algo_state, state.step)

    def reshard_host_state(self, leaves: Dict[str, np.ndarray], plan_payload: dict, old_world: int,
                           dtypes: Optional[Dict[str, str]] = None):
        """Re-shard a sharded-update snapshot's host leaves (``{key:
        array}``, rank-stacked at ``old_world``) into this engine's current
        layout and world size: the sharded-update replacement for a plain
        ``remap_world_size`` on an elastic resume.  Replicated leaves (the
        parameters, the uncovered leaves' optimizer state) take row 0; the
        updater's rows, their per-element optimizer state and the pending
        shards migrate value for value by tensor name through the shard
        layout the snapshot's plan payload records; 0-d leaves stay;
        error-feedback residuals restart at zero.  Returns ``(leaves,
        dtypes)``, the torch dtype names (``dtypes``, as the snapshot's
        manifest records them) following the leaves' new keys."""
        from bagua_tpu_torch.checkpoint.checkpointing import remap_leaf
        from bagua_tpu_torch.resilience.snapshot import dtype_name
        from bagua_tpu_torch.sharded.layout import reshard_bucket_rows, reshard_group_flat
        from bagua_tpu_torch.utils import from_bagua_datatype

        if self.group.exchange_size != self.group.size:
            raise ValueError(
                "snapshot resharding is undefined when model axes are present "
                "(per-rank shard rows don't map 1:1 to exchange-ring slots); "
                "resume onto a data-only mesh, then re-shard"
            )
        old = ShardLayout.from_payload(plan_payload, old_world)
        new = self._sharded_updater.layout
        n_new = self.group.size
        new_index = {}
        for oi, og in enumerate(old.groups):
            ng = new.group_for(og.dtype)
            if ng is None:
                raise ValueError(f"the live shard layout lacks the snapshot's dtype group {og.dtype!r}")
            new_index[oi] = new.groups.index(ng)
        for ng in new.groups:
            if old.group_for(ng.dtype) is None:
                raise ValueError(f"snapshot shard layout lacks dtype group {ng.dtype!r}")
        rows_key = re.compile(r"^\.optimizer\.(rows|sharded\['state'\])\[(\d+)\](.*)$")
        dtypes = dtypes or {}
        out: Dict[str, np.ndarray] = {}
        out_dtypes: Dict[str, str] = {}
        pending = {}
        for key, a in leaves.items():
            a = np.asarray(a)
            m = rows_key.match(key)
            if m is not None:
                oi = int(m.group(2))
                og = old.groups[oi]
                nkey = f".optimizer.{m.group(1)}[{new_index[oi]}]{m.group(3)}"
                if key in dtypes:
                    out_dtypes[nkey] = dtypes[key]
                if a.ndim >= 2 and a.shape[0] == old.n_shards and a.shape[-1] == og.shard_total:
                    out[nkey] = reshard_group_flat(a, old, new, og.dtype).astype(a.dtype)
                else:
                    out[nkey] = remap_leaf(nkey, a, n_new, lambda _: False)
            elif key.startswith(".algo_state['pending']"):
                pending[int(key[len(".algo_state['pending']"):].strip("[]"))] = a
            elif key.startswith(".algo_state['qr_residual']"):
                continue
            else:
                out[key] = remap_leaf(key, a, n_new, lambda _: False)
                if key in dtypes:
                    out_dtypes[key] = dtypes[key]
        if pending:
            rows = reshard_bucket_rows([pending[bi] for bi in sorted(pending)], old, new)
            for bi, (r, b) in enumerate(zip(rows, new.buckets)):
                out[f".algo_state['pending'][{bi}]"] = r
                out_dtypes[f".algo_state['pending'][{bi}]"] = dtype_name(from_bagua_datatype(b.dtype))
        if any(k.startswith(".algo_state['qr_residual']") for k in leaves):
            for bi, b in enumerate(new.buckets):
                out[f".algo_state['qr_residual'][{bi}]"] = np.zeros((n_new, b.numel), np.float32)
                out_dtypes[f".algo_state['qr_residual'][{bi}]"] = "float32"
        return out, out_dtypes

    def optimizer_state_bytes(self, state: TrainState) -> int:
        """Bytes of optimizer state one rank holds: the state tensors' bytes
        over the ranks this process stacks.  A sharded update's
        parameter rows are parameters, not state, and are not counted."""
        opt = state.optimizer
        opts = (opt.sharded, opt.local) if isinstance(opt, ShardedOptState) else (opt,)
        total = sum(v.numel() * v.element_size() for o in opts if o is not None
                    for st in o.state.values() for v in st.values() if torch.is_tensor(v))
        return total // self.group.local_size

    # -- the algorithm's background machinery --------------------------------------

    def shutdown(self) -> None:
        """Stop the algorithm's background machinery (async model average's
        averager thread) for good; safe to call more than once."""
        self.impl.host_shutdown()

    def abort(self) -> None:
        """Pause the algorithm's background behaviour (async model average:
        drain the in-flight average and discard it)."""
        self.impl.abort()

    def resume(self) -> None:
        """Undo :meth:`abort`."""
        self.impl.resume()

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
        """The batch :meth:`train_step` takes from this process's rows (the
        JAX package's ``make_array_from_process_local_data`` over the data
        axes): single-controller, the global batch, passed through; on a
        group that spans processes every process loads only its own ranks'
        rows, ``local_size`` blocks of the per-rank batch on the legacy
        mesh, and they are the step's batch as they are (checked here)."""
        if self.group.distributed:
            blocks = self._batch_blocks[0]
            for t in tree_leaves(local_batch):
                if t.dim() == 0 or t.shape[0] % blocks:
                    raise ValueError(f"a local batch of {tuple(t.shape)[:1]} rows does not divide "
                                     f"into this process's {blocks} blocks")
        return local_batch

    def process_rows(self, global_batch):
        """This process's rows of a global batch, the batch :meth:`train_step`
        takes from it: on a group that spans processes the blocks (of
        ``exchange_size``) of the data indices its ranks hold, in order;
        single-controller, the global batch itself."""
        if not self.group.distributed:
            return global_batch
        blocks = self.group.exchange_size
        mine = torch.unique(self._data_rank.cpu())

        def rows(t):
            if t.dim() == 0 or t.shape[0] % blocks:
                raise ValueError(f"a global batch of {tuple(t.shape)[:1]} rows does not divide into "
                                 f"{blocks} blocks")
            return t.reshape(blocks, t.shape[0] // blocks, *t.shape[1:])[mine.to(t.device)].reshape(-1, *t.shape[1:])
        return tree_map(rows, global_batch)

    def record_speed(self, n_samples: int) -> None:
        self.speed_meter.record(n_samples)

    def params_unstacked(self, state: TrainState, rank: int = 0):
        """One rank's parameter copy; on a group that spans processes
        ``rank`` is a global rank this process holds (another raises)."""
        rows = self.group.local_rows
        if rank not in rows:
            raise ValueError(f"rank {rank} is not one of this process's ranks {list(rows)}")
        return tree_map(lambda x: x[rank - rows.start], state.params)


class AutotuneSession:
    """Drives the autotune service's register / report / re-bucket cycle for
    one engine (the port of ``bagua_tpu/ddp.py``'s): register the plan's
    tensors at construction, report the speed and ask for hyperparameters
    every ``interval`` steps, and apply what comes back.

    Each knob that changes what a step exchanges (the bucket plan, the
    hierarchical reduction, the wire dtype, the overlap mode) resets the
    engine's per-variant state: the variants seen (the recompile detector's
    misses) and the flight recorder's captured programs, so the next step
    captures its program again instead of replaying a stale one.  The
    overlap hooks are registered anew every step and hold nothing across
    steps.  Such a change also restarts the engine's speed meter, so each
    speed the session reports is the throughput of the configuration the
    service credits it to (the JAX package's session reports the run's
    average since its start, under which the first samples decide the
    pick)."""

    def __init__(self, ddp: DistributedDataParallel, model_name: str, client=None, interval: int = 100):
        from bagua_tpu_torch.env import get_rpc_breaker_cooldown_s, get_rpc_breaker_threshold
        from bagua_tpu_torch.observability.core import SpanRecorder
        from bagua_tpu_torch.resilience.retry import CircuitBreaker, CircuitOpenError
        from bagua_tpu_torch.service.autotune_client import get_hyperparameters_service_client

        self.ddp = ddp
        self.model_name = model_name
        self.client = client or get_hyperparameters_service_client()
        self.interval = interval
        self._step = 0
        self.completed = False
        decls = [td for bucket in ddp.plan.declarations() for td in bucket]
        # the wire dtype and mode the first speed reports are measured under
        self.client.register_tensors(
            model_name, decls,
            current_wire_bf16=getattr(ddp.impl, "wire_dtype", None) == torch.bfloat16,
            current_overlap=ddp.overlap_enabled,
        )
        self.spans = SpanRecorder()
        # until profile_and_report runs, the service orders tensors by their
        # registration, which is the plan's order
        self.profiled = False
        # a service that flaps mid-run leaves the session on its current
        # hyperparameters: the client retries, and once the breaker opens
        # tick is a fast no-op until the cooldown
        self._breaker = CircuitBreaker(failure_threshold=get_rpc_breaker_threshold(),
                                       cooldown_s=get_rpc_breaker_cooldown_s(), name="autotune")
        self._CircuitOpenError = CircuitOpenError

    def profile_and_report(self, state: TrainState, batch) -> None:
        """Measure the buckets' gradient-arrival order
        (:meth:`DistributedDataParallel.profile_bucket_order`: one forward
        and backward, no exchange, no update) and send it to the service as
        ``tensor_ready`` spans.  Call once when training starts (the
        ``Trainer`` does)."""
        times = self.ddp.profile_bucket_order(state, batch)
        self.spans.record_measured_order(self.ddp.plan, times)
        self.spans.report_to_autotune(self.client, self.model_name)
        self.profiled = True

    def report_wire_timings(self, analysis, hierarchical: Optional[bool] = None) -> None:
        """Send a device-trace analysis
        (:func:`~bagua_tpu_torch.observability.trace_analysis.analyze_trace`)
        to the service as per-bucket ``bucket_wire`` spans, the measured
        wire times the service's planner fits its alpha-beta cost model on.
        A sharded-update algorithm's spans calibrate the reduce-scatter leg."""
        if hierarchical is None:
            hierarchical = bool(getattr(self.ddp.impl, "hierarchical", False))
        leg = "rs" if getattr(self.ddp.impl, "sharded_update", False) else None
        self.spans.record_wire_timings(self.ddp.plan, analysis, intra_size=self.ddp.group.intra_size,
                                       hierarchical=hierarchical, leg=leg)
        self.spans.report_to_autotune(self.client, self.model_name)

    def tick(self, n_samples: int) -> None:
        """Call once per training step with the samples it processed."""
        from bagua_tpu_torch.env import get_rank

        self.ddp.record_speed(n_samples)
        self._step += 1
        if self.completed or self._step % self.interval != 0:
            return
        # the service tunes once every rank in [0, world_size) has reported
        # for an iteration: each process reports its own index (0 on one
        # controller, which drives every rank of the group)
        rank = get_rank()
        try:
            self._breaker.before_call()
            self.client.report_metrics(self.model_name, rank, self._step, self.ddp.speed_meter.speed(60.0))
            hp, self.completed = self.client.ask_hyperparameters(self.model_name, rank, self._step)
        except self._CircuitOpenError:
            return
        except (OSError, ConnectionError) as e:
            # the client already retried: the service is down; keep training
            # on the current hyperparameters (the breaker opens after a few)
            self._breaker.record_failure()
            logger.warning("autotune service unreachable at step %d (%s); keeping current "
                           "hyperparameters", self._step, e)
            return
        self._breaker.record_success()
        self._apply(hp)

    def _apply(self, hp) -> None:
        ddp, impl = self.ddp, self.ddp.impl
        if getattr(impl, "holds_bucketized_state", False):
            return  # cannot re-bucket this algorithm
        changed = False
        current = ddp.plan.declarations()
        proposed = [list(bucket) for bucket in hp.buckets]
        if proposed and [[td.name for td in b] for b in proposed] != [[td.name for td in b] for b in current]:
            plan = BucketPlan.from_declarations(proposed, ddp._tree_template,
                                                align_elems=ddp.group.exchange_size)
            ddp.rebucket(plan, predicted_exposed_ms=getattr(hp, "predicted_exposed_ms", None))
            changed = True
        if hp.is_hierarchical_reduce != impl.hierarchical:
            if hp.is_hierarchical_reduce and ddp.group.mesh_spec is not None:
                logger.info("autotune proposed a hierarchical reduction; the named mesh has no "
                            "(inter, intra) axes, so it stays flat")
            else:
                impl.hierarchical = hp.is_hierarchical_reduce
                ddp._reset_programs()
                changed = True
        # the wire-dtype knob: only algorithms with ``wire_dtype``
        # (gradient_allreduce) take part; None means the service is not
        # tuning it, and a user-configured wire dtype is left alone
        if hp.wire_bf16 is not None and hasattr(impl, "wire_dtype"):
            want = torch.bfloat16 if hp.wire_bf16 else None
            if want != impl.wire_dtype:
                impl.wire_dtype = want
                ddp._reset_programs()
                changed = True
        # the execution-mode knob, same tri-state contract, for
        # gradient-mode algorithms only: weight and post_step algorithms
        # shape their plan by the mode, which would need a re-plan
        cap = impl.overlap_capability()
        if hp.overlap is not None and cap.supported and cap.mode == "gradient":
            if bool(hp.overlap) != ddp.overlap_enabled:
                ddp.overlap = bool(hp.overlap)
                impl.overlap_hint = ddp.overlap_enabled
                ddp._reset_programs()
                changed = True
        if changed:
            ddp.speed_meter.reset()
