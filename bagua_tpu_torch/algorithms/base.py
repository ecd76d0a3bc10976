"""Algorithm plugin base: data-parallel relaxations as step stages.

The port of ``bagua_tpu/algorithms/base.py``.  An algorithm is a set of
stages the DDP engine composes around the backward pass and the optimizer
step, all on rank-stacked tensors:

    on_step_start → backward → transform_gradients → optimizer step
                              (or, with overlap, overlap_exchange per
                               bucket inside the backward, then
                               finalize_overlap)
    → on_step_end

Every stage receives a :class:`StepContext` carrying the process group, the
step counter, the bucket plan and ``extras``, a dict the stages of one
step share (an overlap step puts the algorithm's state there, under
``"algo_state"``, for the per-bucket exchanges that read it).

A stage may return new parameter tensors: the engine copies each into the
stacked tensor the optimizer holds (:class:`~bagua_tpu_torch.ddp.TrainState`'s
``params``), before the optimizer step and again after :meth:`AlgorithmImpl.on_step_end`.
"""

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from bagua_tpu_torch.bucket import BucketPlan
from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.env import get_default_bucket_size
from bagua_tpu_torch.observability.annotations import bucket_scope
from bagua_tpu_torch.observability.flight_recorder import notify_collective


@dataclasses.dataclass
class StepContext:
    """Per-step info handed to every algorithm stage."""

    group: BaguaProcessGroup
    step: int
    plan: Optional[BucketPlan] = None
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class OverlapCapability:
    """One algorithm's report on the backward-overlapped execution mode,
    which the engine's ``overlap`` knob resolves against.

    ``mode`` says what rides the backward pass: ``"gradient"`` (each
    bucket's gradients, exchanged by :meth:`AlgorithmImpl.overlap_exchange`
    as the backward completes them), ``"weight"`` (each bucket's *weights*,
    exchanged by ``overlap_exchange(..., params_leaves=...)`` as the
    backward completes the bucket's gradients; the exchanged weights are
    what the optimizer steps: decentralized SGD) or ``"post_step"`` (the
    monolithic step's stages on a plan of several buckets, the exchange
    after the optimizer: low-precision decentralized).  ``auto`` gates
    the ``"auto"`` resolution apart from an explicit ``overlap=True``: auto
    never changes numerics.  ``reason`` names the class and the cause when
    the mode is refused."""

    supported: bool
    mode: str = "gradient"
    auto: bool = True
    reason: str = ""


class AlgorithmImpl:
    """A reified algorithm bound to a process group."""

    #: registry-style short name carried in the exchange labels
    #: (:func:`bagua_tpu_torch.observability.annotations.bucket_scope`) and
    #: the flight records; subclasses set it to their registered name
    algo_name = ""

    #: algorithms that implement :meth:`overlap_exchange` set this True
    supports_overlap = False

    #: what the overlap mode exchanges per bucket (see :class:`OverlapCapability`)
    overlap_mode = "gradient"

    #: False for algorithms whose :meth:`step_variant` changes across steps:
    #: ``overlap`` must not anchor their exchange differently from step to step
    stable_step_variant = True

    #: set by the engine to whether overlap is on before every
    #: :meth:`tensors_to_buckets` (``init`` and ``rebucket``): algorithms
    #: that bucket by mode (the decentralized pair: one bucket for the whole
    #: model monolithically, the default plan under overlap) read it
    overlap_hint = False

    def __init__(self, process_group: BaguaProcessGroup, hierarchical: bool = False):
        self.process_group = process_group
        self.hierarchical = hierarchical

    #: the engine skips the optimizer update on a step where
    #: :meth:`is_update_step` is False (gradient accumulation)
    skips_optimizer_update = False

    #: a lock the engine holds around the whole step when not None, shared
    #: with a background thread of the algorithm (async model average)
    host_dispatch_lock = None

    def annotate(self, bucket_idx, phase: str):
        """The ``record_function`` labeling one bucket's exchange in a
        profiler trace (``bagua_ex/algo=<name>/bucket=<i>/phase=<phase>``).
        A host-side marker: wrapping an exchange in it never changes the
        computation.

        Also the flight recorder's capture point: every exchange path wraps
        its bucket collective in ``annotate``, so one notification here
        records the step's whole collective program (a no-op unless the
        engine has a capture active).  The record carries the mesh axes the
        exchange rides (the group's data axes), so flight-recorder consumers
        can tell a dp-ring collective from a model-axis one on named
        meshes."""
        name = self.algo_name or type(self).__name__
        notify_collective(name, bucket_idx, phase, axes=list(self.process_group.data_axes))
        return bucket_scope(name, bucket_idx, phase)

    def tensors_to_buckets(self, tree, bucket_size_bytes: Optional[int] = None, filter_fn=None) -> BucketPlan:
        """Default: dtype-grouped greedy buckets, aligned to the exchange
        size so every rank's scatter chunk is equal-sized.  ``filter_fn(name)``
        excludes leaves from communication (the engine's ``dp_filter``)."""
        if bucket_size_bytes is None:
            bucket_size_bytes = get_default_bucket_size()
        return BucketPlan.from_tree(
            tree, bucket_size_bytes, align_elems=self.process_group.exchange_size, filter_fn=filter_fn
        )

    def bind_plan(self, plan: BucketPlan) -> None:
        """Called by the engine whenever the bucket plan changes (init and
        every rebucket), before :meth:`init_state`, so state laid out per
        bucket sees the plan."""
        self._bound_plan = plan

    def init_state(self, params) -> Any:
        """Algorithm-private state (peer weights, compression stats...),
        rank-stacked like the parameters."""
        return ()

    # -- step stages ----------------------------------------------------------

    def on_step_start(self, params, state, ctx: StepContext):
        return params, state

    def transform_gradients(self, grads, params, state, ctx: StepContext):
        """Runs between the backward pass and the optimizer step; gradients
        in, gradients out.  Centralized algorithms communicate here."""
        return grads, params, state

    def on_step_end(self, params, state, ctx: StepContext):
        return params, state

    # -- overlap execution mode -----------------------------------------------

    def overlap_capability(self) -> OverlapCapability:
        """The report ``overlap="auto"`` and ``overlap=True`` resolve
        against, with a reason that names the class and the cause."""
        name = type(self).__name__
        if not self.supports_overlap:
            return OverlapCapability(
                False,
                reason=f"{name} does not implement overlap_exchange (no per-bucket "
                "backward hook); pass overlap=False or 'auto'",
            )
        if not self.stable_step_variant:
            return OverlapCapability(
                False,
                reason=f"{name} switches its step variant across steps (step_variant); "
                "per-bucket backward hooks would anchor its exchange inconsistently "
                "— pass overlap=False or 'auto'",
            )
        if getattr(self, "holds_bucketized_state", False):
            return OverlapCapability(
                False,
                reason=f"{name} keeps per-bucket state; its exchange cannot be split "
                "into independent backward-time bucket collectives — pass "
                "overlap=False or 'auto'",
            )
        return OverlapCapability(True, mode=self.overlap_mode)

    def overlap_exchange(self, bucket_idx: int, grads, ctx: StepContext, params_leaves=None):
        """Exchange ONE bucket from inside the backward pass: ``grads`` are
        the bucket's stacked gradient leaves in slot order, complete at this
        point.  ``"gradient"`` mode: return them exchanged, same shapes and
        dtypes (a ``sharded_update`` algorithm returns ``[shard]``, the
        bucket's shards alone).  ``"weight"`` mode: ``params_leaves`` are
        the bucket's stacked parameter leaves; return the exchanged
        parameters, which replace them.  A weight exchange reads no
        gradient: on the card it waits only for the step's start, not for
        the backward.  With overlap on, the engine calls
        this per bucket and :meth:`finalize_overlap` in place of
        :meth:`transform_gradients`."""
        raise NotImplementedError(self.overlap_capability().reason)

    def finalize_overlap(self, grads, params, state, ctx: StepContext):
        """After the backward pass of an overlap step: receives the
        exchanged gradients, may finish whole-tree work; the identity by
        default.  Same contract as :meth:`transform_gradients`."""
        return grads, params, state

    # -- control ----------------------------------------------------------------

    def need_reset(self, step: int) -> bool:
        """Does the step need rebuilding at this step (a warm-up switch)?"""
        return False

    def step_variant(self, step: int) -> str:
        """Which variant of the step runs at this step."""
        return "default"

    def is_update_step(self, step: int) -> bool:
        """Does the optimizer update at this step?  Read only where
        :attr:`skips_optimizer_update` is set."""
        return True

    # -- host hooks (around the step, outside its stages) --------------------

    def host_pre_dispatch(self, state):
        """Before the step, outside :attr:`host_dispatch_lock`: may return
        another train state (async model average folds its delta here)."""
        return state

    def host_post_dispatch(self, state, step: int) -> None:
        """After the step, inside :attr:`host_dispatch_lock`, with the new
        state and the step count it has reached."""

    def host_shutdown(self) -> None:
        """Stop any background machinery for good (end of training)."""

    def abort(self) -> None:
        """Pause background behaviour."""

    def resume(self) -> None:
        """Undo :meth:`abort`."""


class Algorithm:
    """User-facing declarative algorithm config."""

    def reify(self, process_group: BaguaProcessGroup) -> AlgorithmImpl:
        raise NotImplementedError

    @classmethod
    def init(cls, name: str, **kwargs) -> "Algorithm":
        return GlobalAlgorithmRegistry.get(name)(**kwargs)


class _Registry:
    """The reference's ``GlobalAlgorithmRegistry``."""

    def __init__(self):
        self._algorithms: Dict[str, Tuple[Callable[..., Algorithm], str]] = {}

    def register(self, name: str, factory: Callable[..., Algorithm], description: str = ""):
        if name in self._algorithms:
            raise ValueError(f"algorithm {name!r} already registered")
        self._algorithms[name] = (factory, description)

    def get(self, name: str) -> Callable[..., Algorithm]:
        if name not in self._algorithms:
            raise KeyError(
                f"unknown algorithm {name!r}; registered: {sorted(self._algorithms)}"
            )
        return self._algorithms[name][0]

    def keys(self) -> List[str]:
        return sorted(self._algorithms)


GlobalAlgorithmRegistry = _Registry()
