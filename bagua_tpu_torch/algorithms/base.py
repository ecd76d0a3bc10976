"""Algorithm plugin base: data-parallel relaxations as step stages.

The port of ``bagua_tpu/algorithms/base.py``.  An algorithm is a set of
stages the DDP engine composes around each rank's backward pass and the
optimizer step, all on rank-stacked tensors:

    backward (per rank) → transform_gradients → optimizer step

The stage receives a :class:`StepContext` carrying the process group, the
step counter and the bucket plan.  The JAX package's other stages
(``on_step_start``/``on_step_end``, the overlap hooks) arrive with the
algorithms that need them.
"""

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from bagua_tpu_torch.bucket import BucketPlan
from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.env import get_default_bucket_size


@dataclasses.dataclass
class StepContext:
    """Per-step info handed to every algorithm stage."""

    group: BaguaProcessGroup
    step: int
    plan: Optional[BucketPlan] = None


class AlgorithmImpl:
    """A reified algorithm bound to a process group."""

    algo_name = ""

    def __init__(self, process_group: BaguaProcessGroup, hierarchical: bool = False):
        self.process_group = process_group
        self.hierarchical = hierarchical

    def tensors_to_buckets(self, tree, bucket_size_bytes: Optional[int] = None) -> BucketPlan:
        """Default: dtype-grouped greedy buckets, aligned to the exchange
        size so every rank's scatter chunk is equal-sized."""
        if bucket_size_bytes is None:
            bucket_size_bytes = get_default_bucket_size()
        return BucketPlan.from_tree(
            tree, bucket_size_bytes, align_elems=self.process_group.exchange_size
        )

    def init_state(self, params) -> Any:
        """Algorithm-private state (peer weights, compression stats...)."""
        return ()

    def transform_gradients(self, grads, params, state, ctx: StepContext):
        """Runs between the backward pass and the optimizer step; gradients
        in, gradients out.  Centralized algorithms communicate here."""
        return grads, params, state


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


GlobalAlgorithmRegistry = _Registry()
