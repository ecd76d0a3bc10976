"""High-level training loop (the port of ``bagua_tpu/trainer.py``, its fit
loop only: no checkpoint, snapshot, autotune, watchdog or telemetry yet)."""

import logging
from typing import Callable, Iterable, Optional

from bagua_tpu_torch.algorithms.base import Algorithm
from bagua_tpu_torch.ddp import DistributedDataParallel, TrainState
from bagua_tpu_torch.utils import tree_leaves

logger = logging.getLogger(__name__)


class Trainer:
    """Minimal fit loop over :class:`~bagua_tpu_torch.ddp.DistributedDataParallel`.

    ``loss_fn``, ``optimizer``, ``algorithm``, ``process_group``,
    ``bucket_size_bytes`` and ``overlap`` are as for the engine (overlap
    ``"auto"`` by default, as the JAX ``Trainer``; ``overlap=False`` pins the
    monolithic step).  After :meth:`fit`, ``self.losses`` holds the last
    step's per-rank losses."""

    def __init__(self, loss_fn: Callable, optimizer: Callable, algorithm: Algorithm, process_group=None,
                 bucket_size_bytes: Optional[int] = None, overlap="auto"):
        self.ddp = DistributedDataParallel(
            loss_fn, optimizer, algorithm, process_group=process_group,
            bucket_size_bytes=bucket_size_bytes, overlap=overlap,
        )
        self.losses = None

    def init_state(self, params) -> TrainState:
        return self.ddp.init(params)

    def fit(self, state: TrainState, batches: Iterable, n_steps: Optional[int] = None,
            log_every: int = 100) -> TrainState:
        """Run the training loop; returns the final state."""
        for i, batch in enumerate(batches):
            if n_steps is not None and i >= n_steps:
                break
            state, self.losses = self.ddp.train_step(state, batch)
            self.ddp.record_speed(tree_leaves(batch)[0].shape[0])
            if log_every and state.step % log_every == 0:
                logger.info(
                    "step %d loss %.5f (%.1f samples/s)", state.step,
                    float(self.losses.mean()), self.ddp.speed_meter.speed(30.0),
                )
        return state
