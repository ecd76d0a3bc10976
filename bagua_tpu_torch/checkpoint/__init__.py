"""Checkpoint and resume (the port of ``bagua_tpu/checkpoint/``)."""

from bagua_tpu_torch.checkpoint.checkpointing import (  # noqa: F401
    COMPLETE_FILENAME,
    TRACKER_FILENAME,
    get_latest_iteration,
    load_checkpoint,
    remap_world_size,
    save_checkpoint,
)
