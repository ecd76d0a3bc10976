"""Environment/config accessors (the port of ``bagua_tpu/env.py``)."""

import os


def get_default_bucket_size() -> int:
    """Default communication bucket size in bytes (10 MiB, like the reference)."""
    return int(os.environ.get("BAGUA_DEFAULT_BUCKET_SIZE", 10 * 1024 ** 2))


def get_world_size() -> int:
    """Processes in the job: ``WORLD_SIZE``, else 1 (one controller drives
    every rank of a group)."""
    return int(os.environ.get("WORLD_SIZE", 1))


def get_rank() -> int:
    """This process's index in the job: ``RANK``, else 0."""
    return int(os.environ.get("RANK", 0))
