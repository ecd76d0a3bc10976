"""Environment/config accessors (the port of ``bagua_tpu/env.py``)."""

import os


def get_default_bucket_size() -> int:
    """Default communication bucket size in bytes (10 MiB, like the reference)."""
    return int(os.environ.get("BAGUA_DEFAULT_BUCKET_SIZE", 10 * 1024 ** 2))
