"""ZeRO-fused bucketed exchange: reduce-scatter, sharded optimizer update,
all-gather deferred into the next step (the port of ``bagua_tpu/sharded``).

* :mod:`~bagua_tpu_torch.sharded.layout`: shard geometry and host-side
  resharding;
* :mod:`~bagua_tpu_torch.sharded.updater`: the shard-only optimizer phase;
* :mod:`~bagua_tpu_torch.sharded.algorithm`: the registered ``zero``
  algorithm (reduce-scatter leg, deferred all-gather leg; ByteGrad and
  quantized-ring compositions).

The JAX package's deprecated optax shim (``fuse_optimizer``,
``FusedState``) is not ported.
"""

from bagua_tpu_torch.sharded.algorithm import ZeroAlgorithm, ZeroAlgorithmImpl
from bagua_tpu_torch.sharded.layout import (
    BucketShard,
    DtypeGroup,
    ShardLayout,
    ShardSlot,
    assemble_full_flats,
    reshard_bucket_rows,
    reshard_group_flat,
)
from bagua_tpu_torch.sharded.updater import ShardedOptimizerUpdater, ShardedOptState

__all__ = [
    "ZeroAlgorithm",
    "ZeroAlgorithmImpl",
    "ShardLayout",
    "ShardSlot",
    "BucketShard",
    "DtypeGroup",
    "ShardedOptState",
    "ShardedOptimizerUpdater",
    "assemble_full_flats",
    "reshard_bucket_rows",
    "reshard_group_flat",
]
