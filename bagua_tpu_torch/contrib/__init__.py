"""Contrib tier, the jax-free data path copied from ``bagua_tpu/contrib``:
the stores, the cache loader, the cached dataset and the load-balancing
samplers (reference ``bagua/torch_api/contrib/``).  The fused optimizer,
ZeRO's optax wrapper, SyncBatchNorm and the native stores are not ported
(ROADMAP Queue 1 items 3 and 9)."""

from bagua_tpu_torch.contrib.store import (  # noqa: F401
    Store,
    InMemoryStore,
    FileStore,
    ClusterStore,
)
from bagua_tpu_torch.contrib.cache_loader import CacheLoader  # noqa: F401
from bagua_tpu_torch.contrib.cached_dataset import CachedDataset  # noqa: F401
from bagua_tpu_torch.contrib.load_balancing_data_loader import (  # noqa: F401
    LoadBalancingDistributedSampler,
    LoadBalancingDistributedBatchSampler,
)
