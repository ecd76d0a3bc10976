"""Contrib tier (reference ``bagua/torch_api/contrib/``): the stores, the
native shared-memory store and IO prefetcher (C++ built at first use by
g++), the rendezvous blob store, the cache loader, the cached dataset, the
load-balancing samplers and synchronized batch norm.  The fused optimizer
and ZeRO's optax wrapper are not ported: the engine takes a
``torch.optim`` factory in their place."""

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
from bagua_tpu_torch.contrib.io_prefetcher import IOPrefetcher  # noqa: F401
from bagua_tpu_torch.contrib.rendezvous_store import (  # noqa: F401
    RendezvousStore,
    make_rendezvous_cluster_store,
)
from bagua_tpu_torch.contrib.shm_store import ShmStore  # noqa: F401
from bagua_tpu_torch.contrib.sync_batchnorm import SyncBatchNorm  # noqa: F401
