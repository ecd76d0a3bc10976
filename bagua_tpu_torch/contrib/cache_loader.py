"""CacheLoader: memoize expensive sample loads through a KV store (a copy
of ``bagua_tpu/contrib/cache_loader.py``).

Analog of the reference's ``contrib/cache_loader.py:17-140``: ``get(key,
load_fn)`` consults the store first and computes+caches on miss, with write
batching so many small samples become one ``mset`` round trip.
"""

from typing import Callable, Dict, Optional

from bagua_tpu_torch.contrib.store import ClusterStore, InMemoryStore, Store


class CacheLoader:
    def __init__(
        self,
        backend: str = "memory",
        dataset_name: str = "",
        writer_buffer_size: int = 20,
        store: Optional[Store] = None,
        **kwargs,
    ):
        """``backend`` ∈ {"memory", "file", "shm", "rendezvous"} or pass an
        explicit ``store``.  ``writer_buffer_size`` batches that many pending
        writes before flushing (reference ``cache_loader.py:75-140``).

        ``backend="rendezvous"`` is the cross-host path (the analog of the
        reference's redis-backed cluster cache): pass
        ``endpoints=["host1:29400", "host2:29400", ...]`` (one rendezvous
        blob server per node, same order on every worker) and optionally
        ``bootstrap=True`` to start this host's server if absent."""
        self.dataset_name = dataset_name
        if store is not None:
            self.store = store
        elif backend == "memory":
            self.store = InMemoryStore()
        elif backend == "file":
            from bagua_tpu_torch.contrib.store import FileStore

            self.store = FileStore(kwargs.get("path"))
        elif backend == "shm":
            from bagua_tpu_torch.contrib.shm_store import ShmStore

            self.store = ShmStore(**kwargs)
        elif backend == "rendezvous":
            from bagua_tpu_torch.contrib.rendezvous_store import make_rendezvous_cluster_store

            self.store = make_rendezvous_cluster_store(**kwargs)
        else:
            raise ValueError(f"unknown cache backend {backend!r}")
        self.writer_buffer_size = writer_buffer_size
        self._pending: Dict[str, object] = {}
        self._hits = 0
        self._misses = 0
        self._cache_full = False

    def _key(self, key: str) -> str:
        return f"{self.dataset_name}_{key}"

    def get(self, key: str, load_fn: Callable[[str], object]):
        k = self._key(key)
        if k in self._pending:
            self._hits += 1
            return self._pending[k]
        value = self.store.get(k)
        if value is not None:
            self._hits += 1
            return value
        self._misses += 1
        value = load_fn(key)
        if not self._cache_full:
            self._pending[k] = value
            if len(self._pending) >= self.writer_buffer_size:
                self.flush()
        return value

    def flush(self) -> None:
        if self._pending:
            try:
                self.store.mset(self._pending)
            except MemoryError:
                # Bounded backend (e.g. shm segment) is full: degrade to a
                # read-only cache instead of crashing the training loop (the
                # reference's redis backend evicts via allkeys-lru; a fixed
                # segment cannot, so we stop writing).
                import logging

                logging.getLogger(__name__).warning(
                    "cache store full; caching disabled for new keys"
                )
                self._cache_full = True
            self._pending.clear()

    def num_keys(self) -> int:
        self.flush()
        return self.store.num_keys()

    @property
    def hit_rate(self) -> float:
        total = self._hits + self._misses
        return self._hits / total if total else 0.0
