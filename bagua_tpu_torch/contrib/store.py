"""Key-value stores backing the cached-dataset tier (a copy of
``bagua_tpu/contrib/store.py``).

The analog of the reference's ``contrib/utils/store.py`` (``Store`` /
``ClusterStore`` ABCs with xxhash key routing, ``store.py:56-143``) and
``redis_store.py``.  Redis isn't available in this image, so the concrete
backends are:

* :class:`InMemoryStore` — plain dict, single process.
* :class:`FileStore` — directory of pickled blobs, usable across processes on
  one host (and across hosts on shared filesystems).
* :class:`~bagua_tpu_torch.contrib.shm_store.ShmStore` — the C++
  shared-memory store (the native-runtime equivalent of the reference
  bootstrapping local redis servers), provided separately, as is the
  cross-host :mod:`~bagua_tpu_torch.contrib.rendezvous_store`.

``ClusterStore`` shards keys over multiple backends with xxhash, exactly like
the reference routes keys across redis instances.
"""

import os
import pickle
import tempfile
from typing import Dict, List, Optional

try:
    import xxhash

    def _hash(key: bytes) -> int:
        return xxhash.xxh64(key).intdigest()

except ImportError:  # pragma: no cover
    import hashlib

    def _hash(key: bytes) -> int:
        return int.from_bytes(hashlib.md5(key).digest()[:8], "little")


class Store:
    """Abstract KV store (reference ``store.py:56-107``)."""

    def set(self, key: str, value) -> None:
        raise NotImplementedError

    def get(self, key: str):
        raise NotImplementedError

    def num_keys(self) -> int:
        raise NotImplementedError

    def clear(self) -> None:
        raise NotImplementedError

    def mset(self, mapping: Dict[str, object]) -> None:
        for k, v in mapping.items():
            self.set(k, v)

    def mget(self, keys: List[str]) -> List[Optional[object]]:
        return [self.get(k) for k in keys]

    def status(self) -> bool:
        return True

    def shutdown(self) -> None:
        pass


class InMemoryStore(Store):
    def __init__(self):
        self._data: Dict[str, object] = {}

    def set(self, key, value):
        self._data[key] = value

    def get(self, key):
        return self._data.get(key)

    def num_keys(self):
        return len(self._data)

    def clear(self):
        self._data.clear()


class FileStore(Store):
    """Pickled-blob-per-key store under a directory; safe for concurrent
    readers and single-writer-per-key patterns (atomic rename)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or tempfile.mkdtemp(prefix="bagua_store_")
        os.makedirs(self.path, exist_ok=True)

    def _candidates(self, key: str):
        """Filenames for ``key``: the hash slot, then linear-probe suffixes.

        Blobs are named by a 64-bit key hash; distinct keys may collide, so
        both ``set`` and ``get`` probe ``<hash>.blob``, ``<hash>.1.blob``, …
        and match on the stored key (each blob records its full key)."""
        base = f"{_hash(key.encode()):016x}"
        yield os.path.join(self.path, f"{base}.blob")
        for i in range(1, 64):
            yield os.path.join(self.path, f"{base}.{i}.blob")

    def _slot(self, key: str, load_value: bool):
        """Walk the probe chain for ``key``.  Returns ``(path, found, value)``:
        ``path`` is the slot holding the key (or the first free slot), and
        ``value`` is the stored payload when ``found`` and ``load_value``.
        Blobs hold two sequential pickles — key, then value — so key
        comparison never deserializes the payload."""
        for cand in self._candidates(key):
            try:
                with open(cand, "rb") as f:
                    if pickle.load(f) == key:
                        return cand, True, (pickle.load(f) if load_value else None)
            except FileNotFoundError:
                return cand, False, None
        return None, False, None  # chain exhausted: no slot holds (or can hold) key

    def set(self, key, value):
        target, _, _ = self._slot(key, load_value=False)
        if target is None:
            # 64 colliding keys on a 64-bit hash is pathological; overwriting
            # an occupied slot would silently evict an unrelated key's data.
            raise RuntimeError(
                f"FileStore probe chain exhausted for key {key!r}: 64 slots "
                "occupied by colliding keys"
            )
        fd, tmp = tempfile.mkstemp(dir=self.path)
        with os.fdopen(fd, "wb") as f:
            pickle.dump(key, f)
            pickle.dump(value, f)
        os.replace(tmp, target)

    def get(self, key):
        _, found, value = self._slot(key, load_value=True)
        return value if found else None  # exhausted chain with no match = miss

    def num_keys(self):
        return len([f for f in os.listdir(self.path) if f.endswith(".blob")])

    def clear(self):
        for f in os.listdir(self.path):
            if f.endswith(".blob"):
                os.unlink(os.path.join(self.path, f))


class ClusterStore(Store):
    """Shards keys across backend stores by xxhash
    (reference ``store.py:109-143``)."""

    def __init__(self, stores: List[Store]):
        if not stores:
            raise ValueError("ClusterStore needs at least one backend store")
        self.stores = list(stores)

    def _route(self, key: str) -> Store:
        return self.stores[_hash(key.encode()) % len(self.stores)]

    def set(self, key, value):
        self._route(key).set(key, value)

    def get(self, key):
        return self._route(key).get(key)

    def mset(self, mapping):
        by_store: Dict[int, Dict[str, object]] = {}
        for k, v in mapping.items():
            idx = _hash(k.encode()) % len(self.stores)
            by_store.setdefault(idx, {})[k] = v
        for idx, sub in by_store.items():
            self.stores[idx].mset(sub)

    def mget(self, keys):
        return [self.get(k) for k in keys]

    def num_keys(self):
        return sum(s.num_keys() for s in self.stores)

    def clear(self):
        for s in self.stores:
            s.clear()

    def status(self):
        return all(s.status() for s in self.stores)

    def shutdown(self):
        for s in self.stores:
            s.shutdown()
