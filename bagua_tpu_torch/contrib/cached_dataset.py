"""CachedDataset: wrap any indexable dataset with a cache
(reference ``contrib/cached_dataset.py:7-62``; a copy of
``bagua_tpu/contrib/cached_dataset.py``)."""

from typing import Optional

from bagua_tpu_torch.contrib.cache_loader import CacheLoader
from bagua_tpu_torch.contrib.store import Store


class CachedDataset:
    """Wraps a map-style dataset (supports ``__len__``/``__getitem__``) so
    each sample is materialized once and then served from the cache —
    worthwhile when ``__getitem__`` does expensive decode/preprocess work."""

    def __init__(
        self,
        dataset,
        backend: str = "memory",
        dataset_name: str = "",
        writer_buffer_size: int = 20,
        store: Optional[Store] = None,
        **kwargs,
    ):
        self.dataset = dataset
        self.cache_loader = CacheLoader(
            backend=backend,
            dataset_name=dataset_name,
            writer_buffer_size=writer_buffer_size,
            store=store,
            **kwargs,
        )

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index: int):
        return self.cache_loader.get(str(index), lambda key: self.dataset[int(key)])
