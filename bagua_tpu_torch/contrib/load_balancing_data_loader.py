"""Load-balancing distributed samplers (a copy of
``bagua_tpu/contrib/load_balancing_data_loader.py``).

Same contract as the reference's ``contrib/load_balancing_data_loader.py``
(rank-sliced sampling where every rank's step-``t`` sample has similar
*complexity* — sequence length, image size — so no rank stalls the gang on a
long sample), built around a different core: instead of dict-of-complexity
bookkeeping and chunk generators, an epoch is materialized as a single
``(steps, ranks)`` **assignment matrix** with vectorized numpy:

1. complexities are jittered (``random_level`` blends in uniform noise — 0 is
   best balance, 1 trades balance for shuffling freedom),
2. ``argsort`` of the jittered complexities is wrap-padded to fill the matrix,
3. each row then holds ``ranks`` samples of adjacent complexity; rows are
   shuffled as units, and rank ``r`` reads column ``r``.

``drop_last`` keeps only full rows of unique samples; otherwise the sort
order wraps to pad.  Determinism: (seed, epoch) fully determine the matrix.
"""

import math
from typing import Callable, Iterator, List, Optional

import numpy as np


class LoadBalancingDistributedSampler:
    """Yields this rank's column of the epoch's assignment matrix."""

    def __init__(
        self,
        dataset,
        complexity_fn: Callable[..., int],
        num_replicas: Optional[int] = None,
        rank: Optional[int] = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        random_level: float = 0.0,
    ):
        if num_replicas is None:
            from bagua_tpu_torch.env import get_world_size

            num_replicas = get_world_size()
        if rank is None:
            from bagua_tpu_torch.env import get_rank

            rank = get_rank()
        if not 0 <= rank < num_replicas:
            raise ValueError(
                f"Invalid rank {rank}, rank should be in the interval [0, {num_replicas - 1}]"
            )
        if not 0.0 <= random_level <= 1.0:
            raise ValueError(
                f"Invalid random level {random_level}, should be in the range [0.0, 1.0]"
            )
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

        n = len(dataset)
        self.complexities = np.asarray(
            [complexity_fn(dataset[i]) for i in range(n)], dtype=np.float64
        )
        # noise amplitude: random_level as a fraction of the complexity range
        spread = float(self.complexities.max() - self.complexities.min()) if n else 0.0
        self.jitter_amplitude = spread * random_level + 1.0

        if drop_last and n % num_replicas != 0:
            self.num_samples = math.ceil((n - num_replicas) / num_replicas)
        else:
            self.num_samples = math.ceil(n / num_replicas)

    def _assignment_matrix(self) -> np.ndarray:
        """The epoch's ``(num_samples, num_replicas)`` sample-index matrix."""
        rng = np.random.RandomState(self.seed + self.epoch)
        if self.shuffle:
            keys = self.complexities + rng.randint(
                0, int(self.jitter_amplitude), size=self.complexities.shape
            )
        else:
            keys = self.complexities
        order = np.argsort(keys, kind="stable")
        rows, cols = self.num_samples, self.num_replicas
        # wrap-pad the sorted order to fill the matrix exactly
        flat = np.resize(order, rows * cols)
        matrix = flat.reshape(rows, cols)
        if self.shuffle:
            matrix = matrix[rng.permutation(rows)]
        return matrix

    def __iter__(self) -> Iterator[int]:
        return iter(self._assignment_matrix()[:, self.rank].tolist())

    def __len__(self) -> int:
        return self.num_samples

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch


class LoadBalancingDistributedBatchSampler:
    """Variable-size mini-batches on top of the load-balancing sampler
    (reference ``load_balancing_data_loader.py:202+``).

    ``batch_fn(indices) -> list[list[int]]`` packs one rank's sample indices
    into batches (e.g. token-budget packing).  Ranks can end up with
    different batch counts; every rank must run the same number of steps, so
    the shorter ranks wrap their batch list (or, with ``drop_last``, all
    ranks truncate to the shortest)."""

    def __init__(self, sampler: LoadBalancingDistributedSampler, batch_fn, drop_last: bool = False):
        if not isinstance(sampler, LoadBalancingDistributedSampler):
            raise ValueError("sampler should be of LoadBalancingDistributedSampler type.")
        if sampler.drop_last:
            raise ValueError("drop_last of sampler should be False")
        self.sampler = sampler
        self.batch_fn = batch_fn
        self.drop_last = drop_last
        self.num_replicas = sampler.num_replicas
        self.rank = sampler.rank
        self.generate_batches()

    def generate_batches(self) -> None:
        matrix = self.sampler._assignment_matrix()
        per_rank: List[List[List[int]]] = [
            self.batch_fn(matrix[:, r].tolist()) for r in range(self.num_replicas)
        ]
        counts = [len(b) for b in per_rank]
        self.total_batch = min(counts) if self.drop_last else max(counts)
        self.padded_batches = [
            (b * math.ceil(self.total_batch / len(b)))[: self.total_batch] if b else []
            for b in per_rank
        ]

    def __iter__(self):
        return iter(self.padded_batches[self.rank])

    def __len__(self):
        return self.total_batch

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)
        self.generate_batches()
