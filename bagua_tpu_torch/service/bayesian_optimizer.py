"""Gaussian-process Bayesian optimizer over a small discrete space.

Replaces the reference's scikit-optimize dependency
(``service/bayesian_optimizer.py:34-57``: skopt.Optimizer over
``bucket_size_2p ∈ [10, 31]`` × ``is_hierarchical_reduce ∈ {0,1}``).  The
space is tiny (≤ a few dozen points), so the acquisition (expected
improvement) is maximized exhaustively over the grid; the GP itself is a
plain numpy RBF-kernel regression.
"""

import dataclasses
import itertools
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class IntParam:
    name: str
    low: int
    high: int  # inclusive

    def grid(self) -> List[int]:
        return list(range(self.low, self.high + 1))


@dataclasses.dataclass(frozen=True)
class BoolParam:
    name: str

    def grid(self) -> List[int]:
        return [0, 1]


class BayesianOptimizer:
    """ask/tell optimizer maximizing score over the parameter grid."""

    def __init__(self, params: Sequence, n_initial_points: int = 5, seed: int = 0):
        self.params = list(params)
        self.rng = np.random.RandomState(seed)
        self.n_initial_points = n_initial_points
        self._grid = np.array(
            list(itertools.product(*[p.grid() for p in self.params])), dtype=np.float64
        )
        self._scales = self._grid.max(axis=0) - self._grid.min(axis=0)
        self._scales[self._scales == 0] = 1.0
        self.xs: List[np.ndarray] = []
        self.ys: List[float] = []
        # Initial sampling walks the seeded draw sequence *deduplicated*
        # (first-appearance order of with-replacement draws, then whatever
        # the draws missed): deterministic under ``seed`` and free of
        # duplicate proposals — each re-proposed point wastes a recompile on
        # the client, which re-jits for a plan it already measured.
        self._initial_order = self._dedup_draw_order()
        self._initial_idx = 0
        # Warm-start queue: externally ranked proposals (the trace-driven
        # planner's top-k) served before the cold permutation walk.
        self._pending: List[np.ndarray] = []

    def _dedup_draw_order(self) -> np.ndarray:
        n = len(self._grid)
        draws = self.rng.randint(n, size=4 * n)  # coupon-collector headroom
        seen = set()
        order = []
        for i in draws:
            if i not in seen:
                seen.add(int(i))
                order.append(int(i))
        order.extend(i for i in range(n) if i not in seen)
        return np.array(order)

    # -- API ------------------------------------------------------------

    def warm_start(self, param_dicts: Sequence[Dict[str, int]]) -> None:
        """Queue proposals for ``ask`` to serve first, in order — already-told
        points are skipped at ask time, so telling between asks stays safe."""
        for d in param_dicts:
            self._pending.append(
                np.array([float(d.get(p.name, 0)) for p in self.params])
            )

    def _explored(self):
        return {tuple(x) for x in self.xs}

    def ask(self) -> Dict[str, int]:
        explored = self._explored()
        x = None
        while self._pending:
            cand = self._pending.pop(0)
            if tuple(cand) not in explored:
                x = cand
                break
        if x is None and len(self.xs) < self.n_initial_points:
            while self._initial_idx < len(self._initial_order):
                cand = self._grid[self._initial_order[self._initial_idx]]
                self._initial_idx += 1
                if tuple(cand) not in explored:
                    x = cand
                    break
        if x is None:
            # EI needs at least one observation; before any tell, fall back
            # to the head of the deterministic permutation.
            x = self._ask_ei() if self.xs else self._grid[self._initial_order[0]]
        return {p.name: int(v) for p, v in zip(self.params, x)}

    def tell(self, param_dict: Dict[str, int], score: float) -> None:
        x = np.array([float(param_dict[p.name]) for p in self.params])
        self.xs.append(x)
        self.ys.append(float(score))

    def best(self) -> Tuple[Dict[str, int], float]:
        if not self.ys:
            return self.ask(), -math.inf
        i = int(np.argmax(self.ys))
        return (
            {p.name: int(v) for p, v in zip(self.params, self.xs[i])},
            self.ys[i],
        )

    # -- GP internals -----------------------------------------------------

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        # RBF with lengthscale 0.25 in unit-normalized parameter space.
        d = (a[:, None, :] - b[None, :, :]) / self._scales
        return np.exp(-0.5 * np.sum(d * d, axis=-1) / 0.25 ** 2)

    def _ask_ei(self) -> np.ndarray:
        X = np.stack(self.xs)
        y = np.array(self.ys)
        y_mean, y_std = y.mean(), y.std() + 1e-9
        yn = (y - y_mean) / y_std
        K = self._kernel(X, X) + 1e-4 * np.eye(len(X))
        Ks = self._kernel(self._grid, X)
        try:
            L = np.linalg.cholesky(K)
            alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
            v = np.linalg.solve(L, Ks.T)
        except np.linalg.LinAlgError:
            return self._grid[self.rng.randint(len(self._grid))]
        mu = Ks @ alpha
        var = np.clip(1.0 - np.sum(v * v, axis=0), 1e-9, None)
        sigma = np.sqrt(var)
        best = yn.max()
        z = (mu - best) / sigma
        ei = sigma * (z * _norm_cdf(z) + _norm_pdf(z))
        # Never re-propose an explored point unless everything is explored.
        explored = {tuple(x) for x in self.xs}
        order = np.argsort(-ei)
        for i in order:
            if tuple(self._grid[i]) not in explored:
                return self._grid[i]
        return self._grid[order[0]]


def _norm_pdf(z):
    return np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)


def _norm_cdf(z):
    from scipy.special import ndtr

    return ndtr(z)
