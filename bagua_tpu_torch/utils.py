"""Small shared utilities (the port of ``bagua_tpu/utils.py``): dtype
mapping, alignment, the ``SpeedMeter``, flax's kernel initializer, and the
few pytree helpers the port needs in place of ``jax.tree_util``.

Parameter trees are nested dicts (and lists/tuples) of tensors, as flax's
are.  Leaves are visited in JAX's order, dict keys sorted, so ``Conv_10``
comes before ``Conv_2``; a leaf's name is what ``jax.tree_util.keystr``
writes for its path, e.g. ``['Conv_0']['kernel']``.  The same tree thus
yields the same names, order and bucket plan in both packages.
"""

import math
import time
from collections import deque
from typing import Any, Callable, List, Optional, Tuple

import torch

from bagua_tpu_torch.defs import DType

_TO_BAGUA = {
    torch.float32: DType.F32.value,
    torch.float16: DType.F16.value,
    torch.bfloat16: DType.BF16.value,
    torch.uint8: DType.U8.value,
    torch.int32: DType.I32.value,
    torch.int64: DType.I64.value,
}
_FROM_BAGUA = {v: k for k, v in _TO_BAGUA.items()}


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the current CUDA device; raises where no
    CUDA device is visible (pass ``device="cpu"`` to run on the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def lecun_normal(shape, fan_in: int, dtype=torch.float32, device=None, generator=None) -> torch.Tensor:
    """flax's default kernel init: a normal truncated at two deviations,
    scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)
    return t.to(dtype)


def to_bagua_datatype(dtype: torch.dtype) -> str:
    """Map a torch dtype to the wire datatype name."""
    try:
        return _TO_BAGUA[dtype]
    except KeyError:
        raise ValueError(f"unsupported data type {dtype}") from None


def from_bagua_datatype(name: str) -> torch.dtype:
    return _FROM_BAGUA[name]


def align_size(numel: int, align: int) -> int:
    """Round ``numel`` up to a multiple of ``align``."""
    return int(math.ceil(numel / align) * align)


class SpeedMeter:
    """Units/sec meter over a sliding time window of (timestamp, total) pairs."""

    def __init__(self, window_seconds: float = 300.0):
        self._window = window_seconds
        self._events = deque()  # (timestamp, amount)
        self._start: Optional[float] = None

    def record(self, amount: float) -> None:
        now = time.time()
        if self._start is None:
            self._start = now
        self._events.append((now, amount))
        while self._events and now - self._events[0][0] > self._window:
            self._events.popleft()

    def speed(self, last_seconds: float = 60.0) -> float:
        if not self._events:
            return 0.0
        now = time.time()
        cutoff = now - last_seconds
        amount = sum(a for t, a in self._events if t >= cutoff)
        # If history is shorter than the window, normalize by actual elapsed time.
        span = min(last_seconds, max(now - self._start, 1e-9))
        return amount / span


# ---------------------------------------------------------------------------
# Pytrees of tensors
# ---------------------------------------------------------------------------


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """``(keystr piece, child)`` pairs of an inner node, None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def tree_flatten_with_names(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(name, leaf)`` pairs in JAX's flattening order."""
    children = _children(tree)
    if children is None:
        return [(prefix, tree)]
    out = []
    for piece, child in children:
        out.extend(tree_flatten_with_names(child, prefix + piece))
    return out


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_names(tree)]


def tree_unflatten(template, leaves) -> Any:
    """A tree shaped like ``template`` whose leaves are ``leaves``, taken in
    :func:`tree_flatten_with_names` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)

    return build(template)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """Apply ``fn`` to every leaf, and to the leaves of ``rest`` (trees of
    the same structure) beside it."""
    return tree_unflatten(tree, [fn(*leaves) for leaves in zip(tree_leaves(tree), *map(tree_leaves, rest))])
