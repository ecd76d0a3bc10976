"""Bucketing: fuse tree leaves into flat, dtype-homogeneous tensors.

The port of ``bagua_tpu/bucket.py``.  For the same declarations the plan is
identical to the JAX package's: same names, offsets, padding and dtype, so
ByteGrad quantizes the very same chunks.  Leaves may carry leading rank
dims: a slot of shape ``s`` takes a leaf of shape ``(*lead, *s)`` and the
bucket's flat tensor is ``(*lead, numel)``, so one call fuses every rank's
gradients at once.
"""

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import torch

from bagua_tpu_torch.defs import TensorDeclaration, dtype_itemsize
from bagua_tpu_torch.utils import (
    align_size,
    from_bagua_datatype,
    to_bagua_datatype,
    tree_flatten_with_names,
    tree_map,
    tree_unflatten,
)


def tree_leaf_names(tree) -> List[str]:
    """Deterministic path names for every leaf, as ``jax.tree_util.keystr``."""
    return [name for name, _ in tree_flatten_with_names(tree)]


@dataclasses.dataclass(frozen=True)
class TensorSlot:
    """One tensor's position inside a fused bucket."""

    name: str
    shape: Tuple[int, ...]
    dtype: str  # wire dtype name
    offset: int  # element offset inside the bucket

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """A fused bucket: an ordered set of slots plus padding to ``numel``."""

    slots: Tuple[TensorSlot, ...]
    numel: int  # total elements including padding
    dtype: str

    @property
    def nbytes(self) -> int:
        return self.numel * dtype_itemsize(self.dtype)

    def declarations(self) -> List[TensorDeclaration]:
        return [TensorDeclaration(name=s.name, num_elements=s.numel, dtype=s.dtype) for s in self.slots]


class BucketPlan:
    """A full tensor→bucket assignment for one tree structure."""

    def __init__(self, specs: Sequence[BucketSpec], tree):
        self.specs = list(specs)
        self._structure = tree_map(lambda leaf: None, tree)  # the tree's shape, no tensors

    @classmethod
    def from_tree(cls, tree, bucket_size_bytes: int, align_elems: int = 1) -> "BucketPlan":
        """Greedy dtype-grouped split by byte size."""
        named = tree_flatten_with_names(tree)
        decls = [
            TensorDeclaration(
                name=n, num_elements=leaf.numel(), dtype=to_bagua_datatype(leaf.dtype)
            )
            for n, leaf in named
        ]
        shapes = {n: tuple(leaf.shape) for n, leaf in named}
        return cls(split_declarations(decls, shapes, bucket_size_bytes, align_elems), tree)

    @classmethod
    def from_declarations(
        cls, buckets: Sequence[Sequence[TensorDeclaration]], tree, align_elems: int = 1
    ) -> "BucketPlan":
        """A plan from a given bucket assignment (an autotuner's, or one
        carried in a plan payload): slots in the given order, each bucket
        padded to ``align_elems``."""
        shapes = {n: tuple(leaf.shape) for n, leaf in tree_flatten_with_names(tree)}
        specs = []
        for bi, bucket in enumerate(buckets):
            if not bucket:
                raise ValueError(f"bucket {bi} in supplied assignment is empty")
            dtypes = {td.dtype for td in bucket}
            if len(dtypes) != 1:
                raise ValueError(
                    f"bucket {bi} mixes dtypes {sorted(dtypes)}; buckets must be dtype-homogeneous"
                )
            slots, offset = [], 0
            for td in bucket:
                slots.append(TensorSlot(name=td.name, shape=shapes[td.name], dtype=td.dtype, offset=offset))
                offset += td.num_elements
            specs.append(BucketSpec(tuple(slots), align_size(offset, align_elems), bucket[0].dtype))
        return cls(specs, tree)

    def group_leaves(self, tree) -> List[Dict[str, torch.Tensor]]:
        """The tree's leaves grouped per bucket, ``{slot name: leaf}`` in slot
        order, without building the flat tensors."""
        by_name = dict(tree_flatten_with_names(tree))
        return [{s.name: by_name[s.name] for s in spec.slots} for spec in self.specs]

    def ungroup_leaves(self, groups: Sequence[Dict[str, torch.Tensor]]):
        """Rebuild the tree from :meth:`group_leaves` groups."""
        leaves: Dict[str, torch.Tensor] = {}
        for group in groups:
            leaves.update(group)
        return tree_unflatten(
            self._structure, [leaves[name] for name in tree_leaf_names(self._structure)]
        )

    def backward_order(self) -> List[int]:
        """Bucket indices in expected gradient-readiness order: by each
        bucket's latest leaf in tree order, descending, as the JAX package
        orders them.  Buckets fill in tree order, so the last bucket's leaves
        are the first the backward pass completes; tree order sorts names
        (``Conv_10`` before ``Conv_2``), so for deep models this is an
        approximation of the order the backward really takes."""
        pos = {name: i for i, name in enumerate(tree_leaf_names(self._structure))}
        return sorted(
            range(len(self.specs)),
            key=lambda bi: -max(pos.get(s.name, -1) for s in self.specs[bi].slots),
        )

    def declarations(self) -> List[List[TensorDeclaration]]:
        return [spec.declarations() for spec in self.specs]

    def bucketize(self, tree) -> List[torch.Tensor]:
        """Fuse the tree's leaves into one flat tensor per bucket."""
        by_name = dict(tree_flatten_with_names(tree))
        return [
            flatten_bucket_leaves([by_name[s.name] for s in spec.slots], spec)
            for spec in self.specs
        ]

    def debucketize(self, flats: Sequence[torch.Tensor]):
        """Rebuild the tree from fused tensors (views into them)."""
        return self.ungroup_leaves([
            dict(zip((s.name for s in spec.slots), split_bucket_flat(flat, spec)))
            for spec, flat in zip(self.specs, flats)
        ])

    @property
    def num_buckets(self) -> int:
        return len(self.specs)

    def __repr__(self) -> str:
        return f"BucketPlan(buckets={[(len(s.slots), s.numel, s.dtype) for s in self.specs]})"


def flatten_bucket_leaves(leaves: Sequence[torch.Tensor], spec: BucketSpec) -> torch.Tensor:
    """Fuse ONE bucket's leaves (slot order) into its padded flat tensor."""
    first, slot = leaves[0], spec.slots[0]
    lead = tuple(first.shape[: first.dim() - len(slot.shape)])
    parts = [leaf.reshape(*lead, -1) for leaf in leaves]
    used = sum(p.shape[-1] for p in parts)
    if used < spec.numel:
        parts.append(
            torch.zeros(
                (*lead, spec.numel - used), dtype=from_bagua_datatype(spec.dtype),
                device=first.device,
            )
        )
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]


def split_bucket_flat(flat: torch.Tensor, spec: BucketSpec) -> List[torch.Tensor]:
    """Re-slice one bucket's flat tensor into its leaves (slot order); the
    inverse of :func:`flatten_bucket_leaves` (padding dropped)."""
    lead = tuple(flat.shape[:-1])
    return [
        flat[..., s.offset : s.offset + s.numel].reshape(*lead, *s.shape)
        for s in spec.slots
    ]


def split_declarations(
    decls: Sequence[TensorDeclaration],
    shapes: Dict[str, Tuple[int, ...]],
    bucket_size_bytes: int,
    align_elems: int = 1,
) -> List[BucketSpec]:
    """Greedy in-order fill, grouped by dtype, cut at ``bucket_size_bytes``."""
    by_dtype: Dict[str, List[TensorDeclaration]] = {}
    for td in decls:
        by_dtype.setdefault(td.dtype, []).append(td)

    specs: List[BucketSpec] = []
    for dtype, group in by_dtype.items():
        item = dtype_itemsize(dtype)
        current: List[TensorSlot] = []
        offset = 0
        for td in group:
            if current and (offset + td.num_elements) * item > bucket_size_bytes:
                specs.append(BucketSpec(tuple(current), align_size(offset, align_elems), dtype))
                current, offset = [], 0
            current.append(
                TensorSlot(name=td.name, shape=shapes[td.name], dtype=dtype, offset=offset)
            )
            offset += td.num_elements
        if current:
            specs.append(BucketSpec(tuple(current), align_size(offset, align_elems), dtype))
    return specs
