"""Parameters from the JAX package to the port.

The port keeps the JAX package's parameter layout (HWIO conv kernels,
``(in, out)`` Dense kernels, flax's names), so conversion is a copy of each
leaf into a tensor on the chosen device."""

import numpy as np
import torch

from bagua_tpu_torch.utils import tree_leaves, tree_map, tree_unflatten


def params_from_jax(tree, device=None):
    """A tree of numpy (or JAX) arrays as the same tree of torch tensors."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def stacked_params_from_jax(trees, device=None):
    """Per-rank trees of numpy (or JAX) arrays, one per rank in rank order,
    as one rank-stacked tree of torch tensors: every leaf ``(R, ...)``, the
    port's layout for parameters that differ by rank (what the JAX package
    builds with ``jax.tree.map(jnp.stack, *per_rank)``)."""
    leaves = [tree_leaves(t) for t in trees]
    stacked = [torch.from_numpy(np.stack([np.asarray(x) for x in per])).to(device)
               for per in zip(*leaves)]
    return tree_unflatten(trees[0], stacked)
