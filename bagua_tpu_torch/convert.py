"""Parameters from the JAX package to the port.

The port keeps the JAX package's parameter layout (HWIO conv kernels,
``(in, out)`` Dense kernels, flax's names), so conversion is a copy of each
leaf into a tensor on the chosen device."""

import numpy as np
import torch

from bagua_tpu_torch.utils import tree_map


def params_from_jax(tree, device=None):
    """A tree of numpy (or JAX) arrays as the same tree of torch tensors."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)
