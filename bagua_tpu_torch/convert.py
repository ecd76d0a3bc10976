"""Parameters from the JAX package to the port.

The port keeps the JAX package's parameter layout (HWIO conv kernels in
VGG, ``(in, out)`` Dense kernels, flax's names), so conversion is a copy of
each leaf into a tensor on the chosen device.  That holds for the MoE trees
(``gate/Dense_0``, ``experts/VmapDense_{0,1}`` with kernels ``(local
experts, in, out)``), ``nn.SelfAttention`` (``query/key/value`` kernels
``(M, heads, head_dim)``, ``out`` ``(heads, head_dim, M)``), ``nn.LayerNorm``
and ``nn.Embed``.  ResNet alone lays its conv kernels out as OIHW:
:func:`resnet_params_from_jax` transposes them; the ``gpt_pretrain``
twin's trees take rank rows by pipeline coordinate
(:func:`gpt_params_from_jax`)."""

import numpy as np
import torch

from bagua_tpu_torch.utils import tree_leaves, tree_map, tree_unflatten


def _tensor(a) -> torch.Tensor:
    """A numpy (or JAX) array as a CPU tensor; bf16 (``ml_dtypes``, which
    ``torch.from_numpy`` does not take) crosses as its 16-bit pattern."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree, device=None):
    """A tree of numpy (or JAX) arrays as the same tree of torch tensors."""
    return tree_map(lambda a: _tensor(a).to(device), tree)


def stacked_params_from_jax(trees, device=None):
    """Per-rank trees of numpy (or JAX) arrays, one per rank in rank order,
    as one rank-stacked tree of torch tensors: every leaf ``(R, ...)``, the
    port's layout for parameters that differ by rank (what the JAX package
    builds with ``jax.tree.map(jnp.stack, *per_rank)``)."""
    leaves = [tree_leaves(t) for t in trees]
    stacked = [_tensor(np.stack([np.asarray(x) for x in per])).to(device) for per in zip(*leaves)]
    return tree_unflatten(trees[0], stacked)


def resnet_params_from_jax(variables, device=None):
    """flax ResNet variables (``{"params", "batch_stats"}``) as the port's:
    every conv ``kernel`` HWIO -> OIHW, the rest copied."""
    tree = params_from_jax(variables, device)
    return tree_map(lambda t: t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t, tree)


def gpt_params_from_jax(params, stage_rows, device=None):
    """The ``gpt_pretrain`` example's parameters, ``{"embed", "stage",
    "head"}`` with the stages stacked over ``pp`` (``(pp, ...)`` leaves), as
    the port's twin holds them rank-stacked: embed and head copied to every
    rank, and rank r's stage row ``stage_rows[r]`` (its pp coordinate), so
    the stages are replicated over the other live axis."""
    rows = torch.as_tensor(np.asarray(stage_rows), dtype=torch.long)
    n = len(rows)
    out = params_from_jax(params, device)
    out["embed"] = tree_map(lambda t: t[None].repeat(n, *([1] * t.dim())), out["embed"])
    out["head"] = tree_map(lambda t: t[None].repeat(n, *([1] * t.dim())), out["head"])
    out["stage"] = tree_map(lambda t: t[rows.to(t.device)].contiguous(), out["stage"])
    return out
