"""Layers the port's models share, in flax's parameter names: ``nn.Embed``,
``nn.LayerNorm`` (``dtype=None``) and the module-to-tree helper.  Each
applies a rank-stacked parameter tree (every leaf ``(R, ...)``) to
rank-stacked inputs."""

import torch
import torch.nn as nn
import torch.nn.functional as F

from bagua_tpu_torch.parallel.tensor_parallel import _per_rank


class Embed(nn.Module):
    """flax ``nn.Embed``: ``embedding (num, features)``, initialized N(0,
    1/features) (flax's ``variance_scaling(1, fan_in, normal)`` of an
    embedding table)."""

    def __init__(self, num_embeddings: int, features: int, device=None, generator=None):
        super().__init__()
        table = torch.empty((num_embeddings, features), device=device)
        self.embedding = nn.Parameter(nn.init.normal_(table, 0.0, features ** -0.5, generator=generator))

    def forward(self, params, ids):
        """Each rank's ids ``(R, ...)`` looked up in its own table."""
        table = params["embedding"]
        R, n = table.shape[:2]
        offsets = torch.arange(R, device=ids.device).reshape(R, *([1] * (ids.dim() - 1))) * n
        return F.embedding(ids.long() + offsets, table.reshape(R * n, table.shape[-1]))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` as BERT and GPT use it (``dtype=None``, f32
    scale and bias), operation for operation: statistics in f32 from ``E[x]`` and
    ``E[x^2]`` (the fast variance, clipped at zero), ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias``, returned in the promotion of the
    input's type with f32, so a bf16 input comes back f32."""

    def __init__(self, features: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, params, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * _per_rank(params["scale"], x.dim())
        return (xf - mean) * mul + _per_rank(params["bias"], x.dim())


def module_params(model: nn.Module):
    """The model's parameters as flax's nested dict (no copies)."""
    tree = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p.detach()
    return tree
