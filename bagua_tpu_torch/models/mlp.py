"""Minimal MLP used by algorithm-correctness tests (the port of
``bagua_tpu/models/mlp.py``): plain dict params, plain functions."""

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F


def init_mlp(
    generator: torch.Generator, sizes: Sequence[int], device=None
) -> Dict[str, Dict[str, torch.Tensor]]:
    """He-initialized MLP: ``sizes = [in, h1, ..., out]``."""
    params = {}
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = torch.randn((fan_in, fan_out), generator=generator, device=device)
        params[f"layer{i}"] = {
            "w": w * math.sqrt(2.0 / fan_in),
            "b": torch.zeros((fan_out,), device=device),
        }
    return params


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    n_layers = len(params)
    for i in range(n_layers):
        layer = params[f"layer{i}"]
        x = x @ layer["w"] + layer["b"]
        if i < n_layers - 1:
            x = F.relu(x)
    return x


def mse_loss(params, batch) -> torch.Tensor:
    x, y = batch
    return torch.mean((mlp_apply(params, x) - y) ** 2)
