"""VGG16, the reference's headline benchmark model (the port of
``bagua_tpu/models/vgg.py``).

Parameters keep the JAX package's layout and flax's names: conv kernels
HWIO, Dense kernels ``(in, out)``, modules ``Conv_<i>`` and ``Dense_<i>``.
The forward permutes for ``F.conv2d`` (NCHW view of the NHWC input, OIHW
view of the kernel) and flattens in NHWC order before ``Dense_0``, so a
flax parameter tree drops in unchanged (:mod:`bagua_tpu_torch.convert`).
Compute runs in ``compute_dtype`` by explicit casts, as flax does; the
logits come back in float32.
"""

import math
from typing import Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

# 'M' = 2x2 max pool; ints = conv output channels (VGG16 = config D)
VGG16_CFG: Sequence[Union[str, int]] = (
    64, 64, "M",
    128, 128, "M",
    256, 256, 256, "M",
    512, 512, 512, "M",
    512, 512, 512, "M",
)


def _lecun_normal(shape, fan_in, device, generator) -> torch.Tensor:
    """flax's default kernel init: a normal truncated at two deviations,
    scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape, device=device)
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (3, 3), padding=1)``: kernel HWIO."""

    def __init__(self, in_features, features, dtype, device=None, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(_lecun_normal((3, 3, in_features, features), 9 * in_features, device, generator))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.dtype = dtype

    def forward(self, x):  # x: NCHW
        y = F.conv2d(x, self.kernel.to(self.dtype).permute(3, 2, 0, 1), padding=1)
        return y + self.bias.to(self.dtype)[:, None, None]


class Dense(nn.Module):
    """flax ``nn.Dense``: kernel ``(in, out)``."""

    def __init__(self, in_features, features, dtype, device=None, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(_lecun_normal((in_features, features), in_features, device, generator))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.dtype = dtype

    def forward(self, x):
        return x @ self.kernel.to(self.dtype) + self.bias.to(self.dtype)


class VGG(nn.Module):
    def __init__(
        self, num_classes: int = 1000, cfg=VGG16_CFG, compute_dtype=torch.float32,
        classifier_width: int = 4096, image_size: int = 224, in_channels: int = 3,
        device=None, generator=None,
    ):
        super().__init__()
        self.cfg = tuple(cfg)
        self.compute_dtype = compute_dtype
        channels, side, i = in_channels, image_size, 0
        for v in self.cfg:
            if v == "M":
                side //= 2
                continue
            self.add_module(f"Conv_{i}", Conv(channels, int(v), compute_dtype, device, generator))
            channels, i = int(v), i + 1
        widths = (side * side * channels, classifier_width, classifier_width, num_classes)
        for j in range(3):
            self.add_module(f"Dense_{j}", Dense(widths[j], widths[j + 1], compute_dtype, device, generator))

    def forward(self, x):  # x: NHWC
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        i = 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"Conv_{i}")(x))
                i += 1
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order, as flax
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x).to(torch.float32)


def vgg16(num_classes: int = 1000, compute_dtype=torch.float32, image_size: int = 224,
          device=None, generator=None) -> VGG:
    return VGG(num_classes=num_classes, compute_dtype=compute_dtype, image_size=image_size,
               device=device, generator=generator)


def module_params(model: nn.Module):
    """The model's parameters as a flax-style nested dict (no copies)."""
    tree = {}
    for name, p in model.named_parameters():
        module, leaf = name.rsplit(".", 1)
        tree.setdefault(module, {})[leaf] = p.detach()
    return tree


def init_vgg16(generator: torch.Generator, image_size: int = 224, num_classes: int = 1000,
               compute_dtype=torch.float32, device=None):
    model = vgg16(num_classes, compute_dtype, image_size, device, generator)
    return model, module_params(model)


def vgg_loss_fn(model: VGG):
    """``loss_fn(params, batch)``: mean cross-entropy of ``model`` run with
    the given flax-style parameter tree."""

    def loss_fn(params, batch):
        x, y = batch
        flat = {f"{m}.{leaf}": t for m, leaves in params.items() for leaf, t in leaves.items()}
        logp = F.log_softmax(functional_call(model, flat, (x,)), dim=-1)
        return -torch.mean(torch.gather(logp, 1, y[:, None].long()))

    return loss_fn
