"""ResNet family (the port of ``bagua_tpu/models/resnet.py``; ResNet-50 is
BASELINE config 4, trained with decentralized SGD).

The standard bottleneck ResNet as the JAX package builds it with flax:
flax's module names (``Conv_0``, ``bn_init``, ``stage<i>_block<b>`` with
``Conv_0..2``, ``bn1..3``, ``proj``, ``bn_proj``, ``Dense_0``), f32
parameters, compute in ``compute_dtype`` by explicit casts.  Conv kernels
are OIHW here (flax's HWIO transposed by :mod:`bagua_tpu_torch.convert`);
the input is NHWC and runs as an NCHW view of it, so each rank's
activations stay channels-last; the convolution is
:func:`~bagua_tpu_torch.models._rank_ops.rank_conv2d` (one per rank under
the engine's ``vmap``).  Padding is flax's: ``'SAME'`` for the 1x1
convolutions (none, at stride 1 or 2), 1 for the 3x3, 3 for the stem's
7x7; the max pool pads with -inf.

:class:`BatchNorm` is flax's ``nn.BatchNorm`` in training mode
(``use_running_average=False``) as flax computes it: each rank's batch
statistics in f32 (``E[x^2] - E[x]^2``, clipped at zero), eps 1e-5, the
output in the promotion of the input's type with f32 (so a bf16
convolution's output comes back f32 and the next convolution casts it).
The running-statistics update is dropped, as ``resnet_loss_fn`` drops it
in the JAX package: the ``batch_stats`` tree rides in the train state
(``dp_filter=lambda n: "batch_stats" not in n``) and no step changes it.

``sync_bn=True`` builds :class:`~bagua_tpu_torch.contrib.sync_batchnorm.SyncBatchNorm`
for every norm, under the same names: its statistics are averaged over the
group's ranks under the engine's ``vmap`` and taken in the convolution's
type (bf16 under bf16 compute), as the JAX module's are.
"""

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from bagua_tpu_torch.contrib.sync_batchnorm import SyncBatchNorm
from bagua_tpu_torch.models._rank_ops import rank_conv2d
from bagua_tpu_torch.models.llama import module_params
from bagua_tpu_torch.utils import dotted_leaves, lecun_normal, resolve_device

BN_EPS = 1e-5


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides, padding, use_bias=False)``;
    kernel OIHW."""

    def __init__(self, in_features, features, kernel_size, stride, padding, dtype, device, generator):
        super().__init__()
        fan_in = kernel_size * kernel_size * in_features
        self.kernel = nn.Parameter(lecun_normal((features, in_features, kernel_size, kernel_size), fan_in,
                                                device=device, generator=generator))
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x):  # NCHW
        return rank_conv2d(x.to(self.dtype), self.kernel.to(self.dtype), self.padding, self.stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=False)`` on an NCHW view:
    per-rank statistics over (N, H, W) in f32, eps 1e-5."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=(0, 2, 3), keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3), keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + BN_EPS) * self.scale[:, None, None]
        return (xf - mean) * mul + self.bias[:, None, None]


def norm(features: int, sync_bn: bool, device):
    """The block's norm: flax's ``BatchNorm``, or ``SyncBatchNorm`` on the
    NCHW view (its running statistics dropped, as the loss drops them)."""
    if sync_bn:
        return SyncBatchNorm(features, channel_dim=1, track_running_stats=False, device=device)
    return BatchNorm(features, device)


class BottleneckBlock(nn.Module):
    def __init__(self, in_features: int, features: int, strides: int = 1, compute_dtype=torch.float32,
                 device=None, generator=None, sync_bn: bool = False):
        super().__init__()
        conv = dict(dtype=compute_dtype, device=device, generator=generator)
        self.Conv_0 = Conv(in_features, features, 1, 1, 0, **conv)
        self.bn1 = norm(features, sync_bn, device)
        self.Conv_1 = Conv(features, features, 3, strides, 1, **conv)
        self.bn2 = norm(features, sync_bn, device)
        self.Conv_2 = Conv(features, features * 4, 1, 1, 0, **conv)
        self.bn3 = norm(features * 4, sync_bn, device)
        # flax projects where the residual's shape differs from the output's
        if in_features != features * 4 or strides != 1:
            self.proj = Conv(in_features, features * 4, 1, strides, 0, **conv)
            self.bn_proj = norm(features * 4, sync_bn, device)

    def forward(self, x):
        residual = x
        y = F.relu(self.bn1(self.Conv_0(x)))
        y = F.relu(self.bn2(self.Conv_1(y)))
        y = self.bn3(self.Conv_2(y))
        if hasattr(self, "proj"):
            residual = self.bn_proj(self.proj(residual))
        return F.relu(y + residual)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000, compute_dtype=torch.float32,
                 sync_bn: bool = False, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.stage_sizes, self.num_classes, self.compute_dtype = tuple(stage_sizes), num_classes, compute_dtype
        self.sync_bn = sync_bn
        self.Conv_0 = Conv(3, 64, 7, 2, 3, compute_dtype, device, generator)
        self.bn_init = norm(64, sync_bn, device)
        channels = 64
        for i, n_blocks in enumerate(self.stage_sizes):
            for b in range(n_blocks):
                strides = 2 if i > 0 and b == 0 else 1
                self.add_module(f"stage{i}_block{b}", BottleneckBlock(
                    channels, 64 * 2 ** i, strides, compute_dtype, device, generator, sync_bn))
                channels = 64 * 2 ** i * 4
        self.Dense_0 = nn.Module()
        self.Dense_0.kernel = nn.Parameter(lecun_normal((channels, num_classes), channels, device=device,
                                                        generator=generator))
        self.Dense_0.bias = nn.Parameter(torch.zeros(num_classes, device=device))

    def forward(self, x):  # NHWC
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn_init(self.Conv_0(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for i, n_blocks in enumerate(self.stage_sizes):
            for b in range(n_blocks):
                x = getattr(self, f"stage{i}_block{b}")(x)
        x = x.mean(dim=(2, 3)).to(torch.float32)
        # flax's Dense promotes its input to its parameters' type
        dtype = torch.promote_types(x.dtype, self.Dense_0.kernel.dtype)
        return x.to(dtype) @ self.Dense_0.kernel + self.Dense_0.bias


def resnet50(num_classes: int = 1000, compute_dtype=torch.float32, sync_bn: bool = False, device=None,
             generator=None) -> ResNet:
    return ResNet([3, 4, 6, 3], num_classes, compute_dtype, sync_bn, device, generator)


def batch_stats(model: ResNet):
    """The ``batch_stats`` tree flax's ``init`` gives the same model: each
    norm's ``mean`` (zeros) and ``var`` (ones), f32."""
    tree = {}
    for name, module in model.named_modules():
        if isinstance(module, (BatchNorm, SyncBatchNorm)):
            *path, leaf = name.split(".")
            node = tree
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = {"mean": torch.zeros_like(module.scale.detach()),
                          "var": torch.ones_like(module.scale.detach())}
    return tree


def init_resnet(model: ResNet):
    """``{"params": ..., "batch_stats": ...}``, the variables flax's
    ``init`` returns, over ``model``'s own parameters (no copies)."""
    return {"params": module_params(model), "batch_stats": batch_stats(model)}


def init_resnet50(generator=None, image_size: int = 224, num_classes: int = 1000, compute_dtype=torch.float32,
                  sync_bn: bool = False, device=None):
    """``(model, variables)``; ``image_size`` only names the input the JAX
    package initializes on (the weights do not depend on it)."""
    model = resnet50(num_classes, compute_dtype, sync_bn, device, generator)
    return model, init_resnet(model)


def resnet_loss_fn(model: ResNet):
    """Cross-entropy over ``{"params", "batch_stats"}``.  Pass
    ``dp_filter=lambda n: "batch_stats" not in n`` to the engine so the
    (gradient-free) statistics are neither bucketed nor exchanged; the
    training-mode forward reads only the batch's statistics."""

    def loss_fn(params, batch):
        x, y = batch
        logits = functional_call(model, dotted_leaves(params["params"]), (x,))
        logp = F.log_softmax(logits, dim=-1)
        return -torch.mean(torch.gather(logp, 1, y[:, None].long()))

    return loss_fn
