"""A small MoE step and a small ResNet step on the card against the same
steps on the CPU.

These tests need a CUDA device and skip without one; they import neither
JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_moe_cuda.py

Tolerances, with their reason (f32, TF32 off in matmuls and cuDNN): the moe
example's model over 4 ranks (ep 4: the stacked all-to-all under the
engine's ``vmap``; experts outside the exchange), 3 Adam steps: the losses
within rtol 1e-4 and every parameter within 3 lr of the CPU run's (Adam
moves an element by about lr a step whatever its gradient's scale).  The
small ResNet (stage sizes [1, 1, 1, 1], 32x32) is ``chip_smoke.py``'s own
check, :func:`chip_smoke.check_small_resnet_on_card`, whose docstring and
constants give its tolerances: f64 losses and gradients under ``vmap``,
and 2 f32 decentralized engine steps (``dp_filter`` on ``batch_stats``)
against the CPU's engine and the f64 recurrence.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from bagua_tpu_torch.algorithms import GradientAllReduceAlgorithm
from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.examples import moe
from bagua_tpu_torch.utils import tree_leaves, tree_map

RANKS, LR = 4, 1e-3


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _moe_run(device, stacked, batches):
    group = BaguaProcessGroup([device] * RANKS, intra_size=2)
    ddp = DistributedDataParallel(moe.loss_fn(moe.build_model(group)), lambda ps: torch.optim.Adam(ps, lr=LR),
                                  GradientAllReduceAlgorithm(), group, dp_filter=lambda n: "experts" not in n)
    state = ddp.init(stacked_params=tree_map(lambda t: t.to(device), stacked))
    for x, y in batches:
        state, losses = ddp.train_step(state, (x.to(device), y.to(device)))
    return losses.cpu(), [t.cpu() for t in tree_leaves(state.params)]


@pytest.mark.cuda
def test_moe_example_steps_on_card_match_cpu(cuda_device):
    stacked = moe.stacked_params(BaguaProcessGroup([torch.device("cpu")] * RANKS, intra_size=2))
    rng = np.random.RandomState(0)
    protos = rng.rand(10, 32).astype(np.float32)
    batches = []
    for _ in range(3):
        y = rng.randint(0, 10, size=64 * RANKS)
        x = protos[y] + 0.2 * rng.randn(64 * RANKS, 32).astype(np.float32)
        batches.append((torch.from_numpy(x.astype(np.float32)), torch.from_numpy(y.astype(np.int32))))
    card_losses, card = _moe_run(cuda_device, stacked, batches)
    cpu_losses, cpu = _moe_run(torch.device("cpu"), stacked, batches)
    np.testing.assert_allclose(card_losses.numpy(), cpu_losses.numpy(), rtol=1e-4)
    for a, b in zip(card, cpu):
        assert (a - b).abs().max() <= 3 * LR


@pytest.mark.cuda
def test_resnet_grads_on_card_match_cpu(cuda_device):
    readings = chip_smoke.check_small_resnet_on_card(cuda_device)
    assert readings["vs_cpu"] <= chip_smoke.SMALL_RESNET_SHARE
