#!/usr/bin/env python3
"""MoE: the twin of the JAX package's ``examples/moe/main.py``.

A small classifier with an expert-parallel MoE block (``ep_size`` = the
group's size over every rank), experts excluded from the data-parallel
exchange: ``gradient_allreduce`` + Adam 1e-3 with ``dp_filter=lambda n:
"experts" not in n``.  Every rank initializes its own experts (rank r's
weights from seed r) and takes rank 0's other weights; the data is the JAX
example's synthetic prototypes.

    python3 -m bagua_tpu_torch.examples.moe --num-experts 8
    python3 -m bagua_tpu_torch.examples.moe --device cpu --ranks 4 --steps 10

The group defaults to one rank per visible card; ``--ranks N`` places N
ranks on ``--device``.  :func:`build_model`, :func:`stacked_params` and
:func:`loss_fn` are the example's model, initial parameters and loss, for
callers that train it with another algorithm.
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from bagua_tpu_torch.algorithms import Algorithm
from bagua_tpu_torch.communication import ALL_AXES, init_process_group
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.models.llama import module_params
from bagua_tpu_torch.models.vgg import Dense
from bagua_tpu_torch.parallel.moe import MoE
from bagua_tpu_torch.parallel.moe.utils import is_moe_param_path
from bagua_tpu_torch.utils import dotted_leaves, resolve_device, tree_flatten_with_names, tree_leaves, tree_unflatten

IN_FEATURES, WIDTH, HIDDEN, CLASSES = 32, 64, 128, 10
LR = 1e-3


class Model(nn.Module):
    """Dense 64 (ReLU) -> MoE (hidden 128, capacity factor 2) -> Dense 10;
    returns ``(logits, l_aux)``."""

    def __init__(self, group, num_experts: int, k: int = 1, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.Dense_0 = Dense(IN_FEATURES, WIDTH, torch.float32, device, generator)
        self.MoE_0 = MoE(WIDTH, HIDDEN, num_experts, k=k, capacity_factor=2.0, ep_size=group.size,
                         ep_axis=ALL_AXES, group=group, device=device, generator=generator)
        self.Dense_1 = Dense(WIDTH, CLASSES, torch.float32, device, generator)

    def forward(self, x):
        h, l_aux = self.MoE_0(F.relu(self.Dense_0(x)))
        return self.Dense_1(h), l_aux


def build_model(group, num_experts: int = 0, k: int = 1, seed: int = 0) -> Model:
    """The example's model over ``group`` (``num_experts`` 0: one a rank),
    weights drawn from ``seed`` on the group's device."""
    device = group.device
    return Model(group, num_experts or group.size, k, device, torch.Generator(device=device).manual_seed(seed))


def stacked_params(group, num_experts: int = 0, k: int = 1):
    """Rank-stacked initial parameters: rank r's experts from seed r, every
    other leaf rank 0's (the JAX example's per-rank expert init)."""
    trees = [module_params(build_model(group, num_experts, k, seed=r)) for r in range(group.size)]
    per_rank = [tree_leaves(tree) for tree in trees]
    names = [name for name, _ in tree_flatten_with_names(trees[0])]
    return tree_unflatten(trees[0], [
        torch.stack([per_rank[r if is_moe_param_path(name) else 0][i] for r in range(group.size)])
        for i, name in enumerate(names)])


def loss_fn(model: Model):
    """``loss_fn(params, batch)``: cross-entropy + 0.01 x the balance loss."""

    def fn(params, batch):
        x, y = batch
        logits, l_aux = functional_call(model, dotted_leaves(params), (x,))
        logp = F.log_softmax(logits, dim=-1)
        return -torch.mean(torch.gather(logp, 1, y[:, None].long())) + 0.01 * l_aux

    return fn


def main(argv=None):
    """Train and print as the JAX example does; returns ``(final loss,
    stacked parameters)``."""
    p = argparse.ArgumentParser()
    p.add_argument("--num-experts", type=int, default=0, help="0 = one per rank")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--ranks", type=int, default=None,
                   help="place this many ranks on --device (default: one rank per visible card)")
    p.add_argument("--intra-size", type=int, default=None, help="ranks on the fast inner axis")
    args = p.parse_args(argv)

    if args.ranks is None and args.device == "cuda":
        group = init_process_group(intra_size=args.intra_size)
    else:
        device = resolve_device(None if args.device == "cuda" else "cpu")
        group = init_process_group([device] * (args.ranks or 1), intra_size=args.intra_size)
    n = group.size
    ddp = DistributedDataParallel(
        loss_fn(build_model(group, args.num_experts)), lambda ps: torch.optim.Adam(ps, lr=LR),
        Algorithm.init("gradient_allreduce"), process_group=group,
        dp_filter=lambda name: "experts" not in name,
    )
    try:
        state = ddp.init(stacked_params=stacked_params(group, args.num_experts))
        rng = np.random.RandomState(0)
        protos = rng.rand(CLASSES, IN_FEATURES).astype(np.float32)
        for i in range(args.steps):
            y = rng.randint(0, CLASSES, size=64 * n)
            x = protos[y] + 0.2 * rng.randn(64 * n, IN_FEATURES).astype(np.float32)
            state, losses = ddp.train_step(state, (torch.from_numpy(x.astype(np.float32)),
                                                   torch.from_numpy(y.astype(np.int32))))
            if i % 10 == 0:
                print(f"step {i}: loss {float(losses.mean()):.4f}", flush=True)
    finally:
        ddp.shutdown()
    print(f"final loss {float(losses.mean()):.6f}", flush=True)
    return float(losses.mean()), state.params


if __name__ == "__main__":
    main()
