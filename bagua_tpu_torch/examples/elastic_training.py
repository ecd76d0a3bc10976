#!/usr/bin/env python3
"""Elastic training: the twin of the JAX package's
``examples/elastic_training/main.py``.  An MLP [32, 64, 8] trained with
``gradient_allreduce`` and Adam 1e-3 through the ``Trainer``, which
checkpoints every 50 steps and resumes from the latest checkpoint when it
(re)starts.  Run it under the elastic launcher, which restarts a failed
worker:

    PYTHONPATH=. python3 -m bagua_tpu_torch.distributed.run --nproc_per_node 1 --max_restarts 3 \\
        bagua_tpu_torch/examples/elastic_training.py --ckpt-dir ckpt
    python3 -m bagua_tpu_torch.examples.elastic_training --device cpu --ranks 4 --ckpt-dir ckpt

The group defaults to one rank per visible card (``init_from_env``);
``--ranks N`` places N ranks on ``--device`` (``cuda`` or ``cpu``).  Each
(re)start draws its batches from ``RandomState(0)`` afresh, as the JAX
example does.
"""

import argparse
from typing import Callable, List, Optional

import numpy as np
import torch

from bagua_tpu_torch.algorithms import build_algorithm
from bagua_tpu_torch.distributed import init_from_env
from bagua_tpu_torch.models.mlp import init_mlp, mse_loss
from bagua_tpu_torch.trainer import Trainer
from bagua_tpu_torch.utils import resolve_device

SIZES = [32, 64, 8]


def run(group, steps: int, ckpt_dir: str, params=None, on_step: Optional[Callable] = None):
    """Train to ``steps`` from the latest checkpoint in ``ckpt_dir`` (or
    from ``params``, by default the seeded MLP).  Returns ``(start, state,
    losses)``: the step it started at, the final state and each step's
    mean loss over the ranks.  ``on_step(trainer, state)`` runs after every
    step."""
    device = group.device
    if params is None:
        params = init_mlp(torch.Generator(device=device).manual_seed(0), SIZES, device=device)
    losses: List[float] = []
    with Trainer(mse_loss, lambda ps: torch.optim.Adam(ps, lr=1e-3), build_algorithm("gradient_allreduce"),
                 group, ckpt_dir=ckpt_dir, ckpt_interval=50) as trainer:
        state = trainer.init_state(params)
        start = state.step
        print(f"starting at step {start}", flush=True)
        rng = np.random.RandomState(0)
        n = group.size
        for _ in range(steps - start):
            batch = (torch.from_numpy(rng.randn(16 * n, SIZES[0]).astype(np.float32)),
                     torch.from_numpy(rng.randn(16 * n, SIZES[-1]).astype(np.float32)))
            state = trainer.fit(state, [batch], log_every=50)
            losses.append(float(trainer.losses.mean()))
            if on_step is not None:
                on_step(trainer, state)
        print(f"done at step {state.step}", flush=True)
    return start, state, losses


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt-dir", default="bagua_elastic_ckpt")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--ranks", type=int, default=None,
                   help="place this many ranks on --device (default: one rank per visible card)")
    args = p.parse_args(argv)
    if args.ranks is None and args.device == "cuda":
        group = init_from_env()
    else:
        device = resolve_device(None if args.device == "cuda" else "cpu")
        group = init_from_env([device] * (args.ranks or 1))
    return run(group, args.steps, args.ckpt_dir)


if __name__ == "__main__":
    main()
