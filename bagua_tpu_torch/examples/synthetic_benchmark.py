#!/usr/bin/env python3
"""Synthetic throughput benchmark: the twin of the JAX package's
``examples/benchmark/synthetic_benchmark.py`` (the reference's CI workload).

The same flags and the same result line, computed the same way: one
random batch from ``numpy.random.RandomState(0)``, ``--num-warmup`` steps,
then ``--num-iters`` timed steps ending when the card is idle; samples per
second per rank.  SGD(0.01, momentum 0.9), as the reference's optax sgd;
``qadam`` brings its own optimizer (``lr=1e-3``, warmup 10 steps unless
``algorithm_kwargs`` give a ``QAdamOptimizer``).
Only ``--model vgg16`` runs (224x224, 1000 classes, bf16 compute unless
``--fp32``); ``bert-large`` is not ported.

The group defaults to one rank per visible card.  ``--ranks N
--intra-size M`` place N ranks on ``cuda:0`` instead: on one rank
ByteGrad's compressed allreduce returns the gradient untouched, so a
one-card group measures no compressor.

    python3 -m bagua_tpu_torch.examples.synthetic_benchmark --ranks 4 --intra-size 1 --algorithm bytegrad

``--algorithm`` takes any registered algorithm: ``zero`` runs ZeRO on the
f32 wire, its parameters one step behind their update (as the reference's).
"""

import argparse
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from bagua_tpu_torch.algorithms import build_algorithm
from bagua_tpu_torch.communication import init_process_group
from bagua_tpu_torch.ddp import DistributedDataParallel, TrainState
from bagua_tpu_torch.models.vgg import VGG, init_vgg16, vgg_loss_fn


@dataclasses.dataclass
class BenchmarkResult:
    line: str  # the reference's result line
    samples_per_sec_per_chip: float
    step_seconds: float  # mean over the timed steps
    warmup_seconds: float
    losses: torch.Tensor  # the last step's per-rank losses
    state: TrainState
    ddp: DistributedDataParallel
    batch: Any  # the global batch every step takes


def build(model_name: str, dtype, device):
    """The reference's model at its shape, weights from seed 0."""
    if model_name == "vgg16":
        return init_vgg16(torch.Generator(device=device).manual_seed(0), 224, 1000,
                          compute_dtype=dtype, device=device)
    if model_name == "bert-large":
        raise NotImplementedError("BERT is not ported yet (ROADMAP Queue 1 item 5)")
    raise ValueError(model_name)


def _wait(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(model: VGG, params, group, algorithm: str = "gradient_allreduce", algorithm_kwargs=None,
        batch_size: int = 32, num_iters: int = 30, num_warmup: int = 3, overlap="auto") -> BenchmarkResult:
    """Train ``model`` (a VGG, parameters ``params``) on one synthetic batch
    of ``batch_size`` per rank over ``group`` with the algorithm registered
    as ``algorithm`` (built with ``algorithm_kwargs``); prints and returns
    the reference's result line."""
    device = group.device
    algo = build_algorithm(algorithm, lr=1e-3, qadam_warmup_steps=10, **(algorithm_kwargs or {}))
    optimizer = None if algorithm == "qadam" else lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9)
    ddp = DistributedDataParallel(vgg_loss_fn(model), optimizer, algo, process_group=group, overlap=overlap)
    state = ddp.init(params)
    rng = np.random.RandomState(0)
    n, side = batch_size * group.size, model.image_size
    batch = (torch.from_numpy(rng.rand(n, side, side, 3).astype(np.float32)).to(device),
             torch.from_numpy(rng.randint(0, model.num_classes, (n,)).astype(np.int32)).to(device))

    losses: Any = None
    t0 = time.perf_counter()
    for _ in range(num_warmup):
        state, losses = ddp.train_step(state, batch)
    _wait(device)
    t1 = time.perf_counter()
    for _ in range(num_iters):
        state, losses = ddp.train_step(state, batch)
    _wait(device)
    dt = time.perf_counter() - t1

    sps = batch_size * group.size * num_iters / dt / group.size
    line = (f"model=vgg16 algorithm={algorithm} batch={batch_size}/chip chips={group.size}: "
            f"{sps:.1f} samples/sec/chip, final loss {float(losses.mean()):.6f}")
    print(line, flush=True)
    return BenchmarkResult(line, sps, dt / num_iters, t1 - t0, losses, state, ddp, batch)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="vgg16", choices=["vgg16", "bert-large"])
    p.add_argument("--algorithm", default="gradient_allreduce")
    p.add_argument("--batch-size", type=int, default=32, help="per rank")
    p.add_argument("--num-iters", type=int, default=30)
    p.add_argument("--num-warmup", type=int, default=3)
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--ranks", type=int, default=None,
                   help="place this many ranks on cuda:0 (default: one rank per visible card)")
    p.add_argument("--intra-size", type=int, default=None, help="ranks on the fast inner axis")
    args = p.parse_args(argv)

    devices = [torch.device("cuda", 0)] * args.ranks if args.ranks else None
    group = init_process_group(devices, intra_size=args.intra_size)
    model, params = build(args.model, torch.float32 if args.fp32 else torch.bfloat16, group.device)
    run(model, params, group, args.algorithm, batch_size=args.batch_size, num_iters=args.num_iters,
        num_warmup=args.num_warmup)


if __name__ == "__main__":
    main()
