#!/usr/bin/env python3
"""Synthetic throughput benchmark: the twin of the JAX package's
``examples/benchmark/synthetic_benchmark.py`` (the reference's CI workload).

The same flags and the same result line, computed the same way: one
random batch from ``numpy.random.RandomState(0)``, ``--num-warmup`` steps,
then ``--num-iters`` timed steps ending when the card is idle; samples per
second per rank.  SGD(0.01, momentum 0.9), as the reference's optax sgd;
``qadam`` brings its own optimizer (``lr=1e-3``, warmup 10 steps unless
``algorithm_kwargs`` give a ``QAdamOptimizer``).  ``--model vgg16``
(224x224, 1000 classes) or ``bert-large`` (``BertForPreTraining``, 128
positions, masked-LM batches of 128 tokens), bf16 compute unless
``--fp32``.

The group defaults to one rank per visible card.  ``--ranks N
--intra-size M`` place N ranks on ``cuda:0`` instead: on one rank
ByteGrad's compressed allreduce returns the gradient untouched, so a
one-card group measures no compressor.

    python3 -m bagua_tpu_torch.examples.synthetic_benchmark --ranks 4 --intra-size 1 --algorithm bytegrad

``--algorithm`` takes any registered algorithm: ``zero`` runs ZeRO on the
f32 wire, its parameters one step behind their update (as the reference's);
``async`` averages the model on a background thread every 500 ms (the
reference's CI takes ``--algorithm async``), ``stale`` is the
bounded-staleness allreduce (τ 0 by default: bulk synchronous).  The run
ends with ``ddp.shutdown()``, also when it raises, so no averager thread
outlives it.
"""

import argparse
import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from bagua_tpu_torch.algorithms import build_algorithm
from bagua_tpu_torch.communication import init_process_group
from bagua_tpu_torch.ddp import DistributedDataParallel, TrainState
from bagua_tpu_torch.models.bert import BertForPreTraining, bert_large_config, init_bert, mlm_loss_fn
from bagua_tpu_torch.models.vgg import VGG, init_vgg16, vgg_loss_fn

#: the BERT benchmark's sequence and position table (the reference's)
BERT_SEQ = 128


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
    """``(model, params)``: the reference's model at its shape, weights from
    seed 0."""
    gen = torch.Generator(device=device).manual_seed(0)
    if model_name == "vgg16":
        return init_vgg16(gen, 224, 1000, compute_dtype=dtype, device=device)
    if model_name == "bert-large":
        cfg = bert_large_config(compute_dtype=dtype, max_position_embeddings=BERT_SEQ)
        return init_bert(cfg, gen, device)
    raise ValueError(model_name)


def workload(model):
    """``(name, loss_fn, batch_fn)`` of a benchmark model: ``batch_fn(rng,
    n)`` draws ``n`` samples from the numpy ``rng`` as the reference does."""
    if isinstance(model, VGG):
        side, classes = model.image_size, model.num_classes
        return "vgg16", vgg_loss_fn(model), lambda rng, n: (
            torch.from_numpy(rng.rand(n, side, side, 3).astype(np.float32)),
            torch.from_numpy(rng.randint(0, classes, (n,)).astype(np.int32)))
    if isinstance(model, BertForPreTraining):
        vocab, seq = model.cfg.vocab_size, model.cfg.max_position_embeddings
        return "bert-large", mlm_loss_fn(model), lambda rng, n: (
            torch.from_numpy(rng.randint(0, vocab, (n, seq)).astype(np.int32)),
            torch.from_numpy(rng.randint(0, vocab, (n, seq)).astype(np.int32)))
    raise ValueError(f"no benchmark workload for {type(model).__name__}")


def _wait(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(model, params, group, algorithm="gradient_allreduce", algorithm_kwargs=None,
        batch_size: int = 32, num_iters: int = 30, num_warmup: int = 3, overlap="auto",
        on_step: Optional[Callable] = None) -> BenchmarkResult:
    """Train ``model`` (a VGG or a ``BertForPreTraining``, parameters
    ``params``; its loss and batches from :func:`workload`) on one synthetic batch
    of ``batch_size`` per rank over ``group`` with the algorithm registered
    as ``algorithm`` (built with ``algorithm_kwargs``), or an
    :class:`~bagua_tpu_torch.algorithms.base.Algorithm` given as it is;
    prints and returns the reference's result line.  ``on_step(i, state,
    ddp)`` runs before step i (warm-up steps counted, from 0) and returns
    the state the step takes: a directive flip or an algorithm switch.
    The engine is shut down when the run ends, also when it raises."""
    device = group.device
    if isinstance(algorithm, str):
        algo = build_algorithm(algorithm, lr=1e-3, qadam_warmup_steps=10, **(algorithm_kwargs or {}))
    else:
        algo, algorithm = algorithm, type(algorithm).__name__
    optimizer = None if algorithm == "qadam" else lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9)
    name, loss_fn, batch_fn = workload(model)
    ddp = DistributedDataParallel(loss_fn, optimizer, algo, process_group=group, overlap=overlap)
    try:
        state = ddp.init(params)
        batch = tuple(t.to(device) for t in batch_fn(np.random.RandomState(0), batch_size * group.size))

        def step(i, state):
            if on_step is not None:
                state = on_step(i, state, ddp)
            return ddp.train_step(state, batch)

        losses: Any = None
        t0 = time.perf_counter()
        for i in range(num_warmup):
            state, losses = step(i, state)
        _wait(device)
        t1 = time.perf_counter()
        for i in range(num_warmup, num_warmup + num_iters):
            state, losses = step(i, state)
        _wait(device)
        dt = time.perf_counter() - t1
    finally:
        ddp.shutdown()

    sps = batch_size * group.size * num_iters / dt / group.size
    line = (f"model={name} algorithm={algorithm} batch={batch_size}/chip chips={group.size}: "
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
