#!/usr/bin/env python3
"""MNIST: the twin of the JAX package's ``examples/mnist/main.py``.

A small ConvNet trained with any registered algorithm and Adam (QAdam
brings its own optimizer).  With ``--data-dir`` naming a directory that
holds the official IDX files (``train-images-idx3-ubyte[.gz]`` and
``train-labels-idx1-ubyte[.gz]``) it trains on real MNIST, else on a
synthetic MNIST-shaped task; nothing is downloaded.

    python3 -m bagua_tpu_torch.examples.mnist --algorithm gradient_allreduce --epochs 2
    python3 -m bagua_tpu_torch.examples.mnist --device cpu --ranks 4 --algorithm decentralized

The group defaults to one rank per visible card; ``--ranks N`` places N
ranks on ``--device`` (``cuda`` or ``cpu``).  ``Net`` keeps flax's
parameter names and layout (HWIO kernels, flatten in NHWC order), so the
JAX example's parameters drop in (:mod:`bagua_tpu_torch.convert`).
"""

import argparse
import gzip
import os
import struct

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from bagua_tpu_torch.algorithms import build_algorithm
from bagua_tpu_torch.communication import init_process_group
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.models.mlp import cross_entropy
from bagua_tpu_torch.models.vgg import Conv, Dense, module_params
from bagua_tpu_torch.utils import resolve_device


class Net(nn.Module):
    """Two 3x3 SAME convolutions with bias, each followed by a 2x2 max
    pool and then a ReLU; Dense 128 (ReLU) and Dense 10.  f32, NHWC input
    ``(B, 28, 28, 1)``."""

    def __init__(self, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.Conv_0 = Conv(1, 32, torch.float32, device, generator)
        self.Conv_1 = Conv(32, 64, torch.float32, device, generator)
        self.Dense_0 = Dense(7 * 7 * 64, 128, torch.float32, device, generator)
        self.Dense_1 = Dense(128, 10, torch.float32, device, generator)

    def forward(self, x):  # x: NHWC
        x = x.permute(0, 3, 1, 2)
        x = F.relu(F.max_pool2d(self.Conv_0(x), 2, 2))
        x = F.relu(F.max_pool2d(self.Conv_1(x), 2, 2))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order, as flax
        return self.Dense_1(F.relu(self.Dense_0(x)))


def net_loss_fn(model: Net):
    """``loss_fn(params, batch)``: mean cross-entropy of ``model`` run with
    the given flax-style parameter tree."""

    def loss_fn(params, batch):
        x, y = batch
        flat = {f"{m}.{leaf}": t for m, leaves in params.items() for leaf, t in leaves.items()}
        return cross_entropy(functional_call(model, flat, (x,)), y)

    return loss_fn


def _read_idx(path):
    """The IDX format: a big-endian magic (2 zero bytes, a type byte, the
    number of dims), each dim's size, then the raw u8 data."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zero, dtype, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0 or dtype != 0x08:
            raise ValueError(f"{path}: not a u8 IDX file")
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(shape)


def real_mnist(data_dir):
    """The official train split from IDX files (plain or .gz)."""
    def find(stem):
        for suffix in ("", ".gz"):
            p = os.path.join(data_dir, stem + suffix)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"{stem}[.gz] not found under {data_dir}")

    xs = _read_idx(find("train-images-idx3-ubyte")).astype(np.float32)
    xs = (xs / 255.0 - 0.1307) / 0.3081  # torchvision normalization
    ys = _read_idx(find("train-labels-idx1-ubyte")).astype(np.int32)
    return xs[..., None], ys


def synthetic_mnist(n=4096, seed=0):
    """Separable synthetic digits: class-dependent blob patterns."""
    rng = np.random.RandomState(seed)
    ys = rng.randint(0, 10, size=n)
    protos = rng.rand(10, 28, 28, 1).astype(np.float32)
    xs = protos[ys] + 0.3 * rng.randn(n, 28, 28, 1).astype(np.float32)
    return xs.astype(np.float32), ys.astype(np.int32)


def main(argv=None):
    """Train and print as the JAX example does; returns ``(final loss,
    train accuracy)``: the last step's mean loss over the ranks and rank
    0's accuracy on the first 1024 samples."""
    p = argparse.ArgumentParser()
    p.add_argument("--algorithm", default="gradient_allreduce")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=256, help="global, over every rank")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--data-dir", default=None,
                   help="directory with the official MNIST IDX files; synthetic data when omitted")
    p.add_argument("--steps", type=int, default=None, help="stop after this many steps")
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
    device = group.device
    model = Net(device=device, generator=torch.Generator(device=device).manual_seed(0))
    algo = build_algorithm(args.algorithm, lr=args.lr, qadam_warmup_steps=20)
    opt = None if args.algorithm == "qadam" else (lambda ps: torch.optim.Adam(ps, lr=args.lr))
    ddp = DistributedDataParallel(net_loss_fn(model), opt, algo, process_group=group)
    try:
        state = ddp.init(module_params(model))

        xs, ys = real_mnist(args.data_dir) if args.data_dir else synthetic_mnist()
        print(f"{len(xs)} samples ({'real' if args.data_dir else 'synthetic'})", flush=True)
        n_batches = len(xs) // args.batch_size
        if n_batches == 0:
            raise SystemExit(f"dataset ({len(xs)} samples) smaller than --batch-size "
                             f"{args.batch_size}; lower the batch size")
        losses = None
        done = lambda: args.steps is not None and state.step >= args.steps  # noqa: E731
        for epoch in range(args.epochs):
            perm = np.random.RandomState(epoch).permutation(len(xs))
            for b in range(n_batches):
                if done():
                    break
                idx = perm[b * args.batch_size:(b + 1) * args.batch_size]
                state, losses = ddp.train_step(state, (torch.from_numpy(xs[idx]), torch.from_numpy(ys[idx])))
            print(f"epoch {epoch}: loss {float(losses.mean()):.4f}", flush=True)
            if done():
                break
    finally:
        ddp.shutdown()  # no averager thread outlives the run

    state = ddp.finalize_pending_updates(state)
    params = ddp.params_unstacked(state)
    flat = {f"{m}.{leaf}": t for m, leaves in params.items() for leaf, t in leaves.items()}
    with torch.no_grad():
        logits = functional_call(model, flat, (torch.from_numpy(xs[:1024]).to(device),))
    acc = float((logits.argmax(-1).cpu() == torch.from_numpy(ys[:1024]).long()).float().mean())
    print(f"final train-accuracy: {acc:.3f}", flush=True)
    return float(losses.mean()), acc


if __name__ == "__main__":
    main()
