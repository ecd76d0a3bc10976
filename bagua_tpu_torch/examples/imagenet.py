#!/usr/bin/env python3
"""ImageNet: the twin of the JAX package's ``examples/imagenet/main.py``,
its synthetic path: ResNet-50 or VGG16 (bf16 compute) with any algorithm,
SGD 0.005 momentum 0.9, fed through the contrib data tier.

``SyntheticImageNet`` (512 samples, 100 classes) is wrapped in a
``CachedDataset`` (memory), and the ``LoadBalancingDistributedSampler``'s
order (class id as the complexity) picks each step's global batch; ResNet's
``batch_stats`` ride in the train state outside the exchange
(``dp_filter=lambda n: "batch_stats" not in n``).

    python3 -m bagua_tpu_torch.examples.imagenet --arch resnet50 --algorithm decentralized
    python3 -m bagua_tpu_torch.examples.imagenet --device cpu --ranks 4 --image-size 32 --steps 3

The group defaults to one rank per visible card; ``--ranks N`` places N
ranks on ``--device``.  ``--data-dir`` (real ImageFolder data) raises: the
JAX example reads it through its native IO prefetcher, which is not ported
yet, and the repository holds no image folder to test it on.
"""

import argparse
import time

import numpy as np
import torch

from bagua_tpu_torch.algorithms import Algorithm
from bagua_tpu_torch.communication import init_process_group
from bagua_tpu_torch.contrib import CachedDataset, LoadBalancingDistributedSampler
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.models.resnet import init_resnet50, resnet_loss_fn
from bagua_tpu_torch.models.vgg import init_vgg16, vgg_loss_fn
from bagua_tpu_torch.utils import resolve_device

CLASSES = 100


class SyntheticImageNet:
    """Map-style dataset with an expensive-looking __getitem__ (the cache
    tier's reason to exist)."""

    def __init__(self, n=512, image_size=64, classes=CLASSES, seed=0):
        self.n, self.image_size, self.classes = n, image_size, classes
        self.rng = np.random.RandomState(seed)
        self.labels = self.rng.randint(0, classes, n)
        self.protos = self.rng.rand(classes, image_size, image_size, 3).astype(np.float32)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        y = self.labels[i]
        x = self.protos[y] + 0.1 * np.random.RandomState(i).randn(
            self.image_size, self.image_size, 3
        ).astype(np.float32)
        return x, np.int32(y)


def build(arch: str, image_size: int, classes: int, device, compute_dtype=torch.bfloat16):
    """``(params, loss_fn, dp_filter)`` of the example's model, weights from
    seed 0."""
    gen = torch.Generator(device=device).manual_seed(0)
    if arch == "resnet50":
        model, variables = init_resnet50(gen, image_size, classes, compute_dtype=compute_dtype, device=device)
        return variables, resnet_loss_fn(model), lambda name: "batch_stats" not in name
    if arch == "vgg16":
        model, params = init_vgg16(gen, image_size, classes, compute_dtype=compute_dtype, device=device)
        return params, vgg_loss_fn(model), None
    raise ValueError(f"unknown arch {arch!r}")


def main(argv=None):
    """Train and print as the JAX example does; returns ``(final loss,
    seconds of each step)``, a step's time on the host clock from the batch
    handed over to the device idle."""
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="resnet50", choices=["resnet50", "vgg16"])
    p.add_argument("--algorithm", default="gradient_allreduce")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=32, help="per rank")
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--data-dir", default=None,
                   help="ImageFolder root (class subdirs of images); synthetic data when omitted")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--ranks", type=int, default=None,
                   help="place this many ranks on --device (default: one rank per visible card)")
    p.add_argument("--intra-size", type=int, default=None, help="ranks on the fast inner axis")
    args = p.parse_args(argv)
    if args.data_dir is not None:
        raise NotImplementedError(
            "--data-dir: the real-data path needs the native IO prefetcher (ROADMAP Queue 1 "
            "item 9) and an image folder in the repository to test it on; only the synthetic "
            "path is ported"
        )

    if args.ranks is None and args.device == "cuda":
        group = init_process_group(intra_size=args.intra_size)
    else:
        device = resolve_device(None if args.device == "cuda" else "cpu")
        group = init_process_group([device] * (args.ranks or 1), intra_size=args.intra_size)
    device = group.device
    params, loss_fn, dp_filter = build(args.arch, args.image_size, CLASSES, device)
    ddp = DistributedDataParallel(
        loss_fn, lambda ps: torch.optim.SGD(ps, lr=0.005, momentum=0.9), Algorithm.init(args.algorithm),
        process_group=group, dp_filter=dp_filter,
    )
    seconds = []
    try:
        state = ddp.init(params)
        del params
        bs = args.batch_size * group.size
        dataset = CachedDataset(SyntheticImageNet(image_size=args.image_size), backend="memory")
        # Sampling over the CACHED dataset warms the cache during the
        # complexity pass, so the training loop is served entirely from cache.
        sampler = LoadBalancingDistributedSampler(
            dataset, complexity_fn=lambda s: int(s[1]),  # class id as fake complexity
            num_replicas=1, rank=0,
        )
        order = list(iter(sampler))
        for step in range(args.steps):
            idx = [order[(step * bs + j) % len(order)] for j in range(bs)]
            samples = [dataset[i] for i in idx]
            x = torch.from_numpy(np.stack([s[0] for s in samples])).to(device)
            y = torch.from_numpy(np.array([s[1] for s in samples], np.int32)).to(device)
            t0 = time.perf_counter()
            state, losses = ddp.train_step(state, (x, y))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            seconds.append(time.perf_counter() - t0)
            if step % 10 == 0:
                print(f"step {step}: loss {float(losses.mean()):.4f} "
                      f"(cache hit rate {dataset.cache_loader.hit_rate:.2f})", flush=True)
    finally:
        ddp.shutdown()
    print(f"final loss {float(losses.mean()):.6f}", flush=True)
    return float(losses.mean()), seconds


if __name__ == "__main__":
    main()
