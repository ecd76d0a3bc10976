#!/usr/bin/env python3
"""ImageNet: the twin of the JAX package's ``examples/imagenet/main.py``:
ResNet-50 or VGG16 (bf16 compute) with any algorithm, SGD 0.005 momentum
0.9, fed through the contrib data tier.

Two data paths, as in the JAX example:

* ``--data-dir DIR``: real ImageFolder data (``DIR/<class>/<img>.jpeg``),
  its bytes read by the native IO prefetcher
  (:class:`~bagua_tpu_torch.contrib.io_prefetcher.IOPrefetcher`, C++ reader
  threads), decoded with PIL (imported where a batch is decoded),
  random-cropped, flipped and normalized (``FolderImageNet``);
* by default, synthetic data: ``SyntheticImageNet`` (512 samples, 100
  classes) is wrapped in a
``CachedDataset`` (memory), and the ``LoadBalancingDistributedSampler``'s
order (class id as the complexity) picks each step's global batch; ResNet's
``batch_stats`` ride in the train state outside the exchange
(``dp_filter=lambda n: "batch_stats" not in n``).

    python3 -m bagua_tpu_torch.examples.imagenet --arch resnet50 --algorithm decentralized
    python3 -m bagua_tpu_torch.examples.imagenet --device cpu --ranks 4 --image-size 32 --steps 3
    python3 -m bagua_tpu_torch.examples.imagenet --data-dir /data/imagenet/train

The group defaults to one rank per visible card; ``--ranks N`` places N
ranks on ``--device``.
"""

import argparse
import io
import os
import time

import numpy as np
import torch

from bagua_tpu_torch.algorithms import Algorithm
from bagua_tpu_torch.communication import init_process_group
from bagua_tpu_torch.contrib import CachedDataset, IOPrefetcher, LoadBalancingDistributedSampler
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


class FolderImageNet:
    """ImageFolder-layout dataset (reference loader:
    ``examples/imagenet/main.py`` torchvision ``ImageFolder``): class
    subdirectories of image files.  ``read_batches`` streams decoded,
    augmented batches with file IO overlapped by the native prefetcher."""

    MEAN = np.array([0.485, 0.456, 0.406], np.float32)
    STD = np.array([0.229, 0.224, 0.225], np.float32)

    def __init__(self, root, image_size=64, seed=0):
        self.root = root
        self.image_size = image_size
        self.classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        if not self.classes:
            raise FileNotFoundError(f"no class subdirectories under {root}")
        exts = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".ppm")
        self.samples = []
        for ci, cname in enumerate(self.classes):
            cdir = os.path.join(root, cname)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(exts):  # skip READMEs/checksums
                    self.samples.append((os.path.join(cdir, fname), ci))
        if not self.samples:
            raise FileNotFoundError(f"no image files under {root}")
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.samples)

    def _decode(self, raw, train=True):
        from PIL import Image

        img = Image.open(io.BytesIO(raw)).convert("RGB")
        s = self.image_size
        # resize shorter side to 1.15*s, then random (train) / center crop
        w, h = img.size
        scale = int(s * 1.15) / min(w, h)
        img = img.resize((max(s, round(w * scale)), max(s, round(h * scale))))
        w, h = img.size
        if train:
            x0 = self.rng.randint(0, w - s + 1)
            y0 = self.rng.randint(0, h - s + 1)
        else:
            x0, y0 = (w - s) // 2, (h - s) // 2
        img = img.crop((x0, y0, x0 + s, y0 + s))
        x = np.asarray(img, np.float32) / 255.0
        if train and self.rng.rand() < 0.5:
            x = x[:, ::-1]
        return (x - self.MEAN) / self.STD

    def read_batches(self, batch_size, steps, prefetch_threads=4):
        """Yield ``(x, y)`` batches; file reads ride the C++ IO prefetcher
        so decode/augment overlaps disk latency."""
        order = self.rng.permutation(len(self.samples))
        needed = [self.samples[order[k % len(order)]] for k in range(batch_size * steps)]
        pf = IOPrefetcher(n_threads=prefetch_threads)
        try:
            it = pf.read_ordered([p for p, _ in needed])
            k = 0
            for _ in range(steps):
                xs, ys = [], []
                for _ in range(batch_size):
                    path, raw = next(it)
                    if raw is None:
                        raise IOError(f"prefetcher failed to read {path}")
                    xs.append(self._decode(raw))
                    ys.append(needed[k][1])
                    k += 1
                yield np.stack(xs), np.array(ys, np.int32)
        finally:
            pf.close()


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


def synthetic_batches(image_size: int, batch_size: int, steps: int):
    """The synthetic path's ``(x, y, hit_rate)`` a step: ``SyntheticImageNet``
    through a memory ``CachedDataset``, in the load-balancing sampler's
    order; ``hit_rate()`` reads the cache's."""
    dataset = CachedDataset(SyntheticImageNet(image_size=image_size), backend="memory")
    # Sampling over the CACHED dataset warms the cache during the
    # complexity pass, so the training loop is served entirely from cache.
    sampler = LoadBalancingDistributedSampler(
        dataset, complexity_fn=lambda s: int(s[1]),  # class id as fake complexity
        num_replicas=1, rank=0,
    )
    order = list(iter(sampler))
    for step in range(steps):
        samples = [dataset[order[(step * batch_size + j) % len(order)]] for j in range(batch_size)]
        yield (np.stack([s[0] for s in samples]), np.array([s[1] for s in samples], np.int32),
               lambda: dataset.cache_loader.hit_rate)


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
    if args.ranks is None and args.device == "cuda":
        group = init_process_group(intra_size=args.intra_size)
    else:
        device = resolve_device(None if args.device == "cuda" else "cpu")
        group = init_process_group([device] * (args.ranks or 1), intra_size=args.intra_size)
    device = group.device
    folder = FolderImageNet(args.data_dir, args.image_size) if args.data_dir else None
    classes = len(folder.classes) if folder else CLASSES
    params, loss_fn, dp_filter = build(args.arch, args.image_size, classes, device)
    ddp = DistributedDataParallel(
        loss_fn, lambda ps: torch.optim.SGD(ps, lr=0.005, momentum=0.9), Algorithm.init(args.algorithm),
        process_group=group, dp_filter=dp_filter,
    )
    seconds = []
    try:
        state = ddp.init(params)
        del params
        bs = args.batch_size * group.size
        if folder is not None:
            print(f"{len(folder)} images, {classes} classes from {args.data_dir}", flush=True)
            batches = ((x, y, None) for x, y in folder.read_batches(bs, args.steps))
        else:
            batches = synthetic_batches(args.image_size, bs, args.steps)
        for step, (xs, ys, hit_rate) in enumerate(batches):
            x, y = torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)
            t0 = time.perf_counter()
            state, losses = ddp.train_step(state, (x, y))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            seconds.append(time.perf_counter() - t0)
            if step % 10 == 0:
                rate = "" if hit_rate is None else f" (cache hit rate {hit_rate():.2f})"
                print(f"step {step}: loss {float(losses.mean()):.4f}{rate}", flush=True)
    finally:
        ddp.shutdown()
    print(f"final loss {float(losses.mean()):.6f}", flush=True)
    return float(losses.mean()), seconds


if __name__ == "__main__":
    main()
