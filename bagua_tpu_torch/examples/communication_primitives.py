#!/usr/bin/env python3
"""Every eager collective once: the twin of the JAX package's
``examples/communication_primitives/main.py`` (the reference's 2-node CI
smoke test), single-controller only.

    python3 -m bagua_tpu_torch.examples.communication_primitives --device cpu --ranks 8
    python3 -m bagua_tpu_torch.examples.communication_primitives --ranks 4

Each collective takes and returns the whole ``(size, ...)`` stack: rank r
sends row r of an ``(size, 8)`` arange, and the lines print what the JAX
example prints.  The group defaults to one rank per visible card;
``--ranks N`` places N ranks on ``--device``.
"""

import argparse

import numpy as np
import torch

import bagua_tpu_torch as bagua
from bagua_tpu_torch import ReduceOp
from bagua_tpu_torch.utils import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--ranks", type=int, default=None,
                   help="place this many ranks on --device (default: one rank per visible card)")
    args = p.parse_args(argv)

    if args.ranks is None and args.device == "cuda":
        group = bagua.init_process_group()
    else:
        device = resolve_device(None if args.device == "cuda" else "cpu")
        group = bagua.init_process_group([device] * (args.ranks or 1))
    n = group.size
    x = torch.arange(n * 8, dtype=torch.float32, device=group.device).reshape(n, 8)

    def show(t):
        return np.asarray(t.cpu())

    print("group:", group, "local ranks:", bagua.local_ranks(group))
    print("allreduce SUM :", show(bagua.allreduce(x, op=ReduceOp.SUM))[0][:4])
    print("allreduce AVG :", show(bagua.allreduce(x, op=ReduceOp.AVG))[0][:4])
    print("allgather     :", show(bagua.allgather(x)).shape)
    print("reducescatter :", show(bagua.reducescatter(x)).shape)
    print("broadcast     :", show(bagua.broadcast(x, src=0))[-1][:4])
    print("alltoall      :", show(bagua.alltoall(x)).shape)
    print("reduce(dst=0) :", show(bagua.reduce(x, dst=0))[0][:4])
    print("scatter(src=0):", show(bagua.scatter(x, src=0)).shape)
    print("gather(dst=0) :", show(bagua.gather(x, dst=0)).shape)
    bagua.barrier(comm=group)
    print("barrier OK")


if __name__ == "__main__":
    main()
