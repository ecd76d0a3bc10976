"""The MoE gate (the analog of the reference's MoE MNIST CI run,
``.buildkite/scripts/benchmark_master.sh:109-144``, which trains a
2-expert MoE on MNIST and pins the exact final loss).

The port of the JAX package's ``ci/moe_check.py``.  No dataset is
downloaded, so the workload is the moe example's synthetic classification
task (``bagua_tpu_torch/examples/moe.py``): 10 gaussian prototype classes,
an expert-parallel MoE block with one expert a rank, each rank's experts
initialized on their own and kept out of the data-parallel exchange
(``dp_filter``), ``gradient_allreduce`` with Adam 5e-3 for 400 steps.
Three gates, the reference's pattern:

1. determinism: two runs give **exactly** the same final loss;
2. convergence: the final loss is under a fixed threshold;
3. expert parity: the expert parameters differ across ranks (per-rank
   state), while every other parameter stays bitwise equal.

The threshold is the JAX lane's, set for its 8 ranks (8 experts): at 4
ranks neither package's loss falls under it in 400 steps.

::

    python -m bagua_tpu_torch.tools.moe_check --ranks 8       # 8 ranks on the card
    python -m bagua_tpu_torch.tools.moe_check --device cpu    # 8 CPU ranks
"""

import argparse
import sys

import numpy as np
import torch

from bagua_tpu_torch.tools._lane import add_device_args, lane_group
from bagua_tpu_torch.tools.benchmark_check import deterministic

CONVERGED_LOSS = 0.05  # the synthetic task's analog of the reference's pinned 0.000071
STEPS = 400
LR = 5e-3


def run(group, stacked=None, steps: int = STEPS):
    """Train the MoE task over ``group`` from ``stacked`` (rank-stacked
    initial parameters; default the example's own: rank r's experts from
    seed r).  Returns ``(final loss, stacked parameters)``."""
    from bagua_tpu_torch.algorithms import Algorithm
    from bagua_tpu_torch.ddp import DistributedDataParallel
    from bagua_tpu_torch.examples import moe

    n = group.size
    device = group.device
    if stacked is None:
        stacked = moe.stacked_params(group)
    with deterministic():
        ddp = DistributedDataParallel(
            moe.loss_fn(moe.build_model(group)), lambda ps: torch.optim.Adam(ps, lr=LR),
            Algorithm.init("gradient_allreduce"), process_group=group,
            dp_filter=lambda name: "experts" not in name,
        )
        try:
            state = ddp.init(stacked_params=stacked)
            rng = np.random.RandomState(0)
            protos = rng.rand(moe.CLASSES, moe.IN_FEATURES).astype(np.float32)
            for _ in range(steps):
                y = rng.randint(0, moe.CLASSES, size=64 * n)
                x = protos[y] + 0.2 * rng.randn(64 * n, moe.IN_FEATURES).astype(np.float32)
                state, losses = ddp.train_step(state, (torch.from_numpy(x.astype(np.float32)).to(device),
                                                       torch.from_numpy(y.astype(np.int32)).to(device)))
        finally:
            ddp.shutdown()
    return float(losses.mean()), state.params


def gate(group, stacked=None, steps: int = STEPS, log=None) -> dict:
    """The three gates over two runs; returns the losses and the failures."""
    from bagua_tpu_torch.utils import tree_flatten_with_names

    log = log or sys.stdout
    loss1, params = run(group, stacked, steps)
    loss2, _ = run(group, stacked, steps)
    print(f"moe final loss run1={loss1:.8f} run2={loss2:.8f}", file=log, flush=True)
    failures = []
    if loss1 != loss2:
        failures.append(f"determinism: {loss1} != {loss2}")
    if not loss1 < CONVERGED_LOSS:
        failures.append(f"convergence: {loss1} >= {CONVERGED_LOSS}")
    experts = 0
    for name, leaf in tree_flatten_with_names(params):
        same = [torch.equal(leaf[0], leaf[r]) for r in range(1, leaf.shape[0])]
        if "experts" in name:
            experts += 1
            if all(same):
                failures.append(f"expert leaf {name} identical across ranks")
        elif not all(same):
            failures.append(f"dense leaf {name} diverged across ranks")
    return {"losses": (loss1, loss2), "expert_leaves": experts, "failures": failures}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_args(ap)
    args = ap.parse_args(argv)
    # the JAX lane's default group: every rank on the intra axis
    out = gate(lane_group(args.device, args.ranks, args.intra_size))
    if out["failures"]:
        print("FAILURES:\n  " + "\n  ".join(out["failures"]))
        return 1
    print("moe check passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
