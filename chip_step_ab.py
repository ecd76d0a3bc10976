#!/usr/bin/env python3
"""Times the full-width VGG16 training step of two versions of the port on
one card, in turns.

    git archive <commit> | tar -x -C _chipcheck/parent
    python3 chip_step_ab.py --parent _chipcheck/parent [--steps 10] [--wires "f32,QAdam"]

Each turn is a process of its own that imports ``bagua_tpu_torch`` from one
tree, in the order parent, this tree, this tree, parent.  A turn trains
VGG16 at ``chip_smoke.py``'s shape (224x224, 1000 classes, bf16 compute,
f32 parameters, batch 32 a rank, weights and data from seed 0) over 4 ranks
of the one card (``intra_size=1``) through ``Trainer.fit`` with SGD
momentum (QAdam: its own optimizer), on each wire of WIRES the tree has (``--wires``: those named alone):
the monolithic step
(``overlap=False`` where the tree's ``Trainer`` takes the knob; a tree
without it has no other step) and, where the tree has it, the overlap
step.  Each path: 2 warm-up steps,
then ``--steps`` steps ending in ``torch.cuda.synchronize()``; its ms/step,
its peak memory (``torch.cuda.max_memory_allocated``) and, where the engine
reports it, its optimizer state per rank, and its algorithm state per rank, and a SHA-256 of the
parameters after the steps (ZeRO's pending shards gathered first).  ``async``'s numbers follow the
wall clock (its averager folds when its thread gets the engine's lock),
so they vary from run to run more than the others'.  Prints each turn's
numbers and a JSON line with the faster of each tree's two turns per path
and the paths whose parameters differ between turns.  Exits non-zero
without a card.
"""

import argparse
import gc
import hashlib
import importlib.util
import inspect
import itertools
import json
import os
import subprocess
import sys
import time

WARMUP = 2
#: wire -> (module, class, arguments); a tree without the module skips it
WIRES = {
    "ByteGrad": ("bagua_tpu_torch.algorithms", "ByteGradAlgorithm", {}),
    "int8 ring": ("bagua_tpu_torch.algorithms", "GradientAllReduceAlgorithm", {"wire_precision": "int8"}),
    "f32": ("bagua_tpu_torch.algorithms", "GradientAllReduceAlgorithm", {}),
    "ZeRO f32": ("bagua_tpu_torch.sharded", "ZeroAlgorithm", {}),
    "ZeRO ByteGrad": ("bagua_tpu_torch.sharded", "ZeroAlgorithm", {"compression": "bytegrad"}),
    "ZeRO int8 ring": ("bagua_tpu_torch.sharded", "ZeroAlgorithm", {"wire_precision": "int8"}),
    # int4 error feedback holds per-bucket state, which the engine keeps out
    # of overlap: monolithic only
    "int4 ring": ("bagua_tpu_torch.algorithms", "GradientAllReduceAlgorithm", {"wire_precision": "int4"}),
    "ZeRO int4 ring": ("bagua_tpu_torch.sharded", "ZeroAlgorithm", {"wire_precision": "int4"}),
    "decentralized shift_one": ("bagua_tpu_torch.algorithms.decentralized", "DecentralizedAlgorithm",
                                {"peer_selection_mode": "shift_one"}),
    "decentralized all": ("bagua_tpu_torch.algorithms.decentralized", "DecentralizedAlgorithm", {}),
    "low-precision decentralized": ("bagua_tpu_torch.algorithms.decentralized",
                                    "LowPrecisionDecentralizedAlgorithm", {}),
    # its bundled optimizer (SGD at lr), compression from step 2 on:
    # chip_smoke.QADAM_FULL (at larger lr a warmup this short runs away)
    "QAdam": ("bagua_tpu_torch.algorithms.q_adam", "QAdamAlgorithm",
              {"lr": 1e-5, "warmup_steps": 2, "eps": 1e-3}),
    # no exchange at all: the step the relaxations are held against
    "none": ("bagua_tpu_torch.algorithms", "NoCommAlgorithm", {}),
    # no rank under the directive: the gate's work is the same either way
    "stale τ=2": ("bagua_tpu_torch.algorithms.stale", "StaleSyncAlgorithm", {"staleness_tau": 2}),
    "gossip all τ=1": ("bagua_tpu_torch.algorithms.decentralized", "DecentralizedAlgorithm",
                       {"hierarchical": False, "staleness_tau": 1}),
    # ByteGrad's exchange and the update on every fourth step
    "GradientAccumulation ByteGrad every=4": ("bagua_tpu_torch.algorithms.grad_accumulation",
                                              "GradientAccumulation", {"every": 4}),
    # wall-clock driven: the averager folds when its thread gets the lock,
    # so its steps differ from run to run
    "async": ("bagua_tpu_torch.algorithms.async_model_average", "AsyncModelAverageAlgorithm",
              {"sync_interval_ms": 50, "warmup_steps": 2}),
}
#: wires whose algorithm has no overlap mode
MONOLITHIC_ONLY = {"none", "GradientAccumulation ByteGrad every=4", "async", "int4 ring", "ZeRO int4 ring"}


def _algorithm(module: str, cls: str, kwargs: dict):
    """``cls(**kwargs)`` from ``module``; QAdam's arguments build its
    ``QAdamOptimizer``."""
    mod = importlib.import_module(module)
    if cls == "QAdamAlgorithm":
        return mod.QAdamAlgorithm(mod.QAdamOptimizer(**kwargs))
    if cls == "GradientAccumulation":
        from bagua_tpu_torch.algorithms import ByteGradAlgorithm

        return mod.GradientAccumulation(ByteGradAlgorithm(), **kwargs)
    return getattr(mod, cls)(**kwargs)


def worker(root: str, steps: int, names) -> dict:
    """One turn: every path of the tree at ``root`` on the wires ``names``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from bagua_tpu_torch import init_process_group
    from bagua_tpu_torch.models.vgg import init_vgg16, vgg_loss_fn
    from bagua_tpu_torch.trainer import Trainer
    from bagua_tpu_torch.utils import tree_leaves

    assert os.path.abspath(sys.modules["bagua_tpu_torch"].__file__).startswith(os.path.abspath(root))
    device = torch.device("cuda", 0)
    group = init_process_group([device] * 4, intra_size=1)
    wires = {}
    for name in names:
        module, cls, kwargs = WIRES[name]
        if importlib.util.find_spec(module) is not None:
            wires[name] = lambda module=module, cls=cls, kwargs=kwargs: _algorithm(module, cls, kwargs)
    modes = {"monolithic": {"overlap": False}, "overlap": {"overlap": True}} \
        if "overlap" in inspect.signature(Trainer).parameters else {"monolithic": {}}
    out = {}
    for (wire, algorithm), (mode, kwargs) in itertools.product(wires.items(), modes.items()):
        if mode == "overlap" and wire in MONOLITHIC_ONLY:
            continue
        gc.collect()
        torch.cuda.empty_cache()
        gen = torch.Generator(device=device).manual_seed(0)
        model, params = init_vgg16(gen, image_size=224, num_classes=1000, compute_dtype=torch.bfloat16,
                                   device=device)
        algo = algorithm()
        optimizer = None if hasattr(algo, "optimizer") else lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9)
        try:
            trainer = Trainer(vgg_loss_fn(model), optimizer, algo, group, **kwargs)
        except NotImplementedError as e:  # a tree that has the module but not this option
            print(f"[ab] {root}: {wire} {mode} skipped: {e}", file=sys.stderr, flush=True)
            continue
        state = trainer.init_state(params)
        del params
        batch = (torch.rand((128, 224, 224, 3), generator=gen, device=device),
                 torch.randint(0, 1000, (128,), generator=gen, device=device))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = trainer.fit(state, itertools.repeat(batch), n_steps=WARMUP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = trainer.fit(state, itertools.repeat(batch), n_steps=steps)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
        if not torch.isfinite(trainer.losses).all():
            raise AssertionError(f"{wire} {mode}: non-finite loss {trainer.losses.tolist()}")
        out[f"{wire} {mode}"] = {"ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        if hasattr(trainer.ddp, "optimizer_state_bytes"):
            out[f"{wire} {mode}"]["optimizer_bytes_per_rank"] = trainer.ddp.optimizer_state_bytes(state)
        final = trainer.ddp.finalize_pending_updates(state) if hasattr(trainer.ddp, "finalize_pending_updates") \
            else state
        digest = hashlib.sha256()
        for leaf in tree_leaves(final.params):
            digest.update(leaf.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
        out[f"{wire} {mode}"]["params_sha256"] = digest.hexdigest()
        del final
        # the algorithm's state: its distinct tensors over the ranks
        algo = {t.data_ptr(): t.numel() * t.element_size() for t in tree_leaves(state.algo_state)
                if torch.is_tensor(t)}
        out[f"{wire} {mode}"]["algorithm_bytes_per_rank"] = sum(algo.values()) // 4
        if hasattr(trainer, "close"):
            trainer.close()
        del state, trainer, model, batch
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an unpacked tree of the commit to compare with")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--wires", default=",".join(WIRES), help="comma-separated names of WIRES (default: all)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    names = args.wires.split(",")
    unknown = [n for n in names if n not in WIRES]
    if unknown:
        ap.error(f"unknown wires {unknown}; WIRES has {list(WIRES)}")
    if args.worker:
        print(json.dumps(worker(args.worker, args.steps, names)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_step_ab: no CUDA device is visible")
    if not args.parent:
        ap.error("--parent is required")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    best, digests = {}, {}
    for tree, root in (("parent", args.parent), ("tree", here), ("tree", here), ("parent", args.parent)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root,
                               "--steps", str(args.steps), "--wires", args.wires],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
            return proc.returncode
        turn = json.loads(proc.stdout.strip().splitlines()[-1])
        for path, row in turn.items():
            opt = f", optimizer state {row['optimizer_bytes_per_rank']} B per rank" \
                if "optimizer_bytes_per_rank" in row else ""
            opt += f", algorithm state {row['algorithm_bytes_per_rank']} B per rank"
            print(f"[ab] {tree} {path}: {row['ms']:.2f} ms/step, peak {row['peak_gib']:.2f} GiB{opt}; "
                  f"parameters {row['params_sha256'][:16]}", flush=True)
            digests.setdefault(path, set()).add(row["params_sha256"])
            prev = best.setdefault(tree, {}).get(path)
            if prev is None or row["ms"] < prev["ms"]:
                best[tree][path] = row
    differ = sorted(path for path, seen in digests.items() if len(seen) > 1)
    print(json.dumps({"steps": args.steps, "parameters_differ_between_turns": differ,
                      "faster_of_two_turns": best}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
