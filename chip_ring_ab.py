#!/usr/bin/env python3
"""Runs the causal ring-attention paths of two versions of the port on one
card, in turns: their results bit for bit, their peak memory and their
step time.

    git archive <commit> | tar -x -C _chipcheck/parent
    python3 chip_ring_ab.py --parent _chipcheck/parent [--paths "Llama sp 4,[gpt-pp] 1F1B"] [--steps 5] \
        [--profile 1]

Each turn is a process of its own that imports ``bagua_tpu_torch`` from one
tree, in the order parent, this tree, this tree, parent.  A turn trains
each path of PATHS through ``examples/gang.py``'s ``run_case`` on the
single-controller group of the card (the pretraining twin's own
hand-scheduled step, weights and batches from seed 0, the widths of
``chip_smoke.py``'s phase of that name): one warm-up step, which also holds
each kernel's first launch against its plain version, then ``--steps``
timed steps.  Per path it reports a SHA-256 of each rank's parameters
after the steps, the losses, ms/step, the hand-written kernels' launches
and the peak memory from the warm-up step on
(``torch.cuda.max_memory_allocated``, reset where ``run_case`` starts its
steps); with ``--profile N``, N more steps traced (``gang.trace_steps``:
the wall time, the host's and the card's self time, the ops that took the
most host time), which the parameters then include on both trees.  Exits
non-zero unless every turn of this tree gives the parent's parameters and
losses bit for bit.  Prints each turn's numbers and a JSON line: per tree
and path, the faster turn's ms/step, the larger turn's peak and the
launches.  Exits non-zero without a card.
"""

import argparse
import json
import os
import subprocess
import sys

#: path -> (gang.py model, mesh, case); the widths and meshes of
#: chip_smoke.py's phases: the Llama slice (zigzag sp 4), [mesh-llama]
#: (dp 2 x tp 2 x sp 2, 2 sequences), [dist] path (a) (tp 2 x sp 2, Row
#: projections fused), [gpt-pp] (pp 2 x sp 2 on the contiguous ring) and
#: [mesh-gpt] (pp 2 x tp 2 x sp 2) at GPT-2 small, 6 blocks a stage, 4
#: microbatches
GPT = {"blocks_per_stage": 6, "microbatches": 4}
PATHS = {
    "Llama sp 4": ("llama-7b", {"dp": 1, "tp": 1, "sp": 4}, ["stacked", {}, "auto"]),
    "[mesh-llama]": ("llama-7b", {"dp": 2, "tp": 2, "sp": 2}, ["stacked", {"batch": 2}, "auto"]),
    "path (a)": ("llama-7b", {"dp": 1, "tp": 2, "sp": 2}, ["stacked", {"tp_fused": True}, "auto"]),
    "[gpt-pp] 1F1B": ("gpt2-small", {"dp": 1, "pp": 2, "tp": 1, "sp": 2},
                      ["stacked", {**GPT, "schedule": "1f1b"}, "auto"]),
    "[gpt-pp] GPipe": ("gpt2-small", {"dp": 1, "pp": 2, "tp": 1, "sp": 2},
                       ["stacked", {**GPT, "schedule": "gpipe"}, "auto"]),
    "[mesh-gpt] 1F1B": ("gpt2-small", {"dp": 1, "pp": 2, "tp": 2, "sp": 2},
                        ["stacked", {**GPT, "schedule": "1f1b"}, "auto"]),
    "[mesh-gpt] GPipe": ("gpt2-small", {"dp": 1, "pp": 2, "tp": 2, "sp": 2},
                         ["stacked", {**GPT, "schedule": "gpipe"}, "auto"]),
}


def worker(root: str, steps: int, names, profile: int) -> dict:
    """One turn: the paths ``names`` of the tree at ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import gc

    import torch

    from bagua_tpu_torch.communication import BaguaProcessGroup
    from bagua_tpu_torch.examples import gang
    from bagua_tpu_torch.mesh import MeshSpec

    assert os.path.abspath(sys.modules["bagua_tpu_torch"].__file__).startswith(os.path.abspath(root))
    device = torch.device("cuda", 0)
    reset = gang.reset_launches

    def reset_both():  # run_case resets the counts where its steps start
        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    gang.reset_launches = reset_both
    out = {}
    for name in names:
        model, mesh, case = PATHS[name]
        gc.collect()
        torch.cuda.empty_cache()
        group = BaguaProcessGroup([device] * MeshSpec(mesh).size, mesh_spec=MeshSpec(mesh))
        report = gang.run_case(group, model, *case, steps=steps, warmup=1, profile_steps=profile)
        out[name] = {"digests": report["digests"], "losses": report["losses"], "ms": report["ms_per_step"],
                     "peak_bytes": torch.cuda.max_memory_allocated(), "launches": report["launches"],
                     "profile": report["profile"]}
        del group, report
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an unpacked tree of the commit to compare with")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--paths", default=",".join(PATHS), help="comma-separated names of PATHS (default: all)")
    ap.add_argument("--profile", type=int, default=0, help="steps to trace after the timed ones")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    names = args.paths.split(",")
    unknown = [n for n in names if n not in PATHS]
    if unknown:
        ap.error(f"unknown paths {unknown}; PATHS has {list(PATHS)}")
    if args.worker:
        print(json.dumps(worker(args.worker, args.steps, names, args.profile)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_ring_ab: no CUDA device is visible")
    if not args.parent:
        ap.error("--parent is required")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    turns = []
    for tree, root in (("parent", args.parent), ("tree", here), ("tree", here), ("parent", args.parent)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root,
                               "--steps", str(args.steps), "--paths", args.paths, "--profile", str(args.profile)],
                              capture_output=True, text=True, timeout=1800)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
            return proc.returncode
        turn = json.loads(proc.stdout.strip().splitlines()[-1])
        for path, row in turn.items():
            print(f"[ring-ab] {tree} {path}: {row['ms']:.2f} ms/step, peak {row['peak_bytes'] / 2**30:.3f} GiB "
                  f"({row['peak_bytes']} B), launches {row['launches']}, losses {row['losses']}", flush=True)
            prof = row.pop("profile")
            if prof:
                top = "; ".join(f"{op['name']} {op['host_self_ms']:.1f}/{op['host_total_ms']:.1f} ms x{op['calls']}"
                                for op in prof["ops"][:10])
                print(f"[ring-ab] {tree} {path}: {prof['steps']} traced steps, wall {prof['wall_ms']:.1f} ms, host "
                      f"self {prof['host_self_ms']} ms, card self {prof['device_self_ms']} ms; host self/total: "
                      f"{top}", flush=True)
        turns.append((tree, turn))
    summary, differ = {}, []
    parent = turns[0][1]
    for tree, turn in turns:
        for path, row in turn.items():
            if (row["digests"], row["losses"]) != (parent[path]["digests"], parent[path]["losses"]):
                differ.append(f"{tree} {path}")
            best = summary.setdefault(tree, {}).setdefault(path, {**row, "ms": float("inf"), "peak_bytes": 0})
            best["ms"] = min(best["ms"], row["ms"])
            best["peak_bytes"] = max(best["peak_bytes"], row["peak_bytes"])
    for tree in summary.values():
        for row in tree.values():
            del row["digests"]
    print(json.dumps({"steps": args.steps, "bitwise_the_parent": not differ, "differ": differ,
                      "per_tree": summary}), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
