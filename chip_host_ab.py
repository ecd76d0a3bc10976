#!/usr/bin/env python3
"""Times the port's host-bound training steps, those with many bucket
exchanges or much host work a step, in two versions of the port on one
card, in turns.

    git archive <commit> | tar -x -C _chipcheck/parent
    python3 chip_host_ab.py --parent _chipcheck/parent [--steps 10] [--paths "BERT SQuAD"]

Each turn is a process of its own that imports ``bagua_tpu_torch`` from one
tree, in the order parent, this tree, this tree, parent.  The paths are
``chip_smoke.py``'s, at its shapes, weights and data from seed 0:

* ``BERT SQuAD``: the SQuAD twin at BERT-Large width (bf16 compute, 128
  tokens, 8 a rank, 4 ranks, ByteGrad with overlap: 75 buckets);
* ``mesh engine``: the GPT twin's engine mode at GPT-2 small, dp 4 x tp 2,
  ``gradient_allreduce`` with overlap (a bucket a leaf: 110 buckets);
* ``GPT 1F1B``: the GPT twin at pp 2 x sp 2, 1F1B (each tick's host work);
* ``mesh GPT 1F1B``: the twin at pp 2 x tp 2 x sp 2, 1F1B (the
  tensor-parallel collectives of every tick).

Each path: 2 warm-up steps, then ``--steps`` steps ending in
``torch.cuda.synchronize()``: its ms/step.  Prints the card's name and
power limit, each turn's numbers and a JSON line with the faster of each
tree's two turns per path.  Exits non-zero without a card.
"""

import argparse
import gc
import json
import os
import subprocess
import sys
import time

WARMUP = 2
GPT2 = ["--vocab", "50257", "--hidden", "768", "--heads", "12", "--seq", "1024", "--batch", "8"]
PATHS = {
    "BERT SQuAD": None,
    "mesh engine": ["--engine", "--pp", "1", "--sp", "1", "--blocks-per-stage", "12", "--dp", "4", "--tp", "2"],
    "GPT 1F1B": ["--pp", "2", "--tp", "1", "--sp", "2", "--blocks-per-stage", "6", "--microbatches", "4",
                 "--schedule", "1f1b"],
    "mesh GPT 1F1B": ["--pp", "2", "--tp", "2", "--sp", "2", "--blocks-per-stage", "6", "--microbatches", "4",
                      "--schedule", "1f1b"],
}


def worker(root: str, steps: int, names) -> dict:
    """One turn: the paths ``names`` of the tree at ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from bagua_tpu_torch import init_process_group
    from bagua_tpu_torch.examples import gpt_pretrain as gp
    from bagua_tpu_torch.examples import squad
    from bagua_tpu_torch.examples.synthetic_benchmark import BERT_SEQ
    from bagua_tpu_torch.kernels import _build
    from bagua_tpu_torch.models.bert import init_bert

    assert os.path.abspath(sys.modules["bagua_tpu_torch"].__file__).startswith(os.path.abspath(root))
    _build.build(["minmax_uint8", "quantized_ring", "flash_attention", "collective_matmul"])
    device = torch.device("cuda", 0)

    def timed(step, data):
        for batch in data[:WARMUP]:
            step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in data[WARMUP:]:
            step(batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3

    out = {}
    for name in names:
        gc.collect()
        torch.cuda.empty_cache()
        if name == "BERT SQuAD":
            group = init_process_group(devices=[device] * 4, intra_size=1)
            model, params = init_bert(squad.squad_config(True, BERT_SEQ), torch.Generator(device=device).manual_seed(0),
                                      device, model_cls=squad.BertForQuestionAnswering)
            marks = {}

            def on_step(i, state, ddp):
                if i == WARMUP:
                    torch.cuda.synchronize()
                    marks["t0"] = time.perf_counter()
                return state

            losses, state, ddp = squad.run(model, params, group, WARMUP + steps, 8, BERT_SEQ,
                                           log_every=WARMUP + steps + 1, on_step=on_step)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - marks["t0"]) / steps * 1e3
            finite = all(bool(torch.isfinite(x).all()) for x in losses)
            del model, params, state, ddp
        elif PATHS[name][0] == "--engine":
            args = gp.parse_args(GPT2 + PATHS[name] + ["--steps", str(WARMUP + steps), "--device", "cuda"])
            ddp, state = gp.engine(args, device)
            data = [(torch.as_tensor(i, device=device), torch.as_tensor(l, device=device))
                    for i, l in gp.batches(args)]
            holder = {"state": state, "losses": []}

            def step(batch):
                holder["state"], losses = ddp.train_step(holder["state"], batch)
                holder["losses"].append(losses)

            ms = timed(step, data)
            finite = all(bool(torch.isfinite(x).all()) for x in holder["losses"])
            ddp.shutdown()
            del ddp, state, holder, data
        else:
            args = gp.parse_args(GPT2 + PATHS[name] + ["--steps", str(WARMUP + steps)])
            twin = gp.Twin(args, device)
            data = [(twin.shard(i), twin.shard(l)) for i, l in gp.batches(args)]
            losses = []
            ms = timed(lambda batch: losses.append(twin.step(*batch)), data)
            finite = all(bool(torch.isfinite(x).all()) for x in losses)
            del twin, data
        if not finite:
            raise AssertionError(f"{name}: a non-finite loss")
        out[name] = {"ms": ms}
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--parent", help="an unpacked tree of the commit to compare with")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--paths", default=",".join(PATHS), help="comma-separated names of PATHS (default: all)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    names = args.paths.split(",")
    unknown = [n for n in names if n not in PATHS]
    if unknown:
        ap.error(f"unknown paths {unknown}; PATHS has {list(PATHS)}")
    if args.worker:
        print(json.dumps(worker(args.worker, args.steps, names)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_host_ab: no CUDA device is visible")
    if not args.parent:
        ap.error("--parent is required")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    best = {}
    for tree, root in (("parent", args.parent), ("tree", here), ("tree", here), ("parent", args.parent)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root,
                               "--steps", str(args.steps), "--paths", args.paths],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
            return proc.returncode
        turn = json.loads(proc.stdout.strip().splitlines()[-1])
        for path, row in turn.items():
            print(f"[host-ab] {tree} {path}: {row['ms']:.2f} ms/step", flush=True)
            prev = best.setdefault(tree, {}).get(path)
            if prev is None or row["ms"] < prev["ms"]:
                best[tree][path] = row
    print(json.dumps({"steps": args.steps, "faster_of_two_turns": best}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
