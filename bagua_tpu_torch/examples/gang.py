"""Training on a gang of processes, one a card: the port's twin of the JAX
package's two-process DDP test (``tests/test_multiprocess.py:60-137``).

Start one worker a card with the launcher:

    python -m bagua_tpu_torch.distributed.run --nproc_per_node 4 \\
        bagua_tpu_torch/examples/gang.py --model vgg16 --cases '[["bytegrad", {}, "on"]]'

Each worker forms the gang at the launcher's coordinator
(``MASTER_ADDR:MASTER_PORT``, as process ``RANK`` of ``WORLD_SIZE``, even
a gang of one: ``torch.distributed`` over NCCL, its ranks on
``cuda:LOCAL_RANK``; with ``--device cpu`` over gloo), builds the same
weights from the seed as every other worker, feeds its own rows of the
step's batch through ``shard_batch`` and trains.  Started without the
launcher, the script is one process driving its ranks as a
single-controller group: the run a gang must reproduce bit for bit.  It
prints one JSON line a case (``--report PATH`` also writes them to
``PATH.proc<p>.json``): a SHA-256 of each of its ranks' parameters after
the last step, the losses, ms/step, the bytes its collectives sent to
other processes and to itself a step, the hand-written kernels' launches,
each kernel's first launch held against its plain version and, with
``--profile N``, a ``torch.profiler`` summary of N more steps.
:func:`run_case` runs the same case on any group.

Models: ``mlp`` (the reference test's ``[12, 16, 4]`` with SGD 0.05, each
process drawing its own rows from ``RandomState(100 + p)``, 4 a rank),
``small-vgg`` (the CPU tests' VGG on 16x16 images) and ``vgg16`` (full
width, 224x224, 1000 classes, bf16, SGD momentum, the synthetic
benchmark's seed-0 weights and batch).
"""

import argparse
import contextlib
import hashlib
import json
import os
import re
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bagua_tpu_torch.algorithms import build_algorithm
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.kernels import _build
from bagua_tpu_torch.kernels import minmax_uint8 as mm8
from bagua_tpu_torch.kernels import quantized_ring as qr
from bagua_tpu_torch.utils import tree_flatten_with_names, tree_map

SMALL_VGG = dict(num_classes=10, cfg=(8, "M", 16, "M"), classifier_width=32, image_size=16)
MLP_SIZES = [12, 16, 4]


def build_model(model: str, device, params_npz: Optional[str] = None):
    """``(params, loss_fn, optimizer factory, per-rank batch, batch_of(p, k,
    W, step))``: ``batch_of`` gives process p's rows of a step (its k
    ranks' blocks)."""
    if model == "mlp":
        from bagua_tpu_torch.models import mlp

        if params_npz:
            with np.load(params_npz) as z:
                params = {f"layer{i}": {"w": torch.from_numpy(z[f"layer{i}.w"]).to(device),
                                        "b": torch.from_numpy(z[f"layer{i}.b"]).to(device)}
                          for i in range(len(MLP_SIZES) - 1)}
        else:
            params = mlp.init_mlp(torch.Generator().manual_seed(0), MLP_SIZES, device="cpu")
            params = tree_map(lambda t: t.to(device), params)
        draws: Dict[int, np.random.RandomState] = {}

        def batch_of(p, k, W, step):
            rng = draws.setdefault(p, np.random.RandomState(100 + p))
            return (torch.from_numpy(rng.randn(4 * k, MLP_SIZES[0]).astype(np.float32)),
                    torch.from_numpy(rng.randn(4 * k, MLP_SIZES[-1]).astype(np.float32)))
        return params, mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.05), 4, batch_of
    from bagua_tpu_torch.examples import synthetic_benchmark as sb
    from bagua_tpu_torch.models.vgg import VGG, module_params, vgg_loss_fn

    if model == "small-vgg":
        net = VGG(**SMALL_VGG, device="cpu", generator=torch.Generator().manual_seed(0))
        params = tree_map(lambda t: t.to(device), module_params(net))
        net = net.to(device)
        side, per_rank, classes = net.image_size, 4, net.num_classes
        loss_fn = vgg_loss_fn(net)

        def batch_of(p, k, W, step):
            rng = np.random.RandomState(1000 + step)
            n = W * k * per_rank
            x = rng.randn(n, side, side, 3).astype(np.float32)
            y = rng.randint(0, classes, (n,)).astype(np.int32)
            rows = slice(p * k * per_rank, (p + 1) * k * per_rank)
            return torch.from_numpy(x[rows]), torch.from_numpy(y[rows])
        return params, loss_fn, lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9), per_rank, batch_of
    if model == "vgg16":
        net, params = sb.build("vgg16", torch.bfloat16, device)
        _, loss_fn, batch_fn = sb.workload(net)
        per_rank = 32
        cache = {}

        def batch_of(p, k, W, step):
            # the synthetic benchmark's one batch, every step
            if W not in cache:
                cache[W] = batch_fn(np.random.RandomState(0), per_rank * W * k)
            rows = slice(p * k * per_rank, (p + 1) * k * per_rank)
            return tuple(t[rows] for t in cache[W])
        return params, loss_fn, lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9), per_rank, batch_of
    raise ValueError(f"unknown model {model!r}")


def reset_launches() -> None:
    for fn in mm8.KERNELS + qr.KERNELS:
        fn.launches = 0
    qr.hop_dequant_add_requant.launches_by_bits.update({8: 0, 4: 0})


def read_launches() -> Dict[str, int]:
    counts = {fn.__name__: fn.launches for fn in mm8.KERNELS}
    for bits, n in qr.hop_dequant_add_requant.launches_by_bits.items():
        counts[f"hop_dequant_add_requant_int{bits}"] = n
    return counts


#: each wrapper's plain version
PLAIN = {
    "compress_minmax_uint8": mm8.compress_minmax_uint8_plain,
    "decompress_minmax_uint8": mm8.decompress_minmax_uint8_plain,
    "decompress_reduce_requantize": mm8.decompress_reduce_requantize_plain,
    "hop_dequant_add_requant": qr.hop_dequant_add_requant_plain,
}


def _bits_of(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8) if a.dtype != torch.uint8 else a,
        b.contiguous().view(torch.uint8) if b.dtype != torch.uint8 else b)


@contextlib.contextmanager
def held_against_plain(held: Dict[str, dict]):
    """Within, the wrappers record the first launch of each codec and hop
    kernel (a ring hop: at each width of levels; ``kernels._build.WITNESS``).
    On leaving, each is held against its plain version on the same inputs:
    ``held`` gets the shapes, whether the outputs agree bit for bit and
    their largest difference.  The launch is the one the step makes and
    counts as ever; the plain version launches no kernel of ours."""
    _build.WITNESS = {}
    try:
        yield held
        seen = _build.WITNESS
    finally:
        _build.WITNESS = None
    for key, (operands, got) in seen.items():
        want = PLAIN[key if key in PLAIN else key.rsplit("_int", 1)[0]](*operands)
        want = want if isinstance(want, tuple) else (want,)
        err = max(float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
                  for g, w in zip(got, want))
        held[key] = {"shapes": [list(t.shape) for t in operands if torch.is_tensor(t)], "max_abs_err": err,
                     "bitwise": all(_bits_of(g, w) for g, w in zip(got, want))}


def digests(params, rows: int) -> List[str]:
    """A SHA-256 of each stacked row's parameters (every leaf, name order)."""
    out = []
    for r in range(rows):
        h = hashlib.sha256()
        for name, leaf in tree_flatten_with_names(params):
            h.update(name.encode())
            h.update(leaf[r].detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
        out.append(h.hexdigest())
    return out


def _wait(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ms(text: str) -> Optional[float]:
    """``369.856ms`` (a profiler table's total) in ms."""
    m = re.fullmatch(r"([\d.]+)(s|ms|us)", text.strip())
    return float(m.group(1)) * {"s": 1e3, "ms": 1.0, "us": 1e-3}[m.group(2)] if m else None


def trace_steps(step, n: int, device) -> dict:
    """``n`` calls of ``step`` under ``torch.profiler`` (the host's ops,
    and the card's kernels where the ranks are on one): the wall time, the
    profiler table's totals of host and device self time, and the ops that
    took the most host time (self and with their children, and their
    calls), ``torch.distributed``'s first."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    _wait(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        _wait(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    totals = dict(re.findall(r"^Self (CPU|CUDA|Device) time total:\s*(\S+)", averages.table(row_limit=1), re.M))
    ops = sorted(averages, key=lambda e: (not e.key.startswith("c10d::"), -e.self_cpu_time_total))[:16]
    return {"steps": n, "wall_ms": wall_ms, "host_self_ms": _ms(totals.get("CPU", "")),
            "device_self_ms": _ms(totals.get("CUDA", totals.get("Device", ""))),
            "ops": [{"name": e.key, "host_self_ms": e.self_cpu_time_total / 1e3,
                     "host_total_ms": e.cpu_time_total / 1e3, "calls": e.count} for e in ops]}


def run_case(group, model: str, algorithm: str, algorithm_kwargs: Optional[dict] = None, overlap="auto",
             steps: int = 3, warmup: int = 1, params_npz: Optional[str] = None,
             bucket_size_bytes: Optional[int] = None, processes: int = 1, keep_state: bool = False,
             profile_steps: int = 0) -> dict:
    """Train ``model`` on ``group`` with the registered ``algorithm``:
    ``warmup`` steps, which hold each kernel they launch against its plain
    version (:func:`held_against_plain`; the report's ``held``), then
    ``steps`` timed, then ``profile_steps`` traced (:func:`trace_steps`;
    the report's ``profile``).  On a gang each process feeds its own rows;
    a single-controller group feeds the rows of a gang of ``processes``
    processes, concatenated (the same global batch).  Returns the report
    (with ``keep_state``, also the final ``state``)."""
    device = group.device
    params, loss_fn, optimizer, per_rank, batch_of = build_model(model, device, params_npz)
    algo = build_algorithm(algorithm, **(algorithm_kwargs or {}))
    k, W, p = group.local_size, group.process_count, group.process_index
    ddp = DistributedDataParallel(loss_fn, optimizer, algo, process_group=group, overlap=overlap,
                                  bucket_size_bytes=bucket_size_bytes)
    backing = group._backing
    try:
        state = ddp.init(params)
        del params
        if group.distributed:
            batches = [ddp.shard_batch(batch_of(p, k, W, i)) for i in range(warmup + steps + profile_steps)]
        else:
            per = group.size // processes
            batches = [tuple(torch.cat(parts) for parts in zip(*[batch_of(q, per, processes, i)
                                                                 for q in range(processes)]))
                       for i in range(warmup + steps + profile_steps)]
        reset_launches()
        losses, held = [], {}
        with held_against_plain(held):
            for i in range(warmup):
                state, loss = ddp.train_step(state, batches[i])
                losses.append(loss.float().cpu().tolist())
        _wait(device)
        sent0 = dict(backing.sent) if backing is not None else {}
        t0 = time.perf_counter()
        for i in range(warmup, warmup + steps):
            state, loss = ddp.train_step(state, batches[i])
        _wait(device)
        seconds = time.perf_counter() - t0
        losses.append(loss.float().cpu().tolist())
        launches = read_launches()
        sent = {q: n - sent0.get(q, 0) for q, n in (backing.sent.items() if backing is not None else ())}
        profile = None
        if profile_steps:
            profiled = iter(batches[warmup + steps:])

            def step():
                nonlocal state, loss
                state, loss = ddp.train_step(state, next(profiled))
            profile = trace_steps(step, profile_steps, device)
        state = ddp.finalize_pending_updates(state)
        report = {
            "process": p, "processes": W, "local_ranks": k, "device": str(device), "model": model,
            "algorithm": algorithm, "algorithm_kwargs": algorithm_kwargs or {},
            "overlap": ddp.overlap_enabled, "buckets": ddp.plan.num_buckets,
            "steps": warmup + steps, "ms_per_step": seconds * 1e3 / max(steps, 1),
            "losses": losses, "digests": digests(state.params, k), "launches": launches, "held": held,
            "profile": profile,
            "wire_bytes_per_step": {
                "to_other_processes": sum(n for q, n in sent.items() if q != p) // max(steps, 1),
                "to_itself": sent.get(p, 0) // max(steps, 1)},
        }
        if keep_state:
            report["state"] = state
        return report
    finally:
        ddp.shutdown()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="vgg16", choices=["mlp", "small-vgg", "vgg16"])
    ap.add_argument("--cases", default='[["bytegrad", {}, "auto"]]',
                    help="JSON list of [algorithm, kwargs, overlap], run in turn on the one gang")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ranks-per-process", type=int, default=1)
    ap.add_argument("--intra-size", type=int, default=None)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--params", default=None, help="an npz of the mlp's weights (layer<i>.w, layer<i>.b)")
    ap.add_argument("--bucket-bytes", type=int, default=None, help="bucket size (default: 10 MiB)")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="after the timed steps, trace N more with torch.profiler (the report's profile)")
    ap.add_argument("--report", default=None, help="write the report to REPORT.proc<p>.json")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from bagua_tpu_torch.communication import destroy_process_group, init_process_group

    if args.device == "cpu":
        torch.set_num_threads(1)
        device = torch.device("cpu")
    else:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    devices = [device] * args.ranks_per_process
    if "MASTER_PORT" in os.environ:
        # a gang under the launcher, even of one process: its collectives
        # go through torch.distributed all the same
        group = init_process_group(devices, intra_size=args.intra_size,
                                   coordinator_address=f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}:"
                                                       f"{os.environ['MASTER_PORT']}",
                                   num_processes=int(os.environ.get("WORLD_SIZE", 1)),
                                   process_id=int(os.environ.get("RANK", 0)))
    else:
        group = init_process_group(devices, intra_size=args.intra_size)
    reports = []
    try:
        for algorithm, kwargs, overlap in json.loads(args.cases):
            overlap = {"on": True, "off": False}.get(overlap, overlap)
            reports.append(run_case(group, args.model, algorithm, kwargs, overlap, args.steps, args.warmup,
                                    args.params, args.bucket_bytes, profile_steps=args.profile))
            print(json.dumps(reports[-1]), flush=True)
        if args.report:
            with open(f"{args.report}.proc{group.process_index}.json", "w") as f:
                json.dump(reports, f)
    finally:
        destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
