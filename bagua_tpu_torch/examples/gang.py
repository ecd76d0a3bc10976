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
benchmark's seed-0 weights and batch); and the pretraining twins on a
named mesh (``--mesh '{"dp": 2, "tp": 2}'``, a JSON ``MeshSpec``, which
sets the ranks a process holds): ``small-llama`` (the Llama twin's
example width) and ``llama-7b`` (``llama_7b_config``'s width, 2 layers,
one 4096-token sequence, f32), ``small-gpt`` (the GPT twin's example
width) and ``gpt2-small`` (GPT-2 small: 50257 vocabulary, 768 hidden, 12
heads, 1024 tokens, 8 sequences).  A twin's case is ``[mode, options,
overlap]``: mode ``"stacked"`` is the twin's hand-scheduled step, any
other its ``--engine`` mode with that ``--algo``; options are the twin's
own flags (``{"tp_fused": true}``, ``{"schedule": "gpipe"}``,
``{"blocks_per_stage": 12}``), so the layout and the step are the twin's
code.  A twin builds its seed-drawn weights in every process and feeds
each process its ranks' rows of the step's global batch.  The warm-up
steps also hold the first launch of each flash-attention kernel within
``ATTENTION_TOLS`` and of the tile GEMM within ``matmul_tol``
(``kernels/tolerance.py``).

    python -m bagua_tpu_torch.distributed.run --nproc_per_node 2 bagua_tpu_torch/examples/gang.py \
        --device cpu --model small-llama --mesh '{"dp": 1, "tp": 2, "sp": 2}' --cases '[["stacked", {}, "auto"]]'
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
from bagua_tpu_torch.kernels import collective_matmul as cm
from bagua_tpu_torch.kernels import flash_attention as fa
from bagua_tpu_torch.kernels import minmax_uint8 as mm8
from bagua_tpu_torch.kernels import quantized_ring as qr
from bagua_tpu_torch.kernels.tolerance import ATTENTION_TOLS, close, matmul_share
from bagua_tpu_torch.mesh import MeshSpec
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
    for fn in mm8.KERNELS + qr.KERNELS + fa.KERNELS + cm.KERNELS:
        fn.launches = 0
    qr.hop_dequant_add_requant.launches_by_bits.update({8: 0, 4: 0})


def read_launches() -> Dict[str, int]:
    counts = {fn.__name__: fn.launches for fn in mm8.KERNELS + qr.CODEC4 + fa.KERNELS + cm.KERNELS}
    for bits, n in qr.hop_dequant_add_requant.launches_by_bits.items():
        counts[f"hop_dequant_add_requant_int{bits}"] = n
    return counts


#: each wrapper's plain version
PLAIN = {
    "compress_minmax_uint8": mm8.compress_minmax_uint8_plain,
    "decompress_minmax_uint8": mm8.decompress_minmax_uint8_plain,
    "decompress_reduce_requantize": mm8.decompress_reduce_requantize_plain,
    "hop_dequant_add_requant": qr.hop_dequant_add_requant_plain,
    "compress_minmax_uint4": qr.compress_minmax_uint4_plain,
    "decompress_minmax_uint4": qr.decompress_minmax_uint4_plain,
    "block_attention": fa.block_attention_plain,
    "flash_attention_bwd_dq": fa.flash_attention_bwd_dq_plain,
    "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv_plain,
    "matmul_tile": cm.matmul_tile_plain,
}


def _bits_of(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8) if a.dtype != torch.uint8 else a,
        b.contiguous().view(torch.uint8) if b.dtype != torch.uint8 else b)


@contextlib.contextmanager
def held_against_plain(held: Dict[str, dict]):
    """Within, the wrappers record the first launch of each kernel (a ring
    hop: at each width of levels; ``kernels._build.WITNESS``).  On leaving,
    each is held against its plain version on the same inputs: ``held``
    gets the shapes, whether the outputs agree bit for bit, their largest
    difference, and for the kernels held to a tolerance whether they meet
    it (``within``: ``ATTENTION_TOLS`` for the attention kernels,
    ``matmul_tol`` for the tile GEMM; the codecs and hops are held
    bitwise).  The launch is the one the
    step makes and counts as ever; the plain version launches no kernel of
    ours."""
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
        if key in ATTENTION_TOLS:
            held[key]["within"] = all(g.shape == w.shape and g.dtype == w.dtype and close(g, w, tol)
                                      for g, w, tol in zip(got, want, ATTENTION_TOLS[key]))
        elif key == "matmul_tile":
            held[key]["within"] = got[0].shape == want[0].shape and matmul_share(got[0], want[0], *operands) <= 1.0


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


#: the pretraining twins: model -> (example module name, its arguments
#: beyond the mesh)
TWINS = {
    "small-llama": ("llama_pretrain", []),
    "llama-7b": ("llama_pretrain", ["--width", "7b", "--layers", "2", "--seq", "4096", "--batch", "1"]),
    "small-gpt": ("gpt_pretrain", []),
    "gpt2-small": ("gpt_pretrain", ["--vocab", "50257", "--hidden", "768", "--heads", "12", "--seq", "1024",
                                    "--batch", "8"]),
}
#: each twin's mesh axes, in the order its ``mesh_spec`` lays them
TWIN_AXES = {"llama_pretrain": ("dp", "tp", "sp"), "gpt_pretrain": ("dp", "pp", "tp", "sp")}


def twin_args(group, model: str, mode: str, options: Optional[dict], steps: int):
    """``(example module, its parsed arguments)`` of a twin case on
    ``group``'s mesh: the mesh's axis sizes as the twin's flags (``fsdp``
    too), ``--engine --algo <mode>`` unless ``mode`` is ``"stacked"``, the
    ``options`` as the twin's own flags."""
    import importlib

    name, preset = TWINS[model]
    module = importlib.import_module(f"bagua_tpu_torch.examples.{name}")
    sizes = dict(zip(group.mesh_spec.names, group.mesh_spec.shape))
    unknown = set(sizes) - set(TWIN_AXES[name]) - {"fsdp"}
    if unknown:
        raise ValueError(f"{model} has no mesh axes {sorted(unknown)}")
    argv = list(preset) + ["--device", group.device.type, "--steps", str(steps)]
    for axis in TWIN_AXES[name] + ("fsdp",):
        argv += [f"--{axis}", str(sizes.get(axis, 1))]
    if mode != "stacked":
        argv += ["--engine", "--algo", mode]
    for key, value in (options or {}).items():
        flag = "--" + key.replace("_", "-")
        argv += [flag] if value is True else ([] if value is False else [flag, str(value)])
    return module, module.parse_args(argv)


def run_twin_case(group, model: str, mode: str, options: Optional[dict], warmup: int, steps: int,
                  keep_state: bool, profile_steps: int, params_file: Optional[str] = None) -> dict:
    """A twin case (:data:`TWINS`) on ``group``, through the twin's own
    code: its hand-scheduled step or its engine, the same weights in every
    process (seed-drawn, or the unstacked tree ``torch.save``d in
    ``params_file``), each process feeding its ranks' rows of each global
    batch.  Returns :func:`run_case`'s report."""
    device = group.device
    total = warmup + steps + profile_steps
    module, args = twin_args(group, model, mode, options, total)
    llama = module.__name__.endswith("llama_pretrain")
    given = torch.load(params_file) if params_file else None
    if mode == "stacked":
        if llama:
            _, params, step, data, _ = module.hand_steps(args, device, params=given, group=group)
            batches = list(data)
        else:
            twin = module.Twin(args, device, params=given, group=group)
            params = twin.params
            batches = [(twin.shard(ids), twin.shard(labels)) for ids, labels in module.batches(args)]

            def step(batch):
                return twin.step(*batch)
        return _drive(group, model, mode, options, step, lambda: {"params": params}, batches, warmup, steps,
                      profile_steps, None, keep_state)
    if llama:
        ddp, state, _ = module.engine(args, device, params=given, group=group)
        batches = [ddp.process_rows(torch.as_tensor(ids, dtype=torch.int64, device=device))
                   for ids in module.engine_batches(args)]
    else:
        ddp, state = module.engine(args, device, params=given, group=group)
        batches = [ddp.process_rows((torch.as_tensor(ids, device=device), torch.as_tensor(labels, device=device)))
                   for ids, labels in module.batches(args)]
    try:
        return _drive(group, model, mode, options, *_engine_steps(ddp, state), batches, warmup, steps,
                      profile_steps, ddp, keep_state)
    finally:
        ddp.shutdown()


def _engine_steps(ddp, state):
    """``(step, final)`` of an engine from ``state``: ``step(batch)``
    trains one step and returns the losses, ``final()`` the parameters
    and state with the pending updates gathered."""
    box = [state]

    def step(batch):
        box[0], losses = ddp.train_step(box[0], batch)
        return losses

    def final():
        finalized = ddp.finalize_pending_updates(box[0])
        return {"params": finalized.params, "state": finalized}
    return step, final


def _drive(group, model, algorithm, kwargs, step, final, batches, warmup, steps, profile_steps, ddp,
           keep_state) -> dict:
    """``step(batch)`` (returning the step's losses) over ``batches``:
    ``warmup`` steps holding each first launch against its plain version,
    ``steps`` timed, ``profile_steps`` traced; the report.  ``final()``
    gives ``{"params": ...}`` after the steps (and whatever else
    ``keep_state`` keeps in the report); ``ddp``, where an engine ran, its
    overlap mode and buckets."""
    device, backing = group.device, group._backing
    k, W, p = group.local_size, group.process_count, group.process_index
    reset_launches()
    losses, held = [], {}
    with held_against_plain(held):
        for i in range(warmup):
            losses.append(step(batches[i]).float().cpu().tolist())
    _wait(device)
    sent0 = dict(backing.sent) if backing is not None else {}
    t0 = time.perf_counter()
    for i in range(warmup, warmup + steps):
        loss = step(batches[i])
    _wait(device)
    seconds = time.perf_counter() - t0
    if steps:
        losses.append(loss.float().cpu().tolist())
    launches = read_launches()
    sent = {q: n - sent0.get(q, 0) for q, n in (backing.sent.items() if backing is not None else ())}
    profile = None
    if profile_steps:
        profiled = iter(batches[warmup + steps:])
        profile = trace_steps(lambda: step(next(profiled)), profile_steps, device)
    kept = final()
    report = {
        "process": p, "processes": W, "local_ranks": k, "device": str(device), "model": model,
        "algorithm": algorithm, "algorithm_kwargs": kwargs or {},
        "overlap": ddp.overlap_enabled if ddp is not None else False,
        "buckets": ddp.plan.num_buckets if ddp is not None else 0,
        "steps": warmup + steps, "ms_per_step": seconds * 1e3 / max(steps, 1),
        "losses": losses, "digests": digests(kept["params"], k), "launches": launches, "held": held,
        "profile": profile,
        "wire_bytes_per_step": {
            "to_other_processes": sum(n for q, n in sent.items() if q != p) // max(steps, 1),
            "to_itself": sent.get(p, 0) // max(steps, 1)},
    }
    if keep_state:
        report.update(kept)
    return report


def make_algorithm(algorithm: str, kwargs: dict):
    """The registered ``algorithm`` on its JSON ``kwargs``, and two that
    take objects: ``"grad_accumulation"`` (``{"inner": name, "inner_kwargs":
    {...}, "every": n}``) and ``"qadam"`` with ``{"optimizer": {...}}``,
    the ``QAdamOptimizer``'s arguments."""
    from bagua_tpu_torch.algorithms.grad_accumulation import GradientAccumulation
    from bagua_tpu_torch.algorithms.q_adam import QAdamOptimizer

    kwargs = dict(kwargs)
    if algorithm == "grad_accumulation":
        return GradientAccumulation(make_algorithm(kwargs.pop("inner"), kwargs.pop("inner_kwargs", {})),
                                    every=kwargs.pop("every"))
    if algorithm == "qadam" and "optimizer" in kwargs:
        kwargs["q_adam_optimizer"] = QAdamOptimizer(**kwargs.pop("optimizer"))
    return build_algorithm(algorithm, **kwargs)


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
    (with ``keep_state``, also the final ``params`` and, where an engine
    trained them, its ``state``).  A twin (:data:`TWINS`) runs
    :func:`run_twin_case`, its ``overlap`` the twin's own."""
    if model in TWINS:
        return run_twin_case(group, model, algorithm, algorithm_kwargs, warmup, steps, keep_state, profile_steps,
                             params_npz)
    device = group.device
    params, loss_fn, optimizer, per_rank, batch_of = build_model(model, device, params_npz)
    kwargs = dict(algorithm_kwargs or {})
    directive = kwargs.pop("directive", None)
    algo = make_algorithm(algorithm, kwargs)
    if algorithm == "qadam":
        optimizer = None  # QAdam's own
    k, W, p = group.local_size, group.process_count, group.process_index
    ddp = DistributedDataParallel(loss_fn, optimizer, algo, process_group=group, overlap=overlap,
                                  bucket_size_bytes=bucket_size_bytes)
    try:
        state = ddp.init(params)
        del params
        if directive is not None:
            state = ddp.apply_degradation_directive(state, directive)
        if group.distributed:
            batches = [ddp.shard_batch(batch_of(p, k, W, i)) for i in range(warmup + steps + profile_steps)]
        else:
            per = group.size // processes
            batches = [tuple(torch.cat(parts) for parts in zip(*[batch_of(q, per, processes, i)
                                                                 for q in range(processes)]))
                       for i in range(warmup + steps + profile_steps)]
        return _drive(group, model, algorithm, algorithm_kwargs, *_engine_steps(ddp, state), batches, warmup, steps,
                      profile_steps, ddp, keep_state)
    finally:
        ddp.shutdown()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="vgg16", choices=["mlp", "small-vgg", "vgg16", *TWINS])
    ap.add_argument("--mesh", default=None,
                    help='a JSON MeshSpec of the group ({"dp": 2, "tp": 2}); the processes share its ranks')
    ap.add_argument("--cases", default='[["bytegrad", {}, "auto"]]',
                    help="JSON list of [algorithm, kwargs, overlap] (and optionally {\"warmup\": n}, this "
                         "case's warm-up steps), run in turn on the one gang")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ranks-per-process", type=int, default=1)
    ap.add_argument("--intra-size", type=int, default=None)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--params", default=None,
                    help="an npz of the mlp's weights (layer<i>.w, layer<i>.b), or a twin's unstacked tree "
                         "saved by torch.save")
    ap.add_argument("--bucket-bytes", type=int, default=None, help="bucket size (default: 10 MiB)")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="after the timed steps, trace N more with torch.profiler (the report's profile)")
    ap.add_argument("--report", default=None, help="write the report to REPORT.proc<p>.json")
    ap.add_argument("--save-params", default=None, metavar="PATH",
                    help="write each case's final parameters (this process's ranks, f32) to "
                         "PATH.case<i>.proc<p>.npz")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from bagua_tpu_torch.communication import destroy_process_group, init_process_group
    from bagua_tpu_torch.distributed import init_gang, launched, mesh_group

    if args.device == "cpu":
        torch.set_num_threads(1)
        device = torch.device("cpu")
    else:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    spec = MeshSpec(json.loads(args.mesh)) if args.mesh else None
    if args.model in TWINS and spec is None:
        raise SystemExit(f"{args.model} needs --mesh")
    if launched():
        # a gang under the launcher, even of one process: its collectives
        # go through torch.distributed all the same
        if spec is not None:
            group = mesh_group(spec, device)
        else:
            group = init_gang([device] * args.ranks_per_process, intra_size=args.intra_size)
    elif spec is not None:
        group = init_process_group([device] * spec.size, mesh_spec=spec)
    else:
        group = init_process_group([device] * args.ranks_per_process, intra_size=args.intra_size)
    reports = []
    try:
        for algorithm, kwargs, overlap, *more in json.loads(args.cases):
            overlap = {"on": True, "off": False}.get(overlap, overlap)
            warmup = (more[0] if more else {}).get("warmup", args.warmup)
            report = run_case(group, args.model, algorithm, kwargs, overlap, args.steps, warmup,
                              args.params, args.bucket_bytes, keep_state=bool(args.save_params),
                              profile_steps=args.profile)
            params = report.pop("params", None)
            report.pop("state", None)
            if args.save_params:
                flat = {name: leaf.detach().cpu().float().numpy() for name, leaf in tree_flatten_with_names(params)}
                np.savez(f"{args.save_params}.case{len(reports)}.proc{group.process_index}.npz", **flat)
            reports.append(report)
            print(json.dumps(reports[-1]), flush=True)
        if args.report:
            with open(f"{args.report}.proc{group.process_index}.json", "w") as f:
                json.dump(reports, f)
    finally:
        destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
