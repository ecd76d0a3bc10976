"""The benchmark gate: for every deterministic algorithm, train the chosen
model twice and assert (a) that the two runs' final losses are **exactly**
equal and (b) that the throughput clears the algorithm's floor.

The port of the JAX package's ``ci/benchmark_check.py`` (the analog of the
reference's ``.buildkite/scripts/benchmark_master.sh:81-106``, which pins
exact loss values per algorithm).  Models:

* ``mlp``: a seconds-fast smoke gate, MLP ``[64, 128, 16]``;
* ``vgg16``: the reference's headline workload; on the card 224 x 224, 1000
  classes, bf16 and 32 a rank; on the CPU 32 x 32, 10 classes, f32 and 4 a
  rank;
* ``bert``: a small BERT MLM encoder (vocab 512, hidden 64, 2 layers).

Each algorithm runs its warm-up steps (QAdam ``QADAM_WARMUP + 2``, the rest
2; QAdam's lr and eps are ``QADAM``'s) and 12 timed steps on data from ``np.random.RandomState(3)``, with
cuDNN's deterministic algorithms, twice from the same parameters.
Throughput is samples a second **a card**: the run's samples over the
distinct devices that hold the ranks (one card may hold several ranks), so
a floor is held to what one card does.  ``--reference-floors`` gates VGG16
against the reference's own GPU CI floors (``BASELINE.md``,
``benchmark_master.sh:81-83``)::

    python -m bagua_tpu_torch.tools.benchmark_check --model vgg16 --ranks 4 --intra-size 1 --reference-floors
    python -m bagua_tpu_torch.tools.benchmark_check --device cpu                 # 8 CPU ranks, mlp
    python -m bagua_tpu_torch.tools.benchmark_check --device cpu --model vgg16
"""

import argparse
import contextlib
import sys
import time

import numpy as np
import torch

from bagua_tpu_torch.tools._lane import add_device_args, lane_group, wait

QADAM_WARMUP = 5
#: QAdam's lr and eps by model: the JAX lane's (``build_algorithm``'s lr,
#: ``QAdamOptimizer``'s eps) but at VGG16, where they run away to NaN in
#: both packages (a weight whose gradient was zero through the warm-up steps
#: moves by m / sqrt(v) at eps 1e-8) and fail the exact-loss gate; VGG16
#: takes the smoke run's full-width QAdam (``chip_smoke.QADAM_FULL``)
QADAM = {"mlp": {"lr": 1e-3, "eps": 1e-8}, "bert": {"lr": 1e-3, "eps": 1e-8}, "vgg16": {"lr": 1e-5, "eps": 1e-3}}
STEPS = 12

#: the reference's VGG16 img/s floors a GPU (``BASELINE.md``,
#: ``benchmark_master.sh:81-83``); applied with --reference-floors
REFERENCE_VGG16_FLOORS = {
    "gradient_allreduce": 185.0,
    "bytegrad": 180.0,
    "decentralized": 150.0,
    "low_precision_decentralized": 115.0,
    "qadam": 165.0,
}

BERT_SEQ = 32
DEFAULT_BATCH = {"mlp": 64, "vgg16": 32, "bert": 8}
CPU_BATCH = {"mlp": 64, "vgg16": 4, "bert": 8}


def deterministic_algorithms():
    """The registry's algorithms the gate runs: all but the wall-clock
    schedules (not bitwise deterministic) and ``none`` (nothing to gate)."""
    from bagua_tpu_torch.algorithms import WALL_CLOCK_ALGORITHMS, GlobalAlgorithmRegistry

    return [n for n in GlobalAlgorithmRegistry.keys() if n not in WALL_CLOCK_ALGORITHMS and n != "none"]


def build_workload(model: str, device, params=None):
    """``(loss_fn, params, make_batch)`` of ``model`` on ``device``:
    ``make_batch(rng, n)`` draws ``n`` samples from the numpy ``rng``.
    ``params`` (a flax-style tree) replaces the model's own initial weights,
    drawn from seed 1."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(1)
    if model == "mlp":
        from bagua_tpu_torch.models.mlp import init_mlp, mse_loss

        params = params if params is not None else init_mlp(gen, [64, 128, 16], device=device)
        return mse_loss, params, lambda rng, n: (
            torch.from_numpy(rng.randn(n, 64).astype(np.float32)),
            torch.from_numpy(rng.randn(n, 16).astype(np.float32)))
    if model == "vgg16":
        from bagua_tpu_torch.models.vgg import init_vgg16, vgg_loss_fn

        cpu = device.type == "cpu"
        size, classes = (32, 10) if cpu else (224, 1000)
        net, own = init_vgg16(gen, size, classes, compute_dtype=torch.float32 if cpu else torch.bfloat16,
                              device=device)
        return vgg_loss_fn(net), params if params is not None else own, lambda rng, n: (
            torch.from_numpy(rng.rand(n, size, size, 3).astype(np.float32)),
            torch.from_numpy(rng.randint(0, classes, size=(n,)).astype(np.int32)))
    if model == "bert":
        from bagua_tpu_torch.models.bert import BertConfig, init_bert, mlm_loss_fn

        cfg = BertConfig(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                         max_position_embeddings=BERT_SEQ)
        net, own = init_bert(cfg, gen, device)
        return mlm_loss_fn(net), params if params is not None else own, lambda rng, n: (
            torch.from_numpy(rng.randint(0, cfg.vocab_size, (n, BERT_SEQ)).astype(np.int32)),
            torch.from_numpy(rng.randint(0, cfg.vocab_size, (n, BERT_SEQ)).astype(np.int32)))
    raise SystemExit(f"unknown --model {model}")


def cards(group) -> int:
    """The distinct devices that hold the group's ranks."""
    return len({str(d) for d in group.devices}) * group.process_count


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms (the same convolution gradients from
    one run to the next) within."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def run_once(group, workload, algorithm: str, n_steps: int = STEPS, batch: int = 64, qadam=QADAM["mlp"]) -> dict:
    """One run of ``algorithm`` over ``group`` on ``workload`` (``(loss_fn,
    params, make_batch)``, the parameters unstacked): the warm-up steps,
    then ``n_steps`` timed; QAdam at ``qadam``'s lr and eps.  Returns the
    final loss (the mean over the ranks), samples a second a card, the
    plan's buckets and the steps."""
    from bagua_tpu_torch.algorithms import QAdamOptimizer, build_algorithm
    from bagua_tpu_torch.ddp import DistributedDataParallel

    loss_fn, params, make_batch = workload
    device = group.device
    kwargs = {"q_adam_optimizer": QAdamOptimizer(warmup_steps=QADAM_WARMUP, **qadam)} if algorithm == "qadam" else {}
    algo = build_algorithm(algorithm, **kwargs)
    opt = None if algorithm == "qadam" else (lambda ps: torch.optim.SGD(ps, lr=0.05))
    rng = np.random.RandomState(3)
    bs = batch * group.size
    # warm-up long enough to run every step variant (QAdam's warm-up
    # boundary) before the timed window
    n_warm = (QADAM_WARMUP + 2) if algorithm == "qadam" else 2
    data = [tuple(t.to(device) for t in make_batch(rng, bs)) for _ in range(n_warm + n_steps)]
    with deterministic():
        ddp = DistributedDataParallel(loss_fn, opt, algo, process_group=group)
        try:
            state = ddp.init(params)
            for b in data[:n_warm]:
                state, losses = ddp.train_step(state, b)
            wait(device)
            t0 = time.perf_counter()
            for b in data[n_warm:]:
                state, losses = ddp.train_step(state, b)
            wait(device)
            dt = time.perf_counter() - t0
            buckets = ddp.plan.num_buckets
        finally:
            ddp.shutdown()
    return {"loss": float(losses.mean()), "sps": bs * n_steps / dt / cards(group), "buckets": buckets,
            "warmup": n_warm, "steps": n_steps}


def run_gate(group, model: str, names=None, steps: int = STEPS, batch=None, floors=None, min_throughput=0.0,
             params=None, log=None) -> dict:
    """Each algorithm of ``names`` (default: every deterministic one) twice
    on ``group`` from ``params`` (default the model's own, seed 1);
    ``floors`` maps an algorithm to its samples/s a card.  Returns
    ``{"results": {name: {...}}, "failures": [...]}``."""
    log = log or sys.stdout
    if batch is None:
        batch = (CPU_BATCH if group.device.type == "cpu" else DEFAULT_BATCH)[model]
    workload = build_workload(model, group.device, params)
    results, failures = {}, []
    for name in names or deterministic_algorithms():
        floor = max(min_throughput, (floors or {}).get(name, min_throughput))
        t0 = time.perf_counter()
        first = run_once(group, workload, name, steps, batch, QADAM[model])
        second = run_once(group, workload, name, steps, batch, QADAM[model])
        seconds = time.perf_counter() - t0
        sps = max(first["sps"], second["sps"])
        det = first["loss"] == second["loss"]
        thr = sps >= floor
        print(f"{model}/{name:28s} loss={first['loss']:.8f} determinism={'OK ' if det else 'FAIL'} "
              f"throughput={sps:9.1f} samples/s/card floor({floor:.0f})={'OK ' if thr else 'FAIL'} "
              f"ranks={group.size} cards={cards(group)}", file=log, flush=True)
        results[name] = {"losses": (first["loss"], second["loss"]), "sps": (first["sps"], second["sps"]),
                         "floor": floor, "buckets": first["buckets"], "warmup": first["warmup"],
                         "steps": steps, "seconds": seconds}
        if not det:
            failures.append(f"{name}: loss {first['loss']} != {second['loss']}")
        if not thr:
            failures.append(f"{name}: throughput {sps:.1f} < {floor}")
    return {"results": results, "failures": failures}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="mlp", choices=("mlp", "vgg16", "bert"))
    p.add_argument("--min-throughput", type=float, default=0.0,
                   help="samples/s a card floor (raised per algorithm by --reference-floors)")
    p.add_argument("--reference-floors", action="store_true",
                   help="gate VGG16 against the reference's img/s floors a GPU (BASELINE.md, "
                        "benchmark_master.sh:81-83)")
    p.add_argument("--algorithms", default=None, help="comma list; default = every deterministic one")
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--batch", type=int, default=None, help="batch a rank")
    add_device_args(p)
    args = p.parse_args(argv)

    if args.reference_floors and args.model != "vgg16":
        raise SystemExit("--reference-floors are VGG16 img/s numbers (BASELINE.md); use --min-throughput "
                         "for other models")
    # the JAX lane's default group: every rank on the intra axis
    group = lane_group(args.device, args.ranks, args.intra_size)
    out = run_gate(group, args.model, args.algorithms.split(",") if args.algorithms else None, args.steps,
                   args.batch, REFERENCE_VGG16_FLOORS if args.reference_floors else None, args.min_throughput)
    if out["failures"]:
        print("FAILURES:\n  " + "\n  ".join(out["failures"]))
        return 1
    print("all benchmark checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
