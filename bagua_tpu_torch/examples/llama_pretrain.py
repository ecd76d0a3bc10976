#!/usr/bin/env python3
"""Llama-style character-LM pretraining over a ``(dp, tp, sp)`` mesh with
zigzag ring attention: the twin of ``examples/llama_pretrain/main.py``.

* **dp** -- the batch is sharded over it.
* **tp** -- Megatron column/row sharding of the heads and the SwiGLU MLP;
  the Row projections sum over it (``psum``).
* **sp** -- each rank holds two globally non-adjacent half-blocks of every
  sequence (zigzag), and attention is the causal ring.

The group is the JAX mesh itself: a :class:`~bagua_tpu_torch.mesh.MeshSpec`
``{"dp": dp, "tp": tp, "sp": sp}`` in that order, axes of size 1 included
(:func:`mesh_spec`), ranks row-major over it as the JAX devices are.

The hand-scheduled step is the example's ``local_step``: every rank's
loss, the gradient of their sum with respect to each rank's copy of the
parameters (in JAX each device differentiates its own loss and the
transposed ring shifts and ``psum``s bring the other ranks' cotangents
back, which is the same), the average over dp and sp (JAX's ``pmean``
over ``("dp", "sp")``; never over tp), then AdamW with optax's defaults.
As in JAX, the model is built at the local (``1 / tp``) shapes and every
rank starts from that one tree, so the tp ranks are replicas of one shard.

``--engine`` is the example's ``run_engine``: the DDP engine owns the step
on the named mesh ``{"dp"[, "fsdp"][, "tp"]}`` (sp 1), its bucketed
exchange (``gradient_allreduce`` with overlap, or ZeRO under ``--algo
zero``) riding the data axes dp and fsdp only while the model's tp
collectives keep their axis; buckets of ``1 << 14`` bytes, AdamW.

    python -m bagua_tpu_torch.examples.llama_pretrain --device cpu --steps 5     # dp 2 x tp 2 x sp 2
    python -m bagua_tpu_torch.examples.llama_pretrain --device cpu --engine --dp 4 --tp 2 --sp 1
    python -m bagua_tpu_torch.examples.llama_pretrain --device cpu --engine --dp 4 --fsdp 2 --tp 1 \
        --sp 1 --algo zero
    python -m bagua_tpu_torch.examples.llama_pretrain --dp 1 --tp 1 --sp 4 --steps 10   # on the card

Started by the launcher (``python -m bagua_tpu_torch.distributed.run
--nproc_per_node W``, or any gang worker with ``MASTER_PORT`` set), either
mode forms its named group across the W processes, each holding ``size /
W`` of the mesh's ranks (:func:`bagua_tpu_torch.distributed.mesh_group`):
every process builds the same seed-0 weights and feeds its own ranks' rows
of each step's batch, and the result is bitwise the single controller's:

    PYTHONPATH=. python -m bagua_tpu_torch.distributed.run --nproc_per_node 2 \
        bagua_tpu_torch/examples/llama_pretrain.py --device cpu --dp 1 --tp 2 --sp 2 --steps 3
"""

import argparse
from typing import Optional

import numpy as np
import torch

from bagua_tpu_torch.communication import BaguaProcessGroup, ReduceOp, allreduce, axis_size, rank_id
from bagua_tpu_torch.distributed import mesh_group
from bagua_tpu_torch.mesh import MeshSpec
from bagua_tpu_torch.models.bert import one_rank
from bagua_tpu_torch.models.llama import LlamaConfig, init_llama, llama_7b_config, llama_loss_fn
from bagua_tpu_torch.parallel.ring_attention import zigzag_order
from bagua_tpu_torch.utils import resolve_device, tree_leaves, tree_map

#: the engine mode's bucket size, the JAX example's
ENGINE_BUCKET_BYTES = 1 << 14

#: optax.adamw's default weight decay (torch.optim.AdamW's is 1e-2)
WEIGHT_DECAY = 1e-4


def load_corpus(path, rng):
    """Char-level corpus: (token array, vocab size).  Synthetic fallback is a
    Markov-ish byte stream so the loss has real structure to learn."""
    if path:
        text = open(path, "r", encoding="utf-8", errors="replace").read()
        chars = sorted(set(text))
        lut = {c: i for i, c in enumerate(chars)}
        return np.array([lut[c] for c in text], dtype=np.int32), len(chars)
    n, vocab = 65536, 64
    toks = np.zeros(n, dtype=np.int32)
    for i in range(1, n):
        # next char depends on the previous one: learnable bigram structure
        toks[i] = (toks[i - 1] * 7 + rng.randint(0, 8)) % vocab
    return toks, vocab


def batches(toks, rng, batch, seq, steps):
    for _ in range(steps):
        idx = rng.randint(0, len(toks) - seq - 1, size=batch)
        yield np.stack([toks[i : i + seq] for i in idx])


def mesh_spec(dp: int, tp: int, sp: int) -> MeshSpec:
    """The JAX example's mesh, ``("dp", "tp", "sp")``, size-1 axes kept."""
    return MeshSpec({"dp": dp, "tp": tp, "sp": sp})


def mesh_axes(dp: int, tp: int, sp: int) -> dict:
    """Where two live axes of ``(dp, tp, sp)`` lie on a legacy ``(inter,
    intra)`` group, in the mesh's order (one live axis is intra):
    ``intra_size``, each of ``dp_axis``, ``tp_axis`` and ``sp_axis``
    (``"inter"``, ``"intra"`` or None for an axis of size 1), and
    ``avg_axis``, what the gradients and losses are averaged over (dp and
    sp, never tp).  Three live axes need the named mesh of
    :func:`mesh_spec`."""
    if dp > 1 and tp > 1 and sp > 1:
        raise ValueError(
            f"dp {dp} x tp {tp} x sp {sp} has three live axes, more than a legacy (inter, intra) "
            "group holds: build the group on mesh_spec(dp, tp, sp)"
        )
    live = [(name, size) for name, size in (("dp", dp), ("tp", tp), ("sp", sp)) if size > 1]
    names = {"dp_axis": None, "tp_axis": None, "sp_axis": None}
    if len(live) == 2:
        names[f"{live[0][0]}_axis"], names[f"{live[1][0]}_axis"] = "inter", "intra"
    elif len(live) == 1:
        names[f"{live[0][0]}_axis"] = "intra"
    intra_size = live[-1][1] if live else 1
    avg = tuple(a for a in (names["dp_axis"], names["sp_axis"]) if a is not None)
    return dict(intra_size=intra_size, avg_axis=avg, **names)


def shard_ids(ids, group: BaguaProcessGroup, device=None, dp_axis="inter",
              sp_axis="intra") -> torch.Tensor:
    """Global ``(batch, seq)`` ids, already in the ring's layout, as the
    rank-stacked ``(R, batch / dp, seq / sp)`` shards of JAX's ``P("dp",
    "sp")``: a rank holds the batch block of its ``dp_axis`` index and the
    sequence block of its ``sp_axis`` index (either axis None: the whole
    dim), replicated over any other axis.  ``R`` is this process's ranks
    (every rank of a single-controller group)."""
    ids = torch.as_tensor(np.asarray(ids), dtype=torch.int64)
    zero = torch.zeros(group.local_size, dtype=torch.int64)
    dp, sp = (axis_size(group, a) if a else 1 for a in (dp_axis, sp_axis))
    B, T = ids.shape
    blocks = ids.reshape(dp, B // dp, sp, T // sp).permute(0, 2, 1, 3)
    d = rank_id(group, dp_axis).cpu() if dp_axis else zero
    s = rank_id(group, sp_axis).cpu() if sp_axis else zero
    return blocks[d, s].to(device)


def replicate(params, size: int):
    """Every leaf of an unstacked tree copied to ``size`` ranks: ``(size,
    ...)`` leaves that take gradients."""
    return tree_map(lambda p: p.detach()[None].repeat(size, *([1] * p.dim())).requires_grad_(), params)


def make_optimizer(params, lr: float) -> torch.optim.Optimizer:
    """AdamW over the stacked leaves with optax.adamw's defaults; fused on
    the card, which keeps foreach's full-size temporaries off the memory."""
    leaves = tree_leaves(params)
    return torch.optim.AdamW(leaves, lr=lr, weight_decay=WEIGHT_DECAY,
                             fused=leaves[0].device.type == "cuda")


def train_step(params, optimizer, ids, loss_fn, group: Optional[BaguaProcessGroup] = None,
               axis=None):
    """One step on rank-stacked ``params`` (updated in place) and ids ``(R,
    b, t_local)``: ``losses.sum().backward()``, each gradient averaged over
    ``axis`` of ``group`` (None: every rank), then the optimizer step.
    Returns the per-rank losses averaged the same way, ``(R,)``.

    Through a ``psum`` (``allreduce(SUM)`` of the tp ranks' partials) the
    gradient of the summed losses carries every tp rank's cotangent: tp
    times the single-rank gradient where the tp ranks are replicas, as JAX's
    transpose of ``psum`` under ``check_vma=False`` gives.  It is not
    divided out."""
    losses = loss_fn(params, ids)
    losses.sum().backward()
    for leaf in tree_leaves(params):
        grad, leaf.grad = leaf.grad, None
        leaf.grad = _average(grad, group, axis)
        del grad
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return _average(losses.detach(), group, axis)


def _average(x: torch.Tensor, group, axis):
    if group is None or axis == ():
        return x
    return allreduce(x, ReduceOp.AVG, group, axis)


def model_config(args, vocab: int) -> LlamaConfig:
    """The twin's ``LlamaConfig``: the example's (``--hidden``, ``--layers``,
    ``max(2, 2 tp)`` heads, half as many K/V heads, a ``2 hidden`` MLP, the
    corpus's vocabulary) or, with ``--width 7b``, ``llama_7b_config``'s
    width at ``--layers``; tp over ``"tp"``, the zigzag ring over ``"sp"``
    where sp > 1, the Row projections fused under ``--tp-fused``."""
    mesh = dict(tp_size=args.tp, tp_axis="tp", sp_axis="sp" if args.sp > 1 else None,
                sp_layout="zigzag" if args.sp > 1 else "contiguous", tp_fused=args.tp_fused)
    if args.width == "7b":
        return llama_7b_config(num_layers=args.layers, **mesh)
    heads = max(2, 2 * args.tp)
    return LlamaConfig(
        vocab_size=vocab, hidden_size=args.hidden, num_layers=args.layers,
        num_heads=heads, num_kv_heads=heads // 2, intermediate_size=2 * args.hidden,
        max_position_embeddings=args.seq, **mesh,
    )


def build(args, vocab: int, device, group=None):
    """The named group (by default :func:`mesh_group`'s: set as the
    default, across the gang under the launcher), config, model and this
    process's ranks' stacked parameters of ``args``."""
    if group is None:
        group = mesh_group(mesh_spec(args.dp, args.tp, args.sp), device)
    cfg = model_config(args, vocab)
    model, params = init_llama(cfg, torch.Generator(device=device).manual_seed(0), device, group)
    return group, cfg, model, replicate(params, group.local_size)


def engine_loss_fn(model):
    """One rank's loss as the engine's ``vmap`` calls it: ``loss(params,
    ids (b, t))`` through the rank-stacked model with a rank axis of one."""
    stacked_loss = llama_loss_fn(model)

    def loss_fn(params, ids):
        return stacked_loss(one_rank(params), ids[None])[0]

    return loss_fn


def engine_axes(args) -> dict:
    """The engine mode's mesh ``{"dp"[, "fsdp"][, "tp"]}``, as the JAX
    example's ``run_engine`` builds it."""
    axes = {"dp": args.dp}
    if args.fsdp > 1:
        axes["fsdp"] = args.fsdp
    if args.tp > 1:
        axes["tp"] = args.tp
    return axes


def make_engine(args, loss_fn, optimizer, group):
    """The example's ``DistributedDataParallel``: ZeRO under ``--algo
    zero``, else ``gradient_allreduce``; overlap on, ``1 << 14``-byte
    buckets, each role keyword naming its axis where the mesh has it."""
    from bagua_tpu_torch.algorithms.gradient_allreduce import GradientAllReduceAlgorithm
    from bagua_tpu_torch.ddp import DistributedDataParallel
    from bagua_tpu_torch.sharded.algorithm import ZeroAlgorithm

    algo = ZeroAlgorithm() if args.algo == "zero" else GradientAllReduceAlgorithm()
    return DistributedDataParallel(
        loss_fn, optimizer, algo, process_group=group,
        bucket_size_bytes=ENGINE_BUCKET_BYTES, overlap=True,
        dp_axis="dp", fsdp_axis="fsdp" if args.fsdp > 1 else None,
        tp_axis="tp" if args.tp > 1 else None,
    )


def engine(args, device, params=None, group=None):
    """The engine mode's ``(ddp, state, vocab)`` on a named group of
    ``args``' mesh (by default :func:`mesh_group`'s, set as the default
    group).  ``params``: an unstacked tree (``params_from_jax`` of the
    example's init), or None to draw it with seed 0."""
    if args.sp != 1:
        raise ValueError("--engine covers dp x tp / dp x fsdp; drop --sp")
    if group is None:
        group = mesh_group(MeshSpec(engine_axes(args)), device)
    vocab = load_corpus(args.data, np.random.RandomState(0))[1]
    cfg = model_config(args, vocab)
    model, drawn = init_llama(cfg, torch.Generator(device=device).manual_seed(0), device, group)
    model.requires_grad_(False)
    ddp = make_engine(args, engine_loss_fn(model), lambda ps: make_optimizer(ps, args.lr), group)
    state = ddp.init(params=drawn if params is None else tree_map(lambda t: t.to(device), params))
    return ddp, state, vocab


def run_engine(args, device, params=None):
    """The example's engine mode: ``(losses, state, ddp)``, this process's
    first rank's loss a step, the final state (pending ZeRO updates
    gathered) and the engine (shut down).  Each step feeds this process's
    rows of the global batch (``ddp.process_rows``)."""
    ddp, state, vocab = engine(args, device, params)
    losses = []
    try:
        for i, ids in enumerate(engine_batches(args)):
            ids = ddp.process_rows(torch.as_tensor(ids, dtype=torch.int64, device=device))
            state, step_losses = ddp.train_step(state, ids)
            losses.append(float(step_losses[0]))
            print(f"step {i}: loss {losses[-1]:.4f}", flush=True)
        state = ddp.finalize_pending_updates(state)
    finally:
        ddp.shutdown()
    print(f"final: engine mesh={engine_axes(args)} algo={args.algo} vocab={vocab} loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}", flush=True)
    assert np.isfinite(losses[-1])
    return losses, state, ddp


def engine_batches(args):
    """The engine mode's global ``(batch, seq)`` ids a step, numpy."""
    rng = np.random.RandomState(0)
    toks, _ = load_corpus(args.data, rng)
    return batches(toks, rng, args.batch, args.seq, args.steps)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", default=None, help="UTF-8 text file (char LM); synthetic if unset")
    p.add_argument("--dp", type=int, default=2)
    p.add_argument("--tp", type=int, default=2)
    p.add_argument("--sp", type=int, default=2)
    p.add_argument("--fsdp", type=int, default=1, help="engine mode only: fsdp axis size")
    p.add_argument("--engine", action="store_true",
                   help="drive the step through the DDP engine over a named MeshSpec mesh "
                   "(dp x tp / dp x fsdp) instead of the hand-scheduled step")
    p.add_argument("--algo", choices=("gradient_allreduce", "zero"), default="gradient_allreduce",
                   help="engine mode: exchange algorithm")
    p.add_argument("--seq", type=int, default=64, help="global sequence length")
    p.add_argument("--batch", type=int, default=8, help="global batch size")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--width", choices=("example", "7b"), default="example",
                   help="the example's width (--hidden) or llama_7b_config's")
    p.add_argument("--tp-fused", action="store_true",
                   help="the Row projections through the collective-matmul ring (matmul_rs)")
    p.add_argument("--device", default=None, help="the current CUDA device unless given")
    return p.parse_args(argv)


def hand_steps(args, device, params=None, group=None):
    """The hand-scheduled mode's pieces: ``(group, stacked, step, data,
    vocab)``.  ``step(ids)`` trains one step on a global ``(batch, seq)``
    batch in the ring's layout (each process takes its ranks' shards) and
    returns the per-rank losses averaged over dp and sp, ``(R,)``;
    ``data`` yields the example's global batches, zigzag-permuted where sp
    > 1.  ``params``: an unstacked tree (``params_from_jax`` of the
    example's init), or None to draw it with seed 0."""
    rng = np.random.RandomState(0)
    toks, vocab = load_corpus(args.data, rng)
    group, cfg, model, stacked = build(args, vocab, device, group)
    if params is not None:
        stacked = replicate(tree_map(lambda t: t.to(device), params), group.local_size)
    optimizer = make_optimizer(stacked, args.lr)
    loss_fn = llama_loss_fn(model)
    zz = zigzag_order(args.seq, args.sp) if args.sp > 1 else None

    def step(ids):
        shards = shard_ids(ids, group, device, "dp", "sp")
        return train_step(stacked, optimizer, shards, loss_fn, group, ("dp", "sp"))

    def data():
        for ids in batches(toks, rng, args.batch, args.seq, args.steps):
            # physical zigzag layout; the model assigns matching global
            # RoPE positions per rank
            yield ids if zz is None else ids[:, zz]

    return group, stacked, step, data(), vocab


def run(args, device, params=None):
    """The hand-scheduled mode: ``(losses, params)``, each step's loss
    (averaged over dp and sp; this process's first rank's) and the final
    rank-stacked parameters (this process's ranks)."""
    _, stacked, step, data, vocab = hand_steps(args, device, params)
    losses = []
    for i, ids in enumerate(data):
        losses.append(float(step(ids)[0]))
        print(f"step {i}: loss {losses[-1]:.4f}", flush=True)
    print(f"final: vocab={vocab} loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    assert np.isfinite(losses[-1])
    return losses, stacked


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.engine:
        return run_engine(args, device)[0]
    return run(args, device)[0]


if __name__ == "__main__":
    main()
