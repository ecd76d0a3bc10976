#!/usr/bin/env python3
"""Llama-style character-LM pretraining over a ``(dp, tp, sp)`` layout with
zigzag ring attention: the twin of the hand-scheduled mode of
``examples/llama_pretrain/main.py``.

* **dp** -- the batch is sharded over it.
* **tp** -- Megatron column/row sharding of the heads and the SwiGLU MLP;
  the Row projections sum over it (``psum``).
* **sp** -- each rank holds two globally non-adjacent half-blocks of every
  sequence (zigzag), and attention is the causal ring.

The port's group has two axes, so two of the three map onto ``(inter,
intra)`` in the JAX mesh's order (dp outer, then tp, then sp inner):
``--dp D --sp S`` (dp = inter, sp = intra), ``--dp 1 --tp T --sp S`` (tp =
inter, sp = intra) and ``--dp D --tp T --sp 1`` (dp = inter, tp = intra).
All three above 1 needs a three-axis group, which is not ported.

The step is the example's ``local_step``: every rank's loss, the gradient
of their sum with respect to each rank's copy of the parameters (in JAX
each device differentiates its own loss and the transposed ring shifts and
``psum``s bring the other ranks' cotangents back, which is the same), the
average over dp and sp (JAX's ``pmean`` over ``("dp", "sp")``; never over
tp), then AdamW with optax's defaults.  As in JAX, the model is built at
the local (``1 / tp``) shapes and every rank starts from that one tree, so
the tp ranks are replicas of one shard.  The engine mode is not ported.

    python -m bagua_tpu_torch.examples.llama_pretrain --device cpu --dp 2 --sp 2 --steps 5
    python -m bagua_tpu_torch.examples.llama_pretrain --device cpu --dp 1 --tp 2 --sp 2 --steps 5
    python -m bagua_tpu_torch.examples.llama_pretrain --dp 1 --sp 4 --steps 10   # on the card
"""

import argparse
from typing import Optional

import numpy as np
import torch

from bagua_tpu_torch.communication import BaguaProcessGroup, ReduceOp, allreduce, axis_size
from bagua_tpu_torch.models.llama import LlamaConfig, init_llama, llama_loss_fn
from bagua_tpu_torch.parallel.ring_attention import zigzag_order
from bagua_tpu_torch.utils import resolve_device, tree_leaves, tree_map

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


def mesh_axes(dp: int, tp: int, sp: int) -> dict:
    """Where the JAX mesh's ``("dp", "tp", "sp")`` axes lie on the port's
    ``(inter, intra)`` group: ``intra_size`` and each of ``dp_axis``,
    ``tp_axis`` and ``sp_axis`` (``"inter"``, ``"intra"`` or None for an
    axis of size 1), and ``avg_axis``, what the gradients and losses are
    averaged over (dp and sp, never tp)."""
    if dp > 1 and tp > 1 and sp > 1:
        raise NotImplementedError(
            f"dp {dp} x tp {tp} x sp {sp} needs a three-axis group (MeshSpec), which is not "
            "ported yet: keep one of --dp, --tp, --sp at 1"
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
    dim), replicated over any other axis."""
    ids = torch.as_tensor(np.asarray(ids), dtype=torch.int64)
    coord = {"inter": torch.arange(group.size) // group.intra_size,
             "intra": torch.arange(group.size) % group.intra_size}
    zero = torch.zeros(group.size, dtype=torch.int64)
    dp, sp = (axis_size(group, a) if a else 1 for a in (dp_axis, sp_axis))
    B, T = ids.shape
    blocks = ids.reshape(dp, B // dp, sp, T // sp).permute(0, 2, 1, 3)
    d = coord[dp_axis] if dp_axis else zero
    s = coord[sp_axis] if sp_axis else zero
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


def build(args, vocab: int, device):
    """The group, axes, config, model and stacked parameters of ``args``."""
    axes = mesh_axes(args.dp, args.tp, args.sp)
    group = BaguaProcessGroup([device] * (args.dp * args.tp * args.sp), intra_size=axes["intra_size"])
    heads = max(2, 2 * args.tp)
    cfg = LlamaConfig(
        vocab_size=vocab, hidden_size=args.hidden, num_layers=args.layers,
        num_heads=heads, num_kv_heads=heads // 2, intermediate_size=2 * args.hidden,
        max_position_embeddings=args.seq, tp_size=args.tp, tp_axis=axes["tp_axis"] or "intra",
        sp_axis=axes["sp_axis"],
        sp_layout="zigzag" if args.sp > 1 else "contiguous",
    )
    model, params = init_llama(cfg, torch.Generator(device=device).manual_seed(0), device, group)
    return group, axes, cfg, model, replicate(params, group.size)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", default=None, help="UTF-8 text file (char LM); synthetic if unset")
    p.add_argument("--dp", type=int, default=2)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=2)
    p.add_argument("--seq", type=int, default=64, help="global sequence length")
    p.add_argument("--batch", type=int, default=8, help="global batch size")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--device", default=None, help="the current CUDA device unless given")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    rng = np.random.RandomState(0)
    toks, vocab = load_corpus(args.data, rng)
    group, axes, cfg, model, params = build(args, vocab, device)
    optimizer = make_optimizer(params, args.lr)
    loss_fn = llama_loss_fn(model)
    zz = zigzag_order(args.seq, args.sp) if args.sp > 1 else None
    first = last = None
    for i, ids in enumerate(batches(toks, rng, args.batch, args.seq, args.steps)):
        if zz is not None:
            ids = ids[:, zz]  # physical zigzag layout; the model assigns
            # matching global RoPE positions per rank
        shards = shard_ids(ids, group, device, axes["dp_axis"], axes["sp_axis"])
        losses = train_step(params, optimizer, shards, loss_fn, group, axes["avg_axis"])
        last = float(losses[0])
        first = first if first is not None else last
        print(f"step {i}: loss {last:.4f}", flush=True)
    print(f"final: vocab={vocab} loss {first:.4f} -> {last:.4f}", flush=True)
    assert np.isfinite(last)


if __name__ == "__main__":
    main()
