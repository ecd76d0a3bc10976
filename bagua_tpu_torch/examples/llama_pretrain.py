#!/usr/bin/env python3
"""Llama-style character-LM pretraining over a ``(dp, sp)`` group with
zigzag ring attention: the twin of the hand-scheduled mode of
``examples/llama_pretrain/main.py``.

* **dp** -- the ``inter`` axis of the group: the batch is sharded over it.
* **sp** -- the ``intra`` axis: each rank holds two globally non-adjacent
  half-blocks of every sequence (zigzag), and attention is the causal ring.

The step is the example's ``local_step``: every rank's loss, the gradient
of their sum with respect to each rank's copy of the parameters (in JAX
each device differentiates its own loss and the transposed ring shifts
bring the other ranks' cotangents back, which is the same), the average
over both axes (JAX's ``pmean`` over ``("dp", "sp")``), then AdamW with
optax's defaults.  Tensor parallelism (``--tp``) and the engine mode are
not ported.

    python -m bagua_tpu_torch.examples.llama_pretrain --device cpu --dp 2 --sp 2 --steps 5
    python -m bagua_tpu_torch.examples.llama_pretrain --dp 1 --sp 4 --steps 10   # on the card
"""

import argparse
from typing import Optional

import numpy as np
import torch

from bagua_tpu_torch.communication import BaguaProcessGroup, ReduceOp, allreduce
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


def shard_ids(ids, group: BaguaProcessGroup, device=None) -> torch.Tensor:
    """Global ``(batch, seq)`` ids, already in the ring's layout, as the
    rank-stacked ``(R, batch / dp, seq / sp)`` shards of JAX's ``P("dp",
    "sp")``: rank ``inter * sp + intra`` holds batch block ``inter`` and
    sequence block ``intra``."""
    ids = torch.as_tensor(np.asarray(ids), dtype=torch.int64)
    dp, sp = group.inter_size, group.intra_size
    B, T = ids.shape
    shards = ids.reshape(dp, B // dp, sp, T // sp).permute(0, 2, 1, 3)
    return shards.reshape(group.size, B // dp, T // sp).to(device)


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


def train_step(params, optimizer, ids, loss_fn, group: Optional[BaguaProcessGroup] = None):
    """One step on rank-stacked ``params`` (updated in place) and ids ``(R,
    b, t_local)``: ``losses.sum().backward()``, each gradient averaged over
    every rank of ``group``, then the optimizer step.  Returns the per-rank
    losses averaged over the group, ``(R,)``."""
    losses = loss_fn(params, ids)
    losses.sum().backward()
    for leaf in tree_leaves(params):
        grad, leaf.grad = leaf.grad, None
        leaf.grad = allreduce(grad, ReduceOp.AVG, group) if group is not None else grad
        del grad
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    losses = losses.detach()
    return allreduce(losses, ReduceOp.AVG, group) if group is not None else losses


def build(args, vocab: int, device):
    """The group, config, model and stacked parameters of ``args``."""
    if args.tp != 1:
        raise NotImplementedError("tensor parallelism is not ported yet: use --tp 1")
    group = BaguaProcessGroup([device] * (args.dp * args.sp), intra_size=args.sp)
    heads = 2
    cfg = LlamaConfig(
        vocab_size=vocab, hidden_size=args.hidden, num_layers=args.layers,
        num_heads=heads, num_kv_heads=heads // 2, intermediate_size=2 * args.hidden,
        max_position_embeddings=args.seq,
        sp_axis="intra" if args.sp > 1 else None,
        sp_layout="zigzag" if args.sp > 1 else "contiguous",
    )
    model, params = init_llama(cfg, torch.Generator(device=device).manual_seed(0), device, group)
    return group, cfg, model, replicate(params, group.size)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", default=None, help="UTF-8 text file (char LM); synthetic if unset")
    p.add_argument("--dp", type=int, default=2)
    p.add_argument("--tp", type=int, default=1, help="must be 1: tensor parallelism is not ported")
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
    group, cfg, model, params = build(args, vocab, device)
    optimizer = make_optimizer(params, args.lr)
    loss_fn = llama_loss_fn(model)
    zz = zigzag_order(args.seq, args.sp) if args.sp > 1 else None
    first = last = None
    for i, ids in enumerate(batches(toks, rng, args.batch, args.seq, args.steps)):
        if zz is not None:
            ids = ids[:, zz]  # physical zigzag layout; the model assigns
            # matching global RoPE positions per rank
        losses = train_step(params, optimizer, shard_ids(ids, group, device), loss_fn, group)
        last = float(losses[0])
        first = first if first is not None else last
        print(f"step {i}: loss {last:.4f}", flush=True)
    print(f"final: vocab={vocab} loss {first:.4f} -> {last:.4f}", flush=True)
    assert np.isfinite(last)


if __name__ == "__main__":
    main()
