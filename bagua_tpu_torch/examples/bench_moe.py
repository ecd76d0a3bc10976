#!/usr/bin/env python3
"""MoE transformer training throughput: the twin of the JAX package's
``bench_moe.py``.

The same model at the same widths: 8 pre-LN blocks of hidden 512 over 128
tokens, each an 8-head self-attention and a top-2 MoE FFN (8 experts,
capacity factor 1.25, ``ep_size`` 1: every expert on every rank), vocab
8192, bf16 compute; ``gradient_allreduce`` + Adam 1e-3 on one synthetic
batch from ``numpy.random.RandomState(0)``, 2 warm-up steps, then 12
timed steps ending when the card is idle.  It prints the
``moe_fused_a2a_step_ms`` row (the MoE block's forward at ``ep_size`` = the
group's size, ``a2a_chunks`` 4 against 1, 512 tokens a rank) and then the
``moe_samples_per_sec_per_chip`` line, as JSON.

    python3 -m bagua_tpu_torch.examples.bench_moe --ranks 4 --intra-size 1
    python3 -m bagua_tpu_torch.examples.bench_moe --device cpu --ranks 2 --hidden 64 --layers 2 --vocab 256 --seq 16 --batch 2

Precision is flax's, as the JAX model runs it: the embedding table is cast
to bf16 before the lookup; LayerNorm (``dtype=bf16``) takes f32 statistics
and returns bf16; attention follows ``nn.SelfAttention``'s order of
operations in plain torch ops (the query scaled by 1/sqrt(64) first, a bf16
einsum, ``jax.nn.softmax``'s bf16 steps, a bf16 einsum; no fused attention
or fused softmax, which round once where flax rounds each step); the MoE block returns f32, so from the first block on the
residual stream is f32; the logits are cast to f32.
"""

import argparse
import dataclasses
import json
import time
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from bagua_tpu_torch.algorithms import build_algorithm
from bagua_tpu_torch.communication import ALL_AXES, init_process_group
from bagua_tpu_torch.ddp import DistributedDataParallel, TrainState
from bagua_tpu_torch.models.llama import module_params
from bagua_tpu_torch.parallel.moe import MoE
from bagua_tpu_torch.utils import dotted_leaves, lecun_normal, resolve_device

HIDDEN, LAYERS, SEQ, EXPERTS, TOP_K = 512, 8, 128, 8, 2
VOCAB = 8192
HEADS = 8
CAPACITY_FACTOR = 1.25
FUSED_TOKENS = 512  # a rank, in the fused all-to-all row
TIMED_STEPS = 12


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=dtype)``: f32 statistics (``E[x^2] -
    E[x]^2``, clipped at zero), eps 1e-6, the result cast to ``dtype``."""

    def __init__(self, features: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        return ((xf - mean) * (torch.rsqrt(var + 1e-6) * self.scale) + self.bias).to(self.dtype)


class _DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral`` in ``dtype``: ``kernel`` of shape
    ``in_shape + out_shape`` (f32), contracted over the input's trailing
    ``len(in_shape)`` dims."""

    def __init__(self, in_shape, out_shape, dtype, device, generator):
        super().__init__()
        fan_in = int(np.prod(in_shape))
        self.in_shape, self.out_shape, self.dtype = tuple(in_shape), tuple(out_shape), dtype
        self.kernel = nn.Parameter(lecun_normal((*in_shape, *out_shape), fan_in, device=device,
                                                generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_shape, device=device))

    def forward(self, x):
        lead = x.shape[:x.dim() - len(self.in_shape)]
        k = self.kernel.to(self.dtype).reshape(-1, int(np.prod(self.out_shape)))
        y = (x.to(self.dtype).reshape(*lead, -1) @ k).reshape(*lead, *self.out_shape)
        return y + self.bias.to(self.dtype)


def _flax_softmax(x):
    """``jax.nn.softmax`` over the last dim as its ops run, each rounded to
    the input's type, and differentiated through them as JAX does
    (``torch.softmax`` rounds once, which moves a bf16 gate input by a step
    and a token to another expert)."""
    u = torch.exp(x - x.amax(dim=-1, keepdim=True).detach())
    return u / u.sum(dim=-1, keepdim=True)


class SelfAttention(nn.Module):
    """flax ``nn.SelfAttention(num_heads, dtype, deterministic=True)``."""

    def __init__(self, features: int, heads: int, dtype, device, generator):
        super().__init__()
        head_dim = features // heads
        self.dtype = dtype
        for name in ("query", "key", "value"):
            self.add_module(name, _DenseGeneral((features,), (heads, head_dim), dtype, device, generator))
        self.out = _DenseGeneral((heads, head_dim), (features,), dtype, device, generator)

    def forward(self, x):  # (b, t, features)
        q, k, v = self.query(x), self.key(x), self.value(x)  # (b, t, h, d)
        q = q / torch.tensor(q.shape[-1] ** 0.5, dtype=q.dtype)
        w = _flax_softmax(torch.einsum("bqhd,bkhd->bhqk", q, k))
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))


class Block(nn.Module):
    def __init__(self, hidden, dtype, group, device, generator):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(hidden, dtype, device)
        self.SelfAttention_0 = SelfAttention(hidden, HEADS, dtype, device, generator)
        self.LayerNorm_1 = LayerNorm(hidden, dtype, device)
        # ep_size=1: all experts local, as the JAX bench runs it
        self.MoE_0 = MoE(hidden, hidden, EXPERTS, k=TOP_K, capacity_factor=CAPACITY_FACTOR, ep_size=1,
                         ep_axis=ALL_AXES, group=group, device=device, generator=generator)

    def forward(self, x):
        x = x + self.SelfAttention_0(self.LayerNorm_0(x))
        moe_out, l_aux = self.MoE_0(self.LayerNorm_1(x))
        return x + moe_out, l_aux


class Model(nn.Module):
    """Embed -> ``layers`` blocks -> LayerNorm -> Dense(vocab); returns f32
    logits and the blocks' mean balance loss."""

    def __init__(self, hidden=HIDDEN, layers=LAYERS, vocab=VOCAB, dtype=torch.bfloat16, group=None,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.layers, self.dtype = layers, dtype
        self.Embed_0 = nn.Module()
        table = torch.empty((vocab, hidden), device=device)
        self.Embed_0.embedding = nn.Parameter(nn.init.normal_(table, 0.0, hidden ** -0.5, generator=generator))
        for i in range(layers):
            self.add_module(f"Block_{i}", Block(hidden, dtype, group, device, generator))
        self.LayerNorm_0 = LayerNorm(hidden, dtype, device)
        self.Dense_0 = _DenseGeneral((hidden,), (vocab,), dtype, device, generator)

    def forward(self, tokens):
        x = F.embedding(tokens.long(), self.Embed_0.embedding.to(self.dtype))
        aux = 0.0
        for i in range(self.layers):
            x, l_aux = getattr(self, f"Block_{i}")(x)
            aux = aux + l_aux
        return self.Dense_0(self.LayerNorm_0(x)).to(torch.float32), aux / self.layers


def loss_fn(model: Model):
    """Next-token cross-entropy against the batch's targets + 0.01 x the
    mean balance loss."""

    def fn(params, batch):
        tokens, targets = batch
        logits, l_aux = functional_call(model, dotted_leaves(params), (tokens,))
        logp = F.log_softmax(logits, dim=-1)
        return -torch.mean(torch.gather(logp, -1, targets[..., None].long())) + 0.01 * l_aux

    return fn


@dataclasses.dataclass
class BenchResult:
    value: float  # samples/s/chip
    step_seconds: float  # mean over the timed steps
    steps: int
    losses: torch.Tensor
    state: TrainState
    ddp: DistributedDataParallel
    batch: Any


def _wait(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(group, batch_per_chip=32, hidden=HIDDEN, layers=LAYERS, vocab=VOCAB, seq=SEQ,
        dtype=torch.bfloat16) -> BenchResult:
    """Train the bench model (weights from seed 0) over ``group``: 2
    warm-ups, then TIMED_STEPS timed steps (the JAX bench's 12, its
    deadline never reached)."""
    device = group.device
    model = Model(hidden, layers, vocab, dtype, group, device, torch.Generator(device=device).manual_seed(0))
    rng = np.random.RandomState(0)
    n = batch_per_chip * group.size
    batch = (torch.from_numpy(rng.randint(0, vocab, (n, seq)).astype(np.int32)).to(device),
             torch.from_numpy(rng.randint(0, vocab, (n, seq)).astype(np.int32)).to(device))
    ddp = DistributedDataParallel(loss_fn(model), lambda ps: torch.optim.Adam(ps, lr=1e-3),
                                  build_algorithm("gradient_allreduce"), process_group=group)
    try:
        state = ddp.init(module_params(model))
        for _ in range(2):  # warm-ups
            state, losses = ddp.train_step(state, batch)
        _wait(device)
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            state, losses = ddp.train_step(state, batch)
        _wait(device)
        elapsed = time.perf_counter() - t0
    finally:
        ddp.shutdown()
    return BenchResult(n * TIMED_STEPS / elapsed / group.size, elapsed / TIMED_STEPS, TIMED_STEPS, losses, state,
                       ddp, batch)


def fused_a2a_row(group, hidden=HIDDEN, tokens=FUSED_TOKENS, iters=10) -> dict:
    """The MoE block's forward at ``ep_size`` = the group's size with
    ``a2a_chunks`` 4 against 1 (the JAX bench's fused-collective row): the
    ranks' ``tokens`` tokens each, f32, one ``torch.func.vmap`` over the
    stacked input, the same weights on every rank; ms per forward."""
    n, device = group.size, group.device
    num_experts = n * max(1, EXPERTS // n)
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(n, tokens, hidden).astype(np.float32)).to(device)

    def step_ms(chunks):
        moe = MoE(hidden, hidden, num_experts, k=TOP_K, capacity_factor=CAPACITY_FACTOR, ep_size=n,
                  ep_axis=ALL_AXES, a2a_chunks=chunks, group=group, device=device,
                  generator=torch.Generator(device=device).manual_seed(0))
        params = dotted_leaves(module_params(moe))
        fn = torch.func.vmap(lambda xx: functional_call(moe, params, (xx,))[0])
        with torch.no_grad():
            fn(x)
            _wait(device)
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(x)
            _wait(device)
        return (time.perf_counter() - t0) / iters * 1e3

    mono, chunked = step_ms(1), step_ms(4)
    return {
        "metric": "moe_fused_a2a_step_ms", "value": round(chunked, 3),
        "unit": "ms/step (ep-sharded MoE forward)", "a2a_chunks": 4, "unchunked_ms": round(mono, 3),
        "speedup": round(mono / chunked, 3) if chunked else None, "ep_size": n, "provisional": True,
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=32, help="per rank")
    p.add_argument("--hidden", type=int, default=HIDDEN)
    p.add_argument("--layers", type=int, default=LAYERS)
    p.add_argument("--vocab", type=int, default=VOCAB)
    p.add_argument("--seq", type=int, default=SEQ)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--ranks", type=int, default=None,
                   help="place this many ranks on --device (default: one rank per visible card)")
    p.add_argument("--intra-size", type=int, default=None, help="ranks on the fast inner axis")
    args = p.parse_args(argv)

    if args.ranks is None and args.device == "cuda":
        group = init_process_group(intra_size=args.intra_size)
    else:
        device = resolve_device(None if args.device == "cuda" else "cpu")
        group = init_process_group([device] * (args.ranks or 1), intra_size=args.intra_size)
    result = run(group, args.batch, args.hidden, args.layers, args.vocab, args.seq)
    if group.size > 1:
        print(json.dumps(fused_a2a_row(group, args.hidden)), flush=True)
    smoke = (args.batch, args.hidden, args.layers, args.vocab, args.seq) != (32, HIDDEN, LAYERS, VOCAB, SEQ)
    config = f"hidden{args.hidden} L{args.layers} seq{args.seq} {EXPERTS}experts top{TOP_K}"
    print(json.dumps({"metric": "moe_samples_per_sec_per_chip", "value": round(result.value, 2),
                      "unit": "samples/s/chip", "config": ("SMOKE " if smoke else "") + config,
                      "vs_baseline": None}), flush=True)
    return result


if __name__ == "__main__":
    main()
