#!/usr/bin/env python3
"""SQuAD BERT finetune: the twin of the JAX package's
``examples/squad/main.py`` (BASELINE config 3, "BERT-Large SQuAD finetune
with ByteGrad 8-bit compression"), on its synthetic path (the reference's
CI path).

    python3 -m bagua_tpu_torch.examples.squad --device cpu --ranks 4 --steps 3   # BERT-mini
    python3 -m bagua_tpu_torch.examples.squad --large --ranks 4 --steps 20      # BERT-Large, one card

BERT with a span head (``qa_outputs``, a ``Dense(2)``), trained by
``DistributedDataParallel(qa_loss_fn, Adam(3e-4), ByteGrad)`` on synthetic
QA batches drawn from ``numpy.random.RandomState(0)`` in the JAX example's
order, so both packages see the same batches.  ``--large`` is BERT-Large
at bf16 compute with ``max_position_embeddings = --seq``; without it the
JAX example's BERT-mini (hidden 64, 2 layers, 4 heads, vocab 1000), f32.
Weights from seed 0.

The group defaults to one rank per visible card; ``--ranks N`` places N
ranks on ``--device``.  Every rank is its own node (``intra_size=1``), so
that ByteGrad compresses the whole exchange: its hierarchical mode reduces
inside a node in full precision, and the JAX example's one-host group
compresses nothing.  The real-data path
(``--data``, the JAX example's ``load_real_squad``) needs the
``tokenizers`` package and a SQuAD file, which this package does not ship;
it raises.
"""

import argparse
import time
from typing import List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from bagua_tpu_torch.algorithms import build_algorithm
from bagua_tpu_torch.communication import init_process_group
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.models.bert import (
    BertConfig, BertModel, _f32_dense, bert_large_config, init_bert, one_rank,
)
from bagua_tpu_torch.utils import resolve_device

LR = 3e-4


class BertForQuestionAnswering(nn.Module):
    """Encoder + ``qa_outputs`` (``Dense(2)``, f32): start and end logits
    ``(R, b, t)`` each."""

    def __init__(self, cfg: BertConfig, group=None, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.group = cfg, group
        self.bert = BertModel(cfg, group, device, generator)
        self.qa_outputs = _f32_dense(cfg.hidden_size, 2, device, generator)

    def forward(self, params, input_ids, attention_mask=None):
        h = self.bert(params["bert"], input_ids, attention_mask=attention_mask)
        logits = self.qa_outputs(params["qa_outputs"], h)
        return logits[..., 0], logits[..., 1]


def qa_loss_fn(model: BertForQuestionAnswering):
    """``loss_fn(params, (ids, mask, starts, ends))``: one rank's span loss,
    as the engine calls it under ``vmap``: the logits of padded positions
    set to -1e9, then the mean of the start and end cross entropies."""

    def loss_fn(params, batch):
        ids, mask, starts, ends = batch
        s_logits, e_logits = model(one_rank(params), ids[None], attention_mask=mask[None])
        s_logits = torch.where(mask, s_logits[0], -1e9)
        e_logits = torch.where(mask, e_logits[0], -1e9)

        def ce(logits, pos):
            logp = F.log_softmax(logits, dim=-1)
            return -torch.mean(torch.gather(logp, 1, pos[:, None].long()))

        return 0.5 * (ce(s_logits, starts) + ce(e_logits, ends))

    return loss_fn


def synthetic_squad(rng: np.random.RandomState, n: int, seq: int, vocab: int):
    """``n`` QA features of ``seq`` tokens, drawn as the JAX example draws
    them: ``(ids int32, mask bool, starts int32, ends int32)``, with the
    answer's first and last tokens marked by ids 2 and 3."""
    ids = rng.randint(5, vocab, (n, seq)).astype(np.int32)
    lengths = rng.randint(seq // 2, seq, n)
    mask = np.arange(seq)[None, :] < lengths[:, None]
    starts = (rng.rand(n) * (lengths - 2)).astype(np.int32)
    spans = rng.randint(1, 5, n)
    ends = np.minimum(starts + spans, lengths - 1).astype(np.int32)
    for i in range(n):
        ids[i, starts[i]] = 2
        ids[i, ends[i]] = 3
    return ids, mask, starts, ends


def squad_config(large: bool, seq: int) -> BertConfig:
    """BERT-Large at bf16 compute, or the JAX example's BERT-mini in f32."""
    if large:
        return bert_large_config(compute_dtype=torch.bfloat16, max_position_embeddings=seq)
    return BertConfig(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4,
                      intermediate_size=128, max_position_embeddings=seq)


def run(model: BertForQuestionAnswering, params, group, steps: int, batch_size: int = 8,
        seq: int = 128, log_every: int = 10, on_step=None):
    """``steps`` ByteGrad + Adam steps of ``model`` from ``params`` on
    synthetic batches of ``batch_size`` per rank, printing the JAX example's
    lines (a loss every ``log_every`` steps).  ``on_step(i, state, ddp)``
    runs before step i (from 0) and returns the state the step takes, as in
    :func:`~bagua_tpu_torch.examples.synthetic_benchmark.run`.  Returns
    ``(losses, state, ddp)``: every step's per-rank losses, the final state
    and the engine."""
    ddp = DistributedDataParallel(qa_loss_fn(model), lambda ps: torch.optim.Adam(ps, lr=LR),
                                  build_algorithm("bytegrad"), process_group=group)
    losses: List[torch.Tensor] = []
    try:
        state = ddp.init(params)
        rng = np.random.RandomState(0)
        bs = batch_size * group.size
        for step in range(steps):
            if on_step is not None:
                state = on_step(step, state, ddp)
            batch = tuple(torch.from_numpy(a) for a in synthetic_squad(rng, bs, seq, model.cfg.vocab_size))
            state, step_losses = ddp.train_step(state, batch)
            losses.append(step_losses)
            if step % log_every == 0:
                print(f"step {step}: loss {float(step_losses.mean()):.4f}", flush=True)
    finally:
        ddp.shutdown()
    print(f"final loss {float(losses[-1].mean()):.6f}", flush=True)
    return losses, state, ddp


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--large", action="store_true")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=8, help="per rank")
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--data", default=None,
                   help="path to SQuAD train-v1.1.json (not supported: needs the tokenizers package)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--ranks", type=int, default=None,
                   help="place this many ranks on --device (default: one rank per visible card)")
    args = p.parse_args(argv)
    if args.data:
        raise NotImplementedError(
            "the real SQuAD path needs the tokenizers package and a SQuAD file, neither of which "
            "this package has; run without --data for the synthetic batches")

    if args.ranks is None and args.device == "cuda":
        group = init_process_group(intra_size=1)
    else:
        device = resolve_device(None if args.device == "cuda" else "cpu")
        group = init_process_group([device] * (args.ranks or 1), intra_size=1)
    cfg = squad_config(args.large, args.seq)
    model, params = init_bert(cfg, torch.Generator(device=group.device).manual_seed(0), group.device,
                              model_cls=BertForQuestionAnswering)
    t0 = time.perf_counter()
    losses, _, _ = run(model, params, group, args.steps, args.batch_size, args.seq)
    print(f"{args.steps} steps in {time.perf_counter() - t0:.1f} s", flush=True)
    return float(losses[-1].mean())


if __name__ == "__main__":
    main()
