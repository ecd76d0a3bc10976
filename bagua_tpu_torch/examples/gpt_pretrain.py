#!/usr/bin/env python3
"""Pipeline-parallel GPT pretraining: the twin of the hand-scheduled mode of
``examples/gpt_pretrain/main.py``.

* **dp** -- the batch is sharded over it; gradients are averaged.
* **pp** -- uniform GPT stages (``--blocks-per-stage`` blocks each), one a
  rank, with ``--schedule 1f1b`` (:func:`~bagua_tpu_torch.parallel.pipeline.pipeline_train_1f1b`:
  stage inputs stashed, the backward recomputed, the LM head inside the
  loss) or ``gpipe`` (:func:`~bagua_tpu_torch.parallel.pipeline.pipeline_apply`
  and autograd through the schedule); the embedding and the head stay
  outside the pipeline, replicated.
* **tp** -- Megatron column/row parallelism inside every block.
* **sp** -- the contiguous causal ring over the sequence axis (the flash
  kernels on the card).

Gradient sync, as in the example: under 1F1B the embedding's backward is
fed by the input cotangents summed over pp and the head's gradients are
summed over pp; under GPipe the embedding's are summed over pp and the
head's averaged over dp, pp and sp; stage gradients are averaged over dp
and sp, as is the loss.  The gradient is that of the sum of every rank's
loss, taken through the port's differentiable collectives (what each JAX
device's gradient of its own loss is under ``check_vma=False``).  Three
Adam optimizers with optax's defaults at the example's rate (``LR``); the
stage's state is pp-local.

The group is the JAX mesh itself: a :class:`~bagua_tpu_torch.mesh.MeshSpec`
``{"dp", "pp", "tp", "sp"}`` in that order, axes of size 1 included
(:func:`mesh_spec`), ranks row-major over it as the JAX devices are; the
example's default is pp 2 x tp 2 x sp 2.

``--engine`` is the example's ``run_engine``: embed + stage + head as one
tree trained through the DDP engine on the named mesh ``{"dp"[, "fsdp"][,
"tp"]}`` (pp 1, sp 1), the bucketed exchange (``gradient_allreduce`` with
overlap, or ZeRO under ``--algo zero``) riding dp and fsdp only while the
blocks' tp collectives keep their axis; buckets of ``1 << 14`` bytes, Adam
1e-3.

    python -m bagua_tpu_torch.examples.gpt_pretrain --device cpu --steps 5      # pp 2 x tp 2 x sp 2
    python -m bagua_tpu_torch.examples.gpt_pretrain --device cpu --tp 1 --schedule gpipe
    python -m bagua_tpu_torch.examples.gpt_pretrain --device cpu --engine --dp 4 --tp 2 --pp 1 --sp 1
    python -m bagua_tpu_torch.examples.gpt_pretrain --device cpu --engine --dp 4 --fsdp 2 --tp 1 \\
        --pp 1 --sp 1 --algo zero
    python -m bagua_tpu_torch.examples.gpt_pretrain --pp 2 --sp 2 --vocab 50257 --hidden 768 \\
        --heads 12 --blocks-per-stage 6 --seq 1024 --microbatches 4    # GPT-2 small, on the card

Started by the launcher (``python -m bagua_tpu_torch.distributed.run
--nproc_per_node W``), either mode forms its named group across the W
processes (:func:`bagua_tpu_torch.distributed.mesh_group`), each holding
``size / W`` ranks, building the same seed-drawn weights and feeding its
own ranks' rows; the result is bitwise the single controller's.
"""

import argparse

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from bagua_tpu_torch.communication import ReduceOp, allreduce, rank_id
from bagua_tpu_torch.distributed import mesh_group
from bagua_tpu_torch.examples.llama_pretrain import engine_axes, make_engine, shard_ids
from bagua_tpu_torch.mesh import MeshSpec
from bagua_tpu_torch.models._layers import Embed, module_params
from bagua_tpu_torch.models.bert import one_rank
from bagua_tpu_torch.models.gpt import GPTBlock, GPTConfig
from bagua_tpu_torch.parallel.pipeline import pipeline_apply, pipeline_train_1f1b
from bagua_tpu_torch.parallel.tensor_parallel import stacked_matmul
from bagua_tpu_torch.utils import lecun_normal, resolve_device, tree_leaves, tree_map

#: the JAX example's mesh order
MESH = ("dp", "pp", "tp", "sp")
#: the example's ``optax.adam`` learning rate
LR = 1e-3


def mesh_spec(dp: int, pp: int, tp: int, sp: int) -> MeshSpec:
    """The JAX example's mesh, ``("dp", "pp", "tp", "sp")``, size-1 axes
    kept."""
    return MeshSpec(dict(zip(MESH, (dp, pp, tp, sp))))


class GPTStage(nn.Module):
    """A uniform chunk of GPT blocks, one pipeline stage (``block{i}``)."""

    def __init__(self, cfg: GPTConfig, n_blocks: int, group=None, device=None, generator=None):
        super().__init__()
        self.n_blocks = n_blocks
        for i in range(n_blocks):
            self.add_module(f"block{i}", GPTBlock(cfg, group, device, generator))

    def forward(self, params, x):
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(params[f"block{i}"], x)
        return x


class Head(nn.Module):
    """flax ``nn.Dense(vocab, use_bias=False)``: ``kernel (hidden, vocab)``."""

    def __init__(self, hidden: int, vocab: int, device=None, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(lecun_normal((hidden, vocab), hidden, device=device, generator=generator))


def head_loss(h_p, y, labels):
    """The LM head and the mean cross entropy of each rank: ``y (R, b, t,
    hidden)``, ``labels (R, b, t)`` -> ``(R,)``."""
    logp = F.log_softmax(stacked_matmul(y, h_p["kernel"]), dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0].mean(dim=(1, 2))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--pp", type=int, default=2)
    p.add_argument("--tp", type=int, default=2)
    p.add_argument("--sp", type=int, default=2)
    p.add_argument("--fsdp", type=int, default=1, help="engine mode only: fsdp axis size")
    p.add_argument("--engine", action="store_true",
                   help="drive the step through the DDP engine over a named MeshSpec mesh "
                   "(dp x tp / dp x fsdp) instead of the hand-scheduled step")
    p.add_argument("--algo", choices=("gradient_allreduce", "zero"), default="gradient_allreduce",
                   help="engine mode: exchange algorithm")
    p.add_argument("--vocab", type=int, default=128)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--seq", type=int, default=32, help="GLOBAL sequence length")
    p.add_argument("--blocks-per-stage", type=int, default=1)
    p.add_argument("--batch", type=int, default=8, help="global batch")
    p.add_argument("--microbatches", type=int, default=2)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--schedule", choices=["1f1b", "gpipe"], default="1f1b",
                   help="pipeline schedule: 1F1B (bounded memory, remat) or GPipe")
    p.add_argument("--device", default=None, help="the current CUDA device unless given")
    return p.parse_args(argv)


class Twin:
    """The example's model, parameters (rank-stacked, taking gradients) and
    optimizers on its named mesh; :meth:`step` is its ``local_step``.  ``params``: ``{"embed", "stage", "head"}`` rank-stacked
    (:func:`bagua_tpu_torch.convert.gpt_params_from_jax`), or None to draw
    them as the example does (seeds 0, 100 + s and 1)."""

    def __init__(self, args, device=None, params=None, group=None):
        self.args = args
        device = resolve_device(args.device if device is None else device)
        self.group = mesh_group(mesh_spec(args.dp, args.pp, args.tp, args.sp), device) if group is None else group
        self.cfg = gpt_config(args)
        self.stage = GPTStage(self.cfg, args.blocks_per_stage, self.group, device)
        self.embed = Embed(args.vocab, args.hidden, device)
        if params is None:
            params = self.init_params(device)
        self.params = tree_map(lambda t: t.detach().to(device).requires_grad_(), params)
        # the stage's moments are pp-local, as its parameters are
        self.optimizers = [torch.optim.Adam(tree_leaves(self.params[k]), lr=LR,
                                            fused=device.type == "cuda")
                           for k in ("embed", "stage", "head")]

    def pp_coord(self) -> torch.Tensor:
        return rank_id(self.group, "pp").cpu()

    def init_params(self, device):
        """Each pp stage drawn with its own seed, embed and head with theirs,
        flax's initializers in distribution; rank-stacked."""
        args = self.args

        def gen(seed):
            return torch.Generator(device=device).manual_seed(seed)

        stages = [module_params(GPTStage(self.cfg, args.blocks_per_stage, self.group, device, gen(100 + s)))
                  for s in range(args.pp)]
        rows = self.pp_coord()
        n = self.group.local_size
        return {
            "embed": tree_map(lambda t: t[None].repeat(n, 1, 1), module_params(Embed(args.vocab, args.hidden,
                                                                                     device, gen(0)))),
            "stage": tree_map(lambda *ts: torch.stack(ts)[rows.to(device)], *stages),
            "head": tree_map(lambda t: t[None].repeat(n, 1, 1), module_params(Head(args.hidden, args.vocab,
                                                                                   device, gen(1)))),
        }

    def shard(self, ids) -> torch.Tensor:
        """Global ``(batch, seq)`` as the rank-stacked ``P("dp", "sp")``
        shards."""
        return shard_ids(ids, self.group, self.group.device, "dp", "sp")

    def _avg(self, x, names):
        return allreduce(x, ReduceOp.AVG, self.group, names)

    def _sum(self, x, name):
        return allreduce(x, ReduceOp.SUM, self.group, name)

    def step(self, ids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """One training step on rank-stacked ``ids`` and ``labels`` ``(R,
        b_local, t_local)``; returns the per-rank losses averaged over dp
        and sp, ``(R,)``."""
        args, p = self.args, self.params
        R, b, t = ids.shape
        M, H = args.microbatches, args.hidden
        pp, pp_group = "pp", (None if args.pp == 1 else self.group)
        x = self.embed(p["embed"], ids)
        if args.schedule == "1f1b":
            micro = x.detach().reshape(R, M, b // M, t, H)
            loss, grads = pipeline_train_1f1b(
                self.stage, p["stage"], micro, labels.reshape(R, M, b // M, t), head_loss, pp_group, pp,
                loss_params=p["head"], with_input_grads=True)
            # input cotangents are real on pp rank 0: sum over pp, then pull
            # back through the embedding
            x.backward(self._sum(grads.inputs, "pp").reshape(R, b, t, H))
            g_embed = {"embedding": self._avg(p["embed"]["embedding"].grad, ("dp", "sp"))}
            g_head = tree_map(lambda g: self._avg(self._sum(g, "pp"), ("dp", "sp")), grads.loss_params)
            g_stage = tree_map(lambda g: self._avg(g, ("dp", "sp")), grads.stage)
        else:
            y = pipeline_apply(self.stage, p["stage"], x.reshape(R, M, b // M, t, H), pp_group, pp)
            loss = head_loss(p["head"], y.reshape(R, b, t, H), labels)
            loss.sum().backward()
            g_embed = tree_map(lambda t_: self._avg(self._sum(t_.grad, "pp"), ("dp", "sp")), p["embed"])
            g_stage = tree_map(lambda t_: self._avg(t_.grad, ("dp", "sp")), p["stage"])
            g_head = tree_map(lambda t_: self._avg(t_.grad, ("dp", "pp", "sp")), p["head"])
        for tree, grads_ in ((p["embed"], g_embed), (p["stage"], g_stage), (p["head"], g_head)):
            for leaf, g in zip(tree_leaves(tree), tree_leaves(grads_)):
                leaf.grad = g
        for opt in self.optimizers:
            opt.step()
            opt.zero_grad(set_to_none=True)
        return self._avg(loss.detach(), ("dp", "sp"))


def gpt_config(args, sp: bool = True) -> GPTConfig:
    """The example's ``GPTConfig``: tp over ``"tp"``, the ring over ``"sp"``
    where ``sp`` and the mesh has one."""
    return GPTConfig(
        vocab_size=args.vocab, hidden_size=args.hidden, num_layers=args.blocks_per_stage,
        num_heads=args.heads, max_position_embeddings=args.seq, tp_size=args.tp, tp_axis="tp",
        sp_axis="sp" if sp and args.sp > 1 else None,
    )


def batches(args):
    """The example's data: ``(ids, labels)`` a step, numpy, from seed 0."""
    data = np.random.RandomState(0).randint(0, args.vocab, size=(args.steps, args.batch, args.seq + 1))
    for i in range(args.steps):
        yield data[i, :, :-1], data[i, :, 1:]


def run(args, device=None, params=None):
    """``(losses, twin)``: each step's loss, and the trained twin."""
    twin = Twin(args, device, params)
    losses = []
    for i, (ids, labels) in enumerate(batches(args)):
        losses.append(float(twin.step(twin.shard(ids), twin.shard(labels))[0]))
        print(f"step {i}: loss {losses[-1]:.4f}", flush=True)
    return losses, twin


class EngineModel:
    """The engine mode's model: embed, one stage of ``--blocks-per-stage``
    blocks and the head, as one tree ``{"embed", "stage", "head"}`` (drawn
    with seeds 0, 100 and 1, as the example's ``run_engine``), and
    :meth:`loss`, one rank's loss as the engine's ``vmap`` calls it."""

    def __init__(self, args, group, device):
        def gen(seed):
            return torch.Generator(device=device).manual_seed(seed)

        cfg = gpt_config(args, sp=False)
        self.embed = Embed(args.vocab, args.hidden, device, gen(0))
        self.stage = GPTStage(cfg, args.blocks_per_stage, group, device, gen(100))
        self.head = Head(args.hidden, args.vocab, device, gen(1))
        for m in (self.embed, self.stage, self.head):
            m.requires_grad_(False)

    def params(self):
        return {"embed": module_params(self.embed), "stage": module_params(self.stage),
                "head": module_params(self.head)}

    def loss(self, params, batch):
        ids, labels = batch
        p = one_rank(params)
        x = self.stage(p["stage"], self.embed(p["embed"], ids[None]))
        return head_loss(p["head"], x, labels[None])[0]


def engine(args, device=None, params=None, group=None):
    """The engine mode's ``(ddp, state)`` on a named group of ``args``'
    mesh (by default :func:`mesh_group`'s, set as the default group).
    ``params``: an unstacked ``{"embed", "stage", "head"}`` tree
    (``params_from_jax`` of the example's), or None to draw it."""
    if args.pp != 1 or args.sp != 1:
        raise ValueError("--engine covers dp x tp / dp x fsdp; use the default mode for pp/sp")
    device = resolve_device(args.device if device is None else device)
    if group is None:
        group = mesh_group(MeshSpec(engine_axes(args)), device)
    model = EngineModel(args, group, device)
    ddp = make_engine(args, model.loss, lambda ps: torch.optim.Adam(ps, lr=LR, fused=device.type == "cuda"),
                      group)
    state = ddp.init(params=model.params() if params is None else tree_map(lambda t: t.to(device), params))
    return ddp, state


def run_engine(args, device=None, params=None):
    """The example's engine mode: ``(losses, state, ddp)``, this process's
    first rank's loss a step, the final state (pending ZeRO updates
    gathered) and the engine (shut down).  Each step feeds this process's
    rows of the global batch (``ddp.process_rows``)."""
    ddp, state = engine(args, device, params)
    device = ddp.group.device
    losses = []
    try:
        for i, (ids, labels) in enumerate(batches(args)):
            batch = ddp.process_rows((torch.as_tensor(ids, device=device), torch.as_tensor(labels, device=device)))
            state, step_losses = ddp.train_step(state, batch)
            losses.append(float(step_losses[0]))
            print(f"step {i}: loss {losses[-1]:.4f}", flush=True)
        state = ddp.finalize_pending_updates(state)
    finally:
        ddp.shutdown()
    print(f"final: engine mesh={engine_axes(args)} algo={args.algo}", flush=True)
    return losses, state, ddp


def main(argv=None):
    args = parse_args(argv)
    if args.engine:
        return run_engine(args)[0]
    losses, _ = run(args)
    return losses


if __name__ == "__main__":
    main()
