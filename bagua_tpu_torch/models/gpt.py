"""GPT-style causal decoder with optional ring-attention sequence
parallelism (the port of ``bagua_tpu/models/gpt.py``), and the
sequence-parallel position and loss helpers it shares with the Llama port.

Modules hold flax's parameter tree and names (``wte/embedding``,
``wpe/embedding``, ``block_i/{ln1,ln2}/{scale,bias}``,
``block_i/{qkv,out}/{kernel,bias}``, ``block_i/mlp/{ColumnParallelDense_0,
RowParallelDense_0}/{kernel,bias}``, ``ln_f/{scale,bias}``), created with
flax's initializers in distribution, so a flax tree converts unchanged
(:func:`bagua_tpu_torch.convert.params_from_jax`).  The forward is
functional and rank-stacked, as the Llama port's: ``model(params, ids)``
takes a tree whose every leaf is ``(R, ...)`` and ids ``(R, b, t_local)``
and returns ``(R, b, t_local, vocab)`` logits of the tied head.

Attention is the causal :func:`~bagua_tpu_torch.parallel.ring_attention.ring_attention`
with the layout ``cfg.sp_layout`` over ``cfg.sp_axis`` of the model's group
(the flash kernels on the card), else the plain
:func:`~bagua_tpu_torch.parallel.ring_attention._block_attention_local`, as
the JAX package computes it outside Pallas.  Under tensor parallelism the
``qkv`` and MLP-in layers are column-parallel and ``out`` and MLP-out
row-parallel over ``cfg.tp_axis`` (the ``psum`` path; the model never
fuses), built at the local shapes as flax's ``init`` builds them.

Precision follows flax's promotion: the token and position embeddings sum
in their own type and are cast to ``cfg.compute_dtype``; the
tensor-parallel layers hold their parameters in the compute type; a
LayerNorm returns f32 whatever its input, so under bf16 the residual stream
stays bf16 (``x + attn``) while each sublayer's input is f32 and cast back;
``ln_f`` runs on ``x`` cast to f32 and the tied head is ``x @ wte.T`` in
the promotion of the two types.

The helpers read the ``sp`` axis of a group passed explicitly; without one
(or without ``cfg.sp_axis``) every rank stands alone.  Positions and losses
are rank-stacked: one row per rank.
"""

import dataclasses
from typing import Any, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from bagua_tpu_torch.communication import axis_size, rank_id
from bagua_tpu_torch.models._layers import Embed, LayerNorm, module_params
from bagua_tpu_torch.parallel.ring_attention import _block_attention_local, ring_attention
from bagua_tpu_torch.parallel.tensor_parallel import (
    ColumnParallelDense, ParallelMLP, RowParallelDense, stacked_matmul,
)
from bagua_tpu_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 2048
    tp_size: int = 1
    #: the group axis the heads and the MLP are sharded over ("tp" of a
    #: named mesh, "inter" or "intra" of the legacy one); read only at
    #: tp_size > 1
    tp_axis: Union[str, Tuple[str, ...]] = "intra"
    #: the group axis the sequence is sharded over ("sp" of a named mesh,
    #: "inter" or "intra" of the legacy one)
    sp_axis: Union[str, Tuple[str, ...], None] = None
    #: "contiguous" or "zigzag" (the balanced causal ring layout; feed ids
    #: permuted with ``ring_attention.zigzag_order``)
    sp_layout: str = "contiguous"
    compute_dtype: Any = torch.float32


def _zigzag_active(cfg, group=None) -> bool:
    """Is the zigzag layout in effect (an ``sp`` axis of more than one
    rank)?  Otherwise zigzag degenerates to the identity layout, and
    positions, attention and the loss's seam mask all take the contiguous
    path together."""
    if cfg.sp_axis is None or cfg.sp_layout != "zigzag" or group is None:
        return False
    return axis_size(group, cfg.sp_axis) > 1


def _sp_positions(cfg, t_local: int, group=None, device=None) -> torch.Tensor:
    """Global position ids of each rank's local tokens: ``(R, t_local)``, or
    ``(1, t_local)`` where every rank holds positions ``0..t_local-1``."""
    local = torch.arange(t_local, device=device)
    if cfg.sp_axis is None or group is None:
        return local[None]
    r = rank_id(group, cfg.sp_axis).to(device)[:, None]
    if _zigzag_active(cfg, group):
        if t_local % 2:
            raise ValueError(
                f"zigzag sp layout needs an even local sequence length, got {t_local}"
            )
        sp = axis_size(group, cfg.sp_axis)
        t2 = t_local // 2
        return torch.cat([r * t2 + local[:t2], (2 * sp - 1 - r) * t2 + local[:t2]], dim=1)
    return r * t_local + local


class GPTBlock(nn.Module):
    """Pre-LN block: ``x + out(attn(qkv(ln1(x))))``, then ``x +
    mlp(ln2(x))``; ``x (R, b, t, hidden)``."""

    def __init__(self, cfg: GPTConfig, group=None, device=None, generator=None):
        super().__init__()
        if cfg.num_heads % cfg.tp_size:
            raise ValueError(f"num_heads ({cfg.num_heads}) must divide by tp_size ({cfg.tp_size})")
        self.cfg, self.group = cfg, group
        self.local_heads = cfg.num_heads // cfg.tp_size
        self.head_dim = cfg.hidden_size // cfg.num_heads
        tp = dict(tp_size=cfg.tp_size, tp_axis=cfg.tp_axis, dtype=cfg.compute_dtype, group=group,
                  device=device, generator=generator)
        self.ln1 = LayerNorm(cfg.hidden_size, device=device)
        self.qkv = ColumnParallelDense(cfg.hidden_size, 3 * cfg.hidden_size, **tp)
        self.out = RowParallelDense(self.local_heads * self.head_dim, cfg.hidden_size, **tp)
        self.ln2 = LayerNorm(cfg.hidden_size, device=device)
        self.mlp = ParallelMLP(cfg.hidden_size, 4 * cfg.hidden_size, cfg.hidden_size, **tp)

    def forward(self, params, x):
        cfg = self.cfg
        R, b, t, _ = x.shape
        h = self.ln1(params["ln1"], x)
        qkv = self.qkv(params["qkv"], h).reshape(R, b, t, 3, self.local_heads, self.head_dim)
        q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
        if cfg.sp_axis is not None:
            ctx = ring_attention(q, k, v, self.group, cfg.sp_axis, causal=True, layout=cfg.sp_layout)
        else:
            ctx = _block_attention_local(q.flatten(0, 1), k.flatten(0, 1), v.flatten(0, 1), causal=True)
        x = x + self.out(params["out"], ctx.reshape(R, b, t, self.local_heads * self.head_dim))
        return x + self.mlp(params["mlp"], self.ln2(params["ln2"], x))


class GPTModel(nn.Module):
    """Causal LM: token + position embeddings -> pre-LN blocks -> ``ln_f``
    -> the tied head ``x @ wte.T``.  ``group`` holds ``cfg.sp_axis`` and
    ``cfg.tp_axis``; parameters are built on ``device``, by default the
    current CUDA device (raises without one)."""

    def __init__(self, cfg: GPTConfig, group=None, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.group = cfg, group
        self.wte = Embed(cfg.vocab_size, cfg.hidden_size, device, generator)
        self.wpe = Embed(cfg.max_position_embeddings, cfg.hidden_size, device, generator)
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", GPTBlock(cfg, group, device, generator))
        self.ln_f = LayerNorm(cfg.hidden_size, device=device)

    def forward(self, params, input_ids):
        cfg = self.cfg
        R, _, t = input_ids.shape
        # the position table bounds the *global* sequence (sp ranks x local)
        sp = axis_size(self.group, cfg.sp_axis) if cfg.sp_axis is not None and self.group is not None else 1
        if sp * t > cfg.max_position_embeddings:
            raise ValueError(
                f"global sequence length {sp * t} exceeds the configured "
                f"max_position_embeddings ({cfg.max_position_embeddings})"
            )
        pos = _sp_positions(cfg, t, self.group, input_ids.device)
        x = self.wte(params["wte"], input_ids)
        x = (x + self.wpe(params["wpe"], pos.expand(R, t))[:, None]).to(cfg.compute_dtype)
        for i in range(cfg.num_layers):
            x = getattr(self, f"block_{i}")(params[f"block_{i}"], x)
        x = self.ln_f(params["ln_f"], x.to(torch.float32))
        wte = params["wte"]["embedding"]
        dtype = torch.promote_types(x.dtype, wte.dtype)
        return stacked_matmul(x.to(dtype), wte.to(dtype).transpose(1, 2))  # tied LM head


def init_gpt(cfg: GPTConfig, generator=None, device=None, group=None):
    """``(model, params)``: a :class:`GPTModel` and its unstacked flax-style
    parameter tree, drawn with flax's initializers in distribution."""
    model = GPTModel(cfg, group, device=device, generator=generator)
    return model, module_params(model)


def lm_loss_fn(model):
    """``loss_fn(params, ids) -> (R,)``: each rank's next-token cross
    entropy within its local block.  Under the zigzag layout the two local
    half-blocks are globally non-adjacent, so the seam pair (local ``t2-1 ->
    t2``) is masked out of the mean, which divides by ``b * (t - 2)``."""
    cfg, group = model.cfg, model.group

    def loss_fn(params, ids):
        logits = model(params, ids)
        logp = F.log_softmax(logits[:, :, :-1], dim=-1)
        nll = -torch.gather(logp, -1, ids[:, :, 1:, None].long())[..., 0]  # (R, b, t - 1)
        if _zigzag_active(cfg, group):
            t = ids.shape[2]
            if t < 4:
                raise ValueError(
                    f"zigzag LM loss needs a local sequence length >= 4 "
                    f"(seam masking leaves no targets at {t})"
                )
            keep = torch.arange(t - 1, device=ids.device) != (t // 2 - 1)  # drop the seam pair
            return (nll * keep).sum(dim=(1, 2)) / (nll.shape[1] * (t - 2))
        return nll.mean(dim=(1, 2))

    return loss_fn
