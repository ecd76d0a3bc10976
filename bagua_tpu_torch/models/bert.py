"""BERT encoder family (the port of ``bagua_tpu/models/bert.py``; BERT-Large
is the reference's second headline benchmark).

Post-LN layers: self-attention whose ``qkv`` projection is a
:class:`~bagua_tpu_torch.parallel.tensor_parallel.ColumnParallelDense` of
``3 * hidden`` and whose ``out`` projection is a ``RowParallelDense``, then
a :class:`~bagua_tpu_torch.parallel.tensor_parallel.ParallelMLP` (tanh
GELU); each sublayer's residual sum goes through a :class:`LayerNorm`.

Modules hold flax's parameter tree and names (``bert/word_embeddings/
embedding``, ``bert/layer_i/attention/{qkv,out}/{kernel,bias}``,
``bert/layer_i/{ln_attn,ln_ffn}/{scale,bias}``, ``bert/layer_i/mlp/
{ColumnParallelDense_0,RowParallelDense_0}``, ``mlm_transform``, ``mlm_ln``,
``mlm_decoder``), created with flax's initializers in distribution, so a
flax tree converts unchanged (:mod:`bagua_tpu_torch.convert`).  The
tensor-parallel layers hold their parameters in ``cfg.compute_dtype``, as
the JAX layers create them; embeddings, LayerNorms and the heads are f32.

The forward is functional and rank-stacked, as the Llama port's:
``model(params, ids, ...)`` takes a tree whose every leaf is ``(R, ...)``
and ids ``(R, b, t_local)``.  The data-parallel engine calls its loss once
per rank under ``torch.func.vmap``, where the rank axis is gone: the losses
here (:func:`mlm_loss_fn`, and the SQuAD twin's) add a rank axis of one
inside, so one model serves both.

Under sequence parallelism (``cfg.sp_axis``, an axis of the model's group)
attention is the non-causal :func:`~bagua_tpu_torch.parallel.ring_attention.ring_attention`
with the key-padding mask rotating beside its K/V block, and position ids
are offset by the rank's global block start.  Otherwise attention is
:func:`~bagua_tpu_torch.parallel.ring_attention._block_attention_local`,
plain torch, as the JAX package computes it in plain ``jnp``.

Precision follows flax's promotion: the embeddings sum in f32 and
``ln_embed`` casts to the compute type; a LayerNorm returns f32 whatever
its input (f32 scale and bias), so under bf16 compute each layer returns
f32 and the next ``qkv`` casts back; the encoder's output is f32.
"""

import dataclasses
from typing import Any, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from bagua_tpu_torch.communication import axis_size, rank_id
from bagua_tpu_torch.models._layers import Embed, LayerNorm, module_params  # noqa: F401  (re-exported)
from bagua_tpu_torch.parallel.ring_attention import _block_attention_local, ring_attention
from bagua_tpu_torch.parallel.tensor_parallel import (
    ColumnParallelDense, ParallelMLP, RowParallelDense, gelu,
)
from bagua_tpu_torch.utils import resolve_device, tree_map


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    tp_size: int = 1
    #: the group axis the heads and the MLP are sharded over ("tp" of a
    #: named mesh, "inter" or "intra" of the legacy one); read only at
    #: tp_size > 1
    tp_axis: Union[str, Tuple[str, ...]] = "intra"
    #: the group axis the sequence is sharded over (ring attention when set)
    sp_axis: Union[str, Tuple[str, ...], None] = None
    compute_dtype: Any = torch.float32

    def __post_init__(self):
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden_size ({self.hidden_size}) must divide by num_heads "
                             f"({self.num_heads})")
        if self.num_heads % self.tp_size:
            raise ValueError("num_heads must divide by tp_size")


def bert_large_config(**overrides) -> BertConfig:
    return BertConfig(**overrides)


def bert_base_config(**overrides) -> BertConfig:
    return BertConfig(hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072,
                      **overrides)


def _f32_dense(in_features: int, features: int, device, generator) -> ColumnParallelDense:
    """flax ``nn.Dense`` on an f32 input: the tp-1 column layer in f32
    (``kernel (in, features)`` lecun-normal, ``bias`` zeros)."""
    return ColumnParallelDense(in_features, features, dtype=torch.float32, device=device,
                               generator=generator)


def _sp_offset(cfg: BertConfig, t_local: int, group, device) -> torch.Tensor:
    """Global position offset of each rank's block under SP, ``(R, 1)``, or
    0 without an sp axis."""
    if cfg.sp_axis is None or group is None:
        return torch.zeros((1, 1), dtype=torch.int64, device=device)
    return (rank_id(group, cfg.sp_axis).to(device) * t_local)[:, None]


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, group=None, device=None, generator=None):
        super().__init__()
        self.cfg, self.group = cfg, group
        self.local_heads = cfg.num_heads // cfg.tp_size
        self.head_dim = cfg.hidden_size // cfg.num_heads
        tp = dict(tp_size=cfg.tp_size, tp_axis=cfg.tp_axis, dtype=cfg.compute_dtype, group=group,
                  device=device, generator=generator)
        self.qkv = ColumnParallelDense(cfg.hidden_size, 3 * cfg.hidden_size, **tp)
        self.out = RowParallelDense(self.local_heads * self.head_dim, cfg.hidden_size, **tp)

    def forward(self, params, x, mask=None):
        R, b, t, _ = x.shape
        h, d = self.local_heads, self.head_dim
        qkv = self.qkv(params["qkv"], x).reshape(R, b, t, 3, h, d)
        q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
        if self.cfg.sp_axis is not None:
            ctx = ring_attention(q, k, v, self.group, self.cfg.sp_axis, causal=False, kv_mask=mask)
        else:
            flat = lambda a: None if a is None else a.flatten(0, 1)  # noqa: E731
            ctx = _block_attention_local(flat(q), flat(k), flat(v), causal=False, kv_mask=flat(mask))
        return self.out(params["out"], ctx.reshape(R, b, t, h * d))


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, group=None, device=None, generator=None):
        super().__init__()
        self.attention = BertSelfAttention(cfg, group, device, generator)
        self.ln_attn = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)
        self.mlp = ParallelMLP(cfg.hidden_size, cfg.intermediate_size, cfg.hidden_size, cfg.tp_size,
                               cfg.tp_axis, dtype=cfg.compute_dtype, group=group, device=device,
                               generator=generator)
        self.ln_ffn = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)

    def forward(self, params, x, mask=None):
        x = self.ln_attn(params["ln_attn"], x + self.attention(params["attention"], x, mask))
        return self.ln_ffn(params["ln_ffn"], x + self.mlp(params["mlp"], x))


class BertModel(nn.Module):
    """Encoder producing final hidden states ``(R, b, t_local, H)`` in f32.
    ``token_types`` adds the ``token_type_embeddings`` table, which flax
    creates only when ``init`` is given token types.  ``group`` holds the
    sp and tp axes; parameters are built on ``device``, by default the
    current CUDA device (raises without one)."""

    def __init__(self, cfg: BertConfig, group=None, device=None, generator=None,
                 token_types: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.group = cfg, group
        self.word_embeddings = Embed(cfg.vocab_size, cfg.hidden_size, device, generator)
        self.position_embeddings = Embed(cfg.max_position_embeddings, cfg.hidden_size, device,
                                         generator)
        if token_types:
            self.token_type_embeddings = Embed(cfg.type_vocab_size, cfg.hidden_size, device,
                                               generator)
        self.ln_embed = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", BertLayer(cfg, group, device, generator))

    def forward(self, params, input_ids, token_type_ids=None, attention_mask=None):
        """``input_ids (R, b, t_local)``; ``attention_mask`` ``(R, b,
        t_local)`` bool, True = a real token (the key-padding mask)."""
        cfg = self.cfg
        R, b, t = input_ids.shape
        sp = axis_size(self.group, cfg.sp_axis) if cfg.sp_axis is not None and self.group is not None else 1
        if sp * t > cfg.max_position_embeddings:
            raise ValueError(f"global sequence length {sp * t} exceeds the configured "
                             f"max_position_embeddings ({cfg.max_position_embeddings})")
        x = self.word_embeddings(params["word_embeddings"], input_ids)
        pos = torch.arange(t, device=input_ids.device)[None] + _sp_offset(cfg, t, self.group, input_ids.device)
        x = x + self.position_embeddings(params["position_embeddings"], pos.expand(R, t)[:, None])
        if token_type_ids is not None:
            if "token_type_embeddings" not in params:
                raise ValueError("token_type_ids given to a model built without token_types")
            x = x + self.token_type_embeddings(params["token_type_embeddings"], token_type_ids)
        x = self.ln_embed(params["ln_embed"], x).to(cfg.compute_dtype)
        for i in range(cfg.num_layers):
            x = getattr(self, f"layer_{i}")(params[f"layer_{i}"], x, attention_mask)
        return x.to(torch.float32)


class BertForPreTraining(nn.Module):
    """Encoder + MLM head (untied decoder), f32 logits ``(R, b, t, vocab)``."""

    def __init__(self, cfg: BertConfig, group=None, device=None, generator=None,
                 token_types: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.group = cfg, group
        self.bert = BertModel(cfg, group, device, generator, token_types)
        self.mlm_transform = _f32_dense(cfg.hidden_size, cfg.hidden_size, device, generator)
        self.mlm_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)
        self.mlm_decoder = _f32_dense(cfg.hidden_size, cfg.vocab_size, device, generator)

    def forward(self, params, input_ids, token_type_ids=None):
        h = self.bert(params["bert"], input_ids, token_type_ids)
        h = gelu(self.mlm_transform(params["mlm_transform"], h))
        h = self.mlm_ln(params["mlm_ln"], h)
        return self.mlm_decoder(params["mlm_decoder"], h)


def one_rank(tree):
    """A rank axis of one on every leaf: one rank's tree (as the engine's
    ``vmap`` hands it to a loss) as the stacked models take it."""
    return tree_map(lambda t: t.unsqueeze(0), tree)


def mlm_loss_fn(model: BertForPreTraining):
    """``loss_fn(params, (ids, labels))``: one rank's masked-LM cross entropy
    over every position (the synthetic benchmark's), as the engine calls it
    under ``vmap``."""

    def loss_fn(params, batch):
        input_ids, labels = batch
        logp = F.log_softmax(model(one_rank(params), input_ids[None])[0], dim=-1)
        return -torch.mean(torch.gather(logp, -1, labels[..., None].long()))

    return loss_fn


def init_bert(cfg: BertConfig, generator=None, device=None, group=None, model_cls=None):
    """``(model, params)``: a ``model_cls`` (default
    :class:`BertForPreTraining`) and its unstacked flax-style parameter
    tree, drawn with flax's initializers in distribution."""
    model = (model_cls or BertForPreTraining)(cfg, group, device=device, generator=generator)
    return model, module_params(model)

