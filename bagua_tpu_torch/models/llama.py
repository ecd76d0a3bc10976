"""Llama-style causal decoder (the port of ``bagua_tpu/models/llama.py``):
RMSNorm, rotary position embeddings on interleaved pairs, SwiGLU MLP and
grouped-query attention, with ring-attention sequence parallelism.

Modules hold flax's parameter tree and names (``embed/embedding``,
``block_i/attn/{q,k,v,out}/kernel``, ``block_i/{attn_norm,mlp_norm}/scale``,
``block_i/mlp/{gate,up,down}/kernel``, ``final_norm/scale``,
``lm_head/kernel``), created with flax's initializers in distribution, so a
flax tree converts unchanged (:func:`bagua_tpu_torch.convert.params_from_jax`).
The forward is functional, like flax's ``apply``: ``model(params, ids)`` takes
a **rank-stacked** tree (every leaf ``(R, ...)``) and ids ``(R, b,
t_local)`` and returns ``(R, b, t_local, vocab)`` float32 logits, every op
batched over the rank axis.  With ``R = 1`` and ``sp_axis=None`` it is the
single-device model.

Under sequence parallelism (``cfg.sp_axis``, an axis of the model's
group, e.g. ``"sp"``) attention is :func:`~bagua_tpu_torch.parallel.ring_attention.ring_attention`,
causal, with the layout ``cfg.sp_layout``; RoPE rotates each rank's tokens
by their *global* positions before the ring exchange, so the K/V blocks
carry their rotation around the ring.

Under tensor parallelism (``cfg.tp_size > 1`` over ``cfg.tp_axis``) each
rank holds ``1 / tp_size`` of the heads and of the MLP width, and the Row
projections (``out``, ``down``) sum their partial products over the tp
axis (the ``psum`` path; the model never fuses).  Parameters are built at
these local shapes, as flax's ``init`` builds them inside the JAX example.
"""

import dataclasses
from typing import Any, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from bagua_tpu_torch.communication import axis_size
from bagua_tpu_torch.models._layers import Embed, module_params  # noqa: F401  (re-exported)
from bagua_tpu_torch.models.gpt import _sp_positions, lm_loss_fn  # noqa: F401  (re-exported)
from bagua_tpu_torch.parallel.ring_attention import _block_attention_local, ring_attention
from bagua_tpu_torch.parallel.tensor_parallel import (
    ColumnParallelDense, RowParallelDense, _per_rank, stacked_matmul,
)
from bagua_tpu_torch.utils import lecun_normal, resolve_device


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    #: < num_heads enables grouped-query attention; K/V heads are shared by
    #: ``num_heads // num_kv_heads`` query heads each
    num_kv_heads: int = 32
    intermediate_size: int = 11008
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tp_size: int = 1
    #: the group axis the heads and the MLP are sharded over ("tp" of a
    #: named mesh, "inter" or "intra" of the legacy one); read only at
    #: tp_size > 1
    tp_axis: Union[str, Tuple[str, ...]] = "intra"
    #: the group axis the sequence is sharded over ("sp" of a named mesh,
    #: "inter" or "intra" of the legacy one)
    sp_axis: Union[str, Tuple[str, ...], None] = None
    #: "contiguous" or "zigzag" (the balanced causal ring layout)
    sp_layout: str = "contiguous"
    compute_dtype: Any = torch.float32
    #: the Row projections' ``fused`` (``RowParallelDense``): False keeps the
    #: ``psum``; True or "auto" take the collective-matmul ring
    #: (``matmul_rs`` and its all-gather) at tp_size > 1
    tp_fused: Union[bool, str] = False

    def __post_init__(self):
        if self.hidden_size % self.num_heads:
            raise ValueError(
                f"hidden_size ({self.hidden_size}) must divide by num_heads "
                f"({self.num_heads})"
            )
        if (self.hidden_size // self.num_heads) % 2:
            raise ValueError(
                f"head_dim ({self.hidden_size // self.num_heads}) must be even "
                "(RoPE rotates half-dimension pairs)"
            )
        if self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"num_heads ({self.num_heads}) must divide by num_kv_heads "
                f"({self.num_kv_heads})"
            )
        for field, n in (("num_heads", self.num_heads), ("num_kv_heads", self.num_kv_heads)):
            if n % self.tp_size:
                raise ValueError(
                    f"{field} ({n}) must divide by tp_size ({self.tp_size})"
                )


def llama_7b_config(**overrides) -> LlamaConfig:
    """The classic 7B shape (32 layers x 4096 hidden, MHA)."""
    return LlamaConfig(**overrides)


def llama_test_config(**overrides) -> LlamaConfig:
    kwargs = dict(
        vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
        intermediate_size=48, max_position_embeddings=64,
    )
    kwargs.update(overrides)
    return LlamaConfig(**kwargs)


class RMSNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device))

    def forward(self, params, x):
        dtype = x.dtype
        x = x.to(torch.float32)
        y = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + self.eps)
        return (y * _per_rank(params["scale"], x.dim())).to(dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate interleaved feature pairs (``x[..., ::2]``, ``x[..., 1::2]``) of
    ``x (..., b, t, h, d)`` by the angles of ``positions (..., t)``.
    Computed in f32, cast back to ``x.dtype``."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"RoPE needs an even head_dim, got {d}")
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = positions.to(torch.float32)[..., :, None] * inv_freq  # (..., t, d/2)
    cos = torch.cos(ang)[..., None, :, None, :]
    sin = torch.sin(ang)[..., None, :, None, :]
    xf = x.to(torch.float32)
    x1, x2 = xf[..., ::2], xf[..., 1::2]
    rotated = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.reshape(x.shape).to(x.dtype)


def _tp_layer_kwargs(cfg: LlamaConfig, group, device, generator) -> dict:
    """The tensor-parallel layers' settings: bias-free, in the compute type,
    sharded over ``cfg.tp_axis``, fused as ``cfg.tp_fused`` says (a Column
    layer's input is replicated, so only the Row layers take a ring)."""
    return dict(tp_size=cfg.tp_size, tp_axis=cfg.tp_axis, use_bias=False, dtype=cfg.compute_dtype,
                fused=cfg.tp_fused, group=group, device=device, generator=generator)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, group=None, device=None, generator=None):
        super().__init__()
        self.cfg, self.group = cfg, group
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.local_q = cfg.num_heads // cfg.tp_size
        self.local_kv = cfg.num_kv_heads // cfg.tp_size

        tp = _tp_layer_kwargs(cfg, group, device, generator)

        def proj(n_heads):
            return ColumnParallelDense(cfg.hidden_size, n_heads * self.head_dim, **tp)

        self.q, self.k, self.v = proj(cfg.num_heads), proj(cfg.num_kv_heads), proj(cfg.num_kv_heads)
        self.out = RowParallelDense(self.local_q * self.head_dim, cfg.hidden_size, **tp)

    def forward(self, params, x):
        cfg = self.cfg
        R, b, t, _ = x.shape
        q = self.q(params["q"], x).reshape(R, b, t, self.local_q, self.head_dim)
        k = self.k(params["k"], x).reshape(R, b, t, self.local_kv, self.head_dim)
        v = self.v(params["v"], x).reshape(R, b, t, self.local_kv, self.head_dim)

        # RoPE on the *global* positions of each rank's tokens
        pos = _sp_positions(cfg, t, self.group, x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)

        if cfg.sp_axis is not None:
            # GQA rides the ring unrepeated: the block kernels index the
            # shared K/V heads
            ctx = ring_attention(q, k, v, self.group, cfg.sp_axis, causal=True,
                                 layout=cfg.sp_layout, kv_groups=self.local_q // self.local_kv)
        else:
            g = self.local_q // self.local_kv
            if g > 1:  # local path: expand before the oracle
                k = torch.repeat_interleave(k, g, dim=3)
                v = torch.repeat_interleave(v, g, dim=3)
            ctx = _block_attention_local(q.flatten(0, 1), k.flatten(0, 1), v.flatten(0, 1), causal=True)
        return self.out(params["out"], ctx.reshape(R, b, t, self.local_q * self.head_dim))


class LlamaMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, cfg: LlamaConfig, group=None, device=None, generator=None):
        super().__init__()
        tp = _tp_layer_kwargs(cfg, group, device, generator)
        self.gate = ColumnParallelDense(cfg.hidden_size, cfg.intermediate_size, **tp)
        self.up = ColumnParallelDense(cfg.hidden_size, cfg.intermediate_size, **tp)
        self.down = RowParallelDense(cfg.intermediate_size // cfg.tp_size, cfg.hidden_size, **tp)

    def forward(self, params, x):
        h = F.silu(self.gate(params["gate"], x)) * self.up(params["up"], x)
        return self.down(params["down"], h)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, group=None, device=None, generator=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, device)
        self.attn = LlamaAttention(cfg, group, device, generator)
        self.mlp_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, device)
        self.mlp = LlamaMLP(cfg, group, device, generator)

    def forward(self, params, x):
        x = x + self.attn(params["attn"], self.attn_norm(params["attn_norm"], x))
        return x + self.mlp(params["mlp"], self.mlp_norm(params["mlp_norm"], x))


class LlamaModel(nn.Module):
    """Causal LM: embed -> pre-norm blocks -> RMSNorm -> untied f32 LM head.
    ``group`` holds ``cfg.sp_axis``; parameters are built on ``device``, by
    default the current CUDA device (raises without one)."""

    def __init__(self, cfg: LlamaConfig, group=None, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.group = cfg, group
        self.embed = Embed(cfg.vocab_size, cfg.hidden_size, device, generator)
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", LlamaBlock(cfg, group, device, generator))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, device)
        self.lm_head = nn.Module()
        self.lm_head.kernel = nn.Parameter(
            lecun_normal((cfg.hidden_size, cfg.vocab_size), cfg.hidden_size, device=device,
                         generator=generator))

    def forward(self, params, input_ids):
        cfg = self.cfg
        # the config's trained context length is a contract on the *global*
        # sequence (sp ranks x local length)
        sp = axis_size(self.group, cfg.sp_axis) if cfg.sp_axis is not None and self.group is not None else 1
        t_global = sp * input_ids.shape[-1]
        if t_global > cfg.max_position_embeddings:
            raise ValueError(
                f"global sequence length {t_global} exceeds the configured "
                f"max_position_embeddings ({cfg.max_position_embeddings})"
            )
        x = self.embed(params["embed"], input_ids).to(cfg.compute_dtype)
        for i in range(cfg.num_layers):
            x = getattr(self, f"block_{i}")(params[f"block_{i}"], x)
        x = self.final_norm(params["final_norm"], x.to(torch.float32))
        return stacked_matmul(x, params["lm_head"]["kernel"].to(torch.float32))


def init_llama(cfg: LlamaConfig, generator=None, device=None, group=None):
    """``(model, params)``: a :class:`LlamaModel` and its unstacked flax-style
    parameter tree, drawn with flax's initializers in distribution."""
    model = LlamaModel(cfg, group, device=device, generator=generator)
    return model, module_params(model)


# ``lm_loss_fn`` (from models.gpt) reads only ``model.cfg``, ``model.group``
# and ``model(params, ids)``, including the zigzag seam mask.
llama_loss_fn = lm_loss_fn
