"""Expert-parallel MoE block: router + all-to-all token exchange + experts
(the port of ``bagua_tpu/parallel/moe/layer.py``).

User API is :class:`MoE` (reference ``model_parallel/moe/layer.py:22``); the
machinery below it:

* :class:`Router` — linear f32 gate feeding
  :mod:`bagua_tpu_torch.parallel.moe.routing`.
* :class:`Experts` — the per-expert FFN stack, its weights laid out as
  ``nn.vmap(nn.Dense)`` lays them out (``kernel (local_experts, in, out)``)
  and applied by batched matmul.
* :class:`ExpertParallelFFN` — dispatch → all-to-all over the group's
  ``ep_axis`` → expert compute → all-to-all back → combine.

The modules compute one rank's tokens.  The engine runs every rank's loss
in one ``torch.func.vmap`` over the rank-stacked parameters; there the
exchange is :func:`~bagua_tpu_torch.models._rank_ops.rank_alltoall`, whose
``vmap`` rule runs the group's stacked all-to-all (the JAX package's
``lax.all_to_all`` under ``shard_map``).  ``ep_size`` fixes the experts'
shapes (each rank owns ``num_experts // ep_size``); the group's ``ep_axis``
must multiply to exactly ``ep_size``, and at ``ep_size > 1`` the block runs
only under such a ``vmap``.

Precision follows flax's promotion: the gate is f32, the dispatch einsum
runs in the tokens' type, the experts promote their input to their f32
parameters, and the combine rounds its weights to the tokens' type and
contracts in the promoted type (f32), so a bf16 input comes back f32.
Parameters keep flax's names (``moe_layer/gate/Dense_0/kernel``,
``moe_layer/experts/VmapDense_{0,1}/{kernel,bias}``).
"""

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from bagua_tpu_torch.communication import ALL_AXES, _axes, axis_size
from bagua_tpu_torch.models._rank_ops import rank_alltoall
from bagua_tpu_torch.observability.annotations import mp_scope
from bagua_tpu_torch.parallel.moe.routing import Routing, route_top1, route_top2
from bagua_tpu_torch.utils import lecun_normal, resolve_device

_ACTIVATIONS = {"relu": F.relu}


def _check_ep_axes(ep_size: int, ep_axis, group) -> None:
    """The group must exist and its ``ep_axis`` must multiply to ``ep_size``
    (a misspelled axis would otherwise skip the exchange and train each rank
    on its local experts only)."""
    if group is None:
        raise ValueError(f"ep_size={ep_size} needs the process group that holds its ep_axis")
    axes = _axes(ep_axis, group)
    if not axes or any(a not in group.all_axes for a in axes):
        raise ValueError(
            f"none of the declared expert-parallel axes {axes} are axes of the group "
            f"{group.all_axes} — check the ep_axis spelling"
        )
    bound = axis_size(group, ep_axis)
    if bound != ep_size:
        raise ValueError(f"ep_size={ep_size} but the group's axes {axes} have total size {bound}")


class Router(nn.Module):
    """Linear gate + top-k routing (reference ``TopKGate``,
    ``sharded_moe.py:241-303``)."""

    def __init__(self, model_dim: int, num_experts: int, k: int = 1, capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 noisy_gate_policy: Optional[str] = None, device=None, generator=None):
        super().__init__()
        if k not in (1, 2):
            raise ValueError("Only top-1 and top-2 gatings are supported.")
        if noisy_gate_policy not in (None, "Jitter", "RSample"):
            raise ValueError(
                f"unknown noisy_gate_policy {noisy_gate_policy!r} "
                "(expected None, 'Jitter' or 'RSample')"
            )
        self.num_experts, self.k = num_experts, k
        self.capacity_factor, self.eval_capacity_factor = capacity_factor, eval_capacity_factor
        self.min_capacity, self.noisy_gate_policy = min_capacity, noisy_gate_policy
        self.Dense_0 = nn.Module()
        self.Dense_0.kernel = nn.Parameter(
            lecun_normal((model_dim, num_experts), model_dim, device=device, generator=generator))

    def forward(self, tokens, train: bool = True, used_token=None,
                rng: Optional[torch.Generator] = None) -> Routing:
        if self.noisy_gate_policy == "Jitter" and train:
            # Input jittering (reference multiplicative_jitter,
            # sharded_moe.py:37-59): multiply the gate input by
            # uniform(1-eps, 1+eps), eps=1e-2.
            if rng is None:
                raise ValueError("noisy_gate_policy='Jitter' requires an rng key")
            noise = torch.rand(tokens.shape, generator=rng, device=tokens.device, dtype=tokens.dtype)
            tokens = tokens * (noise * 2e-2 + (1.0 - 1e-2))
        logits = tokens.to(torch.float32) @ self.Dense_0.kernel.to(torch.float32)
        factor = self.capacity_factor if train else self.eval_capacity_factor
        if self.k == 1:
            return route_top1(logits, factor, self.min_capacity, used_token,
                              self.noisy_gate_policy if train else None, rng)
        return route_top2(logits, factor, rng, used_token)


class _ExpertDense(nn.Module):
    """``nn.vmap(nn.Dense)`` over the local experts: ``kernel (E, in,
    out)``, ``bias (E, out)``; each expert's kernel lecun-normal."""

    def __init__(self, experts: int, in_features: int, features: int, device, generator):
        super().__init__()
        self.kernel = nn.Parameter(
            lecun_normal((experts, in_features, features), in_features, device=device, generator=generator))
        self.bias = nn.Parameter(torch.zeros(experts, features, device=device))

    def forward(self, x):  # (E, tokens, in)
        dtype = torch.promote_types(x.dtype, self.kernel.dtype)
        return torch.bmm(x.to(dtype), self.kernel.to(dtype)) + self.bias.to(dtype)[:, None, :]


class Experts(nn.Module):
    """Per-expert FFN stack over the local experts (reference ``experts.py:16``)."""

    def __init__(self, model_dim: int, hidden_dim: int, num_local_experts: int,
                 activation: str = "relu", device=None, generator=None):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"activation {activation!r} is not ported (have {sorted(_ACTIVATIONS)})")
        self.activation = _ACTIVATIONS[activation]
        self.VmapDense_0 = _ExpertDense(num_local_experts, model_dim, hidden_dim, device, generator)
        self.VmapDense_1 = _ExpertDense(num_local_experts, hidden_dim, model_dim, device, generator)

    def forward(self, x):
        # x: (local_experts, tokens, model_dim)
        return self.VmapDense_1(self.activation(self.VmapDense_0(x)))


class ExpertParallelFFN(nn.Module):
    """Route tokens to experts sharded over the group's ``ep_axis``.

    ``a2a_chunks > 1`` splits the capacity axis into chunks and runs each
    chunk's dispatch all-to-all → expert FFN → combine all-to-all on its
    own, so one chunk's exchange can run beside another's expert GEMMs.
    The expert FFN is position-wise, so chunking is exact; the requested
    chunk count is clamped to the nearest divisor of the capacity.
    """

    def __init__(self, model_dim: int, num_experts: int, hidden_dim: int, k: int = 1,
                 capacity_factor: float = 1.0, eval_capacity_factor: float = 1.0,
                 min_capacity: int = 4, noisy_gate_policy: Optional[str] = None, ep_size: int = 1,
                 ep_axis: Union[str, Tuple[str, ...], None] = ALL_AXES, a2a_chunks: int = 1,
                 group=None, device=None, generator=None):
        super().__init__()
        if num_experts % ep_size != 0:
            raise ValueError(
                f"num_experts ({num_experts}) must divide evenly by ep_size ({ep_size})"
            )
        if ep_size > 1:
            _check_ep_axes(ep_size, ep_axis, group)
        device = resolve_device(device)
        self.num_experts, self.ep_size, self.ep_axis = num_experts, ep_size, ep_axis
        self.a2a_chunks, self.group = a2a_chunks, group
        self.local_experts = num_experts // ep_size
        self.gate = Router(model_dim, num_experts, k, capacity_factor, eval_capacity_factor,
                           min_capacity, noisy_gate_policy, device, generator)
        self.experts = Experts(model_dim, hidden_dim, self.local_experts, device=device, generator=generator)

    def _resolve_chunks(self, capacity: int) -> int:
        c = max(1, min(int(self.a2a_chunks), capacity))
        while capacity % c:
            c -= 1
        return c

    def _exchange(self, ob):
        """One dispatch → expert compute → combine round over a slice of
        the capacity axis; ob: (ep_size, local_experts, c, model_dim)."""
        ep, local, c, model_dim = ob.shape
        if ep > 1:
            # chunk g of every rank's tokens travels to the rank owning
            # expert group g (reference dist.all_to_all_single,
            # sharded_moe.py:77-91)
            with mp_scope("ep", "dispatch"):
                ob = rank_alltoall(ob, self.group, self.ep_axis)
        expert_in = ob.movedim(0, 1).reshape(local, -1, model_dim)
        expert_out = self.experts(expert_in)
        ib = expert_out.reshape(local, ep, c, model_dim).movedim(0, 1)
        if ep > 1:
            with mp_scope("ep", "combine"):
                ib = rank_alltoall(ib, self.group, self.ep_axis)
        return ib.reshape(self.num_experts, c, model_dim)

    def forward(self, x, train: bool = True, used_token=None, rng: Optional[torch.Generator] = None):
        orig_shape = x.shape
        model_dim = x.shape[-1]
        tokens = x.reshape(-1, model_dim)
        if used_token is not None:
            used_token = used_token.reshape(-1).to(torch.float32)
        routing = self.gate(tokens, train=train, used_token=used_token, rng=rng)

        # (S,E,C) x (S,M) -> (E,C,M), grouped by owning rank
        outbound = torch.einsum(
            "sec,sm->ecm", routing.dispatch_mask.to(tokens.dtype), tokens
        ).reshape(self.ep_size, self.local_experts, -1, model_dim)
        capacity = outbound.shape[2]
        chunks = self._resolve_chunks(capacity) if (self.ep_size > 1 and capacity) else 1
        if chunks > 1:
            cblk = capacity // chunks
            inbound = torch.cat(
                [self._exchange(outbound[:, :, i * cblk:(i + 1) * cblk]) for i in range(chunks)], dim=1
            )
        else:
            inbound = self._exchange(outbound)

        weights = routing.combine_weights.to(tokens.dtype)
        dtype = torch.promote_types(weights.dtype, inbound.dtype)
        out = torch.einsum("sec,ecm->sm", weights.to(dtype), inbound.to(dtype))
        return out.reshape(orig_shape), routing.balance_loss


class MoE(nn.Module):
    """A mixture-of-experts FFN block: ``out, l_aux = MoE(...)(x)``.

    Mirrors the reference constructor (``layer.py:22``), with the input
    width ``model_dim`` first (flax infers it) and the ``group`` that holds
    ``ep_axis``: ``num_experts`` total experts sharded over the
    expert-parallel axes, top-``k`` gating with capacity factors.  Add
    ``l_aux`` (scaled by your chosen coefficient) to the training loss.
    """

    def __init__(self, model_dim: int, hidden_size: int, num_experts: int = 1, k: int = 1,
                 capacity_factor: float = 1.0, eval_capacity_factor: float = 1.0,
                 min_capacity: int = 4, noisy_gate_policy: Optional[str] = None, ep_size: int = 1,
                 ep_axis: Union[str, Tuple[str, ...], None] = ALL_AXES, a2a_chunks: int = 1,
                 group=None, device=None, generator=None):
        super().__init__()
        self.moe_layer = ExpertParallelFFN(
            model_dim, num_experts, hidden_size, k, capacity_factor, eval_capacity_factor,
            min_capacity, noisy_gate_policy, ep_size, ep_axis, a2a_chunks, group, device, generator,
        )

    def forward(self, x, train: bool = True, used_token=None, rng: Optional[torch.Generator] = None):
        """``used_token``: optional 0/1 mask over tokens (any shape reshaping
        to ``x``'s token count) — masked-out tokens are not routed
        (reference ``MoE.forward``'s ``used_token``, ``layer.py:90-96``)."""
        return self.moe_layer(x, train=train, used_token=used_token, rng=rng)
