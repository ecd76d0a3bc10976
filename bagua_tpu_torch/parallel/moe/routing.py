"""Token-to-expert routing (gating) for the expert-parallel MoE block (the
port of ``bagua_tpu/parallel/moe/routing.py``).

The same routing function, operation for operation: softmax router,
top-1/top-2 expert choice, per-expert capacity truncation, the
load-balancing loss, and dense ``(tokens, experts, capacity)`` combine and
dispatch tensors, built from the three shared primitives
:func:`_claim_slots`, :func:`_combine` and :func:`_balance_loss`, returned
as a :class:`Routing` record.

Randomness is explicit, as in the JAX package, but through a
``torch.Generator``: ``rng=None`` claims slots in token-position order (the
rule top-2 always uses); a generator draws the uniform capacity tie-break
(top-1) and the Gumbel noise (top-1 ``RSample``, top-2's second choice).
The draws cannot match ``jax.random``'s, so the tests feed the JAX draws
through ``priority`` and the scores.
"""

import math
from typing import NamedTuple, Optional

import torch


class Routing(NamedTuple):
    """Routing decision for one batch of tokens.

    combine_weights/dispatch_mask have shape (tokens, experts, capacity);
    tokens_per_expert is the pre-truncation demand histogram (int32, (E,)).
    """

    balance_loss: torch.Tensor
    combine_weights: torch.Tensor
    dispatch_mask: torch.Tensor
    tokens_per_expert: torch.Tensor


def expert_capacity(num_tokens: int, num_experts: int, factor: float, k: int = 1,
                    floor: int = 0) -> int:
    """Slots each expert can accept: ``ceil(k * tokens/experts * factor)``,
    at least ``floor``."""
    return max(int(math.ceil(k * num_tokens / num_experts * factor)), floor)


def _one_hot(index: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot(index, n)``: f32 rows, all zero for an index
    outside ``[0, n)``."""
    return (index[..., None] == torch.arange(n, device=index.device)).to(torch.float32)


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax(logits, axis=1)`` as JAX writes it: ``exp(x -
    max)`` over its sum."""
    e = torch.exp(logits - logits.amax(dim=1, keepdim=True).detach())
    return e / e.sum(dim=1, keepdim=True)


def _gumbel(rng: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, ``u`` uniform in ``(tiny,
    1)`` as ``jax.random.gumbel`` draws it."""
    u = torch.rand(like.shape, generator=rng, device=like.device, dtype=like.dtype)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(like.dtype).tiny)))


def _balance_loss(router_probs, chosen_mask, num_experts: int, scale: float):
    """Mean router probability x mean routed fraction, summed over experts —
    pushes the router toward uniform expert load."""
    prob_share = router_probs.mean(dim=0)
    routed_share = chosen_mask.mean(dim=0)
    return torch.sum(prob_share * routed_share) * scale


def _claim_slots(chosen_mask, capacity: int, *, start_at=None, priority=None):
    """Assign capacity slots within each expert column.

    Tokens claim slots in position order (masked cumsum), or — when a
    ``priority`` tensor is given — the ``capacity`` highest-priority tokens
    win.  ``start_at`` (per-expert, e.g. the top-1 column's demand) offsets
    the slot numbering for second-choice tokens.  Returns
    ``(kept_mask, slot_of_token)``: the mask with over-capacity tokens
    dropped, and each surviving token's slot index (int32, (S,))."""
    if priority is not None:
        ranked = chosen_mask * priority
        # jnp.sort(...)[-capacity] clamps the index to 0 where capacity
        # exceeds the tokens (every token then fits); torch would raise
        row = max(ranked.shape[0] - capacity, 0)
        kth = torch.sort(ranked, dim=0).values[row][None, :]
        chosen_mask = chosen_mask * ((ranked >= torch.clamp(kth, min=1e-38)) & (chosen_mask > 0))
        slots = torch.cumsum(chosen_mask, dim=0) - 1
    else:
        slots = torch.cumsum(chosen_mask, dim=0) - 1
        if start_at is not None:
            slots = slots + start_at[None, :]
        chosen_mask = chosen_mask * (slots < capacity)
        slots = torch.cumsum(chosen_mask, dim=0) - 1
        if start_at is not None:
            slots = slots + start_at[None, :]
    slot_of_token = torch.sum(slots * chosen_mask, dim=1).to(torch.int32)
    return chosen_mask, slot_of_token


def _combine(weight_of_token, chosen_mask, slot_of_token, capacity: int):
    """(S,) weights + (S,E) mask + (S,) slots -> (S,E,C) combine tensor: the
    outer product ``einsum("se,sc->sec")``, one product per element."""
    slot_one_hot = _one_hot(slot_of_token, capacity)
    return (weight_of_token[:, None] * chosen_mask)[:, :, None] * slot_one_hot[:, None, :]


def route_top1(
    logits: torch.Tensor,
    capacity_factor: float,
    min_capacity: int = 4,
    used_token: Optional[torch.Tensor] = None,
    noisy_gate_policy: Optional[str] = None,
    rng: Optional[torch.Generator] = None,
) -> Routing:
    """Top-1 routing (reference ``sharded_moe.py:93-165``): every token goes
    to its argmax expert, capacity-truncated."""
    probs = _softmax(logits)
    num_tokens, num_experts = probs.shape
    capacity = expert_capacity(num_tokens, num_experts, capacity_factor, floor=min_capacity)

    if noisy_gate_policy == "RSample":
        if rng is None:
            raise ValueError("noisy_gate_policy='RSample' requires an rng key")
        choice_scores = logits + _gumbel(rng, logits)
    else:
        choice_scores = probs
    chosen = _one_hot(torch.argmax(choice_scores, dim=1), num_experts)
    if used_token is not None:
        chosen = used_token[:, None] * chosen

    demand = torch.sum(chosen, dim=0).to(torch.int32)
    loss = _balance_loss(probs, chosen, num_experts, scale=float(num_experts))

    priority = None
    if rng is not None:
        # random capacity tie-break, like the reference's uniform sample
        priority = torch.rand(chosen.shape, generator=rng, device=chosen.device)
    kept, slot_of_token = _claim_slots(chosen, capacity, priority=priority)

    weight_of_token = torch.sum(probs * kept, dim=1)
    combine = _combine(weight_of_token, kept, slot_of_token, capacity)
    return Routing(loss, combine, combine > 0, demand)


def route_top2(
    logits: torch.Tensor,
    capacity_factor: float,
    rng: Optional[torch.Generator] = None,
    used_token: Optional[torch.Tensor] = None,
) -> Routing:
    """Top-2 routing (reference ``sharded_moe.py:168-239``): each token's two
    best experts share it, with renormalized weights; second choices queue
    behind every first choice in the capacity count.

    ``used_token`` masks tokens out of routing entirely — a deliberate
    extension: the reference's ``top2gating`` silently ignores the mask its
    ``TopKGate.forward`` accepts (``sharded_moe.py:298-303``)."""
    probs = _softmax(logits)
    num_tokens, num_experts = probs.shape
    capacity = expert_capacity(num_tokens, num_experts, capacity_factor, k=2)

    first = _one_hot(torch.argmax(probs, dim=1), num_experts)
    second_scores = logits if rng is None else logits + _gumbel(rng, logits)
    second_scores = torch.where(first > 0, -math.inf, second_scores)
    second = _one_hot(torch.argmax(second_scores, dim=1), num_experts)
    if used_token is not None:
        first = used_token[:, None] * first
        second = used_token[:, None] * second

    demand = torch.sum(first, dim=0).to(torch.int32)
    # top-2 scaling: mean over experts of (prob share x routed share) x E^2
    loss = torch.mean(probs.mean(dim=0) * first.mean(dim=0)) * num_experts ** 2

    kept1, slot1 = _claim_slots(first, capacity)
    kept2, slot2 = _claim_slots(second, capacity, start_at=torch.sum(first, dim=0))

    w1 = torch.sum(probs * kept1, dim=1)
    w2 = torch.sum(probs * kept2, dim=1)
    norm = torch.clamp(w1 + w2, min=torch.finfo(probs.dtype).eps)
    combine = _combine(w1 / norm, kept1, slot1, capacity) + _combine(
        w2 / norm, kept2, slot2, capacity
    )
    return Routing(loss, combine, combine > 0, demand)
