"""The port's expert-parallel MoE (``bagua_tpu_torch.parallel.moe``) against
the JAX package's (``bagua_tpu.parallel.moe``), on the CPU.

Every case of ``tests/test_moe.py`` is replayed against the port (the
``test_ref_*`` functions, in that file's order), then the port is held
against JAX on the same numpy inputs and flax's initial weights:

- routing: dispatch masks, slots and ``tokens_per_expert`` exactly JAX's;
  combine weights and ``l_aux`` within rtol 1e-6 (softmax's ``exp`` and
  its sum round in another order); where JAX draws noise, the JAX draw is
  fed through ``priority`` and the scores (``jax.random`` cannot be
  matched by a ``torch.Generator``);
- ``ExpertParallelFFN`` at ep 1 and at ep 8 (the 8-rank group, under
  ``torch.func.vmap``, against ``shard_map``): outputs within 1e-6 of
  their largest value, every gradient within 1e-5 of its leaf's largest
  JAX value (f32 matmuls summed in another order);
- ``rank_alltoall`` under ``vmap`` bitwise the stacked ``alltoall``, and
  so its gradient; ``a2a_chunks`` bitwise unchunked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from bagua_tpu.parallel.moe import MoE as JMoE
from bagua_tpu.parallel.moe import layer as jlayer
from bagua_tpu.parallel.moe import routing as jrouting

from bagua_tpu_torch.algorithms import GradientAllReduceAlgorithm
from bagua_tpu_torch.communication import ALL_AXES, BaguaProcessGroup, alltoall
from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.models._rank_ops import rank_alltoall
from bagua_tpu_torch.models.llama import module_params
from bagua_tpu_torch.models.vgg import Dense
from bagua_tpu_torch.parallel.moe import MoE, route_top1, route_top2
from bagua_tpu_torch.parallel.moe import routing as trouting
from bagua_tpu_torch.parallel.moe.layer import ExpertParallelFFN, Router
from bagua_tpu_torch.parallel.moe.utils import split_moe_params
from bagua_tpu_torch.utils import dotted_leaves, tree_flatten_with_names, tree_leaves, tree_unflatten

N = 8
MODEL_DIM = 8
NUM_EXPERTS = 8


def cpu_group(n=N):
    return BaguaProcessGroup([torch.device("cpu")] * n, intra_size=4 if n == N else n)


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def softmax(logits):
    return trouting._softmax(logits)


# ---------------------------------------------------------------------------
# tests/test_moe.py, replayed against the port
# ---------------------------------------------------------------------------


def test_ref_route_top1_invariants():
    rng = np.random.RandomState(0)
    S, E = 16, 4
    logits = t(rng.randn(S, E))
    l_aux, combine, dispatch, exp_counts = route_top1(logits, capacity_factor=1.0, min_capacity=2)
    C = combine.shape[-1]
    assert combine.shape == (S, E, C) and dispatch.shape == (S, E, C)
    assert int(dispatch.sum(dim=(1, 2)).max()) <= 1
    assert int(dispatch.sum(dim=0).max()) <= 1
    assert int(dispatch.sum(dim=(0, 2)).max()) <= C
    gates = softmax(logits)
    mask1 = trouting._one_hot(gates.argmax(1), E)
    expect = torch.sum(gates.mean(0) * mask1.mean(0)) * E
    np.testing.assert_allclose(float(l_aux), float(expect), rtol=1e-5)
    assert torch.equal(exp_counts, mask1.sum(0).to(torch.int32))


def test_ref_route_top2_invariants():
    rng = np.random.RandomState(1)
    logits = t(rng.randn(16, 4))
    _, combine, dispatch, _ = route_top2(logits, capacity_factor=1.0)
    per_token = dispatch.sum(dim=(1, 2))
    assert int(per_token.max()) <= 2
    sums = combine.sum(dim=(1, 2))
    np.testing.assert_allclose(sums[per_token > 0].numpy(), 1.0, rtol=1e-5)


def test_ref_top1_capacity_truncation():
    logits = torch.tensor([[10.0, 0.0]]).repeat(8, 1)
    _, combine, dispatch, exp_counts = route_top1(logits, capacity_factor=1.0, min_capacity=2)
    C = combine.shape[-1]
    assert int(dispatch.sum()) == min(8, C)
    assert int(exp_counts[0]) == 8


def test_ref_top1_used_token_masks_routing():
    rng = np.random.RandomState(2)
    S, E = 16, 4
    logits = t(rng.randn(S, E))
    used = t(np.arange(S) % 2 == 0)
    _, _, dispatch, exp_counts = route_top1(logits, capacity_factor=1.0, min_capacity=2, used_token=used)
    per_token = dispatch.sum(dim=(1, 2))
    assert (per_token[1::2] == 0).all()
    mask1 = trouting._one_hot(softmax(logits).argmax(1), E)
    assert torch.equal(exp_counts, (used[:, None] * mask1).sum(0).to(torch.int32))


def test_ref_top2_used_token_masks_routing():
    rng = np.random.RandomState(6)
    logits = t(rng.randn(16, 4))
    used = t(np.arange(16) < 8)
    _, _, dispatch, exp_counts = route_top2(logits, capacity_factor=2.0, used_token=used)
    per_token = dispatch.sum(dim=(1, 2))
    assert (per_token[8:] == 0).all() and (per_token[:8] > 0).all()
    assert int(exp_counts.sum()) == 8


def test_ref_top1_rsample_uses_noised_argmax_but_clean_weights():
    rng = np.random.RandomState(3)
    logits = t(rng.randn(32, 4) * 0.1)
    gen = torch.Generator().manual_seed(0)
    _, _, d_clean, _ = route_top1(logits, 2.0, min_capacity=2)
    _, c_noise, d_noise, _ = route_top1(logits, 2.0, min_capacity=2, noisy_gate_policy="RSample", rng=gen)
    assert not torch.equal(d_clean, d_noise)
    probs = softmax(logits).numpy()
    combine = c_noise.numpy()
    for s, e in zip(*np.nonzero(combine.sum(2))):
        np.testing.assert_allclose(combine[s, e].sum(), probs[s, e], rtol=1e-5)
    with pytest.raises(ValueError, match="requires an rng"):
        route_top1(logits, 2.0, noisy_gate_policy="RSample")


def test_ref_min_capacity_floor_default():
    _, combine, _, _ = route_top1(torch.zeros(4, 8), capacity_factor=1.0)
    assert combine.shape[-1] == 4


def test_ref_router_jitter_and_eval_capacity():
    rng = np.random.RandomState(4)
    tokens = t(rng.randn(16, MODEL_DIM))
    router = Router(MODEL_DIM, num_experts=4, k=1, capacity_factor=2.0, eval_capacity_factor=0.5,
                    min_capacity=1, noisy_gate_policy="Jitter", device="cpu")
    train_routing = router(tokens, train=True, rng=torch.Generator().manual_seed(7))
    eval_routing = router(tokens, train=False)
    assert train_routing.combine_weights.shape[-1] == 8
    assert eval_routing.combine_weights.shape[-1] == 2
    assert torch.equal(eval_routing.combine_weights, router(tokens, train=False).combine_weights)
    with pytest.raises(ValueError, match="requires an rng"):
        router(tokens, train=True)
    with pytest.raises(ValueError, match="unknown noisy_gate_policy"):
        Router(MODEL_DIM, num_experts=4, noisy_gate_policy="Wiggle", device="cpu")


def test_ref_moe_used_token_end_to_end():
    x = t(np.random.RandomState(5).randn(2, 8, MODEL_DIM))
    used = torch.ones(2, 8)
    used[0, :4] = 0.0
    moe = MoE(MODEL_DIM, MODEL_DIM * 2, num_experts=4, capacity_factor=4.0, ep_size=1, ep_axis=None,
              device="cpu")
    out, _ = moe(x, used_token=used)
    assert torch.all(out[0, :4] == 0.0)
    assert torch.any(out[0, 4:] != 0.0)


class MoEModel(torch.nn.Module):
    """``tests/test_moe.py``'s ``MoEModel``: Dense, ReLU, MoE, Dense."""

    def __init__(self, group, num_experts, ep_size, k=1, generator=None):
        super().__init__()
        self.Dense_0 = Dense(MODEL_DIM, MODEL_DIM, torch.float32, "cpu", generator)
        self.MoE_0 = MoE(MODEL_DIM, MODEL_DIM * 2, num_experts, k=k, capacity_factor=2.0, ep_size=ep_size,
                         ep_axis=ALL_AXES, group=group, device="cpu", generator=generator)
        self.Dense_1 = Dense(MODEL_DIM, 4, torch.float32, "cpu", generator)

    def forward(self, x):
        out, l_aux = self.MoE_0(torch.relu(self.Dense_0(x)))
        return self.Dense_1(out), l_aux


def per_rank_apply(model, stacked, x):
    """``model`` on each rank's tokens under one ``vmap`` over the ranks."""
    return torch.func.vmap(lambda p, xx: torch.func.functional_call(model, dotted_leaves(p), (xx,)))(stacked, x)


def test_ref_ep_matches_local_when_experts_tiled():
    rng = np.random.RandomState(2)
    x = t(rng.randn(N, 16, MODEL_DIM))
    group = cpu_group()
    local = MoEModel(None, NUM_EXPERTS, 1, generator=torch.Generator().manual_seed(0))
    params = module_params(local)
    with torch.no_grad():
        local_out = torch.stack([local(x[r])[0] for r in range(N)])
        ep = MoEModel(group, NUM_EXPERTS, N)
        names = [n for n, _ in tree_flatten_with_names(params)]
        # expert e of the local model becomes rank e's one local expert
        stacked = tree_unflatten(params, [
            leaf[:, None] if "experts" in name else leaf.expand(N, *leaf.shape)
            for name, leaf in zip(names, tree_leaves(params))])
        ep_out = per_rank_apply(ep, stacked, x)[0]
    np.testing.assert_allclose(ep_out.numpy(), local_out.numpy(), rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("k", [1, 2])
def test_ref_moe_ddp_training(k):
    group = cpu_group()
    model = MoEModel(group, NUM_EXPERTS, N, k=k)
    per_rank = [tree_flatten_with_names(module_params(
        MoEModel(group, NUM_EXPERTS, N, k=k, generator=torch.Generator().manual_seed(100 + r)))) for r in range(N)]
    stacked = tree_unflatten(module_params(model), [
        torch.stack([per_rank[r if "experts" in name else 0][i][1] for r in range(N)])
        for i, (name, _) in enumerate(per_rank[0])])

    def loss_fn(params, batch):
        xx, yy = batch
        logits, l_aux = torch.func.functional_call(model, dotted_leaves(params), (xx,))
        return torch.mean((logits - yy) ** 2) + 0.01 * l_aux

    ddp = DistributedDataParallel(loss_fn, lambda ps: torch.optim.Adam(ps, lr=1e-2),
                                  GradientAllReduceAlgorithm(), group, dp_filter=lambda n: "experts" not in n)
    state = ddp.init(stacked_params=stacked)
    rng = np.random.RandomState(3)
    hist = []
    for _ in range(8):
        state, losses = ddp.train_step(state, (t(rng.randn(N * 16, MODEL_DIM)), t(rng.randn(N * 16, 4))))
        hist.append(float(losses.mean()))
    assert all(np.isfinite(hist))
    for name, leaf in tree_flatten_with_names(state.params):
        same = [torch.equal(leaf[0], leaf[r]) for r in range(1, N)]
        assert (not all(same)) if "experts" in name else all(same), name


def test_ref_split_moe_params():
    params = module_params(MoEModel(None, 4, 1))
    non_expert, expert = split_moe_params(params)
    assert expert and non_expert
    assert all("experts" in k for k in expert)
    assert all("experts" not in k for k in non_expert)


def _ep_moe(chunks, group=None, ep_size=N, ep_axis=ALL_AXES):
    return MoE(MODEL_DIM, MODEL_DIM * 2, NUM_EXPERTS, capacity_factor=2.0, ep_size=ep_size, ep_axis=ep_axis,
               a2a_chunks=chunks, group=group or cpu_group(), device="cpu",
               generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("chunks", [2, 4])
def test_ref_a2a_chunks_bitwise_matches_unchunked(chunks):
    x = t(np.random.RandomState(3).randn(N, 16, MODEL_DIM))
    moe1, moec = _ep_moe(1), _ep_moe(chunks)
    params = module_params(moe1)
    assert [(n, tuple(p.shape)) for n, p in moe1.named_parameters()] == \
        [(n, tuple(p.shape)) for n, p in moec.named_parameters()]
    with torch.no_grad():
        ref = torch.func.vmap(lambda xx: torch.func.functional_call(moe1, dotted_leaves(params), (xx,))[0])(x)
        got = torch.func.vmap(lambda xx: torch.func.functional_call(moec, dotted_leaves(params), (xx,))[0])(x)
    assert torch.equal(got, ref)


def test_ref_a2a_chunks_clamps_to_capacity_divisor():
    ffn = ExpertParallelFFN(MODEL_DIM, 8, 16, a2a_chunks=5, device="cpu")
    assert ffn._resolve_chunks(8) == 4
    assert ffn._resolve_chunks(7) == 1
    assert ExpertParallelFFN(MODEL_DIM, 8, 16, a2a_chunks=64, device="cpu")._resolve_chunks(8) == 8


def test_ref_typod_ep_axis_raises_clear_error():
    with pytest.raises(ValueError, match="none of the declared expert-parallel axes"):
        _ep_moe(1, ep_axis="exprt")


# ---------------------------------------------------------------------------
# The port against the JAX package
# ---------------------------------------------------------------------------


def test_claim_slots_clamps_like_jnp_sort():
    """Capacity above the token count: ``jnp.sort(x)[-capacity]`` clamps
    its index to 0 (every token fits) where torch would raise."""
    mask = np.eye(3, 2, dtype=np.float32)
    priority = np.random.RandomState(0).rand(3, 2).astype(np.float32)
    assert float(jnp.sort(jnp.arange(3.0))[-5]) == 0.0
    want_mask, want_slot = jrouting._claim_slots(jnp.asarray(mask), 5, priority=jnp.asarray(priority))
    got_mask, got_slot = trouting._claim_slots(t(mask), 5, priority=t(priority))
    assert np.array_equal(got_mask.numpy(), np.asarray(want_mask)) and got_mask.sum() == 2
    assert np.array_equal(got_slot.numpy(), np.asarray(want_slot))


def _same_routing(got, want):
    assert np.array_equal(got.dispatch_mask.numpy(), np.asarray(want.dispatch_mask))
    assert np.array_equal(got.tokens_per_expert.numpy(), np.asarray(want.tokens_per_expert))
    assert got.tokens_per_expert.dtype == torch.int32
    np.testing.assert_allclose(got.combine_weights.numpy(), np.asarray(want.combine_weights), rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(got.balance_loss), float(want.balance_loss), rtol=1e-6)


ROUTING_CASES = {
    "top1": dict(k=1, S=64, E=8, factor=1.0, used=False),
    "top1 truncated": dict(k=1, S=64, E=4, factor=0.5, used=False),
    "top1 used_token": dict(k=1, S=48, E=8, factor=1.0, used=True),
    "top1 min capacity": dict(k=1, S=6, E=8, factor=1.0, used=False),
    "top2": dict(k=2, S=64, E=8, factor=1.25, used=False),
    "top2 truncated": dict(k=2, S=64, E=4, factor=0.5, used=False),
    "top2 used_token": dict(k=2, S=48, E=8, factor=1.0, used=True),
}


@pytest.mark.parametrize("case", sorted(ROUTING_CASES))
def test_routing_matches_jax(case):
    c = ROUTING_CASES[case]
    rng = np.random.RandomState(sorted(ROUTING_CASES).index(case))
    logits = (rng.randn(c["S"], c["E"]) * 2).astype(np.float32)
    used = (rng.rand(c["S"]) < 0.7).astype(np.float32) if c["used"] else None
    ju = None if used is None else jnp.asarray(used)
    tu = None if used is None else t(used)
    if c["k"] == 1:
        want = jrouting.route_top1(jnp.asarray(logits), c["factor"], used_token=ju)
        got = route_top1(t(logits), c["factor"], used_token=tu)
    else:
        want = jrouting.route_top2(jnp.asarray(logits), c["factor"], used_token=ju)
        got = route_top2(t(logits), c["factor"], used_token=tu)
    _same_routing(got, want)


def test_random_paths_match_jax_given_its_draws():
    """JAX's Gumbel noise and uniform priority, fed to the port's
    primitives in ``route_top1``'s and ``route_top2``'s order: JAX's masks
    exactly, its weights within rtol 1e-6."""
    rng = np.random.RandomState(9)
    S, E = 32, 4
    logits = (rng.randn(S, E) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(0)
    noise = t(jax.random.gumbel(key, logits.shape, dtype=jnp.float32))
    probs = softmax(t(logits))

    want = jrouting.route_top1(jnp.asarray(logits), 0.5, min_capacity=2, noisy_gate_policy="RSample", rng=key)
    cap = trouting.expert_capacity(S, E, 0.5, floor=2)
    priority = t(jax.random.uniform(jax.random.fold_in(key, 1), logits.shape))
    chosen = trouting._one_hot(torch.argmax(t(logits) + noise, dim=1), E)
    kept, slot = trouting._claim_slots(chosen, cap, priority=priority)
    combine = trouting._combine(torch.sum(probs * kept, dim=1), kept, slot, cap)
    assert np.array_equal((combine > 0).numpy(), np.asarray(want.dispatch_mask))
    np.testing.assert_allclose(combine.numpy(), np.asarray(want.combine_weights), rtol=1e-6, atol=0)

    want = jrouting.route_top2(jnp.asarray(logits), 1.0, rng=key)
    cap = trouting.expert_capacity(S, E, 1.0, k=2)
    first = trouting._one_hot(torch.argmax(probs, dim=1), E)
    second = trouting._one_hot(torch.argmax(torch.where(first > 0, -np.inf, t(logits) + noise), dim=1), E)
    kept1, slot1 = trouting._claim_slots(first, cap)
    kept2, slot2 = trouting._claim_slots(second, cap, start_at=first.sum(0))
    w1, w2 = torch.sum(probs * kept1, dim=1), torch.sum(probs * kept2, dim=1)
    norm = torch.clamp(w1 + w2, min=torch.finfo(torch.float32).eps)
    combine = trouting._combine(w1 / norm, kept1, slot1, cap) + trouting._combine(w2 / norm, kept2, slot2, cap)
    assert np.array_equal((combine > 0).numpy(), np.asarray(want.dispatch_mask))
    np.testing.assert_allclose(combine.numpy(), np.asarray(want.combine_weights), rtol=1e-6, atol=0)


def _flax_moe(x, ep_size, k, chunks=1, ep_axis="ep"):
    moe = JMoE(hidden_size=MODEL_DIM * 2, num_experts=NUM_EXPERTS, k=k, capacity_factor=1.25, ep_size=ep_size,
               ep_axis=ep_axis, a2a_chunks=chunks)
    return moe, jax.tree.map(np.asarray, moe.init(jax.random.PRNGKey(0), x)["params"])


def _grad_tols(got_leaves, want_tree, got_names):
    for name, g, w in zip(got_names, got_leaves, jax.tree.leaves(want_tree)):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        assert np.abs(g.numpy() - w).max() <= 1e-5 * max(np.abs(w).max(), 1.0), name


@pytest.mark.parametrize("k", [1, 2])
def test_expert_parallel_ffn_ep1_matches_jax(k):
    rng = np.random.RandomState(10 + k)
    x = rng.randn(2, 24, MODEL_DIM).astype(np.float32)
    cot = rng.randn(2, 24, MODEL_DIM).astype(np.float32)
    jmoe, jp = _flax_moe(jnp.asarray(x), 1, k)
    (jout, jl), vjp = jax.vjp(lambda p, xx: jmoe.apply({"params": p}, xx), jp, jnp.asarray(x))
    jg, jgx = vjp((jnp.asarray(cot), jnp.float32(0.3)))
    moe = MoE(MODEL_DIM, MODEL_DIM * 2, NUM_EXPERTS, k=k, capacity_factor=1.25, device="cpu")
    tp = params_from_jax(jp)
    leaves = [leaf.requires_grad_(True) for leaf in tree_leaves(tp)]
    xx = t(x).requires_grad_(True)
    out, l_aux = torch.func.functional_call(moe, dotted_leaves(tree_unflatten(tp, leaves)), (xx,))
    scale = np.abs(np.asarray(jout)).max()
    assert np.abs(out.detach().numpy() - np.asarray(jout)).max() <= 1e-6 * scale
    np.testing.assert_allclose(float(l_aux.detach()), float(jl), rtol=1e-6)
    ((out * t(cot)).sum() + 0.3 * l_aux).backward()
    _grad_tols([leaf.grad for leaf in leaves], jg, [n for n, _ in tree_flatten_with_names(tp)])
    assert np.abs(xx.grad.numpy() - np.asarray(jgx)).max() <= 1e-5 * np.abs(np.asarray(jgx)).max()


@pytest.mark.parametrize("k", [1, 2])
def test_expert_parallel_ffn_ep8_matches_shard_map(k):
    """ep 8 over the 8-rank group: the port's ``vmap`` over the ranks with
    the stacked all-to-all against JAX's ``shard_map`` with
    ``lax.all_to_all``; per-rank experts, the gate replicated."""
    rng = np.random.RandomState(20 + k)
    x = rng.randn(N, 16, MODEL_DIM).astype(np.float32)
    cot = rng.randn(N, 16, MODEL_DIM).astype(np.float32)
    jmoe = JMoE(hidden_size=MODEL_DIM * 2, num_experts=NUM_EXPERTS, k=k, capacity_factor=1.25, ep_size=N,
                ep_axis="ep")
    per_rank = [jmoe.init(jax.random.PRNGKey(r), jnp.asarray(x[0]))["params"] for r in range(N)]
    per_rank = [jax.tree_util.tree_map_with_path(
        lambda path, b, pr: pr if "experts" in jax.tree_util.keystr(path) else b, per_rank[0], p) for p in per_rank]
    jstacked = jax.tree.map(lambda *xs: jnp.stack(xs), *per_rank)
    mesh = Mesh(np.array(jax.devices()[:N]), ("ep",))

    def f(p, xx):
        def body(pp, xr):
            out, l_aux = jmoe.apply({"params": jax.tree.map(lambda q: q[0], pp)}, xr[0])
            return out[None], l_aux[None]
        outs, ls = jax.shard_map(body, mesh=mesh, in_specs=(P("ep"), P("ep")), out_specs=(P("ep"), P("ep")),
                                 check_vma=False)(p, xx)
        return outs, ls

    (jout, jls), vjp = jax.vjp(f, jstacked, jnp.asarray(x))
    jg, jgx = vjp((jnp.asarray(cot), jnp.full((N,), 0.3, jnp.float32)))

    group = cpu_group()
    moe = MoE(MODEL_DIM, MODEL_DIM * 2, NUM_EXPERTS, k=k, capacity_factor=1.25, ep_size=N, ep_axis=ALL_AXES,
              group=group, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jstacked))
    leaves = [leaf.requires_grad_(True) for leaf in tree_leaves(tp)]
    xx = t(x).requires_grad_(True)
    out, ls = per_rank_apply(moe, tree_unflatten(tp, leaves), xx)
    scale = np.abs(np.asarray(jout)).max()
    assert np.abs(out.detach().numpy() - np.asarray(jout)).max() <= 1e-6 * scale
    np.testing.assert_allclose(ls.detach().numpy(), np.asarray(jls), rtol=1e-6)
    ((out * t(cot)).sum() + 0.3 * ls.sum()).backward()
    _grad_tols([leaf.grad for leaf in leaves], jg, [n for n, _ in tree_flatten_with_names(tp)])
    assert np.abs(xx.grad.numpy() - np.asarray(jgx)).max() <= 1e-5 * np.abs(np.asarray(jgx)).max()


@pytest.mark.parametrize("axis", [ALL_AXES, "inter", "intra"], ids=["all", "inter", "intra"])
def test_rank_alltoall_under_vmap_is_the_stacked_alltoall(axis):
    group = cpu_group()
    x = t(np.random.RandomState(7).randn(N, 8, 3)).requires_grad_(True)
    cot = t(np.random.RandomState(8).randn(N, 8, 3))
    y = torch.func.vmap(lambda v: rank_alltoall(v * 2.0, group, axis))(x)
    assert torch.equal(y, alltoall(x.detach() * 2.0, group, axis))
    (y * cot).sum().backward()
    assert torch.equal(x.grad, alltoall(cot, group, axis) * 2.0)  # the exchange is its own transpose


def test_rank_alltoall_raises_outside_vmap_and_on_bad_shapes():
    group = cpu_group()
    with pytest.raises(RuntimeError, match="runs under torch.func.vmap"):
        rank_alltoall(torch.zeros(8, 2), group, ALL_AXES)
    with pytest.raises(ValueError, match="does not divide"):
        torch.func.vmap(lambda v: rank_alltoall(v, group, ALL_AXES))(torch.zeros(N, 6, 2))
    with pytest.raises(ValueError, match="under a vmap of 4"):
        torch.func.vmap(lambda v: rank_alltoall(v, group, "intra"))(torch.zeros(4, 8, 2))


def test_ep_size_must_match_the_group_axes():
    with pytest.raises(ValueError, match="have total size 4"):
        _ep_moe(1, ep_axis="intra")
    with pytest.raises(ValueError, match="needs the process group"):
        MoE(MODEL_DIM, 16, NUM_EXPERTS, ep_size=N, device="cpu")
    with pytest.raises(ValueError, match="must divide evenly"):
        MoE(MODEL_DIM, 16, 6, ep_size=4, group=cpu_group(4), device="cpu")


def test_jax_layer_is_the_reference():
    """The replays above hold the port to ``tests/test_moe.py``; the JAX
    layer's own chunk clamp is the one ``_resolve_chunks`` copies."""
    ffn = jlayer.ExpertParallelFFN(num_experts=8, hidden_dim=16, a2a_chunks=5)
    port = ExpertParallelFFN(MODEL_DIM, 8, 16, a2a_chunks=5, device="cpu")
    assert [ffn._resolve_chunks(c) for c in range(1, 20)] == [port._resolve_chunks(c) for c in range(1, 20)]
