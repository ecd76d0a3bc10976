"""The engine's ``dp_filter`` (leaves kept out of every bucket) against the
JAX package, on an 8-rank CPU group (``intra_size=4``).

A leaf the filter excludes is in no bucket and never exchanged: it keeps
its local gradient, monolithic and overlap, under ZeRO (a replicated
optimizer of its own) and through QAdam's overlap branch for such leaves.
The plan's filter and fallbacks are held bitwise to the JAX plan's; engine
runs within ``F32_TOL`` (rtol 1e-5, atol 1e-6) of the JAX engine's, QAdam
within the tiers of ``tests/test_torch_q_adam.py`` (a quantized momentum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bagua_tpu.algorithms.gradient_allreduce import GradientAllReduceAlgorithm as JaxGradientAllReduce
from bagua_tpu.algorithms.q_adam import QAdamAlgorithm as JaxQAdam, QAdamOptimizer as JaxQAdamOptimizer
from bagua_tpu.bucket import BucketPlan as JaxBucketPlan
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP
from bagua_tpu.models import mlp as jax_mlp
from bagua_tpu.sharded import ZeroAlgorithm as JaxZero

from bagua_tpu_torch.algorithms import GradientAllReduceAlgorithm, QAdamAlgorithm, QAdamOptimizer
from bagua_tpu_torch.bucket import BucketPlan
from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.models import mlp
from bagua_tpu_torch.sharded import ZeroAlgorithm
from bagua_tpu_torch.utils import tree_flatten_with_names, tree_leaves

N = 8
LAYERS = [10, 16, 4]
BUCKET = 1 << 9
STEPS, LR = 4, 0.05
F32_TOL = dict(rtol=1e-5, atol=1e-6)
EXCLUDED = "['layer1']['b']"


def keep(name: str) -> bool:
    return name != EXCLUDED


@pytest.fixture()
def tgroup():
    return BaguaProcessGroup([torch.device("cpu")] * N, intra_size=4)


def jax_params(seed=0, layers=LAYERS):
    return jax.tree.map(np.asarray, jax_mlp.init_mlp(jax.random.PRNGKey(seed), layers))


def batches(seed=0, layers=LAYERS, steps=STEPS):
    rng = np.random.RandomState(seed)
    return [(rng.randn(32, layers[0]).astype(np.float32), rng.randn(32, layers[-1]).astype(np.float32))
            for _ in range(steps)]


def test_plan_filter_and_fallback_match_jax():
    """Same buckets as the JAX plan with the filter; ``debucketize`` and
    ``ungroup_leaves`` take an excluded leaf from ``fallback`` and raise the
    JAX plan's KeyError without one."""
    params = jax_params()
    jplan = JaxBucketPlan.from_tree(params, BUCKET, align_elems=N, filter_fn=keep)
    tparams = params_from_jax(params)
    plan = BucketPlan.from_tree(tparams, BUCKET, align_elems=N, filter_fn=keep)
    decl = lambda p: [[(td.name, td.num_elements, td.dtype) for td in b] for b in p.declarations()]  # noqa: E731
    assert decl(plan) == decl(jplan)
    assert [spec.numel for spec in plan.specs] == [spec.numel for spec in jplan.specs]
    assert EXCLUDED not in plan.covered() and len(plan.covered()) == len(tree_leaves(tparams)) - 1
    flats = plan.bucketize(tparams)
    for f, jf in zip(flats, jplan.bucketize(params)):
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    fallback = {k: {kk: v + 100 for kk, v in d.items()} for k, d in tparams.items()}
    for back in (plan.debucketize(flats, fallback), plan.ungroup_leaves(plan.group_leaves(tparams), fallback)):
        for name, leaf in tree_flatten_with_names(back):
            want = fallback if name == EXCLUDED else tparams
            assert torch.equal(leaf, dict(tree_flatten_with_names(want))[name])
    with pytest.raises(KeyError) as got:
        plan.debucketize(flats)
    with pytest.raises(KeyError) as want:
        jplan.debucketize(jplan.bucketize(params))
    assert str(got.value) == str(want.value)


def run_pair(group, tgroup, jalgo, algo, overlap, jopt, opt, data, params):
    jddp = JaxDDP(jax_mlp.mse_loss, jopt, jalgo, process_group=group, bucket_size_bytes=BUCKET,
                  dp_filter=keep, overlap=overlap)
    ddp = DistributedDataParallel(mlp.mse_loss, opt, algo, tgroup, bucket_size_bytes=BUCKET, dp_filter=keep,
                                  overlap=overlap)
    jstate, state = jddp.init(params), ddp.init(params_from_jax(params))
    for x, y in data:
        jstate, _ = jddp.train_step(jstate, (jnp.asarray(x), jnp.asarray(y)))
        state, _ = ddp.train_step(state, (torch.from_numpy(x), torch.from_numpy(y)))
    return jddp, jstate, ddp, state


@pytest.mark.parametrize("overlap", [False, True], ids=["mono", "overlap"])
@pytest.mark.parametrize("sharded", [False, True], ids=["gar", "zero"])
def test_excluded_leaf_keeps_local_gradient(group, tgroup, overlap, sharded):
    """``gradient_allreduce`` and f32 ZeRO (SGD momentum) with the bias of
    the last layer excluded: the covered leaves stay equal on every rank,
    the excluded one parts (its ranks step on their own gradients), all
    within F32_TOL of the JAX engine; ZeRO bitwise the unsharded run, its
    excluded leaf under a replicated optimizer of its own."""
    params, data = jax_params(1), batches(1)
    jalgo, algo = (JaxZero(), ZeroAlgorithm()) if sharded else (JaxGradientAllReduce(), GradientAllReduceAlgorithm())

    def opt(ps):
        return torch.optim.SGD(ps, lr=LR, momentum=0.9)

    jddp, jstate, ddp, state = run_pair(group, tgroup, jalgo, algo, overlap, optax.sgd(LR, momentum=0.9), opt,
                                        data, params)
    assert ddp.overlap_enabled is overlap and EXCLUDED not in ddp.plan.covered()
    state = ddp.finalize_pending_updates(state)
    jstate = jddp.finalize_pending_updates(jstate)
    for (name, got), want in zip(tree_flatten_with_names(state.params), jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
        same = all(torch.equal(got[0], got[r]) for r in range(1, N))
        assert same is (name != EXCLUDED), name
    if sharded:
        assert state.optimizer.local is not None and len(state.optimizer.local.param_groups[0]["params"]) == 1
        plain = DistributedDataParallel(mlp.mse_loss, opt, GradientAllReduceAlgorithm(), tgroup,
                                        bucket_size_bytes=BUCKET, dp_filter=keep, overlap=overlap)
        pstate = plain.init(params_from_jax(params))
        for x, y in data:
            pstate, _ = plain.train_step(pstate, (torch.from_numpy(x), torch.from_numpy(y)))
        for a, b in zip(tree_leaves(state.params), tree_leaves(pstate.params)):
            assert torch.equal(a, b)


QLAYERS, QLR, QBUCKET = [10, 8, 3], 0.01, 128


def tiers(got, want, loose, tight, share=0.05):
    d = np.concatenate([np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64)).ravel()
                        for g, w in zip(got, want)])
    return d.max() <= loose and (d > tight).mean() <= share


def test_qadam_uncovered_leaf_branch(group, tgroup):
    """QAdam (warmup 2, 5 steps) with the last bias excluded: with overlap
    the excluded leaf reaches ``finalize_overlap`` with its local gradient,
    and in compression its momentum is updated there from it, as the
    monolithic step updates it before its exchange: overlap equals the
    monolithic run bit for bit (parameters and both moments); against the
    JAX engine's overlap run the parameters are within STEPS Adam steps
    everywhere and, but for 5%, within a thousandth of that."""
    params, data = jax_params(2, QLAYERS), batches(2, QLAYERS, 5)
    excluded = "['layer1']['b']"

    def run(overlap):
        ddp = DistributedDataParallel(mlp.mse_loss, None, QAdamAlgorithm(QAdamOptimizer(lr=QLR, warmup_steps=2)),
                                      tgroup, bucket_size_bytes=QBUCKET, dp_filter=keep, overlap=overlap)
        state = ddp.init(params_from_jax(params))
        for x, y in data:
            state, _ = ddp.train_step(state, (torch.from_numpy(x), torch.from_numpy(y)))
        return ddp, state

    mono, mstate = run(False)
    ov, ostate = run(True)
    assert ov.overlap_enabled and excluded not in ov.plan.covered()
    for key in ("exp_avg", "exp_avg_sq"):
        for a, b in zip(tree_leaves(mstate.algo_state[key]), tree_leaves(ostate.algo_state[key])):
            assert torch.equal(a, b)
    for a, b in zip(tree_leaves(mstate.params), tree_leaves(ostate.params)):
        assert torch.equal(a, b)
    m = dict(tree_flatten_with_names(ostate.algo_state["exp_avg"]))[excluded]
    assert not all(torch.equal(m[0], m[r]) for r in range(1, N)), "the excluded momentum stays local"
    jddp = JaxDDP(jax_mlp.mse_loss, None, JaxQAdam(JaxQAdamOptimizer(lr=QLR, warmup_steps=2)), process_group=group,
                  bucket_size_bytes=QBUCKET, dp_filter=keep, overlap=True)
    jstate = jddp.init(params)
    for x, y in data:
        jstate, _ = jddp.train_step(jstate, (jnp.asarray(x), jnp.asarray(y)))
    got, want = [t.numpy() for t in tree_leaves(ostate.params)], jax.tree.leaves(jstate.params)
    steps = len(data)
    assert tiers(got, want, steps * QLR, steps * QLR * 1e-3)
    start = [np.broadcast_to(a, (N, *a.shape)) for a in jax.tree.leaves(params)]
    assert not tiers(start, want, steps * QLR, steps * QLR * 1e-3)
