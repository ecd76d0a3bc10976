"""The port's QAdam against the JAX package, on an 8-rank CPU group
(``intra_size=4``), across the warmup -> compression switch.

The problem is the JAX QAdam tests' (an MLP [10, 8, 3], LR 0.01): its
units all see a gradient in warmup, so no second moment is left at zero
to divide the quantized momentum by eps.  Bounds: the first moment within
quantization steps of the widest chunk the exchange compresses (a
momentum one rounding away may land one level away); the frozen second
moment within f32 rounding; the parameters within STEPS Adam steps (LR
each, whatever the gradient's scale) everywhere and, but for
FLIPPED_SHARE of them, within a thousandth of that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bagua_tpu.algorithms.q_adam import QAdamAlgorithm as JaxQAdam, QAdamOptimizer as JaxQAdamOptimizer
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP
from bagua_tpu.models import mlp as jax_mlp

from bagua_tpu_torch.algorithms import QAdamAlgorithm, QAdamOptimizer, build_algorithm
from bagua_tpu_torch.algorithms import bytegrad
from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.models import mlp
from bagua_tpu_torch.utils import tree_leaves

N = 8
LAYERS = [10, 8, 3]
LR, STEPS = 0.01, 5
BUCKET = 128  # three buckets of the MLP
FLIPPED_SHARE = 0.05


@pytest.fixture()
def tgroup():
    return BaguaProcessGroup([torch.device("cpu")] * N, intra_size=4)


def jax_params():
    return jax_mlp.init_mlp(jax.random.PRNGKey(2), LAYERS)


def batches(steps=STEPS):
    rng = np.random.RandomState(2)
    return [(rng.randn(N * 4, LAYERS[0]).astype(np.float32), rng.randn(N * 4, LAYERS[-1]).astype(np.float32))
            for _ in range(steps)]


class _Codec:
    """Wraps ByteGrad's compress in the port: the calls, and the widest
    level ((max - min) / 255) of the chunks it compresses."""

    def __init__(self, monkeypatch):
        self.calls, self.width = 0, 0.0
        inner = bytegrad.compress_minmax_uint8

        def compress(x):
            q, mm = inner(x)
            self.calls += 1
            self.width = max(self.width, float((mm[:, 1] - mm[:, 0]).max()) / 255.0)
            return q, mm

        monkeypatch.setattr(bytegrad, "compress_minmax_uint8", compress)


def run_port(group, warmup, hierarchical, overlap=False, data=None, on_step=None):
    algo = QAdamAlgorithm(QAdamOptimizer(lr=LR, warmup_steps=warmup), hierarchical=hierarchical)
    ddp = DistributedDataParallel(mlp.mse_loss, None, algo, group, bucket_size_bytes=BUCKET, overlap=overlap)
    state = ddp.init(params_from_jax(jax.tree.map(np.asarray, jax_params())))
    for x, y in data or batches():
        state, _ = ddp.train_step(state, (torch.from_numpy(x), torch.from_numpy(y)))
        if on_step:
            on_step(state)
    return ddp, state


def run_jax(group, warmup, hierarchical, overlap=False):
    algo = JaxQAdam(JaxQAdamOptimizer(lr=LR, warmup_steps=warmup), hierarchical=hierarchical)
    ddp = JaxDDP(jax_mlp.mse_loss, None, algo, process_group=group, bucket_size_bytes=BUCKET, overlap=overlap)
    state = ddp.init(jax_params())
    for x, y in batches():
        state, _ = ddp.train_step(state, (jnp.asarray(x), jnp.asarray(y)))
    return ddp, state


def tiers(got, want, loose, tight):
    d = np.concatenate([np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64)).ravel()
                        for g, w in zip(got, want)])
    return d.max() <= loose and (d > tight).mean() <= FLIPPED_SHARE


def test_hyperparameters_are_checked_as_in_jax():
    for kw in (dict(lr=-1.0), dict(eps=-1.0), dict(warmup_steps=0), dict(betas=(1.0, 0.999)),
               dict(betas=(0.9, -0.1))):
        with pytest.raises(ValueError) as want:
            JaxQAdamOptimizer(**kw)
        with pytest.raises(ValueError) as got:
            QAdamOptimizer(**kw)
        assert str(got.value) == str(want.value)
    opt = QAdamOptimizer(lr=0.3).to_torch()([torch.zeros(2)])
    assert isinstance(opt, torch.optim.SGD) and opt.defaults["lr"] == 0.3 and opt.defaults["momentum"] == 0


# warmup 2: the moments update at step 0 only, compression from step 2;
# warmup 3: at steps 0-1, compression from step 3
@pytest.mark.parametrize("warmup", [2, 3])
@pytest.mark.parametrize("hierarchical", [False, True], ids=["flat", "hier"])
def test_engine_matches_jax_across_the_switch(group, tgroup, monkeypatch, warmup, hierarchical):
    codec = _Codec(monkeypatch)
    jddp, jstate = run_jax(group, warmup, hierarchical)
    ddp, state = run_port(tgroup, warmup, hierarchical)
    assert ddp.plan.num_buckets == jddp.plan.num_buckets == 3 and not ddp.overlap_enabled
    compressions = STEPS - warmup
    # one compress per bucket and compression step (the requantize is the
    # fused reduce's own), flat or over the two inter ranks
    assert codec.calls == compressions * ddp.plan.num_buckets and codec.width > 0
    for leaf in tree_leaves(state.params):
        assert all(torch.equal(leaf[0], leaf[r]) for r in range(1, N))
    m, v = (tree_leaves(state.algo_state[k]) for k in ("exp_avg", "exp_avg_sq"))
    jm, jv = (jax.tree.leaves(jstate.algo_state[k]) for k in ("exp_avg", "exp_avg_sq"))
    assert tiers([t.numpy() for t in m], jm, 2 * compressions * codec.width, 1e-3 * codec.width)
    for got, want in zip(v, jv):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-9)
    got, want = [t.numpy() for t in tree_leaves(state.params)], jax.tree.leaves(jstate.params)
    assert tiers(got, want, STEPS * LR, STEPS * LR * 1e-3)
    start = [np.broadcast_to(a, (N, *a.shape)) for a in jax.tree.leaves(jax_params())]
    assert not tiers(start, want, STEPS * LR, STEPS * LR * 1e-3)


def test_moments_follow_the_off_by_one(tgroup):
    """The last warmup step averages the gradients but leaves both moments
    as they were; compression freezes the second moment and moves the
    first."""
    seen = []
    run_port(tgroup, 3, False, data=batches(5),
             on_step=lambda s: seen.append([t.clone() for k in ("exp_avg", "exp_avg_sq")
                                            for t in tree_leaves(s.algo_state[k])]))
    n = len(tree_leaves(jax_params()))
    moved = [any(not torch.equal(a, b) for a, b in zip(seen[i][:n], seen[i + 1][:n])) for i in range(4)]
    moved_sq = [any(not torch.equal(a, b) for a, b in zip(seen[i][n:], seen[i + 1][n:])) for i in range(4)]
    # steps 1..4 against the step before: step 2 is the last warmup step
    assert moved == [True, False, True, True] and moved_sq == [True, False, False, False]


@pytest.mark.parametrize("hierarchical", [False, True], ids=["flat", "hier"])
def test_overlap_equals_monolithic_bitwise(tgroup, monkeypatch, hierarchical):
    """Each bucket's exchange from inside the backward, in both phases,
    gives the monolithic run's bits; the codec runs on compression steps
    only, once per bucket as in the monolithic step."""
    codec = _Codec(monkeypatch)
    finals = {}
    for overlap in (False, True):
        calls = codec.calls
        ddp, state = run_port(tgroup, 2, hierarchical, overlap=overlap)
        assert ddp.overlap_enabled is overlap and ddp.plan.num_buckets == 3
        assert codec.calls - calls == (STEPS - 2) * 3
        finals[overlap] = state
    assert ddp.exchange_counts == [STEPS] * 3 and ddp.exchange_order == ddp.plan.backward_order()
    for a, b in zip(tree_leaves(finals[False].params), tree_leaves(finals[True].params)):
        assert torch.equal(a, b)
    for k in ("exp_avg", "exp_avg_sq"):
        for a, b in zip(tree_leaves(finals[False].algo_state[k]), tree_leaves(finals[True].algo_state[k])):
            assert torch.equal(a, b)


def test_overlap_matches_jax_overlap(group, tgroup):
    jddp, jstate = run_jax(group, 2, True, overlap=True)
    ddp, state = run_port(tgroup, 2, True, overlap=True)
    assert jddp.overlap_enabled and ddp.overlap_enabled
    got, want = [t.numpy() for t in tree_leaves(state.params)], jax.tree.leaves(jstate.params)
    assert tiers(got, want, STEPS * LR, STEPS * LR * 1e-3)


def test_build_algorithm_configures_the_bundled_optimizer(tgroup):
    algo = build_algorithm("qadam", lr=0.2, qadam_warmup_steps=7)
    impl = algo.reify(tgroup)
    assert impl.warmup_steps == 7 and impl.optimizer.lr == 0.2 and impl.algo_name == "q_adam"
    mine = QAdamOptimizer(lr=0.5, warmup_steps=1)
    assert build_algorithm("qadam", lr=0.2, q_adam_optimizer=mine).optimizer is mine
    ddp = DistributedDataParallel(mlp.mse_loss, None, algo, tgroup)
    assert ddp.overlap_enabled and ddp.impl.overlap_capability().mode == "gradient"
    state = ddp.init(params_from_jax(jax.tree.map(np.asarray, jax_params())))
    for leaf, p in zip(tree_leaves(state.algo_state["exp_avg"]), tree_leaves(state.params)):
        assert leaf.shape == p.shape and not leaf.any()


def test_short_warmup_runs_away_at_the_default_eps(group, tgroup):
    """A small VGG over the 8 ranks, warmup 2, lr 1e-3: the moments see
    step 0 only, so a weight whose gradient was zero there has a zero
    second moment, and once it gets a gradient its direction is m / (bc1
    eps).  At the default eps (1e-8) both packages' losses run away within
    6 steps; at 1e-3 both train, within the parameter tiers of each other.
    This is why ``chip_smoke.py`` runs QAdam at eps 1e-3."""
    from bagua_tpu.models.vgg import VGG as FlaxVGG, vgg_loss_fn as flax_vgg_loss_fn

    from bagua_tpu_torch.models.vgg import VGG, vgg_loss_fn

    cfg = dict(num_classes=10, cfg=(16, "M", 32, "M"), classifier_width=64)
    fmodel = FlaxVGG(**cfg)
    params = jax.tree.map(np.asarray, fmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))["params"])
    rng = np.random.RandomState(0)
    x, y = rng.rand(32, 32, 32, 3).astype(np.float32), rng.randint(0, 10, 32).astype(np.int32)
    for eps in (1e-8, 1e-3):
        opt = dict(lr=1e-3, warmup_steps=2, eps=eps)
        jddp = JaxDDP(flax_vgg_loss_fn(fmodel), None, JaxQAdam(JaxQAdamOptimizer(**opt)), process_group=group)
        ddp = DistributedDataParallel(vgg_loss_fn(VGG(device="cpu", image_size=32, **cfg)), None,
                                      QAdamAlgorithm(QAdamOptimizer(**opt)), tgroup)
        jstate, state = jddp.init(params), ddp.init(params_from_jax(params))
        for _ in range(6):
            jstate, jloss = jddp.train_step(jstate, (jnp.asarray(x), jnp.asarray(y)))
            state, loss = ddp.train_step(state, (torch.from_numpy(x), torch.from_numpy(y)))
        jloss, loss = float(np.asarray(jloss).mean()), float(loss.mean())
        if eps == 1e-8:
            assert not (jloss < 1e6) and not (loss < 1e6), (jloss, loss)
        else:
            assert loss < 2.3 and jloss < 2.3
            got, want = [t.numpy() for t in tree_leaves(state.params)], jax.tree.leaves(jstate.params)
            assert tiers(got, want, 6 * 1e-3, 6 * 1e-3 * 1e-3)


def test_synthetic_benchmark_brings_qadams_optimizer(capsys):
    """The twin passes ``optimizer=None`` for ``qadam``, as the reference's
    benchmark does: its run equals a ``Trainer`` run with QAdam's own SGD
    on the same batch, bit for bit."""
    from bagua_tpu_torch.examples import synthetic_benchmark as sb
    from bagua_tpu_torch.models.vgg import VGG, module_params, vgg_loss_fn
    from bagua_tpu_torch.trainer import Trainer

    group = BaguaProcessGroup([torch.device("cpu")] * 4, intra_size=1)
    model = VGG(device="cpu", generator=torch.Generator().manual_seed(0), num_classes=10, cfg=(8, "M", 16, "M"),
                classifier_width=32, image_size=32)
    params = module_params(model)
    opt = QAdamOptimizer(lr=1e-3, warmup_steps=2, eps=1e-3)
    result = sb.run(model, params, group, "qadam", {"q_adam_optimizer": opt}, batch_size=2, num_iters=2, num_warmup=1)
    assert "algorithm=qadam" in capsys.readouterr().out and result.ddp.impl.optimizer is opt
    assert isinstance(result.state.optimizer, torch.optim.SGD) and result.state.optimizer.defaults["lr"] == 1e-3
    trainer = Trainer(vgg_loss_fn(model), None, QAdamAlgorithm(opt), group)
    state = trainer.fit(trainer.init_state(params), [result.batch] * 3)
    for a, b in zip(tree_leaves(result.state.params), tree_leaves(state.params)):
        assert torch.equal(a, b)
