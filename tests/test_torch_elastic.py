"""The elastic twin (``bagua_tpu_torch/examples/elastic_training.py``)
against the JAX example (``examples/elastic_training/main.py``): the same
MLP [32, 64, 8] parameters (``convert.params_from_jax``), the same
``RandomState(0)`` batches, ``gradient_allreduce`` with Adam 1e-3 on the
8-rank groups; each step's mean loss agrees within f32 rounding, and a
run cut at a checkpoint and restarted resumes there."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from bagua_tpu.algorithms import Algorithm as JaxAlgorithm
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP
from bagua_tpu.models.mlp import init_mlp, mse_loss

from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.examples import elastic_training as et

STEPS = 12


def jax_losses(group, params, steps):
    """The JAX example's loop, step by step: its Trainer's engine over the
    example's batches."""
    ddp = JaxDDP(mse_loss, optax.adam(1e-3), JaxAlgorithm.init("gradient_allreduce"), process_group=group)
    state = ddp.init(params)
    rng = np.random.RandomState(0)
    n = group.size
    out = []
    for _ in range(steps):
        batch = (jnp.asarray(rng.randn(16 * n, 32), jnp.float32), jnp.asarray(rng.randn(16 * n, 8), jnp.float32))
        state, losses = ddp.train_step(state, batch)
        out.append(float(np.asarray(losses).mean()))
    return out


def test_twin_losses_match_the_jax_example(group, tmp_path):
    params = init_mlp(jax.random.PRNGKey(0), et.SIZES)
    want = jax_losses(group, params, STEPS)
    tgroup = BaguaProcessGroup([torch.device("cpu")] * group.size, intra_size=4)
    start, state, got = et.run(tgroup, STEPS, str(tmp_path / "ckpt"),
                               params=params_from_jax(jax.tree.map(np.asarray, params)))
    assert start == 0 and state.step == STEPS
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_twin_resumes_from_its_checkpoint(tmp_path):
    """60 steps cut after step 55 (a checkpoint at 50), then a restart: it
    starts at 50, with the batches drawn afresh as the JAX example does,
    and ends at 60 on finite losses."""
    tgroup = BaguaProcessGroup([torch.device("cpu")] * 2, intra_size=1)
    ckpt = str(tmp_path / "ckpt")

    class Cut(Exception):
        pass

    def cut(trainer, state):
        if state.step == 55:
            raise Cut

    try:
        et.run(tgroup, 60, ckpt, on_step=cut)
    except Cut:
        pass
    start, state, losses = et.run(tgroup, 60, ckpt)
    assert start == 50 and state.step == 60 and len(losses) == 10 and np.isfinite(losses).all()
