"""The SQuAD twin (``bagua_tpu_torch.examples.squad``) against the JAX
package's ``examples/squad/main.py``: the same synthetic batches, and 3
ByteGrad + Adam steps of BERT-mini over 4 ranks (``intra_size=1``: every
rank its own node, so the whole exchange is compressed) in both engines.

Tolerances, with their reason: the first step's losses within rtol 1e-6
(f32, summed in another order); after 3 Adam steps at lr 3e-4 every
parameter within 3 lr of JAX's (Adam moves an element by about lr a step,
whatever its gradient's size, and ByteGrad's 8-bit levels can round a
gradient near a level's edge to the next one), all but 5% of the elements
within 3 lr x 1e-3, while the starting parameters must fail that; the
losses of every step within rtol 1e-4.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bagua_tpu.algorithms import build_algorithm as jax_build_algorithm
from bagua_tpu.communication import BaguaProcessGroup as JaxGroup
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP

from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.examples import squad
from bagua_tpu_torch.utils import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS, STEPS, BATCH, SEQ = 4, 3, 2, 32
FLIPPED_SHARE = 0.05


def jax_example():
    spec = importlib.util.spec_from_file_location("jax_squad_example",
                                                  os.path.join(REPO, "examples", "squad", "main.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_synthetic_squad_draws_the_jax_batches():
    jsq = jax_example()
    a, b = np.random.RandomState(0), np.random.RandomState(0)
    for _ in range(2):
        for x, y in zip(jsq.synthetic_squad(a, 8, SEQ, 1000), squad.synthetic_squad(b, 8, SEQ, 1000)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    cfg = squad.squad_config(True, 128)
    assert (cfg.hidden_size, cfg.num_layers, cfg.compute_dtype, cfg.max_position_embeddings) == \
        (1024, 24, torch.bfloat16, 128)


def tiers(got, want, loose, tight):
    d = np.concatenate([np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64)).ravel()
                        for g, w in zip(got, want)])
    return d.max() <= loose and (d > tight).mean() <= FLIPPED_SHARE


def test_bytegrad_adam_steps_match_the_jax_engine(capsys):
    jsq = jax_example()
    jcfg = jsq.BertConfig(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4,
                          intermediate_size=128, max_position_embeddings=SEQ)
    jmodel = jsq.BertForQuestionAnswering(jcfg)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, SEQ), jnp.int32))["params"])

    jgroup = JaxGroup(jax.devices()[:RANKS], intra_size=1)
    jddp = JaxDDP(jsq.qa_loss_fn(jmodel), optax.adam(squad.LR), jax_build_algorithm("bytegrad"),
                  process_group=jgroup)
    jstate = jddp.init(params)
    rng = np.random.RandomState(0)
    jlosses = []
    for _ in range(STEPS):
        batch = jsq.synthetic_squad(rng, BATCH * RANKS, SEQ, jcfg.vocab_size)
        jstate, losses = jddp.train_step(jstate, tuple(map(jnp.asarray, batch)))
        jlosses.append(np.asarray(losses))

    group = BaguaProcessGroup([torch.device("cpu")] * RANKS, intra_size=1)
    model = squad.BertForQuestionAnswering(squad.squad_config(False, SEQ), device="cpu")
    losses, state, ddp = squad.run(model, params_from_jax(params), group, STEPS, BATCH, SEQ)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step 0: loss ") and out[-1].startswith("final loss ")
    assert ddp.overlap_enabled and ddp.exchange_counts == [STEPS] * ddp.plan.num_buckets

    np.testing.assert_allclose(losses[0].numpy(), jlosses[0], rtol=1e-6)
    for got, want in zip(losses, jlosses):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    got = [t[0].numpy() for t in tree_leaves(state.params)]
    want = jax.tree.leaves(jddp.params_unstacked(jstate))
    loose = STEPS * squad.LR * 3
    assert tiers(got, want, loose, loose * 1e-3)
    assert not tiers(jax.tree.leaves(params), want, loose, loose * 1e-3)
    for leaf in tree_leaves(state.params):
        assert all(torch.equal(leaf[0], leaf[r]) for r in range(1, RANKS))


def test_main_runs_on_the_cpu(capsys):
    loss = squad.main(["--device", "cpu", "--ranks", "4", "--steps", "3", "--batch-size", "2", "--seq", "32"])
    out = capsys.readouterr().out
    assert np.isfinite(loss) and "step 0: loss" in out and "final loss" in out and "3 steps in" in out
    with pytest.raises(NotImplementedError, match="tokenizers"):
        squad.main(["--device", "cpu", "--ranks", "4", "--data", "train-v1.1.json"])
