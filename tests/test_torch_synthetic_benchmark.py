"""The twin of the reference's synthetic benchmark
(``bagua_tpu_torch.examples.synthetic_benchmark``) on the CPU: ``run()``
with a small VGG over 4 ranks prints the reference's result line, and its
parameters equal a ``Trainer`` run's on the same batch."""

import re

import numpy as np
import pytest
import torch

from bagua_tpu_torch.algorithms import GradientAllReduceAlgorithm
from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.examples import synthetic_benchmark as sb
from bagua_tpu_torch.models.vgg import VGG, module_params, vgg_loss_fn
from bagua_tpu_torch.trainer import Trainer
from bagua_tpu_torch.utils import tree_leaves

SMALL_VGG = dict(num_classes=10, cfg=(8, "M", 16, "M"), classifier_width=32, image_size=32)
LINE = re.compile(r"^model=vgg16 algorithm=(\S+) batch=2/chip chips=4: [0-9.]+ samples/sec/chip, "
                  r"final loss [0-9.]+$")


@pytest.mark.parametrize("algorithm, kwargs", [("bytegrad", {}), ("gradient_allreduce", {"wire_precision": "int8"}),
                                               ("zero", {}), ("zero", {"compression": "bytegrad"})],
                         ids=["bytegrad", "int8", "zero", "zero-bytegrad"])
def test_run_matches_trainer(capsys, algorithm, kwargs):
    group = BaguaProcessGroup([torch.device("cpu")] * 4, intra_size=1)
    model = VGG(device="cpu", generator=torch.Generator().manual_seed(0), **SMALL_VGG)
    params = module_params(model)
    result = sb.run(model, params, group, algorithm, kwargs, batch_size=2, num_iters=2, num_warmup=1)
    out = capsys.readouterr().out.strip().splitlines()
    assert out == [result.line] and LINE.match(result.line).group(1) == algorithm
    assert result.ddp.overlap_enabled and result.state.step == 3
    assert result.ddp.exchange_counts == [3] * result.ddp.plan.num_buckets
    assert torch.isfinite(result.losses).all() and result.samples_per_sec_per_chip > 0

    # the same batch, made as the reference makes it, through Trainer.fit
    rng = np.random.RandomState(0)
    batch = (torch.from_numpy(rng.rand(8, 32, 32, 3).astype(np.float32)),
             torch.from_numpy(rng.randint(0, 10, (8,)).astype(np.int32)))
    algo = sb.build_algorithm(algorithm, **kwargs)
    trainer = Trainer(vgg_loss_fn(model), lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9), algo, group)
    state = trainer.fit(trainer.init_state(params), [batch] * 3)
    for a, b in zip(tree_leaves(result.state.params), tree_leaves(state.params)):
        assert torch.equal(a, b)
    assert torch.equal(result.losses, trainer.losses)


SMALL_BERT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64)


def test_unported_model_and_no_card(monkeypatch, capsys):
    """``build("bert-large")`` at a small config against the JAX benchmark's
    ``build`` (each package's ``bert_large_config`` given the same small
    widths): the same
    parameter tree, and on the JAX weights the same loss on the same batch
    within rtol 1e-6 (f32 sums in another order); ``run()`` takes it and
    prints the reference's line; an unknown model raises; ``main`` without
    a card raises."""
    import importlib.util
    import os

    import jax
    import jax.numpy as jnp

    from bagua_tpu.models import bert as jax_bert

    from bagua_tpu_torch.convert import params_from_jax
    from bagua_tpu_torch.utils import tree_flatten_with_names

    spec = importlib.util.spec_from_file_location(
        "jax_synthetic_benchmark", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                                "examples", "benchmark", "synthetic_benchmark.py"))
    jsb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jsb)
    for module in (jax_bert, sb):
        full = module.bert_large_config
        monkeypatch.setattr(module, "bert_large_config", lambda full=full, **kw: full(**{**kw, **SMALL_BERT}))
    jloss, jparams, jbatch = jsb.build("bert-large", jnp.float32)

    model, params = sb.build("bert-large", torch.float32, torch.device("cpu"))
    assert model.cfg.max_position_embeddings == sb.BERT_SEQ == 128
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    assert [(n, t.shape, t.dtype) for n, t in tree_flatten_with_names(params)] == \
        [(n, t.shape, t.dtype) for n, t in tree_flatten_with_names(tparams)]
    want = float(jloss(jparams, jbatch(np.random.RandomState(0), 2)))
    _, loss_fn, batch_fn = sb.workload(model)
    ids, labels = batch_fn(np.random.RandomState(0), 2)
    assert np.array_equal(ids.numpy(), np.asarray(jbatch(np.random.RandomState(0), 2)[0]))
    got = float(torch.func.vmap(loss_fn)(tree_map_stack(tparams), (ids[None], labels[None]))[0])
    np.testing.assert_allclose(got, want, rtol=1e-6)

    group = BaguaProcessGroup([torch.device("cpu")] * 2, intra_size=1)
    result = sb.run(model, params, group, "bytegrad", batch_size=1, num_iters=1, num_warmup=1)
    assert re.match(r"^model=bert-large algorithm=bytegrad batch=1/chip chips=2: [0-9.]+ samples/sec/chip, "
                    r"final loss [0-9.]+$", result.line)
    assert capsys.readouterr().out.strip() == result.line and torch.isfinite(result.losses).all()
    with pytest.raises(ValueError):
        sb.build("resnet50", torch.float32, torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sb.main(["--num-iters", "1"])
    assert isinstance(sb.build_algorithm("gradient_allreduce"), GradientAllReduceAlgorithm)
    # the full configuration: BERT-Large's widths, the benchmark's positions
    cfg = full(compute_dtype=torch.bfloat16, max_position_embeddings=sb.BERT_SEQ)
    assert (cfg.vocab_size, cfg.hidden_size, cfg.num_layers, cfg.num_heads) == (30522, 1024, 24, 16)


def tree_map_stack(tree):
    from bagua_tpu_torch.utils import tree_map

    return tree_map(lambda t: t[None], tree)


def _averagers():
    import threading

    return [t for t in threading.enumerate() if t.name == "bagua-async-averager"]


def test_run_takes_async_and_stale_and_shuts_down(capsys):
    """``async`` and ``stale`` by name, an ``on_step`` callback that flips
    the directive before step 0 (the staleness counters then cycle), an
    ``Algorithm`` object as it is; the engine is shut down when the run
    ends, and also when it raises: no averager thread is left."""
    from bagua_tpu_torch.algorithms import GradientAccumulation, build_algorithm

    group = BaguaProcessGroup([torch.device("cpu")] * 4, intra_size=1)
    model = VGG(device="cpu", generator=torch.Generator().manual_seed(0), **SMALL_VGG)
    params = module_params(model)
    result = sb.run(model, params, group, "async", {"sync_interval_ms": 1}, batch_size=2, num_iters=2,
                    num_warmup=1)
    assert LINE.match(result.line).group(1) == "async" and result.ddp.impl._thread is None and not _averagers()
    seen = []

    def flag(i, state, ddp):
        seen.append(i)
        return ddp.apply_degradation_directive(state, (2,)) if i == 0 else state

    result = sb.run(model, params, group, "stale", {"staleness_tau": 2}, batch_size=2, num_iters=2,
                    num_warmup=1, on_step=flag)
    assert seen == [0, 1, 2] and result.state.algo_state["staleness"].tolist() == [0, 0, 0, 0]
    result = sb.run(model, params, group, GradientAccumulation(build_algorithm("bytegrad"), every=3),
                    batch_size=2, num_iters=2, num_warmup=1)
    assert LINE.match(result.line).group(1) == "GradientAccumulation" and result.state.step == 3

    def boom(i, state, ddp):
        if i == 1:
            assert ddp.impl._thread.is_alive()
            raise RuntimeError("the run failed")
        return state

    with pytest.raises(RuntimeError, match="the run failed"):
        sb.run(model, params, group, "async", {"sync_interval_ms": 10 ** 9}, batch_size=2, num_iters=2,
               num_warmup=1, on_step=boom)
    assert not _averagers()
    capsys.readouterr()
