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


def test_unported_model_and_no_card(monkeypatch):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 5"):
        sb.build("bert-large", torch.float32, torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sb.main(["--num-iters", "1"])
    assert isinstance(sb.build_algorithm("gradient_allreduce"), GradientAllReduceAlgorithm)
