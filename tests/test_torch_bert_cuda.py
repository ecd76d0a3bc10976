"""A small BERT on the card against the same run on the CPU.

These tests need a CUDA device and skip without one; they import neither
JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_bert_cuda.py

Tolerances, with their reason (f32, TF32 off): the encoder under sp 4
(ring attention through the three flash-attention kernels, with a
key-padding mask that leaves whole blocks padded) within 1e-5 of the CPU's
plain blocks, its gradients within 1e-5 of their leaf's largest value
(the kernels and cuBLAS sum in another order than the CPU); the SQuAD
twin's 2 ByteGrad + Adam steps: the losses within rtol 1e-5, every
parameter within 2 lr of the CPU run's (Adam moves an element by about lr
a step; an 8-bit level can round the other way) and all but 5% within 2
lr x 1e-3, with exactly one launch of each codec kernel per bucket and
step.
"""

import numpy as np
import pytest
import torch

from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.examples import squad
from bagua_tpu_torch.kernels import flash_attention as fa
from bagua_tpu_torch.kernels import minmax_uint8 as mm8
from bagua_tpu_torch.models import bert as tb
from bagua_tpu_torch.utils import tree_leaves, tree_map

SMALL = dict(vocab_size=100, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
             max_position_embeddings=64)
RANKS, B, T = 4, 2, 64


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for fn in mm8.KERNELS + fa.KERNELS:
        fn.launches = 0
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = saved


def _sp_pass(device, params, ids, mask, cot):
    group = BaguaProcessGroup([device] * RANKS, intra_size=RANKS)
    model = tb.BertModel(tb.BertConfig(**SMALL, sp_axis="intra"), group, device=device)
    leaves = tree_map(lambda p: p.to(device).requires_grad_(), params)
    out = model(leaves, ids.to(device), attention_mask=mask.to(device))
    (out * cot.to(device)).sum().backward()
    return out.detach().cpu(), [leaf.grad.cpu() for leaf in tree_leaves(leaves)]


@pytest.mark.cuda
def test_bert_sp_on_card_matches_cpu(cuda_device):
    gen = torch.Generator().manual_seed(0)
    _, params = tb.init_bert(tb.BertConfig(**SMALL), gen, "cpu", model_cls=tb.BertModel)
    stacked = tree_map(lambda p: p[None].repeat(RANKS, *([1] * p.dim())), params)
    ids = torch.randint(0, SMALL["vocab_size"], (B, T), generator=gen)
    mask = torch.arange(T)[None] < torch.tensor([[T], [T // 4 + 3]])  # ranks 2 and 3 hold no key of row 1
    block = lambda x: x.reshape(B, RANKS, -1).transpose(0, 1).contiguous()  # noqa: E731
    cot = torch.randn((RANKS, B, T // RANKS, SMALL["hidden_size"]), generator=gen)
    got, got_grads = _sp_pass(cuda_device, stacked, block(ids), block(mask), cot)
    launches = [fn.launches for fn in fa.KERNELS]
    want, want_grads = _sp_pass(torch.device("cpu"), stacked, block(ids), block(mask), cot)
    assert launches == [SMALL["num_layers"] * RANKS] * 3
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    for g, w in zip(got_grads, want_grads):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * max(1.0, float(w.abs().max())))


@pytest.mark.cuda
def test_squad_steps_on_card_match_cpu(cuda_device):
    steps, batch, seq = 2, 2, 32
    cfg = squad.squad_config(False, seq)
    runs = {}
    for device in (cuda_device, torch.device("cpu")):
        group = BaguaProcessGroup([device] * RANKS, intra_size=1)
        model, params = tb.init_bert(cfg, torch.Generator().manual_seed(0), "cpu",
                                     model_cls=squad.BertForQuestionAnswering)
        losses, state, ddp = squad.run(model, tree_map(lambda p: p.to(device), params), group, steps, batch, seq)
        runs[device.type] = (torch.stack(losses).cpu(), [t[0].cpu() for t in tree_leaves(state.params)],
                             [fn.launches for fn in mm8.KERNELS], ddp.plan.num_buckets)
        for leaf in tree_leaves(state.params):
            assert all(torch.equal(leaf[0], leaf[r]) for r in range(1, RANKS))
    (got_losses, got, launches, buckets), (want_losses, want, _, _) = runs["cuda"], runs["cpu"]
    assert launches == [steps * buckets] * 3
    torch.testing.assert_close(got_losses, want_losses, rtol=1e-5, atol=0)
    d = np.concatenate([(g - w).abs().numpy().ravel() for g, w in zip(got, want)])
    loose = 2 * squad.LR
    assert d.max() <= loose and (d > loose * 1e-3).mean() <= 0.05
