"""GPT, the pipeline schedules and FSDP on the card against the CPU.

These tests need a CUDA device and skip without one; they import neither
JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpt_cuda.py

They run ``chip_smoke.py``'s own ``[gpt-ref]`` checks, whose docstrings
and constants give the tolerances: the small GPT at sp 2 contiguous, sp 2
zigzag and tp 2 (logits and every gradient within ``REF_GPT_TOL`` of the
CPU's and of the plain ring's on the card, rows 6-8 launched exactly once
a block call), the three schedules against the sequential program, and
one FSDP step; then the gpt_pretrain twin at its small defaults (pp 2 x
sp 2), 3 steps of each schedule on the card against the CPU: losses within
rtol 1e-4 and every parameter within 3 lr (Adam moves an element by about
lr a step whatever its gradient's scale), with exact launches.
"""

import pytest
import torch

import chip_smoke
from bagua_tpu_torch.examples import gpt_pretrain as gp
from bagua_tpu_torch.utils import tree_leaves


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(chip_smoke.REF_GPT_LAYOUTS))
def test_small_gpt_on_card_matches_cpu(cuda_device, layout):
    res = chip_smoke.check_small_gpt_on_card(cuda_device, layout)
    assert max(res["worst"].values()) <= chip_smoke.REF_GPT_TOL


@pytest.mark.cuda
def test_pipeline_schedules_on_card_match_sequential(cuda_device):
    chip_smoke.check_pipelines_on_card(cuda_device)


@pytest.mark.cuda
def test_fsdp_step_on_card_matches_cpu(cuda_device):
    chip_smoke.check_fsdp_on_card(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_twin_on_card_matches_cpu(cuda_device, schedule):
    args = gp.parse_args(["--steps", "3", "--schedule", schedule])
    cpu_losses, cpu = gp.run(args, device=torch.device("cpu"))
    chip_smoke.reset_launches()
    losses, card = gp.run(args, device=cuda_device, params=cpu.init_params(torch.device("cpu")))
    launches = chip_smoke.read_launches()
    assert launches == {k: 3 * n for k, n in chip_smoke.gpt_pp_calls(args).items()}
    assert torch.allclose(torch.tensor(losses), torch.tensor(cpu_losses), rtol=1e-4)
    for g, w in zip(tree_leaves(card.params), tree_leaves(cpu.params)):
        assert float((g.detach().cpu() - w.detach()).abs().max()) <= 3 * gp.LR
