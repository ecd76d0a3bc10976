"""``rank_conv2d``, the convolution whose ``vmap`` rule runs one
convolution per rank (``bagua_tpu_torch.models._rank_ops``), on the CPU.

Under ``torch.func.vmap`` over the ranks it must give the same bits as a
loop of ``F.conv2d`` over the ranks, for the output and for the input and
weight gradients, with a batched and an unbatched weight; each stacked
leaf's post-accumulate-grad hook fires once, from one backward; a rank's
NHWC input (a ``channels_last`` NCHW view) stays NHWC; outside ``vmap`` it
is ``F.conv2d``, bit for bit.  The card's twin is in
``tests/test_torch_kernels_cuda.py``.
"""

import pytest
import torch
import torch.nn.functional as F

from bagua_tpu_torch.models._rank_ops import rank_conv2d

RANKS, BATCH = 4, 2


def _inputs(seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(RANKS, BATCH, 9, 7, 3, generator=gen)  # NHWC
    w1 = torch.randn(RANKS, 3, 3, 3, 5, generator=gen)  # HWIO
    w2 = torch.randn(RANKS, 3, 3, 5, 6, generator=gen)
    return x, w1, w2


def _net(conv, x, w1, w2):
    """Two convolutions on an NHWC input, with HWIO kernels, as VGG's."""
    h = F.relu(conv(x.permute(0, 3, 1, 2), w1.permute(3, 2, 0, 1)))
    return conv(h, w2.permute(3, 2, 0, 1))


def _rank_conv(x, w):
    return rank_conv2d(x, w, 1)


def _plain_conv(x, w):
    return F.conv2d(x, w, padding=1)


@pytest.mark.parametrize("batched_weight", [True, False], ids=["batched", "unbatched"])
def test_vmap_matches_per_rank_loop_bitwise(batched_weight):
    x, w1, w2 = _inputs()
    if not batched_weight:
        w1, w2 = w1[0], w2[0]
    leaves = [t.clone().requires_grad_(True) for t in (x, w1, w2)]
    fired = []
    for name, leaf in zip("x w1 w2".split(), leaves):
        leaf.register_post_accumulate_grad_hook(lambda _t, name=name: fired.append(name))
    in_dims = (0, 0, 0) if batched_weight else (0, None, None)
    y = torch.func.vmap(lambda *a: _net(_rank_conv, *a), in_dims=in_dims)(*leaves)
    (y * y).sum().backward()
    assert fired == ["w2", "w1", "x"]

    gx, gw1, gw2 = [], [], []
    for r in range(RANKS):
        xr = x[r].clone().requires_grad_(True)
        a = (w1[r] if batched_weight else w1).clone().requires_grad_(True)
        b = (w2[r] if batched_weight else w2).clone().requires_grad_(True)
        yr = _net(_plain_conv, xr, a, b)
        assert torch.equal(y[r], yr)
        (yr * yr).sum().backward()
        gx.append(xr.grad)
        if batched_weight:
            assert torch.equal(leaves[1].grad[r], a.grad) and torch.equal(leaves[2].grad[r], b.grad)
        else:
            gw1.append(a.grad)
            gw2.append(b.grad)
    assert torch.equal(leaves[0].grad, torch.stack(gx))
    if not batched_weight:  # the expanded weight's gradient: a sum over the ranks
        assert torch.equal(leaves[1].grad, torch.stack(gw1).sum(0))
        assert torch.equal(leaves[2].grad, torch.stack(gw2).sum(0))


def test_outside_vmap_is_conv2d_bitwise():
    x, w1, _ = _inputs(1)
    outs = []
    for conv in (_rank_conv, _plain_conv):
        xr, w = x[0].clone().requires_grad_(True), w1[0].clone().requires_grad_(True)
        y = conv(xr.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
        (y * y).sum().backward()
        outs.append((y, xr.grad, w.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_rank_keeps_channels_last():
    """A rank's NHWC input is a channels_last NCHW view; so is its output,
    in the stack the rule returns."""
    x, w1, _ = _inputs(2)
    y = torch.func.vmap(lambda xr, w: _rank_conv(xr.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)))(x, w1)
    assert y.shape == (RANKS, BATCH, 5, 9, 7)
    assert all(y[r].is_contiguous(memory_format=torch.channels_last) for r in range(RANKS))
