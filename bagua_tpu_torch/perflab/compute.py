"""Compute spans: the FLOP census of one rank's step.

The port of ``bagua_tpu/perflab/compute.py``.  The JAX package walks the
step's jaxpr and counts every ``dot_general`` and ``conv_general_dilated``
of the per-chip (``shard_map``) program.  The port counts the same work
with ``torch.utils.flop_counter.FlopCounterMode`` over a dry run on the
``meta`` device (:func:`step_flops_census`): one rank's forward and
backward of the engine's loss, run as the engine runs it (``vmap`` over a
rank axis, here of one rank), so the counted shapes are per-GPU.  The
collectives and the optimizer's update carry no matmul or convolution
FLOPs, so the forward and backward are the step's census.

``n_dots`` counts the matrix products (``mm``, ``addmm``, ``bmm``,
``baddbmm``), ``n_convs`` the convolutions, a ``convolution_backward`` as
one convolution per gradient it computes (the input's and the weight's),
as the JAX backward has one ``conv_general_dilated`` for each.  The
counter takes a multiply-accumulate as two FLOPs, as the JAX census does.

The census is FLOPs, not seconds; :func:`compute_time_s` turns it into a
compute span under an explicit peak-FLOPs × assumed-MFU model.  The peaks
are :data:`~bagua_tpu_torch.observability.goodput.PEAK_FLOPS_PER_CHIP`'s;
the default, ``h100-sxm-f32``, is how the port's f32 steps run: TF32 off
(PyTorch's default for matmuls), so the products run at the card's f32
rate, not on the tensor cores' TF32 or bf16 paths.
"""

from collections import Counter
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from bagua_tpu_torch.observability.goodput import PEAK_FLOPS_PER_CHIP

__all__ = ["compute_time_s", "flops_census", "step_flops_census"]

_DOTS = frozenset({"mm", "addmm", "bmm", "baddbmm", "_scaled_mm"})
_CONVS = frozenset({"convolution", "_convolution", "cudnn_convolution", "convolution_overrideable",
                    "_slow_conv2d_forward"})


def _name(op) -> str:
    return getattr(op, "__name__", str(op)).split(".")[-1]


class _Calls(TorchDispatchMode):
    """Counts the products and convolutions the counter prices."""

    def __init__(self):
        super().__init__()
        self.calls = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = _name(func._overloadpacket)
        if name in _DOTS:
            self.calls["dot"] += 1
        elif name in _CONVS:
            self.calls["conv"] += 1
        elif name == "convolution_backward":
            mask = (kwargs or {}).get("output_mask", args[-1] if args else (True, True, False))
            self.calls["conv"] += int(bool(mask[0])) + int(bool(mask[1]))
        return func(*args, **(kwargs or {}))


def flops_census(fn: Callable[[], object]) -> Dict[str, float]:
    """FLOPs of one call of ``fn`` (no arguments), in the JAX census's
    keys: ``flops``, ``dot_flops``, ``conv_flops``, ``n_dots``,
    ``n_convs``."""
    counter = FlopCounterMode(display=False)
    calls = _Calls()
    with counter, calls:
        fn()
    tot = {"flops": 0.0, "dot_flops": 0.0, "conv_flops": 0.0}
    for op, f in counter.get_flop_counts().get("Global", {}).items():
        name = _name(op)
        tot["flops"] += float(f)
        if name in _DOTS:
            tot["dot_flops"] += float(f)
        elif name in _CONVS or name == "convolution_backward":
            tot["conv_flops"] += float(f)
    tot["n_dots"] = int(calls.calls["dot"])
    tot["n_convs"] = int(calls.calls["conv"])
    return tot


def step_flops_census(ddp, batch) -> Dict[str, float]:
    """Per-GPU FLOPs of one step of ``ddp`` on the global ``batch``: one
    rank's forward and backward of the engine's loss, on ``meta`` (nothing
    runs, nothing is allocated), its batch the global batch's share of one
    rank of the exchange."""
    from bagua_tpu_torch.analysis.verify import on_meta
    from bagua_tpu_torch.utils import tree_leaves, tree_map, tree_unflatten

    e = ddp.group.exchange_size
    meta = torch.device("meta")
    params = tree_map(lambda p: torch.empty((1, *p.shape), dtype=p.dtype, device=meta), ddp._tree_template)
    local = tree_map(lambda t: torch.empty((1, t.shape[0] // e, *t.shape[1:]), dtype=t.dtype, device=meta), batch)

    def one_rank():
        leaves = [leaf.requires_grad_(True) for leaf in tree_leaves(params)]
        with torch.enable_grad():
            losses = torch.func.vmap(ddp.loss_fn)(tree_unflatten(params, leaves), local)
            losses.sum().backward()

    with on_meta():
        return flops_census(one_rank)


def compute_time_s(flops: float, chip: str = "h100-sxm-f32", mfu: float = 0.3) -> float:
    """Modeled compute span: counted FLOPs at ``mfu`` of the card's peak
    (``chip`` a key of ``PEAK_FLOPS_PER_CHIP``).  ``mfu`` is an explicit
    assumption: the modeled trend across algorithms and precisions is exact
    in the wire term and shares one compute scale factor."""
    peak = PEAK_FLOPS_PER_CHIP[chip]
    denom = peak * mfu
    if denom <= 0:
        raise ValueError(f"non-positive effective peak: {chip=} {mfu=}")
    return float(flops) / denom
