"""The sequence-parallel position and loss helpers of
``bagua_tpu/models/gpt.py``, which the Llama model shares.  ``GPTModel``
itself is not ported yet.

The JAX helpers read the bound ``sp`` mesh axis; here the group is passed
explicitly, and without one (or without ``cfg.sp_axis``) every rank stands
alone.  Positions and losses are rank-stacked: one row per rank.
"""

import torch
import torch.nn.functional as F

from bagua_tpu_torch.communication import axis_size, rank_id


def _zigzag_active(cfg, group=None) -> bool:
    """Is the zigzag layout in effect (an ``sp`` axis of more than one
    rank)?  Otherwise zigzag degenerates to the identity layout, and
    positions, attention and the loss's seam mask all take the contiguous
    path together."""
    if cfg.sp_axis is None or cfg.sp_layout != "zigzag" or group is None:
        return False
    return axis_size(group, cfg.sp_axis) > 1


def _sp_positions(cfg, t_local: int, group=None, device=None) -> torch.Tensor:
    """Global position ids of each rank's local tokens: ``(R, t_local)``, or
    ``(1, t_local)`` where every rank holds positions ``0..t_local-1``."""
    local = torch.arange(t_local, device=device)
    if cfg.sp_axis is None or group is None:
        return local[None]
    r = rank_id(group, cfg.sp_axis).to(device)[:, None]
    if _zigzag_active(cfg, group):
        if t_local % 2:
            raise ValueError(
                f"zigzag sp layout needs an even local sequence length, got {t_local}"
            )
        sp = axis_size(group, cfg.sp_axis)
        t2 = t_local // 2
        return torch.cat([r * t2 + local[:t2], (2 * sp - 1 - r) * t2 + local[:t2]], dim=1)
    return r * t_local + local


def lm_loss_fn(model):
    """``loss_fn(params, ids) -> (R,)``: each rank's next-token cross
    entropy within its local block.  Under the zigzag layout the two local
    half-blocks are globally non-adjacent, so the seam pair (local ``t2-1 ->
    t2``) is masked out of the mean, which divides by ``b * (t - 2)``."""
    cfg, group = model.cfg, model.group

    def loss_fn(params, ids):
        logits = model(params, ids)
        logp = F.log_softmax(logits[:, :, :-1], dim=-1)
        nll = -torch.gather(logp, -1, ids[:, :, 1:, None].long())[..., 0]  # (R, b, t - 1)
        if _zigzag_active(cfg, group):
            t = ids.shape[2]
            if t < 4:
                raise ValueError(
                    f"zigzag LM loss needs a local sequence length >= 4 "
                    f"(seam masking leaves no targets at {t})"
                )
            keep = torch.arange(t - 1, device=ids.device) != (t // 2 - 1)  # drop the seam pair
            return (nll * keep).sum(dim=(1, 2)) / (nll.shape[1] * (t - 2))
        return nll.mean(dim=(1, 2))

    return loss_fn
