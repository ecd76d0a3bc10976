"""Pipeline parallelism: microbatch streaming over a pipeline axis of the
group (the port of ``bagua_tpu/parallel/pipeline.py``).

Every rank holds ONE stage's parameters (stages share a structure, e.g.
uniform transformer blocks), and activations hop to the next stage with
one neighbour :func:`~bagua_tpu_torch.communication.ppermute_shift` a tick.
The pipeline axis is ``(group, axis)``: an axis of a
:class:`~bagua_tpu_torch.BaguaProcessGroup` (``"pp"`` of a named mesh,
``"inter"`` or ``"intra"`` of the legacy one, or None for every rank).

Everything is rank-stacked, as in the rest of the port: ``stage_fn(params,
x)`` takes the stacked stage parameters (every leaf ``(R, ...)``, rank r's
row its own stage) and a stacked input ``(R, mb, ...)``, and returns ``(R,
mb, ...)``, one batched call for every rank of the tick.  Microbatches are
``(R, n_micro, mb, ...)``, one row per rank (stage 0 reads its own, the
other ranks pass the same shape), and a loss ``loss_fn(y, target)`` returns
the ``(R,)`` per-rank losses of one microbatch.  Where the JAX package
picks a rank's microbatch with ``dynamic_index`` and writes it under
``lax.cond``, the port gathers by rank row and writes under a per-rank
mask; the bubble ticks compute on every rank, as they do in JAX.

Three schedules:

* **GPipe** (:func:`pipeline_apply` / :func:`pipeline_loss`): ``T =
  n_stages + n_micro - 1`` ticks; at tick ``t`` stage ``s`` runs microbatch
  ``t - s``.  Autograd differentiates straight through the loop, so its
  graph keeps every tick's residuals (``remat=True`` keeps only each tick's
  stage input, through ``torch.utils.checkpoint``).
* **Interleaved** (:func:`pipeline_loss_interleaved`): each rank holds
  ``V`` chunks (global stage ``v*S + r``), so microbatches circle the ring
  ``V`` times and the bubble shrinks about ``V``-fold; ``V = 1`` is GPipe.
* **1F1B** (:func:`pipeline_train_1f1b`): forward and backward scheduled by
  hand in one loop; only stage inputs are stashed (a ring of ``2S - 1``
  slots), and each tick recomputes the stage forward from the stash and
  pulls back with :func:`torch.autograd.grad` on a fresh graph, so no
  tick's graph outlives the tick and live memory does not grow with the
  microbatch count.

Gradients across ranks: in JAX each device differentiates its own loss and
the transpose of ``psum`` brings the other ranks' cotangents back; here the
caller takes the gradient of the sum of every rank's loss through the
differentiable collectives, which is the same.  Every pipeline rank returns
the same (replicated) loss, so, as in JAX, :func:`_scale_grad` divides the
backward by ``n_stages``.
"""

from typing import Callable, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from bagua_tpu_torch.communication import (
    allreduce, axis_size, broadcast_inplace, ppermute_shift, rank_id,
)
from bagua_tpu_torch.defs import ReduceOp
from bagua_tpu_torch.utils import tree_leaves, tree_map, tree_unflatten


class PipelineGrads(NamedTuple):
    """Gradients from :func:`pipeline_train_1f1b`, rank-stacked.

    ``stage``: each rank's stage-parameter gradients.
    ``inputs``: d(loss)/d(microbatches): real on pipeline rank 0, zeros
        elsewhere (an ``allreduce(SUM)`` over the pipeline axis recovers
        it; only with ``with_input_grads``).
    ``loss_params``: gradients of ``loss_params``: real on the last
        pipeline rank, zeros elsewhere (the same sum recovers them)."""

    stage: object
    inputs: Optional[torch.Tensor] = None
    loss_params: Optional[object] = None


def _n_stages(group, axis) -> int:
    """The pipeline axis's size; 1 without a group (every rank stands
    alone, as an unbound axis is in JAX)."""
    return 1 if group is None else axis_size(group, axis)


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-rank ``(R,)`` bool broadcast against ``like (R, ...)``."""
    return mask.reshape(mask.shape[0], *([1] * (like.dim() - 1)))


def _select(mask: torch.Tensor, x: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """``where`` by rank row: select, never multiply (an inactive tick's
    value may be non-finite, and 0 x inf poisons a sum)."""
    return torch.where(_rows(mask, x), x, other)


def _pick(stack: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Row ``index[r]`` of each rank's ``stack[r]``: ``(R, n, ...)`` ->
    ``(R, ...)``."""
    return stack[torch.arange(stack.shape[0], device=stack.device), index]


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the backward multiplies the cotangent by ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _scale_grad(x: torch.Tensor, scale: float) -> torch.Tensor:
    return _ScaleGrad.apply(x, scale)


def _maybe_remat(stage_fn: Callable, remat: bool) -> Callable:
    """``stage_fn`` under ``torch.utils.checkpoint`` (the graph keeps only
    the stage input and recomputes the rest in the backward), or as is."""
    if not remat:
        return stage_fn

    def run(params, x):
        leaves = tree_leaves(params)
        return checkpoint(lambda x_, *ls: stage_fn(tree_unflatten(params, ls), x_), x, *leaves,
                          use_reentrant=False)

    return run


def _per_micro(fn: Callable, stage_params, microbatches: torch.Tensor) -> torch.Tensor:
    """``fn`` on each microbatch in turn, stacked back on dim 1."""
    return torch.stack([fn(stage_params, microbatches[:, m]) for m in range(microbatches.shape[1])], 1)


def _mean_loss(loss_fn: Callable, out: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The per-rank mean over microbatches of ``loss_fn``, ``(R,)``."""
    return torch.stack([loss_fn(out[:, m], targets[:, m]) for m in range(out.shape[1])], 1).mean(1)


def pipeline_apply(stage_fn: Callable, stage_params, microbatches: torch.Tensor, group=None,
                   axis="intra", remat: bool = False) -> torch.Tensor:
    """Run ``microbatches (R, n_micro, mb, ...)`` through the pipeline
    (GPipe schedule).

    Returns the last stage's outputs ``(R, n_micro, mb, ...)``, broadcast to
    every pipeline rank (so the loss can be computed anywhere).  Each rank's
    cotangent of the broadcast is summed into the last stage's, so the
    backward is scaled by ``1 / n_stages`` to match the sequential program
    when every rank computes the same loss on them."""
    n_stages = _n_stages(group, axis)
    if n_stages == 1:
        return _per_micro(_maybe_remat(stage_fn, remat), stage_params, microbatches)
    collected = _gpipe_collect(stage_fn, stage_params, microbatches, group, axis, remat)
    out = broadcast_inplace(collected, src_rank=n_stages - 1, comm=group, axis=axis)
    return _scale_grad(out, 1.0 / n_stages)


def pipeline_loss(stage_fn: Callable, stage_params, microbatches: torch.Tensor,
                  targets: torch.Tensor, loss_fn: Callable, group=None, axis="intra",
                  remat: bool = False) -> torch.Tensor:
    """Mean microbatch loss of the pipeline, ``(R,)`` (the same on every
    pipeline rank): GPipe, but only a scalar a rank crosses stages (the last
    stage's mean, summed over the pipeline axis).  Differentiable; the
    backward is scaled by ``1 / n_stages`` as in :func:`pipeline_apply`."""
    n_stages = _n_stages(group, axis)
    if n_stages == 1:
        out = pipeline_apply(stage_fn, stage_params, microbatches, group, axis, remat)
        return _mean_loss(loss_fn, out, targets)
    collected = _gpipe_collect(stage_fn, stage_params, microbatches, group, axis, remat)
    per_rank = _mean_loss(loss_fn, collected, targets)  # real only on the last stage
    is_last = rank_id(group, axis) == n_stages - 1
    total = allreduce(torch.where(is_last, per_rank, torch.zeros_like(per_rank)), ReduceOp.SUM, group, axis)
    return _scale_grad(total, 1.0 / n_stages)


def _gpipe_collect(stage_fn, stage_params, microbatches, group, axis, remat):
    """The GPipe forward loop without the broadcast: the last stage's
    outputs ``(R, n_micro, mb, ...)``, zeros on every other rank."""
    stage_fn = _maybe_remat(stage_fn, remat)
    n_stages = axis_size(group, axis)
    n_micro = microbatches.shape[1]
    my = rank_id(group, axis).to(microbatches.device)
    is_first, is_last = my == 0, my == n_stages - 1
    outbuf = torch.zeros_like(microbatches[:, 0])
    collected = [None] * n_micro
    for t in range(n_stages + n_micro - 1):
        recv = ppermute_shift(outbuf, 1, group, axis)
        m = t - my
        active = (m >= 0) & (m < n_micro)
        x_in = _select(is_first, _pick(microbatches, m.clamp(0, n_micro - 1)), recv)
        y = stage_fn(stage_params, x_in)
        y = _select(active, y, torch.zeros_like(y))
        # only the last rank writes, so the slot is the same for every row
        m_last = t - (n_stages - 1)
        if 0 <= m_last < n_micro:
            collected[m_last] = _select(is_last, y, torch.zeros_like(y))
        outbuf = y
    return torch.stack(collected, 1)


def _check_chunks(stacked_params) -> int:
    leaves = tree_leaves(stacked_params)
    if not leaves:
        raise ValueError("stacked_params is empty")
    n_chunks = leaves[0].shape[1]
    for leaf in leaves:
        if leaf.shape[1] != n_chunks:
            raise ValueError(
                "every stacked_params leaf needs the same leading V axis; "
                f"got {leaf.shape[1]} vs {n_chunks}"
            )
    return n_chunks


def _interleaved_collect(stage_fn, stacked_params, microbatches, group, axis, remat, n_chunks):
    """Interleaved forward loop: rank ``r`` holds chunks ``{v}``, global
    stages ``v*S + r``.  At tick ``t`` with ``u = t - r``: ``g = u //
    (S*V)``, ``v = (u % (S*V)) // S``, microbatch ``m = g*S + u % S``, a
    collision-free schedule in which every rank emits one value a tick, so
    the one neighbour shift carries both the hops within a circuit and the
    wrap (rank S-1 chunk v -> rank 0 chunk v+1).  ``M*V + S - 1`` ticks.
    Returns the final chunk's outputs (zeros off the last rank)."""
    stage_fn = _maybe_remat(stage_fn, remat)
    S, V = axis_size(group, axis), n_chunks
    n_micro = microbatches.shape[1]
    if n_micro % S:
        raise ValueError(
            f"interleaved schedule needs n_microbatches ({n_micro}) divisible "
            f"by n_stages ({S})"
        )
    my = rank_id(group, axis).to(microbatches.device)
    is_first, is_last = my == 0, my == S - 1
    groups = n_micro // S
    u_max = (groups - 1) * S * V + (V - 1) * S + (S - 1)
    outbuf = torch.zeros_like(microbatches[:, 0])
    collected = [None] * n_micro
    for t in range(u_max + S):
        recv = ppermute_shift(outbuf, 1, group, axis)
        u = t - my
        active = (u >= 0) & (u <= u_max)
        uc = u.clamp(0, u_max)
        v = (uc % (S * V)) // S
        m = (uc // (S * V)) * S + uc % S
        x_in = _select(is_first & (v == 0), _pick(microbatches, m), recv)
        y = stage_fn(tree_map(lambda p: _pick(p, v), stacked_params), x_in)
        y = _select(active, y, torch.zeros_like(y))
        u_last = t - (S - 1)  # the last rank's u: its writes fix the slot
        if 0 <= u_last <= u_max and (u_last % (S * V)) // S == V - 1:
            collected[(u_last // (S * V)) * S + u_last % S] = _select(is_last, y, torch.zeros_like(y))
        outbuf = y
    return torch.stack(collected, 1)


def pipeline_loss_interleaved(stage_fn: Callable, stacked_params, microbatches: torch.Tensor,
                              targets: torch.Tensor, loss_fn: Callable, group=None, axis="intra",
                              remat: bool = False) -> torch.Tensor:
    """Mean microbatch loss under the interleaved (virtual chunks)
    schedule, ``(R,)``.  ``stacked_params`` leaves are ``(R, V, ...)``:
    rank ``r`` owns global stages ``{v*S + r}``.  Needs ``n_micro %
    n_stages == 0``.  Differentiable, scaled as :func:`pipeline_loss`."""
    n_stages = _n_stages(group, axis)
    n_chunks = _check_chunks(stacked_params)
    if n_stages == 1:
        fn = _maybe_remat(stage_fn, remat)

        def full(params, x):  # the V chunks in turn
            for v in range(n_chunks):
                x = fn(tree_map(lambda p: p[:, v], params), x)
            return x

        return _mean_loss(loss_fn, _per_micro(full, stacked_params, microbatches), targets)
    collected = _interleaved_collect(stage_fn, stacked_params, microbatches, group, axis, remat,
                                     n_chunks)
    per_rank = _mean_loss(loss_fn, collected, targets)
    is_last = rank_id(group, axis) == n_stages - 1
    total = allreduce(torch.where(is_last, per_rank, torch.zeros_like(per_rank)), ReduceOp.SUM, group, axis)
    return _scale_grad(total, 1.0 / n_stages)


def _fresh(tree):
    """Detached copies that take gradients: the leaves of one tick's graph."""
    return tree_map(lambda p: p.detach().requires_grad_(), tree)


def _grads(out: torch.Tensor, inputs, cotangent=None):
    """``torch.autograd.grad`` of ``out`` (summed, or against ``cotangent``)
    into ``inputs``, zeros for an input ``out`` does not reach; the graph
    is freed."""
    got = torch.autograd.grad(out, inputs, grad_outputs=cotangent, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for g, x in zip(got, inputs)]


def pipeline_train_1f1b(stage_fn: Callable, stage_params, microbatches: torch.Tensor,
                        targets: torch.Tensor, loss_fn: Callable, group=None, axis="intra",
                        loss_params=None, with_input_grads: bool = False):
    """One-forward-one-backward pipeline training step.

    Scheduled by hand (not autograd through the loop): at tick ``t`` stage
    ``s`` runs the forward of microbatch ``t - s`` (under ``no_grad``) and
    the backward of ``t - (2(S-1) - s)``; on the last stage the two are the
    same microbatch.  Only stage inputs are stashed (a ring of ``2S - 1``
    slots a rank); the backward recomputes ``stage_fn`` from the stash on a
    fresh graph and pulls the tick's cotangent back through it.

    Args:
        stage_fn: ``stage_fn(stage_params, x) -> y``, rank-stacked.
        stage_params: each rank's stage parameters, stacked.
        microbatches: ``(R, n_micro, mb, ...)``, read by stage 0.
        targets: ``(R, n_micro, ...)``, read by the last stage.
        loss_fn: ``loss_fn(y, target) -> (R,)``, or with ``loss_params``
            ``loss_fn(loss_params, y, target) -> (R,)``.
        group, axis: the pipeline axis.
        loss_params: optional parameters used inside ``loss_fn`` (e.g. an
            LM head); their gradients come back in
            ``PipelineGrads.loss_params``.
        with_input_grads: also return d(loss)/d(microbatches).

    Returns ``(loss, grads)``: the mean microbatch loss ``(R,)`` (the same
    on every pipeline rank) and the gradients, detached: the bare stage tree,
    or a :class:`PipelineGrads` when ``loss_params`` or
    ``with_input_grads`` is used.  Values match the gradient of
    :func:`pipeline_loss`."""
    extended = loss_params is not None or with_input_grads
    if loss_params is None:
        full_loss_fn = lambda _none, y, t: loss_fn(y, t)  # noqa: E731
        loss_params = ()
    else:
        full_loss_fn = loss_fn

    n_stages = _n_stages(group, axis)
    n_micro = microbatches.shape[1]
    if n_stages == 1:
        p, lp, mbs = _fresh(stage_params), _fresh(loss_params), microbatches.detach().requires_grad_()
        with torch.enable_grad():
            out = _per_micro(stage_fn, p, mbs)
            losses = torch.stack([full_loss_fn(lp, out[:, m], targets[:, m]) for m in range(n_micro)], 1)
            loss = losses.mean(1)
            leaves = tree_leaves(p) + tree_leaves(lp) + [mbs]
            got = _grads(loss.sum(), leaves)
        n_p, n_lp = len(tree_leaves(p)), len(tree_leaves(lp))
        dstage = tree_unflatten(stage_params, got[:n_p])
        if not extended:
            return loss.detach(), dstage
        return loss.detach(), PipelineGrads(
            stage=dstage, inputs=got[-1] if with_input_grads else None,
            loss_params=tree_unflatten(loss_params, got[n_p:n_p + n_lp]),
        )

    device = microbatches.device
    microbatches, targets = microbatches.detach(), targets.detach()
    my = rank_id(group, axis).to(device)
    is_first, is_last = my == 0, my == n_stages - 1
    slots = 2 * n_stages - 1  # the most microbatches in flight on a rank, + 1
    stash = microbatches.new_zeros((microbatches.shape[0], slots) + microbatches.shape[2:])
    rows = torch.arange(microbatches.shape[0], device=device)
    param_leaves = [p.detach() for p in tree_leaves(stage_params)]
    lp_leaves = [p.detach() for p in tree_leaves(loss_params)]
    dgrads = [torch.zeros_like(p) for p in param_leaves]
    dlp_acc = [torch.zeros_like(p) for p in lp_leaves]
    dinputs = torch.zeros_like(microbatches) if with_input_grads else None
    loss_acc = torch.zeros(microbatches.shape[0], dtype=torch.float32, device=device)
    y_prev = dx_prev = torch.zeros_like(microbatches[:, 0])

    def stage(leaves, x):
        return stage_fn(tree_unflatten(stage_params, leaves), x)

    for t in range(n_micro + 2 * n_stages - 2):
        # the hops of last tick's results: activations s-1 -> s, cotangents
        # s+1 -> s
        recv_f = ppermute_shift(y_prev, 1, group, axis)
        recv_g = ppermute_shift(dx_prev, -1, group, axis)

        # forward: microbatch mf = t - s
        mf = t - my
        active_f = (mf >= 0) & (mf < n_micro)
        mf_c = mf.clamp(0, n_micro - 1)
        x_in = _select(is_first, _pick(microbatches, mf_c), recv_f)
        with torch.no_grad():
            y = stage(param_leaves, x_in)
        y = _select(active_f, y, torch.zeros_like(y))
        slot = mf_c % slots
        stash[rows, slot] = _select(active_f, x_in, stash[rows, slot])

        # backward: microbatch mb = t - (2(S-1) - s)
        mb = t - (2 * (n_stages - 1) - my)
        active_b = (mb >= 0) & (mb < n_micro)
        mb_c = mb.clamp(0, n_micro - 1)
        x_saved = _pick(stash, mb_c % slots)
        target = _pick(targets, mb_c)

        # the cotangent feeding this stage: the last stage seeds it from the
        # loss on the y it just computed (mf == mb there), the others take
        # the hop
        with torch.enable_grad():
            lp_t = [p.requires_grad_() for p in map(torch.Tensor.detach, lp_leaves)]
            y_t = y.detach().requires_grad_()
            loss_m = full_loss_fn(tree_unflatten(loss_params, lp_t), y_t, target)
            *dlp, dy_loss = _grads(loss_m.sum(), lp_t + [y_t])
        g_in = _select(is_last, dy_loss / n_micro, recv_g)

        # recompute the stage forward from the stashed input and pull back
        # (the remat: nothing but x_in was kept from the forward)
        with torch.enable_grad():
            p_t = [p.detach().requires_grad_() for p in param_leaves]
            x_t = x_saved.detach().requires_grad_()
            *dp, dx = _grads(stage(p_t, x_t), p_t + [x_t], g_in)
        dgrads = [a + _select(active_b, d, torch.zeros_like(d)) for a, d in zip(dgrads, dp)]
        seed_b = active_b & is_last
        dlp_acc = [a + _select(seed_b, d / n_micro, torch.zeros_like(d)) for a, d in zip(dlp_acc, dlp)]
        dx = _select(active_b, dx, torch.zeros_like(dx))
        if dinputs is not None:
            dinputs[rows, mb_c] = _select(active_b, _select(is_first, dx, torch.zeros_like(dx)),
                                          dinputs[rows, mb_c])
        loss_acc = loss_acc + torch.where(active_b & is_last, loss_m.detach().float(),
                                          torch.zeros_like(loss_acc))
        y_prev, dx_prev = y, dx

    loss = allreduce(torch.where(is_last, loss_acc / n_micro, torch.zeros_like(loss_acc)),
                     ReduceOp.SUM, group, axis)
    dstage = tree_unflatten(stage_params, dgrads)
    if not extended:
        return loss, dstage
    return loss, PipelineGrads(stage=dstage, inputs=dinputs,
                               loss_params=tree_unflatten(loss_params, dlp_acc))
