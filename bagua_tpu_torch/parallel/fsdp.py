"""FSDP / ZeRO-3: parameters sharded at rest, gathered at use (the port of
``bagua_tpu/parallel/fsdp.py``).

In the JAX package ZeRO-3 is a sharding annotation and XLA inserts the
collectives.  Here they are explicit, over every rank of a
:class:`~bagua_tpu_torch.BaguaProcessGroup`:

* at rest each rank holds its ``1 / n`` rows of every sharded leaf (and the
  optimizer's state of those rows, but for a state of one value per leaf,
  such as Adam's step counter: :meth:`FSDP.at_rest_bytes`); a leaf no dim
  of which divides is replicated (:func:`shard_leaf_spec`, the JAX
  package's rule);
* :meth:`FSDP.train_step` gathers each sharded leaf (``allgather``), casts
  it to ``compute_dtype``, takes the loss on each rank's batch shard (the
  reported loss is the mean over the global batch), lands every gradient in
  the shard layout through ``reduce_scatter`` (AVG; replicated leaves
  ``allreduce``), and steps the optimizer on the shard rows only.

    fsdp = FSDP(loss_fn, lambda ps: torch.optim.Adam(ps, lr=1e-3), group,
                compute_dtype=torch.bfloat16)
    params, opt_state = fsdp.init(params)         # leaves land sharded
    (params, opt_state), loss = fsdp.train_step(params, opt_state, batch)

``loss_fn(params, batch) -> (R,)`` is rank-stacked, as the port's models
are: ``params`` leaves ``(R, ...)``, every rank's gathered copy, and
``batch`` leaves ``(R, B / R, ...)``; a per-rank loss (the engine's) goes
through ``torch.func.vmap``.  ``R`` is the ranks this process holds
(``group.local_size``): on a group that spans processes each process
stacks its own ranks' shards and feeds its own ranks' rows of the batch,
as the engine's ``shard_batch`` takes them.  The optimizer factory is called once on the
list of shard leaves ``(R, ...)``, so any ``torch.optim`` optimizer whose
update is elementwise steps each rank's rows as the unsharded one would.

**Mixed precision** (``compute_dtype``): the master parameters and the
optimizer state stay in their own type (f32); the step's gathered copies
are the graph's leaves and are cast inside it, so the cast's backward
brings the gradients back to the master type.

The step gathers the whole tree at its start; gathering one layer at a
time as it is used (what XLA schedules under :func:`scan_layers`) is not
ported.
"""

from typing import Callable, List, Optional

import torch

from bagua_tpu_torch.communication import allgather, allreduce, get_default_group, reduce_scatter
from bagua_tpu_torch.defs import ReduceOp
from bagua_tpu_torch.utils import tree_leaves, tree_map, tree_unflatten


def cast_floating(tree, dtype):
    """Every floating leaf of ``tree`` cast to ``dtype`` (ints and bools
    pass through); ``dtype=None`` returns the tree as it is."""
    if dtype is None:
        return tree
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


def scan_layers(block_fn: Callable, stacked_params, x):
    """A stack of homogeneous layers applied in order: ``stacked_params``
    leaves carry a leading layer axis ``(L, ...)`` and ``block_fn(layer,
    x) -> x`` is one layer (JAX's ``lax.scan`` over the axis, as a loop)."""
    for i in range(tree_leaves(stacked_params)[0].shape[0]):
        x = block_fn(tree_map(lambda p: p[i], stacked_params), x)
    return x


def shard_leaf_spec(shape, mesh_size: int) -> Optional[int]:
    """The dim a leaf is sharded on: the first whose extent divides by the
    group size and is at least that size; None (replicated) if none."""
    for dim, extent in enumerate(shape):
        if extent % mesh_size == 0 and extent >= mesh_size:
            return dim
    return None


def fsdp_shardings(tree, group=None):
    """The shard dim (or None) of every leaf of ``tree`` (unstacked)."""
    n = (group or get_default_group()).size
    return tree_map(lambda t: shard_leaf_spec(tuple(t.shape), n), tree)


def _shard(leaf: torch.Tensor, dim: Optional[int], n: int) -> torch.Tensor:
    """An unstacked leaf as its rank-stacked at-rest layout: rank r's rows
    ``r * m : (r + 1) * m`` of ``dim`` (``m = extent / n``), ``(n, ...,
    m, ...)``; or a copy a rank where ``dim`` is None.  Always a copy: the
    optimizer writes the shards in place."""
    if dim is None:
        return leaf[None].repeat(n, *([1] * leaf.dim()))
    shape = tuple(leaf.shape)
    split = leaf.reshape(*shape[:dim], n, shape[dim] // n, *shape[dim + 1:])
    return split.movedim(dim, 0).clone(memory_format=torch.contiguous_format)


def _gather(shard: torch.Tensor, dim: Optional[int], group) -> torch.Tensor:
    """Every rank's whole leaf ``(n, *shape)`` from the shards
    (``allgather`` over the group along ``dim``)."""
    if dim is None:
        return shard
    return allgather(shard.movedim(dim + 1, 1), group).movedim(1, dim + 1).contiguous()


def _scatter(grad: torch.Tensor, dim: Optional[int], group) -> torch.Tensor:
    """Every rank's whole-leaf gradient averaged over the group, each rank
    keeping its rows (``reduce_scatter``; ``allreduce`` where replicated)."""
    if dim is None:
        return allreduce(grad, ReduceOp.AVG, group)
    return reduce_scatter(grad.movedim(dim + 1, 1), ReduceOp.AVG, group).movedim(1, dim + 1).contiguous()


class FSDP:
    """Fully sharded data parallelism over every rank of a group (ZeRO-3)."""

    def __init__(self, loss_fn: Callable, optimizer: Callable[[List[torch.Tensor]], torch.optim.Optimizer],
                 group=None, compute_dtype=None, cast_batch: bool = True):
        """``compute_dtype``: the step's compute type (the gathered copies
        are cast; the master leaves keep theirs).  ``cast_batch``: also
        cast the batch's floating leaves (it rounds regression targets
        too; pass False and cast inputs inside ``loss_fn`` to keep the
        loss in f32)."""
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.group = group or get_default_group()
        self.compute_dtype = compute_dtype
        self.cast_batch = cast_batch
        self._dims = None

    def init(self, params):
        """``(params, opt_state)``: the unstacked ``params`` in the sharded
        layout on the group's device, every leaf ``(R, ...)`` with each
        rank's rows, and the optimizer the factory builds over them."""
        group = self.group
        n, device, rows = group.size, group.device, group.local_rows
        self._dims = [shard_leaf_spec(tuple(t.shape), n) for t in tree_leaves(params)]
        shards = [_shard(t.detach().to(device), d, n) for t, d in zip(tree_leaves(params), self._dims)]
        if group.distributed:  # this process's ranks' rows
            shards = [s[rows.start:rows.stop].clone() for s in shards]
        return tree_unflatten(params, shards), self.optimizer(shards)

    def full_params(self, params, rank: int = 0):
        """One rank's whole (unstacked) parameters, gathered from the
        shards; on a group that spans processes ``rank`` is one this
        process holds (a collective call: every process calls it)."""
        row = rank - self.group.local_rows.start
        return tree_unflatten(params, [_gather(s, d, self.group)[row]
                                       for s, d in zip(tree_leaves(params), self._dims)])

    def train_step(self, params, opt_state, batch):
        """One step on ``batch``: the global batch, or on a group that
        spans processes this process's rows of it (leading dim divisible by
        the ranks this process holds; its i-th local rank takes the i-th
        slice).  Returns ``((params, opt_state), loss)``: the shards
        updated in place and the f32 mean of this process's ranks' losses
        (the global-batch mean on a single controller)."""
        n = self.group.local_size
        shards = tree_leaves(params)
        full = [_gather(s.detach(), d, self.group).requires_grad_() for s, d in zip(shards, self._dims)]

        def split(t):
            if t.shape[0] % n:
                raise ValueError(f"batch {t.shape[0]} not divisible by this process's {n} ranks")
            return t.to(self.group.device).reshape(n, t.shape[0] // n, *t.shape[1:])

        local = tree_map(split, batch)
        if self.cast_batch:
            local = cast_floating(local, self.compute_dtype)
        losses = self.loss_fn(cast_floating(tree_unflatten(params, full), self.compute_dtype), local)
        losses.sum().backward()
        for shard, leaf, d in zip(shards, full, self._dims):
            shard.grad = _scatter(leaf.grad, d, self.group)
            leaf.grad = None
        del full
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        return (params, opt_state), losses.detach().float().mean()

    def at_rest_bytes(self, params, opt_state) -> int:
        """The bytes one rank holds between steps: its parameter rows and
        the optimizer state of them (a state tensor of one value per rank
        counts once).  Not all of it is sharded: ``torch.optim.Adam`` keeps
        one f32 ``step`` counter per leaf, whole on every rank, so GPTModel
        at GPT-2 small (148 leaves) over 4 ranks holds 248,152,912 B a rank
        against total / 4 = 248,152,320 B, the 592 B of its counters."""
        n = self.group.local_size
        total = sum(s[0].numel() * s.element_size() for s in tree_leaves(params))
        for state in opt_state.state.values():
            for t in state.values():
                if torch.is_tensor(t):
                    per_rank = t[0] if t.dim() and t.shape[0] == n else t
                    total += per_rank.numel() * t.element_size()
        return total
