"""Sharded optimizer update: each rank updates only its shard of every
bucket (the port of ``bagua_tpu/sharded/updater.py``).

The compute half of the ZeRO exchange (arXiv:2004.13336).  After the
per-bucket reduce-scatter each rank holds the reduced gradients for its
contiguous flat slice of every bucket; this module steps the optimizer on
exactly those slices and hands back per-bucket *updated parameter shards*
for the deferred all-gather.  Optimizer state therefore exists only for
``1/n`` of every parameter per rank: SGD momentum's ``P`` becomes ``P/n``,
Adam's ``2P`` of moments ``2P/n``.

The torch form: for each dtype group of the shard layout the updater holds
ONE persistent tensor of shape ``(n, shard_total)``, the group's *rows*:
row ``r`` is rank ``r``'s shard of every bucket of the group, concatenated
in bucket order.  The engine's optimizer factory is called once, on the
rows, so an elementwise ``torch.optim`` optimizer updates each rank's shard
on its own and keeps state of the rows' shape.  The rows start as the
initial parameters' shards and are updated in place; the pending shards
the update returns are views of them.

Bitwise contract: for an elementwise optimizer (SGD, momentum, Adam, ...)
the update of a shard equals that slice of the update of the whole
parameter, and alignment padding carries zero gradients, so the gathered
shards reproduce the unsharded engine's trajectory bit for bit
(``tests/test_torch_zero.py``).

Leaves no bucket covers never ride a collective; they keep a replicated
optimizer of their own over their stacked tensors, updated in place each
step, as on the unsharded path.
"""

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from bagua_tpu_torch.bucket import BucketPlan, flatten_bucket_leaves, tree_leaf_names
from bagua_tpu_torch.communication import rank_id
from bagua_tpu_torch.sharded.layout import ShardLayout, reshard_group_flat, to_device, to_host
from bagua_tpu_torch.utils import tree_flatten_with_names, tree_leaves, tree_unflatten

__all__ = ["ShardedOptState", "ShardedOptimizerUpdater"]


@dataclasses.dataclass
class ShardedOptState:
    """Engine-side optimizer state under the zero algorithm: the rows of
    each dtype group and the optimizer over them (shard-sized state: the
    memory win), plus a replicated optimizer for leaves no bucket covers
    (None where every leaf is covered)."""

    rows: Tuple[torch.Tensor, ...]  # per dtype group, (n, shard_total)
    sharded: torch.optim.Optimizer  # over ``rows``
    local: Optional[torch.optim.Optimizer]


def _per_element(value: torch.Tensor, like: torch.Tensor) -> bool:
    """An optimizer state tensor that mirrors its parameter (a moment),
    as against a shape-free one (a step count)."""
    return value.shape == like.shape


class ShardedOptimizerUpdater:
    """Steps the optimizer on each rank's bucket shards only.

    Built by the engine whenever the bound algorithm reports
    ``sharded_update=True``; rebuilt on every ``rebucket`` (the layout is a
    function of the plan and the group size, and
    :meth:`reshard_state` migrates live state between layouts)."""

    def __init__(self, optimizer: Callable, plan: BucketPlan, group):
        self.optimizer = optimizer
        self.plan = plan
        self.group = group
        self.layout = ShardLayout.from_plan(plan, group.exchange_size)
        self._covered = plan.covered()

    # -- helpers -------------------------------------------------------------

    def _uncovered(self, tree) -> Dict[str, torch.Tensor]:
        return {n: leaf for n, leaf in tree_flatten_with_names(tree) if n not in self._covered}

    def _bucket_shards(self, tree) -> List[torch.Tensor]:
        """Each rank's flat slice of every bucket of the rank-stacked
        ``tree``, plan order: ``(n, shard_numel)``, row r rank r's."""
        groups = self.plan.group_leaves(tree)
        k = self.group.local_size  # the stack's rows: this process's ranks
        ranks = torch.arange(k, device=self.group.device)
        me = rank_id(self.group, self.group.data_axes)  # the shard index: within the data axes
        shards = []
        for bi, spec in enumerate(self.plan.specs):
            flat = flatten_bucket_leaves([groups[bi][s.name] for s in spec.slots], spec)
            b = self.layout.buckets[bi]
            shards.append(flat.reshape(k, self.layout.n_shards, b.shard_numel)[ranks, me])
        return shards

    def _group_rows(self, shards: List[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.cat([shards[bi] for bi in g.buckets], dim=1) for g in self.layout.groups)

    def pending(self, opt_state: ShardedOptState) -> Tuple[torch.Tensor, ...]:
        """Each bucket's updated parameter shards, ``(n, shard_numel)``:
        views of the rows."""
        out: List[Optional[torch.Tensor]] = [None] * self.plan.num_buckets
        for rows, grp in zip(opt_state.rows, self.layout.groups):
            col = 0
            for bi in grp.buckets:
                sh = self.layout.buckets[bi].shard_numel
                out[bi] = rows[:, col:col + sh]
                col += sh
        return tuple(out)

    # -- API -----------------------------------------------------------------

    def init(self, params) -> ShardedOptState:
        """The rows, seeded with each rank's shards of the rank-stacked
        ``params``, and the optimizer over them; the replicated optimizer
        over the uncovered leaves."""
        rows = self._group_rows(self._bucket_shards(params))
        local = list(self._uncovered(params).values())
        return ShardedOptState(rows, self.optimizer(list(rows)), self.optimizer(local) if local else None)

    def update_shards(self, shards, params, opt_state: ShardedOptState, local_grads=None):
        """One sharded optimizer phase.

        ``shards`` is the exchange's output: each bucket's reduced shards,
        plan order, ``(size, shard_numel)`` with row r rank r's.
        ``local_grads`` maps each leaf no bucket covers to its gradient
        (needed only where there are such leaves).  Returns ``(pending,
        opt_state, params)``: ``pending`` one updated parameter shard per
        bucket, ``(n, shard_numel)`` views of the rows, which the algorithm
        all-gathers into the parameters at the start of the next step.
        Covered parameters are not touched here; uncovered ones are updated
        in place.  The rows and the optimizer state are updated in place."""
        for rows, g in zip(opt_state.rows, self._group_rows(list(shards))):
            rows.grad = g
        opt_state.sharded.step()
        opt_state.sharded.zero_grad(set_to_none=True)
        if opt_state.local is not None:
            local_p = self._uncovered(params)
            if local_grads is None or set(local_grads) != set(local_p):
                raise ValueError(f"update_shards needs the gradients of the uncovered leaves {sorted(local_p)}")
            for name, g in local_grads.items():
                local_p[name].grad = g
            opt_state.local.step()
            opt_state.local.zero_grad(set_to_none=True)
        return self.pending(opt_state), opt_state, params

    # -- the unsharded engine's state ------------------------------------------
    #
    # The bitwise contract means the sharded state IS the unsharded state,
    # re-laid out: moment rows are flat slices of the full moments, counts
    # are shape-free.  The two methods below map between this state and the
    # unsharded engine's ``optimizer.state_dict()`` (its optimizer is over
    # ``tree_leaves`` of the rank-stacked parameters) without a collective:
    # the engine's ``switch_algorithm`` into and out of ZeRO calls them
    # (``rebucket`` migrates through :meth:`reshard_state`).

    def gather_full_state(self, opt_state: ShardedOptState, params) -> dict:
        """The sharded state as the unsharded engine's ``state_dict()``
        over the rank-stacked ``params``: each parameter's moments whole on
        every rank (the concatenation of every rank's shard), its
        shape-free entries as the sharded optimizer holds them."""
        names = tree_leaf_names(params)
        index = {name: i for i, name in enumerate(names)}
        leaves = tree_leaves(params)
        sd = opt_state.sharded.state_dict()
        state: Dict[int, dict] = {}
        for gi, grp in enumerate(self.layout.groups):
            for key, value in sd["state"].get(gi, {}).items():
                col = 0
                for bi in grp.buckets:
                    b = self.layout.buckets[bi]
                    full = value[:, col:col + b.shard_numel].reshape(-1) \
                        if _per_element(value, opt_state.rows[gi]) else None
                    for s in b.slots:
                        i = index[s.name]
                        state.setdefault(i, {})[key] = value.clone() if full is None else \
                            full[s.offset:s.offset + s.numel].reshape(leaves[i].shape[1:]).expand_as(leaves[i]).clone()
                    col += b.shard_numel
        if opt_state.local is not None:
            local = opt_state.local.state_dict()["state"]
            for j, name in enumerate(self._uncovered(params)):
                if j in local:
                    state[index[name]] = {k: v.clone() for k, v in local[j].items()}
        groups = [{**pg, "params": list(range(len(names)))} for pg in sd["param_groups"]]
        return {"state": state, "param_groups": groups}

    def scatter_full_state(self, full_state: dict, params) -> ShardedOptState:
        """Inverse of :meth:`gather_full_state`: the unsharded engine's
        ``state_dict()`` over the rank-stacked ``params`` -> the
        :class:`ShardedOptState` this updater would hold, its rows seeded
        from ``params``.  Rank r keeps its shard of its own row of each
        moment (alignment padding zero, as at init); shape-free entries
        are taken from the group's first parameter."""
        opt_state = self.init(params)
        all_names = tree_leaf_names(params)
        index = {name: i for i, name in enumerate(all_names)}
        leaves = tree_leaves(params)
        full = full_state["state"]
        state: Dict[int, dict] = {}
        for gi, grp in enumerate(self.layout.groups):
            names = [s.name for bi in grp.buckets for s in self.layout.buckets[bi].slots]
            first = full.get(index[names[0]])
            if first is None:
                continue
            for key, value in first.items():
                missing = [n for n in names if key not in full.get(index[n], {})]
                if missing:
                    raise ValueError(f"full optimizer state is missing {key!r} of {missing[0]!r}")
                if not _per_element(value, leaves[index[names[0]]]):
                    state.setdefault(gi, {})[key] = value.clone()
                    continue
                tree = tree_unflatten(params, [
                    full[i][key] if name in names else torch.zeros_like(leaf)
                    for i, (name, leaf) in enumerate(zip(all_names, leaves))
                ])
                shards = self._bucket_shards(tree)
                state.setdefault(gi, {})[key] = torch.cat([shards[bi] for bi in grp.buckets], dim=1)
        groups = [{**pg, "params": list(range(len(opt_state.rows)))} for pg in full_state["param_groups"]]
        opt_state.sharded.load_state_dict({"state": state, "param_groups": groups})
        if opt_state.local is not None:
            uncovered = list(self._uncovered(params))
            opt_state.local.load_state_dict({
                "state": {j: {k: v.clone() for k, v in full[index[n]].items()}
                          for j, n in enumerate(uncovered) if index[n] in full},
                "param_groups": [{**pg, "params": list(range(len(uncovered)))}
                                 for pg in full_state["param_groups"]],
            })
        return opt_state

    # -- plan changes ------------------------------------------------------------

    def reshard_state(self, opt_state: ShardedOptState, old: ShardLayout) -> ShardedOptState:
        """The state built under the shard layout ``old`` moved to this
        updater's layout (a mid-training ``rebucket``): the rows and every
        per-element state tensor value for value by tensor name
        (:func:`~bagua_tpu_torch.sharded.layout.reshard_group_flat`, on the
        host), shape-free entries as they are; a new optimizer over the new
        rows takes the old one's hyperparameters."""
        olds = []
        for grp in self.layout.groups:
            og = old.group_for(grp.dtype)
            if og is None:
                raise ValueError(f"cannot reshard: old layout lacks dtype group {grp.dtype!r}")
            olds.append(old.groups.index(og))

        def move(t: torch.Tensor, oi: int) -> torch.Tensor:
            flat = reshard_group_flat(to_host(t), old, self.layout, old.groups[oi].dtype)
            return to_device(flat, t.dtype, t.device)

        rows = tuple(move(opt_state.rows[oi], oi) for oi in olds)
        sd = opt_state.sharded.state_dict()
        state = {
            gi: {k: move(v, oi) if _per_element(v, opt_state.rows[oi]) else v.clone()
                 for k, v in sd["state"][oi].items()}
            for gi, oi in enumerate(olds) if oi in sd["state"]
        }
        sharded = self.optimizer(list(rows))
        sharded.load_state_dict({"state": state, "param_groups": [
            {**pg, "params": list(range(len(rows)))} for pg in sd["param_groups"]]})
        return ShardedOptState(rows, sharded, opt_state.local)
