"""Checkpoint save and load with an MoE-aware layout (the port of
``bagua_tpu/checkpoint/checkpointing.py``, without orbax).

* A tracker file ``latest_checkpointed_iteration.txt`` at the checkpoint
  root names the newest complete checkpoint; ``iter_%07d/.complete`` is
  published before it, so a crash between the two leaves a complete,
  discoverable checkpoint behind a stale tracker (healed by
  :func:`get_latest_iteration`'s marker check and scan), never the reverse.
  Every file goes through write-temp and rename.
* The non-expert ("model") state and the expert state are stored apart
  (``expert_filter`` on each leaf's key), so a job restarted with another
  expert-parallel layout can remap the experts.

Each half is one npz of the flattened leaves (``leaf_%05d``, no pickle)
beside a JSON of their keys and torch dtypes (a bfloat16 leaf is stored as
its 16-bit pattern).  A train state flattens through the engine's
:func:`~bagua_tpu_torch.ddp.state_leaves` and loads through
:func:`~bagua_tpu_torch.ddp.load_state_leaves`, the pair the snapshots use.
"""

import json
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from bagua_tpu_torch.parallel.moe.utils import is_moe_param_path

TRACKER_FILENAME = "latest_checkpointed_iteration.txt"
COMPLETE_FILENAME = ".complete"
HALVES = ("model_states", "expert_states")


def _ckpt_path(ckpt_dir: str, iteration: int) -> str:
    return os.path.join(ckpt_dir, f"iter_{iteration:07d}")


def _atomic_write(path: str, text: str) -> None:
    """Write-temp and rename, so no reader ever sees a torn file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def _is_complete(ckpt_dir: str, iteration: int) -> bool:
    return os.path.exists(os.path.join(_ckpt_path(ckpt_dir, iteration), COMPLETE_FILENAME))


def _host_leaves(state):
    """``[(key, host array, torch dtype name)]`` of a train state (the
    engine's flattening) or of a tree of tensors (keys by name)."""
    from bagua_tpu_torch.ddp import TrainState, state_leaves
    from bagua_tpu_torch.resilience.snapshot import dtype_name, host_array
    from bagua_tpu_torch.utils import tree_flatten_with_names

    items = state_leaves(state) if isinstance(state, TrainState) else tree_flatten_with_names(state)
    out = []
    for key, t in items:
        t = t.detach().cpu()
        out.append((key, host_array(t), dtype_name(t.dtype)))
    return out


def _write_half(path: str, name: str, items) -> None:
    from bagua_tpu_torch.resilience.snapshot import save_npz

    tmp = os.path.join(path, f"{name}.npz.tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        save_npz(f, [a for _, a, _ in items])
    os.replace(tmp, os.path.join(path, f"{name}.npz"))
    _atomic_write(os.path.join(path, f"{name}.json"), json.dumps(
        {"leaf_keys": [k for k, _, _ in items], "leaf_dtypes": [d for _, _, d in items]}))


def save_checkpoint(
    iteration: int,
    ckpt_dir: str,
    state,
    moe_split: bool = True,
    expert_filter: Callable[[str], bool] = is_moe_param_path,
) -> str:
    """Save ``state`` under ``ckpt_dir/iter_XXXXXXX`` and update the tracker.

    ``state`` is a :class:`~bagua_tpu_torch.ddp.TrainState` (under a
    sharded-update algorithm the pending shards ride along, so a load
    reproduces the lagging parameters and their update) or a tree of
    tensors.  ``expert_filter(leaf_key) -> bool`` names the per-rank
    (expert) leaves; keep it the complement of the engine's ``dp_filter``
    if you customized expert naming."""
    path = _ckpt_path(ckpt_dir, iteration)
    os.makedirs(path, exist_ok=True)
    items = _host_leaves(state)
    expert = [it for it in items if moe_split and expert_filter(it[0])]
    _write_half(path, HALVES[0], [it for it in items if not (moe_split and expert_filter(it[0]))])
    if expert:
        _write_half(path, HALVES[1], expert)
    # the marker certifies the states landed; the tracker is only a shortcut
    # over scanning, so it goes last
    _atomic_write(os.path.join(path, COMPLETE_FILENAME), str(iteration))
    _atomic_write(os.path.join(ckpt_dir, TRACKER_FILENAME), str(iteration))
    return path


def _scan_latest_complete(ckpt_dir: str) -> Optional[int]:
    """The newest ``iter_*`` directory bearing the completion marker."""
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return None
    iterations = []
    for name in names:
        if name.startswith("iter_"):
            try:
                iterations.append(int(name[len("iter_"):]))
            except ValueError:
                continue
    for it in sorted(iterations, reverse=True):
        if _is_complete(ckpt_dir, it):
            return it
    return None


def get_latest_iteration(ckpt_dir: str) -> Optional[int]:
    """The newest *complete* checkpointed iteration, or None.

    The tracker names the candidate, but it is trusted only when the
    checkpoint it points at carries its completion marker: a torn tracker
    or a truncated checkpoint directory falls back to scanning ``iter_*``
    for the newest marked one."""
    tracker = os.path.join(ckpt_dir, TRACKER_FILENAME)
    try:
        with open(tracker) as f:
            it = int(f.read().strip())
        if _is_complete(ckpt_dir, it):
            return it
    except (OSError, ValueError):
        pass
    return _scan_latest_complete(ckpt_dir)


def _read_half(path: str, name: str, leaves: Dict[str, np.ndarray], dtypes: Dict[str, str]) -> None:
    with open(os.path.join(path, f"{name}.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, f"{name}.npz")) as z:
        arrays = [z[k] for k in sorted(z.files)]
    if len(arrays) != len(meta["leaf_keys"]):
        raise ValueError(f"{path}/{name}: {len(arrays)} arrays for {len(meta['leaf_keys'])} keys")
    for key, dt, a in zip(meta["leaf_keys"], meta["leaf_dtypes"], arrays):
        leaves[key], dtypes[key] = a, dt


def load_checkpoint(
    ckpt_dir: str,
    iteration: Optional[int] = None,
    target=None,
) -> Tuple[object, int]:
    """Load the checkpoint the tracker names (or ``iteration``).  Returns
    ``(state, iteration)``.

    With ``target`` (a freshly built :class:`~bagua_tpu_torch.ddp.TrainState`
    of the same model and optimizer, e.g. ``Trainer.init_state``'s) the
    leaves are loaded into it in place and the state is returned; a state
    of another definition raises ValueError.  Without a target, ``state``
    is the ordered ``{key: host array}`` of both halves
    merged (bfloat16 leaves as their 16-bit pattern), what
    :func:`remap_world_size` and an elastic resume take."""
    if iteration is None:
        iteration = get_latest_iteration(ckpt_dir)
        if iteration is None:
            raise FileNotFoundError(f"no complete checkpoint in {ckpt_dir}")
    path = _ckpt_path(ckpt_dir, iteration)
    leaves: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    for name in HALVES:
        if os.path.exists(os.path.join(path, f"{name}.json")):
            _read_half(path, name, leaves, dtypes)
    if target is None:
        return leaves, iteration
    from bagua_tpu_torch.ddp import load_state_leaves

    return load_state_leaves(target, leaves, dtypes), iteration


def _keystr_children(node):
    """``(keystr piece, child)`` pairs of an inner node in JAX's flattening
    order, None for a leaf: dict keys ``['k']``, sequence items ``[i]``,
    named-tuple fields ``.name``."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def _rebuild(node, children):
    if isinstance(node, dict):
        return {k: children[f"[{k!r}]"] for k in node}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(children[f".{f}"] for f in node._fields))
    return type(node)(children[f"[{i}]"] for i in range(len(node)))


def remap_leaf(path: str, x, new_size: int, expert_filter: Callable[[str], bool] = is_moe_param_path):
    """One leaf of :func:`remap_world_size`: an expert leaf's global pool
    redistributed over ``new_size`` ranks, any other rank-stacked leaf's row
    0 re-stacked ``new_size`` times; a 0-d leaf (a step count the engine
    keeps once, not per rank) as it is; None stays None."""
    if x is None:
        return None
    x = np.asarray(x)
    if x.ndim == 0:
        return x
    if expert_filter(path):
        old_size, local = x.shape[0], x.shape[1]
        total = old_size * local
        if total % new_size != 0:
            raise ValueError(f"cannot redistribute {total} experts over {new_size} ranks (leaf {path})")
        return np.reshape(x, (new_size, total // new_size) + tuple(x.shape[2:]))
    one = x[0]
    return np.broadcast_to(one[None], (new_size,) + tuple(one.shape))


def remap_world_size(state, new_size: int, expert_filter: Callable[[str], bool] = is_moe_param_path):
    """Remap a rank-stacked state of host arrays to another world size (an
    elastic restart into a resized gang), leaf by leaf as JAX's function
    does, on numpy.

    * Replicated leaves (what centralized algorithms keep bitwise equal
      across ranks: params, optimizer state) are sliced to one copy and
      re-stacked to ``new_size``.
    * Expert leaves (``expert_filter`` on the leaf's keystr path) hold a
      different shard per rank, ``(old_size, local_experts, ...)``: the
      global pool ``old_size * local_experts`` is redistributed as
      ``(new_size, old_size * local_experts / new_size, ...)``; the total
      must divide evenly.

    ``state`` is a tree of dicts, lists, tuples and named tuples (a flat
    ``{key: array}`` of :func:`load_checkpoint` or a snapshot is a dict
    whose keys hold the paths).  Decentralized algorithms keep different
    weights per rank: remap their state only after a sync point."""

    def walk(path, node):
        children = _keystr_children(node)
        if children is None:
            return remap_leaf(path, node, new_size, expert_filter)
        return _rebuild(node, {piece: walk(path + piece, c) for piece, c in children})

    return walk("", state)
