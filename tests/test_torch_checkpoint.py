"""The port's checkpoints (``bagua_tpu_torch/checkpoint/``, a rewrite
without orbax) against the JAX package's rules: the tracker and the
completion marker, the scan that heals a torn write, the marker published
before the tracker, the expert split, and ``remap_world_size`` bitwise the
JAX package's on the same numpy trees (replicated and expert leaves)."""

import collections
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bagua_tpu.checkpoint import remap_world_size as jax_remap

from bagua_tpu_torch.algorithms import build_algorithm
from bagua_tpu_torch.checkpoint import (
    COMPLETE_FILENAME,
    TRACKER_FILENAME,
    get_latest_iteration,
    load_checkpoint,
    remap_world_size,
    save_checkpoint,
)
from bagua_tpu_torch.checkpoint.checkpointing import _atomic_write
from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.ddp import DistributedDataParallel, state_leaves
from bagua_tpu_torch.distributed.run import parse_nnodes
from bagua_tpu_torch.models import mlp


def test_tracker_torn_write_falls_back_to_scan(tmp_path):
    """Every torn-write interleaving heals to the newest checkpoint whose
    marker landed: a tracker that names an incomplete checkpoint, a torn
    tracker, none, or one past every directory."""
    root = str(tmp_path)

    def fake_ckpt(iteration, complete=True):
        d = tmp_path / f"iter_{iteration:07d}"
        d.mkdir()
        (d / "model_states.npz").write_bytes(b"")
        if complete:
            _atomic_write(str(d / COMPLETE_FILENAME), str(iteration))

    assert get_latest_iteration(root) is None
    fake_ckpt(3)
    fake_ckpt(5, complete=False)
    for tracker in ("3", "5", "5\x00garbage", None, "9000"):
        if tracker is None:
            (tmp_path / TRACKER_FILENAME).unlink()
        else:
            (tmp_path / TRACKER_FILENAME).write_text(tracker)
        assert get_latest_iteration(root) == 3, tracker
    (tmp_path / f"iter_{3:07d}" / COMPLETE_FILENAME).unlink()
    assert get_latest_iteration(root) is None
    (tmp_path / "iter_notanumber").mkdir()
    assert get_latest_iteration(root) is None


def test_save_publishes_marker_then_tracker_and_splits_experts(tmp_path):
    """A save leaves the marker in the checkpoint, the tracker at the root
    and no temporary file; expert leaves go to their own half, and a load
    merges both halves back, bitwise (a bfloat16 leaf included)."""
    tree = {"dense": {"w": torch.arange(6.0).reshape(2, 3), "h": torch.ones(4, dtype=torch.bfloat16) / 3},
            "moe": {"experts": torch.arange(24.0).reshape(2, 4, 3)}}
    save_checkpoint(7, str(tmp_path), tree)
    d = tmp_path / "iter_0000007"
    assert (d / COMPLETE_FILENAME).read_text() == "7" and (tmp_path / TRACKER_FILENAME).read_text() == "7"
    assert [os.path.join(r, n) for r, _, ns in os.walk(tmp_path) for n in ns if ".tmp." in n] == []
    assert json.loads((d / "model_states.json").read_text())["leaf_keys"] == ["['dense']['h']", "['dense']['w']"]
    assert json.loads((d / "expert_states.json").read_text())["leaf_keys"] == ["['moe']['experts']"]
    leaves, it = load_checkpoint(str(tmp_path))
    assert it == 7 and sorted(leaves) == ["['dense']['h']", "['dense']['w']", "['moe']['experts']"]
    assert torch.equal(torch.from_numpy(leaves["['dense']['h']"]).view(torch.bfloat16), tree["dense"]["h"])
    np.testing.assert_array_equal(leaves["['moe']['experts']"], tree["moe"]["experts"].numpy())
    save_checkpoint(8, str(tmp_path), tree, moe_split=False)
    assert not (tmp_path / "iter_0000008" / "expert_states.npz").exists()
    assert get_latest_iteration(str(tmp_path)) == 8


def test_train_state_round_trip_and_refusal(tmp_path):
    """An engine state saved and loaded into a fresh state of the same
    definition is bitwise, SGD's momentum and the step included; a state of
    another model is refused."""
    group = BaguaProcessGroup([torch.device("cpu")] * 4, intra_size=2)

    def engine():
        return DistributedDataParallel(mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
                                       build_algorithm("bytegrad"), group, bucket_size_bytes=256)

    params = mlp.init_mlp(torch.Generator().manual_seed(0), [6, 8, 2], device="cpu")
    ddp = engine()
    state = ddp.init(params)
    rng = np.random.RandomState(0)
    for _ in range(2):
        state, _ = ddp.train_step(state, (torch.from_numpy(rng.randn(8, 6).astype(np.float32)),
                                          torch.from_numpy(rng.randn(8, 2).astype(np.float32))))
    save_checkpoint(state.step, str(tmp_path), state)
    other = engine()
    loaded, it = load_checkpoint(str(tmp_path), target=other.init(mlp.init_mlp(torch.Generator().manual_seed(1),
                                                                               [6, 8, 2], device="cpu")))
    assert it == 2 and loaded.step == 2
    got, want = state_leaves(loaded), state_leaves(state)
    assert [k for k, _ in got] == [k for k, _ in want]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(got, want))
    smaller = engine().init(mlp.init_mlp(torch.Generator().manual_seed(1), [6, 2], device="cpu"))
    with pytest.raises(ValueError, match="do not match"):
        load_checkpoint(str(tmp_path), target=smaller)


def _trees():
    """The JAX package's checkpoint-test trees, as numpy in 32 bits (JAX
    without x64 would take float64 as float32)."""
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return {
        "replicated_and_expert": {"dense": {"w": f32(np.broadcast_to(np.arange(6.0)[None], (8, 6)).copy())},
                                  "moe": {"experts": f32(np.arange(8 * 2 * 3.0).reshape(8, 2, 3))}},
        "odd": {"dense": {"w": f32(np.broadcast_to(np.arange(5.0)[None], (6, 5)).copy())},
                "moe": {"experts": f32(np.arange(6 * 2 * 3.0).reshape(6, 2, 3))}},
        "holey": {"dense": None, "moe": {"experts": f32(np.arange(6 * 2 * 3.0).reshape(6, 2, 3))}},
        "sequences": {"opt": (f32(np.arange(12.0).reshape(4, 3)), [np.ones((4, 2), np.float32)]),
                      "experts_bank": np.arange(16, dtype=np.int32).reshape(4, 2, 2)},
    }


Named = collections.namedtuple("Named", ["params", "experts"])


@pytest.mark.parametrize("tree", list(_trees()) + ["named"])
@pytest.mark.parametrize("new_size", [2, 3, 4, 12, 16, 24])
def test_remap_world_size_bitwise_jax(tree, new_size):
    """The same numpy trees through both functions: the same leaves bit for
    bit (or both refuse a pool that does not divide)."""
    named = Named(np.arange(8, dtype=np.float32).reshape(4, 2), np.arange(24, dtype=np.float32).reshape(4, 6, 1))
    state = named if tree == "named" else _trees()[tree]
    try:
        want = jax_remap(state, new_size)
    except ValueError:
        with pytest.raises(ValueError, match="redistribute"):
            remap_world_size(state, new_size)
        return
    got = remap_world_size(state, new_size)
    flat_got, flat_want = _flatten(got), _flatten(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        if b is None:
            assert a is None, path
            continue
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b), path


def _flatten(node, path=""):
    if isinstance(node, dict):
        return [x for k in sorted(node) for x in _flatten(node[k], f"{path}['{k}']")]
    if isinstance(node, (list, tuple)):
        return [x for i, c in enumerate(node) for x in _flatten(c, f"{path}[{i}]")]
    return [(path, node)]


def test_remap_world_size_flat_leaves_and_expert_round_trip():
    """A flat ``{key: array}`` (a snapshot's or a checkpoint's leaves) remaps
    as a dict whose keys hold the paths; the expert pool survives a shrink
    and a grow bitwise; 0-d leaves (the port's step counts) pass through."""
    experts = np.arange(6 * 2 * 3, dtype=np.float32).reshape(6, 2, 3)
    flat = {".params['moe']['experts']": experts, ".params['w']": np.ones((6, 2)), ".step": np.array(5)}
    back = remap_world_size(remap_world_size(flat, 2), 6)
    np.testing.assert_array_equal(back[".params['moe']['experts']"], experts)
    assert back[".params['w']"].shape == (6, 2) and back[".step"] == 5
    np.testing.assert_array_equal(np.asarray(jax_remap({"experts": jnp.asarray(experts)}, 3)["experts"]),
                                  remap_world_size({"experts": experts}, 3)["experts"])


def test_parse_nnodes():
    assert parse_nnodes("3") == (3, 3)
    assert parse_nnodes("1:4") == (1, 4)
    with pytest.raises(ValueError):
        parse_nnodes("4:2")
