"""The port's resilience tier (``bagua_tpu_torch/resilience/``, the engine's
state flattening and the ``Trainer``'s snapshot, drain and resume) against
the JAX package's, on an 8-rank CPU group (``intra_size=4``).

The store's completeness, retention and busy-skip rules and the preemption
watcher are the JAX tests' cases on the port.  A ``Trainer`` drained by
``PreemptionWatcher.trigger()`` and resumed from its snapshot (or from a
checkpoint) must end bitwise equal to an uninterrupted run, for
``gradient_allreduce``, ByteGrad, decentralized and ZeRO: ZeRO's resumed
step is the reseed hazard (the port's ``init`` seeds the pending shards and
the updater's rows from the parameters, so a resume must put back the
snapshot's).  A resume into a resized gang equals the JAX package's
``remap_world_size`` of the same leaves, ZeRO's grow and shrink round trips
are bitwise, and the JAX package's ``SnapshotStore`` reads the port's
snapshots, whose parameter leaves match the JAX engine's snapshot of the
same run within the slice's tolerance.
"""

import json
import logging
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bagua_tpu.algorithms.gradient_allreduce import GradientAllReduceAlgorithm as JaxGAR
from bagua_tpu.checkpoint import remap_world_size as jax_remap
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP
from bagua_tpu.models import mlp as jax_mlp
from bagua_tpu.resilience import AsyncSnapshotter as JaxSnapshotter
from bagua_tpu.resilience import SnapshotStore as JaxStore

import chip_smoke
from bagua_tpu_torch.algorithms import build_algorithm
from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.ddp import DistributedDataParallel, state_leaves
from bagua_tpu_torch.models import mlp
from bagua_tpu_torch.observability.metrics import validate_metrics_file
from bagua_tpu_torch.observability.telemetry import Telemetry
from bagua_tpu_torch.resilience import (
    MANIFEST_FILENAME,
    AsyncSnapshotter,
    ElasticResumeCoordinator,
    PreemptionWatcher,
    SnapshotStore,
    clear_resumable_marker,
    read_resumable_marker,
    write_resumable_marker,
)
from bagua_tpu_torch.trainer import Trainer
from bagua_tpu_torch.utils import tree_leaves

LAYERS = [12, 16, 16, 4]
BUCKET = 1 << 9

#: name -> (algorithm, kwargs, optimizer factory): the drain/resume runs
RUNS = {
    "gradient_allreduce": ("gradient_allreduce", {}, lambda ps: torch.optim.SGD(ps, lr=0.05, momentum=0.9)),
    "bytegrad": ("bytegrad", {}, lambda ps: torch.optim.Adam(ps, lr=1e-2)),
    "decentralized": ("decentralized", {}, lambda ps: torch.optim.SGD(ps, lr=0.05)),
    "zero": ("zero", {}, lambda ps: torch.optim.Adam(ps, lr=1e-2)),
}


def tgroup(n=8, intra=4):
    return BaguaProcessGroup([torch.device("cpu")] * n, intra_size=intra)


def jax_params():
    return jax_mlp.init_mlp(jax.random.PRNGKey(5), LAYERS)


def port_params():
    return params_from_jax(jax.tree.map(np.asarray, jax_params()))


def batches(n=6, rows=40, seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(rows, LAYERS[0]).astype(np.float32), rng.randn(rows, LAYERS[-1]).astype(np.float32))
            for _ in range(n)]


def port_batches(n=6, rows=40, seed=3):
    return [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in batches(n, rows, seed)]


def trainer(group, run, **kw):
    algo, akw, opt = RUNS[run]
    return Trainer(mlp.mse_loss, opt, build_algorithm(algo, **akw), group, bucket_size_bytes=BUCKET, **kw)


def leaves_of(tr, state):
    return state_leaves(tr.ddp.finalize_pending_updates(state))


def assert_leaves_equal(a, b):
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), k


# -- the store: atomic completeness, retention --------------------------------------


def test_store_completeness_and_gc(tmp_path):
    """A snapshot is complete iff its manifest and every file it names
    exist; gc keeps the newest ``keep`` complete ones and an incomplete
    directory newer than them (it may still be in flight)."""
    store = SnapshotStore(str(tmp_path))
    arrays = [np.arange(8, dtype=np.float32).reshape(2, 4), np.ones(3)]
    store.write_process_arrays(5, 0, arrays)
    assert not store.is_complete(5) and store.latest_complete() is None
    store.write_manifest(5, {"step": 5, "world_size": 2, "num_processes": 1, "files": ["proc0.npz"]})
    assert store.is_complete(5) and store.latest_complete() == 5
    os.makedirs(store.step_dir(9), exist_ok=True)
    with open(os.path.join(store.step_dir(9), "proc0.npz.tmp.1"), "wb") as f:
        f.write(b"torn")
    store.write_manifest(12, {"step": 12, "world_size": 4, "num_processes": 2, "files": ["proc0.npz", "proc1.npz"]})
    store.write_process_arrays(12, 0, arrays)
    assert store.latest_complete() == 5
    assert not [n for n in os.listdir(store.step_dir(5)) if ".tmp." in n]
    _, got = store.load_stacked(5)
    for g, w in zip(got, arrays):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(FileNotFoundError):
        store.load_stacked(12)

    gc_store = SnapshotStore(str(tmp_path / "gc"))
    for step in (2, 4, 6):
        gc_store.write_process_arrays(step, 0, [np.ones(2)])
        gc_store.write_manifest(step, {"step": step, "world_size": 1, "num_processes": 1, "files": ["proc0.npz"]})
    os.makedirs(gc_store.step_dir(1))
    os.makedirs(gc_store.step_dir(7))
    gc_store.gc(keep=2)
    assert gc_store.steps() == [4, 6, 7]


def test_save_npz_entries_are_numpys():
    """The store's npz writer gives the archive entries ``np.savez`` gives,
    byte for byte (C-, Fortran- and non-contiguous leaves, 0-d, empty), so
    ``np.load`` and the JAX package's store read it alike."""
    import io
    import zipfile

    from bagua_tpu_torch.resilience.snapshot import save_npz

    arrays = [np.arange(12, dtype=np.float32).reshape(3, 4), np.array(5, dtype=np.int64),
              np.zeros((0, 3), np.float32), np.arange(20, dtype=np.int16).reshape(4, 5).T,
              np.ones((2, 2), bool), np.arange(24.0).reshape(2, 3, 4)[:, ::2],
              np.broadcast_to(np.arange(3, dtype=np.float32), (4, 3))]
    mine, theirs = io.BytesIO(), io.BytesIO()
    save_npz(mine, arrays)
    np.savez(theirs, **{f"leaf_{i:05d}": a for i, a in enumerate(arrays)})
    zm, zt = zipfile.ZipFile(mine), zipfile.ZipFile(theirs)
    assert zm.namelist() == zt.namelist()
    assert all(zm.read(n) == zt.read(n) for n in zm.namelist())


def test_snapshotter_cadence_busy_skip_and_errors(tmp_path):
    """The cadence gate, the per-step dedupe, a busy writer's skipped tick
    (counted in ``snapshot_skipped_total``), the forced snapshot's manifest
    extras and its bitwise round trip, and a writer error surfacing at the
    next blocking call."""
    state = {"w": torch.arange(16.0), "b": torch.ones(4, dtype=torch.bfloat16)}
    tel = Telemetry()
    snap = AsyncSnapshotter(str(tmp_path), every=2, telemetry=tel, keep=10,
                            manifest_extra_fn=lambda: {"plan": {"buckets": [["w"]]}})
    try:
        assert snap.maybe_snapshot(state, 1) is False
        assert snap.maybe_snapshot(state, 2) is True
        snap.drain()
        assert snap.store.latest_complete() == 2
        assert snap.maybe_snapshot(state, 2) is False
        snap._idle.clear()
        assert snap.maybe_snapshot(state, 4) is False
        snap._idle.set()
        assert snap.skipped == 1 and tel.registry.snapshot()["snapshot_skipped_total"] == 1
        assert snap.force_snapshot(state, 6) is True
        manifest = snap.store.read_manifest(6)
        assert manifest["kind"] == "final" and manifest["plan"] == {"buckets": [["w"]]}
        assert manifest["leaf_keys"] == ["['b']", "['w']"] and manifest["leaf_dtypes"] == ["bfloat16", "float32"]
        _, arrays = snap.store.load_stacked(6)
        assert torch.equal(torch.from_numpy(arrays[0]).view(torch.bfloat16), state["b"])
        assert torch.equal(torch.from_numpy(arrays[1]), state["w"])
        assert snap.written == 2 and snap.last_bytes == 4 * 2 + 16 * 4
    finally:
        snap.close()
        snap.close()
    assert tel.registry.snapshot()["snapshots_total"] == 2
    tel.close()

    snap2 = AsyncSnapshotter(str(tmp_path / "err"), every=1)

    def boom(*a, **k):
        raise OSError("disk full")

    snap2.store.write_process_arrays = boom
    try:
        with pytest.raises(OSError, match="disk full"):
            snap2.force_snapshot(state, 1)
    finally:
        snap2.close()
    off = AsyncSnapshotter(str(tmp_path / "off"), every=0)
    assert off.maybe_snapshot(state, 10) is False
    off.close()


# -- the preemption watcher ----------------------------------------------------------


def test_preemption_marker_and_sigterm_chaining(tmp_path):
    """``trigger()`` and a real SIGTERM set the flag; the handler chains the
    prior Python handler and ``uninstall`` restores it; the marker is
    written atomically, read back and consumed."""
    w = PreemptionWatcher()
    assert not w.should_stop()
    w.trigger()
    assert w.should_stop() and w.preempted
    write_resumable_marker(str(tmp_path), 7)
    assert read_resumable_marker(str(tmp_path))["step"] == 7
    clear_resumable_marker(str(tmp_path))
    assert read_resumable_marker(str(tmp_path)) is None

    seen = []
    prior = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        w2 = PreemptionWatcher().install()
        os.kill(os.getpid(), signal.SIGTERM)
        assert w2.should_stop() and w2.signum == signal.SIGTERM and seen == [signal.SIGTERM]
        w2.uninstall()
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == [signal.SIGTERM] * 2
    finally:
        signal.signal(signal.SIGTERM, prior)


# -- the Trainer: drain, then resume, bitwise -----------------------------------------


def _uninterrupted(run, data, tmp_path, **kw):
    tr = trainer(tgroup(), run, **kw)
    state = tr.fit(tr.init_state(port_params()), data, log_every=0)
    losses = tr.losses.clone()
    out = leaves_of(tr, state)
    tr.close()
    return out, losses


@pytest.mark.parametrize("run", list(RUNS))
def test_trainer_drain_then_resume_is_bitwise(run, tmp_path):
    """Three steps, a triggered preemption that drains the fourth and forces
    a final snapshot with a resumable marker, then a fresh ``Trainer`` over
    the same directory that resumes at step 4 on the carried plan and takes
    the last two: every leaf and the last losses equal the uninterrupted
    run's bit for bit."""
    data = port_batches()
    want, want_losses = _uninterrupted(run, data, tmp_path)
    snap_dir = str(tmp_path / "snaps")
    tr1 = trainer(tgroup(), run, snapshot_dir=snap_dir, snapshot_every=1000)
    state = tr1.fit(tr1.init_state(port_params()), data[:3], log_every=0)
    assert tr1.resume_result is None and state.step == 3
    tr1.preemption.trigger()
    state = tr1.fit(state, data[3:], log_every=0)
    assert tr1.preempted and state.step == 4
    assert read_resumable_marker(snap_dir)["step"] == 4
    assert SnapshotStore(snap_dir).latest_complete() == 4
    tr1.close()

    tel = Telemetry(metrics_jsonl=str(tmp_path / "m.jsonl"))
    tr2 = trainer(tgroup(), run, snapshot_dir=snap_dir, snapshot_every=1000, telemetry=tel)
    state2 = tr2.init_state(mlp.init_mlp(torch.Generator().manual_seed(9), LAYERS, device="cpu"))
    res = tr2.resume_result
    assert res is not None and res.step == 4 and res.plan_source == "carried"
    assert tr2.ddp._host_step == 4 and read_resumable_marker(snap_dir) is None
    state2 = tr2.fit(state2, data[4:], log_every=0)
    assert torch.equal(tr2.losses, want_losses)
    assert_leaves_equal(leaves_of(tr2, state2), want)
    tr2.close()
    tel.close()
    assert validate_metrics_file(str(tmp_path / "m.jsonl")) == []
    (restart,) = [json.loads(line) for line in open(tmp_path / "m.jsonl")
                  if json.loads(line)["event"] == "restart"]
    assert restart["step"] == 4 and restart["lost_steps"] == 0


@pytest.mark.parametrize("run", list(RUNS))
def test_trainer_checkpoint_resume_is_bitwise(run, tmp_path):
    """The same through ``ckpt_dir`` alone: a run stopped after step 4 with
    a checkpoint at step 3 restarts there and ends bitwise equal."""
    data = port_batches()
    want, want_losses = _uninterrupted(run, data, tmp_path)
    ckpt = str(tmp_path / "ckpt")
    tr1 = trainer(tgroup(), run, ckpt_dir=ckpt, ckpt_interval=3)
    tr1.fit(tr1.init_state(port_params()), data[:4], log_every=0)
    tr1.close()
    tr2 = trainer(tgroup(), run, ckpt_dir=ckpt, ckpt_interval=3)
    state = tr2.init_state(port_params())
    assert state.step == 3 and tr2.ddp._host_step == 3
    state = tr2.fit(state, data[3:], log_every=0)
    assert torch.equal(tr2.losses, want_losses)
    assert_leaves_equal(leaves_of(tr2, state), want)
    tr2.close()


def test_snapshot_leaf_keys_are_pinned(tmp_path):
    """The small VGG under ByteGrad and SGD with momentum, the card's
    ``[resil-ref]`` configuration: the snapshot's ``leaf_keys`` are the
    parameters' paths, one momentum buffer per parameter and the step
    (``chip_smoke.resil_leaf_keys``, which the card's run checks too)."""
    from bagua_tpu_torch.models.vgg import VGG, module_params, vgg_loss_fn

    g = tgroup(chip_smoke.RANKS, 1)
    model = VGG(**chip_smoke.REF_VGG, device="cpu", generator=torch.Generator().manual_seed(0))
    tr = Trainer(vgg_loss_fn(model), lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
                 build_algorithm("bytegrad"), g, snapshot_dir=str(tmp_path), snapshot_every=1)
    side = chip_smoke.REF_VGG["image_size"]
    rng = np.random.RandomState(0)
    batch = (torch.from_numpy(rng.rand(8, side, side, 3).astype(np.float32)),
             torch.from_numpy(rng.randint(0, 10, size=(8,)).astype(np.int64)))
    state = tr.fit(tr.init_state(module_params(model)), [batch], log_every=0)
    tr.close()
    manifest = SnapshotStore(str(tmp_path)).read_manifest(1)
    assert manifest["leaf_keys"] == chip_smoke.resil_leaf_keys(state.params)
    assert len(manifest["leaf_keys"]) == 2 * len(tree_leaves(state.params)) + 1


# -- resumes into other gangs ---------------------------------------------------------


def test_resume_into_a_resized_gang_equals_jax_remap(group, tmp_path):
    """A snapshot of the 8-rank gang resumed into 4 ranks: every leaf is the
    JAX package's ``remap_world_size`` of the snapshot's leaves, bitwise,
    and the parameters match the JAX engine's 8-rank run remapped to 4,
    within the f32 allreduce's summation-order tolerance."""
    data = port_batches(3)
    snap_dir = str(tmp_path / "snaps")
    tr1 = trainer(tgroup(), "gradient_allreduce", snapshot_dir=snap_dir, snapshot_every=3)
    tr1.fit(tr1.init_state(port_params()), data, log_every=0)
    tr1.close()
    manifest, arrays = JaxStore(snap_dir).load_stacked(3)
    tree = dict(zip(manifest["leaf_keys"], arrays))

    tr2 = trainer(tgroup(4, 4), "gradient_allreduce", snapshot_dir=snap_dir)
    state = tr2.init_state(port_params())
    assert tr2.resume_result.old_world_size == 8 and tr2.resume_result.new_world_size == 4
    # the JAX package's leaves are all rank-stacked; the port keeps its
    # step counts once (0-d), and they pass through unchanged
    want = jax_remap({k: a for k, a in tree.items() if a.ndim}, 4)
    for key, t in state_leaves(state):
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[key]) if key in want else tree[key], err_msg=key)
    tr2.close()

    ddp = JaxDDP(jax_mlp.mse_loss, optax.sgd(0.05, momentum=0.9), JaxGAR(), process_group=group,
                 bucket_size_bytes=BUCKET)
    jstate = ddp.init(jax_params())
    for x, y in batches(3):
        jstate, _ = ddp.train_step(jstate, (jnp.asarray(x), jnp.asarray(y)))
    jparams = jax_remap(jstate.params, 4)
    for (name, got), want in zip(
            [(k, t) for k, t in state_leaves(state) if k.startswith(".params")],
            jax.tree.leaves(jparams)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5, err_msg=name)


def _zero_trainer(group, snap_dir, bucket=BUCKET):
    return Trainer(mlp.mse_loss, lambda ps: torch.optim.Adam(ps, lr=1e-2), build_algorithm("zero"), group,
                   bucket_size_bytes=bucket, overlap=True, snapshot_dir=snap_dir, snapshot_every=1000)


def _snapshot(ddp, state, step, directory):
    snap = AsyncSnapshotter(directory, every=1, leaves_fn=state_leaves, world_size=ddp.group.size,
                            manifest_extra_fn=lambda: {"plan": ddp.export_plan_payload()})
    snap.force_snapshot(state, step)
    snap.close()


def test_zero_resume_grows_and_shrinks_bitwise(tmp_path):
    """ZeRO through resized gangs (the JAX tests' cases): 5 ranks grown to
    8 finalize to the 5-rank run's parameters bitwise; 8 shrunk to 5 (on a
    single-bucket cold plan, which the carried plan replaces) and grown
    back to 8 gives every leaf of the 8-rank state back bitwise, the
    sharded Adam moments and the pending shards included."""
    data = port_batches(2)
    tr5 = _zero_trainer(tgroup(5, 1), str(tmp_path / "unused5"))
    st5 = tr5.fit(tr5.init_state(port_params()), data, log_every=0)
    _snapshot(tr5.ddp, st5, 2, str(tmp_path / "w5"))
    fin5 = tr5.ddp.finalize_pending_updates(st5)
    tr5.close()
    tr8 = _zero_trainer(tgroup(), str(tmp_path / "w5"))
    st8 = tr8.init_state(port_params())
    assert tr8.resume_result.old_world_size == 5 and tr8.resume_result.new_world_size == 8
    fin8 = tr8.ddp.finalize_pending_updates(st8)
    for a, b in zip(tree_leaves(fin8.params), tree_leaves(fin5.params)):
        assert torch.equal(a[0], b[0])
    st8, losses = tr8.ddp.train_step(st8, data[0])
    assert torch.isfinite(losses).all() and st8.step == 3
    tr8.close()

    tra = _zero_trainer(tgroup(), str(tmp_path / "unused8"))
    sta = tra.fit(tra.init_state(port_params()), data, log_every=0)
    want = [(k, t.clone()) for k, t in state_leaves(sta)]
    _snapshot(tra.ddp, sta, 2, str(tmp_path / "w8"))
    tra.close()
    trb = _zero_trainer(tgroup(5, 1), str(tmp_path / "w8"), bucket=1 << 22)
    stb = trb.init_state(port_params())
    assert trb.resume_result.plan_source == "carried" and trb.ddp.plan.num_buckets == tra.ddp.plan.num_buckets
    _snapshot(trb.ddp, stb, 2, str(tmp_path / "w8to5"))
    trb.close()
    trc = _zero_trainer(tgroup(), str(tmp_path / "w8to5"))
    stc = trc.init_state(port_params())
    assert trc.resume_result.old_world_size == 5
    assert_leaves_equal(state_leaves(stc), want)
    trc.close()


def test_resume_refuses_a_mismatched_state(tmp_path):
    """A snapshot of another model fails loud through the coordinator (the
    ``Trainer`` logs it and starts fresh, its documented fallback); an
    empty directory is a clean None."""
    snap_dir = str(tmp_path / "snaps")
    tr = trainer(tgroup(), "gradient_allreduce", snapshot_dir=snap_dir, snapshot_every=1)
    tr.fit(tr.init_state(port_params()), port_batches(1), log_every=0)
    tr.close()
    ddp = DistributedDataParallel(mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.05),
                                  build_algorithm("gradient_allreduce"), tgroup(), bucket_size_bytes=BUCKET)
    smaller = ddp.init(mlp.init_mlp(torch.Generator().manual_seed(0), [12, 16, 4], device="cpu"))
    with pytest.raises(ValueError, match="do not match"):
        ElasticResumeCoordinator(snap_dir).resume(ddp, smaller)
    assert ElasticResumeCoordinator(str(tmp_path / "empty")).resume(ddp, smaller) is None


@pytest.mark.parametrize("run", ["gradient_allreduce", "zero"])
def test_a_failed_resume_writes_nothing_and_the_trainer_starts_fresh(run, tmp_path, caplog):
    """A snapshot whose leaf keys match but one of whose parameters has
    another shape (the second layer narrowed) is refused before anything
    is written: the state the resume was given keeps its values.  The
    ``Trainer`` logs the failure and starts fresh, bitwise a run that had
    no snapshot to resume."""
    snap_dir = str(tmp_path / "snaps")
    tr = trainer(tgroup(), run, snapshot_dir=snap_dir, snapshot_every=1)
    tr.fit(tr.init_state(port_params()), port_batches(1), log_every=0)
    tr.close()

    def narrower():
        return mlp.init_mlp(torch.Generator().manual_seed(0), [12, 16, 8, 4], device="cpu")

    ddp = trainer(tgroup(), run).ddp
    given = ddp.init(narrower())
    before = [(k, t.clone()) for k, t in state_leaves(given)]
    with pytest.raises(ValueError, match="shape"):
        ElasticResumeCoordinator(snap_dir).resume(ddp, given)
    assert_leaves_equal(state_leaves(given), before)

    data = port_batches(2)
    ref = trainer(tgroup(), run)
    want = leaves_of(ref, ref.fit(ref.init_state(narrower()), data, log_every=0))
    ref.close()
    with caplog.at_level(logging.WARNING, logger="bagua_tpu_torch.trainer"):
        tr2 = trainer(tgroup(), run, snapshot_dir=snap_dir, snapshot_every=1000)
        state = tr2.init_state(narrower())
    assert "snapshot resume failed" in caplog.text
    assert tr2.resume_result is None and state.step == 0
    state = tr2.fit(state, data, log_every=0)
    assert_leaves_equal(leaves_of(tr2, state), want)
    tr2.close()


def test_jax_store_reads_the_ports_snapshot(group, tmp_path):
    """The JAX package's ``SnapshotStore`` finds and loads a snapshot the
    port wrote (layout and manifest are the JAX package's), and its
    parameter leaves match, key for key, the JAX engine's snapshot of the
    same three steps within the f32 allreduce's tolerance."""
    data = port_batches(3)
    snap_dir = str(tmp_path / "port")
    tr = trainer(tgroup(), "gradient_allreduce", snapshot_dir=snap_dir, snapshot_every=3)
    tr.fit(tr.init_state(port_params()), data, log_every=0)
    tr.close()
    store = JaxStore(snap_dir)
    assert store.latest_complete() == 3
    manifest, arrays = store.load_stacked(3)
    assert manifest["kind"] == "async" and os.path.exists(os.path.join(store.step_dir(3), MANIFEST_FILENAME))
    mine = dict(zip(manifest["leaf_keys"], arrays))

    ddp = JaxDDP(jax_mlp.mse_loss, optax.sgd(0.05, momentum=0.9), JaxGAR(), process_group=group,
                 bucket_size_bytes=BUCKET)
    jstate = ddp.init(jax_params())
    for x, y in batches(3):
        jstate, _ = ddp.train_step(jstate, (jnp.asarray(x), jnp.asarray(y)))
    snap = JaxSnapshotter(str(tmp_path / "jax"), every=1, world_size=group.size)
    snap.force_snapshot(jstate, 3)
    snap.close()
    jmanifest, jarrays = JaxStore(str(tmp_path / "jax")).load_stacked(3)
    theirs = {k: a for k, a in zip(jmanifest["leaf_keys"], jarrays) if k.startswith(".params")}
    assert theirs and set(theirs) <= set(mine)
    for key, want in theirs.items():
        np.testing.assert_allclose(mine[key], want, rtol=0, atol=1e-5, err_msg=key)
