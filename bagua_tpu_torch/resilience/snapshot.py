"""Async snapshots taken off the critical path, with atomic manifests (the
port of ``bagua_tpu/resilience/snapshot.py``: :class:`SnapshotStore` is a
copy, :class:`AsyncSnapshotter` a rewrite for tensors that the step
updates in place).

The synchronous checkpoint path (:mod:`bagua_tpu_torch.checkpoint`) blocks
the step loop for the whole device-to-host transfer and serialization.
The snapshotter moves that cost off the critical path:

1. **The double buffer.**  The port's optimizer updates the parameters in
   place, so a device-to-host copy that reads the live tensors would race
   the next step's ``optimizer.step()``.  :meth:`AsyncSnapshotter.snapshot`
   therefore clones every leaf on the card on the current (main) stream,
   queued after the step (whose end already waits for the overlap
   exchange's side stream), and records an event after the clones; that
   is all the training thread does.  The writer thread then copies the
   clones into pinned host buffers with ``non_blocking=True`` on a side
   stream that waits on that event, and keeps the clones alive until the
   copy's own event has completed.  The pinned buffers are allocated once
   (:meth:`AsyncSnapshotter.prepare`, which the ``Trainer`` calls when it
   builds the state: pinning gigabytes takes about a second) and reused.
   On the CPU the clone is the copy and no stream is involved.
2. **A background writer.**  The daemon thread waits on the copy's event
   (not on a device-wide synchronize) and writes the npz.  A cadence tick
   that finds the writer busy is skipped and counted
   (``snapshot_skipped_total``), never queued.
3. **Atomic completeness.**  Every file is written to a ``.tmp`` path and
   ``os.replace``-d; the manifest is written last and names every process
   file, so a snapshot is complete iff its manifest and every file it names
   exist.

The layout is the JAX package's, so its ``SnapshotStore`` reads a snapshot
the port wrote::

    <dir>/step_0000010/proc0.npz       # leaf_00000 ... in the engine's order
    <dir>/step_0000010/manifest.json   # written last, atomically

The leaves are the engine's flattening of its train state
(:func:`~bagua_tpu_torch.ddp.state_leaves`): the
parameters keyed by the JAX snapshot's ``leaf_keys`` paths, the optimizer's
tensors, the algorithm's state and the step.  The manifest records each
leaf's key (``leaf_keys``) and torch dtype (``leaf_dtypes``: a bfloat16
leaf is stored as its 16-bit pattern, numpy having no bfloat16).
"""

import json
import logging
import os
import queue
import shutil
import threading
import time
import zipfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bagua_tpu_torch.utils import tree_flatten_with_names

logger = logging.getLogger(__name__)

MANIFEST_FILENAME = "manifest.json"

__all__ = ["SnapshotStore", "AsyncSnapshotter", "MANIFEST_FILENAME", "host_array", "dtype_name", "save_npz"]


def _step_dirname(step: int) -> str:
    return f"step_{step:07d}"


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"``: the manifest's ``leaf_dtypes``."""
    return str(dtype).replace("torch.", "")


def save_npz(f, arrays: Sequence[np.ndarray]) -> None:
    """``np.savez(f, leaf_00000=arrays[0], ...)``: the same archive entries,
    byte for byte, but each leaf's data goes to its entry in one write from
    the array's own memory.  ``np.savez`` copies it through 16 MiB
    ``tobytes`` chunks, which hold the interpreter lock that the training
    thread needs; zipfile's crc and the file write release it."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for i, a in enumerate(arrays):
            a = np.asarray(a)
            if not (a.flags.c_contiguous or a.flags.f_contiguous):
                a = a.copy(order="C")
            # a Fortran-ordered array is stored in its own order, as numpy does
            data = a if a.flags.c_contiguous else a.T
            with zf.open(f"leaf_{i:05d}.npy", mode="w", force_zip64=True) as fp:
                np.lib.format.write_array_header_1_0(fp, np.lib.format.header_data_from_array_1_0(a))
                fp.write(data.reshape(-1).view(np.uint8))


def host_array(t: torch.Tensor) -> np.ndarray:
    """A host tensor's values as numpy (bfloat16 as its 16-bit pattern)."""
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


class SnapshotStore:
    """Filesystem layout + completeness rules for step snapshots."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, _step_dirname(step))

    # -- writing -------------------------------------------------------------

    def write_process_arrays(
        self, step: int, process_index: int, arrays: List[np.ndarray]
    ) -> str:
        """Atomically write one process's slice of every leaf (flat order)."""
        d = self.step_dir(step)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"proc{process_index}.npz")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            save_npz(f, arrays)
        os.replace(tmp, path)
        return path

    def write_manifest(self, step: int, manifest: Dict[str, Any]) -> str:
        """Atomically publish the manifest — the snapshot's commit record.
        It must name every process file (``files``); completeness is judged
        against that list, so ranks that die before writing leave the
        snapshot incomplete rather than torn."""
        d = self.step_dir(step)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, MANIFEST_FILENAME)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(manifest, f, sort_keys=True)
        os.replace(tmp, path)
        return path

    # -- reading -------------------------------------------------------------

    def read_manifest(self, step: int) -> Optional[Dict[str, Any]]:
        path = os.path.join(self.step_dir(step), MANIFEST_FILENAME)
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def is_complete(self, step: int) -> bool:
        manifest = self.read_manifest(step)
        if manifest is None:
            return False
        d = self.step_dir(step)
        return all(os.path.exists(os.path.join(d, f)) for f in manifest["files"])

    def steps(self) -> List[int]:
        """All step directories present (complete or not), ascending."""
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            if name.startswith("step_"):
                try:
                    out.append(int(name[len("step_"):]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_complete(self) -> Optional[int]:
        """Newest step whose manifest AND every named file exist — the only
        snapshot a resume may trust (torn/partial directories are skipped,
        never errors)."""
        for step in reversed(self.steps()):
            if self.is_complete(step):
                return step
        return None

    def load_stacked(self, step: int) -> Tuple[Dict[str, Any], List[np.ndarray]]:
        """Load a complete snapshot as full ``(world_size, ...)`` host
        arrays: every process file named by the manifest, concatenated along
        the leading (rank) axis in process order; a 0-d leaf (the step, an
        optimizer's count), the same in every process, is process 0's."""
        manifest = self.read_manifest(step)
        if manifest is None or not self.is_complete(step):
            raise FileNotFoundError(
                f"snapshot step {step} in {self.directory} is missing or incomplete"
            )
        d = self.step_dir(step)
        per_proc = []
        for fname in manifest["files"]:
            with np.load(os.path.join(d, fname)) as z:
                per_proc.append([z[k] for k in sorted(z.files)])
        n_leaves = len(per_proc[0])
        if any(len(p) != n_leaves for p in per_proc):
            raise ValueError(f"snapshot step {step}: process files disagree on leaf count")
        leaves = [
            np.concatenate([p[i] for p in per_proc], axis=0)
            if len(per_proc) > 1 and per_proc[0][i].ndim else per_proc[0][i]
            for i in range(n_leaves)
        ]
        return manifest, leaves

    # -- retention -----------------------------------------------------------

    def gc(self, keep: int = 2) -> None:
        """Drop all but the newest ``keep`` *complete* snapshots, plus any
        incomplete directory older than the newest complete one (garbage
        from a killed writer; an incomplete directory *newer* than the
        latest complete snapshot may still be in flight, so it stays)."""
        complete = [s for s in self.steps() if self.is_complete(s)]
        if not complete:
            return
        newest = complete[-1]
        doomed = set(complete[:-keep] if keep > 0 else complete)
        doomed.update(
            s for s in self.steps() if s < newest and not self.is_complete(s)
        )
        doomed.discard(newest)
        for step in doomed:
            shutil.rmtree(self.step_dir(step), ignore_errors=True)


class AsyncSnapshotter:
    """Cadenced state snapshots taken off the critical path (see the module
    docstring).

    Args:
        store: the :class:`SnapshotStore` (or a directory path).
        every: the cadence in steps, the lost-work bound K; 0 disables
            (``maybe_snapshot`` does nothing).
        leaves_fn: ``leaves_fn(state) -> [(key, tensor), ...]``: the
            engine's :func:`~bagua_tpu_torch.ddp.state_leaves`
            for a train state; by default a tree of tensors flattened by
            name (:func:`~bagua_tpu_torch.utils.tree_flatten_with_names`).
        process_index / num_processes: this process's place in the job
            (0 and 1: one controller drives every rank).  Process 0 writes
            the manifest.
        world_size: the rank-stacked leading size recorded in manifests
            (the group's size).
        telemetry: an optional hub; every written snapshot emits
            ``on_snapshot`` (wall ms, bytes, kind) and every skipped cadence
            tick bumps ``snapshot_skipped_total``.
        keep: complete snapshots kept (older ones are removed).
        manifest_extra_fn: called at write time for extra manifest fields:
            the engine's bucket-plan payload rides there, so that a resume
            adopts it without a planner cold start.

    After each snapshot, ``last_clone_ms`` holds the host time of the
    device-side clone (on the card, the time to queue it) and
    ``last_wall_ms`` / ``last_bytes`` the writer's wall time and bytes.
    """

    def __init__(
        self,
        store,
        every: int,
        leaves_fn: Optional[Callable[[Any], Sequence[Tuple[str, torch.Tensor]]]] = None,
        process_index: int = 0,
        num_processes: int = 1,
        world_size: int = 1,
        telemetry=None,
        keep: int = 2,
        manifest_extra_fn: Optional[Callable[[], Dict[str, Any]]] = None,
    ):
        self.store = store if isinstance(store, SnapshotStore) else SnapshotStore(store)
        self.every = int(every)
        self.leaves_fn = leaves_fn or tree_flatten_with_names
        self.process_index = process_index
        self.num_processes = num_processes
        self.world_size = world_size
        self.telemetry = telemetry
        self.keep = keep
        self.manifest_extra_fn = manifest_extra_fn
        self.skipped = 0
        self.written = 0
        self.last_step: Optional[int] = None
        self.last_clone_ms: Optional[float] = None
        self.last_wall_ms: Optional[float] = None
        self.last_bytes: Optional[int] = None
        #: pinned host buffers by leaf key, allocated at the first snapshot
        #: on the card and reused while the key's shape and dtype hold
        self._pinned: Dict[str, torch.Tensor] = {}
        self._copy_stream = None
        self._queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._idle = threading.Event()
        self._idle.set()
        self._stop = False
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._writer_loop, name="bagua-snapshotter", daemon=True)
        self._thread.start()

    # -- hot path ------------------------------------------------------------

    @property
    def busy(self) -> bool:
        """Whether a snapshot is being copied or written now (a cadence
        tick would be skipped)."""
        return not self._idle.is_set()

    def maybe_snapshot(self, state, step: int) -> bool:
        """Cadence gate and non-blocking hand-off.  Returns True when a
        snapshot of this step was queued."""
        if self.every <= 0 or step % self.every != 0 or step == self.last_step:
            return False
        return self.snapshot(state, step, blocking=False)

    def snapshot(self, state, step: int, blocking: bool = False, kind: str = "async") -> bool:
        """Buffer ``state`` and queue it for the writer.  A non-blocking call
        skips (and counts) while the writer is busy; ``blocking=True`` waits
        for the writer and for this snapshot to land (the preemption
        drain)."""
        if not blocking and self.busy:
            self.skipped += 1
            if self.telemetry is not None:
                self.telemetry.registry.counter(
                    "snapshot_skipped_total",
                    help="cadence ticks skipped because the previous snapshot was still writing",
                ).inc()
            return False
        if blocking:
            self._idle.wait()
        t0 = time.perf_counter()
        item = self._buffer(self.leaves_fn(state))
        self.last_clone_ms = (time.perf_counter() - t0) * 1e3
        self._idle.clear()
        self.last_step = step
        self._queue.put(item + (step, kind))
        if blocking:
            self._idle.wait()
            if self._error is not None:
                err, self._error = self._error, None
                raise err
        return True

    def force_snapshot(self, state, step: int) -> bool:
        """A synchronous snapshot: returns once the manifest is on disk.
        The preemption drain calls it after the in-flight step."""
        return self.snapshot(state, step, blocking=True, kind="final")

    def prepare(self, state) -> None:
        """Allocate the pinned host buffers for ``state``'s leaves on the
        card now, off the training loop (a no-op on the CPU)."""
        for key, t in self.leaves_fn(state):
            if t.is_cuda:
                self._pinned_for(key, t)

    def _pinned_for(self, key: str, t: torch.Tensor) -> torch.Tensor:
        buf = self._pinned.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = self._pinned[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf

    def _buffer(self, leaves):
        """The training thread's half of the double buffer: ``(keys, dtypes,
        clones, the event after the clones)``; the event is None on the
        CPU, where the clones are the host copies."""
        keys = [k for k, _ in leaves]
        clones = [t.detach().clone() for _, t in leaves]
        dtypes = [dtype_name(t.dtype) for t in clones]
        cuda = [t for t in clones if t.is_cuda]
        cloned = torch.cuda.current_stream(cuda[0].device).record_event() if cuda else None
        return keys, dtypes, clones, cloned

    def _to_host(self, keys, clones, cloned):
        """The writer thread's half: the clones copied into the pinned
        buffers on the copy stream, after the clones' event; returns once
        the copy has completed."""
        if cloned is None:
            return clones
        device = next(c.device for c in clones if c.is_cuda)
        with torch.cuda.device(device):
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(device)
            side = self._copy_stream
            side.wait_event(cloned)
            host = []
            with torch.cuda.stream(side):
                for key, c in zip(keys, clones):
                    if c.is_cuda:
                        buf = self._pinned_for(key, c)
                        buf.copy_(c, non_blocking=True)
                        c = buf
                    host.append(c)
            side.record_event().synchronize()
        return host

    # -- background writer ---------------------------------------------------

    def _writer_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            keys, dtypes, clones, cloned, step, kind = item
            try:
                self._write(keys, dtypes, clones, cloned, step, kind)
                self.written += 1
            except Exception as e:  # surfaces at the next blocking call
                logger.exception("snapshot at step %d failed", step)
                self._error = e
            finally:
                del clones, item
                self._idle.set()

    def _write(self, keys, dtypes, clones, cloned, step: int, kind: str) -> None:
        t0 = time.perf_counter()
        arrays = [host_array(t) for t in self._to_host(keys, clones, cloned)]
        self.store.write_process_arrays(step, self.process_index, arrays)
        if self.process_index == 0:
            manifest = {
                "step": int(step),
                "world_size": int(self.world_size),
                "num_processes": int(self.num_processes),
                "files": [f"proc{p}.npz" for p in range(self.num_processes)],
                "leaf_keys": list(keys),
                "leaf_dtypes": list(dtypes),
                "kind": kind,
            }
            if self.manifest_extra_fn is not None:
                try:
                    manifest.update(self.manifest_extra_fn() or {})
                except Exception:
                    logger.exception("manifest_extra_fn failed; manifest has no extras")
            self.store.write_manifest(step, manifest)
            self.store.gc(keep=self.keep)
        wall_ms = (time.perf_counter() - t0) * 1e3
        n_bytes = sum(a.nbytes for a in arrays)
        self.last_wall_ms, self.last_bytes = wall_ms, n_bytes
        logger.info("snapshot step %d (%s): %.1f MiB in %.1f ms (off the critical path)",
                    step, kind, n_bytes / 2 ** 20, wall_ms)
        if self.telemetry is not None:
            self.telemetry.on_snapshot(step=step, wall_ms=wall_ms, n_bytes=n_bytes, kind=kind)

    # -- teardown ------------------------------------------------------------

    def drain(self, timeout_s: float = 60.0) -> None:
        """Wait for an in-flight snapshot write to land."""
        self._idle.wait(timeout_s)

    def close(self) -> None:
        """Flush and stop the writer thread, and release the pinned buffers
        (idempotent)."""
        if self._stop:
            return
        self._stop = True
        self.drain()
        self._queue.put(None)
        self._thread.join(timeout=60.0)
        self._pinned = {}
