"""Asynchronous model averaging (the port of
``bagua_tpu/algorithms/async_model_average.py``).

The reference runs a background thread that keeps allreduce-averaging the
live weights on a CUDA stream of its own while training goes on; training
never waits for the average, and the staleness that brings is tolerated.
Here:

* A daemon **averager thread** wakes every ``sync_interval_ms`` and, once
  warmup is over and no delta is waiting, computes the **delta**
  ``mean_over_ranks(snapshot) - snapshot`` of the rank-stacked parameters
  into fresh tensors.  The snapshot is the live parameters themselves (the
  optimizer owns them and updates them in place, so taking one is not free
  as a JAX array's is):

  - on the card the delta runs on the averager's own CUDA stream, which
    first waits for an event the training stream recorded after its last
    write to the parameters (``host_post_dispatch``).  The next optimizer
    step must not write them before the delta has read them, so the
    training stream waits (``wait_event``, on the device) for the delta's
    ``done`` event in :meth:`transform_gradients`, just before the
    optimizer: free once the delta (about 1.3 ms for VGG16 over 4 ranks)
    has finished, and the host never waits;
  - on the CPU there are no streams: the delta is computed under
    ``host_dispatch_lock``, which the engine holds around the whole step,
    so the thread never reads a tensor the training thread is writing.

* At the next step's start (``host_pre_dispatch``) the engine **folds** a
  delta that has landed, ``params += delta`` in place, on the training
  stream.  Whether it has landed is a plain bool the averager thread sets
  (``_watch_pending`` polls the ``done`` event there): the step path makes
  no query of the device and never waits; a delta still in flight stays
  pending for a later step.
* A delta is correct only if no other fold landed between its snapshot and
  its fold (the other fold's correction would be applied twice): every
  fold bumps a **generation** counter, and a delta of an older generation
  is dropped.  Dropped deltas that may still be in flight are **orphans**,
  drained (waited for) by the averager thread or by ``abort()``, never by
  the step path.
* The steady-state step runs no collective; warmup steps average the
  gradients in f32 (one AVG allreduce per bucket), as the reference does.
* ``abort()`` drains any average in flight, discards it and parks the
  averager; ``resume()`` re-arms it; ``host_shutdown()`` stops the thread
  and joins it with a timeout.  The reference negotiates the abort with a
  one-byte MIN allreduce across processes: on a group that spans processes
  :meth:`_negotiate` is that MIN over every rank, each cycle, so every
  process runs the same collectives in the same order (an aborted process
  contributes 0 and keeps negotiating); single-controller, the local flag.
  Stopping is negotiated too: a process whose averager stops runs one more
  round, saying so, and every process's averager leaves after that round
  (:meth:`_leave`), so none is left waiting in a round its peer never
  joins.
* Across processes the averager's collectives ride a fork of the group
  (``BaguaProcessGroup.fork``): communicators of its own, so they never
  interleave with the step's.  The snapshot is then a copy taken under
  ``host_dispatch_lock`` and the collectives run after the lock is
  released: a process waiting in one for its peer holds no lock that
  its own training step needs.  No cycle starts before this process's
  warmup is over, as in the reference.

Only ``peer_selection_mode="all"`` exists, as in the reference.
"""

import contextlib
import logging
import threading
import time

import torch

from bagua_tpu_torch.algorithms.base import Algorithm, AlgorithmImpl, StepContext
from bagua_tpu_torch.communication import ReduceOp, _grouped, _ungrouped, allreduce
from bagua_tpu_torch.utils import tree_flatten_with_names, tree_unflatten

logger = logging.getLogger(__name__)

#: how long ``host_shutdown`` waits for the averager thread
JOIN_TIMEOUT_S = 5.0


class AsyncModelAverageAlgorithmImpl(AlgorithmImpl):
    algo_name = "async"

    def __init__(self, process_group, peer_selection_mode: str = "all", sync_interval_ms: int = 500,
                 warmup_steps: int = 0):
        super().__init__(process_group)
        if peer_selection_mode != "all":
            raise ValueError(
                "async model average supports peer_selection_mode='all' "
                "(the reference rejects others too, async_model_average.py:84-90)"
            )
        self.peer_selection_mode = peer_selection_mode
        self.sync_interval_ms = sync_interval_ms
        self.warmup_steps = warmup_steps

        self._status = "running"
        #: the rank-stacked parameters of the newest step (the live tensors)
        #: and, on the card, an event on the training stream after the last
        #: write to them.  Guarded by ``_pending_lock``
        self._latest = None
        self._latest_event = None
        self._published_step = 0
        #: ``(generation, delta tree, done event or None)`` awaiting a fold,
        #: and whether it has landed (set by the averager thread).  Guarded
        #: by ``_pending_lock``
        self._pending = None
        self._pending_ready = False
        #: bumped by every fold; a delta of an older generation is dropped
        self._fold_generation = 0
        #: dropped deltas that may still be in flight, drained off the step path
        self._orphans = []
        #: on the card: the ``done`` event of the last delta dispatched from
        #: the live parameters, which the training stream has not waited for
        #: yet.  Set and cleared under ``host_dispatch_lock``
        self._unwaited = None
        self._pending_lock = threading.Lock()
        self._cycle_lock = threading.Lock()  # held across one averaging cycle
        self.host_dispatch_lock = threading.Lock()  # shared with the engine
        self._stream = None  # the averager's CUDA stream, made at its first cycle
        self._thread = None
        self._stop_event = threading.Event()  # per thread; replaced on spawn
        self._wake = threading.Event()
        self._shutdown = False
        self.folds_applied = 0  # averages that landed in the parameters
        self.folds_failed = 0  # averages dropped for a failure
        #: across processes: the averager's own communicators (a collective
        #: call at construction, as every process builds the engine)
        self._spans = process_group.distributed
        self._avg_group = process_group.fork() if self._spans else process_group
        #: the outcome of every negotiation, in order
        self.negotiated = []
        #: across processes: a round said that some process's averager
        #: stopped, and this one left with it for good
        self._left = False

    # -- the delta ---------------------------------------------------------------

    def averaged_names(self):
        """The leaves the averager averages: those of the engine's bucket
        plan, so a leaf the engine's ``dp_filter`` keeps out of the
        exchange (an MoE rank's own experts) stays the rank's own."""
        return [slot.name for spec in self._bound_plan.specs for slot in spec.slots]

    def _delta(self, snapshot):
        """``mean_over_ranks(leaf) - leaf`` into fresh tensors, for each leaf
        of :meth:`averaged_names`: ``{name: delta}``.  The mean is summed
        over the ranks of each collective over the data axes left to right
        and divided, as the AVG ``allreduce``, without materializing its
        broadcast.  It runs off the engine's step, so it names the data
        axes itself.  Across processes it is the AVG ``allreduce`` itself
        (the same fold, on the averager's communicators) minus the leaf."""
        group = self.process_group
        axes = group.data_axes

        def delta_of(x):
            if self._spans:
                return allreduce(x, ReduceOp.AVG, self._avg_group, axes) - x
            g = _grouped(x, group, axes)
            red = g[:, 0]
            for r in range(1, g.shape[1]):
                red = red + g[:, r]
            red = red / torch.full_like(red, g.shape[1])
            return _ungrouped(red.unsqueeze(1) - g, group, axes)

        leaves = dict(tree_flatten_with_names(snapshot))
        with torch.no_grad():
            return {name: delta_of(leaves[name]) for name in self.averaged_names()}

    def _averager_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.process_group.device)
        return self._stream

    def _dispatch_delta(self, latest, event, guard: bool = True):
        """Start the delta of ``latest``: ``(delta, done)``.  On the card it
        runs on the averager's stream after ``event`` and ``done`` is
        recorded after it; on the CPU it is computed here and ``done`` is
        None.  Called under ``host_dispatch_lock`` when it reads the live
        parameters (``guard``: the training stream waits for ``done``
        before it writes them)."""
        device = self.process_group.device
        if device.type != "cuda":
            return self._delta(latest), None
        stream = self._averager_stream()
        with torch.cuda.stream(stream):
            if event is not None:
                stream.wait_event(event)
            delta = self._delta(latest)
            done = stream.record_event()
        if guard:
            self._unwaited = done
        return delta, done

    def _snapshot(self, latest, event):
        """A copy of the averaged leaves of ``latest`` (across processes,
        where the collectives run outside ``host_dispatch_lock``), under
        that lock: on the card on the averager's stream after ``event``,
        the training stream waiting for it before it writes them."""
        names = set(self.averaged_names())
        device = self.process_group.device

        def copy():
            return tree_unflatten(latest, [t.clone() if n in names else t
                                           for n, t in tree_flatten_with_names(latest)])
        with torch.no_grad():
            if device.type != "cuda":
                return copy()
            stream = self._averager_stream()
            with torch.cuda.stream(stream):
                if event is not None:
                    stream.wait_event(event)
                out = copy()
                self._unwaited = stream.record_event()
            return out

    @staticmethod
    def _landed(done) -> bool:
        """The readiness probe: has the delta of event ``done`` finished?
        Called on the averager thread only."""
        return done is None or done.query()

    # -- the averager thread -------------------------------------------------------

    def _negotiate(self, ready: bool, staying: bool = True) -> bool:
        """The group's MIN of the ranks' readiness (the reference's one-byte
        abort negotiation, ``bagua_tpu/algorithms/async_model_average.py:
        147-165``): across processes a MIN allreduce of every rank's flags
        on the averager's communicators (on the card on its stream), the
        readiness and ``staying``, which a process whose averager stops
        sends as 0: then every process leaves after this round
        (``_left``).  Single-controller the local flag."""
        if not self._spans:
            agreed = bool(ready)
        else:
            group = self._avg_group
            with torch.cuda.stream(self._averager_stream()) if group.device.type == "cuda" else contextlib.nullcontext():
                flags = torch.tensor([[int(bool(ready)), int(bool(staying))]] * group.local_size,
                                     dtype=torch.int32, device=group.device)
                agreed, stay = (bool(f) for f in allreduce(flags, ReduceOp.MIN, group, group.all_axes).amin(0))
            if not stay:
                self._left = True
        self.negotiated.append(agreed)
        return agreed

    def _leave(self) -> None:
        """Across processes, the round in which this process's averager
        stops (:meth:`_negotiate` with ``staying`` 0), which takes every
        peer's averager with it; nothing where it has left already."""
        if self._spans and not self._left:
            with self._cycle_lock:
                self._negotiate(False, staying=False)

    def _cycle(self, stop_event=None, wait: bool = True):
        """One averaging cycle.  ``wait=False`` (the thread's mode) publishes
        the delta in flight and never waits for it; ``wait=True`` (a manual
        call) waits until it has landed."""
        stop_event = stop_event or self._stop_event
        if self._spans and self._published_step < self.warmup_steps:
            # every process negotiates only once its warmup's allreduces
            # are behind it, so the collectives keep one order
            return
        with self._cycle_lock:
            with self._pending_lock:
                # a delta that is waiting makes a new one pure waste
                slot_free = self._pending is None
            ready = (self._status == "running" and not stop_event.is_set() and self._latest is not None
                     and self._published_step >= self.warmup_steps and slot_free)
            if not self._negotiate(ready, staying=not stop_event.is_set()):
                return
            with self.host_dispatch_lock:
                with self._pending_lock:
                    gen, latest, event = self._fold_generation, self._latest, self._latest_event
                if self._spans:
                    latest = self._snapshot(latest, event)
                else:
                    delta, done = self._dispatch_delta(latest, event)
            if self._spans:
                delta, done = self._dispatch_delta(latest, None, guard=False)
            if wait and done is not None:
                done.synchronize()
            with self._pending_lock:
                if self._status == "running" and gen == self._fold_generation:
                    if self._pending is not None:  # only a manual caller gets here
                        self._orphans.append(self._pending)
                    self._pending = (gen, delta, done)
                    self._pending_ready = wait or done is None
                else:
                    # aborted, or a fold raced this cycle: drained below
                    self._orphans.append((gen, delta, done))
            self._drain_orphans()

    def _drain_orphans(self):
        """Wait out dropped deltas that may still be in flight.  Called from
        the averager thread and ``abort()``, never from the step path."""
        with self._pending_lock:
            orphans, self._orphans = self._orphans, []
        for _, _, done in orphans:
            if done is not None:
                done.synchronize()

    def _watch_pending(self, stop_event):
        """Mark the pending delta ready once it has landed, polling its
        ``done`` event on this thread, so that the step path never queries
        the device.  Returns when it is ready, or when the slot changed
        under it (a fold, an abort)."""
        poll_s = min(0.01, self.sync_interval_ms / 1000.0 / 4)
        t0, warned = time.monotonic(), False
        while not stop_event.is_set():
            with self._pending_lock:
                if self._pending is None or self._pending_ready:
                    return
                gen, _, done = self._pending
            try:
                landed = self._landed(done)
            except RuntimeError as e:
                with self._pending_lock:
                    if self._pending is not None and self._pending[0] == gen:
                        self._orphans.append(self._pending)
                        self._pending, self._pending_ready = None, False
                self._log_fold_failure("pending delta unusable", e)
                return
            if landed:
                with self._pending_lock:
                    if self._pending is not None and self._pending[0] == gen:
                        self._pending_ready = True
                return
            if not warned and time.monotonic() - t0 > 30.0:
                warned = True
                logger.warning("async model average: delta in flight >30s; device stalled? "
                               "averaging is paused until it lands")
            stop_event.wait(poll_s)

    def _run(self, stop_event, wake):
        while True:
            wake.wait(self.sync_interval_ms / 1000.0)
            wake.clear()
            try:
                if stop_event.is_set():
                    self._leave()
                    return
                self._cycle(stop_event, wait=False)
                if self._left:
                    return
                self._watch_pending(stop_event)
            except Exception as e:  # the thread's boundary: record, count, stop averaging
                logger.exception("async model average: the averager thread failed")
                self._log_fold_failure("averager thread failed", e)
                return

    def _ensure_thread(self):
        if self._shutdown or self._left:
            return
        if self._thread is None or not self._thread.is_alive():
            # fresh events per thread: a stuck old thread keeps its own (set)
            # stop event and can never be revived
            self._stop_event = threading.Event()
            self._wake = threading.Event()
            self._thread = threading.Thread(target=self._run, args=(self._stop_event, self._wake),
                                            daemon=True, name="bagua-async-averager")
            self._thread.start()

    # -- the engine's host hooks -------------------------------------------------------

    def _log_fold_failure(self, what: str, exc: Exception) -> None:
        self.folds_failed += 1
        logger.warning("async model average: %s (%s: %s); the average was skipped (folds_failed=%d)",
                       what, type(exc).__name__, exc, self.folds_failed)

    def _fold(self, params, delta, done):
        """``params += delta`` in place for the averaged leaves, on the
        training stream (which waits for ``done``: a no-op by now, and the
        ordering the stream needs)."""
        leaves = dict(tree_flatten_with_names(params))
        if any(name not in leaves or leaves[name].shape != d.shape for name, d in delta.items()):
            raise ValueError("the delta does not match the parameters")
        stream = torch.cuda.current_stream(next(iter(leaves.values())).device) if done is not None else None
        if stream is not None:
            stream.wait_event(done)
        with torch.no_grad():
            for name, d in delta.items():
                leaves[name].add_(d)
                if stream is not None:
                    d.record_stream(stream)
        return stream.record_event() if stream is not None else None

    def host_pre_dispatch(self, state):
        """Fold a landed delta into the parameters about to be stepped.
        Reads only the ``_pending_ready`` bool: no device query, no wait."""
        with self._pending_lock:
            if self._pending is None or not self._pending_ready:
                return state
            gen, delta, done = self._pending
            self._pending, self._pending_ready = None, False
            if gen != self._fold_generation:
                # its snapshot predates a fold: applying it would apply that
                # fold's correction twice
                self._orphans.append((gen, delta, done))
                return state
        with self.host_dispatch_lock:
            try:
                event = self._fold(state.params, delta, done)
            except (RuntimeError, ValueError) as e:
                self._log_fold_failure("fold failed", e)
                return state
            with self._pending_lock:
                self._fold_generation += 1
                self._latest, self._latest_event = state.params, event
        self.folds_applied += 1
        return state

    def host_post_dispatch(self, state, step: int) -> None:
        device = self.process_group.device
        event = torch.cuda.current_stream(device).record_event() if device.type == "cuda" else None
        with self._pending_lock:
            self._latest, self._latest_event = state.params, event
            self._published_step = step
        self._ensure_thread()

    # -- control (the reference's abort and resume) ----------------------------------

    def abort(self) -> None:
        """Stop averaging: wait for an average in flight to drain and
        discard it.  After it returns the averager uses the device no more
        until :meth:`resume`."""
        if self._status != "running":
            return
        self._status = "aborted"
        with self._cycle_lock:
            with self._pending_lock:
                if self._pending is not None:
                    self._orphans.append(self._pending)
                self._pending, self._pending_ready = None, False
            self._drain_orphans()

    def resume(self) -> None:
        self._status = "running"

    def host_shutdown(self) -> None:
        """Stop the averager thread for good (end of training).  Across
        processes the thread's last act is the round that stops its peers'
        averagers too (:meth:`_leave`); where no thread ever ran, this call
        runs that round."""
        if self._shutdown:
            return
        self._shutdown = True
        self._stop_event.set()
        if self._thread is not None:
            self._wake.set()
            self._thread.join(timeout=JOIN_TIMEOUT_S)
            if self._thread.is_alive():
                logger.warning("async model average: the averager thread did not stop within %.1f s",
                               JOIN_TIMEOUT_S)
            self._thread = None
        else:
            self._leave()

    # -- the step's stage ------------------------------------------------------------------

    def transform_gradients(self, grads, params, state, ctx: StepContext):
        """Before the optimizer writes the parameters, the training stream
        waits for the last delta that reads them; warmup steps average the
        gradients."""
        if self._unwaited is not None:
            torch.cuda.current_stream(self.process_group.device).wait_event(self._unwaited)
            self._unwaited = None
        if ctx.step < self.warmup_steps:
            grads = ctx.plan.debucketize(
                [allreduce(f, ReduceOp.AVG, self.process_group) for f in ctx.plan.bucketize(grads)], grads)
        return grads, params, state


class AsyncModelAverageAlgorithm(Algorithm):
    def __init__(self, peer_selection_mode: str = "all", sync_interval_ms: int = 500, warmup_steps: int = 0):
        self.peer_selection_mode = peer_selection_mode
        self.sync_interval_ms = sync_interval_ms
        self.warmup_steps = warmup_steps

    def reify(self, process_group) -> AsyncModelAverageAlgorithmImpl:
        return AsyncModelAverageAlgorithmImpl(
            process_group, peer_selection_mode=self.peer_selection_mode,
            sync_interval_ms=self.sync_interval_ms, warmup_steps=self.warmup_steps,
        )
