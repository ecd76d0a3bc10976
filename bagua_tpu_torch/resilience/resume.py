"""Elastic resume: agree on the newest complete snapshot, load it into the
(possibly resized) gang, carry the bucket plan over (the port of
``bagua_tpu/resilience/resume.py``; the commit is a rewrite for torch
state).

After a preemption or a crash the gang re-forms, maybe smaller, maybe
larger, and every rank must (1) pick the same snapshot, (2) remap the
rank-stacked state to the new world size
(:func:`bagua_tpu_torch.checkpoint.remap_world_size`, or under a sharded
update :meth:`~bagua_tpu_torch.ddp.DistributedDataParallel.reshard_host_state`)
and (3) keep the autotune investment: the bucket plan the tuner had
converged on rides in the snapshot's manifest and is adopted again here.

Snapshot choice: the local scan (``SnapshotStore.latest_complete``) is
authoritative on a shared filesystem.  When a rendezvous store is given
and the job spans processes (``WORLD_SIZE``), ranks also publish their
local view and take the minimum, so that a rank whose filesystem view lags
is not resumed past what it can read.  Store outages fall back to the
local scan (retry and breaker from :mod:`bagua_tpu_torch.resilience.retry`).
"""

import json
import logging
import time
from typing import Any, Dict, Optional

import numpy as np

from bagua_tpu_torch.env import get_rank, get_world_size
from bagua_tpu_torch.resilience.retry import CircuitBreaker, RetryPolicy, retry_call
from bagua_tpu_torch.resilience.snapshot import SnapshotStore

logger = logging.getLogger(__name__)

__all__ = ["ElasticResumeCoordinator", "ResumeResult"]


class ResumeResult:
    """What a resume did: the loaded state and its provenance."""

    def __init__(self, state, step: int, old_world_size: int, new_world_size: int, plan_source: str,
                 wall_ms: float = 0.0):
        self.state = state
        self.step = step
        self.old_world_size = old_world_size
        self.new_world_size = new_world_size
        #: ``"carried"`` when the manifest's bucket plan was adopted again,
        #: ``"autopilot"`` when that carried configuration was
        #: autopilot-chosen, ``"fresh"`` when the engine kept its own plan
        self.plan_source = plan_source
        #: the resume's wall time: the agreement, the load, the commit
        self.wall_ms = wall_ms


class ElasticResumeCoordinator:
    """One resume attempt for one engine.

    Args:
        store: the :class:`SnapshotStore` (or its directory) the
            snapshotter wrote into.
        rendezvous_client: an optional
            :class:`~bagua_tpu_torch.distributed.rendezvous.RendezvousClient`
            for the cross-rank snapshot agreement (multi-process jobs only).
        expert_filter: passed to ``remap_world_size`` (MoE leaves).
        telemetry: an optional hub; a successful resume emits ``on_restart``.
        fleet_plan_fn: an optional zero-argument callable returning a plan
            payload from a cross-gang cache (or None on a miss), consulted
            by :meth:`fleet_warm_start` when there is no snapshot.
        fleet_directive_fn: an optional zero-argument callable returning the
            gang's oldest pending remediation directive (or None), consulted
            by :meth:`directed_world_size`.
    """

    def __init__(self, store, rendezvous_client=None, expert_filter=None, telemetry=None,
                 agreement_timeout_s: float = 30.0, fleet_plan_fn=None, fleet_directive_fn=None):
        self.store = store if isinstance(store, SnapshotStore) else SnapshotStore(store)
        self.rendezvous_client = rendezvous_client
        self.expert_filter = expert_filter
        self.telemetry = telemetry
        self.agreement_timeout_s = agreement_timeout_s
        self.fleet_plan_fn = fleet_plan_fn
        self.fleet_directive_fn = fleet_directive_fn

    # -- snapshot agreement --------------------------------------------------

    def agreed_resume_step(self, nonce: str = "0") -> Optional[int]:
        """The step every rank resumes from (None: a cold start).

        ``nonce`` names the agreement round in the rendezvous KV (the
        launcher's attempt counter), so a second restart never reads the
        first one's views.  The process count and index are the live
        gang's (a group that spans processes), else the environment's
        ``WORLD_SIZE`` and ``RANK``: each process publishes its newest
        complete snapshot and every process takes the smallest."""
        local = self.store.latest_complete()
        client = self.rendezvous_client
        nprocs = get_world_size()
        if client is None or nprocs <= 1:
            return local
        policy = RetryPolicy()
        breaker = CircuitBreaker(name="rendezvous-kv")
        rank = get_rank()
        try:
            retry_call(client.kv_set, f"resilience/resume/{nonce}/rank{rank}", json.dumps(local),
                       policy=policy, breaker=breaker)
            deadline = time.monotonic() + self.agreement_timeout_s
            views: Dict[int, Optional[int]] = {}
            while time.monotonic() < deadline and len(views) < nprocs:
                for r in range(nprocs):
                    if r in views:
                        continue
                    raw = retry_call(client.kv_get, f"resilience/resume/{nonce}/rank{r}",
                                     policy=policy, breaker=breaker)
                    if raw is not None:
                        views[r] = json.loads(raw)
                if len(views) < nprocs:
                    time.sleep(0.1)
            if len(views) < nprocs:
                logger.warning("snapshot agreement timed out (%d/%d views); using local scan",
                               len(views), nprocs)
                return local
            if any(v is None for v in views.values()):
                return None  # some rank sees no snapshot: cold start everywhere
            agreed = min(views.values())
            if agreed != local:
                logger.info("snapshot agreement chose step %s (local view was %s)", agreed, local)
            return agreed
        except (OSError, ConnectionError) as e:
            logger.warning("rendezvous store unreachable for agreement (%s); using local scan", e)
            return local

    # -- the resume ----------------------------------------------------------

    def resume(self, ddp, init_state, nonce: str = "0") -> Optional[ResumeResult]:
        """Load the agreed snapshot into ``ddp``'s gang.

        ``init_state`` is the state ``ddp.init(...)`` just built: its
        parameter tensors receive the snapshot's values.  Returns None when
        there is nothing to resume.  The commit moves the host arrays onto
        the group's device at the engine's dtypes, loads the optimizer
        through ``load_state_dict``, replaces the algorithm's state and sets
        the engine's step."""
        from bagua_tpu_torch.checkpoint.checkpointing import remap_leaf
        from bagua_tpu_torch.ddp import load_state_leaves
        from bagua_tpu_torch.parallel.moe.utils import is_moe_param_path

        t0 = time.perf_counter()
        step = self.agreed_resume_step(nonce=nonce)
        if step is None:
            return None
        manifest, arrays = self.store.load_stacked(step)
        keys = manifest.get("leaf_keys") or []
        if len(keys) != len(arrays):
            raise ValueError(f"snapshot step {step} holds {len(arrays)} leaves but names "
                             f"{len(keys)} leaf keys")
        leaves = dict(zip(keys, arrays))
        dtypes = dict(zip(keys, manifest.get("leaf_dtypes") or []))
        old_world = int(manifest["world_size"])
        new_world = ddp.group.size
        # Adopt the carried plan BEFORE reading the leaves: under a sharded
        # update the state's structure (the rows, the pending shards)
        # depends on the plan.
        plan_payload = manifest.get("plan")
        plan_source = "carried" if self._adopt_plan(ddp, plan_payload) else "fresh"
        if plan_source == "carried" and (plan_payload.get("config") or {}).get("source") == "autopilot":
            plan_source = "autopilot"
        # the adoption went through rebucket, which queues a migration of
        # the live state; the snapshot was taken in the carried layout
        ddp.clear_pending_reshard()
        if old_world != new_world:
            logger.info("remapping snapshot step %d from world size %d to %d", step, old_world, new_world)
            if plan_payload and plan_payload.get("shard") and ddp._sharded_updater is not None:
                leaves, dtypes = ddp.reshard_host_state(leaves, plan_payload, old_world, dtypes)
            else:
                flt = self.expert_filter or is_moe_param_path
                leaves = {k: remap_leaf(k, a, new_world, flt) for k, a in leaves.items()}
        rows = ddp.group.local_rows
        if len(rows) != new_world:
            # a group that spans processes: this process loads its own ranks' rows
            leaves = {k: a[rows.start:rows.stop] if np.ndim(a) and np.shape(a)[0] == new_world else a
                      for k, a in leaves.items()}
        state = load_state_leaves(ddp.state_template(init_state), leaves, dtypes)
        ddp._host_step = state.step
        # Lost work: the drained exit's marker records the step the previous
        # incarnation reached; without one (a hard kill) it is unknown but
        # bounded by the snapshot cadence.
        from bagua_tpu_torch.resilience.preemption import clear_resumable_marker, read_resumable_marker

        marker = read_resumable_marker(self.store.directory)
        lost = max(0, int(marker["step"]) - step) if marker else 0
        clear_resumable_marker(self.store.directory)
        if self.telemetry is not None:
            self.telemetry.on_restart(step=step, old_world_size=old_world, new_world_size=new_world,
                                      plan_source=plan_source, lost_steps=lost)
        logger.info("resumed at step %d (world %d -> %d, plan %s)", step, old_world, new_world, plan_source)
        return ResumeResult(state, step, old_world, new_world, plan_source,
                            wall_ms=(time.perf_counter() - t0) * 1e3)

    def fleet_warm_start(self, ddp) -> Optional[str]:
        """Step-0 plan adoption from a cross-gang cache, the cold-start
        counterpart of :meth:`resume`'s manifest carry-over: call it when
        :meth:`resume` returned None.  Returns ``"fleet"`` when the engine
        adopted the payload ``fleet_plan_fn`` gave (and emits the
        ``restart`` event at step 0), else None.  Advisory: every failure
        returns None and the gang keeps its fresh plan."""
        if self.fleet_plan_fn is None:
            return None
        try:
            payload = self.fleet_plan_fn()
        except Exception as e:
            logger.warning("fleet plan lookup failed (advisory): %s", e)
            return None
        if not payload or not self._adopt_plan(ddp, payload):
            return None
        ddp.clear_pending_reshard()  # nothing to migrate: no live state yet
        logger.info("cold start adopted a fleet-cached plan (plan_source=fleet)")
        if self.telemetry is not None:
            self.telemetry.on_restart(step=0, old_world_size=ddp.group.size, new_world_size=ddp.group.size,
                                      plan_source="fleet", lost_steps=0)
        return "fleet"

    # -- fleet remediation directives -----------------------------------------

    def fleet_directive(self) -> Optional[Dict[str, Any]]:
        """The gang's oldest pending remediation directive, or None.
        Advisory: an unreachable fleet never blocks a restart."""
        if self.fleet_directive_fn is None:
            return None
        try:
            directive = self.fleet_directive_fn()
        except Exception as e:
            logger.warning("fleet directive poll failed (advisory): %s", e)
            return None
        return directive if isinstance(directive, dict) else None

    def directed_world_size(self, default: int) -> int:
        """The world size the re-forming gang should target: a pending
        ``resize`` directive's ``to_world_size``, else ``default``."""
        directive = self.fleet_directive()
        if not directive or directive.get("action") != "resize":
            return int(default)
        to_world = (directive.get("detail") or {}).get("to_world_size")
        if isinstance(to_world, int) and to_world >= 1:
            logger.warning("fleet resize directive #%s (%s): targeting world size %d instead of %d",
                           directive.get("id"), directive.get("reason"), to_world, int(default))
            return to_world
        return int(default)

    def _adopt_plan(self, ddp, payload: Optional[Dict[str, Any]]) -> bool:
        """Adopt the snapshot's bucket plan again.  Best effort: a payload
        that no longer fits the model keeps the engine's fresh plan."""
        if not payload:
            return False
        try:
            return bool(ddp.adopt_plan_payload(payload))
        except Exception as e:
            logger.warning("could not carry bucket plan over (%s); keeping the fresh plan", e)
            return False
