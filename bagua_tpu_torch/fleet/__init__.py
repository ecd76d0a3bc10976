"""Fleet control plane: one multi-tenant, crash-safe rendezvous + autotune
service for N concurrent gangs.

* :mod:`bagua_tpu_torch.fleet.control_plane` — per-gang namespaces, leases +
  admission control, the cross-gang plan cache (with its durable
  quarantine/canary lifecycle), the scheduler view.
* :mod:`bagua_tpu_torch.fleet.remediation` — the verdict-driven
  :class:`RemediationEngine`: plan quarantine + fleet-wide rollback,
  wedged-gang hang diagnosis + directed resize, canary graduation.
* :mod:`bagua_tpu_torch.fleet.shards` — consistent-hash sharding
  (:class:`ShardedControlPlane`): per-shard WALs cut along gang
  namespaces, ``/fleet/*`` reads fan out and merge.
* :mod:`bagua_tpu_torch.fleet.wal` — the write-ahead log + snapshot compaction
  behind crash-safe restarts.
* :mod:`bagua_tpu_torch.fleet.server` — the HTTP front-end
  (``python -m bagua_tpu_torch.fleet.server``): thread-per-request or the
  selector-based async I/O loop (:func:`start_async_fleet_server`).
* :mod:`bagua_tpu_torch.fleet.client` — :class:`FleetClient`, per-gang client
  factories, and the step-0 cross-gang plan warm start.
"""

from bagua_tpu_torch.fleet.control_plane import (
    FleetControlPlane,
    GangNamespace,
    TokenBucket,
    plan_cache_key,
)
from bagua_tpu_torch.fleet.client import (
    FleetClient,
    adopt_fleet_plan,
    engine_plan_key,
    gang_endpoint,
    model_fingerprint,
    publish_engine_plan,
)
from bagua_tpu_torch.fleet.remediation import RemediationEngine
from bagua_tpu_torch.fleet.server import (
    AsyncFleetServer,
    FleetHandler,
    start_async_fleet_server,
    start_fleet_server,
)
from bagua_tpu_torch.fleet.shards import HashRing, ShardedControlPlane
from bagua_tpu_torch.fleet.wal import WriteAheadLog

__all__ = [
    "FleetControlPlane",
    "GangNamespace",
    "TokenBucket",
    "plan_cache_key",
    "FleetClient",
    "adopt_fleet_plan",
    "engine_plan_key",
    "gang_endpoint",
    "model_fingerprint",
    "publish_engine_plan",
    "RemediationEngine",
    "HashRing",
    "ShardedControlPlane",
    "FleetHandler",
    "start_fleet_server",
    "AsyncFleetServer",
    "start_async_fleet_server",
    "WriteAheadLog",
]
