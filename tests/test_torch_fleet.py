"""The port's fleet control plane (``bagua_tpu_torch/fleet/``) against the
JAX package's, case by case.

``bagua_tpu_torch/fleet/`` is a copy of the JAX package's stdlib-only
``fleet/`` over the port's rendezvous store, observability, retry layer
and autotune service, so the contract is equality.  Every case of
``tests/test_fleet.py`` runs twice (``twin_cases``): as written, over the
JAX package, and with its imports (and the module that the SIGKILL case
starts with ``python -m``) pointed at the port.  The two engine cases
build the port's engine there: the same MLP [12, 16, 16, 4] from flax's
init, ``gradient_allreduce`` with SGD 0.1 on the port's 8-rank CPU group.

The cross-package cases are exact: the plan-cache key, the shard map and
the engine's plan key equal JAX's for the same model; a plan the JAX
engine exports is adopted by the port's engine with JAX's bucket names;
a WAL the JAX plane wrote replays in the port's plane to JAX's replayed
``dump()``, compared whole (the dump's only times are the records' own,
which both replays copy, so no field is left out).  The staleness bound
survives a plan payload as in JAX (the repair of the port's payload).
The card's arm is ``chip_smoke.py``'s ``[fleet]`` phase and
``tests/test_torch_fleet_cuda.py``.
"""

import json
import pathlib

import jax
import numpy as np
import optax
import pytest
import torch

from twin_cases import Twin, port_group

from bagua_tpu.algorithms.gradient_allreduce import GradientAllReduceAlgorithm as JaxGAR
from bagua_tpu.algorithms.stale import StaleSyncAlgorithm as JaxStale
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP
from bagua_tpu.fleet import FleetControlPlane as JaxPlane
from bagua_tpu.fleet import HashRing as JaxHashRing
from bagua_tpu.fleet import RemediationEngine as JaxRemediation
from bagua_tpu.fleet import engine_plan_key as jax_engine_plan_key
from bagua_tpu.fleet import plan_cache_key as jax_plan_cache_key
from bagua_tpu.models import mlp as jax_mlp

from bagua_tpu_torch.algorithms import GradientAllReduceAlgorithm, StaleSyncAlgorithm
from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.fleet import FleetControlPlane, HashRing, engine_plan_key, plan_cache_key
from bagua_tpu_torch.models import mlp

LAYERS = [12, 16, 16, 4]
RDZV_FAST = {"min_nodes": 1, "settle_s": 0.05}


def mlp_params():
    return jax_mlp.init_mlp(jax.random.PRNGKey(0), LAYERS)


def port_make_engine(group, bucket_size):
    """``test_fleet.make_engine`` on the port: the same MLP and plan knobs."""
    ddp = DistributedDataParallel(
        mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.1), GradientAllReduceAlgorithm(), group,
        bucket_size_bytes=bucket_size, overlap=False,
    )
    ddp.init(params_from_jax(jax.tree.map(np.asarray, mlp_params())))
    return ddp


FLEET = Twin(
    "test_fleet",
    replace=(('"bagua_tpu.fleet.server"', '"bagua_tpu_torch.fleet.server"'),),
    port_globals={"make_engine": port_make_engine},
)


def test_the_port_runs_its_own_fleet():
    from bagua_tpu_torch import fleet
    import bagua_tpu.fleet as jax_fleet

    ns = FLEET.ns["bagua_tpu_torch"]
    assert ns["FleetControlPlane"] is fleet.FleetControlPlane
    assert ns["RendezvousClient"].__module__ == "bagua_tpu_torch.distributed.rendezvous"
    assert fleet.__all__ == jax_fleet.__all__
    assert len(FLEET.cases) == 30


@pytest.mark.parametrize("pkg, case", FLEET.params())
def test_fleet_case(pkg, case, request):
    FLEET.run(pkg, case, request)


# ---------------- cross-package equality ------------------------------------


def test_plan_cache_key_and_shard_map_equal_jax():
    dims = [("fp", "ranks4", "GradientAllReduceAlgorithm", "f32"), ("a/b", "cpu:8", "x y", "int8"),
            ("ключ", "r?=&", "", "auto")]
    for d in dims:
        assert plan_cache_key(*d) == jax_plan_cache_key(*d)
    for n in (1, 3, 8):
        ours, theirs = HashRing(n), JaxHashRing(n)
        keys = [f"gang-{i}" for i in range(200)] + ["team-a/run1", "", "ключ"]
        assert [ours.shard_for(k) for k in keys] == [theirs.shard_for(k) for k in keys]


def _jax_engine(group, bucket_size, algo=None, params=None):
    ddp = JaxDDP(jax_mlp.mse_loss, optax.sgd(0.1), algo or JaxGAR(), process_group=group,
                 bucket_size_bytes=bucket_size, overlap=False)
    ddp.init(params if params is not None else mlp_params())
    return ddp


def _names(ddp):
    return [[td.name for td in b] for b in ddp.plan.declarations()]


def test_engine_plan_key_and_adopted_plan_equal_jax(group):
    tgroup = port_group()
    for bucket in (1 << 9, 1 << 20):
        jddp, tddp = _jax_engine(group, bucket), port_make_engine(tgroup, bucket)
        try:
            assert engine_plan_key(tddp) == jax_engine_plan_key(jddp)
            assert _names(tddp) == _names(jddp)
        finally:
            jddp.shutdown()
            tddp.shutdown()
    jddp, tddp = _jax_engine(group, 1 << 9), port_make_engine(tgroup, 1 << 20)
    try:
        payload = json.loads(json.dumps(jddp.export_plan_payload()))
        assert _names(tddp) != _names(jddp)
        assert tddp.adopt_plan_payload(payload) is True
        assert _names(tddp) == _names(jddp)
        assert tddp.export_plan_payload()["buckets"] == payload["buckets"]
    finally:
        jddp.shutdown()
        tddp.shutdown()


def _jax_stale(group, tau):
    return _jax_engine(group, 1 << 62, algo=JaxStale(staleness_tau=tau))


def _port_stale(tau):
    ddp = DistributedDataParallel(mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.1),
                                  StaleSyncAlgorithm(staleness_tau=tau), port_group(),
                                  bucket_size_bytes=1 << 62, overlap=False)
    ddp.init(params_from_jax(jax.tree.map(np.asarray, mlp_params())))
    return ddp


def test_plan_payload_carries_the_staleness_bound(group):
    """A ``stale`` engine re-bounded to τ 3 exports the configuration JAX's
    exports, and a fresh τ 2 engine that adopts it runs τ 3, as JAX's does."""
    jddp, tddp = _jax_stale(group, 2), _port_stale(2)
    try:
        assert jddp.apply_staleness(3, reason="manual") and tddp.apply_staleness(3, reason="manual")
        want, got = jddp.export_plan_payload(), tddp.export_plan_payload()
        assert want["config"]["staleness_tau"] == 3
        assert got["config"] == want["config"]
        fresh_j, fresh_t = _jax_stale(group, 2), _port_stale(2)
        try:
            assert fresh_j.adopt_plan_payload(want) and fresh_t.adopt_plan_payload(got)
            assert fresh_j.impl.staleness_tau == 3 and fresh_t.impl.staleness_tau == 3
            assert fresh_t.export_plan_payload()["config"] == fresh_j.export_plan_payload()["config"]
        finally:
            fresh_j.shutdown()
            fresh_t.shutdown()
    finally:
        jddp.shutdown()
        tddp.shutdown()


def _canon(dump):
    return json.dumps(dump, sort_keys=True)


def test_port_replays_a_wal_the_jax_plane_wrote(tmp_path):
    """The JAX plane journals gangs, KV, blobs, a settled rendezvous, plans,
    a quarantine with its rollback directives and an ack; the port's plane
    replays that WAL to the dump JAX's own replay reaches, and serves it."""
    jns = FLEET.ns["bagua_tpu"]
    wal_dir = str(tmp_path / "wal")
    plane = JaxPlane(wal_dir=wal_dir, rdzv_kwargs=RDZV_FAST)
    jns["_populate"](plane)
    dims = jns["PLAN_DIMS"]
    bad = plane.plan_put("bad", plan={"buckets": [["w"]]}, meta={"plan_version": 2}, **dims)
    for gang in ("b0", "b1"):
        assert plane.plan_get("bad", gang=gang, **dims) is not None
        jns["_push_summary"](plane, gang, 0, 10.0)
        plane.ingest_incidents(gang, [{"step": 5, "dominant": "wire_slowdown", "stream": "step_wall",
                                       "plan_version": 2, "trace_id": f"t-{gang}"}])
    assert JaxRemediation(plane).sweep()["quarantined"] == [bad]
    assert plane.ack_directive("b0", plane.directive("b0")["id"])

    want = JaxPlane(wal_dir=wal_dir, rdzv_kwargs=RDZV_FAST).dump()
    assert _canon(want) == _canon(plane.dump())
    ours = FleetControlPlane(wal_dir=wal_dir, rdzv_kwargs=RDZV_FAST)
    assert _canon(ours.dump()) == _canon(want)
    assert ours.plan_statuses()[bad]["status"] == "quarantined"
    assert ours.plan_get("bad", gang="b9", **dims) is None
    assert ours.directive("b0") is None and ours.directive("b1")["action"] == "rollback_plan"
    assert ours.gang("alpha").rendezvous.kv_get("ck/3") == 3
    assert ours.gang("alpha").rendezvous.blob_get("weights") == b"\x00\x01" * 64


def test_fleet_modules_import_no_torch():
    """``python -m bagua_tpu_torch.fleet.server`` pays the package's
    ``import torch`` (``bagua_tpu_torch/__init__.py``); the fleet modules
    themselves import neither torch nor JAX, as JAX's ``fleet/`` is
    stdlib-only."""
    root = pathlib.Path(__file__).resolve().parent.parent / "bagua_tpu_torch" / "fleet"
    for f in sorted(root.glob("*.py")):
        src = f.read_text()
        assert "import torch" not in src and "import jax" not in src, f
