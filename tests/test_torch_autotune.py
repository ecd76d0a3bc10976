"""The port's ``AutotuneSession`` (``bagua_tpu_torch/ddp.py``) against a live
autotune service and against the JAX package's session.

The session re-buckets a live engine, and a step after the re-bucket is
bitwise the step of an engine built on that plan (the JAX case is
``test_midtrain_planner_rebucket_bitwise_parity``); the flight recorder
captures the new plan's program instead of replaying the old one.  The
``wire_dtype``, ``overlap`` and hierarchical knobs follow the JAX session's
tri-state rules (``tests/test_autotune.py``): the same proposals applied to
both sessions leave both engines in the same configuration.
"""

import copy
import logging
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bagua_tpu.algorithms import build_algorithm as jax_build
from bagua_tpu.ddp import AutotuneSession as JaxSession
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP
from bagua_tpu.defs import BaguaHyperparameter as JaxHP
from bagua_tpu.models import mlp as jax_mlp

from bagua_tpu_torch.algorithms import build_algorithm
from bagua_tpu_torch.bucket import BucketPlan
from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.ddp import AutotuneSession, DistributedDataParallel
from bagua_tpu_torch.defs import BaguaHyperparameter
from bagua_tpu_torch.models import mlp
from bagua_tpu_torch.observability.telemetry import Telemetry
from bagua_tpu_torch.service.autotune_client import AutotuneClient
from bagua_tpu_torch.service.autotune_service import AutotuneService, start_autotune_server
from bagua_tpu_torch.utils import tree_leaves

SIZES = [16, 64, 64, 4]


@pytest.fixture()
def tgroup():
    return BaguaProcessGroup([torch.device("cpu")] * 8, intra_size=4)


@pytest.fixture()
def service():
    made = []

    def start(**kw):
        svc = AutotuneService(world_size=1, autotune_level=1, sampling_confidence_time_s=0.0, warmup_time_s=0.0,
                              **{"max_samples": 30, **kw})
        srv = start_autotune_server(svc, port=0)
        made.append(srv)
        return svc, AutotuneClient(port=srv.server_address[1])

    yield start
    for srv in made:
        srv.shutdown()


def params():
    return mlp.init_mlp(torch.Generator().manual_seed(0), SIZES, device="cpu")


def engine(group, algo="gradient_allreduce", bucket=1 << 10, **kw):
    return DistributedDataParallel(mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.05), build_algorithm(algo, **kw),
                                   group, bucket_size_bytes=bucket, overlap=True)


def batches(n, seed):
    rng = np.random.RandomState(seed)
    return [(torch.from_numpy(rng.randn(16, SIZES[0]).astype(np.float32)),
             torch.from_numpy(rng.randn(16, SIZES[-1]).astype(np.float32))) for _ in range(n)]


def test_session_rebuckets_a_live_engine_bitwise(tgroup, service):
    """Engine A trains with a session (interval 2) until the service's
    proposal re-buckets it, then 3 more steps; engine B, built fresh on A's
    new plan, takes the same 3 steps from A's state at the re-bucket: the
    parameters are bitwise equal.  A's flight recorder captures the new
    plan's program (its records carry the new plan version, one exchange
    record per new bucket)."""
    _, client = service(max_samples=5)
    tel = Telemetry(flight="auto")
    ddp_a = DistributedDataParallel(mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.05),
                                    build_algorithm("gradient_allreduce"), tgroup, bucket_size_bytes=1 << 10,
                                    overlap=True, telemetry=tel)
    state = ddp_a.init(params())
    session = AutotuneSession(ddp_a, "ddp_model", client=client, interval=2)
    n0 = ddp_a.plan.num_buckets
    saved = None
    for x, y in batches(8, seed=1):
        state, _ = ddp_a.train_step(state, (x, y))
        session.tick(16)
        if ddp_a.plan_version:
            saved = copy.deepcopy(state)
            break
    assert saved is not None and ddp_a.plan.num_buckets != n0, "the session never re-bucketed"
    tail = batches(3, seed=2)
    state_a = state
    for batch in tail:
        state_a, _ = ddp_a.train_step(state_a, batch)
    last = [r for r in tel.flight.records() if r["step"] == state_a.step - 1 and r["phase"] != "hop"]
    assert {r["plan_version"] for r in last} == {ddp_a.plan_version}
    assert sorted(r["bucket"] for r in last) == list(range(ddp_a.plan.num_buckets))
    tel.close()

    ddp_b = engine(tgroup)
    ddp_b.init(params())
    ddp_b.rebucket(BucketPlan.from_declarations(ddp_a.plan.declarations(), ddp_b._tree_template,
                                                align_elems=tgroup.size))
    state_b = saved
    for batch in tail:
        state_b, _ = ddp_b.train_step(state_b, batch)
    for pa, pb in zip(tree_leaves(state_a.params), tree_leaves(state_b.params)):
        assert torch.equal(pa, pb)


class _Client:
    """A stand-in service client: the sessions register with it and nothing
    else (the proposals are applied directly)."""

    def register_tensors(self, *a, **k):
        return None


def _jax_engine(group, algo, **kw):
    ddp = JaxDDP(jax_mlp.mse_loss, optax.sgd(0.05), jax_build(algo, **kw), process_group=group,
                 bucket_size_bytes=1 << 10, overlap=True)
    ddp.init(jax_mlp.init_mlp(jax.random.PRNGKey(0), SIZES))
    return ddp


def _config(ddp, bf16):
    wire = getattr(ddp.impl, "wire_dtype", "none")
    return (bool(ddp.impl.hierarchical), ddp.overlap, ddp.overlap_enabled,
            "none" if wire == "none" else (wire is not None and wire == bf16))


#: (algorithm, its arguments, proposals applied in turn): each proposal is
#: BaguaHyperparameter keywords (tri-state wire_bf16 / overlap)
KNOB_CASES = {
    "untuned keeps the user's bf16 wire": ("gradient_allreduce", {"wire_dtype": "bf16"},
                                           [{"wire_bf16": None}, {"wire_bf16": None, "overlap": None}]),
    "tuned wire dtype": ("gradient_allreduce", {}, [{"wire_bf16": True}, {"wire_bf16": False}, {"wire_bf16": None}]),
    "overlap knob": ("gradient_allreduce", {}, [{"overlap": False}, {"overlap": None}, {"overlap": True}]),
    "hierarchical": ("gradient_allreduce", {}, [{"is_hierarchical_reduce": True}, {"is_hierarchical_reduce": False}]),
    "bytegrad has no wire dtype": ("bytegrad", {}, [{"wire_bf16": True, "overlap": False}]),
    "weight mode ignores overlap": ("decentralized", {}, [{"overlap": False}, {"is_hierarchical_reduce": False}]),
}


@pytest.mark.parametrize("case", list(KNOB_CASES))
def test_knobs_follow_the_jax_tri_state_rules(group, tgroup, case):
    """The same proposals (no buckets: the plan stays) through both
    sessions' ``_apply`` give the same hierarchical flag, overlap knob and
    wire dtype; every change resets the port's per-variant state (the next
    step is a recompile miss with a fresh flight program)."""
    algo, kw, proposals = KNOB_CASES[case]
    jkw = {"wire_dtype": jnp.bfloat16} if kw.get("wire_dtype") == "bf16" else dict(kw)
    tkw = {"wire_dtype": torch.bfloat16} if kw.get("wire_dtype") == "bf16" else dict(kw)
    jddp, tddp = _jax_engine(group, algo, **jkw), engine(tgroup, algo, **tkw)
    tddp.init(params())
    jsess = JaxSession(jddp, "m", client=_Client())
    tsess = AutotuneSession(tddp, "m", client=_Client())
    for hp in proposals:
        hp = {"is_hierarchical_reduce": bool(tddp.impl.hierarchical), **hp}
        tddp._variants_seen.add("seen")
        before = _config(tddp, torch.bfloat16)
        jsess._apply(JaxHP(**hp))
        tsess._apply(BaguaHyperparameter(**hp))
        after = _config(tddp, torch.bfloat16)
        assert after == _config(jddp, jnp.dtype(jnp.bfloat16)), hp
        assert ("seen" in tddp._variants_seen) == (after[0] == before[0] and after[2:] == before[2:]), hp
    jddp.shutdown()
    tddp.shutdown()


def test_session_applies_the_services_wire_dtype(tgroup, service):
    """A ``tune_wire_dtype`` service's bf16 proposal reaches the engine's
    wire dtype, and the step stays finite; an untuned service never
    touches a user-configured one."""
    _, client = service(max_samples=40, tune_wire_dtype=True)
    ddp = engine(tgroup)
    state = ddp.init(params())
    session = AutotuneSession(ddp, "wire", client=client, interval=1)
    for x, y in batches(25, seed=0):
        state, losses = ddp.train_step(state, (x, y))
        assert torch.isfinite(losses).all()
        session.tick(16)
        if ddp.impl.wire_dtype is not None:
            break
    assert ddp.impl.wire_dtype == torch.bfloat16
    state, losses = ddp.train_step(state, batches(1, seed=5)[0])
    assert torch.isfinite(losses).all()

    _, client = service(max_samples=3)
    ddp = engine(tgroup, wire_dtype=torch.bfloat16)
    state = ddp.init(params())
    session = AutotuneSession(ddp, "keep", client=client, interval=1)
    for x, y in batches(6, seed=0):
        state, _ = ddp.train_step(state, (x, y))
        session.tick(16)
        assert ddp.impl.wire_dtype == torch.bfloat16


def test_unreachable_service_degrades_and_the_trainer_logs_it(tgroup, caplog, monkeypatch):
    """A session whose service stops answering keeps training on its
    hyperparameters and logs it; the breaker opens after the threshold and
    the tick is then a fast no-op.  A ``Trainer`` whose service cannot be
    reached at all trains without tuning and logs a warning."""
    from bagua_tpu_torch.trainer import Trainer

    class Down(_Client):
        calls = 0

        def report_metrics(self, *a):
            Down.calls += 1
            raise ConnectionError("down")

    ddp = engine(tgroup)
    ddp.init(params())
    session = AutotuneSession(ddp, "m", client=Down(), interval=1)
    session._breaker.failure_threshold = 2
    with caplog.at_level(logging.WARNING, logger="bagua_tpu_torch.ddp"):
        for _ in range(4):
            session.tick(16)
    assert Down.calls == 2 and "unreachable" in caplog.text

    # the service the environment names: a localhost port nothing listens on
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    monkeypatch.setenv("AUTO_TUNE_SERVER_ADDR", f"127.0.0.1:{port}")
    monkeypatch.setenv("BAGUA_RPC_RETRIES", "0")
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="bagua_tpu_torch.trainer"):
        tr = Trainer(mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.05), build_algorithm("gradient_allreduce"),
                     tgroup, autotune_model_name="m")
        tr.init_state(params())
    assert tr._session is None and "autotune disabled" in caplog.text
    tr.close()


def test_session_restarts_the_speed_meter_on_a_change(tgroup):
    """Each speed the session reports is its configuration's own: a
    proposal that re-buckets the engine, or turns a knob, restarts the
    engine's speed meter; a proposal that changes nothing keeps it."""
    ddp = engine(tgroup)
    ddp.init(params())
    session = AutotuneSession(ddp, "m", client=_Client())
    one_bucket = [[td for bucket in ddp.plan.declarations() for td in bucket]]
    assert ddp.plan.num_buckets > 1
    for hp, restarts in ((BaguaHyperparameter(buckets=one_bucket), True),
                         (BaguaHyperparameter(buckets=one_bucket), False),
                         (BaguaHyperparameter(buckets=one_bucket, overlap=False), True)):
        ddp.record_speed(16)
        session._apply(hp)
        assert (ddp.speed_meter.speed() == 0.0) == restarts, hp
    assert ddp.plan.num_buckets == 1 and not ddp.overlap_enabled
    ddp.shutdown()
