"""The autotune tier of the port (``bagua_tpu_torch/service/``, copies of the
JAX package's modules, and ``defs.BaguaHyperparameter``, a dataclass in
place of the pydantic model) against the JAX package's, on the same inputs:
the Bayesian optimizer's proposals, the planner's partitions and cost-model
fits on ``tests/test_planner.py``'s fixture, the bytes both HTTP services
answer to the same request sequence, and the port's client against its
server."""

import json
import os
import urllib.request

import numpy as np
import pytest

from bagua_tpu.defs import BaguaHyperparameter as JaxHP, TensorDeclaration as JaxTD
from bagua_tpu.service import autotune_service as jax_service
from bagua_tpu.service import bayesian_optimizer as jax_bo
from bagua_tpu.service import planner as jax_planner
from bagua_tpu.bucket import split_declarations as jax_split

from bagua_tpu_torch.bucket import split_declarations
from bagua_tpu_torch.defs import BaguaHyperparameter, TensorDeclaration
from bagua_tpu_torch.service import bayesian_optimizer as bo
from bagua_tpu_torch.service import planner
from bagua_tpu_torch.service.autotune_client import AutotuneClient
from bagua_tpu_torch.service.autotune_service import AutotuneService, start_autotune_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "ci", "fixtures", "vgg16_bucket_spans.json")


def synthetic_score(bucket_size_bytes: int, hierarchical: bool) -> float:
    """``tests/test_autotune.py``'s score: concave in log2(bucket size), peak
    near 20 MiB, a small bonus for the hierarchical reduction."""
    p = np.log2(bucket_size_bytes)
    return float(100.0 - (p - np.log2(20 * 1024 ** 2)) ** 2 + (1.0 if hierarchical else 0.0))


# -- the hyperparameter record --------------------------------------------------


@pytest.mark.parametrize("kwargs", [
    {},
    {"buckets": [[{"name": "a", "num_elements": 3, "dtype": "f32"}], [{"name": "b", "num_elements": 5, "dtype": "bf16"}]],
     "bucket_size": np.int64(1 << 20), "is_hierarchical_reduce": True, "wire_bf16": False, "overlap": True,
     "predicted_exposed_ms": 1.25},
    {"bucket_size": 4096, "wire_bf16": True, "predicted_exposed_ms": None},
])
def test_hyperparameter_json_is_the_pydantic_models(kwargs):
    """The dataclass dumps what the pydantic model dumps, key for key and in
    order, for the same constructor input; ``from_dict`` and ``update``
    round-trip it."""
    jax_kwargs = dict(kwargs)
    if "bucket_size" in jax_kwargs:
        jax_kwargs["bucket_size"] = int(jax_kwargs["bucket_size"])
    mine, theirs = BaguaHyperparameter(**kwargs), JaxHP(**jax_kwargs)
    assert json.dumps(mine.to_dict()) == json.dumps(theirs.model_dump())
    assert BaguaHyperparameter.from_dict(mine.to_dict()) == mine
    upd = {"bucket_size": 1 << 22, "buckets": [[{"name": "c", "num_elements": 7, "dtype": "f32"}]], "junk": 1}
    assert json.dumps(mine.update(dict(upd)).to_dict()) == json.dumps(theirs.update(dict(upd)).model_dump())


# -- the Bayesian optimizer ------------------------------------------------------


def _drive(mod, seed, warm=None, n=24):
    opt = mod.BayesianOptimizer(
        [mod.IntParam("bucket_size_2p", 10, 31), mod.BoolParam("is_hierarchical_reduce")],
        n_initial_points=5, seed=seed,
    )
    if warm:
        opt.warm_start(warm)
    seen = []
    for _ in range(n):
        p = opt.ask()
        seen.append(dict(p))
        opt.tell(p, synthetic_score(1 << p["bucket_size_2p"], bool(p["is_hierarchical_reduce"])))
    return seen, opt.best()


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("warm", [None, [{"bucket_size_2p": 24, "is_hierarchical_reduce": 1},
                                         {"bucket_size_2p": 12, "is_hierarchical_reduce": 0}]])
def test_bayesian_optimizer_proposals_equal_jax(seed, warm):
    """The seeded walk, the EI phase and the warm start propose the same
    points in the same order, and the best point agrees."""
    assert _drive(bo, seed, warm) == _drive(jax_bo, seed, warm)


# -- the planner -------------------------------------------------------------------


def _fixture(mod_td):
    fx = json.load(open(FIXTURE))
    return fx, [mod_td(**d) for d in fx["declarations"]]


def _cost_model(mod, fx):
    samples = [mod.WireSample(**s) for s in fx["wire_samples"]]
    return mod.CostModel.from_samples(samples), samples


def test_cost_model_fits_equal_jax():
    fx, _ = _fixture(TensorDeclaration)
    mine, _ = _cost_model(planner, fx)
    theirs, _ = _cost_model(jax_planner, fx)
    assert mine.describe() == theirs.describe()
    for n in (1 << 10, 1 << 20, 1 << 26):
        for hier in (False, True):
            assert mine.bucket_wire_time(n, hier) == theirs.bucket_wire_time(n, hier)
        assert mine.ag_time(n) == theirs.ag_time(n)


@pytest.mark.parametrize("cap", [None, 1 << 22])
@pytest.mark.parametrize("hierarchical", [False, True])
def test_planner_partitions_equal_jax(cap, hierarchical):
    """On the committed VGG16 spans: the DP partition, its prediction, the
    greedy seed plan's evaluation and the ranked caps are the JAX
    planner's."""
    def run(mod, td, split):
        fx, ds = _fixture(td)
        cm, samples = _cost_model(mod, fx)
        num = sum(s.hidden_frac * s.seconds for s in samples if s.hidden_frac is not None)
        den = sum(s.seconds for s in samples if s.hidden_frac is not None)
        p = mod.BucketPlanner(ds, fx["arrivals"], cost_model=cm, overlap_efficiency=num / den)
        greedy = [s.declarations() for s in split(ds, {td_.name: (td_.num_elements,) for td_ in ds},
                                                     fx["seed_bucket_size_bytes"])]
        plan = p.plan(max_bucket_bytes=cap, hierarchical=hierarchical)
        ev = p.evaluate(greedy, hierarchical)
        return ([[t.name for t in b] for b in plan.buckets], plan.predicted_exposed_s,
                ev.predicted_exposed_s, p.rank_caps(range(16, 27)))

    assert run(planner, TensorDeclaration, split_declarations) == run(jax_planner, JaxTD, jax_split)


# -- the two services, byte for byte -------------------------------------------------


def _post(port, path, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.read()


@pytest.mark.parametrize("tune", [False, True])
def test_services_answer_the_same_bytes(tune):
    """Both services, built alike (``tests/test_autotune.py``'s settings),
    answer the same register / report / order / ask sequence with the same
    bytes, the proposals included."""
    kw = dict(world_size=1, autotune_level=1, max_samples=6, sampling_confidence_time_s=0.0,
              warmup_time_s=0.0, tune_wire_dtype=tune, tune_overlap=tune)
    servers = [start_autotune_server(AutotuneService(**kw), port=0),
               start_autotune_server(jax_service.AutotuneService(**kw), port=0)]
    decls = [{"name": f"t{i}", "num_elements": 1 << (14 + i % 4), "dtype": "f32"} for i in range(8)]
    seq = [("/api/v1/register_tensors", {"model_name": "m", "tensor_list": decls,
                                         "current_wire_bf16": tune, "current_overlap": False}),
           ("/api/v1/report_tensor_execution_order", {"model_name": "m", "spans": [
               {"action": "tensor_ready", "tensor_name": f"t{i}", "start_time": float(8 - i)} for i in range(8)]})]
    for it in range(8):
        seq.append(("/api/v1/report_metrics", {"model_name": "m", "rank": 0, "train_iter": it,
                                                "speed": 10.0 + it % 3}))
        seq.append(("/api/v1/ask_hyperparameters", {"model_name": "m", "rank": 0, "train_iter": it}))
    try:
        for path, body in seq:
            mine, theirs = (_post(s.server_address[1], path, body) for s in servers)
            assert mine == theirs, (path, mine, theirs)
    finally:
        for s in servers:
            s.shutdown()


def test_client_converges_against_the_ports_server():
    """``tests/test_autotune.py``'s end-to-end case on the port: the client
    registers, reports the synthetic score and asks until the service locks
    near the 20 MiB peak."""
    service = AutotuneService(world_size=1, autotune_level=1, max_samples=30,
                              sampling_confidence_time_s=0.0, warmup_time_s=0.0)
    srv = start_autotune_server(service, port=0)
    try:
        client = AutotuneClient(port=srv.server_address[1])
        assert client.wait_until_ready(5.0)
        hp = client.register_tensors("mock", [TensorDeclaration(f"t{i}", 1 << 18, "f32") for i in range(6)])
        assert hp.buckets and isinstance(hp.buckets[0][0], TensorDeclaration)
        completed = False
        for it in range(35):
            client.report_metrics("mock", 0, it, synthetic_score(hp.bucket_size, hp.is_hierarchical_reduce))
            hp, completed = client.ask_hyperparameters("mock", 0, it)
            if completed:
                break
        assert completed
        assert abs(np.log2(hp.bucket_size) - 24.32) <= 2.5
    finally:
        srv.shutdown()
