"""The port's CPU lanes that need no timing (``bagua_tpu_torch/tools/``:
``static_verify``, ``bench_modeled``) against the JAX package's own lanes
(``ci/static_verify.py``, ``ci/bench_modeled.py``), and the three small
public functions (``models.mlp.softmax_loss``, ``env.set_bagua_service_port``,
``env.is_report_metrics_switch_on``) against the JAX package's.

Each test runs the reference lane as CI does (``python ci/<lane>.py``, on
the 8-device CPU simulation, its artifact written under ``tmp_path``) beside
the port's tool on ``--device cpu`` (8 CPU ranks, the JAX lane's 2 x 4
layout).  Where both describe the same program the cells must agree
exactly: status, collective count, flight records and the wire table (the
overlap mode's rows as a multiset: the JAX trace lists buckets in another
order than the port's ``backward_order()``), and the modeled bench's wire
bytes.  QAdam's cells do not describe the same program: the JAX step
traces both arms of its warm-up ``lax.cond`` (a flat f32 all-reduce and the
compressed momentum exchange, 36 collectives), where the port's step runs
the warm-up arm its variant names (6); its statuses must still agree.  The
modeled ms differ by design (the port prices the H100's links at the
planner's priors, the JAX lane a TPU's at legs fitted on a TPU trace) and
are not compared across packages; the port's ``--check`` holds them to 2%
of its own committed artifact.
"""

import copy
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bagua_tpu.models import mlp as jax_mlp

from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.models import mlp
from bagua_tpu_torch.tools.static_verify import wire_multiset

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ci_lanes import REPO, ok, run_port, run_reference  # noqa: E402

WIRES = ("f32", "int8", "int4")
#: the cells whose programs differ between the packages (see the docstring)
BOTH_ARMS = {"qadam"}


def _registry_cells():
    from bagua_tpu_torch.algorithms import GlobalAlgorithmRegistry

    return {(n, w, o) for n in GlobalAlgorithmRegistry.keys() for w in WIRES for o in (False, True)}


# ---------------------------------------------------------------------------
# The static-verify sweep
# ---------------------------------------------------------------------------


def test_static_sweep_matches_the_jax_sweep(tmp_path):
    ref, port = tmp_path / "jax.json", tmp_path / "port.json"
    ok(run_reference("static_verify", ["--out", str(ref)], tmp_path), "ci/static_verify.py")
    proc = run_port("static_verify", ["--device", "cpu", "--out", str(port)], tmp_path)
    ok(proc, "tools.static_verify")
    assert "all verified" in proc.stderr
    want, got = json.loads(ref.read_text()), json.loads(port.read_text())
    assert got["mesh"] == want["mesh"] == {"inter": 2, "intra": 4}
    assert got["summary"] == want["summary"]
    key = lambda r: (r["algo"], r["wire"], r["overlap"])  # noqa: E731
    jrows, trows = {key(r): r for r in want["rows"]}, {key(r): r for r in got["rows"]}
    assert set(trows) == set(jrows) == _registry_cells()
    same_program = 0
    for k, j in jrows.items():
        t = trows[k]
        assert t["status"] == j["status"], k
        if t["status"] != "pass" or k[0] in BOTH_ARMS:
            continue
        for field in ("num_collectives", "predicted_records", "captured_records"):
            assert t[field] == j[field], (k, field)
        assert wire_multiset(t) == wire_multiset(j), k
        same_program += 1
    assert same_program == want["summary"]["pass"] - 2  # all but QAdam's two
    # QAdam's warm-up arm is the flat f32 exchange: its bytes are the f32
    # gradient_allreduce cell's
    flat = [w["observed_bytes"] for w in trows[("gradient_allreduce", "f32", False)]["wire_table"]]
    assert [w["observed_bytes"] for w in trows[("qadam", "f32", False)]["wire_table"]] == flat
    assert [(r["algo"], r["records"], r["match"]) for r in got["live_capture"]] == \
        [(r["algo"], r["records"], r["match"]) for r in want["live_capture"]]


def test_static_verify_torch_json_committed_and_green():
    """The committed sweep exists, is green and covers every registered
    algorithm x {f32, int8, int4} x {overlap off, on}."""
    with open(os.path.join(REPO, "STATIC_VERIFY_TORCH.json")) as f:
        report = json.load(f)
    assert report["summary"]["fail"] == 0 and report["summary"]["live_mismatch"] == 0
    assert report["summary"]["pass"] > 0 and report["summary"]["live_match"] == 2
    assert {(r["algo"], r["wire"], r["overlap"]) for r in report["rows"]} == _registry_cells()
    live = {r["algo"]: r for r in report["live_capture"]}
    assert set(live) == {"gradient_allreduce", "zero"} and all(r["match"] for r in live.values())
    assert report["device"]["type"] == "cpu" and report["mesh"] == {"inter": 2, "intra": 4}
    assert report["command"].startswith("python -m bagua_tpu_torch.tools.static_verify")


# ---------------------------------------------------------------------------
# The modeled bench
# ---------------------------------------------------------------------------


def _row_key(r):
    return r.get("mesh_key"), r["algo"], r["wire"], r["overlap"]


def test_modeled_bench_matches_the_jax_bench(tmp_path):
    ref, port = tmp_path / "jax.json", tmp_path / "port.json"
    ok(run_reference("bench_modeled", ["--out", str(ref)], tmp_path), "ci/bench_modeled.py")
    ok(run_port("bench_modeled", ["--device", "cpu", "--out", str(port)], tmp_path), "tools.bench_modeled")
    want, got = json.loads(ref.read_text()), json.loads(port.read_text())
    assert got["summary"] == want["summary"] and got["summary"]["fail"] == 0
    assert got["meshes"] == want["meshes"]
    jrows, trows = {_row_key(r): r for r in want["rows"]}, {_row_key(r): r for r in got["rows"]}
    assert set(trows) == set(jrows)
    exact = 0
    for k, j in jrows.items():
        t = trows[k]
        assert t["status"] == j["status"], k
        if t["status"] != "pass":
            continue
        assert t["modeled_wire_bytes"] == t["census_wire_bytes"] >= 0, k
        assert t["modeled_step_ms"] > 0, k
        if k[1] in BOTH_ARMS:
            assert j["modeled_wire_bytes"] > t["modeled_wire_bytes"], k  # JAX counts both arms
            continue
        assert t["modeled_wire_bytes"] == j["modeled_wire_bytes"], k
        assert t["num_collectives"] == j["num_collectives"], k
        exact += 1
    assert exact == want["summary"]["pass"] - 2
    # the port's model is the H100's: no TPU chip, peak or fitted TPU spans
    from bagua_tpu.observability.goodput import PEAK_FLOPS_PER_CHIP as JAX_PEAKS
    from bagua_tpu_torch.observability.goodput import PEAK_FLOPS_PER_CHIP

    a = got["assumptions"]
    assert a["chip"] in PEAK_FLOPS_PER_CHIP and a["chip"].startswith("h100")
    assert a["peak_flops_per_chip"] == PEAK_FLOPS_PER_CHIP[a["chip"]]
    assert "H100" in a["topology"]["card"] and "fixtures" not in json.dumps(a)
    tpu_peaks = {v for k, v in JAX_PEAKS.items() if not k.startswith("h100")}
    text = json.dumps(got)
    assert not any(str(p) in text for p in tpu_peaks)
    assert "v5e" not in text and "vgg16_bucket_spans" not in text
    proj = got["vgg16_projection"]
    assert proj["chip"] == "h100-sxm-bf16" and proj["grad_bytes"] == 553_430_176
    assert got["measured_miss"]["card"].startswith("NVIDIA H100")


def test_modeled_bench_quick_check_passes_and_catches_drift(tmp_path):
    committed = os.path.join(REPO, "MODELED_BENCH_TORCH.json")
    proc = run_port("bench_modeled", ["--device", "cpu", "--quick", "--check", "--out", committed], tmp_path)
    ok(proc, "tools.bench_modeled --quick --check")
    assert "check passed" in proc.stderr
    # a doctored artifact: one passing row's modeled step 3% above the model
    with open(committed) as f:
        art = json.load(f)
    doctored = copy.deepcopy(art)
    row = next(r for r in doctored["rows"] if r["status"] == "pass" and r["algo"] == "gradient_allreduce")
    row["modeled_step_ms"] = round(row["modeled_step_ms"] * 1.03, 6)
    bad = tmp_path / "doctored.json"
    bad.write_text(json.dumps(doctored))
    proc = run_port("bench_modeled", ["--device", "cpu", "--quick", "--check", "--out", str(bad)], tmp_path)
    assert proc.returncode == 1
    assert "REGRESSION" in proc.stderr and "drift" in proc.stderr


def test_modeled_bench_torch_json_committed_and_green():
    with open(os.path.join(REPO, "MODELED_BENCH_TORCH.json")) as f:
        art = json.load(f)
    assert art["summary"]["fail"] == 0 and art["summary"]["pass"] > 0
    assert {(r["algo"], r["wire"], r["overlap"]) for r in art["rows"] if r["mesh_key"] == "inter2xintra4"} == \
        _registry_cells()
    assert art["mode"].startswith("modeled")
    miss = art["measured_miss"]
    assert miss["card"].startswith("NVIDIA H100") and "W" in miss["card"] and miss["paths"]
    for path in miss["paths"].values():
        assert path["modeled_over_measured_f32"] > 0 and path["measured_ms"] > 0
    assert art["command"].startswith("python -m bagua_tpu_torch.tools.bench_modeled")


def test_modeled_bench_rows_read_the_artifact():
    """The port's ``modeled_bench_rows`` gives the JAX package's row shapes
    for the same metrics, from the port's artifact."""
    from bagua_tpu.perflab.engine import modeled_bench_rows as jax_rows

    from bagua_tpu_torch.perflab import modeled_bench_rows

    with open(os.path.join(REPO, "MODELED_BENCH_TORCH.json")) as f:
        art = json.load(f)
    passing = [(r["algo"], r["wire"], r["overlap"]) for r in art["rows"] if r["status"] == "pass"]
    for metric, key in (("vgg16_img_per_sec_per_chip", "modeled_img_per_s_per_card"),
                        ("vgg16_dp_scaling_efficiency", "modeled_scaling_efficiency_8")):
        rows, want = modeled_bench_rows(metric), jax_rows(metric)
        assert len(rows) == len(want) == 1
        assert set(want[0]) - set(rows[0]) <= {"n_chips"}
        assert rows[0]["mode"] == "modeled" and rows[0]["artifact"] == "MODELED_BENCH_TORCH.json"
        assert rows[0]["measured_miss"]["card"].startswith("NVIDIA H100")
        assert rows[0]["value"] == art["vgg16_projection"][key] > 0
        assert [(r["algo"], r["wire"], r["overlap"]) for r in rows[0]["trend"]] == passing
    assert modeled_bench_rows("no_such_metric") == []
    assert modeled_bench_rows("vgg16_img_per_sec_per_chip", "/nonexistent.json") == []


# ---------------------------------------------------------------------------
# The lanes' device
# ---------------------------------------------------------------------------


TOOLS = ("static_verify", "bench_modeled", "benchmark_check", "moe_check", "autotune_real_run", "fleet_load")


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_raises_without_a_card(tool, monkeypatch, tmp_path):
    """Without ``--device`` each lane takes the card, and raises where there
    is none: nothing falls back to the CPU."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"bagua_tpu_torch.tools.{tool}")
    argv = [] if tool in ("benchmark_check", "moe_check") else ["--out", str(tmp_path / "out.json")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
    assert not (tmp_path / "out.json").exists()


# ---------------------------------------------------------------------------
# The three small functions
# ---------------------------------------------------------------------------


def test_softmax_loss_matches_jax():
    rng = np.random.RandomState(0)
    sizes = [12, 16, 10]
    jparams = jax_mlp.init_mlp(jax.random.PRNGKey(0), sizes)
    x = rng.randn(32, sizes[0]).astype(np.float32)
    y = rng.randint(0, sizes[-1], size=(32,)).astype(np.int32)
    want = float(jax_mlp.softmax_loss(jparams, (jnp.asarray(x), jnp.asarray(y))))
    got = mlp.softmax_loss(params_from_jax(jax.tree.map(np.asarray, jparams)),
                           (torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_mnist_cross_entropy_is_the_shared_one_bitwise():
    """The MNIST twin's loss now calls ``mlp.cross_entropy``: bitwise the
    expression it spelled before."""
    import torch.nn.functional as F

    from bagua_tpu_torch.examples import mnist

    model = mnist.Net(device="cpu", generator=torch.Generator().manual_seed(0))
    params = mnist.module_params(model)
    gen = torch.Generator().manual_seed(1)
    x, y = torch.rand((8, 28, 28, 1), generator=gen), torch.randint(0, 10, (8,), generator=gen).int()
    flat = {f"{m}.{leaf}": t for m, leaves in params.items() for leaf, t in leaves.items()}
    logp = F.log_softmax(torch.func.functional_call(model, flat, (x,)), dim=-1)
    want = -torch.mean(torch.gather(logp, 1, y[:, None].long()))
    assert torch.equal(mnist.net_loss_fn(model)(params, (x, y)), want)


def test_service_port_and_report_metrics_switch_match_jax(monkeypatch):
    from bagua_tpu import env as jenv

    from bagua_tpu_torch import env

    for var in ("BAGUA_SERVICE_PORT", "BAGUA_REPORT_METRICS"):
        monkeypatch.setenv(var, "0")  # restored (or removed) after the test
        monkeypatch.delenv(var)
    assert env.get_bagua_service_port() == jenv.get_bagua_service_port() == -1
    assert env.is_report_metrics_switch_on() is jenv.is_report_metrics_switch_on() is False
    env.set_bagua_service_port(29123)
    assert os.environ["BAGUA_SERVICE_PORT"] == "29123"
    assert env.get_bagua_service_port() == jenv.get_bagua_service_port() == 29123
    jenv.set_bagua_service_port(29124)
    assert env.get_bagua_service_port() == 29124
    for value, on in (("1", True), ("0", False), ("2", False)):
        monkeypatch.setenv("BAGUA_REPORT_METRICS", value)
        assert env.is_report_metrics_switch_on() is jenv.is_report_metrics_switch_on() is on
