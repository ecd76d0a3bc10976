"""The port's operator tools (``bagua_tpu_torch/tools/``) against the JAX
package's (``ci/``).

``diagnose_hang``, ``perf_doctor`` and ``export_timeline`` run as
subprocesses, ``python -m bagua_tpu_torch.tools.<name>`` beside
``python ci/<name>.py`` (under ``JAX_PLATFORMS=cpu``), on the same inputs:
the flight dumps, the span JSONLs and the fleet timeline of a two-process
gang that wedged (``tests/test_torch_dist_fleet.py``'s remediation case),
and a metrics JSONL holding a ``perf_regression`` incident and the
autopilot decision that cites it.  Their JSON outputs are equal.

The fault-injection lane (``python -m bagua_tpu_torch.tools.fault_injection
--device cpu --processes 2``): a gloo gang of two launcher workers drained by SIGTERM
and killed by SIGKILL, each resumed run bitwise the uninterrupted one.
That the tools import neither JAX nor the JAX package is held by
``tests/test_torch_slice.py::test_port_imports_no_jax``.
"""

import json
import os
import subprocess
import sys

import pytest

from bagua_tpu_torch.fleet import FleetControlPlane, start_fleet_server
from bagua_tpu_torch.observability import Telemetry

from helpers import REPO_ROOT, worker_env
from test_torch_dist_fleet import RDZV, spawn_workers

TOOLS = ("diagnose_hang", "perf_doctor", "export_timeline")


@pytest.fixture(scope="module")
def wedged(tmp_path_factory):
    """The inputs: a wedged two-process gang's dumps, spans and timeline,
    and a metrics JSONL with an incident and a decision joined to one of
    the gang's traces."""
    tmp = tmp_path_factory.mktemp("wedged")
    dumps = tmp / "dumps"
    dumps.mkdir()
    plane = FleetControlPlane(rdzv_kwargs=RDZV)
    server = start_fleet_server(plane, 0, host="127.0.0.1")
    try:
        spawn_workers("fleet_remediation", 2, tmp, f"http://127.0.0.1:{server.server_address[1]}", "wedge",
                      str(dumps))
        timeline = plane.timeline("wedge")
    finally:
        server.shutdown()
        plane.close()
    (tmp / "timeline.json").write_text(json.dumps(timeline))
    spans = [json.loads(line) for line in open(dumps / "spans0.jsonl")]
    trace_id = spans[-1]["trace_id"]
    tel = Telemetry(metrics_jsonl=str(dumps / "incidents.jsonl"), flight=None, tracing=None, regression=None)
    tel.jsonl.emit({
        "event": "perf_regression", "ts": 10.0, "step": 3, "stream": "step_wall", "dominant": "straggler",
        "components": {"straggler": 1500.0}, "residual_ms": 1500.0, "expected_ms": 10.0, "measured_ms": 1510.0,
        "plan_version": 1, "trace_id": trace_id, "straggler_rank": 1,
    })
    tel.on_plan_decision(
        step=4, decision="demote_precision", reason="autopilot:straggler", trace_id=trace_id, plan_version=1,
        from_config={"algorithm": "gradient_allreduce", "precision": "f32"},
        to_config={"algorithm": "gradient_allreduce", "precision": "int8"},
        verdict="canary", modeled={"stay_ms": 1510.0, "chosen_ms": 12.0},
    )
    tel.close()
    return tmp


def tool_args(name, tmp, out):
    dumps = tmp / "dumps"
    if name == "diagnose_hang":
        return ["--dir", str(dumps), "--out", out]
    spans = sorted(str(p) for p in dumps.glob("spans*.jsonl"))
    if name == "perf_doctor":
        return (["--metrics", str(dumps / "incidents.jsonl"), "--flight-dir", str(dumps), "--out", out]
                + [a for s in spans for a in ("--spans", s)])
    return ([a for s in spans for a in ("--spans", s)]
            + ["--timeline", str(tmp / "timeline.json"), "--metrics", str(dumps / "incidents.jsonl"), "--out", out])


@pytest.mark.parametrize("name", TOOLS)
def test_tool_output_equals_the_jax_tool(wedged, name):
    outs = {}
    for pkg, cmd in (("port", [sys.executable, "-m", f"bagua_tpu_torch.tools.{name}"]),
                     ("jax", [sys.executable, os.path.join(REPO_ROOT, "ci", f"{name}.py")])):
        out = str(wedged / f"{name}.{pkg}.json")
        run = subprocess.run(cmd + tool_args(name, wedged, out), env=worker_env(JAX_PLATFORMS="cpu"),
                             cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
        assert run.returncode == 0, run.stderr[-3000:]
        outs[pkg] = (json.load(open(out)), run.stdout)
    assert outs["port"][0] == outs["jax"][0]
    assert outs["port"][1] == outs["jax"][1]
    report = outs["port"][0]
    if name == "diagnose_hang":
        assert report["verdict"] == "host_wedge" and report["lagging_ranks"] == [1]
        assert report["incidents"] and report["ranks"] == [0, 1]
    elif name == "perf_doctor":
        assert report["incident"]["dominant"] == "straggler" and report["decisions"]
    else:
        assert any(e.get("ph") == "X" for e in report["traceEvents"])
        assert any(e.get("name") == "perf_regression:straggler" for e in report["traceEvents"])


def test_fault_injection_lane_two_processes(tmp_path):
    out = tmp_path / "lane" / "RESILIENCE.json"
    run = subprocess.run([sys.executable, "-m", "bagua_tpu_torch.tools.fault_injection", "--device", "cpu",
                          "--processes", "2", "--workdir", str(tmp_path / "lane")], env=worker_env(),
                         cwd=str(tmp_path), capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-4000:]
    report = json.load(open(out))
    lane = report["fault_injection"]
    assert lane["device"] == report["overhead"]["device"] == "cpu"
    assert lane["processes"] == 2 and lane["bitwise_identical"] and lane["plan_source"] == "carried"
    preempt, crash = lane["scenarios"]["preempt"], lane["scenarios"]["crash"]
    assert preempt["lost_steps"] == 0 and preempt["resumed_step"] >= lane["kill_after_steps"]
    # the hard kill loses at most the cadence
    assert 0 <= crash["signaled_after_steps"] - crash["resumed_step"] <= lane["snapshot_every"]
    assert crash["resumed_step"] % lane["snapshot_every"] == 0
    assert preempt["world_size"] == crash["world_size"] == 4
    assert not (tmp_path / "RESILIENCE.json").exists()


def test_fault_injection_lane_asks_for_the_card_by_default(tmp_path):
    """Without ``--device cpu`` the lane runs on the card, and a gang of
    two processes needs two cards: here, with none, it is refused before
    anything starts."""
    run = subprocess.run([sys.executable, "-m", "bagua_tpu_torch.tools.fault_injection", "--processes", "2",
                          "--workdir", str(tmp_path / "lane")], env=worker_env(), cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 2 and "needs 2 card(s), 0 visible" in run.stderr, run.stderr[-2000:]
    assert not (tmp_path / "lane").exists()
