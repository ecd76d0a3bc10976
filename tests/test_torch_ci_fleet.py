"""The port's fleet lanes (``bagua_tpu_torch/tools/``: ``fleet_load`` against
``python -m bagua_tpu_torch.fleet.server``, ``fleet_scale`` against its
sharded server) beside the JAX package's (``ci/fleet_load.py``,
``ci/fleet_scale.py``) on the CPU.

Each lane's JSON must pass the asserts ``tests/test_ci_lane.py`` makes of the
JAX lane's (the scale lane at its quick 120 gangs), both packages' lanes in
the same test; the committed ``FLEET_LOAD_TORCH.json`` and
``FLEET_SCALE_TORCH.json`` (1000 gangs) must pass them too.  The port's
lanes bind their server to a port chosen free; where another process takes
it first, a lane runs again on a fresh port and says so.
"""

import json
import os
import socket
import sys

from bagua_tpu_torch.tools import _fleet, fleet_scale

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ci_lanes import REPO, ok, run_port, run_reference  # noqa: E402



def fleet_load_asserts(fl):
    """``tests/test_ci_lane.py``'s asserts on the load lane's artifact."""
    assert fl["fleet_sim"]["n_gangs"] >= 8
    assert fl["fleet_sim"]["healthy"] == fl["fleet_sim"]["n_gangs"]
    assert fl["fleet_sim"]["churn_stale_ranks"] == [1]
    assert fl["scheduler"]["straggler"]["rank"] == 2
    assert fl["scheduler"]["straggler"]["phase"] == "wire"
    assert fl["isolation"]["leaks"] == 0 and fl["isolation"]["probes"] >= 6
    assert fl["backpressure"]["denials_429"] >= 1
    assert fl["backpressure"]["retry_after_s_min"] >= 1
    assert fl["backpressure"]["paced_breaker_opened"] == 0
    assert fl["latency"]["p99_ms"] <= fl["latency"]["gate_ms"]
    assert fl["sigkill"]["dump_bitwise_identical"] is True
    assert fl["sigkill"]["rider_failures"] >= 1
    assert fl["sigkill"]["rider_breaker_opened"] >= 1
    assert fl["plan_adoption"]["plan_source"] == "fleet"
    assert fl["plan_adoption"]["published_before_kill"] is True


def fleet_scale_asserts(fs, n_gangs):
    """``tests/test_ci_lane.py``'s asserts on the scale lane's artifact."""
    assert fs["n_gangs"] == n_gangs and fs["server"]["shards"] == 4
    assert fs["herd"]["gangs"] == fs["n_gangs"]
    assert fs["herd"]["withheld_by_canary_gate"] >= fs["n_gangs"] - 2
    assert all(n > 0 for n in fs["herd"]["gangs_per_shard"])
    assert fs["churn"]["flap_429"] >= 1
    assert fs["latency"]["p99_ms"] <= fs["latency"]["gate_ms"]
    assert fs["staleness"]["observed_s"] <= fs["staleness"]["gate_s"]
    rem = fs["remediation"]
    assert rem["false_quarantines"] == 0
    assert len(rem["quarantined"]) == 1 and rem["quarantine_cites"]
    assert rem["rollback_gangs"] == ["b0", "b1"]
    assert rem["resize"]["verdict"] == "desync"
    assert rem["resize"]["to_world_size"] == 1
    assert rem["idempotent_resweep"] is True and rem["graduated"]
    assert fs["sigkill"]["dump_bitwise_identical"] is True
    assert fs["sigkill"]["remediation_state_survived"] is True
    assert all(0 < ms <= fs["sigkill"]["replay_gate_ms"] for ms in fs["sigkill"]["wal_replay_ms"])


def test_fleet_load_lane_beside_the_jax_lane(tmp_path):
    ref, port = tmp_path / "jax.json", tmp_path / "port.json"
    ok(run_reference("fleet_load", ["--out", str(ref), "--workdir", str(tmp_path / "jax")], tmp_path),
        "ci/fleet_load.py")
    fleet_load_asserts(json.loads(ref.read_text()))
    proc = run_port("fleet_load", ["--device", "cpu", "--out", str(port), "--workdir", str(tmp_path / "port")],
                    tmp_path)
    ok(proc, "tools.fleet_load --device cpu")
    assert "fleet load lane passed" in proc.stderr
    got = json.loads(port.read_text())
    fleet_load_asserts(got)
    assert got["device"] == {"type": "cpu", "name": "host CPU", "host_cpu": got["device"]["host_cpu"],
                             "host_cpus": os.cpu_count(), "ranks": 8}
    assert got["command"].startswith("python -m bagua_tpu_torch.tools.fleet_load")


def test_fleet_scale_lane_beside_the_jax_lane(tmp_path):
    ref, port = tmp_path / "jax.json", tmp_path / "port.json"
    ok(run_reference("fleet_scale", ["--n-gangs", "120", "--out", str(ref), "--workdir", str(tmp_path / "jax")],
                      tmp_path), "ci/fleet_scale.py")
    fleet_scale_asserts(json.loads(ref.read_text()), 120)
    proc = run_port("fleet_scale", ["--n-gangs", "120", "--out", str(port), "--workdir", str(tmp_path / "port")],
                    tmp_path)
    ok(proc, "tools.fleet_scale --n-gangs 120")
    assert "fleet scale lane passed" in proc.stderr
    fleet_scale_asserts(json.loads(port.read_text()), 120)


def test_fleet_artifacts_committed_and_green():
    with open(os.path.join(REPO, "FLEET_LOAD_TORCH.json")) as f:
        fl = json.load(f)
    fleet_load_asserts(fl)
    assert fl["command"].startswith("python -m bagua_tpu_torch.tools.fleet_load")
    with open(os.path.join(REPO, "FLEET_SCALE_TORCH.json")) as f:
        fs = json.load(f)
    fleet_scale_asserts(fs, fleet_scale.N_GANGS_FULL)
    assert fs["command"].startswith("python -m bagua_tpu_torch.tools.fleet_scale")


def test_fleet_lane_retries_a_taken_port(tmp_path, monkeypatch, capsys):
    """The first port the lane picks is held by another listener: the
    server exits with EADDRINUSE, the lane prints the retry and passes on a
    fresh port."""
    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen(1)
    ports = [taken.getsockname()[1]]
    real = _fleet.free_port

    def first_taken():
        return ports.pop() if ports else real()

    monkeypatch.setattr(fleet_scale, "free_port", first_taken)
    try:
        out = fleet_scale.run_lane(str(tmp_path / "lane"), str(tmp_path / "fs.json"), n_gangs=40)
    finally:
        taken.close()
    fleet_scale_asserts(out, 40)
    err = capsys.readouterr().err
    assert "[fleet-scale]: a port was taken (EADDRINUSE" in err and "retry 1 of 2" in err
    assert os.path.isdir(tmp_path / "lane" / "try1")
