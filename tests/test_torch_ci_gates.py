"""The port's training gates (``bagua_tpu_torch/tools/``: ``benchmark_check``,
``moe_check``, ``autotune_real_run``) against the JAX package's lanes
(``ci/benchmark_check.py``, ``ci/moe_check.py``, ``ci/autotune_real_run.py``)
on the CPU (the card's ``[ci-bench]`` launch counts are
``tests/test_torch_ci_cuda.py``'s).

Each test runs the reference lane as CI does (``python ci/<lane>.py`` on the
8-device CPU simulation, every rank on the intra axis: the JAX default
group's layout, which the port's ``--device cpu`` takes too) beside the
port's tool.  Tolerances, each with its reason:

- the benchmark gate, ``--model mlp``: the JAX lane's weights
  (``init_mlp(PRNGKey(1), [64, 128, 16])``) carried across by
  ``params_from_jax``, the same 14 steps of data from ``RandomState(3)``;
  each algorithm's final loss within rtol 1e-5 of the JAX lane's printed
  one (the f32 tolerance of ``tests/test_torch_slice.py``).  ByteGrad's
  loss equals ``gradient_allreduce``'s in both packages: on this layout
  every rank sits on the intra axis, which ByteGrad reduces in f32.  Each
  package's two runs are exactly equal.
- the MoE gate: both lanes' three gates (exact determinism, the loss under
  0.05, expert parity) at their 400 steps.  The two packages' trajectories
  from the same weights part at f32 rounding that the top-1 routing and
  Adam amplify about tenfold every 20 steps (1e-7 relative at step 40,
  1.5e-5 at 100, 1.5e-4 at 120, uncorrelated after 140), so the final
  losses at 400 steps are two draws from the converged noise, not one
  number twice.  The port is held to the JAX lane's own ``run`` at 100
  steps instead, from the JAX lane's weights, within rtol 1e-4 (the
  tolerance of ``tests/test_torch_moe_examples.py``).
- the autotune lane: the port's three assertions.  The port's session
  restarts the engine's speed meter whenever it changes the plan, so that
  each sample is its own plan's throughput; the JAX session's samples are
  the run's average since its start, which lets the first samples decide
  (on that signal the port's lane once locked the 32 KiB start under the
  suite's load).  The JAX lane keeps that signal, so it must complete and
  re-bucket and may fail only that third assertion.
"""

import json
import os
import re
import shutil
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bagua_tpu.communication import ALL_AXES as JAX_ALL_AXES
from bagua_tpu.models.mlp import init_mlp as jax_init_mlp
from bagua_tpu.parallel.moe import MoE as JMoE

from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.convert import params_from_jax, stacked_params_from_jax
from bagua_tpu_torch.tools import benchmark_check, moe_check

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ci_lanes import REPO, ok, run_port, run_reference  # noqa: E402

N = 8
LOSS_RTOL = 1e-5
MOE_RTOL, MOE_STEPS = 1e-4, 100


def cpu_group():
    """The JAX default group's layout: 8 ranks, every one on the intra axis."""
    return BaguaProcessGroup([torch.device("cpu")] * N)


# ---------------------------------------------------------------------------
# The benchmark gate
# ---------------------------------------------------------------------------


LINE = re.compile(r"^mlp/(\w+)\s+loss=(\S+) determinism=(OK|FAIL)")


def test_benchmark_gate_mlp_matches_the_jax_lane(tmp_path):
    proc = run_reference("benchmark_check", ["--cpu"], tmp_path)
    ok(proc, "ci/benchmark_check.py --cpu")
    want = {m.group(1): (float(m.group(2)), m.group(3)) for m in map(LINE.match, proc.stdout.splitlines()) if m}
    assert set(want) == set(benchmark_check.deterministic_algorithms())
    assert all(det == "OK" for _, det in want.values())
    params = params_from_jax(jax.tree.map(np.asarray, jax_init_mlp(jax.random.PRNGKey(1), [64, 128, 16])))
    out = benchmark_check.run_gate(cpu_group(), "mlp", params=params)
    assert out["failures"] == []
    for name, r in out["results"].items():
        first, second = r["losses"]
        assert first == second, name
        np.testing.assert_allclose(first, want[name][0], rtol=LOSS_RTOL, err_msg=name)
        assert r["buckets"] >= 1 and r["warmup"] == (7 if name == "qadam" else 2)
    # ByteGrad on the all-intra layout reduces in f32: the f32 gradient's loss
    assert out["results"]["bytegrad"]["losses"] == out["results"]["gradient_allreduce"]["losses"]
    # the command line on the CPU: its own weights, every gate green
    proc = run_port("benchmark_check", ["--device", "cpu"], tmp_path)
    ok(proc, "tools.benchmark_check --device cpu")
    assert "all benchmark checks passed" in proc.stdout and "ranks=8 cards=1" in proc.stdout


def test_benchmark_gate_holds_a_floor_and_the_reference_floors_are_vgg16s(tmp_path):
    out = benchmark_check.run_gate(cpu_group(), "mlp", names=["gradient_allreduce"], steps=2,
                                   floors={"gradient_allreduce": 1e12})
    assert len(out["failures"]) == 1 and "throughput" in out["failures"][0]
    with pytest.raises(SystemExit, match="VGG16"):
        benchmark_check.main(["--device", "cpu", "--reference-floors"])


# ---------------------------------------------------------------------------
# The MoE gate
# ---------------------------------------------------------------------------


class FlaxMoEModel(nn.Module):
    """``ci/moe_check.py``'s ``Model`` (defined inside its ``run``)."""

    n: int

    @nn.compact
    def __call__(self, x):
        h = jax.nn.relu(nn.Dense(64)(x))
        h, l_aux = JMoE(hidden_size=128, num_experts=self.n, k=1, capacity_factor=2.0, ep_size=self.n,
                        ep_axis=JAX_ALL_AXES)(h)
        return nn.Dense(10)(h), l_aux


def jax_lane_weights():
    """The JAX lane's initial weights: rank r's experts from PRNGKey(r), the
    other leaves rank 0's."""
    model = FlaxMoEModel(N)
    per_rank = [model.init(jax.random.PRNGKey(r), jnp.zeros((4, 32)))["params"] for r in range(N)]
    return [jax.tree_util.tree_map_with_path(
        lambda path, b, pr: pr if "experts" in jax.tree_util.keystr(path) else b, per_rank[0], p)
        for p in per_rank]


def _load_jax_moe_lane():
    import importlib.util

    spec = importlib.util.spec_from_file_location("jax_moe_check", os.path.join(REPO, "ci", "moe_check.py"))
    lane = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lane)
    return lane


def test_moe_gate_matches_the_jax_lane(tmp_path, monkeypatch):
    proc = run_reference("moe_check", [], tmp_path)
    ok(proc, "ci/moe_check.py")
    assert "moe check passed" in proc.stdout
    proc = run_port("moe_check", ["--device", "cpu"], tmp_path)
    ok(proc, "tools.moe_check --device cpu")
    assert "moe check passed" in proc.stdout
    run1, run2 = re.search(r"run1=(\S+) run2=(\S+)", proc.stdout).groups()
    assert run1 == run2 and float(run1) < moe_check.CONVERGED_LOSS
    # the same weights and data, MOE_STEPS steps: the JAX lane's own run
    import bagua_tpu.communication as jax_comm

    lane = _load_jax_moe_lane()
    monkeypatch.setattr(lane, "STEPS", MOE_STEPS)
    # the lane's run() makes its own default group: give the next tests back theirs
    monkeypatch.setattr(jax_comm, "_default_group", jax_comm._default_group)
    want, jstate = lane.run()
    merged = jax_lane_weights()
    got, params = moe_check.run(cpu_group(), stacked_params_from_jax([jax.tree.map(np.asarray, m) for m in merged]),
                                steps=MOE_STEPS)
    np.testing.assert_allclose(got, want, rtol=MOE_RTOL)
    # the trees line up leaf for leaf
    assert [tuple(t.shape) for t in jax.tree.leaves(params)] == \
        [tuple(np.shape(t)) for t in jax.tree.leaves(jstate.params)]


def test_moe_gate_catches_a_dense_leaf_that_diverges(monkeypatch):
    """Expert parity is a real gate: a step that moves one rank's dense
    leaf off the others fails it."""
    from bagua_tpu_torch.utils import tree_flatten_with_names

    real = moe_check.run

    def tampered(group, stacked=None, steps=moe_check.STEPS):
        loss, params = real(group, stacked, steps)
        name, leaf = next((n, t) for n, t in tree_flatten_with_names(params) if "experts" not in n)
        leaf[1].add_(1.0)
        return loss, params

    monkeypatch.setattr(moe_check, "run", tampered)
    out = moe_check.gate(cpu_group(), steps=3)
    assert any("diverged across ranks" in f for f in out["failures"])
    assert any("convergence" in f for f in out["failures"])


# ---------------------------------------------------------------------------
# The autotune lane
# ---------------------------------------------------------------------------


def _autotune_asserts(trace):
    assert trace["ok"] is True, trace.get("error")
    assert trace["completed_at_step"] is not None
    assert trace["rebuckets"] >= 1 and trace["samples"]
    assert trace["final_buckets"] < trace["initial_buckets"]
    assert trace["locked_speed_sps"] > 0


def test_autotune_lane_on_a_measured_signal(tmp_path):
    # the JAX lane writes its artifact beside its own ci/ directory: run a
    # copy from tmp_path so that the repo's AUTOTUNE_RUN.json stays as it is
    (tmp_path / "ci").mkdir()
    shutil.copy(os.path.join(REPO, "ci", "autotune_real_run.py"), tmp_path / "ci")
    proc = run_reference(str(tmp_path / "ci" / "autotune_real_run.py"), [], tmp_path)
    ref = json.loads((tmp_path / "AUTOTUNE_RUN.json").read_text())
    # the JAX lane scores each plan by the run's average speed since its
    # start, so under load its first samples can decide the pick and lock
    # the start: the only way it may fail here
    assert ref["completed_at_step"] is not None and ref["rebuckets"] >= 1, ref
    if proc.returncode:
        assert "no better than the pathological" in ref["error"], ref["error"]
    else:
        _autotune_asserts(ref)
    out = tmp_path / "port.json"
    proc = run_port("autotune_real_run", ["--device", "cpu", "--out", str(out)], tmp_path)
    ok(proc, "tools.autotune_real_run --device cpu")
    trace = json.loads(out.read_text())
    _autotune_asserts(trace)
    assert trace["device"]["type"] == "cpu" and trace["devices"] == N
    assert trace["planner_trail"] and "telemetry" in trace


def test_autotune_torch_json_committed_and_green():
    with open(os.path.join(REPO, "AUTOTUNE_RUN_TORCH.json")) as f:
        trace = json.load(f)
    _autotune_asserts(trace)
    assert trace["device"]["type"] == "cuda" and trace["device"]["name"].startswith("NVIDIA H100")
    assert trace["command"].startswith("python -m bagua_tpu_torch.tools.autotune_real_run")
