"""What the CI lanes' parity tests share (``tests/test_torch_ci_static.py``,
``test_torch_ci_gates.py``, ``test_torch_ci_fleet.py``): a JAX lane run as
CI runs it, the port's tool run as a user runs it, and the check that a run
exited 0."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_reference(lane, args, tmp_path, timeout=900):
    """``python ci/<lane>.py args`` (or ``python <lane> args`` where ``lane``
    is a script's path), from ``tmp_path``, on the 8-device CPU simulation
    as the JAX package's tests run (``ci/benchmark_check.py`` does not force
    it itself), its compilation cache under ``tmp_path``."""
    script = lane if lane.endswith(".py") else os.path.join(REPO, "ci", f"{lane}.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jax_cache"))
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    return subprocess.run([sys.executable, script, *args], env=env, cwd=str(tmp_path), capture_output=True,
                          text=True, timeout=timeout)


def run_port(tool, args, tmp_path, timeout=900):
    """``python -m bagua_tpu_torch.tools.<tool> args``, from ``tmp_path``."""
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", f"bagua_tpu_torch.tools.{tool}", *args], env=env,
                          cwd=str(tmp_path), capture_output=True, text=True, timeout=timeout)


def ok(proc, what):
    assert proc.returncode == 0, f"{what} failed (rc={proc.returncode}):\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}"
