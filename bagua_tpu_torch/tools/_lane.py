"""What the CI lanes under ``tools/`` share: the group a lane runs on, the
``--device`` option and the artifact's provenance fields."""

import json
import os
import platform
import sys
from typing import Optional

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: the JAX lanes' CPU shape: the 8-device CPU simulation
CPU_RANKS = 8


def add_device_args(ap) -> None:
    """``--device`` (``cuda``, the default, raises where there is no card),
    ``--ranks`` and ``--intra-size``."""
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the ranks live (cpu: the JAX lane's 8-rank CPU shape)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="place this many ranks on --device (default: 8 on the CPU, one a visible card)")
    ap.add_argument("--intra-size", type=int, default=None,
                    help="ranks on the fast inner axis (default: the lane's own layout)")


def lane_group(device: str, ranks: Optional[int] = None, intra_size: Optional[int] = None,
               cpu_intra_size: Optional[int] = None):
    """The lane's group, made the default group.  ``cpu``: ``ranks`` (8) CPU
    ranks at ``intra_size``, by default ``cpu_intra_size``, the JAX lane's
    layout (None: the JAX default group's, every rank on the intra axis).
    ``cuda``: one rank a visible card, or ``ranks`` ranks on the current
    card; raises where there is no card."""
    from bagua_tpu_torch.communication import init_process_group

    if device == "cpu":
        return init_process_group([torch.device("cpu")] * (ranks or CPU_RANKS),
                                  intra_size=cpu_intra_size if intra_size is None else intra_size)
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device is visible; pass --device cpu to run on the CPU")
    if ranks is None:
        return init_process_group(intra_size=intra_size)
    return init_process_group([torch.device("cuda", torch.cuda.current_device())] * ranks, intra_size=intra_size)


def mesh_of(group) -> dict:
    return {axis: int(n) for axis, n in zip(group.all_axes, group.shape)}


def device_record(group=None) -> dict:
    """The device a lane ran on: the card's name, or the host's CPU."""
    if group is not None and group.device.type == "cuda":
        return {"type": "cuda", "name": torch.cuda.get_device_name(group.device),
                "ranks": group.size, "cards": len({str(d) for d in group.devices})}
    out = {"type": "cpu", "name": "host CPU", "host_cpu": _cpu_model(), "host_cpus": os.cpu_count()}
    if group is not None:
        out["ranks"] = group.size
    return out


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.machine() or "unknown"


def command_line() -> str:
    """The command that made this artifact."""
    return " ".join(["python", "-m", sys.modules["__main__"].__spec__.name] + sys.argv[1:]) \
        if getattr(sys.modules.get("__main__"), "__spec__", None) else " ".join(["python"] + sys.argv)


def wait(device) -> None:
    """Waits for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def write_json(path: str, payload: dict, indent=2) -> None:
    with open(path, "w") as f:
        json.dump(payload, f, indent=indent)
        f.write("\n")
