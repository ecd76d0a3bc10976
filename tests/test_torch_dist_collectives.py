"""Every collective of ``bagua_tpu_torch/communication.py`` on a group that
spans OS processes, against the single-controller group of the same ranks.

Each layout spawns one gloo gang (``tests/torch_dist_workers.py
collectives``): W processes of k ranks each on ``127.0.0.1``, the inputs
numpy-seeded and the same in every process, each process passing its
own rows.  Tolerance: none.  Every process's result must be bitwise the
stacked group's rows ``[p k, (p + 1) k)`` (or both must raise the same
error), for every axis choice the case sweeps.  The stacked group is held
against the JAX package in ``tests/test_torch_communication.py``.

Layouts: W 4 x k 2 on the legacy mesh with ``intra_size=4`` (intra crosses
processes), W 2 x k 4 with ``intra_size=4`` (the JAX package's own
two-process layout: intra inside a process, inter across), and W 4 x k 1
on ``MeshSpec({"dp": 2, "tp": 2})``.
"""

import json
import os
import sys

import pytest

from helpers import free_port, spawn_and_collect, worker_env

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_workers import COLLECTIVES, LAYOUTS  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dist_workers.py")


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """Per layout, the gang's reports (one spawn each, on first use)."""
    done = {}

    def get(layout):
        if layout not in done:
            W = LAYOUTS[layout][0]
            out = str(tmp_path_factory.mktemp(layout) / "r")
            port = str(free_port())
            outs = spawn_and_collect(
                [[sys.executable, WORKER, "collectives", str(p), port, out, layout] for p in range(W)],
                worker_env(OMP_NUM_THREADS="1"), timeout=240)
            for code, stdout, stderr in outs:
                assert code == 0, f"{layout} worker failed:\n{stdout}\n{stderr[-4000:]}"
            done[layout] = [json.load(open(f"{out}.proc{p}.json")) for p in range(W)]
        return done[layout]
    return get


@pytest.mark.parametrize("collective", COLLECTIVES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_collective_rows_are_the_stacked_groups(reports, layout, collective):
    for p, report in enumerate(reports(layout)):
        assert report[collective] == [], f"process {p}: {report[collective][:5]}"
