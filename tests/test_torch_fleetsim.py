"""The port's fleet simulator (``bagua_tpu_torch/perflab/fleetsim.py``)
against the JAX package's.

The simulator is a copy that drives the port's rendezvous server,
``GangAggregator``, flight digests and circuit breaker, so the contract is
equality.  Every case of ``tests/test_fleetsim.py`` runs over both
packages (``twin_cases``), and ``run_fleet`` reports equal, exactly, for
the same configurations under no fault, a straggler and a KV flap (the
reports hold modeled clocks and detections, no wall-clock time).
"""

import pytest

from twin_cases import Twin

from bagua_tpu.perflab import fleetsim as jax_fleetsim

from bagua_tpu_torch.perflab import fleetsim

FLEETSIM = Twin("test_fleetsim")


def test_the_port_runs_its_own_simulator():
    import bagua_tpu_torch.perflab as perflab

    ns = FLEETSIM.ns["bagua_tpu_torch"]
    assert ns["run_fleet"] is fleetsim.run_fleet is perflab.run_fleet
    assert ns["FleetConfig"] is perflab.FleetConfig
    assert len(FLEETSIM.cases) == 12


@pytest.mark.parametrize("pkg, case", FLEETSIM.params())
def test_fleetsim_case(pkg, case, request):
    FLEETSIM.run(pkg, case, request)


def _config(mod, fault):
    faults = {
        "none": (),
        "straggler": (mod.Straggler(gang=1, rank=3, factor=3.0, phase="wire"),),
        "kv_flap": (mod.KVFlap(gang=0, start_window=2, end_window=3),),
    }[fault]
    return mod.FleetConfig(n_gangs=2, ranks_per_gang=4, windows=3, seed=11, faults=faults)


@pytest.mark.parametrize("fault", ["none", "straggler", "kv_flap"])
def test_run_fleet_reports_equal_jax(fault):
    ours = fleetsim.run_fleet(_config(fleetsim, fault))
    assert ours == jax_fleetsim.run_fleet(_config(jax_fleetsim, fault))
    if fault == "straggler":
        assert [d["rank"] for d in ours["gangs"][1]["straggler_detections"]] == [3, 3, 3]
