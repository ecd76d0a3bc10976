"""The port's gang autopilot against the JAX package's, case by case.

``bagua_tpu_torch/autopilot/`` is a copy of the JAX package's jax-free
``autopilot/`` over the port's planner and observability, so the contract
is equality.  Every case of ``tests/test_autopilot.py`` runs on its own
fakes (none builds an engine) twice: once as written, over the JAX
package, and once with its imports pointed at the port.  Both runs must
pass the case's assertions, and every controller and staleness director
the case builds must have taken the same decisions: the ``plan_decision``
rows equal, wall-clock ``ts`` aside.  The card-side arm (the strict gate
under a live ``Trainer`` at full-width VGG16) is ``chip_smoke.py``'s
``[autopilot]`` phase.
"""

import pathlib

import pytest

SOURCE = (pathlib.Path(__file__).parent / "test_autopilot.py").read_text()
PACKAGES = ("bagua_tpu", "bagua_tpu_torch")


def _cases(pkg: str):
    """The case module over ``pkg``, its controllers and directors recorded
    in ``made`` as the cases build them."""
    src = SOURCE if pkg == "bagua_tpu" else SOURCE.replace("from bagua_tpu.", "from bagua_tpu_torch.")
    ns = {"__name__": f"autopilot_cases_{pkg}"}
    exec(compile(src, f"tests/test_autopilot.py[{pkg}]", "exec"), ns)
    made = ns["made"] = []
    for name in ("GangAutopilot", "StalenessDirector"):
        base = ns[name]
        ns[name] = type(name, (base,), {"__init__": _recording(base, made)})
    return ns


def _recording(base, made):
    def __init__(self, *args, **kwargs):
        base.__init__(self, *args, **kwargs)
        made.append(self)

    return __init__


MODULES = {pkg: _cases(pkg) for pkg in PACKAGES}
CASES = sorted(n for n in MODULES["bagua_tpu"] if n.startswith("test_"))


def test_the_port_runs_its_own_autopilot():
    from bagua_tpu_torch.autopilot import GangAutopilot, StalenessDirector

    ns = MODULES["bagua_tpu_torch"]
    assert ns["GangAutopilot"].__mro__[1] is GangAutopilot
    assert ns["StalenessDirector"].__mro__[1] is StalenessDirector
    assert ns["CostModel"].__module__ == "bagua_tpu_torch.service.planner"
    assert len(CASES) == 38


def _rows(controller):
    return [{k: v for k, v in row.items() if k != "ts"} for row in controller.decisions]


@pytest.mark.parametrize("case", CASES)
def test_autopilot_case_matches_jax(case):
    decisions = {}
    for pkg in PACKAGES:
        ns = MODULES[pkg]
        ns["made"].clear()
        ns[case]()
        decisions[pkg] = [(type(c).__name__, _rows(c), c.report().get("configuration") if hasattr(c, "report")
                           else None) for c in ns["made"]]
    assert decisions["bagua_tpu_torch"] == decisions["bagua_tpu"]
