"""Run a JAX-package test module's cases over both packages.

A module of the JAX package's tests is executed twice: once as written,
and once with its imports of ``bagua_tpu`` (and the module names it passes
to ``python -m`` or a child's source) pointed at ``bagua_tpu_torch``.
:meth:`Twin.run` calls one case of one copy, handing it pytest's own
fixtures (``tmp_path``, ``monkeypatch``, the JAX ``group``; the port's copy
gets the port's 8-rank CPU group) and the module's fixtures, which
are set up and torn down around the call as pytest would.  A case that
is ``slow`` in the JAX module stays ``slow`` for the JAX copy; the port's
copy runs unmarked.
"""

import inspect
import pathlib

import pytest

PACKAGES = ("bagua_tpu", "bagua_tpu_torch")
TESTS = pathlib.Path(__file__).parent


class _Fixture:
    def __init__(self, fn):
        self.fn = fn


def port_group():
    import torch

    from bagua_tpu_torch.communication import BaguaProcessGroup

    return BaguaProcessGroup([torch.device("cpu")] * 8, intra_size=4)


class Twin:
    """The cases of ``tests/<module>.py`` over both packages.

    ``replace`` holds further ``(old, new)`` source replacements for the
    port's copy; ``port_globals`` names the port's stand-ins for module
    globals that build JAX objects (an engine factory)."""

    def __init__(self, module: str, replace=(), port_globals=None, only=None):
        self.module = module
        src = (TESTS / f"{module}.py").read_text()
        self.ns = {pkg: self._load(src, pkg, replace) for pkg in PACKAGES}
        self.ns["bagua_tpu_torch"].update(port_globals or {})
        names = sorted(n for n, v in self.ns["bagua_tpu"].items()
                       if n.startswith("test_") and callable(v))
        self.cases = [n for n in names if only is None or only(n)]

    def _load(self, src: str, pkg: str, replace):
        if pkg == "bagua_tpu_torch":
            src = src.replace("from bagua_tpu.", "from bagua_tpu_torch.")
            src = src.replace("import bagua_tpu.", "import bagua_tpu_torch.")
            for old, new in replace:
                src = src.replace(old, new)
        src = src.replace("@pytest.fixture()", "@_twin_fixture")
        ns = {"__name__": f"{self.module}[{pkg}]", "__file__": str(TESTS / f"{self.module}.py"),
              "_twin_fixture": _Fixture}
        exec(compile(src, f"tests/{self.module}.py[{pkg}]", "exec"), ns)
        return ns

    def params(self):
        """``(pkg, case)`` pairs, the JAX copy of a slow case marked slow."""
        out = []
        for case in self.cases:
            for pkg in PACKAGES:
                fn = self.ns[pkg][case]
                slow = pkg == "bagua_tpu" and any(
                    m.name == "slow" for m in getattr(fn, "pytestmark", []))
                out.append(pytest.param(pkg, case, marks=pytest.mark.slow if slow else (),
                                        id=f"{pkg}-{case}"))
        return out

    def run(self, pkg: str, case: str, request):
        ns = self.ns[pkg]
        teardown = []
        cache = {}

        def resolve(name):
            if name in cache:
                return cache[name]
            fx = ns.get(name)
            if isinstance(fx, _Fixture):
                args = {p: resolve(p) for p in inspect.signature(fx.fn).parameters}
                value = fx.fn(**args)
                if inspect.isgenerator(value):
                    gen, value = value, next(value)
                    teardown.append(gen)
            elif name == "group" and pkg == "bagua_tpu_torch":
                value = port_group()
            else:
                value = request.getfixturevalue(name)
            cache[name] = value
            return value

        try:
            fn = ns[case]
            fn(**{p: resolve(p) for p in inspect.signature(fn).parameters})
        finally:
            for gen in reversed(teardown):
                for _ in gen:
                    pass


def shm_child(pkg: str, name: str, q) -> None:
    """A ``spawn`` child of the shm cases: read ``hello`` from the segment
    ``name`` through ``pkg``'s store, write ``from_child``."""
    try:
        import importlib

        ShmStore = importlib.import_module(f"{pkg}.contrib.shm_store").ShmStore
        s = ShmStore(name=name, capacity_bytes=1 << 20, create=False)
        q.put(("ok", s.get("hello")))
        s.set("from_child", [4, 5, 6])
        s.shutdown()
    except Exception as e:  # pragma: no cover
        q.put(("err", repr(e)))
