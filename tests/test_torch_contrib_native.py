"""The rest of the port's contrib tier against the JAX package's: the
native shared-memory store and IO prefetcher (the port's own copies of
``shm_store.cpp`` and ``io_prefetcher.cpp``, built by g++ at first use),
the rendezvous blob store, SyncBatchNorm and the imagenet twin's
``--data-dir`` path.

Every case of ``tests/test_io_prefetcher.py`` and
``tests/test_rendezvous_store.py`` runs over both packages
(``twin_cases``); the shm and SyncBatchNorm cases of
``tests/test_contrib.py`` run over both packages by hand (the JAX module
is flax's, the port's an ``nn.Module``).  Cross-package, exactly: a
segment either package's ``ShmStore`` wrote reads back through the
other's; the prefetcher's stream equals JAX's; the cluster store routes
every key to the server JAX's routes it to; ``--data-dir``'s batches are
the JAX example's, bit for bit.  SyncBatchNorm is held to the JAX module
under ``shard_map`` on the same inputs: the output, the input's and
parameters' gradients and the running statistics within 2^-20 of the
largest of each in f32, and 2^-5 in bf16 (the statistics in the input's
type, as JAX takes them).  They are not bitwise: XLA:CPU fuses ``x * x``
into the mean's sum as fused multiply-adds, so ``E[x^2]`` differs by an
ulp (a bf16 step under bf16), and contracts the running update the same
way.
"""

import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from twin_cases import Twin, port_group, shm_child

from bagua_tpu.communication import ALL_AXES
from bagua_tpu.contrib import shm_store as jshm
from bagua_tpu.contrib.io_prefetcher import IOPrefetcher as JaxPrefetcher
from bagua_tpu.contrib.rendezvous_store import make_rendezvous_cluster_store as jax_cluster
from bagua_tpu.contrib.sync_batchnorm import SyncBatchNorm as JaxSyncBN

from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.contrib import IOPrefetcher, ShmStore, SyncBatchNorm, make_rendezvous_cluster_store
from bagua_tpu_torch.contrib.native import BUILD_DIR, library_path
from bagua_tpu_torch.contrib.sync_batchnorm import statistics_sink
from bagua_tpu_torch.distributed.rendezvous import RendezvousState, start_rendezvous_server
from bagua_tpu_torch.mesh import MeshSpec
from bagua_tpu_torch.models._rank_ops import over_ranks

PREFETCH = Twin("test_io_prefetcher")
RDZV_STORE = Twin("test_rendezvous_store")
PACKAGES = ("bagua_tpu", "bagua_tpu_torch")


def test_the_port_runs_its_own_native_tier():
    ns_p, ns_r = PREFETCH.ns["bagua_tpu_torch"], RDZV_STORE.ns["bagua_tpu_torch"]
    assert ns_p["IOPrefetcher"] is IOPrefetcher
    assert ns_r["RendezvousStore"].__module__ == "bagua_tpu_torch.contrib.rendezvous_store"
    assert ns_r["start_rendezvous_server"] is start_rendezvous_server
    assert (len(PREFETCH.cases), len(RDZV_STORE.cases)) == (3, 8)


@pytest.mark.parametrize("pkg, case", PREFETCH.params())
def test_io_prefetcher_case(pkg, case, request):
    PREFETCH.run(pkg, case, request)


@pytest.mark.parametrize("pkg, case", RDZV_STORE.params())
def test_rendezvous_store_case(pkg, case, request):
    RDZV_STORE.run(pkg, case, request)


# ---------------- the native build ------------------------------------------


def test_native_libraries_build_from_the_port_s_sources():
    """Each library is built from ``bagua_tpu_torch/contrib/native/`` into
    the git-ignored ``_build`` beside it, keyed by the source's hash; the
    sources are the JAX package's, copied."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name, libs in (("shm_store", ("-lpthread", "-lrt")), ("io_prefetcher", ("-lpthread",))):
        with open(os.path.join(root, "bagua_tpu_torch", "contrib", "native", f"{name}.cpp")) as f, \
                open(os.path.join(root, "bagua_tpu", "contrib", "native", f"{name}.cpp")) as g:
            assert f.read() == g.read()
        path = library_path(name, libs)
        assert os.path.dirname(path) == BUILD_DIR
    ShmStore(name=f"/bagua_torch_build_{os.getpid()}", capacity_bytes=1 << 16).unlink()
    IOPrefetcher(n_threads=1).close()
    assert os.path.exists(library_path("shm_store", ("-lpthread", "-lrt")))
    assert os.path.exists(library_path("io_prefetcher", ("-lpthread",)))


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: a source g++ refuses raises with the compiler's words."""
    from bagua_tpu_torch.contrib import native

    (tmp_path / "broken.cpp").write_text("int main( {")
    monkeypatch.setattr(native, "NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build"):
        native.build_library("broken")
    assert not any(p.name.endswith(".so") for p in (tmp_path / "_build").iterdir())


# ---------------- shm store (the shm cases of tests/test_contrib.py) --------


def _shm_module(pkg):
    if pkg == "bagua_tpu":
        return jshm.ShmStore
    return ShmStore


@pytest.mark.parametrize("pkg", PACKAGES)
def test_shm_store_cross_process(pkg):
    Store = _shm_module(pkg)
    name = f"/bagua_twin_{pkg}_{os.getpid()}"
    s = Store(name=name, capacity_bytes=1 << 20)
    try:
        s.clear()
        s.set("hello", {"a": np.arange(3)})
        got = s.get("hello")
        np.testing.assert_array_equal(got["a"], np.arange(3))
        assert s.get("missing") is None
        assert s.num_keys() == 1

        ctx = multiprocessing.get_context("spawn")
        q = ctx.Queue()
        p = ctx.Process(target=shm_child, args=(pkg, name, q))
        p.start()
        status, value = q.get(timeout=60)
        p.join(timeout=30)
        assert status == "ok", value
        np.testing.assert_array_equal(value["a"], np.arange(3))
        assert s.get("from_child") == [4, 5, 6]
    finally:
        s.shutdown()
        Store(name=name, capacity_bytes=1 << 20).unlink()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_shm_store_overwrite_and_clear(pkg):
    Store = _shm_module(pkg)
    name = f"/bagua_twin2_{pkg}_{os.getpid()}"
    s = Store(name=name, capacity_bytes=1 << 20)
    try:
        s.clear()
        s.set("k", 1)
        s.set("k", 2)
        assert s.get("k") == 2
        assert s.num_keys() == 1
        s.clear()
        assert s.num_keys() == 0
        assert s.get("k") is None
    finally:
        s.shutdown()
        Store(name=name, capacity_bytes=1 << 20).unlink()


@pytest.mark.parametrize("writer", PACKAGES)
def test_a_segment_one_package_writes_the_other_reads(writer):
    reader = PACKAGES[1 - PACKAGES.index(writer)]
    name = f"/bagua_cross_{writer}_{os.getpid()}"
    w = _shm_module(writer)(name=name, capacity_bytes=1 << 20)
    r = _shm_module(reader)(name=name, capacity_bytes=1 << 20, create=False)
    try:
        w.clear()
        items = {f"k{i}": np.arange(i, dtype=np.float32) for i in range(20)}
        for k, v in items.items():
            w.set(k, v)
        w.set("k3", "overwritten")
        assert r.num_keys() == w.num_keys() == 20
        for k in items:
            assert repr(r.get(k)) == repr(w.get(k))
        r.set("back", {"from": reader})
        assert w.get("back") == {"from": reader}
    finally:
        r.shutdown()
        w.shutdown()
        _shm_module(writer)(name=name, capacity_bytes=1 << 20).unlink()


# ---------------- IO prefetcher and cluster routing, cross-package ----------


def test_prefetcher_stream_equals_jax(tmp_path):
    rng = np.random.RandomState(3)
    paths = []
    for i in range(300):
        p = tmp_path / f"f{i:03d}.bin"
        p.write_bytes(rng.bytes(int(rng.randint(1, 5000))))
        paths.append(str(p))
    paths.insert(17, str(tmp_path / "missing.bin"))
    streams = []
    for cls in (IOPrefetcher, JaxPrefetcher):
        pf = cls(n_threads=4, capacity=16)
        try:
            streams.append(list(pf.read_ordered(paths)))
        finally:
            pf.close()
    assert streams[0] == streams[1]
    assert streams[0][17] == (paths[17], None)
    assert all(payload == open(p, "rb").read() for p, payload in streams[0] if payload is not None)


def test_cluster_store_routes_each_key_as_jax():
    states = [RendezvousState() for _ in range(3)]
    servers = [start_rendezvous_server(st, 0, host="127.0.0.1") for st in states]
    try:
        endpoints = [f"127.0.0.1:{s.server_address[1]}" for s in servers]
        keys = [f"sample/{i}" for i in range(64)] + ["ключ", "a b"]
        placement = {}
        for tag, make in (("port", make_rendezvous_cluster_store), ("jax", jax_cluster)):
            cluster = make(endpoints)
            for k in keys:
                cluster.set(k, k)
            placement[tag] = [st.blob_count() for st in states]
            assert all(cluster.get(k) == k for k in keys)
            cluster.clear()
        assert placement["port"] == placement["jax"] and min(placement["port"]) > 0
    finally:
        for s in servers:
            s.shutdown()


# ---------------- SyncBatchNorm (the cases of tests/test_contrib.py) --------


def _port_sync_bn(tgroup, x, cot=None, track=False, axis_name=("inter", "intra")):
    """The port's SyncBatchNorm on each rank's slice of ``x`` (ranks
    stacked on dim 0) under a ``vmap`` over ``tgroup``'s ranks: outputs,
    the input's and parameters' gradients against ``cot``, and each rank's
    running statistics after the batch."""
    n = tgroup.size
    bn = SyncBatchNorm(x.shape[-1], axis_name=axis_name)
    xs = x.reshape(n, -1, x.shape[-1]).clone().requires_grad_(True)
    scale = bn.scale.detach()[None].repeat(n, 1).requires_grad_(True)
    bias = bn.bias.detach()[None].repeat(n, 1).requires_grad_(True)

    def one_rank(xl, s, b):
        sink = []
        with statistics_sink(sink):
            y = torch.func.functional_call(bn, {"scale": s, "bias": b}, (xl,))
        return (y, *bn.running_update(*sink[0]))

    with over_ranks(tgroup):
        y, mean, var = torch.func.vmap(one_rank)(xs, scale, bias)
    if cot is not None:
        (y * cot.reshape(y.shape)).sum().backward()
    return y, xs.grad, scale.grad, bias.grad, mean.detach(), var.detach()


def _jax_sync_bn(group, x, cot):
    bn = JaxSyncBN(axis_name=ALL_AXES)
    variables = bn.init(jax.random.PRNGKey(0), x[: x.shape[0] // group.size])

    def local(xl, c, v):
        def f(xl, v):
            y, st = bn.apply(v, xl, mutable=["batch_stats"])
            return jnp.sum(y * c), (y, st)

        (_, (y, st)), (gx, gv) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(xl, v)
        per_rank = lambda t: jax.tree.map(lambda a: a[None], t)  # noqa: E731
        return y, gx, per_rank(gv["params"]), per_rank(st["batch_stats"])

    fn = jax.jit(group.shard_map(local, in_specs=(P(ALL_AXES), P(ALL_AXES), P()),
                                 out_specs=(P(ALL_AXES),) * 4))
    y, gx, gp, st = fn(x, cot, variables)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f(y), f(gx), f(gp["scale"]), f(gp["bias"]), f(st["mean"]), f(st["var"])


def _data(seed=0, n=32, c=6):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, c) * 3 + 1.5).astype(np.float32), rng.randn(n, c).astype(np.float32)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_sync_batchnorm_matches_global_bn(pkg, group):
    """Per-rank SyncBatchNorm over the ranks == ordinary BN on the global
    batch (the JAX case's defining property, its tolerances)."""
    x = _data()[0]
    if pkg == "bagua_tpu":
        y_sync = _jax_sync_bn(group, jnp.asarray(x), jnp.zeros_like(jnp.asarray(x)))[0]
    else:
        y_sync = _port_sync_bn(port_group(), torch.from_numpy(x))[0].detach().reshape(x.shape).numpy()
    y_ref = (x - x.mean(0)) / np.sqrt(x.var(0) + 1e-5)
    np.testing.assert_allclose(y_sync, y_ref, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_sync_batchnorm_single_device_fallback(pkg):
    x = np.random.RandomState(1).randn(16, 4).astype(np.float32)
    if pkg == "bagua_tpu":
        bn = JaxSyncBN(axis_name="nonexistent_axis")
        variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
        y = np.asarray(bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])[0])
    else:
        bn = SyncBatchNorm(4, axis_name="nonexistent_axis")
        y = bn(torch.from_numpy(x)).detach().numpy()
        # outside any vmap over ranks the running statistics fold in place
        np.testing.assert_allclose(bn.mean.numpy(), 0.1 * x.mean(0), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(y.mean(0), np.zeros(4), atol=1e-5)


#: each output of :func:`_port_sync_bn` against JAX's, a share of the largest
TOLS = {"f32": 2.0 ** -20, "bf16": 2.0 ** -5}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sync_batchnorm_equals_jax_under_shard_map(group, dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x, cot = _data(seed=4)
    want = _jax_sync_bn(group, jnp.asarray(x, jdt), jnp.asarray(cot))
    got = [t.detach().float().numpy().reshape(w.shape) for t, w in zip(
        _port_sync_bn(port_group(), torch.from_numpy(x).to(tdt), torch.from_numpy(cot)), want)]
    assert got[0].dtype == np.float32 and want[0].dtype == np.float32  # promoted by the f32 scale
    names = ("y", "dx", "dscale", "dbias", "mean", "var")
    for name, g, w in zip(names, got, want):
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= TOLS[dtype] * scale, name
    # every rank holds the same statistics
    assert (got[4] == got[4][:1]).all() and (got[5] == got[5][:1]).all()


def test_sync_batchnorm_on_a_mesh_without_its_axes_is_local():
    """A group on a mesh that declares neither ``inter`` nor ``intra``
    binds nothing: each rank normalizes its own batch, as JAX's module does
    under a ``shard_map`` that binds none of its axes; no hidden sync."""
    mesh = BaguaProcessGroup([torch.device("cpu")] * 8, mesh_spec=MeshSpec({"dp": 4, "tp": 2}))
    x = torch.from_numpy(_data(seed=5)[0])
    y = _port_sync_bn(mesh, x)[0].detach()
    for r in range(8):
        xr = x.reshape(8, -1, x.shape[-1])[r]
        local = (xr - xr.mean(0)) / torch.sqrt(torch.clamp((xr * xr).mean(0) - xr.mean(0) ** 2, min=0) + 1e-5)
        assert torch.equal(y[r], local)
    synced = _port_sync_bn(mesh, x, axis_name="dp")[0].detach()
    assert not torch.equal(synced, y)


# ---------------- the imagenet twin's --data-dir -----------------------------


def _image_folder(root):
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(0)
    for c in range(2):
        d = root / f"class_{c}"
        d.mkdir()
        for i in range(4):
            arr = (rng.rand(40 + 8 * c, 48, 3) * 255).astype(np.uint8)
            PIL.fromarray(arr).save(d / f"img_{i}.jpeg")
        (d / "README.txt").write_text("not an image")  # must be skipped


def test_data_dir_batches_are_the_jax_example_s(tmp_path):
    from test_torch_imagenet import jax_example

    from bagua_tpu_torch.examples import imagenet

    _image_folder(tmp_path)
    got = imagenet.FolderImageNet(str(tmp_path), 32)
    want = jax_example().FolderImageNet(str(tmp_path), 32)
    assert got.classes == want.classes and got.samples == want.samples and len(got) == 8
    for (gx, gy), (wx, wy) in zip(got.read_batches(4, 3), want.read_batches(4, 3)):
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)


def test_data_dir_trains(tmp_path, capsys):
    from bagua_tpu_torch.examples import imagenet

    _image_folder(tmp_path)
    loss, seconds = imagenet.main(["--data-dir", str(tmp_path), "--arch", "vgg16", "--image-size", "32",
                                   "--batch-size", "2", "--steps", "2", "--device", "cpu", "--ranks", "2"])
    out = capsys.readouterr().out
    assert "8 images, 2 classes" in out and np.isfinite(loss) and len(seconds) == 2
