"""The imagenet twin's synthetic path (``bagua_tpu_torch.examples.imagenet``)
and the contrib data tier it reads through (``bagua_tpu_torch.contrib``:
copies of the JAX package's jax-free stores, cache loader, cached dataset
and load-balancing samplers), on the CPU.

The copies are held against the JAX package's modules on the same seeds
and calls: the same samples, orders, batches, hits and keys, exactly.
"""

import contextlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from bagua_tpu.contrib import cache_loader as jcache_loader
from bagua_tpu.contrib import cached_dataset as jcached_dataset
from bagua_tpu.contrib import load_balancing_data_loader as jlb
from bagua_tpu.contrib import store as jstore

from bagua_tpu_torch.contrib import (
    CacheLoader, CachedDataset, ClusterStore, FileStore, InMemoryStore, LoadBalancingDistributedBatchSampler,
    LoadBalancingDistributedSampler,
)
from bagua_tpu_torch.contrib import store as tstore
from bagua_tpu_torch.contrib.shm_store import ShmStore
from bagua_tpu_torch.examples import imagenet
from bagua_tpu_torch.utils import tree_leaves


class Lengths:
    """A dataset whose samples' complexity is a seeded length."""

    def __init__(self, n=37, seed=0):
        self.lengths = np.random.RandomState(seed).randint(1, 50, n)

    def __len__(self):
        return len(self.lengths)

    def __getitem__(self, i):
        return int(self.lengths[i])


@pytest.mark.parametrize("shuffle,drop_last,random_level", [(True, False, 0.0), (True, True, 0.5),
                                                            (False, False, 0.0), (True, False, 1.0)])
def test_sampler_matches_the_jax_package(shuffle, drop_last, random_level):
    data = Lengths()
    for replicas in (1, 3, 4):
        for rank in range(replicas):
            kw = dict(complexity_fn=lambda s: s, num_replicas=replicas, rank=rank, shuffle=shuffle, seed=3,
                      drop_last=drop_last, random_level=random_level)
            got, want = LoadBalancingDistributedSampler(data, **kw), jlb.LoadBalancingDistributedSampler(data, **kw)
            for epoch in range(3):
                got.set_epoch(epoch)
                want.set_epoch(epoch)
                assert list(got) == list(want) and len(got) == len(want)


def test_batch_sampler_matches_the_jax_package():
    data = Lengths(n=53, seed=1)

    def batch_fn(indices):  # pack by a token budget
        out, cur, used = [], [], 0
        for i in indices:
            if cur and used + data[i] > 60:
                out.append(cur)
                cur, used = [], 0
            cur.append(i)
            used += data[i]
        return out + ([cur] if cur else [])

    for drop_last in (False, True):
        for rank in range(4):
            kw = dict(complexity_fn=lambda s: s, num_replicas=4, rank=rank, seed=7)
            got = LoadBalancingDistributedBatchSampler(LoadBalancingDistributedSampler(data, **kw), batch_fn,
                                                       drop_last=drop_last)
            want = jlb.LoadBalancingDistributedBatchSampler(jlb.LoadBalancingDistributedSampler(data, **kw),
                                                            batch_fn, drop_last=drop_last)
            got.set_epoch(2)
            want.set_epoch(2)
            assert list(got) == list(want) and len(got) == len(want)
    with pytest.raises(ValueError, match="drop_last of sampler"):
        LoadBalancingDistributedBatchSampler(LoadBalancingDistributedSampler(
            data, lambda s: s, num_replicas=2, rank=0, drop_last=True), batch_fn)


def test_sampler_rejects_bad_arguments_and_reads_the_job_size(monkeypatch):
    data = Lengths()
    with pytest.raises(ValueError, match="Invalid rank"):
        LoadBalancingDistributedSampler(data, lambda s: s, num_replicas=2, rank=2)
    with pytest.raises(ValueError, match="Invalid random level"):
        LoadBalancingDistributedSampler(data, lambda s: s, num_replicas=2, rank=0, random_level=2.0)
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "2")
    sampler = LoadBalancingDistributedSampler(data, lambda s: s)
    assert (sampler.num_replicas, sampler.rank) == (3, 2)


@pytest.mark.parametrize("make", ["memory", "file", "cluster"])
def test_stores_match_the_jax_package(make, tmp_path):
    def build(module, sub):
        if make == "memory":
            return module.InMemoryStore()
        if make == "file":
            return module.FileStore(str(tmp_path / sub))
        return module.ClusterStore([module.InMemoryStore() for _ in range(3)])

    got, want = build(tstore, "t"), build(jstore, "j")
    items = {f"k{i}": np.arange(i) for i in range(25)}
    for store in (got, want):
        store.mset(items)
        store.set("k3", "three")
    keys = [f"k{i}" for i in range(27)]
    assert [repr(v) for v in got.mget(keys)] == [repr(v) for v in want.mget(keys)]
    assert got.num_keys() == want.num_keys() == 25 and got.status() and want.status()
    if make == "cluster":
        assert [s.num_keys() for s in got.stores] == [s.num_keys() for s in want.stores]
    got.clear()
    assert got.num_keys() == 0 and got.get("k1") is None
    with pytest.raises(ValueError, match="at least one backend"):
        ClusterStore([])


@contextlib.contextmanager
def _blob_server():
    from bagua_tpu_torch.distributed.rendezvous import RendezvousState, start_rendezvous_server

    server = start_rendezvous_server(RendezvousState(max_blob_bytes=1 << 20), 0, host="127.0.0.1")
    try:
        yield f"127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()


def native_backends():
    """The two native backends' keyword arguments: an shm segment of this
    process's own name, and the endpoint of a live port rendezvous server.
    Each package's loader runs over the store emptied, in turn."""
    with _blob_server() as endpoint:
        yield "shm", {"name": f"/bagua_torch_cl_{os.getpid()}", "capacity_bytes": 1 << 20}
        yield "rendezvous", {"endpoints": [endpoint]}


def test_cache_loader_and_cached_dataset_match_the_jax_package():
    calls = {"got": [], "want": []}

    def loader(tag):
        return lambda key: calls[tag].append(key) or int(key) * 3

    got, want = CacheLoader(writer_buffer_size=4, dataset_name="d"), jcache_loader.CacheLoader(
        writer_buffer_size=4, dataset_name="d")
    order = [1, 2, 1, 3, 4, 5, 2, 6, 1, 7, 3]
    assert [got.get(str(k), loader("got")) for k in order] == [want.get(str(k), loader("want")) for k in order]
    assert calls["got"] == calls["want"] and got.hit_rate == want.hit_rate
    assert got.num_keys() == want.num_keys()
    for backend, kwargs in native_backends():
        runs = {}
        for tag, module in (("got", CacheLoader), ("want", jcache_loader.CacheLoader)):
            native = module(backend=backend, writer_buffer_size=4, dataset_name="d", **kwargs)
            try:
                native.store.clear()
                calls[tag] = []
                values = [native.get(str(k), loader(tag)) for k in order]
                native.flush()
                runs[tag] = (values, list(calls[tag]), native.hit_rate, native.num_keys())
            finally:
                native.store.clear()
                native.store.shutdown()
        assert runs["got"] == runs["want"]
        assert runs["got"][2] == want.hit_rate and runs["got"][3] == want.num_keys()
        if backend == "shm":
            ShmStore(**kwargs).unlink()
    with pytest.raises(ValueError, match="unknown cache backend"):
        CacheLoader(backend="redis")
    data = imagenet.SyntheticImageNet(n=16, image_size=8, classes=5)
    tcached = CachedDataset(data, writer_buffer_size=3)
    jcached = jcached_dataset.CachedDataset(data, writer_buffer_size=3)
    for i in [0, 5, 0, 9, 5, 15]:
        (gx, gy), (wx, wy) = tcached[i], jcached[i]
        assert np.array_equal(gx, wx) and gy == wy
    assert len(tcached) == 16 and tcached.cache_loader.hit_rate == jcached.cache_loader.hit_rate
    assert isinstance(tcached.cache_loader.store, InMemoryStore)
    assert isinstance(CacheLoader(backend="file").store, FileStore)


def jax_example():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "imagenet",
                        "main.py")
    spec = importlib.util.spec_from_file_location("jax_imagenet_example", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_synthetic_imagenet_is_the_jax_example_s():
    want = jax_example().SyntheticImageNet(n=32, image_size=16, classes=7, seed=2)
    got = imagenet.SyntheticImageNet(n=32, image_size=16, classes=7, seed=2)
    assert len(got) == len(want)
    for i in (0, 7, 31):
        assert np.array_equal(got[i][0], want[i][0]) and got[i][1] == want[i][1]


@pytest.mark.parametrize("arch,algorithm", [("resnet50", "decentralized"), ("resnet50", "gradient_allreduce"),
                                            ("vgg16", "gradient_allreduce")])
def test_main_trains_on_the_cpu(arch, algorithm, capsys):
    loss, seconds = imagenet.main(["--arch", arch, "--algorithm", algorithm, "--device", "cpu", "--ranks", "2",
                                   "--batch-size", "2", "--image-size", "32", "--steps", "2"])
    out = capsys.readouterr().out
    assert np.isfinite(loss) and len(seconds) == 2
    assert "step 0: loss" in out and "cache hit rate" in out and "final loss" in out


def test_build_gives_the_example_s_models():
    params, loss_fn, dp_filter = imagenet.build("resnet50", 32, imagenet.CLASSES, torch.device("cpu"))
    assert set(params) == {"params", "batch_stats"} and dp_filter("['params']['Conv_0']['kernel']")
    assert not dp_filter("['batch_stats']['bn_init']['mean']")
    # ResNet-50 at the example's 100 synthetic classes: 23,712,932 parameters
    assert sum(t.numel() for t in tree_leaves(params["params"])) == 23_712_932
    _, _, vgg_filter = imagenet.build("vgg16", 32, imagenet.CLASSES, torch.device("cpu"))
    assert vgg_filter is None
    with pytest.raises(ValueError, match="unknown arch"):
        imagenet.build("alexnet", 32, 10, torch.device("cpu"))
