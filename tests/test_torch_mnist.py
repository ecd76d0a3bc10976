"""The MNIST twin (``bagua_tpu_torch.examples.mnist``) against the JAX
package's example (``examples/mnist/main.py``), on the CPU.

``Net`` takes the flax ``Net``'s parameters as they are and gives its
logits within f32 rounding.  Three Adam steps of the engine on the 8-rank
group (``intra_size=4``) against the JAX example's engine: Adam divides
by the gradient's own scale, so an element whose gradient is all rounding
noise can move by up to a step (LR) either way; every element lies within
STEPS x LR, and all but FLIPPED_SHARE of them within a thousandth of that.
"""

import gzip
import importlib.util
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bagua_tpu.algorithms.gradient_allreduce import GradientAllReduceAlgorithm as JaxGAR
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP

from bagua_tpu_torch.algorithms import GlobalAlgorithmRegistry, build_algorithm
from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.examples import mnist
from bagua_tpu_torch.utils import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, LR, STEPS, BATCH = 8, 1e-3, 3, 64
FLIPPED_SHARE = 0.05


def jax_example():
    """The JAX package's example module, loaded from its file."""
    spec = importlib.util.spec_from_file_location("jax_mnist_example", os.path.join(REPO, "examples", "mnist",
                                                                                   "main.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def flax_net():
    ex = jax_example()
    model = ex.Net()
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))["params"]
    return ex, model, jax.tree.map(np.asarray, params)


def test_net_matches_flax(flax_net):
    ex, model, params = flax_net
    xs, _ = mnist.synthetic_mnist(n=16, seed=3)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(xs)))
    net = mnist.Net(device="cpu")
    assert [(n, tuple(p.shape)) for n, p in net.named_parameters()] == \
        [(f"{m}.{leaf}", tuple(params[m][leaf].shape)) for m in sorted(params) for leaf in ("kernel", "bias")]
    flat = {f"{m}.{leaf}": t for m, leaves in params_from_jax(params).items() for leaf, t in leaves.items()}
    got = torch.func.functional_call(net, flat, (torch.from_numpy(xs),))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)


def tiers(got, want, loose, tight):
    d = np.concatenate([np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64)).ravel()
                        for g, w in zip(got, want)])
    return d.max() <= loose and (d > tight).mean() <= FLIPPED_SHARE


def test_adam_steps_match_the_jax_example(flax_net, group):
    ex, model, params = flax_net
    xs, ys = mnist.synthetic_mnist(n=STEPS * BATCH, seed=1)
    batches = [(xs[i * BATCH:(i + 1) * BATCH], ys[i * BATCH:(i + 1) * BATCH]) for i in range(STEPS)]

    def loss_fn(p, batch):  # the JAX example's own
        x, y = batch
        logits = model.apply({"params": p}, x)
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None], axis=1))

    jddp = JaxDDP(loss_fn, optax.adam(LR), JaxGAR(), process_group=group)
    jstate = jddp.init(params)
    for x, y in batches:
        jstate, _ = jddp.train_step(jstate, (jnp.asarray(x), jnp.asarray(y)))

    tgroup = BaguaProcessGroup([torch.device("cpu")] * N, intra_size=4)
    ddp = DistributedDataParallel(mnist.net_loss_fn(mnist.Net(device="cpu")),
                                  lambda ps: torch.optim.Adam(ps, lr=LR), build_algorithm("gradient_allreduce"),
                                  tgroup)
    state = ddp.init(params_from_jax(params))
    for x, y in batches:
        state, losses = ddp.train_step(state, (torch.from_numpy(x), torch.from_numpy(y)))
    got = [t[0].numpy() for t in tree_leaves(state.params)]
    want = jax.tree.leaves(jddp.params_unstacked(jstate))
    assert tiers(got, want, STEPS * LR, STEPS * LR * 1e-3)
    assert not tiers(jax.tree.leaves(params), want, STEPS * LR, STEPS * LR * 1e-3)
    for leaf in tree_leaves(state.params):
        assert all(torch.equal(leaf[0], leaf[r]) for r in range(1, N))


def test_none_leaves_the_ranks_apart():
    """``"none"``: every stage the identity, so each rank trains on its own
    slice; ``gradient_allreduce`` on the same batches keeps them equal."""
    group = BaguaProcessGroup([torch.device("cpu")] * 4, intra_size=2)
    xs, ys = mnist.synthetic_mnist(n=2 * 32, seed=2)
    finals = {}
    for name in ("none", "gradient_allreduce"):
        ddp = DistributedDataParallel(mnist.net_loss_fn(mnist.Net(device="cpu")),
                                      lambda ps: torch.optim.Adam(ps, lr=LR), build_algorithm(name), group)
        assert not ddp.overlap_enabled or name != "none"
        state = ddp.init(mnist.module_params(mnist.Net(device="cpu", generator=torch.Generator().manual_seed(0))))
        for i in range(2):
            state, _ = ddp.train_step(state, (torch.from_numpy(xs[i * 32:(i + 1) * 32]),
                                              torch.from_numpy(ys[i * 32:(i + 1) * 32])))
        finals[name] = tree_leaves(state.params)
    assert all(not torch.equal(leaf[0], leaf[1]) for leaf in finals["none"])
    assert all(torch.equal(leaf[0], leaf[r]) for leaf in finals["gradient_allreduce"] for r in range(4))


@pytest.mark.parametrize("algorithm", sorted(GlobalAlgorithmRegistry._algorithms))
def test_every_registered_algorithm_runs_a_step(capsys, algorithm):
    loss, acc = mnist.main(["--algorithm", algorithm, "--device", "cpu", "--ranks", "4", "--intra-size", "2",
                            "--epochs", "1", "--steps", "1", "--batch-size", "32"])
    out = capsys.readouterr().out
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0
    assert "4096 samples (synthetic)" in out and "epoch 0: loss" in out and "final train-accuracy" in out


def test_data_dir_reads_idx_files(tmp_path, capsys):
    """IDX files the user has, one gzipped and one plain, as the JAX
    example's test writes them; nothing is downloaded."""
    rng = np.random.RandomState(0)
    imgs = (rng.rand(256, 28, 28) * 255).astype(np.uint8)
    labels = rng.randint(0, 10, 256).astype(np.uint8)
    with gzip.open(tmp_path / "train-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, 3) + struct.pack(">III", 256, 28, 28) + imgs.tobytes())
    with open(tmp_path / "train-labels-idx1-ubyte", "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, 1) + struct.pack(">I", 256) + labels.tobytes())
    xs, ys = mnist.real_mnist(str(tmp_path))
    assert xs.shape == (256, 28, 28, 1) and xs.dtype == np.float32 and np.array_equal(ys, labels)
    np.testing.assert_allclose(xs[..., 0], (imgs / 255.0 - 0.1307) / 0.3081, rtol=1e-6)
    loss, _ = mnist.main(["--data-dir", str(tmp_path), "--device", "cpu", "--ranks", "2", "--epochs", "1",
                          "--batch-size", "64"])
    assert "256 samples (real)" in capsys.readouterr().out and np.isfinite(loss)
    with pytest.raises(FileNotFoundError, match="not found"):
        mnist.real_mnist(str(tmp_path / "missing"))
    bad = tmp_path / "bad"
    bad.mkdir()
    with open(bad / "train-images-idx3-ubyte", "wb") as f:
        f.write(struct.pack(">HBB", 0, 9, 1) + struct.pack(">I", 1) + b"\0")
    with pytest.raises(ValueError, match="not a u8 IDX file"):
        mnist._read_idx(str(bad / "train-images-idx3-ubyte"))
