"""The port's FSDP (``bagua_tpu_torch.parallel.fsdp``) against the JAX
package's, on the same numpy-seeded MLPs, stacks and batches.

The JAX side is ``bagua_tpu.parallel.fsdp.FSDP`` over the 8 simulated
devices (the ``group`` fixture); the port runs ``[cpu] * 8`` (``intra_size
4``), its loss the per-rank MLP loss under ``torch.func.vmap``.  The port's
DDP engine (``gradient_allreduce``) is the second reference, as the JAX
test's.

Tolerances: parameters after the steps within rtol 2e-4 and atol 1e-5 of
JAX's FSDP and of the engine (``tests/test_zero.py:166``'s bound: f32 sums
in another order, four Adam steps).  Under bf16 compute the losses within
rtol 2e-2 of JAX's (each product of a step rounds its operands to bf16,
2^-8 of a value, in both packages, but in another order of sums) and the
master leaves after the steps within 2e-3 of JAX's.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bagua_tpu.communication import ALL_AXES
from bagua_tpu.models import gpt as jg
from bagua_tpu.models import mlp as jax_mlp
from bagua_tpu.parallel import fsdp as jf

from bagua_tpu_torch.algorithms import GradientAllReduceAlgorithm
from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.models import gpt as tg
from bagua_tpu_torch.models import mlp
from bagua_tpu_torch.parallel import fsdp as tf
from bagua_tpu_torch.utils import tree_flatten_with_names, tree_leaves, tree_map

N = 8
LR = 1e-2
PARAM_TOL = dict(rtol=2e-4, atol=1e-5)


@pytest.fixture()
def tgroup():
    return BaguaProcessGroup([torch.device("cpu")] * N, intra_size=4)


def adam(lr=LR):
    return lambda ps: torch.optim.Adam(ps, lr=lr)


def mlp_params(seed, sizes):
    return jax.tree.map(np.asarray, jax_mlp.init_mlp(jax.random.PRNGKey(seed), sizes))


def mlp_batches(seed, n_in, n_out, steps=4, rows=32):
    rng = np.random.RandomState(seed)
    return [(rng.randn(rows, n_in).astype(np.float32), rng.randn(rows, n_out).astype(np.float32))
            for _ in range(steps)]


def run_jax(loss_fn, params, batches, compute_dtype=None, optimizer=None):
    fsdp = jf.FSDP(loss_fn, optimizer or optax.adam(LR), compute_dtype=compute_dtype)
    p, o = fsdp.init(jax.tree.map(jnp.asarray, params))
    losses = []
    for b in batches:
        (p, o), loss = fsdp.train_step(p, o, jax.tree.map(jnp.asarray, b))
        losses.append(float(loss))
    return losses, [np.asarray(x) for x in jax.tree.leaves(p)]


def run_port(group, loss_fn, params, batches, compute_dtype=None):
    fsdp = tf.FSDP(loss_fn, adam(), group, compute_dtype=compute_dtype)
    p, o = fsdp.init(params_from_jax(params))
    losses = []
    for b in batches:
        (p, o), loss = fsdp.train_step(p, o, tuple(map(torch.from_numpy, b)))
        losses.append(float(loss))
    return fsdp, p, o, losses


SHAPES = [(16, 64), (64,), (64, 8), (8,), (6,), (3, 16), (5, 7), (4, 12), (12, 4), (2, 3, 8), ()]


@pytest.mark.parametrize("n", [4, 8])
def test_shard_leaf_spec_matches_jax(n):
    for shape in SHAPES:
        spec = jf.shard_leaf_spec(shape, n)
        want = next((i for i, a in enumerate(spec) if a == ALL_AXES), None)
        assert tf.shard_leaf_spec(shape, n) == want, shape


def test_fsdp_matches_jax_and_ddp(group, tgroup):
    """Four Adam steps of the MLP [16, 64, 8] (every leaf sharded 8 ways):
    the port's FSDP against JAX's and against the port's DDP engine."""
    sizes = [16, 64, 8]
    params = mlp_params(3, sizes)
    batches = mlp_batches(2, sizes[0], sizes[-1])
    _, want = run_jax(jax_mlp.mse_loss, params, batches)

    given = params_from_jax(params)
    fsdp = tf.FSDP(torch.func.vmap(mlp.mse_loss), adam(), tgroup)
    p, o = fsdp.init(given)
    losses = []
    for b in batches:
        (p, o), loss = fsdp.train_step(p, o, tuple(map(torch.from_numpy, b)))
        losses.append(float(loss))
    for g, w in zip(tree_leaves(given), jax.tree.leaves(params)):
        assert np.array_equal(g.numpy(), w)  # the shards are copies: the given tree is untouched
    dims = tf.fsdp_shardings(params, tgroup)
    for (name, shard), d, full in zip(tree_flatten_with_names(p), tree_leaves(dims), jax.tree.leaves(params)):
        assert d is not None and shard.shape[1 + d] * N == full.shape[d], name  # held in rows, not whole
    got = [t.numpy() for t in tree_leaves(fsdp.full_params(p))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **PARAM_TOL)

    ddp = DistributedDataParallel(mlp.mse_loss, adam(), GradientAllReduceAlgorithm(), tgroup)
    state = ddp.init(params_from_jax(params))
    for b in batches:
        state, _ = ddp.train_step(state, tuple(map(torch.from_numpy, b)))
    for g, w in zip(got, tree_leaves(ddp.params_unstacked(state))):
        np.testing.assert_allclose(g, w.numpy(), **PARAM_TOL)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_fsdp_at_rest_bytes(tgroup):
    """A rank holds its rows of every sharded leaf and of its Adam moments,
    and the replicated leaves whole: under total / 4 plus those."""
    sizes = [64, 512, 512, 6]  # the last bias (6,) divides by nothing: replicated
    params = mlp_params(4, sizes)
    fsdp, p, o, _ = run_port(tgroup, torch.func.vmap(mlp.mse_loss), params, mlp_batches(5, 64, 6, steps=1))
    replicated = sum(v.nbytes for v, d in zip(jax.tree.leaves(params), tree_leaves(tf.fsdp_shardings(params, tgroup)))
                     if d is None)
    total = sum(v.nbytes for v in jax.tree.leaves(params))
    per_rank = fsdp.at_rest_bytes(p, o)
    steps = 4 * len(jax.tree.leaves(params))  # Adam's step count, one f32 a leaf
    assert per_rank == 3 * ((total - replicated) // N + replicated) + steps
    assert per_rank < 3 * total / 4 + 3 * replicated
    assert tf.fsdp_shardings(params, tgroup)["layer2"]["b"] is None


class _Products(TorchDispatchMode):
    """The operand types of every matrix product dispatched."""

    def __init__(self):
        super().__init__()
        self.dtypes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm):
            self.dtypes.update(a.dtype for a in args if torch.is_tensor(a) and a.dim() >= 2)
        return func(*args, **(kwargs or {}))


def test_fsdp_mixed_precision_policy(tgroup):
    """``compute_dtype=bf16``: the products run in bf16, the master leaves
    and the Adam moments stay f32, the loss falls, and both follow JAX's
    bf16 FSDP."""
    sizes = [16, 64, 8]
    params = mlp_params(5, sizes)
    batches = mlp_batches(6, sizes[0], sizes[-1], steps=8)
    jlosses, want = run_jax(jax_mlp.mse_loss, params, batches, compute_dtype=jnp.bfloat16)
    fsdp = tf.FSDP(torch.func.vmap(mlp.mse_loss), adam(), tgroup, compute_dtype=torch.bfloat16)
    p, o = fsdp.init(params_from_jax(params))
    losses, products = [], _Products()
    for i, b in enumerate(batches):
        with products if i == 0 else contextlib.nullcontext():
            (p, o), loss = fsdp.train_step(p, o, tuple(map(torch.from_numpy, b)))
        losses.append(float(loss))
    assert products.dtypes == {torch.bfloat16}, products.dtypes
    assert losses[-1] < losses[0], losses
    assert all(t.dtype == torch.float32 for t in tree_leaves(p))
    assert all(t.dtype == torch.float32 for s in o.state.values() for t in s.values() if t.dim())
    np.testing.assert_allclose(losses, jlosses, rtol=2e-2)
    for g, w in zip(tree_leaves(fsdp.full_params(p)), want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-3)


def test_scan_layers_and_fsdp_over_a_scanned_stack(group, tgroup):
    """``scan_layers`` equals the unrolled loop; the FSDP layout shards the
    stack's layer axis; four FSDP steps over the scanned stack equal
    unsharded Adam (the port's own, and JAX's FSDP)."""
    L, D = 8, 16
    rng = np.random.RandomState(7)
    stacked = {"w": (rng.randn(L, D, D) * 0.3).astype(np.float32),
               "b": (rng.randn(L, D) * 0.1).astype(np.float32)}
    x = rng.randn(4, D).astype(np.float32)

    def block(layer, h):
        return torch.tanh(h @ layer["w"] + layer["b"])

    st = params_from_jax(stacked)
    out = tf.scan_layers(block, st, torch.from_numpy(x))
    expect = torch.from_numpy(x)
    for i in range(L):
        expect = block({"w": st["w"][i], "b": st["b"][i]}, expect)
    assert torch.equal(out, expect)
    want_out = jf.scan_layers(lambda layer, h: jax.nn.tanh(h @ layer["w"] + layer["b"]),
                              jax.tree.map(jnp.asarray, stacked), jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-6)
    assert tf.fsdp_shardings(st, tgroup) == {"w": 0, "b": 0}

    batches = [(rng.randn(32, D).astype(np.float32), rng.randn(32, D).astype(np.float32)) for _ in range(4)]

    def loss(params, batch):
        xb, yb = batch
        return torch.mean((tf.scan_layers(block, params, xb) - yb) ** 2)

    def jloss(params, batch):
        xb, yb = batch
        return jnp.mean((jf.scan_layers(lambda layer, h: jax.nn.tanh(h @ layer["w"] + layer["b"]),
                                        params, xb) - yb) ** 2)

    _, want = run_jax(jloss, stacked, batches)
    fsdp, p, _, _ = run_port(tgroup, torch.func.vmap(loss), stacked, batches)
    ref = tree_map(lambda t: t.clone().requires_grad_(), params_from_jax(stacked))
    opt = torch.optim.Adam(tree_leaves(ref), lr=LR)
    for b in batches:
        opt.zero_grad()
        loss(ref, tuple(map(torch.from_numpy, b))).backward()
        opt.step()
    for g, r, w in zip(tree_leaves(fsdp.full_params(p)), tree_leaves(ref), want):
        np.testing.assert_allclose(g.numpy(), r.detach().numpy(), **PARAM_TOL)
        np.testing.assert_allclose(g.numpy(), w, **PARAM_TOL)


def test_fsdp_gpt_step_matches_jax(group, tgroup):
    """Two FSDP SGD steps of a small ``GPTModel`` with ``lm_loss_fn``, 8
    sequences of 16 tokens over 8 ranks (each rank's loss the mean over
    its sequence; their mean the global one), against JAX's FSDP.  SGD, not
    Adam: the key projection's bias has a zero gradient in exact
    arithmetic, which Adam would turn from rounding noise into whole
    steps."""
    cfg = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, max_position_embeddings=16)
    rng = np.random.RandomState(8)
    batches = [rng.randint(0, 64, (8, 16)).astype(np.int32) for _ in range(2)]
    jmodel = jg.GPTModel(jg.GPTConfig(**cfg))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(batches[0]))["params"])
    jlosses, want = run_jax(jg.lm_loss_fn(jmodel), params, batches, optimizer=optax.sgd(0.5))
    model = tg.GPTModel(tg.GPTConfig(**cfg), device="cpu")
    fsdp = tf.FSDP(tg.lm_loss_fn(model), lambda ps: torch.optim.SGD(ps, lr=0.5), tgroup)
    p, o = fsdp.init(params_from_jax(params))
    losses = []
    for ids in batches:
        (p, o), loss = fsdp.train_step(p, o, torch.from_numpy(ids))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    moved = 0.0
    for (name, g), w, w0 in zip(tree_flatten_with_names(fsdp.full_params(p)), want, jax.tree.leaves(params)):
        np.testing.assert_allclose(g.numpy(), w, **PARAM_TOL, err_msg=name)
        moved = max(moved, float(np.abs(w - w0).max()))
    assert moved > 1e-2
