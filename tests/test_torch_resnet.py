"""The port's ResNet (``bagua_tpu_torch.models.resnet``) against the JAX
package's (``bagua_tpu.models.resnet``), on the CPU.

A ResNet of stage sizes ``[1, 1, 1, 1]`` (every block projects), 10
classes, 32x32 images, weights from flax's init (conv kernels HWIO ->
OIHW by ``resnet_params_from_jax``), batch 16 a rank.  At this size the
last stages' BatchNorm sees few values a channel, and flax's fast variance
(``E[x^2] - E[x]^2``) cancels where a channel's variance is small beside
its mean, so f32 rounding is amplified into the earlier gradients: the
JAX package's own f32 gradients sit up to 0.2 of a leaf from its f64 ones
on some batches (XLA:CPU), and three steps
amplify a difference several times each.  The reference is therefore the
JAX package's own function in f64 (``jax.enable_x64``), which does not
depend on the host, and every bound below is a fixed share of it, set
with a margin of 10 or more over the port's measured error in f32 and 2
or more in bf16 (bf16 rounds every product to 2^-8).  Tolerances:

- f64: the logits within 1e-12 of their scale and every gradient within
  1e-9 of its leaf's largest value — the same function, up to f64
  rounding;
- f32: logits within 1e-4 (Frobenius, relative), the loss within 1e-5,
  the gradients' relative errors (each leaf in the Frobenius norm) within
  1e-2 in their root mean square over the leaves; bf16: 0.15, 0.02 and
  0.6 (the JAX package's own bf16 reach 0.034, 0.002 and 0.27);
- ``sync_bn=True`` (8 ranks of 16 images under a ``vmap`` over the ranks,
  and one ``gradient_allreduce`` engine step): the truth is the JAX
  package's ``sync_bn=True`` function in f64 on the global batch of 128
  (its SyncBatchNorm there is batch norm over all of it); logits, the
  ranks' losses and the rank-averaged gradient within the bounds above;
- 3 steps of decentralized SGD (``all`` peers, ``dp_filter`` on
  ``batch_stats``, SGD 0.005 momentum 0.9, 8 ranks): the truth is the
  engine's recurrence in f64 over the JAX package's f64 gradients (each
  rank's gradient at its weights, the weights averaged over the ranks,
  momentum from the average; the JAX engine takes no f64); each leaf of
  the port's engine within 0.1 (f32) or 0.75 (bf16) of that leaf's move
  over the steps, in the Frobenius norm, and the JAX engine's within 0.3
  or 0.75, which ties the recurrence to the JAX engine; the starting
  parameters sit 1.0 away.  ``batch_stats`` leaves stay bitwise where
  they started.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from bagua_tpu.algorithms.decentralized import DecentralizedAlgorithm as JaxDecentralized
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP
from bagua_tpu.models.resnet import ResNet as JResNet
from bagua_tpu.models.resnet import resnet50 as jresnet50
from bagua_tpu.models.resnet import resnet_loss_fn as jresnet_loss_fn

from bagua_tpu_torch.algorithms import DecentralizedAlgorithm
from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.convert import resnet_params_from_jax
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.models._rank_ops import rank_conv2d
from bagua_tpu_torch.models.resnet import ResNet, init_resnet, init_resnet50, resnet_loss_fn
from bagua_tpu_torch.utils import dotted_leaves, tree_flatten_with_names, tree_leaves, tree_map

STAGES, CLASSES, IMAGE, BATCH = [1, 1, 1, 1], 10, 32, 16
N, LR, STEPS = 8, 0.005, 3
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def data(seed=0, n=BATCH):
    rng = np.random.RandomState(seed)
    return rng.randn(n, IMAGE, IMAGE, 3).astype(np.float32), rng.randint(0, CLASSES, n).astype(np.int32)


def flax_variables(model):
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, IMAGE, IMAGE, 3)))
    return jax.tree.map(np.asarray, {"params": v["params"], "batch_stats": v["batch_stats"]})


@functools.lru_cache(maxsize=None)
def _jax_fns(dtype, x64):
    model = JResNet(STAGES, CLASSES, compute_dtype=dtype)
    forward = jax.jit(lambda v, xs: model.apply(v, xs, mutable=["batch_stats"])[0])
    return forward, jax.jit(jax.value_and_grad(jresnet_loss_fn(model)))


def jax_grads(dtype, variables, x, y, x64=False):
    """JAX's logits, loss and gradient tree (OIHW kernels), as numpy f64."""
    with jax.enable_x64(x64):
        forward, value_and_grad = _jax_fns(dtype, x64)
        float_t = jnp.float64 if x64 else jnp.float32
        v = jax.tree.map(lambda a: jnp.asarray(a, float_t), variables)
        xs = jnp.asarray(x, float_t)
        logits = forward(v, xs)
        loss, g = value_and_grad(v, (xs, jnp.asarray(y)))
    leaves = [np.asarray(a, np.float64) for a in jax.tree.leaves(g)]
    leaves = [a.transpose(3, 2, 0, 1) if a.ndim == 4 else a for a in leaves]
    return np.asarray(logits, np.float64), float(loss), leaves


def port_grads(dtype, variables, x, y):
    pdtype = torch.float64 if dtype == torch.float64 else torch.float32
    model = ResNet(STAGES, CLASSES, dtype, device="cpu")
    tv = tree_map(lambda a: a.to(pdtype).requires_grad_(True), resnet_params_from_jax(variables))
    xs = torch.from_numpy(x).to(pdtype)
    logits = torch.func.functional_call(model, dotted_leaves(tv["params"]), (xs,))
    loss = resnet_loss_fn(model)(tv, (xs, torch.from_numpy(y)))
    loss.backward()
    grads = [(leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)).double().numpy()
             for leaf in tree_leaves(tv)]
    return logits.detach().double().numpy(), float(loss.detach()), grads


@pytest.fixture(scope="module")
def reference():
    variables = flax_variables(JResNet(STAGES, CLASSES))
    x, y = data()
    return variables, x, y, jax_grads(jnp.float64, variables, x, y, x64=True)


def test_parameter_tree_matches_flax(reference):
    variables = reference[0]
    port = init_resnet(ResNet(STAGES, CLASSES, device="cpu"))
    want = [(n, (a.shape[3], a.shape[2], a.shape[0], a.shape[1]) if a.ndim == 4 else a.shape)
            for n, a in tree_flatten_with_names(variables)]
    got = [(n, tuple(t.shape)) for n, t in tree_flatten_with_names(port)]
    assert [n for n, _ in got] == [n for n, _ in want]
    assert [s for _, s in got] == [tuple(s) for _, s in want]
    full = init_resnet50(torch.Generator().manual_seed(0), num_classes=1000, device="cpu")[1]
    assert sum(t.numel() for t in tree_leaves(full["params"])) == 25_557_032
    assert sum(t.numel() for t in tree_leaves(full["batch_stats"])) == 53_120
    jfull = jax.eval_shape(lambda: jresnet50(1000).init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    assert [n for n, _ in tree_flatten_with_names(full)] == \
        [n for n, _ in tree_flatten_with_names({"params": jfull["params"], "batch_stats": jfull["batch_stats"]})]


def test_f64_matches_jax(reference):
    variables, x, y, (want_logits, want_loss, want) = reference
    logits, loss, grads = port_grads(torch.float64, variables, x, y)
    assert np.abs(logits - want_logits).max() <= 1e-12 * np.abs(want_logits).max()
    np.testing.assert_allclose(loss, want_loss, rtol=1e-12)
    for (name, _), g, w in zip(tree_flatten_with_names(variables), grads, want):
        assert np.abs(g - w).max() <= 1e-9 * max(np.abs(w).max(), 1e-30), name


#: the bounds against the f64 function: logits, loss, gradients (relative)
ACCURACY = {"f32": (1e-4, 1e-5, 1e-2), "bf16": (0.15, 0.02, 0.6)}
#: each leaf's distance to the f64 trajectory, over its move: port, JAX engine
ENGINE_SHARE = {"f32": (0.1, 0.3), "bf16": (0.75, 0.75)}


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _grad_rms(grads, truth, names):
    return float(np.sqrt(np.mean([_rel(g, t) ** 2 for n, g, t in zip(names, grads, truth)
                                  if "batch_stats" not in n])))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_and_grads_within_bounds_of_the_f64_function(reference, dtype):
    variables, x, y, (ref_logits, ref_loss, ref) = reference
    logits, loss, grads = port_grads(DTYPES[dtype][1], variables, x, y)
    names = [n for n, _ in tree_flatten_with_names(variables)]
    logits_tol, loss_tol, grad_tol = ACCURACY[dtype]
    assert _rel(logits, ref_logits) <= logits_tol
    assert abs(loss - ref_loss) <= loss_tol * abs(ref_loss)
    assert _grad_rms(grads, ref, names) <= grad_tol
    for name, g in zip(names, grads):
        assert "batch_stats" not in name or not g.any(), name


def test_rank_conv2d_stride_is_the_per_rank_loop():
    """Stride 2 under ``vmap``: the same bits as ``F.conv2d`` rank by rank,
    forward and both gradients (the stride reaches ``convolution_backward``
    through the per-rank ops the rule records)."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4, 2, 9, 9, 3, generator=gen)  # NHWC, odd sides
    w = torch.randn(4, 5, 3, 3, 3, generator=gen)  # OIHW
    cot = torch.randn(4, 2, 5, 5, 5, generator=gen)
    xv, wv = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = torch.func.vmap(lambda a, b: rank_conv2d(a.permute(0, 3, 1, 2), b, 1, 2))(xv, wv)
    (y * cot).sum().backward()
    for r in range(4):
        xr, wr = x[r].clone().requires_grad_(True), w[r].clone().requires_grad_(True)
        yr = F.conv2d(xr.permute(0, 3, 1, 2), wr, stride=2, padding=1)
        (yr * cot[r]).sum().backward()
        assert torch.equal(y[r], yr) and torch.equal(xv.grad[r], xr.grad) and torch.equal(wv.grad[r], wr.grad)
    plain = x[0].clone().requires_grad_(True)
    out = rank_conv2d(plain.permute(0, 3, 1, 2), w[0], 3, 2)
    assert torch.equal(out, F.conv2d(x[0].permute(0, 3, 1, 2), w[0], stride=2, padding=3))
    out.sum().backward()
    assert plain.grad.shape == plain.shape


def sync_bn_reference(variables, x, y):
    """The JAX package's ``sync_bn=True`` ResNet in f64 on the whole batch
    (outside ``shard_map`` its SyncBatchNorm is batch norm on what it is
    given, the global batch): logits, each rank's loss on its slice, and
    the gradient of the global mean loss, kernels OIHW."""
    model = JResNet(STAGES, CLASSES, sync_bn=True)
    with jax.enable_x64(True):
        v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        xs = jnp.asarray(x, jnp.float64)
        logits = jax.jit(lambda v, xs: model.apply(v, xs, mutable=["batch_stats"])[0])(v, xs)
        g = jax.jit(jax.grad(jresnet_loss_fn(model)))(v, (xs, jnp.asarray(y)))
    logits = np.asarray(logits, np.float64)
    logp = logits - np.log(np.exp(logits - logits.max(1, keepdims=True)).sum(1, keepdims=True)) - \
        logits.max(1, keepdims=True)
    losses = -logp[np.arange(len(y)), y].reshape(N, -1).mean(1)
    leaves = [np.asarray(a, np.float64) for a in jax.tree.leaves(g)]
    return logits, losses, [a.transpose(3, 2, 0, 1) if a.ndim == 4 else a for a in leaves]


def port_sync_bn_grads(dtype, variables, x, y):
    """The port's ``sync_bn=True`` ResNet over 8 rank-stacked copies under a
    ``vmap`` over the ranks: logits, the ranks' losses, the mean over the
    ranks of each rank's gradient of their summed loss, and each norm's
    ``(mean, var)`` as every rank holds them."""
    from bagua_tpu_torch.contrib.sync_batchnorm import statistics_sink
    from bagua_tpu_torch.models._rank_ops import over_ranks

    tgroup = BaguaProcessGroup([torch.device("cpu")] * N, intra_size=4)
    model = ResNet(STAGES, CLASSES, dtype, sync_bn=True, device="cpu")
    stacked = tree_map(lambda a: a[None].repeat(N, *([1] * a.dim())).requires_grad_(True),
                       resnet_params_from_jax(variables))
    xs = torch.from_numpy(x).reshape(N, -1, *x.shape[1:])
    ys = torch.from_numpy(y).reshape(N, -1)

    def one_rank(v, xr, yr):
        sink = []
        with statistics_sink(sink):
            logits = torch.func.functional_call(model, dotted_leaves(v["params"]), (xr,))
        logp = F.log_softmax(logits, dim=-1)
        return logits, -torch.mean(torch.gather(logp, 1, yr[:, None].long())), [t for st in sink for t in st]

    with over_ranks(tgroup):
        logits, losses, stats = torch.func.vmap(one_rank)(stacked, xs, ys)
    losses.sum().backward()
    grads = [(leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)).double().mean(0).numpy()
             for leaf in tree_leaves(stacked)]
    return (logits.detach().double().reshape(-1, CLASSES).numpy(), losses.detach().double().numpy(), grads,
            [t.detach() for t in stats])


@pytest.fixture(scope="module")
def sync_reference(reference):
    variables = reference[0]
    x, y = data(seed=20, n=N * BATCH)
    return variables, x, y, sync_bn_reference(variables, x, y)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sync_bn_matches_the_f64_function_on_the_global_batch(sync_reference, dtype):
    """``sync_bn=True`` over 8 ranks of 16 images is batch norm over the
    128: logits, the ranks' losses and the rank-averaged gradient within
    the single model's shares of the JAX package's f64 function; every
    norm's statistics the same on every rank (17 norms)."""
    variables, x, y, (ref_logits, ref_losses, ref) = sync_reference
    logits, losses, grads, stats = port_sync_bn_grads(DTYPES[dtype][1], variables, x, y)
    names = [n for n, _ in tree_flatten_with_names(variables)]
    logits_tol, loss_tol, grad_tol = ACCURACY[dtype]
    assert _rel(logits, ref_logits) <= logits_tol
    assert np.abs(losses - ref_losses).max() <= loss_tol * np.abs(ref_losses).max()
    assert _grad_rms(grads, ref, names) <= grad_tol
    assert len(stats) == 2 * 17
    for t in stats:
        assert t.shape[0] == N and torch.equal(t, t[:1].expand_as(t))
        assert t.dtype == DTYPES[dtype][1]


def test_sync_bn_engine_step_is_the_global_batch_s(sync_reference):
    """One f32 ``gradient_allreduce`` step of the engine (SGD 0.005, no
    momentum) moves every rank's parameters by the global batch's gradient:
    within the f32 share of the f64 function's move; one statistics
    collective a norm a step (the mean and the mean of squares stacked), 17
    norms."""
    from bagua_tpu_torch.algorithms import GradientAllReduceAlgorithm
    from bagua_tpu_torch.contrib import sync_batchnorm

    variables, x, y, (_, ref_losses, ref) = sync_reference
    tgroup = BaguaProcessGroup([torch.device("cpu")] * N, intra_size=4)
    model = ResNet(STAGES, CLASSES, torch.float32, sync_bn=True, device="cpu")
    ddp = DistributedDataParallel(resnet_loss_fn(model), lambda ps: torch.optim.SGD(ps, lr=LR),
                                  GradientAllReduceAlgorithm(), tgroup,
                                  dp_filter=lambda n: "batch_stats" not in n)
    state = ddp.init(resnet_params_from_jax(variables))
    start = [t.clone().double().numpy() for t in tree_leaves(state.params)]
    calls = []
    real = sync_batchnorm.allreduce

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    sync_batchnorm.allreduce = counted
    try:
        state, losses = ddp.train_step(state, (torch.from_numpy(x), torch.from_numpy(y)))
    finally:
        sync_batchnorm.allreduce = real
        ddp.shutdown()
    assert len(calls) == 17 and all(c[:2] == (N, 2) for c in calls)
    assert np.abs(losses.double().numpy() - ref_losses).max() <= ACCURACY["f32"][1] * np.abs(ref_losses).max()
    names = [n for n, _ in tree_flatten_with_names(variables)]
    moves = [(p0 - p1.double().numpy()) / LR for p0, p1 in zip(start, tree_leaves(state.params))]
    for name, m in zip(names, moves):
        assert "batch_stats" in name or (m == m[:1]).all(), name
    assert _grad_rms([m[0] for m in moves], ref, names) <= ACCURACY["f32"][2]


def jax_engine(group, variables, batches, dtype):
    """The JAX engine's parameters after the batches (decentralized SGD,
    ``dp_filter`` on ``batch_stats``), kernels OIHW, as numpy f64."""
    model = JResNet(STAGES, CLASSES, compute_dtype=dtype)
    ddp = JaxDDP(jresnet_loss_fn(model), optax.sgd(LR, momentum=0.9), JaxDecentralized(), process_group=group,
                 dp_filter=lambda n: "batch_stats" not in n)
    state = ddp.init(jax.tree.map(jnp.asarray, variables))
    for x, y in batches:
        state, _ = ddp.train_step(state, (jnp.asarray(x), jnp.asarray(y)))
    leaves = [np.asarray(a, np.float64) for a in jax.tree.leaves(state.params)]
    return [a.transpose(0, 4, 3, 1, 2) if a.ndim == 5 else a for a in leaves]


def port_engine(variables, batches, dtype):
    tgroup = BaguaProcessGroup([torch.device("cpu")] * N, intra_size=4)
    model = ResNet(STAGES, CLASSES, dtype, device="cpu")
    ddp = DistributedDataParallel(resnet_loss_fn(model), lambda ps: torch.optim.SGD(ps, lr=LR, momentum=0.9),
                                  DecentralizedAlgorithm(), tgroup, dp_filter=lambda n: "batch_stats" not in n)
    state = ddp.init(resnet_params_from_jax(variables))
    for x, y in batches:
        state, losses = ddp.train_step(state, (torch.from_numpy(x), torch.from_numpy(y)))
    assert torch.isfinite(losses).all()
    return [leaf.double().numpy() for leaf in tree_leaves(state.params)]


def decentralized_truth(variables, batches):
    """Decentralized SGD (``all`` peers) over the JAX model in f64, as the
    JAX engine defines a step: each rank's gradient at its own weights, the
    weights averaged over every rank, SGD with momentum 0.9 from the
    average with the rank's own gradient; ``batch_stats`` stay.  Leaves
    stacked ``(N, ...)``, kernels OIHW."""
    leaves, treedef = jax.tree.flatten(variables)
    weights = [np.repeat(np.asarray(a, np.float64)[None], N, axis=0) for a in leaves]
    momentum = [np.zeros_like(w) for w in weights]
    names = [n for n, _ in tree_flatten_with_names(variables)]
    for x, y in batches:
        grads = []
        for r in range(N):
            tree = jax.tree.unflatten(treedef, [w[r] for w in weights])
            g = jax_grads(jnp.float64, tree, x[r * BATCH:(r + 1) * BATCH], y[r * BATCH:(r + 1) * BATCH],
                          x64=True)[2]
            grads.append([a.transpose(2, 3, 1, 0) if a.ndim == 4 else a for a in g])  # back to HWIO
        for i, name in enumerate(names):
            if "batch_stats" in name:
                continue
            g = np.stack([grads[r][i] for r in range(N)])
            momentum[i] = 0.9 * momentum[i] + g
            weights[i] = weights[i].mean(axis=0, keepdims=True) - LR * momentum[i]
    return [w.transpose(0, 4, 3, 1, 2) if w.ndim == 5 else w for w in weights]


@pytest.fixture(scope="module")
def engine_reference(reference):
    variables = reference[0]
    batches = [data(seed=10 + i, n=N * BATCH) for i in range(STEPS)]
    return variables, batches, decentralized_truth(variables, batches)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decentralized_steps_match_the_jax_engine(engine_reference, group, dtype):
    variables, batches, truth = engine_reference
    jdt, tdt = DTYPES[dtype]
    want = jax_engine(group, variables, batches, jdt)
    got = port_engine(variables, batches, tdt)
    start = [np.asarray(a, np.float64) for a in tree_leaves(resnet_params_from_jax(variables))]
    port_share, jax_share = ENGINE_SHARE[dtype]
    for (name, _), g, w, r, p0 in zip(tree_flatten_with_names(variables), got, want, truth, start):
        if "batch_stats" in name:
            assert np.array_equal(g, w) and np.array_equal(w, np.broadcast_to(p0, w.shape)), name
            continue
        moved = np.linalg.norm(r - p0[None])
        assert np.linalg.norm(g - r) <= port_share * moved, name
        assert np.linalg.norm(w - r) <= jax_share * moved, name
