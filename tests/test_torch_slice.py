"""The port's first slice against the JAX package, on an 8-rank CPU group.

Both packages see the same inputs, made with numpy from a seed: the
stacked collectives, the bucket plan, ByteGrad's compressed allreduce, the
VGG model and the training loop.  The JAX side runs on the 8 simulated
devices of ``tests/conftest.py`` (``intra_size=4``); the port runs the same
group as ``[cpu] * 8``.
"""

import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import bagua_tpu
from bagua_tpu.algorithms.bytegrad import ByteGradAlgorithm as JaxByteGrad
from bagua_tpu.algorithms.gradient_allreduce import GradientAllReduceAlgorithm as JaxGAR
from bagua_tpu.bucket import BucketPlan as JaxBucketPlan
from bagua_tpu.communication import ALL_AXES, allgather_inplace, allreduce_inplace, alltoall_inplace
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP
from bagua_tpu.models import mlp as jax_mlp
from bagua_tpu.models.vgg import VGG as FlaxVGG, vgg_loss_fn as flax_vgg_loss_fn

import bagua_tpu_torch
from bagua_tpu_torch.algorithms import Algorithm, ByteGradAlgorithm, GradientAllReduceAlgorithm
from bagua_tpu_torch.bucket import BucketPlan
from bagua_tpu_torch.communication import BaguaProcessGroup, ReduceOp
from bagua_tpu_torch.convert import params_from_jax, stacked_params_from_jax
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.kernels import minmax_uint8
from bagua_tpu_torch.models import mlp
from bagua_tpu_torch.models.vgg import VGG, init_vgg16, vgg_loss_fn
from bagua_tpu_torch.trainer import Trainer
from bagua_tpu_torch.utils import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_VGG = dict(num_classes=10, cfg=(8, "M", 16, "M"), classifier_width=32)


@pytest.fixture()
def tgroup():
    return BaguaProcessGroup([torch.device("cpu")] * 8, intra_size=4)


def per_rank_jax(group, fn, x: np.ndarray) -> np.ndarray:
    """Run ``fn`` on each rank's slice of the stacked ``x`` under shard_map."""
    f = jax.jit(group.shard_map(lambda v: fn(v[0])[None], in_specs=P(ALL_AXES), out_specs=P(ALL_AXES)))
    return np.asarray(f(jnp.asarray(x)))


def small_vgg_params():
    model = FlaxVGG(**SMALL_VGG)
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3), jnp.float32))["params"]
    return model, jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axis", [None, "inter", "intra"])
@pytest.mark.parametrize("op", [ReduceOp.SUM, ReduceOp.AVG])
def test_allreduce_matches_jax(group, tgroup, op, axis):
    """Sums agree to f32 rounding: the port adds the peers left to right,
    XLA in an order of its own."""
    x = np.random.RandomState(0).randn(8, 16, 3).astype(np.float32)
    got = bagua_tpu_torch.allreduce(torch.from_numpy(x), op, tgroup, axis).numpy()
    if axis is None:
        want = np.asarray(bagua_tpu.allreduce(jnp.asarray(x), op=op, comm=group))
    else:
        want = per_rank_jax(group, lambda v: allreduce_inplace(v, op=op, axis=axis), x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    peer = {None: 7, "inter": 4, "intra": 3}[axis]  # in rank 0's collective
    np.testing.assert_array_equal(got[0], got[peer])


@pytest.mark.parametrize("axis", [None, "inter", "intra"])
def test_alltoall_matches_jax(group, tgroup, axis):
    x = np.random.RandomState(1).randn(8, 16, 3).astype(np.float32)
    got = bagua_tpu_torch.alltoall(torch.from_numpy(x), tgroup, axis).numpy()
    if axis is None:
        want = np.asarray(bagua_tpu.alltoall(jnp.asarray(x), comm=group))
    else:
        want = per_rank_jax(group, lambda v: alltoall_inplace(v, axis=axis), x)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("axis", [None, "inter", "intra"])
def test_allgather_matches_jax(group, tgroup, axis):
    x = np.random.RandomState(2).randn(8, 5, 3).astype(np.float32)
    got = bagua_tpu_torch.allgather(torch.from_numpy(x), tgroup, axis).numpy()
    if axis is None:
        want = np.asarray(bagua_tpu.allgather(jnp.asarray(x), comm=group))
    else:
        want = per_rank_jax(group, lambda v: allgather_inplace(v, axis=axis, tiled=True), x)
    np.testing.assert_array_equal(got, want)


def test_init_process_group_needs_cuda(monkeypatch):
    """Without devices it takes the visible CUDA devices, and never drops
    to the CPU when there are none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bagua_tpu_torch.init_process_group()
    g = bagua_tpu_torch.init_process_group([torch.device("cpu")] * 4, intra_size=1)
    assert (g.size, g.inter_size, g.intra_size) == (4, 4, 1)


def test_registry_and_unported_options(tgroup):
    """The registry builds both algorithms by name, the quantized wires
    included; what is not ported yet raises instead of running something
    else, and overlap=True on an algorithm that cannot overlap raises with
    the class and the cause."""
    assert isinstance(Algorithm.init("bytegrad"), ByteGradAlgorithm)
    gar = Algorithm.init("gradient_allreduce", hierarchical=True)
    assert isinstance(gar, GradientAllReduceAlgorithm) and gar.reify(tgroup).hierarchical
    with pytest.raises(KeyError, match="unknown algorithm"):
        Algorithm.init("nonexistent_algo")
    impl = Algorithm.init("gradient_allreduce", wire_precision="int8").reify(tgroup)
    assert impl.wire_precision == "int8" and not impl.holds_bucketized_state
    with pytest.raises(ValueError, match="wire_precision must be one of"):
        GradientAllReduceAlgorithm(wire_precision="int2").reify(tgroup)
    with pytest.raises(ValueError, match="GradientAllReduceAlgorithmImpl keeps per-bucket state"):
        DistributedDataParallel(mlp.mse_loss, torch.optim.SGD,
                                GradientAllReduceAlgorithm(wire_precision="int4"), tgroup, overlap=True)


def test_models_need_cuda_by_default(monkeypatch):
    """The model constructors build on the current CUDA device unless told
    otherwise, and raise without one instead of filling host memory."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    for build in (lambda: mlp.init_mlp(gen, [4, 2]), lambda: VGG(image_size=16, **SMALL_VGG),
                  lambda: init_vgg16(gen, image_size=32, num_classes=10)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    model = VGG(image_size=16, device="cpu", **SMALL_VGG)
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_init_mlp_layout_matches_jax():
    """The port's MLP init gives the JAX package's names, shapes and plan."""
    tparams = mlp.init_mlp(torch.Generator().manual_seed(0), [12, 16, 4], device="cpu")
    jparams = jax.tree.map(np.asarray, jax_mlp.init_mlp(jax.random.PRNGKey(0), [12, 16, 4]))
    assert _layout(BucketPlan.from_tree(tparams, 256, 8)) == _layout(JaxBucketPlan.from_tree(jparams, 256, 8))
    x = torch.from_numpy(np.random.RandomState(0).randn(5, 12).astype(np.float32))
    assert mlp.mlp_apply(tparams, x).shape == (5, 4)


def test_codec_refuses_other_devices():
    """A meta tensor (the static verifier's dry run) takes the plain
    versions, shapes only, counting no launch; the kernels' operand check
    takes CUDA tensors alone."""
    counts = [k.launches for k in minmax_uint8.KERNELS]
    q, mm = minmax_uint8.compress_minmax_uint8(torch.empty((2, 8), device="meta"))
    assert q.is_meta and (q.shape, q.dtype, mm.shape) == ((2, 8), torch.uint8, (2, 2))
    x = minmax_uint8.decompress_minmax_uint8(q, mm)
    q2, mm2 = minmax_uint8.decompress_reduce_requantize(q.reshape(1, 2, 8), mm.reshape(1, 2, 2))
    assert x.shape == (2, 8) and q2.shape == (1, 1, 8) and mm2.shape == (1, 1, 2)
    assert [k.launches for k in minmax_uint8.KERNELS] == counts
    with pytest.raises(ValueError, match="CPU or CUDA"):
        minmax_uint8._cuda_operand(torch.empty((2, 8), device="meta"), torch.float32, 2, "compress")


# ---------------------------------------------------------------------------
# Bucket plans
# ---------------------------------------------------------------------------


def _layout(plan):
    return [
        (spec.numel, spec.dtype, [(s.name, tuple(s.shape), s.dtype, s.offset) for s in spec.slots])
        for spec in plan.specs
    ]


@pytest.mark.parametrize("bucket_bytes", [256, 4096, 10 * 1024 ** 2])
@pytest.mark.parametrize("align", [1, 8])
@pytest.mark.parametrize("model", ["mlp", "vgg"])
def test_bucket_plan_matches_jax(model, align, bucket_bytes):
    if model == "mlp":
        params = jax.tree.map(np.asarray, jax_mlp.init_mlp(jax.random.PRNGKey(0), [12, 16, 4]))
    else:
        params = small_vgg_params()[1]
    want = JaxBucketPlan.from_tree(params, bucket_bytes, align_elems=align)
    got = BucketPlan.from_tree(params_from_jax(params), bucket_bytes, align_elems=align)
    assert _layout(got) == _layout(want)
    for g, w in zip(got.bucketize(params_from_jax(params)), want.bucketize(params)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = got.debucketize(got.bucketize(params_from_jax(params)))
    for a, b in zip(tree_leaves(back), tree_leaves(params_from_jax(params))):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# ByteGrad's compressed allreduce
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hierarchical", [False, True], ids=["flat", "hier"])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 50.0])
def test_compressed_allreduce_matches_jax(group, tgroup, hierarchical, scale):
    """The whole bucket exchange on the same per-rank flats, bitwise: the
    codec is bitwise, and the hierarchical leg's f32 intra sum of 4 peers
    rounds the same in both packages on these inputs."""
    x = (np.random.RandomState(3).randn(8, 8 * 96) * scale).astype(np.float32)
    spec = types.SimpleNamespace(dtype="f32")
    jimpl = JaxByteGrad(hierarchical=hierarchical).reify(group)
    want = per_rank_jax(group, lambda v: jimpl._exchange_flat(v, spec), x)
    timpl = ByteGradAlgorithm(hierarchical=hierarchical).reify(tgroup)
    got = timpl._exchange_flat(torch.from_numpy(x), spec).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    for r in range(1, 8):
        np.testing.assert_array_equal(got[0], got[r])


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


def test_small_vgg_loss_and_grads_match_flax():
    """Loss and gradients of the same small VGG within rtol 1e-5 (f32): the
    convolutions run other algorithms and sum in another order than XLA's."""
    model, params = small_vgg_params()
    rng = np.random.RandomState(4)
    x = rng.rand(4, 16, 16, 3).astype(np.float32)
    y = rng.randint(0, 10, size=(4,)).astype(np.int32)
    loss, grads = jax.value_and_grad(flax_vgg_loss_fn(model))(params, (jnp.asarray(x), jnp.asarray(y)))

    tparams = params_from_jax(params)
    leaves = tree_leaves(tparams)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tloss = vgg_loss_fn(VGG(image_size=16, device="cpu", **SMALL_VGG))(tparams, (torch.from_numpy(x), torch.from_numpy(y)))
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    for g, w in zip(tgrads, jax.tree.leaves(grads)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


def test_one_pass_rank_grads_match_flax():
    """The engine's one backward over all ranks (``vmap`` of the loss over
    rank-stacked parameters, each rank its own copy and its own slice of the
    batch) against each rank's ``jax.value_and_grad``, within the tolerance
    of :func:`test_small_vgg_loss_and_grads_match_flax`."""
    model, params = small_vgg_params()
    ranks = 4
    per_rank = [jax.tree.map(lambda p, r=r: p * np.float32(1 + 0.1 * r), params) for r in range(ranks)]
    rng = np.random.RandomState(7)
    x = rng.rand(ranks * 2, 16, 16, 3).astype(np.float32)
    y = rng.randint(0, 10, size=(ranks * 2,)).astype(np.int32)
    tgroup = BaguaProcessGroup([torch.device("cpu")] * ranks, intra_size=1)
    ddp = DistributedDataParallel(vgg_loss_fn(VGG(image_size=16, device="cpu", **SMALL_VGG)),
                                  torch.optim.SGD, ByteGradAlgorithm(), tgroup)
    losses, grads = ddp._rank_grads(stacked_params_from_jax(per_rank), (torch.from_numpy(x), torch.from_numpy(y)))
    for r in range(ranks):
        batch = (jnp.asarray(x[2 * r:2 * r + 2]), jnp.asarray(y[2 * r:2 * r + 2]))
        loss, want = jax.value_and_grad(flax_vgg_loss_fn(model))(per_rank[r], batch)
        np.testing.assert_allclose(losses[r].item(), float(loss), rtol=1e-5)
        for g, w in zip(tree_leaves(grads), jax.tree.leaves(want)):
            w = np.asarray(w)
            np.testing.assert_allclose(g[r].numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


# ---------------------------------------------------------------------------
# Trainer.fit against the JAX package's DDP
# ---------------------------------------------------------------------------

LR, STEPS = 0.05, 3


def _batches():
    rng = np.random.RandomState(5)
    return [
        (rng.randn(32, 12).astype(np.float32), rng.randn(32, 4).astype(np.float32))
        for _ in range(STEPS)
    ]


def _level_width(trainer, state, batch) -> float:
    """The largest quantization level width ByteGrad meets this step, in
    the gradient's units: over the chunks of each rank's gradient and of
    their mean, cut for n = 8 (flat) and n = 2 (hierarchical: the
    intra sums over 4 ranks are divided by 8 at the end, so their levels
    are no wider than a rank's)."""
    _, grads = trainer.ddp._rank_grads(state.params, batch)
    width = 0.0
    for flat in trainer.ddp.plan.bucketize(grads):
        for n in (2, 8):
            for chunks in (flat.reshape(-1, flat.shape[1] // n), flat.mean(0).reshape(n, -1)):
                width = max(width, float((chunks.amax(1) - chunks.amin(1)).max()) / 255.0)
    return width


@pytest.mark.parametrize(
    "algo", ["gradient_allreduce", "gradient_allreduce_hier", "bytegrad_hier", "bytegrad_flat"]
)
def test_trainer_fit_matches_jax_ddp(group, tgroup, algo):
    jparams = jax_mlp.init_mlp(jax.random.PRNGKey(11), [12, 16, 4])
    if algo.startswith("gradient_allreduce"):
        hier = algo == "gradient_allreduce_hier"
        jalgo, talgo = JaxGAR(hierarchical=hier), GradientAllReduceAlgorithm(hierarchical=hier)
    else:
        hier = algo == "bytegrad_hier"
        jalgo, talgo = JaxByteGrad(hierarchical=hier), ByteGradAlgorithm(hierarchical=hier)
    ddp = JaxDDP(jax_mlp.mse_loss, optax.sgd(LR), jalgo, process_group=group)
    jstate = ddp.init(jparams)
    for x, y in _batches():
        jstate, _ = ddp.train_step(jstate, (jnp.asarray(x), jnp.asarray(y)))

    trainer = Trainer(mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=LR), talgo, tgroup)
    state = trainer.init_state(params_from_jax(jax.tree.map(np.asarray, jparams)))
    width = 0.0
    for x, y in _batches():
        batch = (torch.from_numpy(x), torch.from_numpy(y))
        width = max(width, _level_width(trainer, state, batch))
        state = trainer.fit(state, [batch], n_steps=1)
    assert state.step == STEPS and trainer.losses.shape == (8,)

    for leaf in tree_leaves(state.params):
        for r in range(1, 8):
            assert torch.equal(leaf[0], leaf[r])
    # f32 allreduce: summation order only; ByteGrad: a gradient that differs
    # in its last bit may land one quantization level away, each step.
    atol = 1e-5 if algo.startswith("gradient_allreduce") else STEPS * LR * width
    for got, want in zip(tree_leaves(trainer.ddp.params_unstacked(state)),
                         jax.tree.leaves(ddp.params_unstacked(jstate))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# The port stands alone
# ---------------------------------------------------------------------------


def test_port_imports_no_jax():
    """Importing every module of the port, and the chip smoke script, loads
    neither JAX nor the JAX package; the walk reaches the tensor-parallel
    slice's modules, the synthetic benchmark's twin, ZeRO's modules, the
    decentralized pair, QAdam, the MNIST twin, stale-sync, async model
    average, gradient accumulation, BERT, the differentiable collectives,
    the SQuAD twin, the collectives twin, the MoE layer and its twins,
    ResNet, the contrib data tier, the imagenet twin, the pipeline
    schedules, FSDP, GPT, the gpt_pretrain twin, the named mesh
    (``mesh.py``, a copy of the JAX package's, which imports nothing of
    it), the resilience tier, the checkpoints, the autotune service, the
    launcher and the elastic twin, the static gate (``analysis/``), the
    modeled step (``perflab/``), the gang autopilot, the fleet control
    plane (``fleet/``), the fleet simulator, SyncBatchNorm and the native
    stores and prefetcher, and the process-spanning tier (the group's
    ``torch.distributed`` backing in ``communication.py``, the gang-aware
    ``env.py`` and ``init_from_env``, the gang twin ``examples/gang.py``),
    the fleet gang's worker ``examples/fleet_gang.py`` and the operator
    tools (``tools/``: ``diagnose_hang``, ``perf_doctor``,
    ``export_timeline``, ``fault_injection``) and the CI lanes beside them
    (``static_verify``, ``bench_modeled``, ``benchmark_check``,
    ``moe_check``, ``autotune_real_run``, ``fleet_load``, ``fleet_scale``);
    neither pydantic nor orbax is loaded."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import bagua_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(bagua_tpu_torch.__path__, 'bagua_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'bagua_tpu',\n"
        "                                                     'pydantic', 'orbax')]\n"
        "assert not bad, bad\n"
        "need = ['bagua_tpu_torch.kernels.collective_matmul', 'bagua_tpu_torch.parallel.tensor_parallel',\n"
        "        'bagua_tpu_torch.examples.synthetic_benchmark', 'bagua_tpu_torch.sharded.updater',\n"
        "        'bagua_tpu_torch.models._rank_ops', 'bagua_tpu_torch.algorithms.decentralized',\n"
        "        'bagua_tpu_torch.algorithms.q_adam', 'bagua_tpu_torch.examples.mnist',\n"
        "        'bagua_tpu_torch.algorithms.stale', 'bagua_tpu_torch.algorithms.async_model_average',\n"
        "        'bagua_tpu_torch.algorithms.grad_accumulation', 'bagua_tpu_torch.models.bert',\n"
        "        'bagua_tpu_torch.functional', 'bagua_tpu_torch.examples.squad',\n"
        "        'bagua_tpu_torch.examples.communication_primitives', 'bagua_tpu_torch.parallel.moe.routing',\n"
        "        'bagua_tpu_torch.parallel.moe.layer', 'bagua_tpu_torch.parallel.moe.utils',\n"
        "        'bagua_tpu_torch.models.resnet', 'bagua_tpu_torch.contrib.store',\n"
        "        'bagua_tpu_torch.contrib.cache_loader', 'bagua_tpu_torch.contrib.cached_dataset',\n"
        "        'bagua_tpu_torch.contrib.load_balancing_data_loader', 'bagua_tpu_torch.examples.moe',\n"
        "        'bagua_tpu_torch.examples.bench_moe', 'bagua_tpu_torch.examples.imagenet',\n"
        "        'bagua_tpu_torch.parallel.pipeline', 'bagua_tpu_torch.parallel.fsdp',\n"
        "        'bagua_tpu_torch.models.gpt', 'bagua_tpu_torch.models._layers',\n"
        "        'bagua_tpu_torch.examples.gpt_pretrain', 'bagua_tpu_torch.mesh',\n"
        "        'bagua_tpu_torch.resilience.retry', 'bagua_tpu_torch.resilience.snapshot',\n"
        "        'bagua_tpu_torch.resilience.preemption', 'bagua_tpu_torch.resilience.resume',\n"
        "        'bagua_tpu_torch.checkpoint.checkpointing', 'bagua_tpu_torch.service.bayesian_optimizer',\n"
        "        'bagua_tpu_torch.service.planner', 'bagua_tpu_torch.service.autotune_task_manager',\n"
        "        'bagua_tpu_torch.service.autotune_service', 'bagua_tpu_torch.service.autotune_client',\n"
        "        'bagua_tpu_torch.distributed.rendezvous', 'bagua_tpu_torch.distributed.run',\n"
        "        'bagua_tpu_torch.distributed.baguarun', 'bagua_tpu_torch.examples.elastic_training',\n"
        "        'bagua_tpu_torch.trainer'] + ['bagua_tpu_torch.observability.' + m for m in (\n"
        "        'scope_grammar', 'metrics', 'core', 'annotations', 'tracing', 'flight_recorder', 'telemetry',\n"
        "        'health', 'goodput', 'attribution', 'regression', 'aggregate', 'trace_analysis')] + [\n"
        "        'bagua_tpu_torch.' + m for m in (\n"
        "        'analysis.collective_ir', 'analysis.checks', 'analysis.verify', 'perflab.topology',\n"
        "        'perflab.compute', 'perflab.costbridge', 'perflab.engine', 'autopilot.pricing',\n"
        "        'autopilot.controller', 'autopilot.staleness', 'fleet.wal', 'fleet.control_plane',\n"
        "        'fleet.remediation', 'fleet.shards', 'fleet.server', 'fleet.client', 'perflab.fleetsim',\n"
        "        'contrib.sync_batchnorm', 'contrib.native', 'contrib.shm_store', 'contrib.io_prefetcher',\n"
        "        'contrib.rendezvous_store', 'examples.gang', 'communication', 'env', 'distributed',\n"
        "        'examples.fleet_gang', 'tools.diagnose_hang', 'tools.perf_doctor', 'tools.export_timeline',\n"
        "        'tools.fault_injection', 'tools._lane', 'tools._fleet', 'tools.static_verify',\n"
        "        'tools.bench_modeled', 'tools.benchmark_check', 'tools.moe_check', 'tools.autotune_real_run',\n"
        "        'tools.fleet_load', 'tools.fleet_scale')]\n"
        "assert all(m in sys.modules for m in need), need\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
