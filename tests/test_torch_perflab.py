"""The port's modeled step (``bagua_tpu_torch/perflab/``) against the JAX
package's.

* ``step_flops_census`` (FlopCounterMode over one rank's forward and
  backward on ``meta``) equals JAX's ``flops_census`` of the traced step,
  exactly (the same integer FLOPs, products and convolutions), on the MLP
  and on a narrow VGG;
* ``census_wire_bytes`` equals the priced bytes, and the cost bridge (a
  copy) gives JAX's rows and seconds on the same descriptors and the same
  ``CostModel`` (to 1e-12 relative: the same float operations);
* the topology is the H100 ring model: its formulas by hand;
* ``model_step_cell`` composes its fields as the JAX engine does, on a CPU
  engine.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bagua_tpu  # noqa: F401
import bagua_tpu.analysis as jan
import bagua_tpu.perflab.costbridge as jcost
from bagua_tpu.algorithms import build_algorithm as jax_build
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP
from bagua_tpu.models import mlp as jax_mlp
from bagua_tpu.models import vgg as jax_vgg
from bagua_tpu.perflab.compute import flops_census as jax_flops_census
from bagua_tpu.service.planner import AlphaBeta as JaxAlphaBeta
from bagua_tpu.service.planner import CostModel as JaxCostModel

import bagua_tpu_torch.analysis as tan
import bagua_tpu_torch.perflab as perflab
from bagua_tpu_torch.algorithms import build_algorithm
from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.models import mlp
from bagua_tpu_torch.models.vgg import VGG, module_params, vgg_loss_fn
from bagua_tpu_torch.observability.goodput import PEAK_FLOPS_PER_CHIP
from bagua_tpu_torch.service.planner import AlphaBeta, CostModel

N = 8
LAYERS = [64, 128, 128, 64]
BUCKET = 1 << 12
SMALL_VGG = dict(num_classes=10, cfg=(8, "M", 16, "M"), classifier_width=32)


@pytest.fixture()
def tgroup():
    return BaguaProcessGroup([torch.device("cpu")] * N, intra_size=4)


def np_batch(seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(32, LAYERS[0]).astype(np.float32), rng.randn(32, LAYERS[-1]).astype(np.float32)


def jax_engine(group, loss, params, name="gradient_allreduce", **kw):
    ddp = JaxDDP(loss, optax.sgd(0.1), jax_build(name, lr=0.1, **kw), process_group=group,
                 bucket_size_bytes=BUCKET, overlap=False)
    return ddp, ddp.init(params)


def jax_trace(ddp, state, batch):
    return jax.make_jaxpr(ddp._build_sharded("default"))(
        jax.eval_shape(lambda s: s, state), jax.eval_shape(lambda b: b, batch))


def port_engine(group, loss, params, name="gradient_allreduce", overlap=False, **kw):
    ddp = DistributedDataParallel(loss, lambda ps: torch.optim.SGD(ps, lr=0.1), build_algorithm(name, **kw), group,
                                  bucket_size_bytes=BUCKET, overlap=overlap)
    return ddp, ddp.init(params)


# ---------------------------------------------------------------------------
# The FLOP census
# ---------------------------------------------------------------------------


def test_flops_census_matches_jax_on_the_mlp(group, tgroup):
    x, y = np_batch()
    jparams = jax_mlp.init_mlp(jax.random.PRNGKey(0), LAYERS)
    jd, js = jax_engine(group, jax_mlp.mse_loss, jparams)
    want = jax_flops_census(jax_trace(jd, js, (jnp.asarray(x), jnp.asarray(y))))
    jd.shutdown()
    ddp, _ = port_engine(tgroup, mlp.mse_loss, params_from_jax(jax.tree.map(np.asarray, jparams)))
    got = perflab.step_flops_census(ddp, (torch.from_numpy(x), torch.from_numpy(y)))
    assert got == want
    assert got["n_dots"] == 8 and got["n_convs"] == 0


def test_flops_census_matches_jax_on_a_narrow_vgg(group, tgroup):
    rng = np.random.RandomState(0)
    x, y = rng.rand(16, 32, 32, 3).astype(np.float32), (np.arange(16) % 10).astype(np.int32)
    jm = jax_vgg.VGG(**SMALL_VGG)
    jparams = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    jd, js = jax_engine(group, jax_vgg.vgg_loss_fn(jm), jparams)
    want = jax_flops_census(jax_trace(jd, js, (jnp.asarray(x), jnp.asarray(y))))
    jd.shutdown()
    model = VGG(device="cpu", generator=torch.Generator().manual_seed(0), image_size=32, **SMALL_VGG)
    ddp, _ = port_engine(tgroup, vgg_loss_fn(model), module_params(model))
    got = perflab.step_flops_census(ddp, (torch.from_numpy(x), torch.from_numpy(y).long()))
    assert got == want
    assert got["n_convs"] == 5 and got["conv_flops"] > got["dot_flops"] > 0


def test_compute_time_reads_the_h100_peaks():
    assert perflab.compute_time_s(67e12 * 0.3) == pytest.approx(1.0, rel=1e-12)
    assert perflab.compute_time_s(1e12, chip="h100-sxm-bf16", mfu=0.5) == 1e12 / (989e12 * 0.5)
    with pytest.raises(KeyError):
        perflab.compute_time_s(1.0, chip="v5e")
    with pytest.raises(ValueError):
        perflab.compute_time_s(1.0, mfu=0.0)


# ---------------------------------------------------------------------------
# The cost bridge on the same descriptors
# ---------------------------------------------------------------------------

COST = dict(flat=(50e-6, 40e9), intra=(5e-6, 200e9), inter=(30e-6, 20e9), rs=(20e-6, 60e9),
            ag=(25e-6, 70e9), pp=(10e-6, 30e9), qr8=(60e-6, 90e9), qr4=(70e-6, 120e9))


def cost_models():
    return (JaxCostModel(**{k: JaxAlphaBeta(*v) for k, v in COST.items()}, intra_size=4),
            CostModel(**{k: AlphaBeta(*v) for k, v in COST.items()}, intra_size=4))


@pytest.mark.parametrize("name, kw", [("gradient_allreduce", {}), ("gradient_allreduce", dict(wire_precision="int8")),
                                      ("bytegrad", {}), ("zero", {}), ("gradient_allreduce", dict(hierarchical=True))],
                         ids=["allreduce", "int8", "bytegrad", "zero", "hierarchical"])
def test_price_program_matches_jax(group, name, kw):
    x, y = np_batch()
    jd, js = jax_engine(group, jax_mlp.mse_loss, jax_mlp.init_mlp(jax.random.PRNGKey(0), LAYERS), name, **kw)
    try:
        jprog, _ = jan.collect_ir(jd._build_sharded("default"),
                                  (jax.eval_shape(lambda s: s, js), jax.eval_shape(lambda b: b, (x, y))),
                                  dict(group.mesh.shape))
        jcfg = jan.WireModelConfig.from_engine(jd)
    finally:
        jd.shutdown()
    tprog = tan.CollectiveProgram([tan.CollectiveDescriptor(**dataclasses.asdict(d)) for d in jprog.collectives],
                                  dict(jprog.axis_sizes))
    tcfg = tan.WireModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    jcm, tcm = cost_models()
    want, got = jcost.price_program(jprog, jcm, jcfg), perflab.price_program(tprog, tcm, tcfg)
    assert [(r["leg"], r["collectives"], r["wire_bytes"]) for r in got.rows] == \
        [(r["leg"], r["collectives"], r["wire_bytes"]) for r in want.rows]
    for a, b in zip(got.rows, want.rows):
        assert a["seconds"] == pytest.approx(b["seconds"], rel=1e-12)
    assert got.total_wire_bytes == want.total_wire_bytes == perflab.census_wire_bytes(tprog, tcfg)
    assert jcost.census_wire_bytes(jprog, jcfg) == got.total_wire_bytes
    assert got.legs_used == want.legs_used


# ---------------------------------------------------------------------------
# The H100 topology
# ---------------------------------------------------------------------------


def test_topology_ring_formulas():
    topo = perflab.DEFAULT_TOPOLOGY
    nbytes, n = 1 << 26, 8
    lat, bw = topo.ici_lat_hop, topo.ici_bw_chip
    assert perflab.ring_hops(n) == 7 and perflab.ring_hops(1) == 0
    assert perflab.t_collective("allreduce", nbytes, n) == 2 * 7 / 8 * nbytes / bw + 2 * 7 * lat
    for kind in ("allgather", "alltoall", "reducescatter"):
        assert perflab.t_collective(kind, nbytes, n) == 7 / 8 * nbytes / bw + 7 * lat
    assert perflab.t_collective("permute", nbytes, n) == nbytes / bw + lat
    assert perflab.t_collective("allreduce", nbytes, 1) == 0.0
    with pytest.raises(ValueError):
        perflab.t_collective("broadcast", nbytes, n)
    # a data axis across hosts rides the network, a model axis NVLink
    assert perflab.t_axis_collective("allreduce", nbytes, n, "dp") == 2 * 7 / 8 * nbytes / (topo.dcn_bw_host / 8)
    assert perflab.t_axis_collective("allreduce", nbytes, n, "tp") == perflab.t_collective("allreduce", nbytes, n)
    assert perflab.t_axis_collective("permute", nbytes, n, "dp", within_pod=True) == \
        perflab.t_collective("permute", nbytes, n)
    # NVLink 4's 450 GB/s a direction, one 400 Gb/s port a GPU (data sheet)
    assert (topo.ici_bw_chip, topo.dcn_bw_chip(), topo.pod_size) == (450e9, 50e9, 8)
    desc = topo.describe()
    assert "H100" in desc["card"] and desc["nvlink_bw_per_gpu_GBps"] == 450.0
    assert [topo.axis_link(a) for a in ("tp", "sp", "intra", "dp", "fsdp", "inter")] == [
        "nvlink", "nvlink", "nvlink", "network", "network", "network"]


# ---------------------------------------------------------------------------
# The modeled cell
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo, wire, kernels", [
    ("gradient_allreduce", "f32", []),
    ("gradient_allreduce", "int8", ["compress_minmax_uint8", "decompress_minmax_uint8",
                                    "hop_dequant_add_requant(bits=8)"]),
    ("gradient_allreduce", "int4", ["compress_minmax_uint4", "decompress_minmax_uint4",
                                    "hop_dequant_add_requant(bits=4)"]),
    ("zero", "int4", ["compress_minmax_uint4", "decompress_minmax_uint4", "hop_dequant_add_requant(bits=4)"]),
    ("bytegrad", "bytegrad", ["compress_minmax_uint8", "decompress_minmax_uint8", "decompress_reduce_requantize"]),
    ("zero", "bytegrad", ["compress_minmax_uint8", "decompress_minmax_uint8"]),
], ids=["f32", "int8", "int4", "zero-int4", "bytegrad", "zero-bytegrad"])
def test_kernel_basis_names_the_wire_kernels(algo, wire, kernels):
    """Each wire's hand-written kernels (the int4 ring's block codec among
    them): launched on a card, their plain versions elsewhere."""
    for device_type, basis in (("cuda", "cuda"), ("cpu", "plain"), ("meta", "plain")):
        got = perflab.kernel_basis(algo, wire, device_type)
        assert got == {"basis": basis if kernels else "none", "kernels": kernels}


@pytest.mark.parametrize("name, kw, overlap, wire", [("gradient_allreduce", {}, True, "f32"),
                                                      ("gradient_allreduce", dict(wire_precision="int8"), False, "int8"),
                                                      ("bytegrad", {}, True, "bytegrad"),
                                                      ("zero", {}, False, "f32")],
                         ids=["allreduce-overlap", "int8", "bytegrad-overlap", "zero"])
def test_model_step_cell_fields(tgroup, name, kw, overlap, wire):
    x, y = np_batch()
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    params = params_from_jax(jax.tree.map(np.asarray, jax_mlp.init_mlp(jax.random.PRNGKey(0), LAYERS)))
    ddp, state = port_engine(tgroup, mlp.mse_loss, params, name, overlap=overlap, **kw)
    _, tcm = cost_models()
    cell = perflab.model_step_cell(ddp, state, batch, tcm, wire=wire)
    assert cell.verified and cell.findings == []
    assert cell.algo == name and cell.overlap == overlap and cell.wire == wire
    assert cell.modeled_wire_bytes == cell.census_wire_bytes > 0
    assert cell.flops_per_step == perflab.step_flops_census(ddp, batch)["flops"]
    assert cell.compute_ms == pytest.approx(cell.flops_per_step / (PEAK_FLOPS_PER_CHIP["h100-sxm-f32"] * 0.3) * 1e3)
    window = perflab.DEFAULT_TOPOLOGY.overlap_window_frac
    exposed = max(0.0, cell.wire_ms - window * cell.compute_ms) if overlap else cell.wire_ms
    assert cell.exposed_wire_ms == pytest.approx(exposed)
    assert cell.modeled_step_ms == pytest.approx(cell.compute_ms + cell.exposed_wire_ms)
    assert cell.modeled_samples_per_s == pytest.approx(32 / (cell.modeled_step_ms / 1e3))
    assert cell.modeled_goodput_frac == pytest.approx(cell.compute_ms / cell.modeled_step_ms)
    assert sum(leg["wire_bytes"] for leg in cell.leg_breakdown.values()) == cell.census_wire_bytes
    assert cell.mesh == {"inter": 2, "intra": 4} and cell.exchange_axes == ["inter", "intra"]
    basis = cell.kernel_basis
    assert basis["basis"] == ("none" if wire == "f32" else "plain")
    assert ("hop_dequant_add_requant(bits=8)" in basis["kernels"]) == (wire == "int8")
    assert math.isfinite(cell.to_json()["modeled_step_ms"])
    assert perflab.kernel_basis(name, wire, "cuda")["basis"] == ("none" if wire == "f32" else "cuda")
