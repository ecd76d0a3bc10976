"""Both pretraining twins' engine mode (``--engine``) against the JAX
examples' ``run_engine`` at their small defaults: the DDP engine on a named
``MeshSpec`` mesh, ``dp 4 x tp 2`` under ``gradient_allreduce`` with
overlap (the Row layers' tp ``psum`` under the engine's ``vmap``) and ``dp
4 x fsdp 2`` under ZeRO (a shard's row is the rank's index within ``("dp",
"fsdp")``).

The JAX example runs in-process on the simulated CPU devices; its initial
parameters (the engine's ``init``) and final state (after
``finalize_pending_updates``) are read off its engine, and the twin starts
from the same parameters and trains on the same data.

Tolerances: per-step losses within rtol 1e-5 (f32 sums in another order);
after 3 Adam(W) steps every element of every rank's parameters within 3 lr
of JAX's (Adam moves each element by about lr a step whatever its
gradient's size) and all but 1% of them within 1e-5 + 1e-5 |value| (a
gradient near zero turns rounding noise into a step); GPT's key third of
each ``qkv`` bias, whose gradient is zero in exact arithmetic, is held to
the first bound only.  The engine's per-rank gradients at ``dp 4 x tp 2``
(before the exchange) within 1e-5 of each leaf's largest JAX value: a tp
rule off by the factor tp fails by 0.5 of it.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import bagua_tpu
import bagua_tpu.ddp
from bagua_tpu.models import llama as jl

from bagua_tpu_torch import communication as comm
from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.examples import gpt_pretrain as gp
from bagua_tpu_torch.examples import llama_pretrain as lp
from bagua_tpu_torch.utils import tree_flatten_with_names

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
CPU = torch.device("cpu")
CONFIGS = {
    "dp4-tp2": ["--engine", "--dp", "4", "--tp", "2", "--sp", "1"],
    "dp4-fsdp2-zero": ["--engine", "--dp", "4", "--fsdp", "2", "--tp", "1", "--sp", "1", "--algo", "zero"],
}
TWINS = {"llama": (lp, "llama_pretrain", 3e-3, []), "gpt": (gp, "gpt_pretrain", 1e-3, ["--pp", "1"])}


def jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}_example", os.path.join(REPO, "examples", name,
                                                                                      "main.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def restore_groups(monkeypatch):
    """Both packages' default groups as they were, after the examples set
    theirs."""
    monkeypatch.setattr(bagua_tpu.communication, "_default_group", bagua_tpu.communication._default_group)
    monkeypatch.setattr(comm, "_default_group", comm._default_group)


def run_jax_engine(name, argv, monkeypatch):
    """The JAX example's ``run_engine`` under ``argv``: rank 0's loss a step,
    the engine's initial parameters and its final rank-stacked ones."""
    jmod = jax_example(name)
    seen = {"losses": []}
    cls = bagua_tpu.ddp.DistributedDataParallel
    init, step, finalize = cls.init, cls.train_step, cls.finalize_pending_updates

    def recording_init(self, params=None, **kw):
        seen["initial"] = jax.tree.map(np.asarray, params)
        return init(self, params=params, **kw)

    def recording_step(self, state, batch):
        state, losses = step(self, state, batch)
        seen["losses"].append(float(np.asarray(losses).ravel()[0]))
        return state, losses

    def recording_finalize(self, state):
        state = finalize(self, state)
        seen["final"] = jax.tree.map(np.asarray, state.params)
        return state

    monkeypatch.setattr(cls, "init", recording_init)
    monkeypatch.setattr(cls, "train_step", recording_step)
    monkeypatch.setattr(cls, "finalize_pending_updates", recording_finalize)
    if name == "gpt_pretrain":
        jmod.main(argv)
    else:
        monkeypatch.setattr(sys, "argv", ["main.py"] + argv)
        jmod.main()
    monkeypatch.setattr(cls, "init", init)
    monkeypatch.setattr(cls, "train_step", step)
    monkeypatch.setattr(cls, "finalize_pending_updates", finalize)
    return seen["losses"], seen["initial"], seen["final"]


def check_leaf(name, got, want, initial, lr):
    assert np.abs(want - initial).max() > lr / 2, name  # the steps moved it
    assert np.abs(got - want).max() <= 3 * lr, name
    if name.split(" rank")[0].endswith("['qkv']['bias']"):
        third = got.shape[0] // 3  # (q, k, v): keep q and v
        got, want = np.delete(got, np.s_[third:2 * third]), np.delete(want, np.s_[third:2 * third])
    assert np.mean(np.abs(got - want) > 1e-5 + 1e-5 * np.abs(want)) <= 0.01, name


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("twin", sorted(TWINS))
def test_engine_mode_matches_jax_example(twin, config, monkeypatch, restore_groups):
    module, name, lr, extra = TWINS[twin]
    argv = CONFIGS[config] + extra + ["--steps", str(STEPS)]
    want_losses, initial, want = run_jax_engine(name, argv, monkeypatch)
    args = module.parse_args(argv + ["--device", "cpu"])
    got_losses, state, ddp = module.run_engine(args, CPU, params=params_from_jax(initial))
    assert ddp.group.mesh_spec.names == (("dp", "tp") if config == "dp4-tp2" else ("dp", "fsdp"))
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    got = tree_flatten_with_names(state.params)
    assert len(got) == len(jax.tree.leaves(want))
    for (leaf_name, g), w, w0 in zip(got, jax.tree.leaves(want), jax.tree.leaves(initial)):
        assert g.shape[0] == 8
        for r in range(8):
            assert torch.equal(g[r], g[0]), f"{leaf_name} rank {r}"  # replicas, as in JAX
            check_leaf(f"{leaf_name} rank {r}", g[r].numpy(), w[r], w0, lr)


def _jax_engine_grads(twin, args, params, batch):
    """Each rank's gradient of its own loss on a ``("dp", "tp")`` mesh, as
    the JAX engine's ``shard_map`` takes it (``check_vma=False``): leaves
    ``(8, ...)``."""
    if twin == "gpt":
        _, stage, embed, head = jax_example("gpt_pretrain").build(args)

        def loss_fn(p, b):
            ids, labels = b
            x = stage.apply({"params": p["stage"]}, embed.apply({"params": p["embed"]}, ids))
            logp = jax.nn.log_softmax(head.apply({"params": p["head"]}, x))
            return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], axis=-1))
    else:
        heads = max(2, 2 * args.tp)
        cfg = jl.LlamaConfig(
            vocab_size=64, hidden_size=args.hidden, num_layers=args.layers, num_heads=heads,
            num_kv_heads=heads // 2, intermediate_size=2 * args.hidden, max_position_embeddings=args.seq,
            tp_size=args.tp, tp_axis="tp")
        loss_fn = jl.llama_loss_fn(jl.LlamaModel(cfg))
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("dp", "tp"))
    grads = jax.jit(jax.shard_map(
        lambda p, b: jax.tree.map(lambda g: g[None], jax.grad(loss_fn)(p, b)), mesh=mesh,
        in_specs=(P(), P("dp")), out_specs=P(("dp", "tp")), check_vma=False))(params, batch)
    return jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("twin", sorted(TWINS))
def test_engine_gradients_match_jax_at_dp4_tp2(twin, restore_groups):
    """The engine's per-rank gradients on ``dp 4 x tp 2`` (each rank's loss
    on its dp block, differentiated through the tp collectives' ``vmap``
    rule) against JAX's, leaf by leaf and rank by rank."""
    module, name, _, extra = TWINS[twin]
    args = module.parse_args(CONFIGS["dp4-tp2"] + extra + ["--steps", "1", "--device", "cpu"])
    if twin == "gpt":
        jmod = jax_example("gpt_pretrain")
        _, stage, embed, head = jmod.build(args)
        x0 = jnp.zeros((2, args.seq, args.hidden), jnp.float32)
        jparams = {"embed": embed.init(jax.random.PRNGKey(0), jnp.zeros((2, args.seq), jnp.int32))["params"],
                   "stage": stage.init(jax.random.PRNGKey(100), x0)["params"],
                   "head": head.init(jax.random.PRNGKey(1), x0)["params"]}
        ids, labels = next(gp.batches(args))
        jbatch = (jnp.asarray(ids, jnp.int32), jnp.asarray(labels, jnp.int32))
        batch = (torch.as_tensor(ids), torch.as_tensor(labels))
    else:
        heads = max(2, 2 * args.tp)
        cfg = jl.LlamaConfig(
            vocab_size=64, hidden_size=args.hidden, num_layers=args.layers, num_heads=heads,
            num_kv_heads=heads // 2, intermediate_size=2 * args.hidden, max_position_embeddings=args.seq,
            tp_size=args.tp, tp_axis="tp")
        jparams = jl.LlamaModel(cfg).init(jax.random.PRNGKey(0), jnp.zeros((2, args.seq), jnp.int32))["params"]
        ids = np.random.RandomState(3).randint(0, 64, size=(args.batch, args.seq)).astype(np.int32)
        jbatch, batch = jnp.asarray(ids), torch.as_tensor(ids, dtype=torch.int64)
    want = _jax_engine_grads(twin, args, jparams, jbatch)
    ddp, state = module.engine(args, CPU, params=params_from_jax(jax.tree.map(np.asarray, jparams)))[:2]
    _, grads = ddp._rank_grads(state.params, batch)
    for (leaf_name, g), w in zip(tree_flatten_with_names(grads), jax.tree.leaves(want)):
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-5 * scale + 1e-7, f"{leaf_name}: {err:.3e} of a leaf up to {scale:.3e}"


# ---------------------------------------------------------------------------
# The flight recorder's arms on named meshes (the JAX package's
# tests/test_mesh_engine.py, against the port's captured programs)
# ---------------------------------------------------------------------------

MLP_LAYERS = [12, 16, 16, 4]


def _mesh_engine_step(axes, algo, precision="f32"):
    """One step of the MLP on a named mesh with a flight recorder; the
    group, the engine and the captured program."""
    from bagua_tpu_torch.algorithms import build_algorithm
    from bagua_tpu_torch.ddp import DistributedDataParallel
    from bagua_tpu_torch.mesh import MeshSpec
    from bagua_tpu_torch.models import mlp
    from bagua_tpu_torch.observability import FlightRecorder, Telemetry

    g = comm.BaguaProcessGroup([CPU] * 8, mesh_spec=MeshSpec(axes))
    tel = Telemetry(flight=FlightRecorder(capacity=256, rank=0, world_size=1))
    ddp = DistributedDataParallel(mlp.mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.1),
                                  build_algorithm(algo, wire_precision=precision), g, bucket_size_bytes=1 << 9,
                                  telemetry=tel)
    state = ddp.init(mlp.init_mlp(torch.Generator().manual_seed(0), MLP_LAYERS, device=CPU))
    rng = np.random.RandomState(0)
    batch = (torch.from_numpy(rng.randn(32, MLP_LAYERS[0]).astype(np.float32)),
             torch.from_numpy(rng.randn(32, MLP_LAYERS[-1]).astype(np.float32)))
    ddp.train_step(state, batch)
    (program,) = ddp._flight_programs.values()
    return g, ddp, tel, program


def test_flight_records_carry_data_axes():
    """On dp 4 x tp 2 every exchange record carries ``["dp"]``, and the
    step's per-axis wire census puts the plan's bytes on dp."""
    g, ddp, tel, program = _mesh_engine_step({"dp": 4, "tp": 2}, "gradient_allreduce")
    exchange = [r for r in program if r["phase"] != "hop"]
    assert len(exchange) == ddp.plan.num_buckets
    assert all(r["axes"] == ["dp"] for r in exchange)
    snap = tel.registry.snapshot()
    assert snap["wire_bytes_axis_dp_total"] == ddp.plan.total_bytes()
    assert "wire_bytes_axis_tp_total" not in snap


@pytest.mark.parametrize("axes", [{"dp": 8}, {"dp": 4, "tp": 2}, {"dp": 4, "fsdp": 2}],
                         ids=["dp8", "dp4xtp2", "dp4xfsdp2"])
@pytest.mark.parametrize("algo", ["gradient_allreduce", "zero"])
@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_axis_budget_partition_exact_over_captured_program(axes, algo, precision):
    """The JAX package's property over the port's captured programs
    (gar/zero x f32/int8 x three meshes): the BudgetModel's per-axis wire
    ledger joined from the program covers exactly the mesh's data axes, its
    scalar promise is the ledger's sum, and the settled per-axis
    wire_slowdown split sums bitwise to the scalar component on every
    pricing path, with the port's own planner ``CostModel``."""
    from bagua_tpu_torch.observability import BudgetModel
    from bagua_tpu_torch.service.planner import AlphaBeta, CostModel

    g, ddp, tel, program = _mesh_engine_step(axes, algo, precision)
    legs = {ax: AlphaBeta(0.0, 1e8 * (i + 1)) for i, ax in enumerate(g.data_axes)}
    cm = CostModel(flat=AlphaBeta(0.0, 1e9), axis_legs=legs)
    model = BudgetModel(compute_ms=6.0, cost_model=cm, program=program)
    assert set(model.axis_wire_ms) == set(g.data_axes)
    assert all(v > 0 for v in model.axis_wire_ms.values())
    assert model.wire_ms == sum(model.axis_wire_ms[ax] for ax in sorted(model.axis_wire_ms))

    def assert_exact(budget):
        assert set(budget.wire_axis_ms) == set(g.data_axes)
        assert budget.components["wire_slowdown"] == sum(budget.wire_axis_ms[ax] for ax in sorted(budget.wire_axis_ms))
        assert budget.axis_partition_error_ms() == 0.0

    # path 1: per-axis measured wire
    model.note_wire(sum(model.axis_wire_ms.values()) * 2.0,
                    by_axis={ax: ms * 2.0 for ax, ms in model.axis_wire_ms.items()})
    assert_exact(model.settle(0, 20.0))
    # path 2: scalar measured wire, split by the ledger's expected shares
    model.note_wire(model.wire_ms * 3.0)
    assert_exact(model.settle(1, 20.0))
    # path 3: per-axis byte census over the program's own traffic
    census = {ax: 0.0 for ax in g.data_axes}
    for rec in program:
        rec_axes = [a for a in (rec.get("axes") or ()) if a]
        if rec_axes and rec.get("nbytes"):
            for ax in rec_axes:
                census[ax] += float(rec["nbytes"]) / len(rec_axes)
    assert all(v > 0 for v in census.values())
    base = model.expected()
    for step in range(2, 7):
        model.settle(step, base, wire_bytes_by_axis=dict(census))
    inflated = dict(census)
    inflated[sorted(inflated)[-1]] *= 2.0
    assert_exact(model.settle(7, base + 4.0, wire_bytes_by_axis=inflated))
    # the engine's own census: the step event's per-axis bytes are the
    # program's (each record's bytes split evenly over its axes); on the f32
    # allreduce that is the plan's bytes (ZeRO adds its gather's, the ring
    # its hops' wire bytes)
    snap = tel.registry.snapshot()
    got = sum(snap[f"wire_bytes_axis_{ax}_total"] for ax in g.data_axes)
    assert got == sum(int(census[ax]) for ax in g.data_axes)
    if algo == "gradient_allreduce" and precision == "f32":
        assert got == ddp.plan.total_bytes()
