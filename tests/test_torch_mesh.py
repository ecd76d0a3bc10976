"""Named meshes in the port (``bagua_tpu_torch.mesh.MeshSpec``) against the
JAX package: ``tests/test_mesh_engine.py``'s cases but the static-verifier,
flight-record and per-axis budget arms, replayed on the port, and the
stacked collectives over named axes against JAX's ``shard_map``
collectives.

- ``MeshSpec``: roles, sizes, equality and every error message, case by
  case against the JAX package's own ``MeshSpec``.
- The group: its device count, axes and sizes.
- The engine's and the ``Trainer``'s axis fences (typo, role mismatch,
  hierarchical algorithms at construction and in ``switch_algorithm``).
- ``MeshSpec({"dp": 8})`` is bitwise the legacy 8-rank group
  (``intra_size=1``) for ``gradient_allreduce`` and ZeRO: parameters and
  optimizer state after 3 overlapped steps.
- The four 2-D meshes (``dp 4 x tp 2`` and ``dp 4 x fsdp 2`` under
  ``gradient_allreduce`` and ZeRO) train as JAX's engine does: after 3 SGD
  steps every rank's parameters within 1e-6 + 1e-5 |value| of JAX's (f32
  matmuls summed in another order), and the ranks bitwise replicas.
- The collectives over ``("dp",)``, ``("tp",)``, ``("sp",)``, ``("dp",
  "sp")``, ``("sp", "dp")`` and ``("dp", "fsdp")`` of ``(2, 2, 2)``
  meshes: bitwise JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import bagua_tpu
from bagua_tpu import communication as jcomm
from bagua_tpu.algorithms.gradient_allreduce import GradientAllReduceAlgorithm as JaxGAR
from bagua_tpu.ddp import DistributedDataParallel as JaxDDP
from bagua_tpu.defs import ReduceOp as JaxReduceOp
from bagua_tpu.mesh import MeshSpec as JaxMeshSpec
from bagua_tpu.models.mlp import init_mlp as jax_init_mlp, mse_loss as jax_mse_loss
from bagua_tpu.sharded.algorithm import ZeroAlgorithm as JaxZero

import bagua_tpu_torch
from bagua_tpu_torch import communication as comm
from bagua_tpu_torch.algorithms.bytegrad import ByteGradAlgorithm
from bagua_tpu_torch.algorithms.gradient_allreduce import GradientAllReduceAlgorithm
from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.convert import params_from_jax
from bagua_tpu_torch.ddp import DistributedDataParallel
from bagua_tpu_torch.defs import ReduceOp
from bagua_tpu_torch.mesh import DATA_AXIS_NAMES, MODEL_AXIS_NAMES, MeshSpec
from bagua_tpu_torch.models.mlp import mse_loss
from bagua_tpu_torch.sharded.algorithm import ZeroAlgorithm
from bagua_tpu_torch.sharded.updater import ShardedOptState
from bagua_tpu_torch.trainer import Trainer
from bagua_tpu_torch.utils import tree_leaves

LAYERS = [12, 16, 16, 4]
CPU = torch.device("cpu")


def make_batch(seed=0, n=32):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, LAYERS[0]).astype(np.float32), rng.randn(n, LAYERS[-1]).astype(np.float32))


def torch_batch(batch):
    return tuple(torch.from_numpy(b) for b in batch)


def named(axes) -> BaguaProcessGroup:
    spec = MeshSpec(axes)
    return BaguaProcessGroup([CPU] * spec.size, mesh_spec=spec)


def make_ddp(group, algo=None, optimizer=None, **kw):
    kw.setdefault("bucket_size_bytes", 1 << 9)
    return DistributedDataParallel(mse_loss, optimizer or (lambda ps: torch.optim.SGD(ps, lr=0.1)),
                                   algo or GradientAllReduceAlgorithm(), process_group=group, **kw)


@pytest.fixture
def default_group(monkeypatch):
    """The port's default group: 8 CPU ranks, restored afterwards."""
    monkeypatch.setattr(comm, "_default_group", comm._default_group)
    return comm.init_process_group(devices=[CPU] * 8)


# -- MeshSpec, case by case against the JAX package's -------------------------

SPECS = {
    "dp4-tp2": (({"dp": 4, "tp": 2},), {}),
    "dp4-fsdp2": (({"dp": 4, "fsdp": 2},), {}),
    "explicit": (({"rows": 4, "cols": 2},), {"dp_axis": "rows", "tp_axis": "cols"}),
    "pairs": (([("dp", 2), ("pp", 2), ("tp", 2), ("sp", 1)],), {}),
    "fsdp-kw": (({"a": 2, "b": 4},), {"dp_axis": "a", "fsdp_axis": "b"}),
    "dp8": (({"dp": 8},), {}),
}

BAD_SPECS = {
    "typo dp": (({"dp": 4, "tp": 2},), {"dp_axis": "dpp"}),
    "typo tp": (({"dp": 4, "tp": 2},), {"tp_axis": "pt"}),
    "empty": (({},), {}),
    "duplicate": (([("dp", 4), ("dp", 2)],), {}),
    "non-positive": (({"dp": 0},), {}),
    "two roles": (({"dp": 4, "tp": 2},), {"dp_axis": "tp", "tp_axis": "tp"}),
    "no role": (({"rows": 4, "cols": 2},), {}),
    "no data axis": (({"tp": 8},), {}),
}


@pytest.mark.parametrize("case", sorted(SPECS))
def test_meshspec_roles_and_sizes_match_jax(case):
    args, kw = SPECS[case]
    got, want = MeshSpec(*args, **kw), JaxMeshSpec(*args, **kw)
    for attr in ("names", "sizes", "data_axes", "model_axes", "fsdp_axes", "size", "exchange_size",
                 "shape"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.describe() == want.describe() and repr(got) == repr(want)
    assert got.validate_axis("dp_axis", got.names[0]) == want.validate_axis("dp_axis", want.names[0])
    assert DATA_AXIS_NAMES == bagua_tpu.mesh.DATA_AXIS_NAMES
    assert MODEL_AXIS_NAMES == bagua_tpu.mesh.MODEL_AXIS_NAMES


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_meshspec_errors_match_jax(case):
    """The same ValueError, message for message (typos, malformed specs)."""
    args, kw = BAD_SPECS[case]
    with pytest.raises(ValueError) as want:
        JaxMeshSpec(*args, **kw)
    with pytest.raises(ValueError) as got:
        MeshSpec(*args, **kw)
    assert str(got.value) == str(want.value)


def test_meshspec_equality_and_repr():
    a, b = MeshSpec({"dp": 4, "tp": 2}), MeshSpec({"dp": 4, "tp": 2})
    assert a == b and hash(a) == hash(b)
    assert a != MeshSpec({"dp": 2, "tp": 4})
    assert "dp=4" in repr(a) and "tp=2" in repr(a)
    assert bagua_tpu_torch.MeshSpec is MeshSpec
    with pytest.raises(ValueError) as got:
        MeshSpec({"dp": 4, "tp": 2}).validate_axis("tp_axis", "tpp")
    with pytest.raises(ValueError) as want:
        JaxMeshSpec({"dp": 4, "tp": 2}).validate_axis("tp_axis", "tpp")
    assert str(got.value) == str(want.value)


# -- the group ------------------------------------------------------------------


def test_group_needs_matching_device_count(default_group):
    with pytest.raises(ValueError, match="needs 16 devices"):
        bagua_tpu_torch.new_group(mesh_spec=MeshSpec({"dp": 8, "tp": 2}))
    with pytest.raises(ValueError, match="not both"):
        BaguaProcessGroup([CPU] * 8, intra_size=2, mesh_spec=MeshSpec({"dp": 8}))


def test_group_exposes_mesh_axes(default_group):
    g = bagua_tpu_torch.new_group(mesh_spec=MeshSpec({"dp": 4, "tp": 2}))
    assert g.all_axes == ("dp", "tp")
    assert g.data_axes == ("dp",) and g.model_axes == ("tp",)
    assert g.size == 8 and g.exchange_size == 4 and g.shape == (4, 2)
    assert (g.intra_size, g.inter_size) == (8, 1)
    legacy = BaguaProcessGroup([CPU] * 8, intra_size=4)
    assert legacy.all_axes == legacy.data_axes == ("inter", "intra") and legacy.model_axes == ()
    assert legacy.shape == (2, 4) and legacy.exchange_size == 8
    with pytest.raises(ValueError, match=r"declared mesh axes are \('dp', 'tp'\)"):
        comm.allreduce(torch.zeros(8), ReduceOp.SUM, g, "intra")
    if not torch.cuda.is_available():  # no fallback to the CPU for a named group
        with pytest.raises(RuntimeError, match="no CUDA device"):
            comm.init_process_group(mesh_spec=MeshSpec({"dp": 2}))


def test_default_axes_resolution():
    """``axis=None`` is every axis of the group outside :func:`default_axes`
    (JAX's eager API) and the ambient axes inside it (the engine's step)."""
    g = named({"dp": 4, "tp": 2})
    x = torch.arange(8.0)
    assert comm.allreduce(x, ReduceOp.SUM, g).tolist() == [28.0] * 8
    with comm.default_axes(g.data_axes):
        assert comm.allreduce(x, ReduceOp.SUM, g).tolist() == [12.0, 16.0] * 4
        assert comm.rank_id(g).tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
        assert comm.broadcast(x, 1, g).tolist() == [1.0] * 8  # the eager API spans the group
    assert comm.rank_id(g).tolist() == list(range(8))


# -- engine and Trainer fences ------------------------------------------------------


def test_ddp_typo_axis_kwarg_raises():
    g = named({"dp": 4, "tp": 2})
    with pytest.raises(ValueError, match="none of the declared mesh axes"):
        make_ddp(g, dp_axis="ddp")
    with pytest.raises(ValueError, match="none of the declared mesh axes"):
        make_ddp(g, tp_axis="tpp")
    with pytest.raises(ValueError, match="none of the declared mesh axes"):
        make_ddp(BaguaProcessGroup([CPU] * 8, intra_size=4), dp_axis="dp")


def test_trainer_typo_axis_kwarg_raises():
    g = named({"dp": 4, "tp": 2})
    with pytest.raises(ValueError, match="none of the declared mesh axes"):
        Trainer(mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.1), GradientAllReduceAlgorithm(),
                process_group=g, dp_axis="ddp")
    trainer = Trainer(mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.1), GradientAllReduceAlgorithm(),
                      process_group=g, dp_axis="dp", tp_axis="tp")
    assert trainer.ddp.group is g


def test_ddp_axis_role_mismatch_raises():
    """A declared axis of the wrong role is another bug than a typo, with
    another message: the JAX engine's, word for word."""
    g = named({"dp": 4, "tp": 2})
    jg = bagua_tpu.new_group(mesh_spec=JaxMeshSpec({"dp": 4, "tp": 2}))
    for kw in ({"dp_axis": "tp"}, {"tp_axis": "dp"}, {"fsdp_axis": "tp"}):
        with pytest.raises(ValueError) as got:
            make_ddp(g, **kw)
        with pytest.raises(ValueError) as want:
            JaxDDP(jax_mse_loss, optax.sgd(0.1), JaxGAR(), process_group=jg, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="must name one of its data axes"):
        make_ddp(g, dp_axis="tp")
    with pytest.raises(ValueError, match="must name one of its model axes"):
        make_ddp(g, tp_axis="dp")


def test_hierarchical_fenced_on_named_mesh():
    g = named({"dp": 4, "tp": 2})
    with pytest.raises(ValueError, match="legacy \\(inter, intra\\) mesh"):
        make_ddp(g, algo=GradientAllReduceAlgorithm(hierarchical=True))
    with pytest.raises(ValueError, match="legacy \\(inter, intra\\) mesh"):
        make_ddp(g, algo=ByteGradAlgorithm())  # hierarchical by default
    ddp = make_ddp(named({"dp": 8}))
    state = ddp.init(params_from_jax(jax_init_mlp(jax.random.PRNGKey(0), LAYERS)))
    with pytest.raises(ValueError, match="pass hierarchical=False to switch under a MeshSpec"):
        ddp.switch_algorithm(state, ByteGradAlgorithm(hierarchical=True))
    ddp.switch_algorithm(state, ByteGradAlgorithm(hierarchical=False))
    with pytest.raises(ValueError, match="undefined when model axes are present"):
        tp = make_ddp(g)
        tp.switch_algorithm(tp.init(params_from_jax(jax_init_mlp(jax.random.PRNGKey(0), LAYERS))), "zero")


# -- dp x 1 bitwise parity with the legacy engine -------------------------------------


def _optimizer_tensors(opt):
    opts = (opt.sharded, opt.local) if isinstance(opt, ShardedOptState) else (opt,)
    rows = list(opt.rows) if isinstance(opt, ShardedOptState) else []
    return rows + [v for o in opts if o is not None for st in o.state.values()
                   for v in st.values() if torch.is_tensor(v)]


@pytest.mark.parametrize("algo_cls", [GradientAllReduceAlgorithm, ZeroAlgorithm])
def test_dp1_bitwise_parity_with_legacy_engine(algo_cls):
    """A pure-dp MeshSpec group is the same machine as the legacy 1-D
    group: 3 overlapped steps (SGD with momentum) and the finalize land
    bitwise-identical parameters and optimizer state."""
    params = params_from_jax(jax_init_mlp(jax.random.PRNGKey(0), LAYERS))
    finals = []
    for group in (BaguaProcessGroup([CPU] * 8, intra_size=1), named({"dp": 8})):
        ddp = make_ddp(group, algo=algo_cls(), overlap=True,
                       optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9))
        state = ddp.init(params)
        for s in range(3):
            state, _ = ddp.train_step(state, torch_batch(make_batch(seed=s)))
        state = ddp.finalize_pending_updates(state)
        ddp.shutdown()
        finals.append(tree_leaves(state.params) + _optimizer_tensors(state.optimizer))
    assert len(finals[0]) == len(finals[1]) > len(tree_leaves(params))
    for a, b in zip(*finals):
        assert torch.equal(a, b)


# -- the 2-D meshes against JAX's engine ----------------------------------------------


MESHES_2D = [
    ({"dp": 4, "tp": 2}, "gradient_allreduce"),
    ({"dp": 4, "tp": 2}, "zero"),
    ({"dp": 4, "fsdp": 2}, "gradient_allreduce"),
    ({"dp": 4, "fsdp": 2}, "zero"),
]


@pytest.mark.parametrize("axes,algo", MESHES_2D, ids=[f"{'x'.join(a)}-{b}" for a, b in MESHES_2D])
def test_2d_mesh_trains_as_jax_engine(axes, algo):
    """Both 2-D shapes under both exchange algorithms, overlap on, against
    the JAX engine on the same mesh: the dp average covers the data axes
    only, and the tp/fsdp peers ran the same replicated computation."""
    init = jax_init_mlp(jax.random.PRNGKey(0), LAYERS)
    jg = bagua_tpu.new_group(mesh_spec=JaxMeshSpec(axes))
    jddp = JaxDDP(jax_mse_loss, optax.sgd(0.1), JaxZero() if algo == "zero" else JaxGAR(), process_group=jg,
                  bucket_size_bytes=1 << 9, overlap=True)
    jstate = jddp.init(init)
    g = named(axes)
    ddp = make_ddp(g, algo=ZeroAlgorithm() if algo == "zero" else GradientAllReduceAlgorithm(), overlap=True)
    state = ddp.init(params_from_jax(init))
    for s in range(3):
        batch = make_batch(seed=s)
        jstate, jlosses = jddp.train_step(jstate, tuple(jnp.asarray(b) for b in batch))
        state, losses = ddp.train_step(state, torch_batch(batch))
        np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses).ravel(), rtol=1e-5)
    jstate = jddp.finalize_pending_updates(jstate)
    state = ddp.finalize_pending_updates(state)
    jddp.shutdown()
    ddp.shutdown()
    for got, want, start in zip(tree_leaves(state.params), jax.tree.leaves(jstate.params), jax.tree.leaves(init)):
        want = np.asarray(want)
        assert got.shape[0] == g.size
        assert np.abs(want[0] - np.asarray(start)).max() > 1e-3  # the steps moved it
        for r in range(g.size):
            assert torch.equal(got[r], got[0])
            np.testing.assert_allclose(got[r].numpy(), want[r], rtol=1e-5, atol=1e-6)


# -- the stacked collectives over named axes, against JAX's -------------------------------

MESH_A = {"dp": 2, "tp": 2, "sp": 2}
MESH_B = {"dp": 2, "fsdp": 2, "tp": 2}
COLLECTIVE_AXES = [
    (MESH_A, ("dp",)), (MESH_A, ("tp",)), (MESH_A, ("sp",)), (MESH_A, ("dp", "sp")),
    (MESH_A, ("sp", "dp")), (MESH_B, ("dp", "fsdp")),
]


def _jax_collectives(axes_spec, axis, x):
    """Each rank's results of JAX's in-step collectives over ``axis`` in a
    ``shard_map`` over the mesh: allreduce (SUM, AVG, MAX), reduce-scatter,
    tiled all-gather and all-to-all, ring shifts by 1 and -1, rank_id."""
    names = tuple(axes_spec)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(tuple(axes_spec.values())), names)

    def body(v):
        v = v[0]
        ops = (JaxReduceOp.SUM, JaxReduceOp.AVG, JaxReduceOp.MAX)
        outs = [jcomm.allreduce_inplace(v, op, axis) for op in ops]
        outs += [jcomm.reduce_scatter_inplace(v, JaxReduceOp.SUM, axis),
                 jcomm.allgather_inplace(v, axis, tiled=True),
                 jcomm.alltoall_inplace(v, axis),
                 jcomm.ppermute_shift(v, 1, axis), jcomm.ppermute_shift(v, -1, axis),
                 jnp.broadcast_to(jcomm.rank_id(axis), (1,))]
        return tuple(o[None] for o in outs)

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P(names), out_specs=P(names), check_vma=False))
    return [np.asarray(o) for o in fn(jnp.asarray(x))]


@pytest.mark.parametrize("axes_spec,axis", COLLECTIVE_AXES,
                         ids=[f"{'x'.join(m)}-{'+'.join(a)}" for m, a in COLLECTIVE_AXES])
def test_named_collectives_bitwise_jax(axes_spec, axis):
    """Member index row-major over the axes in the order given, as JAX's
    ``rank_id``.  JAX's ring shift over a tuple out of mesh order (``("sp",
    "dp")``) linearizes the members in mesh order instead (``lax.ppermute``
    flattens the tuple as the mesh does), against its own ``rank_id``; there
    the port's shifts are held to JAX's ``rank_id``: member i receives
    member ``(i - shift) mod n``'s slice."""
    x = np.random.RandomState(1).randn(8, 8, 3).astype(np.float32)
    want = _jax_collectives(axes_spec, axis, x)
    g = named(axes_spec)
    t = torch.from_numpy(x)
    got = [comm.allreduce(t, op, g, axis) for op in (ReduceOp.SUM, ReduceOp.AVG, ReduceOp.MAX)]
    got += [comm.reduce_scatter(t, ReduceOp.SUM, g, axis), comm.allgather(t, g, axis), comm.alltoall(t, g, axis),
            comm.ppermute_shift(t, 1, g, axis), comm.ppermute_shift(t, -1, g, axis),
            comm.rank_id(g, axis)[:, None]]
    names = ["allreduce SUM", "allreduce AVG", "allreduce MAX", "reduce_scatter", "allgather", "alltoall",
             "shift 1", "shift -1", "rank_id"]
    if list(axis) != [a for a in axes_spec if a in axis]:
        member = want[-1].ravel()
        n = int(member.max()) + 1
        coords = np.stack(np.unravel_index(np.arange(8), tuple(axes_spec.values())), 1)
        others = [i for i, a in enumerate(axes_spec) if a not in axis]

        def src(r, shift):
            return next(q for q in range(8) if member[q] == (member[r] - shift) % n
                        and (coords[q, others] == coords[r, others]).all())

        want[6] = x[[src(r, 1) for r in range(8)]]
        want[7] = x[[src(r, -1) for r in range(8)]]
    for name, a, b in zip(names, got, want):
        np.testing.assert_array_equal(a.numpy(), b.astype(a.numpy().dtype), err_msg=name)
