"""The port's tensor-parallel layers against the JAX package's, on CPU groups.

JAX runs each layer under ``shard_map`` on an ``("tp",)`` mesh of the
conftest's CPU devices with per-rank parameters (``init`` with
``PRNGKey(r)`` for rank r, stacked, ``P("tp")``), as
``tests/test_parallel.py:545-730`` does; the port applies the same stacked
tree (``stacked_params_from_jax``) over a ``[cpu] * tp`` group.  Biases are
set to random values in both (flax initializes them to zero).  Compared:
every rank's output, and the parameter gradients of the summed ranks'
``sum(out ** 2)`` (JAX: each rank's own loss under ``check_vma=False``,
whose transposed ``psum``s and gathers bring the other ranks' cotangents
back, the same sum).

Tolerances: outputs within 2e-5 (rtol and atol), the JAX package's own
bound for fused against unfused; gradients, which reach the hundreds,
within 2e-5 of each leaf's largest magnitude.  The frameworks' f32 dots and
``psum`` sum in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax.sharding import Mesh, PartitionSpec as P

from bagua_tpu.parallel import tensor_parallel as jtp

from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.convert import stacked_params_from_jax
from bagua_tpu_torch.parallel import tensor_parallel as ttp
from bagua_tpu_torch.utils import tree_flatten_with_names, tree_leaves, tree_map

TOL = 2e-5
FUSED = [False, True, "auto"]


def mesh(tp):
    return Mesh(np.array(jax.devices()[:tp]), ("tp",))


def tgroup(tp):
    return BaguaProcessGroup([torch.device("cpu")] * tp)


def per_rank_params(module, x_local, tp, seed=0):
    """flax ``init`` at rank r's local input with ``PRNGKey(r)``; biases set
    to random values.  Returns the per-rank trees as numpy."""
    rng = np.random.RandomState(seed)
    trees = []
    for r in range(tp):
        params = jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(r), x_local)["params"])
        trees.append(jax.tree_util.tree_map_with_path(
            lambda path, a: rng.randn(*a.shape).astype(np.float32)
            if jax.tree_util.keystr(path).endswith("['bias']") else a, params))
    return trees


def jax_run(module, trees, x, tp, x_spec, out_spec):
    """Every rank's output and the gradients of its ``sum(out ** 2)``."""
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *trees)

    def fwd(p, xx):
        return module.apply({"params": jax.tree.map(lambda q: q[0], p)}, xx)

    out = jax.jit(jax.shard_map(lambda p, xx: fwd(p, xx)[None], mesh=mesh(tp),
                                in_specs=(P("tp"), x_spec), out_specs=P("tp"),
                                check_vma=False))(stacked, jnp.asarray(x))
    grads = jax.jit(jax.shard_map(jax.grad(lambda p, xx: jnp.sum(fwd(p, xx) ** 2)), mesh=mesh(tp),
                                  in_specs=(P("tp"), x_spec), out_specs=P("tp"),
                                  check_vma=False))(stacked, jnp.asarray(x))
    return np.asarray(out), jax.tree.map(np.asarray, grads)


def port_run(layer, trees, x_stacked):
    params = tree_map(lambda t: t.requires_grad_(), stacked_params_from_jax(trees))
    out = layer(params, torch.from_numpy(x_stacked))
    (out ** 2).sum().backward()
    return out.detach().numpy(), tree_map(lambda t: t.grad.numpy(), params)


def assert_grads(got, want):
    names = [n for n, _ in tree_flatten_with_names(got)]
    assert names == [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    for name, g, w in zip(names, tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("fused", FUSED)
@pytest.mark.parametrize("tp", [2, 4])
def test_parallel_mlp_matches_jax(tp, fused):
    """``ParallelMLP`` (Column -> tanh GELU -> Row, ``fused`` on the Row) on
    a replicated input: outputs on every rank and parameter gradients."""
    x = np.random.RandomState(10).randn(8, 16).astype(np.float32)
    jmlp = jtp.ParallelMLP(hidden_features=32, out_features=16, tp_size=tp, axis_name="tp",
                           fused=fused)
    trees = per_rank_params(jmlp, jnp.asarray(x), tp)
    want, want_grads = jax_run(jmlp, trees, x, tp, P(), P())
    mlp = ttp.ParallelMLP(16, 32, 16, tp, "intra", fused=fused, group=tgroup(tp), device="cpu")
    got, grads = port_run(mlp, trees, np.stack([x] * tp))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert_grads(grads, want_grads)


class JaxPair(fnn.Module):
    """Row(scatter_output) -> Column(gather_input): the sequence-parallel
    round trip of ``tests/test_parallel.py:679-730``."""

    tp: int
    fused: object
    dtype: object = jnp.float32

    @fnn.compact
    def __call__(self, x):
        y = jtp.RowParallelDense(12, self.tp, "tp", fused=self.fused, scatter_output=True,
                                 dtype=self.dtype)(x)
        return jtp.ColumnParallelDense(8, self.tp, "tp", fused=self.fused, gather_input=True,
                                       dtype=self.dtype)(y)


class PortPair(torch.nn.Module):
    def __init__(self, tp, fused, k_local, dtype=torch.float32):
        super().__init__()
        kw = dict(group=tgroup(tp), device="cpu", dtype=dtype)
        self.RowParallelDense_0 = ttp.RowParallelDense(k_local, 12, tp, "intra", fused=fused,
                                                       scatter_output=True, **kw)
        self.ColumnParallelDense_0 = ttp.ColumnParallelDense(12, 8, tp, "intra", fused=fused,
                                                             gather_input=True, **kw)

    def forward(self, params, x):
        y = self.RowParallelDense_0(params["RowParallelDense_0"], x)
        return self.ColumnParallelDense_0(params["ColumnParallelDense_0"], y)


@pytest.mark.parametrize("fused", FUSED)
@pytest.mark.parametrize("tp", [2, 4])
def test_sequence_parallel_pair_matches_jax(tp, fused):
    """Row(scatter_output) -> Column(gather_input) on a column-sharded input:
    ``matmul_rs`` and ``ag_matmul`` when fused, ``psum`` + slice and
    ``allgather`` + matmul when not."""
    x = np.random.RandomState(12).randn(8, 20).astype(np.float32)
    k_local = 20 // tp
    jpair = JaxPair(tp, fused)
    trees = per_rank_params(jpair, jnp.asarray(x[:, :k_local]), tp)
    want, want_grads = jax_run(jpair, trees, x, tp, P(None, "tp"), P("tp"))
    x_stacked = np.stack(np.split(x, tp, axis=1))
    got, grads = port_run(PortPair(tp, fused, k_local), trees, x_stacked)
    assert got.shape == (tp, 8, 8 // tp)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert_grads(grads, want_grads)


def jax_mp_phases(module, trees, x, tp, x_spec):
    """The ``mp_scope`` phases in the op names of the JAX package's compiled
    forward of ``module``, by logical axis."""
    from bagua_tpu.observability.scope_grammar import hlo_op_labels, parse_mp_label

    stacked = jax.tree.map(lambda *a: jnp.stack(a), *trees)
    fwd = jax.shard_map(lambda p, xx: module.apply({"params": jax.tree.map(lambda q: q[0], p)}, xx)[None],
                        mesh=mesh(tp), in_specs=(P("tp"), x_spec), out_specs=P("tp"), check_vma=False)
    hlo = jax.jit(fwd).lower(stacked, jnp.asarray(x)).compile().as_text()
    out = {}
    for label in hlo_op_labels(hlo)[1].values():
        mp = parse_mp_label(label)
        if mp is not None:
            out.setdefault(mp["axis"], set()).add(mp["phase"])
    return out


@pytest.mark.parametrize("layout", ["mlp", "pair"])
def test_fused_trace_labels_the_jax_mp_phases(tmp_path, layout):
    """A CPU ``ProfilerSession`` capture of the fused layers' forward over tp
    4: ``analyze_trace``'s ``per_scope`` rows carry the ``mp_scope`` axes and
    phases of the JAX package's compiled forward of the same layers
    (``ParallelMLP``: ``rs_ring`` and ``row_allgather``; the
    sequence-parallel pair: ``rs_ring`` and ``ag_ring``), and no ring hop is
    counted as a bucket exchange."""
    from bagua_tpu_torch.observability import ProfilerSession, analyze_trace

    tp = 4
    if layout == "mlp":
        x = np.random.RandomState(10).randn(8, 16).astype(np.float32)
        jmod = jtp.ParallelMLP(hidden_features=32, out_features=16, tp_size=tp, axis_name="tp", fused=True)
        trees, x_spec = per_rank_params(jmod, jnp.asarray(x), tp), P()
        port = ttp.ParallelMLP(16, 32, 16, tp, "intra", fused=True, group=tgroup(tp), device="cpu")
        x_stacked = np.stack([x] * tp)
    else:
        x = np.random.RandomState(12).randn(8, 20).astype(np.float32)
        jmod = JaxPair(tp, True)
        trees, x_spec = per_rank_params(jmod, jnp.asarray(x[:, :20 // tp]), tp), P(None, "tp")
        port = PortPair(tp, True, 20 // tp)
        x_stacked = np.stack(np.split(x, tp, axis=1))
    want = jax_mp_phases(jmod, trees, x, tp, x_spec)
    assert want == ({"tp": {"rs_ring", "row_allgather"}} if layout == "mlp" else {"tp": {"rs_ring", "ag_ring"}})
    params = stacked_params_from_jax(trees)
    with ProfilerSession(str(tmp_path)) as prof:
        port(params, torch.from_numpy(x_stacked))
    out = analyze_trace(prof.trace_path)
    assert {r["axis"]: set(r["phases"]) for r in out["per_scope"]} == want
    assert all(r["spans"] > 0 for r in out["per_scope"])
    assert out["per_bucket"] == [] and out["unattributed"] is None


#: bf16 parity: every element within 2^-5 of its tensor's largest magnitude,
#: 8 bf16 rounding steps (2^-8 relative) there.  Both frameworks round each
#: product and each ring add to bf16, but accumulate the f32 dot products in
#: other orders, so a rounding can go the other way and carry through the
#: following products; a wrong product or ring order misses by O(1).
BF16_TOL = 2.0 ** -5


def test_sequence_parallel_pair_bf16_matches_jax():
    """The fused Row(scatter_output) -> Column(gather_input) pair in bf16 over
    tp 2: every ring step's tile product of bf16 operands is ``x @ w`` in the
    port, as ``matmul_tile_pallas`` sends them to ``jnp.dot`` in the
    reference.  Outputs and parameter gradients in bf16 within BF16_TOL."""
    tp = 2
    x = np.random.RandomState(12).randn(8, 20).astype(np.float32)
    k_local = 20 // tp
    jpair = JaxPair(tp, True, jnp.bfloat16)
    trees = [jax.tree.map(lambda a: np.asarray(a).astype(jnp.bfloat16), t)
             for t in per_rank_params(jpair, jnp.asarray(x[:, :k_local]), tp)]
    want, want_grads = jax_run(jpair, trees, x, tp, P(None, "tp"), P("tp"))
    assert want.dtype == jnp.bfloat16
    params = tree_map(lambda t: t.to(torch.bfloat16).requires_grad_(), stacked_params_from_jax(
        [jax.tree.map(lambda a: a.astype(np.float32), t) for t in trees]))
    out = PortPair(tp, True, k_local, torch.bfloat16)(params, torch.from_numpy(np.stack(np.split(x, tp, axis=1))))
    (out ** 2).sum().backward()
    assert out.dtype == torch.bfloat16 and out.shape == (tp, 8, 8 // tp)
    assert [n for n, _ in tree_flatten_with_names(params)] == \
        [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(want_grads)[0]]
    got = [out.detach()] + [t.grad for t in tree_leaves(params)]
    wants = [want] + jax.tree.leaves(want_grads)
    for g, w in zip(got, wants):
        g, w = g.float().numpy(), np.asarray(w, dtype=np.float32)
        np.testing.assert_allclose(g, w, rtol=0, atol=BF16_TOL * np.abs(w).max())


def test_indivisible_tokens_fall_back_or_raise():
    """6 tokens over tp 4: ``fused=True`` raises, ``"auto"`` takes the psum
    path (equal to ``fused=False``); ``scatter_output`` without a ring raises
    too, as in JAX."""
    tp = 4
    x = np.random.RandomState(11).randn(tp, 6, 16).astype(np.float32)
    gen = torch.Generator().manual_seed(0)

    def run(fused, scatter_output=False):
        layer = ttp.RowParallelDense(16, 12, tp, "intra", fused=fused, scatter_output=scatter_output,
                                     group=tgroup(tp), device="cpu", generator=gen)
        params = {k: v.detach()[None].repeat(tp, *([1] * v.dim())) for k, v in layer.named_parameters()}
        return layer(params, torch.from_numpy(x))

    with pytest.raises(ValueError, match="divide by tp_size"):
        run(True)
    gen.manual_seed(0)
    auto = run("auto")
    gen.manual_seed(0)
    assert torch.equal(auto, run(False))
    with pytest.raises(ValueError, match="scatter_output needs the token count"):
        run(False, scatter_output=True)


def test_axis_checks():
    """The bound axis must have tp_size ranks; the rings need one axis; a
    psum over two axes is the psum over the whole group."""
    x = torch.randn(4, 8, 6)
    layer = ttp.RowParallelDense(6, 4, 4, "intra", group=tgroup(2), device="cpu")
    params = {k: v.detach()[None].repeat(2, *([1] * v.dim())) for k, v in layer.named_parameters()}
    with pytest.raises(ValueError, match="tp_size=4 but bound axes"):
        layer(params, x[:2])
    with pytest.raises(ValueError, match="not an axis of the group"):
        ttp.RowParallelDense(6, 4, 2, "tp", group=tgroup(2), device="cpu")(params, x[:2])
    with pytest.raises(ValueError, match="fused must be"):
        ttp.ColumnParallelDense(6, 4, 2, fused="yes", device="cpu")

    grid = BaguaProcessGroup([torch.device("cpu")] * 4, intra_size=2)
    both = ("inter", "intra")
    params = {k: torch.randn(4, *v.shape) for k, v in layer.named_parameters()}
    for fused in (True, "auto"):
        with pytest.raises(ValueError, match="single mesh axis"):
            ttp.RowParallelDense(6, 4, 4, both, fused=fused, group=grid, device="cpu")(params, x)
    flat = ttp.RowParallelDense(6, 4, 4, "intra", group=tgroup(4), device="cpu")(params, x)
    assert torch.equal(ttp.RowParallelDense(6, 4, 4, both, group=grid, device="cpu")(params, x), flat)


def test_layer_params_match_flax():
    """Names, shapes and initializers: ``kernel`` lecun-normal at the local
    shape, ``bias`` zeros; ``use_bias=False`` has no bias."""
    tp = 4
    col = ttp.ColumnParallelDense(64, 256, tp, device="cpu", generator=torch.Generator().manual_seed(0))
    row = ttp.RowParallelDense(64, 32, tp, use_bias=False, device="cpu")
    assert tuple(col.kernel.shape) == (64, 64) and tuple(col.bias.shape) == (64,)
    assert not col.bias.any() and not hasattr(row, "bias")
    want = jtp.ColumnParallelDense(256, tp).init(jax.random.PRNGKey(0), jnp.zeros((1, 64)))["params"]
    assert abs(float(col.kernel.detach().std()) / float(np.std(want["kernel"])) - 1) < 0.05


def test_psum_transpose_carries_every_tp_rank():
    """Through ``psum`` over 2 tp ranks that hold the same shard, the
    gradient of the summed ranks' losses is 2x one rank's own gradient:
    JAX's transpose of ``psum`` under ``check_vma=False`` is a ``psum``,
    and the port's autograd of the sum gives the same by construction."""
    tp = 2
    rng = np.random.RandomState(5)
    x = rng.randn(3, 8).astype(np.float32)
    w = rng.randn(8, 5).astype(np.float32)
    layer = jtp.RowParallelDense(5, tp, "tp", use_bias=False)
    want = jax.jit(jax.shard_map(
        jax.grad(lambda p, xx: jnp.sum(layer.apply({"params": p}, xx) ** 2)), mesh=mesh(tp),
        in_specs=(P(), P()), out_specs=P(), check_vma=False))({"kernel": jnp.asarray(w)}, jnp.asarray(x))
    y = tp * (x @ w)  # both ranks' partials, equal
    own = x.T @ (2 * y)  # one rank's loss, the other's partial held fixed
    np.testing.assert_allclose(np.asarray(want["kernel"]), tp * own, rtol=1e-5)

    port = ttp.RowParallelDense(8, 5, tp, "intra", use_bias=False, group=tgroup(tp), device="cpu")
    kernel = torch.from_numpy(np.stack([w] * tp)).requires_grad_()
    (port({"kernel": kernel}, torch.from_numpy(np.stack([x] * tp))) ** 2).sum().backward()
    for r in range(tp):
        np.testing.assert_allclose(kernel.grad[r].numpy(), tp * own, rtol=1e-5)
