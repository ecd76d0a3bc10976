"""The ``gpt_pretrain`` twin (``bagua_tpu_torch.examples.gpt_pretrain``)
against the JAX example's ``main(argv)`` at its small defaults (vocab 128,
hidden 32, 4 heads, 32 tokens, one block a stage, batch 8, 2 microbatches),
for both schedules on five layouts: the example's default pp 2 x tp 2 x
sp 2, pp 2 x sp 2, pp 2 x tp 2, dp 2 x pp 2 and pp 4.

The JAX example runs in-process on the simulated CPU devices; its final
state is read off the jitted step's last outputs.  The twin starts from the
JAX example's initial parameters (built as its ``main`` builds them) and
trains on the same data.

Tolerances: per-step losses within rtol 1e-5 (f32 sums in another order);
after 3 Adam steps every parameter element within 3 lr of JAX's (Adam
moves each element by about lr a step whatever its gradient's size) and
all but 1% of them within 1e-5 (a gradient near zero turns rounding noise
into a step).  The key third of each ``qkv`` bias is held to the first bound
only: its gradient is zero in exact arithmetic (softmax ignores a shift
common to every key), so both packages step it on rounding noise.
"""

import argparse
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from bagua_tpu_torch.communication import BaguaProcessGroup, rank_id
from bagua_tpu_torch.convert import gpt_params_from_jax
from bagua_tpu_torch.examples import gpt_pretrain as gp
from bagua_tpu_torch.utils import tree_flatten_with_names

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
LR = 1e-3
LAYOUTS = {"pp2-sp2": (1, 2, 1, 2), "pp2-tp2": (1, 2, 2, 1), "dp2-pp2": (2, 2, 1, 1), "pp4": (1, 4, 1, 1),
           "pp2-tp2-sp2": (1, 2, 2, 2)}


def jax_example():
    spec = importlib.util.spec_from_file_location("jax_gpt_pretrain_example",
                                                  os.path.join(REPO, "examples", "gpt_pretrain", "main.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def argv(layout, schedule):
    dp, pp, tp, sp = LAYOUTS[layout]
    return ["--dp", str(dp), "--pp", str(pp), "--tp", str(tp), "--sp", str(sp), "--steps", str(STEPS),
            "--schedule", schedule]


def jax_initial(jmod, args):
    """The example's initial parameters, drawn as its ``main`` draws them."""
    cfg, stage, embed, head = jmod.build(args)
    t_local = args.seq // args.sp
    x0 = jnp.zeros((2, t_local, args.hidden), jnp.float32)
    ids0 = jnp.zeros((2, t_local), jnp.int32)
    stages = [stage.init(jax.random.PRNGKey(100 + s), x0)["params"] for s in range(args.pp)]
    return jax.tree.map(np.asarray, {
        "embed": embed.init(jax.random.PRNGKey(0), ids0)["params"],
        "stage": jax.tree.map(lambda *xs: jnp.stack(xs), *stages),
        "head": head.init(jax.random.PRNGKey(1), x0)["params"],
    })


def run_jax(jmod, cli, monkeypatch):
    """``main(argv)``'s losses and its final ``(embed, stacked stages,
    head)``, the jitted step's last outputs."""
    outputs, jit = [], jax.jit

    def recording_jit(fun, *a, **kw):
        compiled = jit(fun, *a, **kw)

        def call(*args):
            out = compiled(*args)
            outputs.append(out)
            return out

        return call

    monkeypatch.setattr(jax, "jit", recording_jit)
    losses = jmod.main(cli)
    monkeypatch.setattr(jax, "jit", jit)
    embed, stage, head = outputs[-1][:3]
    return losses, jax.tree.map(np.asarray, {"embed": embed, "stage": stage, "head": head})


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_twin_matches_jax_example(layout, schedule, monkeypatch):
    jmod = jax_example()
    cli = argv(layout, schedule)
    jargs = argparse.Namespace(**vars(gp.parse_args(cli)))
    initial = jax_initial(jmod, jargs)
    want_losses, want = run_jax(jmod, cli, monkeypatch)

    args = gp.parse_args(cli + ["--device", "cpu"])
    n = args.dp * args.pp * args.tp * args.sp
    spec = gp.mesh_spec(args.dp, args.pp, args.tp, args.sp)
    rows = rank_id(BaguaProcessGroup([torch.device("cpu")] * n, mesh_spec=spec), "pp")
    losses, twin = gp.run(args, params=gpt_params_from_jax(initial, rows))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert losses[-1] < losses[0]

    got = twin.params
    for part in ("embed", "head"):
        for r in range(n):  # replicated: every rank holds JAX's one copy
            for (name, g), w, w0 in zip(tree_flatten_with_names(got[part]), jax.tree.leaves(want[part]),
                                        jax.tree.leaves(initial[part])):
                check_leaf(g[r].detach().numpy(), w, w0, f"{part}{name} rank {r}")
    for r in range(n):  # rank r holds its pp coordinate's stage
        for (name, g), w, w0 in zip(tree_flatten_with_names(got["stage"]), jax.tree.leaves(want["stage"]),
                                    jax.tree.leaves(initial["stage"])):
            check_leaf(g[r].detach().numpy(), w[int(rows[r])], w0[int(rows[r])], f"stage{name} rank {r}")


def check_leaf(got, want, initial, what):
    assert np.abs(want - initial).max() > LR / 2, what  # the steps moved it
    assert np.abs(got - want).max() <= 3 * LR, what
    if what.split(" rank")[0].endswith("['qkv']['bias']"):
        third = got.shape[0] // 3  # (q, k, v): keep q and v
        got, want = np.delete(got, np.s_[third:2 * third]), np.delete(want, np.s_[third:2 * third])
    assert np.mean(np.abs(got - want) > 1e-5 + 1e-5 * np.abs(want)) <= 0.01, what


def test_layouts_and_refusals():
    """The twin's group is the JAX example's mesh: every rank's coordinate on
    each of ``("dp", "pp", "tp", "sp")`` is the JAX device's
    ``lax.axis_index`` on the same mesh, for every layout (the three-axis
    default included).  A ``MeshSpec`` whose size is not the group's
    raises, and so does ``--engine`` with a live pp or sp axis."""
    for layout, sizes in LAYOUTS.items():
        spec = gp.mesh_spec(*sizes)
        n = spec.size
        group = BaguaProcessGroup([torch.device("cpu")] * n, mesh_spec=spec)
        assert group.all_axes == gp.MESH and group.shape == sizes
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(sizes), gp.MESH)
        for axis in gp.MESH:
            index = jax.jit(jax.shard_map(lambda: jax.lax.axis_index(axis)[None], mesh=mesh, in_specs=(),
                                          out_specs=P(gp.MESH), check_vma=False))()
            assert rank_id(group, axis).tolist() == np.asarray(index).ravel().tolist(), (layout, axis)
    with pytest.raises(ValueError, match="needs 8 devices, got 4"):
        BaguaProcessGroup([torch.device("cpu")] * 4, mesh_spec=gp.mesh_spec(1, 2, 2, 2))
    with pytest.raises(ValueError, match="use the default mode for pp/sp"):
        gp.main(["--device", "cpu", "--engine", "--pp", "2", "--sp", "1", "--dp", "4"])
