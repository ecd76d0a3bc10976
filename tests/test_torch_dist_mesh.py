"""Model axes on groups that span OS processes: gloo gangs on the CPU.

(a) Every differentiable collective of ``bagua_tpu_torch/communication.py``
across processes (``tests/torch_dist_workers.py vjps``), in the three
``LAYOUTS`` of ``tests/test_torch_dist_collectives.py``: each process's
vector-Jacobian product rows (a seeded cotangent with zeros of both signs)
bitwise the single-controller group's autograd over the whole stack, for
every axis choice, and, since the single controller runs the same
backward, also within 1e-5 of autograd through each collective written out
with plain tensor ops in the worker file (``torch.roll``, index and zero,
transpose and reshape, ``expand``, ``sum``: shifts, permutations,
all-to-all, allgather, allreduce and reduce-scatter SUM and AVG,
broadcast, the user API's reducescatter, gather and scatter); MAX, MIN,
PRODUCT and the bitwise ops raise on an input that requires grad.  The fault this slice repaired: the gradient of
``allgather(x).sum()`` in a two-process gang reaches ``x``.

(b) The pretraining twins as launcher-style gangs (``examples/gang.py``,
one spawn a layout running its cases in turn), each process feeding its
ranks' rows: ``small-llama`` through the engine at dp 2 x tp 2 (fused and
unfused) at W 4 x k 1 and W 2 x k 2; the Llama twin's hand-scheduled
tp 2 x sp 2 zigzag at W 2 x k 2; the GPT twin at pp 2 x sp 2 under 1F1B
and GPipe at W 2 x k 2.  Tolerance: none; every process's parameters are
bitwise the single-controller run's rows (``gang.run_case`` on one thread,
as each worker runs).

(c) FSDP, MoE over ``ep`` (every rank), the small ResNet with
``sync_bn=True`` and ``new_group`` of some ranks, at W 2 x k 2
(``torch_dist_workers.py model_axes``, each process against the stacked
group in-process), bitwise; a rank list against ``new_group``'s rule
raises.

Also on the single controller: small-llama with its Row projections fused
(``tp_fused``) against the unfused model at tp 2 and tp 2 x sp 2, losses
and gradients within the fused-against-unfused tolerance.

(d) One anchor to the JAX package: the W 2 x k 2 gang's ``small-llama`` dp
2 x tp 2 engine run, started from the JAX example's initial parameters,
against the JAX example's ``run_engine`` within
``tests/test_torch_mesh_engine.py``'s bound (every element within 3 lr,
all but 1% within 1e-5 + 1e-5 |value|).

(e) ``distributed.init_from_env(devices, mesh_spec=)`` outside a gang and
in a two-process gang, and ``mesh_group`` outside one.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bagua_tpu_torch.communication import BaguaProcessGroup
from bagua_tpu_torch.examples import gang
from bagua_tpu_torch.mesh import MeshSpec

from helpers import REPO_ROOT, free_port, spawn_and_collect, worker_env

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_workers import LAYOUTS, MODEL_AXES, VJPS  # noqa: E402

WORKERS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dist_workers.py")
GANG = os.path.join(REPO_ROOT, "bagua_tpu_torch", "examples", "gang.py")
CPU = torch.device("cpu")


@pytest.fixture()
def one_thread():
    """The stacked reference computes on one thread, as each gang worker
    does (a CPU reduction's order may depend on the thread count)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def spawn_workers(job, W, out, *args, timeout=240):
    port = str(free_port())
    outs = spawn_and_collect([[sys.executable, WORKERS, job, str(p), port, out, *args] for p in range(W)],
                             worker_env(OMP_NUM_THREADS="1"), timeout=timeout)
    for code, stdout, stderr in outs:
        assert code == 0, f"{job} worker failed:\n{stdout}\n{stderr[-4000:]}"
    return [json.load(open(f"{out}.proc{p}.json")) for p in range(W)]


def spawn_gang(W, args, out, timeout=240, **env):
    """``gang.py`` as W processes of a gloo gang (the launcher's
    environment); returns each process's reports."""
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, GANG, "--device", "cpu", "--report", out] + args,
                              env=worker_env(OMP_NUM_THREADS="1", RANK=str(p), LOCAL_RANK=str(p), WORLD_SIZE=str(W),
                                             MASTER_ADDR="127.0.0.1", MASTER_PORT=port, **env),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for p in range(W)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [json.load(open(f"{out}.proc{p}.json")) for p in range(W)]


# -- (a) the collectives' gradients ------------------------------------------------------


@pytest.fixture(scope="module")
def vjp_reports(tmp_path_factory):
    done = {}

    def get(layout):
        if layout not in done:
            out = str(tmp_path_factory.mktemp(f"vjp-{layout}") / "r")
            done[layout] = spawn_workers("vjps", LAYOUTS[layout][0], out, layout)
        return done[layout]
    return get


@pytest.mark.parametrize("name", VJPS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_collective_vjp_rows_are_the_stacked_groups(vjp_reports, layout, name):
    for p, report in enumerate(vjp_reports(layout)):
        assert report[name] == [], f"process {p}: {report[name][:5]}"


def test_allgather_gradient_reaches_the_input_across_two_processes(vjp_reports):
    """The gradient of ``allgather(x).sum()`` in a two-process gang: every
    element of ``x`` is gathered by each of the n members, so its gradient
    is n (a collective that viewed its payload as bytes returned no
    gradient path and left ``x.grad`` None)."""
    layout = "W2k4-intra4"
    assert LAYOUTS[layout][0] == 2
    for report in vjp_reports(layout):
        assert report["allgather_sum_grad"] == {"grad_is_none": False, "values": [8.0]}


# -- (b) the twins through gang.py ----------------------------------------------------------

ENGINE_CASES = {"unfused": ["gradient_allreduce", {}, "auto"],
                "fused": ["gradient_allreduce", {"tp_fused": True}, "auto"]}
GANG_STEPS = ["--warmup", "1", "--steps", "2"]


@pytest.fixture(scope="module")
def llama_engine_gangs(tmp_path_factory):
    """small-llama's engine at dp 2 x tp 2, both cases, per layout: W 4 x
    k 1 and W 2 x k 2 (the latter also saving its parameters and run from
    the JAX example's initial ones, for (d))."""
    done = {}

    def get(W):
        if W not in done:
            d = tmp_path_factory.mktemp(f"llama-engine-W{W}")
            done[W] = spawn_gang(W, ["--model", "small-llama", "--mesh", json.dumps({"dp": 2, "tp": 2}),
                                     "--cases", json.dumps(list(ENGINE_CASES.values()))] + GANG_STEPS,
                                 str(d / "r"))
        return done[W]
    return get


def stacked_twin(model, mesh, case):
    algorithm, kwargs, overlap = case
    return gang.run_case(BaguaProcessGroup([CPU] * MeshSpec(mesh).size, mesh_spec=MeshSpec(mesh)), model,
                         algorithm, kwargs, overlap, steps=2, warmup=1)


def assert_rows(reports, i, ref):
    k = reports[0][i]["local_ranks"]
    for p, r in enumerate(reports):
        assert r[i]["processes"] == len(reports)
        assert r[i]["digests"] == ref["digests"][p * k:(p + 1) * k], f"process {p}"
        assert r[i]["launches"] == ref["launches"]


@pytest.mark.parametrize("case", list(ENGINE_CASES))
@pytest.mark.parametrize("W", [4, 2])
def test_small_llama_engine_dp2_tp2_gang_is_bitwise(llama_engine_gangs, W, case, one_thread):
    reports = llama_engine_gangs(W)
    i = list(ENGINE_CASES).index(case)
    assert reports[0][i]["local_ranks"] == 4 // W and reports[0][i]["overlap"]
    assert_rows(reports, i, stacked_twin("small-llama", {"dp": 2, "tp": 2}, ENGINE_CASES[case]))


def test_llama_tp2_sp2_zigzag_gang_is_bitwise(tmp_path, one_thread):
    mesh, case = {"dp": 1, "tp": 2, "sp": 2}, ["stacked", {}, "auto"]
    reports = spawn_gang(2, ["--model", "small-llama", "--mesh", json.dumps(mesh), "--cases", json.dumps([case])]
                         + GANG_STEPS, str(tmp_path / "r"))
    assert_rows(reports, 0, stacked_twin("small-llama", mesh, case))


@pytest.mark.parametrize("mesh", [(1, 2, 1), (1, 2, 2)], ids=["tp2", "tp2-sp2"])
def test_fused_llama_agrees_with_the_unfused(mesh, one_thread, monkeypatch):
    """small-llama with its Row projections through the ``matmul_rs`` ring
    (``LlamaConfig.tp_fused``) against the same model on the ``psum`` path,
    on the same seed-0 weights and batch, at tp 2 and tp 2 x sp 2 (zigzag),
    one forward and backward on the single-controller group: the losses
    within 1e-5 relative, each gradient within 1e-4 of its leaf's largest
    element (``chip_smoke.py``'s fused-against-unfused contract: f32 sums
    of the same K products in another order, each about ``matmul_tol(K) /
    2`` relative).  The fused run goes through ``matmul_rs`` once a Row
    layer, the unfused one never."""
    from bagua_tpu_torch.examples import llama_pretrain as lp
    from bagua_tpu_torch.models.llama import llama_loss_fn
    from bagua_tpu_torch.parallel import tensor_parallel as tpl
    from bagua_tpu_torch.parallel.ring_attention import zigzag_order
    from bagua_tpu_torch.utils import tree_flatten_with_names

    dp, tp, sp = mesh
    calls = []
    ring = tpl.matmul_rs
    monkeypatch.setattr(tpl, "matmul_rs", lambda *a, **kw: calls.append(1) or ring(*a, **kw))
    out = {}
    for fused in (False, True):
        args = lp.parse_args(["--device", "cpu", "--dp", str(dp), "--tp", str(tp), "--sp", str(sp)]
                             + (["--tp-fused"] if fused else []))
        rng = np.random.RandomState(0)
        toks, vocab = lp.load_corpus(None, rng)
        group = BaguaProcessGroup([CPU] * (dp * tp * sp), mesh_spec=lp.mesh_spec(dp, tp, sp))
        _, cfg, model, stacked = lp.build(args, vocab, CPU, group)
        assert cfg.tp_fused is fused
        ids = next(lp.batches(toks, rng, args.batch, args.seq, 1))
        if sp > 1:
            ids = ids[:, zigzag_order(args.seq, sp)]
        calls.clear()
        losses = llama_loss_fn(model)(stacked, lp.shard_ids(ids, group, CPU, "dp", "sp"))
        losses.sum().backward()
        out[fused] = losses.detach(), [(name, leaf.grad) for name, leaf in tree_flatten_with_names(stacked)], len(calls)
    (want, want_grads, unfused_calls), (got, got_grads, fused_calls) = out[False], out[True]
    assert (unfused_calls, fused_calls) == (0, 2 * cfg.num_layers)
    assert torch.allclose(got, want, rtol=1e-5, atol=0.0), (got.tolist(), want.tolist())
    for (name, g), (_, w) in zip(got_grads, want_grads):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), name


GPT_CASES = {"1f1b": ["stacked", {"schedule": "1f1b"}, "auto"], "gpipe": ["stacked", {"schedule": "gpipe"}, "auto"]}


@pytest.fixture(scope="module")
def gpt_gang(tmp_path_factory):
    mesh = {"dp": 1, "pp": 2, "tp": 1, "sp": 2}
    return spawn_gang(2, ["--model", "small-gpt", "--mesh", json.dumps(mesh), "--cases",
                          json.dumps(list(GPT_CASES.values()))] + GANG_STEPS,
                      str(tmp_path_factory.mktemp("gpt") / "r"))


@pytest.mark.parametrize("schedule", list(GPT_CASES))
def test_gpt_pp2_sp2_gang_is_bitwise(gpt_gang, schedule, one_thread):
    i = list(GPT_CASES).index(schedule)
    assert_rows(gpt_gang, i, stacked_twin("small-gpt", {"dp": 1, "pp": 2, "tp": 1, "sp": 2}, GPT_CASES[schedule]))


# -- (c) FSDP, MoE, SyncBatchNorm and sub-groups ---------------------------------------------


@pytest.fixture(scope="module")
def model_axes_reports(tmp_path_factory):
    return spawn_workers("model_axes", 2, str(tmp_path_factory.mktemp("axes") / "r"))


@pytest.mark.parametrize("name", list(MODEL_AXES))
def test_model_axes_rows_are_the_stacked_groups(model_axes_reports, name):
    for p, report in enumerate(model_axes_reports):
        assert report[name] == [], f"process {p}: {report[name][:5]}"


# -- (d) the anchor to the JAX package ---------------------------------------------------------


def test_gang_small_llama_engine_agrees_with_jax(tmp_path, monkeypatch):
    from test_torch_mesh_engine import check_leaf, run_jax_engine

    from bagua_tpu_torch import communication as comm
    from bagua_tpu_torch.convert import params_from_jax
    from bagua_tpu_torch.utils import tree_flatten_with_names

    import bagua_tpu

    monkeypatch.setattr(bagua_tpu.communication, "_default_group", bagua_tpu.communication._default_group)
    monkeypatch.setattr(comm, "_default_group", comm._default_group)
    argv = ["--engine", "--dp", "2", "--tp", "2", "--sp", "1", "--steps", "3"]
    _, initial, want = run_jax_engine("llama_pretrain", argv, monkeypatch)
    initial_path = str(tmp_path / "initial.pt")
    torch.save(params_from_jax(initial), initial_path)
    out = str(tmp_path / "r")
    reports = spawn_gang(2, ["--model", "small-llama", "--mesh", json.dumps({"dp": 2, "tp": 2}), "--cases",
                             json.dumps([ENGINE_CASES["unfused"]]), "--params", initial_path, "--save-params",
                             out] + GANG_STEPS, out)
    assert [r[0]["steps"] for r in reports] == [3, 3]
    got = [np.load(f"{out}.case0.proc{p}.npz") for p in range(2)]
    names = [n for n, _ in tree_flatten_with_names(params_from_jax(initial))]
    import jax

    for name, w, w0 in zip(names, jax.tree.leaves(want), jax.tree.leaves(initial)):
        for p in range(2):
            rows = got[p][name]
            for i in range(rows.shape[0]):
                check_leaf(f"{name} rank {2 * p + i}", rows[i], w[2 * p + i], w0, 3e-3)


# -- (e) the entry points that form a mesh group ------------------------------------------------


def test_init_from_env_forms_a_mesh_group(monkeypatch):
    """``init_from_env(devices, mesh_spec=)``: outside a gang, one controller
    holding every rank of the mesh (also :func:`mesh_group`'s group there);
    with ``WORLD_SIZE=2`` two processes each holding half the ranks of dp 2
    x tp 2, the tp allreduce summing across the pair of ranks a process
    holds; a mesh that does not divide among the processes raises."""
    from bagua_tpu_torch.communication import destroy_process_group, mesh_share
    from bagua_tpu_torch.distributed import init_from_env, mesh_group

    for var in ("WORLD_SIZE", "MASTER_PORT", "RANK"):
        monkeypatch.delenv(var, raising=False)
    spec = MeshSpec({"dp": 2, "tp": 2})
    try:
        for group in (init_from_env([CPU] * 4, mesh_spec=spec), mesh_group(spec, CPU)):
            assert (group.size, group.local_size, group.distributed, group.mesh_spec) == (4, 4, False, spec)
    finally:
        destroy_process_group()
    with pytest.raises(ValueError, match="does not divide among 3 processes"):
        mesh_share(spec, 3)
    port = str(free_port())
    code = ("import torch\n"
            "from bagua_tpu_torch.communication import ReduceOp, allreduce, destroy_process_group\n"
            "from bagua_tpu_torch.distributed import init_from_env\n"
            "from bagua_tpu_torch.mesh import MeshSpec\n"
            "g = init_from_env([torch.device('cpu')] * 2, mesh_spec=MeshSpec({'dp': 2, 'tp': 2}))\n"
            "x = torch.tensor([[1.0], [2.0]]) + 10 * g.process_index\n"
            "s = allreduce(x, ReduceOp.SUM, g, 'tp')\n"
            "print(g.size, g.local_size, g.spans_processes, list(g.local_rows), s.reshape(-1).tolist())\n"
            "destroy_process_group()\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO_ROOT, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE,
                              env=worker_env(OMP_NUM_THREADS="1", WORLD_SIZE="2", RANK=str(r),
                                             MASTER_ADDR="127.0.0.1", MASTER_PORT=port)) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err[-2000:] for _, err in outs]
    assert [out.split() for out, _ in outs] == [["4", "2", "True", "[0,", "1]", "[3.0,", "3.0]"],
                                                ["4", "2", "True", "[2,", "3]", "[23.0,", "23.0]"]]
