"""The port's launcher tier (``bagua_tpu_torch/distributed/``, copies of the
JAX package's modules): the rendezvous state machine gives the JAX store's
assignments for the same event sequence, the client round-trips its KV
through the port's server, ``init_from_env`` builds the single-controller
group and, under ``WORLD_SIZE=2``, a gang of two processes, and one run of
``python -m bagua_tpu_torch.distributed.run --nproc_per_node 1
--max_restarts 1`` restarts the elastic twin after it fails once past a
checkpoint: the second attempt resumes there and finishes."""

import json
import os
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from bagua_tpu.distributed import rendezvous as jax_rdzv
from helpers import REPO_ROOT, free_port

from bagua_tpu_torch.distributed import init_from_env
from bagua_tpu_torch.distributed import rendezvous as rdzv

#: (method, arguments) events with the settle window between some of them:
#: joins below and above min_nodes, an idempotent re-announce, a shrink, a
#: restart request (twice, from the same epoch), crash reports, a completed
#: leave, a rejoin and a crash leave
EVENTS = [
    ("join", (1, 2, 5)), ("join", (0, 3, 9)), ("settle",), ("join", (0, 3, 9)), ("settle",),
    ("join", (0, 1, 9)), ("settle",), ("restart",), ("restart",), ("crash", (1,)), ("crash", (0,)),
    ("leave", (1, True)), ("settle",), ("join", (1, 2, 6)), ("join", (2, 1, 1)), ("settle",),
    ("leave", (2, False)), ("settle",),
]


def _drive(mod):
    st = mod.RendezvousState(min_nodes=2, max_nodes=3, settle_s=0.05)
    out, seen_epoch = [], None
    for event in EVENTS:
        kind, args = event[0], event[1] if len(event) > 1 else ()
        if kind == "settle":
            time.sleep(0.08)
            out.append(st.assignment())
        elif kind == "join":
            out.append(st.join(*args))
        elif kind == "restart":
            # the second request comes from a node that saw the same epoch
            seen_epoch = st.assignment()["epoch"] if seen_epoch is None else seen_epoch
            out.append(st.request_restart(seen_epoch))
        elif kind == "crash":
            out.append(st.report_crash(args[0], st.assignment()["epoch"]))
        else:
            st.leave(*args)
    return out


def _no_clocks(obj):
    if isinstance(obj, dict):
        return {k: _no_clocks(v) for k, v in obj.items() if k not in ("ts", "settled_at", "heartbeat_age_s")}
    if isinstance(obj, list):
        return [_no_clocks(v) for v in obj]
    return obj


def test_rendezvous_state_machine_equals_jax():
    """The same events through both stores give the same answers and
    assignments (generations, epochs, members, rank offsets, world sizes,
    crash origins), clocks aside."""
    assert _no_clocks(_drive(rdzv)) == _no_clocks(_drive(jax_rdzv))
    assert rdzv.rotated_master_port(29500, 7, [29501, 29400]) == \
        jax_rdzv.rotated_master_port(29500, 7, [29501, 29400])


def test_rendezvous_client_against_the_ports_server():
    st = rdzv.RendezvousState(min_nodes=2, settle_s=0.05)
    port = free_port()
    server = rdzv.start_rendezvous_server(st, port, host="127.0.0.1")
    try:
        c0 = rdzv.RendezvousClient(f"127.0.0.1:{port}", node_rank=0, timeout_s=10)
        c1 = rdzv.RendezvousClient(f"127.0.0.1:{port}", node_rank=1, timeout_s=10)
        c1.announce(nslots=2, incarnation=7)
        asn = c0.wait_assignment(nslots=1, incarnation=3)
        assert asn["world_size"] == 3 and not c0.epoch_changed(asn["epoch"])
        c1.request_restart(asn["epoch"])
        assert c0.epoch_changed(asn["epoch"])
        c0.kv_set("job name/with space?&#", [1, 2])
        assert c1.kv_get("job name/with space?&#") == [1, 2] and c1.kv_get("missing") is None
    finally:
        server.shutdown()


def test_init_from_env(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    group = init_from_env([torch.device("cpu")] * 2)
    assert group.size == 2
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert init_from_env([torch.device("cpu")]).size == 1
    # WORLD_SIZE=2: two processes form one gloo gang of 2 x 2 ranks
    port = str(free_port())
    code = ("import torch\n"
            "from bagua_tpu_torch.communication import ReduceOp, allreduce, destroy_process_group\n"
            "from bagua_tpu_torch.distributed import init_from_env\n"
            "torch.set_num_threads(1)\n"
            "g = init_from_env([torch.device('cpu')] * 2)\n"
            "s = allreduce(torch.full((2,), float(g.process_index)), ReduceOp.SUM, g)\n"
            "print(g.size, g.spans_processes, g.process_index, list(g.local_rows), s.tolist())\n"
            "destroy_process_group()\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO_ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env={**os.environ, "WORLD_SIZE": "2", "RANK": str(r), "MASTER_ADDR": "127.0.0.1",
                                   "MASTER_PORT": port, "OMP_NUM_THREADS": "1"}) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err[-2000:] for _, err in outs]
    assert [out.split() for out, _ in outs] == [
        ["4", "True", "0", "[0,", "1]", "[2.0,", "2.0]"], ["4", "True", "1", "[2,", "3]", "[2.0,", "2.0]"]]


WORKER = textwrap.dedent("""
    import json, os, sys
    import torch
    from bagua_tpu_torch.distributed import init_from_env
    from bagua_tpu_torch.examples import elastic_training as et

    attempt = os.environ["BAGUA_ATTEMPT"]

    def on_step(trainer, state):
        if attempt == "0" and state.step == 55:  # past the checkpoint at 50
            sys.exit(3)

    group = init_from_env([torch.device("cpu")] * 2)
    start, state, losses = et.run(group, 60, sys.argv[1], on_step=on_step)
    print("RESULT " + json.dumps({"attempt": attempt, "start": start, "step": state.step,
                                  "world_size": os.environ["WORLD_SIZE"]}), flush=True)
""")


def test_launcher_restarts_the_twin_from_its_checkpoint(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=REPO_ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("WORLD_SIZE", None)
    out = subprocess.run(
        [sys.executable, "-m", "bagua_tpu_torch.distributed.run", "--nproc_per_node", "1", "--max_restarts", "1",
         "--monitor_interval", "0.2", "--master_port", str(free_port()), str(script), str(tmp_path / "ckpt")],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    results = [json.loads(line[len("RESULT "):]) for line in out.stdout.splitlines() if line.startswith("RESULT ")]
    assert results == [{"attempt": "1", "start": 50, "step": 60, "world_size": "1"}], out.stdout[-2000:]
    assert "starting at step 0" in out.stdout and "starting at step 50" in out.stdout
