"""1000-gang fleet scale lane (the artifact ``FLEET_SCALE_TORCH.json``): the
sharded control plane and the remediation engine, proven under churn.

The port of the JAX package's ``ci/fleet_scale.py``: host code against the
port's server, with no group and no engine, so it takes no ``--device``.
One ``python -m bagua_tpu_torch.fleet.server --shards 4 --io async``
subprocess (four consistent-hash shards, per-shard WALs, the selector event
loop) serves:

* **thundering-herd warm start**: every simulated gang arrives at once,
  creates its namespace, pushes a healthy StepSummary and asks the
  cross-gang plan cache for the warm plan (canary gating withholds it from
  all but the cohort), over persistent keep-alive connections.
* **churn**: the fleet simulator's storm profiles (``churn_schedule``)
  pick seeded gang subsets: the preemption storm's gangs restart into a
  new attempt mid-run, the KV-flap gangs hammer their buckets past burst
  (drawing 429s the lane absorbs), while a paced probe measures the p99
  RPC latency under all of it.
* **scheduler staleness**: a probe gang bumps its step; the
  ``/fleet/scheduler`` view must reflect it within the gate.
* **three remediation arcs**, end to end over HTTP through ``POST
  /fleet/remediate``: quarantine and rollback (a bad plan's adopters push
  ``regressed`` incidents naming its ``plan_version``; the sweep
  quarantines it, citing exactly the indicting trace ids, and directs every
  adopter to roll back, while a healthy plan whose adopter regresses under
  an unrelated ``plan_version`` is never touched); hang diagnosis and a
  directed resize (a wedged gang's divergent flight digests join to a
  ``desync`` verdict and a durable ``resize`` directive, and a second sweep
  issues nothing new); canary graduation (a fresh plan is served only to
  its cohort until ``canary_n`` adopters are judged healthy).
* **SIGKILL + per-shard WAL replay**: the server is SIGKILLed after the arcs
  and restarted on the same port and WAL directories; the ``/fleet/dump``
  witness (all four shards) must be **bitwise identical**, every shard's
  replay under the gate, and the remediation state intact.
* **metrics**: ``/fleet/metrics`` exports ``bagua_fleet_shard_count``,
  per-shard ``bagua_wal_replay_ms{shard=...}`` and
  ``bagua_remediations_total{action=...}``.

The server's port is chosen free and then bound by the server; where
another process takes it first (EADDRINUSE, at the start or at the
restart), the lane runs again on a fresh port, each retry printed.

::

    python -m bagua_tpu_torch.tools.fleet_scale                    # 1000 gangs
    python -m bagua_tpu_torch.tools.fleet_scale --n-gangs 120      # the quick variant
"""

import argparse
import json
import os
import signal
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

from bagua_tpu_torch.tools._fleet import canon, free_port, get_json, spawn_server, wait_health, with_port_retries
from bagua_tpu_torch.tools._lane import REPO, command_line, device_record, write_json

N_GANGS_FULL = 1000
N_GANGS_QUICK = 120
SHARDS = 4
LATENCY_CALLS = 200
LATENCY_GATE_MS = 500.0
STALENESS_GATE_S = 5.0
HERD_WORKERS = 32
RATE, BURST = 200.0, 80.0


def _replay_gate_ms(n_gangs: int) -> float:
    """Per-shard WAL replay budget: generous for a CPU CI box, but an
    O(n^2) replay or a lost snapshot would blow it."""
    return max(2000.0, 12.0 * n_gangs)


def _server_args(port: int, wal_dir: str):
    return [
        "--port", str(port), "--host", "127.0.0.1", "--wal-dir", wal_dir,
        "--shards", str(SHARDS), "--io", "async", "--canary-n", "2",
        "--settle-s", "0.05", "--lease-ttl-s", "3600", "--member-ttl-s", "3600",
        "--rate", str(RATE), "--burst", str(BURST), "--compact-every", "5000",
    ]


def _post_json(url: str, payload: dict, timeout: float = 30.0) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


class _Conn:
    """One persistent keep-alive HTTP connection (the herd's unit of
    fan-in: ~32 of these multiplex the whole fleet onto the selector
    loop).  Reconnects transparently — a dropped keep-alive socket must
    not fail a herd gang."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        import http.client

        self._mk = lambda: http.client.HTTPConnection(host, port, timeout=timeout)
        self._conn = self._mk()

    def call(self, method: str, path: str, payload=None):
        body = None if payload is None else json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"} if body else {}
        for attempt in (0, 1):
            try:
                self._conn.request(method, path, body=body, headers=headers)
                resp = self._conn.getresponse()
                data = resp.read()
                return resp.status, json.loads(data) if data else {}
            except (OSError, ValueError):
                self._conn.close()
                self._conn = self._mk()
                if attempt:
                    raise

    def close(self):
        self._conn.close()


def _summary_payload(rank: int, step: int, p50_ms: float = 100.0) -> dict:
    from bagua_tpu_torch.observability.aggregate import StepSummary

    return StepSummary(
        rank=rank, step=step, window=10, p50_ms=p50_ms, p99_ms=p50_ms * 1.2,
        wire_bytes=1 << 20, mfu=0.4, samples_per_s=32.0,
    ).payload()


def _kv_path(gang: str, key: str) -> str:
    from urllib.parse import quote

    return f"/g/{quote(gang, safe='')}/rdzv/kv/{quote(key, safe='')}"


def _plan_key_payload(tag: str) -> dict:
    return {
        "fingerprint": f"scale-{tag}", "topology": "cpu:8",
        "algorithm": "gradient_allreduce", "wire_precision": "fp32",
    }


def _flight_digest(rank: int, label_at_2: str) -> dict:
    """A pushed flight digest whose tail diverges at seq 2 across ranks —
    the first-desync signature ``build_hang_report`` joins to ``desync``."""
    tail = []
    for seq in range(3):
        label = label_at_2 if seq == 2 else f"allreduce:b{seq}"
        tail.append({
            "seq": seq, "step": seq, "label": label, "algo": "allreduce",
            "bucket": seq, "phase": "wire", "precision": "fp32",
            "nbytes": 1 << 20, "plan_version": 1, "variant": "sync",
            "t_enqueue": 1.0 + seq, "t_retire": 1.5 + seq,
        })
    return {"rank": rank, "last_seq": 2, "tail": tail, "mono": 120.0,
            "unretired": 0}


def run_lane(workdir: str, out_path: str, n_gangs: int = None) -> dict:
    """The whole lane; returns the payload (also written to ``out_path``).
    A run whose server lost its port to another process runs again on a
    fresh port, in a fresh WAL directory."""
    return with_port_retries("[fleet-scale]", lambda t: _run_lane_once(
        os.path.join(workdir, f"try{t}") if t else workdir, out_path, n_gangs))


def _run_lane_once(workdir: str, out_path: str, n_gangs: int = None) -> dict:
    from bagua_tpu_torch.perflab.fleetsim import KVFlap, Preemption, churn_schedule

    n_gangs = N_GANGS_QUICK if n_gangs is None else int(n_gangs)
    replay_gate_ms = _replay_gate_ms(n_gangs)
    os.makedirs(workdir, exist_ok=True)
    wal_dir = os.path.join(workdir, "wal")
    log_path = os.path.join(workdir, "server.log")
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    gang_ids = [f"s{i:04d}" for i in range(n_gangs)]

    proc = spawn_server(_server_args(port, wal_dir), log_path)
    restarted_proc = None
    try:
        wait_health(base, proc, log_path, deadline_s=180.0)
        shards = get_json(f"{base}/fleet/shards")
        assert shards["n_shards"] == SHARDS, shards

        # -- warm plan + thundering herd -----------------------------------
        plan_a = _plan_key_payload("healthy")
        out = _post_json(f"{base}/fleet/plan/publish", dict(
            plan_a, plan={"buckets": [["w0"], ["w1"]]},
            meta={"plan_version": 1},
        ))
        assert out.get("ok"), out

        herd_stats = {"ok": 0, "adopted": 0, "withheld": 0, "errors": 0}
        herd_lock = threading.Lock()
        herd_t0 = time.monotonic()

        def herd_slice(worker: int):
            conn = _Conn("127.0.0.1", port)
            ok = adopted = withheld = errors = 0
            try:
                for i in range(worker, n_gangs, HERD_WORKERS):
                    gang = gang_ids[i]
                    try:
                        status, _ = conn.call("GET", f"/g/{gang}/directive")
                        assert status == 200, status
                        status, _ = conn.call(
                            "POST", _kv_path(gang, "bagua/obs/warm/rank0"),
                            {"value": _summary_payload(0, 10)},
                        )
                        assert status == 200, status
                        status, found = conn.call(
                            "POST", "/fleet/plan/lookup", dict(plan_a, gang=gang)
                        )
                        assert status == 200, status
                        if found.get("found"):
                            adopted += 1
                        else:
                            withheld += 1
                        ok += 1
                    except Exception:
                        errors += 1
            finally:
                conn.close()
            with herd_lock:
                herd_stats["ok"] += ok
                herd_stats["adopted"] += adopted
                herd_stats["withheld"] += withheld
                herd_stats["errors"] += errors

        with ThreadPoolExecutor(max_workers=HERD_WORKERS) as pool:
            list(pool.map(herd_slice, range(HERD_WORKERS)))
        herd_wall_s = time.monotonic() - herd_t0
        assert herd_stats["errors"] == 0, herd_stats
        assert herd_stats["ok"] == n_gangs, herd_stats
        # canary gating held the herd back: only the cohort got the plan
        assert herd_stats["adopted"] <= 2, herd_stats
        assert herd_stats["withheld"] >= n_gangs - 2, herd_stats

        info = get_json(f"{base}/fleet/shards")
        assert sum(info["gangs_per_shard"]) >= n_gangs, info
        assert min(info["gangs_per_shard"]) > 0, (
            f"consistent hashing left a shard empty: {info}"
        )

        # -- churn storms + paced p99 latency probe -------------------------
        faults = churn_schedule(n_gangs, seed=0)
        preempt_gangs = sorted({f.gang for f in faults if isinstance(f, Preemption)})
        flap_gangs = sorted({f.gang for f in faults if isinstance(f, KVFlap)})

        churn_stats = {"preempt_restarts": 0, "flap_calls": 0, "flap_429": 0}
        churn_lock = threading.Lock()

        def preempt_storm():
            # a zone reclaim: every hit gang restarts into a new attempt
            # nonce and re-reports with one rank missing
            conn = _Conn("127.0.0.1", port)
            n = 0
            try:
                for g in preempt_gangs:
                    gang = gang_ids[g]
                    status, _ = conn.call(
                        "POST", _kv_path(gang, "bagua/obs/warm2/rank0"),
                        {"value": _summary_payload(0, 20)},
                    )
                    assert status == 200, status
                    n += 1
            finally:
                conn.close()
            with churn_lock:
                churn_stats["preempt_restarts"] += n

        def flap_storm(worker: int):
            # a control-plane brownout as seen from the tenants: unpaced
            # bucket-busting bursts; 429 + Retry-After is the contract.
            # The first gang in each slice floods past its burst so the
            # lane demonstrably absorbs real denials.
            conn = _Conn("127.0.0.1", port)
            calls = denied = 0
            try:
                for j, g in enumerate(flap_gangs[worker::4]):
                    gang = gang_ids[g]
                    for i in range(int(BURST * 2) + 80 if j == 0 else 8):
                        status, _ = conn.call(
                            "POST", _kv_path(gang, f"flap/{i}"), {"value": "x"}
                        )
                        assert status in (200, 429), status
                        calls += 1
                        if status == 429:
                            denied += 1
            finally:
                conn.close()
            with churn_lock:
                churn_stats["flap_calls"] += calls
                churn_stats["flap_429"] += denied

        churn_threads = [threading.Thread(target=preempt_storm)] + [
            threading.Thread(target=flap_storm, args=(w,)) for w in range(4)
        ]
        for t in churn_threads:
            t.start()

        lat_conn = _Conn("127.0.0.1", port)
        walls = []
        for i in range(LATENCY_CALLS // 2):
            t0 = time.monotonic()
            status, _ = lat_conn.call(
                "POST", _kv_path("lat-probe", f"lat/{i}"), {"value": "z" * 64}
            )
            assert status == 200, status
            walls.append(time.monotonic() - t0)
            t0 = time.monotonic()
            status, _ = lat_conn.call(
                "GET", _kv_path("lat-probe", f"lat/{i}")
            )
            assert status == 200, status
            walls.append(time.monotonic() - t0)
            # honest pacing: stay under the probe gang's own bucket so a
            # self-inflicted 429 sleep never lands in the measured wall
            time.sleep(2.0 / RATE * 1.25)
        for t in churn_threads:
            t.join()
        lat_conn.close()
        assert churn_stats["preempt_restarts"] == len(preempt_gangs), churn_stats
        assert churn_stats["flap_429"] >= 1, (
            f"flap storm never drew a 429 (burst {BURST}): {churn_stats}"
        )
        walls.sort()
        p50_ms = walls[len(walls) // 2] * 1e3
        p99_ms = walls[int(len(walls) * 0.99)] * 1e3
        assert p99_ms <= LATENCY_GATE_MS, (
            f"p99 RPC latency {p99_ms:.1f} ms over the {LATENCY_GATE_MS} ms "
            f"gate under churn"
        )

        # -- scheduler-view staleness gate ----------------------------------
        probe = gang_ids[0]
        t0 = time.monotonic()
        _post_json(f"{base}{_kv_path(probe, 'bagua/obs/warm/rank0')}",
                   {"value": _summary_payload(0, 99)})
        staleness_s = None
        while time.monotonic() - t0 < STALENESS_GATE_S + 5.0:
            view = get_json(f"{base}/fleet/scheduler", timeout=60.0)
            if view["gangs"].get(probe, {}).get("max_step") == 99:
                staleness_s = time.monotonic() - t0
                break
        assert staleness_s is not None and staleness_s <= STALENESS_GATE_S, (
            f"scheduler view stale for {staleness_s}s "
            f"(gate {STALENESS_GATE_S}s)"
        )
        assert view["n_gangs"] >= n_gangs, view["n_gangs"]

        # -- arc 3: canary graduation ---------------------------------------
        plan_c = _plan_key_payload("canary")
        _post_json(f"{base}/fleet/plan/publish", dict(
            plan_c, plan={"buckets": [["w0", "w1"]]}, meta={"plan_version": 3},
        ))
        for gang in ("c0", "c1"):
            found = _post_json(f"{base}/fleet/plan/lookup",
                               dict(plan_c, gang=gang))
            assert found.get("found"), (gang, found)
            _post_json(f"{base}{_kv_path(gang, 'bagua/obs/a/rank0')}",
                       {"value": _summary_payload(0, 50)})
        late = _post_json(f"{base}/fleet/plan/lookup", dict(plan_c, gang="c2"))
        assert not late.get("found"), "canary plan escaped its cohort"

        # noise for the zero-false-quarantine property: a healthy-plan
        # adopter regresses under an UNRELATED plan_version
        remediation = get_json(f"{base}/fleet/remediation")
        key_a = [k for k in remediation["plans"] if "scale-healthy" in k][0]
        noise_gang = sorted(remediation["plans"][key_a]["adopters"])[0]
        _post_json(f"{base}/g/{noise_gang}/incidents", {"incidents": [{
            "step": 11, "dominant": "compile", "plan_version": 999,
            "trace_id": "noise-trace-1",
        }]})

        sweep1 = _post_json(f"{base}/fleet/remediate", {})
        key_c = [k for k in sweep1["graduated"] if "scale-canary" in k]
        assert key_c, f"canary plan never graduated: {sweep1}"
        late = _post_json(f"{base}/fleet/plan/lookup", dict(plan_c, gang="c2"))
        assert late.get("found"), "graduated plan still withheld"
        assert not sweep1["quarantined"], (
            f"FALSE QUARANTINE on noise incidents: {sweep1['quarantined']}"
        )

        # -- arc 1: quarantine + fleet-wide rollback ------------------------
        plan_b = _plan_key_payload("bad")
        _post_json(f"{base}/fleet/plan/publish", dict(
            plan_b, plan={"buckets": [["w0"], ["w1"]]}, meta={"plan_version": 2},
        ))
        cites = []
        for i, gang in enumerate(("b0", "b1")):
            found = _post_json(f"{base}/fleet/plan/lookup",
                               dict(plan_b, gang=gang))
            assert found.get("found"), (gang, found)
            _post_json(f"{base}{_kv_path(gang, 'bagua/obs/a/rank0')}",
                       {"value": _summary_payload(0, 60)})
            trace = f"bad-plan-trace-{i}"
            cites.append(trace)
            _post_json(f"{base}/g/{gang}/incidents", {"incidents": [{
                "step": 61, "dominant": "wire_slowdown", "plan_version": 2,
                "trace_id": trace,
            }]})

        sweep2 = _post_json(f"{base}/fleet/remediate", {})
        key_b = [k for k in sweep2["quarantined"] if "scale-bad" in k]
        assert key_b, f"bad plan never quarantined: {sweep2}"
        assert len(sweep2["quarantined"]) == 1, (
            f"false quarantine rode along: {sweep2['quarantined']}"
        )
        rollback_gangs = sorted(r["gang"] for r in sweep2["rollbacks"])
        assert rollback_gangs == ["b0", "b1"], sweep2["rollbacks"]
        remediation = get_json(f"{base}/fleet/remediation")
        assert remediation["plans"][key_b[0]]["status"] == "quarantined"
        assert sorted(remediation["plans"][key_b[0]]["cites"]) == sorted(cites)
        for k, rec in remediation["plans"].items():
            if k != key_b[0]:
                assert rec["status"] != "quarantined", (
                    f"zero-false-quarantine violated: {k} -> {rec['status']}"
                )
        denied = _post_json(f"{base}/fleet/plan/lookup",
                            dict(plan_b, gang="b9"))
        assert not denied.get("found"), "quarantined plan served"
        # one adopter acks its rollback; the other stays pending across
        # the SIGKILL below
        d = get_json(f"{base}/g/b0/directive")["directive"]
        assert d and d["action"] == "rollback_plan", d
        assert f"v2" in d["reason"], d
        acked = _post_json(f"{base}/g/b0/directive/ack", {"id": d["id"]})
        assert acked.get("ok"), acked
        view = get_json(f"{base}/fleet/scheduler", timeout=60.0)
        marker = view["gangs"]["b1"].get("remediation")
        assert marker and marker["action"] == "rollback_plan", marker

        # -- arc 2: wedged -> first-desync diagnosis -> directed resize -----
        for rank, label in ((0, "allreduce:b2"), (1, "allgather:bX")):
            _post_json(
                f"{base}{_kv_path('w0', f'bagua/flight/a/rank{rank}')}",
                {"value": _flight_digest(rank, label)},
            )
        sweep3 = _post_json(f"{base}/fleet/remediate", {})
        resized = [r for r in sweep3["resized"] if r["gang"] == "w0"]
        assert resized and resized[0]["verdict"] == "desync", sweep3
        assert resized[0]["to_world_size"] == 1, resized
        # idempotence: the pending directive suppresses a re-issue
        sweep4 = _post_json(f"{base}/fleet/remediate", {})
        assert not sweep4["resized"] and not sweep4["quarantined"], sweep4
        d = get_json(f"{base}/g/w0/directive")["directive"]
        assert d and d["action"] == "resize", d
        assert d["detail"]["to_world_size"] == 1, d
        assert d["detail"]["implicated_ranks"] == [1], d
        assert _post_json(f"{base}/g/w0/directive/ack", {"id": d["id"]})["ok"]

        # -- metrics exposition ---------------------------------------------
        req = urllib.request.Request(f"{base}/fleet/metrics")
        with urllib.request.urlopen(req, timeout=30.0) as resp:
            metrics = resp.read().decode()
        assert f"bagua_fleet_shard_count {SHARDS}" in metrics, metrics[:2000]
        assert 'bagua_wal_replay_ms{shard="0"}' in metrics
        assert 'bagua_remediations_total{action="quarantine"} 1' in metrics
        assert 'bagua_remediations_total{action="rollback_plan"} 2' in metrics
        assert 'bagua_remediations_total{action="resize"} 1' in metrics
        assert 'bagua_remediations_total{action="canary_graduate"}' in metrics

        # -- SIGKILL + restart: per-shard WAL replay, bitwise ---------------
        pre = get_json(f"{base}/fleet/dump", timeout=120.0)
        assert pre.get("n_shards") == SHARDS, pre.get("n_shards")
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        restarted_proc = spawn_server(_server_args(port, wal_dir), log_path)
        wait_health(base, restarted_proc, log_path, deadline_s=180.0)
        post = get_json(f"{base}/fleet/dump", timeout=120.0)
        assert canon(post) == canon(pre), (
            "sharded durable dump diverged across SIGKILL + WAL replay"
        )
        info = get_json(f"{base}/fleet/shards")
        replay_ms = info["wal_replay_ms"]
        assert len(replay_ms) == SHARDS and all(
            isinstance(m, (int, float)) and 0.0 < m <= replay_gate_ms
            for m in replay_ms
        ), f"per-shard WAL replay {replay_ms} vs gate {replay_gate_ms} ms"
        # remediation state survived the kill verbatim
        denied = _post_json(f"{base}/fleet/plan/lookup",
                            dict(plan_b, gang="b9"))
        assert not denied.get("found"), "quarantine lost across replay"
        served = _post_json(f"{base}/fleet/plan/lookup", dict(plan_c, gang="c3"))
        assert served.get("found"), "graduation lost across replay"
        d = get_json(f"{base}/g/b1/directive")["directive"]
        assert d and d["action"] == "rollback_plan", (
            f"pending rollback lost across replay: {d}"
        )
        assert get_json(f"{base}/g/w0/directive")["directive"] is None, (
            "directive ack lost across replay"
        )

        payload = {
            "generated_by": "bagua_tpu_torch/tools/fleet_scale.py",
            "command": command_line(),
            "device": device_record(),
            "n_gangs": n_gangs,
            "server": {
                "shards": SHARDS, "io": "async", "rate": RATE, "burst": BURST,
                "canary_n": 2, "wal_backed": True,
            },
            "herd": {
                "gangs": herd_stats["ok"],
                "wall_s": round(herd_wall_s, 3),
                "adopted": herd_stats["adopted"],
                "withheld_by_canary_gate": herd_stats["withheld"],
                "gangs_per_shard": info["gangs_per_shard"],
            },
            "churn": {
                "preempted_gangs": len(preempt_gangs),
                "flapped_gangs": len(flap_gangs),
                "flap_calls": churn_stats["flap_calls"],
                "flap_429": churn_stats["flap_429"],
            },
            "latency": {
                "n_calls": len(walls),
                "p50_ms": round(p50_ms, 3),
                "p99_ms": round(p99_ms, 3),
                "gate_ms": LATENCY_GATE_MS,
            },
            "staleness": {
                "observed_s": round(staleness_s, 3),
                "gate_s": STALENESS_GATE_S,
            },
            "remediation": {
                "quarantined": sweep2["quarantined"],
                "quarantine_cites": sorted(cites),
                "false_quarantines": 0,
                "rollback_gangs": rollback_gangs,
                "resize": resized[0],
                "idempotent_resweep": True,
                "graduated": key_c,
            },
            "sigkill": {
                "dump_bitwise_identical": True,
                "wal_replay_ms": [round(float(m), 3) for m in replay_ms],
                "replay_gate_ms": replay_gate_ms,
                "remediation_state_survived": True,
            },
        }
        write_json(out_path, payload, indent=1)
        print(
            f"[fleet-scale] fleet scale lane passed ({n_gangs} gangs on "
            f"{SHARDS} shards, herd {herd_wall_s:.1f}s with canary gate "
            f"holding {herd_stats['withheld']} gangs, p99 {p99_ms:.1f} ms "
            f"under {len(preempt_gangs)}-gang preemption storm + "
            f"{churn_stats['flap_429']}x 429 flap, staleness "
            f"{staleness_s:.2f}s, plan quarantined with 0 false positives "
            f"+ wedged gang resized + canary graduated, SIGKILL->restart "
            f"dump bitwise-identical across {SHARDS} WAL shards "
            f"-> {out_path})",
            file=sys.stderr,
        )
        return payload
    finally:
        for p in (proc, restarted_proc):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "FLEET_SCALE_TORCH.json"))
    ap.add_argument("--n-gangs", type=int, default=N_GANGS_FULL)
    ap.add_argument("--workdir", default=None,
                    help="scratch directory for the WALs and logs (default: a temporary one)")
    args = ap.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="bagua_fleet_scale_")
    run_lane(workdir, args.out, n_gangs=args.n_gangs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
