"""Static collective-program verification sweep (committed as
``STATIC_VERIFY_TORCH.json``).

The port of the JAX package's ``ci/static_verify.py``.  It runs the static
gate (``bagua_tpu_torch/analysis/``) over every registered algorithm x wire
precision {f32, int8, int4} x overlap {off, on}: each cell builds the engine
on the lane's group, runs its step dry on the ``meta`` device (nothing is
allocated on the card and no kernel launches), captures the collective IR
and the flight program in the same pass, and runs the four checkers (rank
invariance, wire-byte exactness, plan conformance, static/dynamic flight
program agreement).  The JAX lane's MLP ``[64, 128, 128, 64]`` and 4096-byte
buckets.

Cell statuses:

* ``pass`` / ``fail``: the verifier ran; ``fail`` carries the findings.
* ``skipped``: the combination is not expressible (the algorithm has no
  ``wire_precision`` knob).
* ``fenced``: the engine itself refuses the combination at construction
  (e.g. int4 error-feedback state with overlap); the refusal is the row's
  evidence, a successful outcome.

For the modeled algorithms (``gradient_allreduce``, ``zero``) the sweep also
runs one **live** step under ``BAGUA_STATIC_VERIFY=strict`` with the flight
recorder attached, and asserts that the statically predicted flight program
equals the recorder's capture record for record.

The exit status is nonzero on any ``fail`` or live mismatch::

    python -m bagua_tpu_torch.tools.static_verify                 # the card
    python -m bagua_tpu_torch.tools.static_verify --device cpu    # 8 CPU ranks, 2 x 4
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

from bagua_tpu_torch.tools._lane import REPO, add_device_args, command_line, device_record, lane_group, mesh_of, \
    write_json

LAYERS = [64, 128, 128, 64]
BUCKET_BYTES = 1 << 12
WIRES = ("f32", "int8", "int4")
#: algorithms exposing the shared wire_precision knob
WIRE_KNOB_ALGOS = ("gradient_allreduce", "zero")
#: the JAX lane's group: 2 inter x 4 intra
INTRA_SIZE = 4


def make_batch(device):
    rng = np.random.RandomState(0)
    return (torch.from_numpy(rng.randn(32, LAYERS[0]).astype(np.float32)).to(device),
            torch.from_numpy(rng.randn(32, LAYERS[-1]).astype(np.float32)).to(device))


def init_params(device):
    """The MLP's parameters, drawn on the CPU from seed 0 (the same on every
    device)."""
    from bagua_tpu_torch.models.mlp import init_mlp

    params = init_mlp(torch.Generator().manual_seed(0), LAYERS, device="cpu")
    return {k: {n: t.to(device) for n, t in v.items()} for k, v in params.items()}


def build_ddp(group, name, wire, overlap, telemetry=None):
    from bagua_tpu_torch.algorithms import build_algorithm
    from bagua_tpu_torch.ddp import DistributedDataParallel
    from bagua_tpu_torch.models.mlp import mse_loss

    kwargs = {} if wire == "f32" else {"wire_precision": wire}
    algo = build_algorithm(name, lr=0.1, **kwargs)
    return DistributedDataParallel(
        mse_loss, lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9), algo, process_group=group,
        bucket_size_bytes=BUCKET_BYTES, overlap=overlap, telemetry=telemetry,
    )


def sweep_cell(group, params, batch, name, wire, overlap):
    from bagua_tpu_torch.analysis import MODELED_ALGOS, verify_step_program

    row = {"algo": name, "wire": wire, "overlap": overlap, "modeled": name in MODELED_ALGOS}
    if wire != "f32" and name not in WIRE_KNOB_ALGOS:
        row["status"] = "skipped"
        row["reason"] = "algorithm has no wire_precision knob"
        return row
    try:
        ddp = build_ddp(group, name, wire, overlap)
    except ValueError as e:
        row["status"] = "fenced"
        row["reason"] = str(e)
        return row
    try:
        state = ddp.init(params)
        variant = ddp.impl.step_variant(0)
        report = verify_step_program(ddp, state, batch, variant=variant)
        row["status"] = "pass" if report.ok else "fail"
        row["variant"] = str(variant)
        row["num_collectives"] = report.num_collectives
        row["findings"] = [f.to_json() for f in report.findings]
        row["wire_table"] = report.wire_table
        row["predicted_records"] = len(report.predicted)
        row["captured_records"] = len(report.captured)
    finally:
        ddp.shutdown()
    return row


def live_certify(group, params, batch, name):
    """One dispatched step under strict mode: the pre-dispatch gate verifies
    the dry run, the flight recorder captures the live program, and the
    engine's crosscheck (and this function's comparison) holds prediction
    == capture record for record."""
    from bagua_tpu_torch.analysis import check_static_dynamic
    from bagua_tpu_torch.observability.flight_recorder import FlightRecorder
    from bagua_tpu_torch.observability.telemetry import Telemetry

    tel = Telemetry(flight=FlightRecorder(capacity=256, rank=0, world_size=1))
    ddp = build_ddp(group, name, "f32", False, telemetry=tel)
    try:
        state = ddp.init(params)
        state, losses = ddp.train_step(state, batch)
        if group.device.type == "cuda":
            torch.cuda.synchronize(group.device)
        variant = ddp.impl.step_variant(0)
        captured = ddp._flight_programs.get(variant)
        predicted = ddp._predicted_programs.get(variant)
        if not captured or not predicted:
            return {"algo": name, "match": False, "reason": "missing flight program or prediction"}
        errors = [str(f) for f in check_static_dynamic(predicted, captured) if f.severity == "error"]
        return {"algo": name, "variant": str(variant), "records": len(captured), "match": not errors,
                "mismatches": errors}
    finally:
        ddp.shutdown()


def wire_multiset(row) -> list:
    """A cell's wire table as a multiset: the JAX sweep lists an overlap
    step's buckets in another order than the port's ``backward_order()``."""
    return sorted(json.dumps(w, sort_keys=True) for w in row.get("wire_table", ()))


def run_sweep(group, algo=None, log=None) -> dict:
    """The sweep on ``group`` under ``BAGUA_STATIC_VERIFY=strict``; returns
    the report (``rows``, ``live_capture``, ``summary``)."""
    log = log or sys.stderr
    from bagua_tpu_torch.algorithms import GlobalAlgorithmRegistry
    from bagua_tpu_torch.analysis import MODELED_ALGOS

    saved = os.environ.get("BAGUA_STATIC_VERIFY")
    os.environ["BAGUA_STATIC_VERIFY"] = "strict"
    try:
        params = init_params(group.device)
        batch = make_batch(group.device)
        names = [n for n in GlobalAlgorithmRegistry.keys() if algo is None or n == algo]
        rows = []
        for name in names:
            for wire in WIRES:
                for overlap in (False, True):
                    row = sweep_cell(group, params, batch, name, wire, overlap)
                    rows.append(row)
                    print(f"[static-verify] {name:28s} wire={wire:4s} overlap={int(overlap)} -> {row['status']}"
                          + (f" ({row['num_collectives']} collectives)" if "num_collectives" in row else ""),
                          file=log)
        live = []
        for name in MODELED_ALGOS:
            if algo is not None and name != algo:
                continue
            res = live_certify(group, params, batch, name)
            live.append(res)
            print(f"[static-verify] live {name}: " + ("match" if res["match"] else f"MISMATCH {res}"), file=log)
    finally:
        if saved is None:
            os.environ.pop("BAGUA_STATIC_VERIFY", None)
        else:
            os.environ["BAGUA_STATIC_VERIFY"] = saved
    summary = {s: sum(1 for r in rows if r["status"] == s) for s in ("pass", "fail", "skipped", "fenced")}
    summary["live_match"] = sum(1 for r in live if r["match"])
    summary["live_mismatch"] = sum(1 for r in live if not r["match"])
    return {
        "schema": 1,
        "generated_by": "bagua_tpu_torch/tools/static_verify.py",
        "command": command_line(),
        "device": device_record(group),
        "mesh": mesh_of(group),
        "model": {"layers": LAYERS, "bucket_size_bytes": BUCKET_BYTES},
        "modeled_algos": list(MODELED_ALGOS),
        "summary": summary,
        "rows": rows,
        "live_capture": live,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "STATIC_VERIFY_TORCH.json"),
                    help="where to write the sweep report (default: the repo's root)")
    ap.add_argument("--algo", default=None, help="restrict the sweep to one algorithm")
    add_device_args(ap)
    args = ap.parse_args(argv)

    group = lane_group(args.device, args.ranks, args.intra_size, cpu_intra_size=INTRA_SIZE)
    report = run_sweep(group, args.algo)
    write_json(args.out, report)
    summary = report["summary"]
    print(f"[static-verify] wrote {args.out}: {summary}", file=sys.stderr)
    failed = summary["fail"] + summary["live_mismatch"]
    if failed:
        print(f"[static-verify] {failed} failure(s)", file=sys.stderr)
        return 1
    print("[static-verify] all verified", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
