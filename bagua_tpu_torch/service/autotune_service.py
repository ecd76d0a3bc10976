"""The autotune HTTP service (rank-0 hosted).

Analog of the reference's Flask app (``service/autotune_service.py:154-298``)
on the stdlib ``ThreadingHTTPServer``.  Endpoints (same paths):

    POST /api/v1/register_tensors
    POST /api/v1/report_metrics
    POST /api/v1/ask_hyperparameters
    POST /api/v1/report_tensor_execution_order
    GET  /api/v1/health_check

Gating mirrors the reference: no tuning during the warmup window, at most one
sample per ``sampling_confidence_time``, and after ``max_samples`` the service
locks to the best observed hyperparameters
(``autotune_service.py:102-152``).
"""

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from bagua_tpu_torch.defs import BaguaHyperparameter, TensorDeclaration
from bagua_tpu_torch.service.autotune_task_manager import AutotuneTaskManager

logger = logging.getLogger(__name__)

#: POST route → AutotuneService method name; shared with the fleet control
#: plane (``bagua_tpu_torch.fleet.server``), which serves the same API per gang
#: namespace under ``/g/<gang_id>/api/v1/...``.
AUTOTUNE_POST_ROUTES = {
    "/api/v1/register_tensors": "register_tensors",
    "/api/v1/report_metrics": "report_metrics",
    "/api/v1/ask_hyperparameters": "ask_hyperparameters",
    "/api/v1/report_tensor_execution_order": "report_tensor_execution_order",
    "/api/v1/planner_trail": "planner_trail",
}


class AutotuneService:
    def __init__(
        self,
        world_size: int,
        autotune_level: int = 0,
        max_samples: int = 60,
        sampling_confidence_time_s: float = 5.0,
        warmup_time_s: float = 30.0,
        is_output_autotune_log: bool = False,
        default_bucket_size: int = 10 * 1024 ** 2,
        tune_wire_dtype: bool = False,
        tune_overlap: bool = False,
    ):
        self.world_size = world_size
        self.autotune_level = autotune_level
        self.max_samples = max_samples
        self.sampling_confidence_time_s = sampling_confidence_time_s
        self.warmup_time_s = warmup_time_s
        self.is_output_autotune_log = is_output_autotune_log
        self.default_bucket_size = default_bucket_size
        self.tune_wire_dtype = tune_wire_dtype
        self.tune_overlap = tune_overlap

        self._lock = threading.Lock()
        self._managers: Dict[str, AutotuneTaskManager] = {}
        self._start_time: Dict[str, float] = {}
        self._last_sample_time: Dict[str, float] = {}
        # per-model, per-rank latest reported speed (averaged when sampling,
        # reference keeps a check board per rank, autotune_service.py:35-45)
        self._speeds: Dict[str, Dict[int, float]] = {}
        # Multi-process plan-change agreement.  Ranks must adopt a new bucket
        # plan at the SAME training step or their collective patterns desync
        # (hang).  The service tracks each rank's LATEST asked train_iter; a
        # sample fires only once every rank has asked, and the proposal
        # becomes *effective from* max(latest asked) + 1 — past the furthest
        # iter any rank has already been answered for, so every rank first
        # sees the new plan at the same (future) ask step, regardless of how
        # far ahead a fast host loop runs.
        self._rank_latest_ask: Dict[str, Dict[int, int]] = {}
        self._hp_effective: Dict[str, list] = {}  # [(effective_from, hp, final)]
        # The hp each gang is *currently running*: workers adopt the hp
        # returned by their latest ask, so the next reported speed was
        # measured under the last *answer*, not the newest proposal (which
        # only becomes effective — and adopted — one ask-round later).
        # Scores must be credited to this, or every sample shifts onto the
        # next point and the optimizer converges beside the optimum.
        self._measured_hp: Dict[str, object] = {}

    def _manager(self, model_name: str) -> AutotuneTaskManager:
        if model_name not in self._managers:
            self._managers[model_name] = AutotuneTaskManager(
                model_name, self.is_output_autotune_log,
                tune_wire_dtype=self.tune_wire_dtype,
                tune_overlap=self.tune_overlap,
            )
            self._start_time[model_name] = time.time()
            self._last_sample_time[model_name] = 0.0
            self._speeds[model_name] = {}
        return self._managers[model_name]

    # -- endpoint logic ------------------------------------------------------

    def register_tensors(self, payload: Dict) -> Dict:
        model_name = payload["model_name"]
        decls = [TensorDeclaration(**td) for td in payload["tensor_list"]]
        with self._lock:
            mgr = self._manager(model_name)
            mgr.tensor_list = decls
            if not mgr.hyperparameter.buckets:
                mgr.hyperparameter = mgr.recommended_from_param_dict(
                    {
                        "bucket_size_2p": max(10, self.default_bucket_size.bit_length() - 1),
                        "is_hierarchical_reduce": 0,
                        # label the pre-tuning samples with the wire dtype /
                        # execution mode they are actually measured under
                        # (the client may have preconfigured bf16 or overlap)
                        "wire_bf16": int(bool(payload.get("current_wire_bf16", False))),
                        "overlap": int(bool(payload.get("current_overlap", False))),
                    }
                )
                mgr.hyperparameter.bucket_size = self.default_bucket_size
            elif mgr.sampling_counter == 0:
                # Re-registration before any GP proposal: the restarted gang
                # may have changed its preconfigured wire dtype / execution
                # mode — refresh the labels so its pre-tuning samples credit
                # the right knob values.
                if self.tune_wire_dtype:
                    mgr.hyperparameter.wire_bf16 = bool(
                        payload.get("current_wire_bf16", False)
                    )
                if self.tune_overlap:
                    mgr.hyperparameter.overlap = bool(
                        payload.get("current_overlap", False)
                    )
            # (Re-)registration = a (re)started gang whose train_iter restarts
            # from 0: reset the per-rank ask ratchet and re-base the
            # effective-from history on the current hyperparameters, or new
            # proposals would only take effect past the pre-restart iteration
            # and speeds would be attributed to never-adopted plans.
            self._rank_latest_ask.pop(model_name, None)
            self._speeds[model_name] = {}
            self._hp_effective[model_name] = [
                (0, mgr.hyperparameter, mgr.sampling_counter >= self.max_samples)
            ]
            self._measured_hp[model_name] = mgr.hyperparameter
            return {"recommended_hyperparameters": mgr.hyperparameter.to_dict()}

    def report_metrics(self, payload: Dict) -> Dict:
        model_name = payload["model_name"]
        rank = int(payload["rank"])
        speed = float(payload["speed"])
        with self._lock:
            self._manager(model_name)
            self._speeds[model_name][rank] = speed
        return {"status": "ok"}

    def _effective_hp(self, model_name: str, train_iter: int, mgr):
        """The hyperparameters in force for asks at ``train_iter`` — the last
        history entry whose effective_from <= train_iter."""
        history = self._hp_effective.setdefault(
            model_name,
            # seed marks final when sampling is already closed (e.g.
            # max_samples=0 disables tuning -> completed from the first ask)
            [(0, mgr.hyperparameter, mgr.sampling_counter >= self.max_samples)],
        )
        current = history[0]
        for entry in history:
            if entry[0] <= train_iter:
                current = entry
        return current  # (effective_from, hp, is_final)

    def ask_hyperparameters(self, payload: Dict) -> Dict:
        model_name = payload["model_name"]
        rank = int(payload.get("rank", 0))
        train_iter = int(payload.get("train_iter", 0))
        with self._lock:
            mgr = self._manager(model_name)
            now = time.time()
            _, hp, is_final = self._effective_hp(model_name, train_iter, mgr)
            if self.autotune_level >= 1 and not is_final:
                latest = self._rank_latest_ask.setdefault(model_name, {})
                latest[rank] = max(latest.get(rank, 0), train_iter)
                in_warmup = now - self._start_time[model_name] < self.warmup_time_s
                confident = (
                    now - self._last_sample_time[model_name]
                    >= self.sampling_confidence_time_s
                )
                speeds = self._speeds[model_name]
                sampling_open = mgr.sampling_counter < self.max_samples
                if (
                    sampling_open
                    and not in_warmup
                    and confident
                    and len(speeds) >= self.world_size
                    and len(latest) >= self.world_size
                ):
                    score = sum(speeds.values()) / len(speeds)
                    mgr.tell_and_ask(
                        score,
                        train_iter,
                        measured_hp=self._measured_hp.get(
                            model_name, mgr.hyperparameter
                        ),
                    )
                    self._last_sample_time[model_name] = now
                    self._speeds[model_name] = {}
                    final = mgr.sampling_counter >= self.max_samples
                    new_hp = mgr.lock_best() if final else mgr.hyperparameter
                    self._hp_effective[model_name].append(
                        (max(latest.values()) + 1, new_hp, final)
                    )
            # whatever we answer is what this gang runs until its next ask —
            # the configuration the next reported speed is measured under
            self._measured_hp[model_name] = hp
            return {
                "recommended_hyperparameters": hp.to_dict(),
                "is_autotune_completed": is_final,
            }

    def report_tensor_execution_order(self, payload: Dict) -> Dict:
        model_name = payload["model_name"]
        with self._lock:
            self._manager(model_name).report_spans(payload.get("spans", []))
        return {"status": "ok"}

    def planner_trail(self, payload: Dict) -> Dict:
        """The trace-driven planner's decision record for one model: mode,
        fitted cost model, ranked candidates, warm-start points, DP-vs-greedy
        predicted costs and the chosen proposal (see
        ``AutotuneTaskManager.decision_trail``)."""
        model_name = payload["model_name"]
        with self._lock:
            return {"trail": self._manager(model_name).decision_trail}

    # -- HTTP plumbing ---------------------------------------------------------

    def make_handler(self):
        service = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # silence
                logger.debug(fmt, *args)

            def _send(self, obj, code=200):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/api/v1/health_check":
                    self._send({"status": "ok"})
                else:
                    self._send({"error": "not found"}, 404)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    self._send({"error": "bad json"}, 400)
                    return
                name = AUTOTUNE_POST_ROUTES.get(self.path)
                fn = getattr(service, name) if name is not None else None
                if fn is None:
                    self._send({"error": "not found"}, 404)
                    return
                try:
                    self._send(fn(payload))
                except Exception as e:  # surface errors to the client
                    logger.exception("autotune endpoint error")
                    self._send({"error": str(e)}, 500)

        return Handler


def start_autotune_server(
    service: AutotuneService, port: int = 0
) -> ThreadingHTTPServer:
    """Start the service in a daemon thread; returns the live server (its
    ``server_address[1]`` is the bound port).  Analog of the reference
    spawning a Flask process from ``init_process_group``
    (``communication.py:384-420``)."""
    # Bind all interfaces: workers on other hosts reach the service at
    # AUTO_TUNE_SERVER_ADDR (the reference's Flask service binds 0.0.0.0 too,
    # ``communication.py:399``).
    server = ThreadingHTTPServer(("0.0.0.0", port), service.make_handler())
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server
