"""Client for the autotune service (reference ``AutotuneClient``,
``service/autotune_service.py:325``) — stdlib urllib, no requests dependency.

Every RPC goes through the resilience retry layer
(:func:`bagua_tpu_torch.resilience.retry.retry_call`): transient connection
failures are retried with jittered exponential backoff
(``BAGUA_RPC_RETRIES`` x ``BAGUA_RPC_BACKOFF_BASE_S``), and persistent ones
trip the client's circuit breaker so a dead service fails fast instead of
stacking 10s timeouts on every tick.  The *caller* (``AutotuneSession``)
additionally degrades to its current local hyperparameters when the failure
surfaces — the service is advisory, never load-bearing.
"""

import json
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional

from bagua_tpu_torch.defs import BaguaHyperparameter, TensorDeclaration
from bagua_tpu_torch.env import get_bagua_service_port


class AutotuneClient:
    """``prefix`` prepends every route (no trailing slash) — the fleet
    control plane serves each gang's autotune API under
    ``/g/<gang_id>/api/v1/...``, so a fleet-attached client passes
    ``prefix="/g/<gang_id>"`` and everything else is unchanged.  ``timeout``
    defaults to the shared ``BAGUA_RPC_TIMEOUT_S`` knob."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: Optional[int] = None,
        timeout: Optional[float] = None,
        prefix: str = "",
    ):
        from bagua_tpu_torch.env import (
            get_rpc_breaker_cooldown_s, get_rpc_breaker_threshold,
            get_rpc_timeout_s,
        )
        from bagua_tpu_torch.resilience.retry import CircuitBreaker, RetryPolicy

        port = port if port is not None else get_bagua_service_port()
        self.base = f"http://{host}:{port}{prefix}"
        self.timeout = get_rpc_timeout_s() if timeout is None else timeout
        self.retry_policy = RetryPolicy()
        self.breaker = CircuitBreaker(
            failure_threshold=get_rpc_breaker_threshold(),
            cooldown_s=get_rpc_breaker_cooldown_s(),
            name="autotune-rpc",
        )

    def _post_once(self, path: str, payload: Dict) -> Dict:
        from bagua_tpu_torch.observability.tracing import client_span

        with client_span(
            f"rpc {path}", component="autotune", endpoint=path
        ) as (_sp, trace_headers):
            req = urllib.request.Request(
                self.base + path,
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json", **trace_headers},
                method="POST",
            )
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    return json.loads(resp.read())
            except urllib.error.HTTPError as e:
                if e.code == 429:
                    from bagua_tpu_torch.resilience.retry import (
                        BackpressureError, retry_after_hint,
                    )

                    raise BackpressureError(
                        f"{self.base + path}: 429 backpressure",
                        retry_after_hint(e) or 0.0,
                    ) from e
                raise

    def _post(self, path: str, payload: Dict) -> Dict:
        from bagua_tpu_torch.resilience.retry import retry_call

        return retry_call(
            self._post_once, path, payload,
            policy=self.retry_policy, breaker=self.breaker, label=path,
        )

    def health_check(self) -> bool:
        try:
            req = urllib.request.Request(self.base + "/api/v1/health_check")
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status == 200
        except (urllib.error.URLError, ConnectionError, OSError):
            return False

    def wait_until_ready(self, max_wait_s: Optional[float] = None) -> bool:
        """Poll the health check until the service answers, for at most
        ``max_wait_s`` (``BAGUA_AUTOTUNE_SERVER_WAIT_TIME`` by default)."""
        if max_wait_s is None:
            from bagua_tpu_torch.env import get_autotune_server_wait_time_s

            max_wait_s = get_autotune_server_wait_time_s()
        deadline = time.time() + max_wait_s
        while time.time() < deadline:
            if self.health_check():
                return True
            time.sleep(0.2)
        return False

    def register_tensors(
        self, model_name: str, tensor_list: List[TensorDeclaration],
        current_wire_bf16: bool = False,
        current_overlap: bool = False,
    ) -> BaguaHyperparameter:
        resp = self._post(
            "/api/v1/register_tensors",
            {
                "model_name": model_name,
                "tensor_list": [td.to_dict() for td in tensor_list],
                # the wire dtype / execution mode the scores will initially
                # be measured under (a tuning service labels its first GP
                # sample with these, instead of assuming f32 / monolithic)
                "current_wire_bf16": bool(current_wire_bf16),
                "current_overlap": bool(current_overlap),
            },
        )
        return BaguaHyperparameter.from_dict(resp["recommended_hyperparameters"])

    def report_metrics(
        self, model_name: str, rank: int, train_iter: int, speed: float
    ) -> None:
        self._post(
            "/api/v1/report_metrics",
            {
                "model_name": model_name,
                "rank": rank,
                "train_iter": train_iter,
                "speed": speed,
            },
        )

    def ask_hyperparameters(
        self, model_name: str, rank: int, train_iter: int
    ):
        resp = self._post(
            "/api/v1/ask_hyperparameters",
            {"model_name": model_name, "rank": rank, "train_iter": train_iter},
        )
        return (
            BaguaHyperparameter.from_dict(resp["recommended_hyperparameters"]),
            bool(resp["is_autotune_completed"]),
        )

    def report_tensor_execution_order(self, model_name: str, spans: List[Dict]) -> None:
        self._post(
            "/api/v1/report_tensor_execution_order",
            {"model_name": model_name, "spans": spans},
        )

    def get_planner_trail(self, model_name: str) -> Dict:
        """The service-side trace-driven planner's decision record (mode,
        cost model, ranked candidates, warm-start points, chosen plan)."""
        resp = self._post("/api/v1/planner_trail", {"model_name": model_name})
        return resp.get("trail", {})


def get_hyperparameters_service_client() -> AutotuneClient:
    """Build a client pointing at the job's autotune service.

    Resolution order (reference ``env.py:get_autotune_server_addr``):
    ``AUTO_TUNE_SERVER_ADDR`` (``host:port``, exported by the launcher) >
    ``MASTER_ADDR`` + ``BAGUA_SERVICE_PORT`` > localhost + default port —
    so workers on non-master hosts reach the master's service.
    """
    import os

    addr = os.environ.get("AUTO_TUNE_SERVER_ADDR")
    if addr and ":" in addr:
        host, _, port_s = addr.rpartition(":")
        return AutotuneClient(host=host, port=int(port_s))
    return AutotuneClient(host=os.environ.get("MASTER_ADDR", "127.0.0.1"))
