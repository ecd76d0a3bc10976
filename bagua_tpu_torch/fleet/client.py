"""Client-side view of the fleet control plane.

:class:`FleetClient` talks to the fleet endpoints (plan cache, scheduler
view, dump) and hands out per-gang clients: the existing
:class:`~bagua_tpu_torch.distributed.rendezvous.RendezvousClient` and
:class:`~bagua_tpu_torch.service.autotune_client.AutotuneClient` work unchanged
against a gang namespace because both concatenate paths onto a base URL —
the namespace is just the ``/g/<gang_id>`` prefix.

The cross-gang warm start: a gang that finishes tuning publishes its
proven plan (:func:`publish_engine_plan`); a brand-new gang with the same
(model fingerprint, topology, algorithm, wire precision) adopts it at
step 0 (:func:`adopt_fleet_plan` → ``plan_source="fleet"``) — the
resilience manifest's warm start, generalized across jobs.
"""

import hashlib
import json
import logging
from typing import Dict, Optional

logger = logging.getLogger("bagua_tpu_torch.fleet")

__all__ = [
    "gang_endpoint",
    "model_fingerprint",
    "engine_plan_key",
    "FleetClient",
    "publish_engine_plan",
    "adopt_fleet_plan",
]


def gang_endpoint(base: str, gang_id: str) -> str:
    """The namespaced endpoint a gang's rendezvous/autotune clients use."""
    from urllib.parse import quote

    if "://" not in base:
        base = "http://" + base
    return f"{base.rstrip('/')}/g/{quote(str(gang_id), safe='')}"


def model_fingerprint(declarations) -> str:
    """Stable fingerprint of a model's communicable-tensor set: sha256 over
    the sorted (name, num_elements, dtype) triples, independent of bucket
    assignment (the thing the cached plan *decides*)."""
    triples = sorted(
        (td.name, int(td.num_elements), str(td.dtype)) for td in declarations
    )
    digest = hashlib.sha256(json.dumps(triples).encode()).hexdigest()
    return digest[:16]


def engine_plan_key(ddp, wire_precision: Optional[str] = None) -> Dict[str, str]:
    """The plan-cache key tuple for a live engine: model fingerprint from
    its declaration list, topology from the gang size, algorithm from the
    impl class, wire precision from the impl knob (or the caller)."""
    decls = [td for bucket in ddp.plan.declarations() for td in bucket]
    if wire_precision is None:
        wire_precision = str(getattr(ddp.impl, "wire_precision", None) or "f32")
    return {
        "fingerprint": model_fingerprint(decls),
        "topology": f"ranks{ddp.group.size}",
        "algorithm": type(ddp.impl).__name__,
        "wire_precision": wire_precision,
    }


class FleetClient:
    """Stdlib-only client for the ``/fleet/*`` endpoints, hardened on the
    same retry/breaker machinery as every other service client."""

    def __init__(self, endpoint: str, timeout_s: Optional[float] = None):
        from bagua_tpu_torch.env import (
            get_rpc_breaker_cooldown_s, get_rpc_breaker_threshold,
            get_rpc_timeout_s,
        )
        from bagua_tpu_torch.resilience.retry import CircuitBreaker, RetryPolicy

        if "://" not in endpoint:
            endpoint = "http://" + endpoint
        self.endpoint = endpoint.rstrip("/")
        self.timeout_s = get_rpc_timeout_s() if timeout_s is None else timeout_s
        self.retry_policy = RetryPolicy()
        self.breaker = CircuitBreaker(
            failure_threshold=get_rpc_breaker_threshold(),
            cooldown_s=get_rpc_breaker_cooldown_s(),
            name="fleet-rpc",
        )

    # -- transport -------------------------------------------------------------

    def _call_once(self, path: str, payload: Optional[dict] = None) -> dict:
        import urllib.error
        import urllib.request

        from bagua_tpu_torch.observability.tracing import client_span

        url = self.endpoint + path
        with client_span(
            f"rpc {path}", component="fleet", endpoint=path
        ) as (_sp, trace_headers):
            if payload is None:
                req = urllib.request.Request(url, headers=dict(trace_headers))
            else:
                req = urllib.request.Request(
                    url,
                    data=json.dumps(payload).encode(),
                    headers={"Content-Type": "application/json", **trace_headers},
                )
            try:
                with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                    return json.loads(resp.read())
            except urllib.error.HTTPError as e:
                if e.code == 429:
                    from bagua_tpu_torch.resilience.retry import (
                        BackpressureError, retry_after_hint,
                    )

                    raise BackpressureError(
                        f"{url}: 429 backpressure", retry_after_hint(e) or 0.0
                    ) from e
                raise

    def _call(self, path: str, payload: Optional[dict] = None) -> dict:
        from bagua_tpu_torch.resilience.retry import retry_call

        return retry_call(
            self._call_once, path, payload,
            policy=self.retry_policy, breaker=self.breaker, label=path,
        )

    # -- per-gang clients -------------------------------------------------------

    def gang_endpoint(self, gang_id: str) -> str:
        return gang_endpoint(self.endpoint, gang_id)

    def rendezvous_client(self, gang_id: str, node_rank: int, **kwargs):
        from bagua_tpu_torch.distributed.rendezvous import RendezvousClient

        return RendezvousClient(
            self.gang_endpoint(gang_id), node_rank=node_rank, **kwargs
        )

    def autotune_client(self, gang_id: str, **kwargs):
        from urllib.parse import quote, urlparse

        from bagua_tpu_torch.service.autotune_client import AutotuneClient

        parsed = urlparse(self.endpoint)
        return AutotuneClient(
            host=parsed.hostname,
            port=parsed.port,
            prefix=f"/g/{quote(str(gang_id), safe='')}",
            **kwargs,
        )

    # -- plan cache --------------------------------------------------------------

    def publish_plan(
        self,
        fingerprint: str,
        topology: str,
        algorithm: str,
        wire_precision: str,
        plan: dict,
        meta: Optional[dict] = None,
    ) -> str:
        out = self._call(
            "/fleet/plan/publish",
            {
                "fingerprint": fingerprint,
                "topology": topology,
                "algorithm": algorithm,
                "wire_precision": wire_precision,
                "plan": plan,
                "meta": meta or {},
            },
        )
        return out["key"]

    def lookup_plan(
        self, fingerprint: str, topology: str, algorithm: str,
        wire_precision: str, gang: Optional[str] = None,
    ) -> Optional[dict]:
        """Cache lookup.  Passing the gang's identity journals the adoption
        on the control plane (the remediation tier's correlation record)
        and applies canary gating — a plan still proving itself is only
        served to its cohort.  Without ``gang`` this is the legacy
        read-only lookup."""
        payload = {
            "fingerprint": fingerprint,
            "topology": topology,
            "algorithm": algorithm,
            "wire_precision": wire_precision,
        }
        if gang is not None:
            payload["gang"] = str(gang)
        out = self._call("/fleet/plan/lookup", payload)
        return out if out.get("found") else None

    # -- fleet views --------------------------------------------------------------

    def scheduler_view(self) -> dict:
        return self._call("/fleet/scheduler")

    def gangs(self) -> dict:
        return self._call("/fleet/gangs")

    def dump(self) -> dict:
        return self._call("/fleet/dump")

    def health(self) -> dict:
        return self._call("/fleet/health")

    # -- tracing ------------------------------------------------------------------

    def push_spans(self, gang_id: str, spans, events=None) -> dict:
        """Ship a batch of finished client spans (``bagua.span.v1`` dicts,
        e.g. ``Tracer.finished_spans()``) — plus optional timeline events —
        into the gang's volatile span ring on the control plane, where
        ``/fleet/timeline`` joins them with the server-side request spans."""
        from urllib.parse import quote

        return self._call(
            f"/g/{quote(str(gang_id), safe='')}/spans",
            {"spans": list(spans), "events": list(events or [])},
        )

    def timeline(self, gang_id: str) -> dict:
        """The gang's causally ordered timeline (client spans, server spans,
        StepSummary windows, health alerts, flight digests, incidents)."""
        from urllib.parse import quote

        return self._call(f"/fleet/timeline?gang={quote(str(gang_id), safe='')}")

    # -- incidents ----------------------------------------------------------------

    def push_incidents(self, gang_id: str, incidents) -> dict:
        """Ship a batch of regression-sentinel ``perf_regression``
        incidents (e.g. ``RegressionSentinel.drain_incidents()``) into the
        gang's volatile incident ring — what ``/fleet/scheduler`` folds
        into the ``regressed`` verdict and ``/fleet/incidents`` lists."""
        from urllib.parse import quote

        return self._call(
            f"/g/{quote(str(gang_id), safe='')}/incidents",
            {"incidents": list(incidents)},
        )

    def incidents(self, gang_id: Optional[str] = None) -> dict:
        """The fleet's volatile incident tier — every gang's recent
        ``perf_regression`` events, or one gang's when ``gang_id`` is
        given."""
        from urllib.parse import quote

        if gang_id is None:
            return self._call("/fleet/incidents")
        return self._call(f"/fleet/incidents?gang={quote(str(gang_id), safe='')}")

    # -- autopilot decisions ------------------------------------------------------

    def push_decisions(self, gang_id: str, decisions) -> dict:
        """Ship a batch of autopilot ``plan_decision`` events (e.g.
        ``GangAutopilot.drain_decisions()``) into the gang's volatile
        decision ring — what ``/fleet/scheduler`` surfaces as the gang's
        ``autopilot`` column and ``/fleet/decisions`` lists."""
        from urllib.parse import quote

        return self._call(
            f"/g/{quote(str(gang_id), safe='')}/decisions",
            {"decisions": list(decisions)},
        )

    def decisions(self, gang_id: Optional[str] = None) -> dict:
        """The fleet's volatile decision tier — every gang's recent
        autopilot ``plan_decision`` events, or one gang's when ``gang_id``
        is given."""
        from urllib.parse import quote

        if gang_id is None:
            return self._call("/fleet/decisions")
        return self._call(f"/fleet/decisions?gang={quote(str(gang_id), safe='')}")

    def metrics_text(self) -> str:
        """The server's ``/fleet/metrics`` Prometheus text exposition."""
        import urllib.request

        req = urllib.request.Request(self.endpoint + "/fleet/metrics")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return resp.read().decode()

    # -- remediation --------------------------------------------------------------

    def remediate(self, quarantine_threshold: Optional[int] = None) -> dict:
        """Run one RemediationEngine sweep on the control plane; returns
        the sweep summary (quarantined plans, rollback/resize directives
        issued, canary graduations, emitted events)."""
        payload = {}
        if quarantine_threshold is not None:
            payload["quarantine_threshold"] = int(quarantine_threshold)
        return self._call("/fleet/remediate", payload)

    def remediation(self) -> dict:
        """The durable remediation tier: every plan's quarantine/canary
        status, per-gang directives, and action counters."""
        return self._call("/fleet/remediation")

    def shards(self) -> dict:
        """Shard topology: shard count, gangs per shard, per-shard WAL
        replay wall time."""
        return self._call("/fleet/shards")

    def gang_directive(self, gang_id: str) -> Optional[dict]:
        """The gang's oldest pending remediation directive, or None —
        what the elastic-resume path polls before picking a world size."""
        from urllib.parse import quote

        out = self._call(f"/g/{quote(str(gang_id), safe='')}/directive")
        return out.get("directive")

    def ack_directive(self, gang_id: str, directive_id: int) -> bool:
        """Acknowledge a directive once acted on (clears the scheduler
        view's remediation-pending marker)."""
        from urllib.parse import quote

        out = self._call(
            f"/g/{quote(str(gang_id), safe='')}/directive/ack",
            {"id": int(directive_id)},
        )
        return bool(out.get("ok"))


def publish_engine_plan(
    fleet: FleetClient, ddp, meta: Optional[dict] = None,
    wire_precision: Optional[str] = None,
) -> Optional[str]:
    """Publish a live engine's proven plan to the cross-gang cache
    (best-effort; returns the cache key, or None when the engine has no
    exportable plan or the fleet is unreachable)."""
    payload = ddp.export_plan_payload()
    if payload is None:
        return None
    key = engine_plan_key(ddp, wire_precision=wire_precision)
    try:
        return fleet.publish_plan(plan=payload, meta=meta, **key)
    except (OSError, ConnectionError) as e:
        logger.warning("fleet plan publish failed (advisory): %s", e)
        return None


def adopt_fleet_plan(
    fleet: FleetClient, ddp, telemetry=None,
    wire_precision: Optional[str] = None, gang: Optional[str] = None,
) -> Optional[str]:
    """Step-0 warm start from the cross-gang plan cache.

    Looks up the engine's (fingerprint, topology, algorithm, wire
    precision) tuple; on a hit, adopts the cached plan and returns
    ``"fleet"`` — the ``plan_source`` value generalizing the resilience
    manifest's ``"carried"``.  Returns None on a miss, an unreachable
    fleet, or a payload that no longer fits (all advisory: the gang just
    runs its fresh plan).  With a ``gang`` identity the adoption is
    journaled on the control plane and canary gating applies — a plan
    still proving itself is withheld from gangs outside its cohort."""
    key = engine_plan_key(ddp, wire_precision=wire_precision)
    try:
        entry = fleet.lookup_plan(gang=gang, **key)
    except (OSError, ConnectionError) as e:
        logger.warning("fleet plan lookup failed (advisory): %s", e)
        return None
    if entry is None:
        return None
    try:
        adopted = ddp.adopt_plan_payload(entry["plan"])
    except Exception as e:
        logger.warning("fleet plan %s did not fit this engine: %s", key, e)
        return None
    if not adopted:
        return None
    logger.info("adopted fleet plan for %s at step 0 (plan_source=fleet)", key)
    if telemetry is not None:
        telemetry.on_restart(
            step=0,
            old_world_size=ddp.group.size,
            new_world_size=ddp.group.size,
            plan_source="fleet",
            lost_steps=0,
        )
    return "fleet"
