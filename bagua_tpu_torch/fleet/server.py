"""HTTP front-end for the fleet control plane.

Route map (one port serves the whole fleet):

    /g/<gang_id>/rdzv/...        per-gang rendezvous/KV/blob (the full
                                 ``distributed.rendezvous`` route table,
                                 delegated per namespace)
    /g/<gang_id>/api/v1/...      per-gang autotune API (the full
                                 ``service.autotune_service`` route table)
    /g/<gang_id>/spans           POST: ingest a batch of client-side spans
                                 (+ timeline events) into the gang's
                                 volatile span ring
    /g/<gang_id>/incidents       POST: ingest a batch of regression-sentinel
                                 ``perf_regression`` incidents into the
                                 gang's volatile incident ring
    /g/<gang_id>/decisions       POST: ingest a batch of autopilot
                                 ``plan_decision`` events into the gang's
                                 volatile decision ring
    /g/<gang_id>/directive       GET: the gang's oldest pending remediation
                                 directive (rollback_plan/resize), or null
    /g/<gang_id>/directive/ack   POST: acknowledge a directive by id
    /fleet/plan/publish          POST: store a proven plan in the cross-gang
                                 cache (fingerprint/topology/algorithm/
                                 wire_precision + plan payload)
    /fleet/plan/lookup           POST: cache lookup by the same key (an
                                 optional ``gang`` identity journals the
                                 adoption and applies canary gating)
    /fleet/remediate             POST: run one RemediationEngine sweep
    /fleet/remediation           GET: the durable remediation tier (plan
                                 statuses, directives, action counters)
    /fleet/shards                GET: shard topology (count, gangs per
                                 shard, per-shard WAL replay wall time)
    /fleet/scheduler             GET: per-gang wedged/straggler/regressed/
                                 healthy/idle verdict view
    /fleet/incidents[?gang=<id>] GET: the volatile perf_regression incident
                                 tier (every gang, or one gang's ring)
    /fleet/decisions[?gang=<id>] GET: the volatile autopilot plan_decision
                                 tier (every gang, or one gang's ring)
    /fleet/gangs                 GET: gang ids + lease remainders
    /fleet/timeline?gang=<id>    GET: the gang's causally ordered timeline
                                 (client+server spans joined by trace_id,
                                 StepSummary windows, flight digests)
    /fleet/metrics               GET: Prometheus text exposition (per-gang
                                 request/429 counts, lease remainders,
                                 plan-cache hits/misses)
    /fleet/dump                  GET: deterministic durable-state dump (the
                                 kill/restart bitwise witness)
    /fleet/health                GET: liveness

Every handled ``/g/...`` request is also recorded as a *server-side span*
(child of the caller's ``traceparent`` when one arrives) in the gang's
volatile ring — the server half of the cross-process trace join.

Every ``/g/...`` request passes the gang's token bucket first — a denial
is ``429`` + ``Retry-After`` (the contract ``retry_call`` paces on and the
circuit breaker ignores) — and touches the gang's lease; an untouched
lease expiring GCs the whole namespace.

Run standalone (what the load lane SIGKILLs and restarts)::

    python -m bagua_tpu_torch.fleet.server --port 29500 --wal-dir /var/lib/bagua
"""

import json
import logging
import math
import threading
import time
from http.server import ThreadingHTTPServer
from typing import Optional, Tuple

from bagua_tpu_torch.distributed.rendezvous import _Handler as _RdzvHandler
from bagua_tpu_torch.fleet.control_plane import FleetControlPlane, GangNamespace
from bagua_tpu_torch.service.autotune_service import AUTOTUNE_POST_ROUTES

logger = logging.getLogger("bagua_tpu_torch.fleet")

__all__ = [
    "FleetHandler",
    "start_fleet_server",
    "AsyncFleetServer",
    "start_async_fleet_server",
    "main",
]


class FleetHandler(_RdzvHandler):
    """Multi-tenant dispatcher reusing the rendezvous handler's route table
    per gang namespace."""

    fleet: FleetControlPlane  # bound by start_fleet_server
    state = None  # the single-tenant binding is never used here

    def _reply(self, payload: dict, code: int = 200, headers=None):
        self._status = code  # server-span attribution (see _record_server_span)
        super()._reply(payload, code, headers)

    def _reply_text(self, text: str, content_type: str = "text/plain; version=0.0.4"):
        body = text.encode()
        self._status = 200
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _record_server_span(self, t0: float) -> None:
        """Record the handled request as a server-side span in its gang's
        volatile ring (no-op for un-ganged ``/fleet/*`` routes).  Fenced:
        span bookkeeping must never turn a served request into a 500."""
        gang_id = getattr(self, "_span_gang", None)
        if gang_id is None:
            return
        try:
            self.fleet.record_server_span(
                gang_id,
                route=self.path.split("?", 1)[0],
                status=int(getattr(self, "_status", 200)),
                dur_ms=(time.monotonic() - t0) * 1e3,
                traceparent=self.headers.get("traceparent"),
                retry_after_s=getattr(self, "_retry_after_s", None),
            )
        except Exception:
            logger.exception("server-span recording failed (gang %r)", gang_id)

    def _gang_route(self, drained: bool) -> Optional[Tuple[GangNamespace, str]]:
        """Resolve ``/g/<gang_id>/<sub>`` → (namespace, sub-path), applying
        admission control + the lease touch.  Replies (429/404) and returns
        None when the request doesn't reach a namespace.  ``drained`` must
        be True for bodied methods — under keep-alive an unread body
        desyncs the connection, so callers drain before any early reply."""
        assert drained or self.command == "GET", "body must be drained first"
        from urllib.parse import unquote

        rest = self.path[len("/g/"):]
        gang_quoted, sep, sub = rest.partition("/")
        gang_id = unquote(gang_quoted)
        if not gang_id or not sep:
            self._reply({"error": "bad gang route"}, 404)
            return None
        self._span_gang = gang_id
        ok, retry_after = self.fleet.admit(gang_id)
        if not ok:
            self._retry_after_s = retry_after
            self._reply(
                {"error": "backpressure", "retry_after_s": round(retry_after, 3)},
                429,
                headers={"Retry-After": max(1, math.ceil(retry_after))},
            )
            return None
        return self.fleet.gang(gang_id), "/" + sub

    def _autotune(self, ns: GangNamespace, sub: str, payload: dict) -> None:
        name = AUTOTUNE_POST_ROUTES.get(sub)
        if name is None:
            self._reply({"error": "not found"}, 404)
            return
        service = ns.autotune_service(world_size=payload.get("world_size"))
        try:
            self._reply(getattr(service, name)(payload))
        except Exception as e:
            logger.exception("autotune endpoint error (gang %r)", ns.gang_id)
            self._reply({"error": str(e)}, 500)

    # -- verbs ----------------------------------------------------------------

    def do_GET(self):
        t0 = time.monotonic()
        try:
            if self.path.startswith("/g/"):
                route = self._gang_route(drained=True)
                if route is not None:
                    ns, sub = route
                    if sub == "/api/v1/health_check":
                        self._reply({"status": "ok"})
                    elif sub == "/directive":
                        self._reply({
                            "gang": ns.gang_id,
                            "directive": self.fleet.directive(ns.gang_id),
                        })
                    else:
                        self._handle_get(ns.rendezvous, sub)
            elif self.path == "/fleet/scheduler":
                self._reply(self.fleet.scheduler_view())
            elif self.path == "/fleet/gangs":
                self._reply({"gangs": self.fleet.gang_ids(),
                             "gangs_gcd": self.fleet.gangs_gcd,
                             "backpressure_denials": self.fleet.backpressure_denials})
            elif self.path == "/fleet/metrics":
                self._reply_text(self.fleet.metrics_text())
            elif self.path == "/fleet/remediation":
                self._reply(self.fleet.remediation_summary())
            elif self.path == "/fleet/shards":
                self._reply(self.fleet.shard_info())
            elif self.path.split("?", 1)[0] == "/fleet/incidents":
                from urllib.parse import parse_qs, urlsplit

                gang = (parse_qs(urlsplit(self.path).query).get("gang") or [None])[0]
                self._reply(self.fleet.incidents(gang))
            elif self.path.split("?", 1)[0] == "/fleet/decisions":
                from urllib.parse import parse_qs, urlsplit

                gang = (parse_qs(urlsplit(self.path).query).get("gang") or [None])[0]
                self._reply(self.fleet.decisions(gang))
            elif self.path.split("?", 1)[0] == "/fleet/timeline":
                from urllib.parse import parse_qs, urlsplit

                gang = (parse_qs(urlsplit(self.path).query).get("gang") or [""])[0]
                if not gang:
                    self._reply({"error": "missing gang parameter"}, 400)
                else:
                    self._reply(self.fleet.timeline(gang))
            elif self.path == "/fleet/dump":
                self._reply(self.fleet.dump())
            elif self.path == "/fleet/health":
                self._reply({"status": "ok", "gangs": len(self.fleet.gang_ids()),
                             "plans": self.fleet.plan_count()})
            else:
                self._reply({"error": "not found"}, 404)
        finally:
            self._record_server_span(t0)
            self.fleet.maybe_compact()

    def do_PUT(self):
        t0 = time.monotonic()
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        try:
            if self.path.startswith("/g/"):
                route = self._gang_route(drained=True)
                if route is not None:
                    ns, sub = route
                    self._handle_put(ns.rendezvous, sub, body)
            else:
                self._reply({"error": "not found"}, 404)
        finally:
            self._record_server_span(t0)
            self.fleet.maybe_compact()

    def do_DELETE(self):
        t0 = time.monotonic()
        try:
            if self.path.startswith("/g/"):
                route = self._gang_route(drained=True)
                if route is not None:
                    ns, sub = route
                    self._handle_delete(ns.rendezvous, sub)
            else:
                self._reply({"error": "not found"}, 404)
        finally:
            self._record_server_span(t0)
            self.fleet.maybe_compact()

    def do_POST(self):
        t0 = time.monotonic()
        try:
            payload = self._body()
        except (ValueError, json.JSONDecodeError):
            return self._reply({"error": "bad json"}, 400)
        try:
            if self.path.startswith("/g/"):
                route = self._gang_route(drained=True)
                if route is not None:
                    ns, sub = route
                    if sub.startswith("/api/v1/"):
                        self._autotune(ns, sub, payload)
                    elif sub == "/spans":
                        self._reply(self.fleet.ingest_spans(
                            ns.gang_id,
                            payload.get("spans") or [],
                            payload.get("events") or [],
                        ))
                    elif sub == "/incidents":
                        self._reply(self.fleet.ingest_incidents(
                            ns.gang_id, payload.get("incidents") or [],
                        ))
                    elif sub == "/decisions":
                        self._reply(self.fleet.ingest_decisions(
                            ns.gang_id, payload.get("decisions") or [],
                        ))
                    elif sub == "/directive/ack":
                        try:
                            directive_id = int(payload["id"])
                        except (KeyError, TypeError, ValueError):
                            self._reply({"error": "missing/bad id"}, 400)
                        else:
                            self._reply({"ok": self.fleet.ack_directive(
                                ns.gang_id, directive_id)})
                    else:
                        self._handle_post(ns.rendezvous, sub, payload)
            elif self.path == "/fleet/plan/publish":
                try:
                    key = self.fleet.plan_put(
                        fingerprint=payload["fingerprint"],
                        topology=payload["topology"],
                        algorithm=payload["algorithm"],
                        wire_precision=payload["wire_precision"],
                        plan=payload["plan"],
                        meta=payload.get("meta"),
                    )
                except KeyError as e:
                    self._reply({"error": f"missing field {e}"}, 400)
                else:
                    self._reply({"ok": True, "key": key})
            elif self.path == "/fleet/plan/lookup":
                try:
                    entry = self.fleet.plan_get(
                        fingerprint=payload["fingerprint"],
                        topology=payload["topology"],
                        algorithm=payload["algorithm"],
                        wire_precision=payload["wire_precision"],
                        gang=payload.get("gang"),
                    )
                except KeyError as e:
                    self._reply({"error": f"missing field {e}"}, 400)
                else:
                    if entry is None:
                        self._reply({"found": False})
                    else:
                        self._reply(dict(entry, found=True))
            elif self.path == "/fleet/remediate":
                knobs = {}
                if isinstance(payload.get("quarantine_threshold"), int):
                    knobs["quarantine_threshold"] = payload["quarantine_threshold"]
                self._reply(self.fleet.remediate(**knobs))
            else:
                self._reply({"error": "not found"}, 404)
        finally:
            self._record_server_span(t0)
            self.fleet.maybe_compact()


def start_fleet_server(
    fleet: FleetControlPlane, port: int, host: str = "0.0.0.0"
) -> ThreadingHTTPServer:
    """Serve the control plane in a daemon thread; returns the live server
    (``server_address[1]`` is the bound port — pass 0 for ephemeral)."""
    handler = type("BoundFleetHandler", (FleetHandler,), {"fleet": fleet})
    server = ThreadingHTTPServer((host, port), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


class AsyncFleetServer:
    """Selector-based single-threaded I/O loop serving the same
    :class:`FleetHandler` route table.

    The thread-per-request :class:`ThreadingHTTPServer` tops out around a
    thousand concurrent keep-alive connections (a stack per idle gang);
    this loop multiplexes them all on one ``selectors`` poll — stdlib
    only, no new deps.  Every fleet/rendezvous/autotune handler is
    non-blocking by construction (in-memory state + a WAL append), so
    dispatching inline on the event loop keeps p99 flat at 1000-gang
    fan-in where the threaded server degrades.

    Request framing: we buffer until the header block plus the declared
    ``Content-Length`` body is complete, then drive the handler over
    ``BytesIO`` files.  Chunked request bodies are not supported — every
    shipped client (urllib + ``http.client``) sends Content-Length.
    Keep-alive follows the handler's ``close_connection`` verdict, so
    HTTP/1.1 clients hold one connection for their whole session.
    """

    _MAX_BUF = 64 * 1024 * 1024  # runaway-request backstop per connection

    def __init__(self, fleet, port: int, host: str = "0.0.0.0"):
        import selectors
        import socket

        self.fleet = fleet
        self._handler_cls = self._make_shim(fleet)
        self._sel = selectors.DefaultSelector()
        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind((host, port))
        self._listen.listen(1024)
        self._listen.setblocking(False)
        self.server_address = self._listen.getsockname()
        # self-pipe: shutdown() pokes the loop awake from any thread
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._running = True
        self._conns: dict = {}  # sock -> {"in": bytes, "out": bytes, "close": bool}
        self._sel.register(self._listen, selectors.EVENT_READ, "accept")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")

    @staticmethod
    def _make_shim(fleet):
        """A FleetHandler subclass driven over in-memory files instead of a
        socket: ``__init__`` skips the socketserver machinery, the caller
        feeds ``raw_requestline``/``parse_request`` and invokes the verb."""

        class _Shim(FleetHandler):
            def __init__(self, rfile, wfile, client_address):
                self.rfile = rfile
                self.wfile = wfile
                self.client_address = client_address
                self.close_connection = True
                self.requestline = ""
                self.request_version = self.default_request_version
                self.command = ""

        _Shim.fleet = fleet
        return _Shim

    @staticmethod
    def _split_request(buf: bytes):
        """One complete request (headers + Content-Length body) off the
        front of ``buf``, or (None, buf) while it's still partial."""
        head_end = buf.find(b"\r\n\r\n")
        if head_end < 0:
            return None, buf
        clen = 0
        for line in buf[:head_end].split(b"\r\n")[1:]:
            if line.lower().startswith(b"content-length:"):
                try:
                    clen = int(line.split(b":", 1)[1].strip())
                except ValueError:
                    clen = 0
        total = head_end + 4 + max(0, clen)
        if len(buf) < total:
            return None, buf
        return buf[:total], buf[total:]

    def _dispatch(self, request: bytes, client_address):
        """Drive the handler shim over one framed request; returns
        (response_bytes, keep_alive)."""
        import io

        rfile, wfile = io.BytesIO(request), io.BytesIO()
        h = self._handler_cls(rfile, wfile, client_address)
        try:
            h.raw_requestline = rfile.readline(65537)
            if not h.raw_requestline or not h.parse_request():
                return wfile.getvalue(), False
            method = getattr(h, "do_" + h.command, None)
            if method is None:
                h.send_error(501)
                return wfile.getvalue(), False
            method()
            return wfile.getvalue(), not h.close_connection
        except Exception:
            logger.exception("async dispatch failed")
            body = b'{"error": "internal"}'
            return (
                b"HTTP/1.1 500 Internal Server Error\r\n"
                b"Content-Type: application/json\r\n"
                b"Content-Length: " + str(len(body)).encode() + b"\r\n"
                b"Connection: close\r\n\r\n" + body
            ), False

    def serve_forever(self):
        import selectors

        while self._running:
            for key, _events in self._sel.select(timeout=0.5):
                if key.data == "wake":
                    return self._close_all()
                if key.data == "accept":
                    self._accept()
                    continue
                sock = key.fileobj
                conn = self._conns.get(sock)
                if conn is None:
                    continue
                if _events & selectors.EVENT_READ:
                    self._readable(sock, conn)
                if sock in self._conns and _events & selectors.EVENT_WRITE:
                    self._writable(sock, conn)
            if not self._running:
                break
        self._close_all()

    def _accept(self):
        import selectors

        try:
            sock, addr = self._listen.accept()
        except OSError:
            return
        sock.setblocking(False)
        self._conns[sock] = {"in": b"", "out": b"", "close": False, "addr": addr}
        self._sel.register(sock, selectors.EVENT_READ, "conn")

    def _interest(self, sock, conn):
        import selectors

        mask = selectors.EVENT_READ
        if conn["out"]:
            mask |= selectors.EVENT_WRITE
        self._sel.modify(sock, mask, "conn")

    def _readable(self, sock, conn):
        try:
            data = sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            return self._drop(sock)
        if not data:
            return self._drop(sock)
        conn["in"] += data
        if len(conn["in"]) > self._MAX_BUF:
            return self._drop(sock)
        while True:
            request, conn["in"] = self._split_request(conn["in"])
            if request is None:
                break
            response, keep_alive = self._dispatch(request, conn["addr"])
            conn["out"] += response
            if not keep_alive:
                conn["close"] = True
                conn["in"] = b""
                break
        self._interest(sock, conn)
        self._flush(sock, conn)

    def _writable(self, sock, conn):
        self._flush(sock, conn)

    def _flush(self, sock, conn):
        while conn["out"]:
            try:
                n = sock.send(conn["out"])
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                return self._drop(sock)
            if n <= 0:
                break
            conn["out"] = conn["out"][n:]
        if not conn["out"] and conn["close"]:
            return self._drop(sock)
        if sock in self._conns:
            self._interest(sock, conn)

    def _drop(self, sock):
        self._conns.pop(sock, None)
        try:
            self._sel.unregister(sock)
        except (KeyError, ValueError):
            pass
        try:
            sock.close()
        except OSError:
            pass

    def _close_all(self):
        for sock in list(self._conns):
            self._drop(sock)
        for sock in (self._listen, self._wake_r, self._wake_w):
            try:
                self._sel.unregister(sock)
            except (KeyError, ValueError):
                pass
            try:
                sock.close()
            except OSError:
                pass
        self._running = False

    def shutdown(self):
        self._running = False
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass


def start_async_fleet_server(
    fleet, port: int, host: str = "0.0.0.0"
) -> AsyncFleetServer:
    """Serve the control plane on the selector loop in a daemon thread;
    same contract as :func:`start_fleet_server` (``server_address[1]`` is
    the bound port, ``shutdown()`` stops it)."""
    server = AsyncFleetServer(fleet, port, host)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def main(argv=None) -> int:
    """Standalone fleet control plane (the deployment mode: one of these
    outlives every gang it serves; the load lane SIGKILLs it mid-run and
    restarts it on the same port + WAL dir)."""
    import argparse

    p = argparse.ArgumentParser("bagua_tpu_torch.fleet.server")
    p.add_argument("--port", type=int, default=29500)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--wal-dir", default=None,
                   help="durability directory (no WAL = in-memory only)")
    p.add_argument("--lease-ttl-s", type=float, default=None,
                   help="gang lease TTL (default BAGUA_FLEET_LEASE_TTL_S)")
    p.add_argument("--rate", type=float, default=None,
                   help="per-gang admitted requests/s (default BAGUA_FLEET_RATE; 0 = off)")
    p.add_argument("--burst", type=float, default=None,
                   help="per-gang burst capacity (default BAGUA_FLEET_BURST)")
    p.add_argument("--compact-every", type=int, default=1000)
    p.add_argument("--fsync", action="store_true")
    p.add_argument("--min-nodes", type=int, default=1)
    p.add_argument("--settle-s", type=float, default=1.0)
    p.add_argument("--member-ttl-s", type=float, default=30.0)
    p.add_argument("--shards", type=int, default=1,
                   help="consistent-hash control-plane shards (per-shard WALs)")
    p.add_argument("--canary-n", type=int, default=2,
                   help="adopter gangs that must report clean before a "
                        "cached plan graduates canary -> default")
    p.add_argument("--io", choices=("async", "thread"), default="async",
                   help="selector event loop (default) or thread-per-request")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[bagua_tpu_torch.fleet] %(message)s")
    plane_kwargs = dict(
        lease_ttl_s=args.lease_ttl_s,
        rate=args.rate,
        burst=args.burst,
        compact_every=args.compact_every,
        fsync=args.fsync,
        canary_n=args.canary_n,
        rdzv_kwargs={
            "min_nodes": args.min_nodes,
            "settle_s": args.settle_s,
            "ttl_s": args.member_ttl_s,
        },
    )
    if args.shards > 1:
        from bagua_tpu_torch.fleet.shards import ShardedControlPlane

        fleet = ShardedControlPlane(
            n_shards=args.shards, wal_dir=args.wal_dir, **plane_kwargs
        )
    else:
        fleet = FleetControlPlane(wal_dir=args.wal_dir, **plane_kwargs)
    if args.io == "async":
        server = start_async_fleet_server(fleet, args.port, args.host)
    else:
        server = start_fleet_server(fleet, args.port, args.host)
    # the parent (launcher, CI lane) waits for this line before connecting
    print(f"fleet control plane on port {server.server_address[1]}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.shutdown()
        fleet.close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
