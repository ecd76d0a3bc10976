"""Cross-host KV store over the rendezvous HTTP server's blob tier.

TPU-native analog of the reference's ``RedisStore``
(``contrib/utils/redis_store.py:46-137``): where the reference bootstraps
one redis server per node and routes keys across them with a hashed
``ClusterStore``, we reuse the rendezvous store — the HTTP server every
elastic job already runs (``bagua_tpu_torch.distributed.rendezvous``) — as the
node-local KV daemon, and route across hosts with the same
:class:`~bagua_tpu_torch.contrib.store.ClusterStore`.  No new infrastructure: a
cluster that can rendezvous can also share a dataset cache.

Values are pickled client-side and shipped as raw ``application/octet-stream``
bodies (``PUT/GET /rdzv/blob/<key>``), so arbitrary sample objects (numpy
arrays, tuples, dicts) round-trip without a JSON detour.  The server bounds
the blob tier with LRU eviction, mirroring redis's ``maxmemory`` +
``allkeys-lru`` configuration in the reference (``redis_store.py:113-137``).

Two entry points:

* :class:`RendezvousStore` — one endpoint, the ``Store`` interface.
* :func:`make_rendezvous_cluster_store` — N endpoints (typically one per
  node, like the reference's ``hosts`` parameter), optionally bootstrapping
  a local server when this host's own endpoint is not yet serving
  (``bootstrap=True`` ≈ ``RedisStore(bootstrap=True)``).
"""

import http.client
import os
import pickle
import threading
from typing import List, Optional, Sequence, Tuple
from urllib.parse import quote, urlparse

from bagua_tpu_torch.contrib.store import ClusterStore, Store


def _host_port(endpoint: str) -> Tuple[str, int]:
    if "://" not in endpoint:
        endpoint = "http://" + endpoint
    u = urlparse(endpoint)
    return u.hostname or "127.0.0.1", u.port or 80


class RendezvousStore(Store):
    """``Store`` backed by one rendezvous server's blob tier.

    Keeps one persistent HTTP connection per thread (the rendezvous server
    is a ``ThreadingHTTPServer``; keep-alive avoids a TCP handshake per
    sample, which dominates for small cached items).
    """

    def __init__(self, endpoint: str, timeout_s: float = 60.0,
                 token: Optional[str] = None):
        self.host, self.port = _host_port(endpoint)
        self.timeout_s = timeout_s
        # Shared secret matching the server's ``blob_token`` — values are
        # pickles, so the blob routes are gated (a writer who can PUT blobs
        # can execute code on every reader).  Defaults from the environment
        # (``BAGUA_STORE_TOKEN``) like the server side; on a fully trusted
        # network both sides may leave it unset.
        self.token = token if token is not None else os.environ.get("BAGUA_STORE_TOKEN")
        self._local = threading.local()

    # -- connection management ----------------------------------------------

    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout_s
            )
            self._local.conn = conn
        return conn

    def _request(self, method: str, path: str, body: Optional[bytes] = None):
        """One request with a single reconnect retry (the server may have
        closed an idle keep-alive connection between batches)."""
        headers = {"X-Bagua-Store-Token": self.token} if self.token else {}
        for attempt in (0, 1):
            conn = self._conn()
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                return resp.status, resp.read()
            except (http.client.HTTPException, ConnectionError, BrokenPipeError, OSError):
                conn.close()
                self._local.conn = None
                if attempt:
                    raise
        raise AssertionError("unreachable")

    # -- Store interface -----------------------------------------------------

    def set(self, key: str, value) -> None:
        status, _ = self._request(
            "PUT", f"/rdzv/blob/{quote(key, safe='')}",
            pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL),
        )
        if status != 200:
            raise RuntimeError(f"rendezvous store PUT {key!r} -> HTTP {status}")

    def get(self, key: str):
        status, body = self._request("GET", f"/rdzv/blob/{quote(key, safe='')}")
        if status == 404:
            return None
        if status != 200:
            raise RuntimeError(f"rendezvous store GET {key!r} -> HTTP {status}")
        return pickle.loads(body)

    def num_keys(self) -> int:
        import json

        status, body = self._request("GET", "/rdzv/blobs")
        if status != 200:
            raise RuntimeError(f"rendezvous store count -> HTTP {status}")
        return int(json.loads(body)["count"])

    def clear(self) -> None:
        status, _ = self._request("DELETE", "/rdzv/blobs")
        if status != 200:
            raise RuntimeError(f"rendezvous store clear -> HTTP {status}")

    def status(self) -> bool:
        try:
            self.num_keys()
            return True
        except OSError:
            return False
        except RuntimeError:
            return False

    def shutdown(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None


def make_rendezvous_cluster_store(
    endpoints: Sequence[str],
    bootstrap: bool = False,
    bootstrap_port: Optional[int] = None,
    max_blob_bytes: int = 1 << 30,
    timeout_s: float = 60.0,
    token: Optional[str] = None,
) -> ClusterStore:
    """Hashed-key store across N rendezvous blob tiers (one per node).

    Mirrors the reference's cluster construction
    (``redis_store.py:46-99``): every worker passes the same ordered
    ``endpoints`` list so the xxhash routing in ``ClusterStore`` agrees
    cluster-wide.  With ``bootstrap=True``, a local rendezvous server is
    started on ``bootstrap_port`` when nothing is serving there yet — the
    analog of ``RedisStore`` starting a local ``redis-server`` — and kept
    alive for the process lifetime (daemon thread).
    """
    if not endpoints:
        raise ValueError("need at least one endpoint")
    if bootstrap:
        from bagua_tpu_torch.distributed.rendezvous import (
            RendezvousState,
            start_rendezvous_server,
        )

        if bootstrap_port is None:
            ports = {_host_port(e)[1] for e in endpoints}
            if len(ports) > 1:
                # This process cannot know which endpoint is local; guessing
                # endpoints[0]'s port would leave a differently-numbered
                # local shard unserved (and half the keyspace erroring).
                raise ValueError(
                    f"endpoints use different ports {sorted(ports)}; pass "
                    "bootstrap_port to say which one THIS host should serve"
                )
            (port,) = ports
        else:
            port = bootstrap_port
        probe = RendezvousStore(f"127.0.0.1:{port}", timeout_s=5.0, token=token)
        if not probe.status():
            state = RendezvousState(max_blob_bytes=max_blob_bytes, blob_token=token)
            try:
                start_rendezvous_server(state, port)
            except OSError:
                # Probe-then-bind race: a sibling worker on this host
                # bootstrapped between our probe and bind.  Any serving
                # process is as good as ours (RedisStore(bootstrap=True)
                # tolerates an already-running server the same way).
                if not probe.status():
                    raise
        probe.shutdown()
    stores: List[Store] = [
        RendezvousStore(e, timeout_s=timeout_s, token=token) for e in endpoints
    ]
    return ClusterStore(stores)
