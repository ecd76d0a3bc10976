"""What the fleet lanes share: the control plane's server process, started
on a port that another process may take first, and its health probe; and
the retry on a fresh port that ``chip_smoke.py``'s launcher runs take too."""

import json
import socket
import subprocess
import sys
import time
import urllib.request

from bagua_tpu_torch.tools._lane import REPO

#: runs made again, each on a fresh port (a lane's also in a fresh WAL
#: directory), where another process took the port between free_port() and
#: the bind (or before a restart: the server's after the SIGKILL, the
#: launcher's on port + 1)
PORT_RETRIES = 2


class PortTaken(RuntimeError):
    """A server could not bind its port (EADDRINUSE)."""


def port_taken(output: str) -> bool:
    """Whether a process's output says that its port was in use."""
    return "EADDRINUSE" in output or "Address already in use" in output


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_server(args, log_path: str) -> subprocess.Popen:
    """``python -m bagua_tpu_torch.fleet.server args`` from the repo, its
    output appended to ``log_path``."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    log = open(log_path, "ab")
    try:
        return subprocess.Popen([sys.executable, "-m", "bagua_tpu_torch.fleet.server", *args],
                                stdout=log, stderr=log, env=env, cwd=REPO)
    finally:
        log.close()


def get_json(url: str, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def wait_health(base: str, proc: subprocess.Popen, log_path: str, deadline_s: float = 120.0) -> dict:
    """Polls ``/fleet/health`` until the server answers ``ok``.  Raises
    :class:`PortTaken` where the server exited for an address in use, and
    RuntimeError where it exited otherwise."""
    deadline = time.monotonic() + deadline_s
    last = None
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            with open(log_path, errors="replace") as f:
                tail = f.read()[-4000:]
            if port_taken(tail):
                raise PortTaken(f"{base}: the port was taken")
            raise RuntimeError(f"fleet server exited with {proc.returncode}:\n{tail}")
        try:
            out = get_json(f"{base}/fleet/health", timeout=2.0)
            if out.get("status") == "ok":
                return out
        except (OSError, ValueError) as e:
            last = e
        time.sleep(0.1)
    raise TimeoutError(f"fleet server never became healthy: {last!r}")


def canon(dump: dict) -> str:
    return json.dumps(dump, sort_keys=True)


def with_port_retries(what: str, run_once, say=None):
    """``run_once(try_index)``, again where it raised :class:`PortTaken`, at
    most PORT_RETRIES times, each retry a line through ``say`` (standard
    error by default)."""
    say = say or (lambda line: print(line, file=sys.stderr, flush=True))
    for retry in range(PORT_RETRIES + 1):
        try:
            return run_once(retry)
        except PortTaken as e:
            if retry == PORT_RETRIES:
                raise
            say(f"{what}: a port was taken (EADDRINUSE: {e}); retry {retry + 1} of {PORT_RETRIES} on a fresh port")
