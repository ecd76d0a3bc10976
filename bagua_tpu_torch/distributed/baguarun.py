"""Multi-host fan-out launcher: ``python -m bagua_tpu_torch.distributed.baguarun``.

A copy of the JAX package's fan-out launcher, the analog of the reference's ``baguarun`` (``script/baguarun.py:36-113``),
which parallel-ssh-launches ``bagua.distributed.run`` on every host with the
right ``--node_rank``.  This does the same with stdlib subprocess + ssh:

    baguarun --hosts "10.0.0.1 10.0.0.2" --nproc_per_node 4 train.py --lr 0.1

Per host ``i`` it runs (via ssh, or locally for host-simulation tests):

    python -m bagua_tpu_torch.distributed.run --nnodes <N> --node_rank <i>
        --master_addr <host 0> ... train.py --lr 0.1

Selected env vars are forwarded through ssh the way the reference forwards
its ``BAGUA_*``/``NCCL_*`` set (``baguarun.py:72-87``); here the set is
``BAGUA_*``, ``NCCL_*``, ``CUDA_*`` and ``TORCH_*``.

``--launcher subprocess`` replaces ssh with local subprocesses — the CI /
single-machine simulation mode (each "host" is a local launcher process);
``--launcher ssh`` is the production path.
"""

import argparse
import os
import shlex
import subprocess
import sys
from typing import List

FORWARD_ENV_PREFIXES = ("BAGUA_", "NCCL_", "CUDA_", "TORCH_")


def parse_args(argv=None):
    p = argparse.ArgumentParser("bagua_tpu_torch.distributed.baguarun")
    p.add_argument(
        "--hosts", type=str, default=None,
        help='space-separated host list, e.g. "10.0.0.1 10.0.0.2"; '
        "host 0 becomes the master",
    )
    p.add_argument(
        "--hostfile", type=str, default=None, help="file with one host per line"
    )
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--master_port", type=int, default=29500)
    p.add_argument("--bagua_service_port", type=int, default=29501)
    p.add_argument("--autotune_level", type=int, default=0)
    p.add_argument("--max_restarts", type=int, default=3)
    p.add_argument("--ssh_port", type=int, default=22)
    p.add_argument(
        "--launcher", choices=("ssh", "subprocess"), default="ssh",
        help="ssh = production fan-out; subprocess = simulate hosts locally",
    )
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def read_hosts(args) -> List[str]:
    if args.hostfile:
        with open(args.hostfile) as f:
            hosts = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    elif args.hosts:
        hosts = args.hosts.split()
    else:
        raise SystemExit("one of --hosts / --hostfile is required")
    if not hosts:
        raise SystemExit("empty host list")
    return hosts


def node_command(args, hosts: List[str], node_rank: int) -> List[str]:
    """The ``bagua_tpu_torch.distributed.run`` invocation for one host."""
    return [
        sys.executable, "-u", "-m", "bagua_tpu_torch.distributed.run",
        "--nnodes", str(len(hosts)),
        "--node_rank", str(node_rank),
        "--nproc_per_node", str(args.nproc_per_node),
        "--master_addr", hosts[0] if args.launcher == "ssh" else "127.0.0.1",
        "--master_port", str(args.master_port),
        "--bagua_service_port", str(args.bagua_service_port),
        "--autotune_level", str(args.autotune_level),
        "--max_restarts", str(args.max_restarts),
        args.training_script, *args.training_script_args,
    ]


def forwarded_env_assignments() -> List[str]:
    return [
        f"{k}={shlex.quote(v)}"
        for k, v in os.environ.items()
        if k.startswith(FORWARD_ENV_PREFIXES)
    ]


def spawn(args, hosts: List[str]) -> List[subprocess.Popen]:
    procs = []
    for node_rank, host in enumerate(hosts):
        cmd = node_command(args, hosts, node_rank)
        if args.launcher == "ssh":
            remote = " ".join(
                ["cd", shlex.quote(os.getcwd()), "&&", "env"]
                + forwarded_env_assignments()
                + [shlex.quote(c) for c in cmd]
            )
            full = ["ssh", "-p", str(args.ssh_port), host, remote]
        else:
            full = cmd
        procs.append(subprocess.Popen(full))
    return procs


def main(argv=None) -> int:
    args = parse_args(argv)
    hosts = read_hosts(args)
    procs = spawn(args, hosts)
    rc = 0
    try:
        for p in procs:
            rc = rc or (p.wait() or 0)
    except KeyboardInterrupt:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        rc = 130
    return rc


if __name__ == "__main__":
    sys.exit(main())
