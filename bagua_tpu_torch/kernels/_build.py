"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so`` beside
this file, at first use.  The hash covers the source and the flags, so an
edited source builds anew and an unchanged one is loaded as it is.  The
library is opened with ``ctypes``; the wrappers pass pointers and the CUDA
stream as ``c_void_p``.

Flags are per source (:func:`flags`).  The codecs (``minmax_uint8``,
``quantized_ring``) build with ``-fmad=false``, which keeps every multiply
and add separately rounded, as their bitwise contract with the plain
versions needs.  Attention's and the tile GEMM's contracts are
tolerances, and their inner products run as fused multiply-adds, at twice
the rate.  No fast-math anywhere.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

#: devices whose tensors a wrapper hands to its kernel's plain version: the
#: CPU (the tests' device), and ``meta``, where the plain version computes
#: shapes only (the static verifier's dry run); neither launches a kernel
#: nor counts a launch
PLAIN_DEVICES = ("cpu", "meta")

#: when a dict, each codec and hop wrapper records its first launch in it
#: under its name (a ring hop: ``hop_dequant_add_requant_int<bits>``):
#: copies of its operands and of its outputs, for a caller to hold against
#: the plain version on the same inputs (``examples/gang.py``); None, the
#: default, records nothing
WITNESS: Optional[dict] = None


def witness(key: str, operands: tuple, outputs: tuple) -> None:
    """Record a launch in :data:`WITNESS`, called by a wrapper after it
    launched its kernel (which leaves its operands as they were)."""
    if WITNESS is None or key in WITNESS:
        return
    import torch

    def copy(v):
        return v.clone() if torch.is_tensor(v) else v
    WITNESS[key] = (tuple(copy(v) for v in operands), tuple(copy(v) for v in outputs))

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)
#: flags beyond NVCC_FLAGS, per source
SOURCE_FLAGS = {
    "minmax_uint8": ("-fmad=false",),
    "quantized_ring": ("-fmad=false",),
    "flash_attention": (),
    "collective_matmul": (),
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else from ``CUDA_HOME`` or the toolkit's
    default install location."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: install the CUDA toolkit or set CUDA_HOME")


def flags(name: str) -> Tuple[str, ...]:
    """``nvcc``'s flags for ``csrc/<name>.cu``."""
    return NVCC_FLAGS + SOURCE_FLAGS[name]


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to, keyed by a hash of the source,
    the shared headers (``csrc/*.cuh``) and its flags."""
    h = hashlib.sha256(" ".join(flags(name)).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str]) -> List[Tuple[str, str, float]]:
    """Build the named sources that are not built yet, one ``nvcc`` each,
    all started together.  Returns ``(name, path, seconds)`` per source;
    ``nvcc``'s output (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside each library as ``<path>.log``.  Raises if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            jobs.append((name, path, None, 0.0))
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *flags(name), "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, path, proc, time.perf_counter()))
    built = []
    for name, path, proc, t0 in jobs:
        if proc is None:
            built.append((name, path, 0.0))
            continue
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        tmp = f"{path}.{os.getpid()}.tmp"
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{out}")
        with open(f"{path}.log", "w") as f:
            f.write(out)
        os.replace(tmp, path)
        built.append((name, path, seconds))
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if need be."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            (_, path, _), = build([name])
            lib = ctypes.CDLL(path)
            _libs[name] = lib
        return lib
