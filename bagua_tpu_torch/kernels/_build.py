"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so`` beside
this file, at first use.  The hash covers the source and the flags, so an
edited source builds anew and an unchanged one is loaded as it is.  The
library is opened with ``ctypes``; the wrappers pass pointers and the CUDA
stream as ``c_void_p``.

No fast-math: ``-fmad=false`` keeps every multiply and add separately
rounded, which the codec's bitwise contract with its plain version needs.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List, Tuple

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

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


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to, keyed by a hash of source and flags."""
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


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
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
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
