"""Build the contrib tier's C++ sources (``shm_store.cpp``,
``io_prefetcher.cpp``) into shared libraries at first use.

The sources are the port's own copies of the JAX package's.  ``g++``
builds each into ``_build/lib<name>-<hash>.so`` beside this file (a
git-ignored directory), keyed by a hash of the source and the flags, so an
edited source builds anew and an unchanged one is loaded as it is.  The
compiler writes to a file of its own process and ``os.replace`` puts it in
place, so processes that build at once never load a half-written library.
A failed build raises :class:`RuntimeError` with the compiler's output:
there is no fallback store.
"""

import hashlib
import os
import subprocess
from typing import Tuple

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(NATIVE_DIR, "_build")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def library_path(name: str, libs: Tuple[str, ...]) -> str:
    """Where ``<name>.cpp`` builds to under these link flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + libs).encode())
    with open(os.path.join(NATIVE_DIR, f"{name}.cpp"), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_library(name: str, libs: Tuple[str, ...] = ("-lpthread",)) -> str:
    """Compile ``<name>.cpp`` unless its library is built; returns its path."""
    so_path = library_path(name, libs)
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.tmp{os.getpid()}"
    src = os.path.join(NATIVE_DIR, f"{name}.cpp")
    proc = subprocess.run(["g++", *CXX_FLAGS, src, "-o", tmp, *libs], capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"g++ failed to build {src} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so_path)
    return so_path
