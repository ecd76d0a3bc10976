"""ctypes wrapper over the C++ shared-memory store.

Native-runtime analog of the reference's redis store
(``contrib/utils/redis_store.py:46-137``): a host-local, cross-process sample
cache — but served by one mmap'd POSIX shm segment instead of a bootstrapped
redis server.  The C++ source is the port's copy, ``native/shm_store.cpp``, built at
first use by g++ (:mod:`bagua_tpu_torch.contrib.native`).
"""

import ctypes
import pickle
import threading
from typing import Optional

from bagua_tpu_torch.contrib.native import build_library
from bagua_tpu_torch.contrib.store import Store

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library("shm_store", ("-lpthread", "-lrt")))
            lib.bagua_shm_store_open.restype = ctypes.c_void_p
            lib.bagua_shm_store_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int]
            lib.bagua_shm_store_set.restype = ctypes.c_int
            lib.bagua_shm_store_set.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
                ctypes.c_char_p, ctypes.c_uint64,
            ]
            lib.bagua_shm_store_get.restype = ctypes.c_int64
            lib.bagua_shm_store_get.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
                ctypes.c_char_p, ctypes.c_uint64,
            ]
            lib.bagua_shm_store_num_keys.restype = ctypes.c_uint64
            lib.bagua_shm_store_num_keys.argtypes = [ctypes.c_void_p]
            lib.bagua_shm_store_clear.argtypes = [ctypes.c_void_p]
            lib.bagua_shm_store_close.argtypes = [ctypes.c_void_p]
            lib.bagua_shm_store_unlink.argtypes = [ctypes.c_char_p]
            _lib = lib
        return _lib


class ShmStore(Store):
    """Cross-process KV store in POSIX shared memory.

    Args:
        name: shm segment name (same name = same store across processes).
        capacity_bytes: total segment size (values are append-allocated;
            overwrites consume new space until ``clear``).
        create: create the segment if missing.
    """

    def __init__(self, name: str = "/bagua_tpu_store", capacity_bytes: int = 64 * 1024 ** 2, create: bool = True):
        self._lib = _get_lib()
        self.name = name
        self._handle = self._lib.bagua_shm_store_open(
            name.encode(), capacity_bytes, 1 if create else 0
        )
        if not self._handle:
            raise OSError(f"cannot open shared-memory store {name!r}")

    def set(self, key: str, value) -> None:
        blob = pickle.dumps(value)
        rc = self._lib.bagua_shm_store_set(
            self._handle, key.encode(), len(key.encode()), blob, len(blob)
        )
        if rc != 0:
            raise MemoryError(
                f"shared-memory store {self.name!r} is full (or slot table exhausted)"
            )

    def get(self, key: str):
        kb = key.encode()
        n = self._lib.bagua_shm_store_get(self._handle, kb, len(kb), None, 0)
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(int(n))
        n2 = self._lib.bagua_shm_store_get(self._handle, kb, len(kb), buf, int(n))
        if n2 != n:
            return None
        return pickle.loads(buf.raw)

    def num_keys(self) -> int:
        return int(self._lib.bagua_shm_store_num_keys(self._handle))

    def clear(self) -> None:
        self._lib.bagua_shm_store_clear(self._handle)

    def shutdown(self) -> None:
        if self._handle:
            self._lib.bagua_shm_store_close(self._handle)
            self._handle = None

    def unlink(self) -> None:
        """Remove the segment from the system (after all processes close)."""
        self._lib.bagua_shm_store_unlink(self.name.encode())
