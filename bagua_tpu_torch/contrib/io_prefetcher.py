"""ctypes wrapper over the C++ IO prefetcher: GIL-free file-reading threads.

The native data-path component (the reference's data tier uses torch
DataLoader worker processes + redis; here native reader threads feed the
input pipeline with no Python in the hot path).  The C++ source is the
port's copy, ``native/io_prefetcher.cpp``, built at first use by g++
(:mod:`bagua_tpu_torch.contrib.native`).  Typical use::

    pf = IOPrefetcher(n_threads=8)
    for path, payload in pf.read_ordered(paths):
        sample = decode(payload)

Results are delivered in submission order (an internal reorder buffer) while
reads proceed out-of-order across the thread pool.
"""

import ctypes
import threading
from typing import Iterable, Iterator, List, Optional, Tuple

from bagua_tpu_torch.contrib.native import build_library

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library("io_prefetcher", ("-lpthread",)))
            lib.bagua_prefetcher_create.restype = ctypes.c_void_p
            lib.bagua_prefetcher_create.argtypes = [ctypes.c_int, ctypes.c_uint64]
            lib.bagua_prefetcher_submit.restype = ctypes.c_int
            lib.bagua_prefetcher_submit.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
            ]
            lib.bagua_prefetcher_poll.restype = ctypes.c_int
            lib.bagua_prefetcher_poll.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int,
            ]
            lib.bagua_prefetcher_free_buffer.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
            lib.bagua_prefetcher_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


class IOPrefetcher:
    """Thread-pool file reader with bounded in-flight budget."""

    def __init__(self, n_threads: int = 4, capacity: int = 64):
        self._lib = _get_lib()
        self._handle = self._lib.bagua_prefetcher_create(n_threads, capacity)
        self._closed = False

    def submit(self, req_id: int, path: str) -> bool:
        """Queue a read; False means the in-flight budget is full."""
        return (
            self._lib.bagua_prefetcher_submit(self._handle, req_id, path.encode()) == 0
        )

    def poll(self, timeout_ms: int = 100) -> Optional[Tuple[int, Optional[bytes]]]:
        """One completed read as ``(req_id, payload-or-None-on-error)``."""
        rid = ctypes.c_uint64()
        data = ctypes.POINTER(ctypes.c_uint8)()
        size = ctypes.c_int64()
        got = self._lib.bagua_prefetcher_poll(
            self._handle, ctypes.byref(rid), ctypes.byref(data), ctypes.byref(size), timeout_ms
        )
        if not got:
            return None
        if size.value < 0:
            return int(rid.value), None
        payload = ctypes.string_at(data, size.value)
        self._lib.bagua_prefetcher_free_buffer(data)
        return int(rid.value), payload

    def read_ordered(self, paths: Iterable[str], timeout_ms: int = 10000) -> Iterator[Tuple[str, Optional[bytes]]]:
        """Stream ``(path, payload)`` in order while reads overlap."""
        paths = list(paths)
        pending = {}
        next_submit = 0
        next_yield = 0
        done = {}
        while next_yield < len(paths):
            while next_submit < len(paths) and self.submit(next_submit, paths[next_submit]):
                pending[next_submit] = paths[next_submit]
                next_submit += 1
            if next_yield in done:
                yield paths[next_yield], done.pop(next_yield)
                next_yield += 1
                continue
            res = self.poll(timeout_ms)
            if res is None:
                raise TimeoutError(f"prefetcher stalled waiting for {paths[next_yield]}")
            rid, payload = res
            pending.pop(rid, None)
            done[rid] = payload

    def close(self) -> None:
        if not self._closed:
            self._lib.bagua_prefetcher_destroy(self._handle)
            self._closed = True

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
