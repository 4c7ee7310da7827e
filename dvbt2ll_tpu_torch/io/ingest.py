"""Native TS ingest: ctypes bindings for csrc/ts_ingest.cc.

The reference leans on the GNU Radio runtime for its input path (the
``ule_ule_source`` block and GR's single-writer ring buffers feeding
``bbheaderbch_bb``); here a small C++ runtime does the same job for the
transmit chain: a producer thread pumps an fd into a lock-free ring, aligns
and re-syncs on the 0x47 sync byte, stuffs null packets on underrun, and
emits step-sized windows with the 187-byte carry prepended.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "ts_ingest.cc")
# generated and not kept in git, beside the CUDA kernels' builds
_LIB_CACHE = os.path.join(_PKG, "_build", "_ts_ingest.so")
_lib = None
_lock = threading.Lock()


def _build_lib() -> str:
    if (not os.path.exists(_LIB_CACHE)
            or os.path.getmtime(_LIB_CACHE) < os.path.getmtime(_SRC)):
        os.makedirs(os.path.dirname(_LIB_CACHE), exist_ok=True)
        tmp = f"{_LIB_CACHE}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
             "-o", tmp, _SRC], check=True)
        os.replace(tmp, _LIB_CACHE)  # atomic for a concurrent builder
    return _LIB_CACHE


def _load():
    global _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(_build_lib())
            except OSError:
                # stale/foreign-arch cached .so: force a rebuild
                os.remove(_LIB_CACHE)
                lib = ctypes.CDLL(_build_lib())
            lib.ts_ingest_create.restype = ctypes.c_void_p
            lib.ts_ingest_create.argtypes = [ctypes.c_uint64, ctypes.c_int]
            lib.ts_ingest_destroy.argtypes = [ctypes.c_void_p]
            lib.ts_ingest_pump.restype = ctypes.c_int64
            lib.ts_ingest_pump.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
            lib.ts_ingest_window.restype = ctypes.c_int
            lib.ts_ingest_window.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_uint64, ctypes.c_int]
            lib.ts_ingest_available.restype = ctypes.c_uint64
            lib.ts_ingest_available.argtypes = [ctypes.c_void_p]
            lib.ts_ingest_stats.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
            lib.ts_ingest_eof.restype = ctypes.c_int
            lib.ts_ingest_eof.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


class TSIngest:
    """Single-producer/single-consumer TS framing ring over a C++ core.

    Use ``pump()`` from an ingest thread (or call ``start_thread()``) and
    ``window(fresh_bytes)`` from the transmit loop; the returned array is
    ``187 + fresh_bytes`` long (carry + fresh), ready for the step.
    """

    def __init__(self, fd: int = -1, capacity: int = 1 << 22):
        self._lib = _load()
        self._h = self._lib.ts_ingest_create(capacity, fd)
        if not self._h:
            raise MemoryError("ts_ingest_create failed")
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def pump(self, budget: int = 1 << 16) -> int:
        """Pull up to ``budget`` bytes from the fd into the ring; returns
        packets pushed, -1 on EOF."""
        return int(self._lib.ts_ingest_pump(self._h, budget))

    def window(self, fresh: int, allow_stuffing: bool = True
               ) -> Optional[np.ndarray]:
        out = np.empty(187 + fresh, dtype=np.uint8)
        ok = self._lib.ts_ingest_window(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            fresh, int(allow_stuffing))
        return out if ok else None

    @property
    def available(self) -> int:
        return int(self._lib.ts_ingest_available(self._h))

    @property
    def stats(self) -> dict:
        buf = (ctypes.c_uint64 * 4)()
        self._lib.ts_ingest_stats(self._h, buf)
        return {"packets_in": buf[0], "sync_errors": buf[1],
                "null_stuffed": buf[2], "bytes_out": buf[3]}

    @property
    def eof(self) -> bool:
        return bool(self._lib.ts_ingest_eof(self._h))

    def start_thread(self) -> None:
        """Continuous background pumping until EOF or close()."""
        def run():
            while not self._stop.is_set():
                n = self.pump()
                if n < 0:
                    break
                if n == 0:
                    self._stop.wait(0.001)
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None
        if self._h:
            self._lib.ts_ingest_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
