"""Native async IQ sink: ctypes bindings for csrc/iq_sink.cc.

The reference flowgraph ends in a gain multiply + ``uhd_usrp_sink`` whose
UHD driver streams asynchronously to hardware; here a small C++ runtime
does the same hand-off for file/fd outputs: ``write()`` copies the window
into a lock-free ring and returns, and a writer thread applies the gain
and streams 4 MB chunks to the descriptor, overlapping host IO with the
next device step.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "iq_sink.cc")
# generated and not kept in git, beside the CUDA kernels' builds
_LIB_CACHE = os.path.join(_PKG, "_build", "_iq_sink.so")
_lib = None
_lock = threading.Lock()


def _build_lib() -> str:
    if (not os.path.exists(_LIB_CACHE)
            or os.path.getmtime(_LIB_CACHE) < os.path.getmtime(_SRC)):
        os.makedirs(os.path.dirname(_LIB_CACHE), exist_ok=True)
        tmp = f"{_LIB_CACHE}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-pthread", "-shared", "-fPIC",
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
            lib.iq_sink_create.restype = ctypes.c_void_p
            lib.iq_sink_create.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64,
                ctypes.c_float]
            lib.iq_sink_write.restype = ctypes.c_int
            lib.iq_sink_write.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_uint64]
            lib.iq_sink_flush.restype = ctypes.c_int
            lib.iq_sink_flush.argtypes = [ctypes.c_void_p]
            lib.iq_sink_floats_written.restype = ctypes.c_uint64
            lib.iq_sink_floats_written.argtypes = [ctypes.c_void_p]
            lib.iq_sink_stalls.restype = ctypes.c_uint64
            lib.iq_sink_stalls.argtypes = [ctypes.c_void_p]
            lib.iq_sink_destroy.restype = ctypes.c_int
            lib.iq_sink_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


class NativeIQSink:
    """Drop-in for :class:`.sink.IQFileSink` with the gain
    multiply and the file writes on a C++ background thread."""

    def __init__(self, path: str = None, fd: int = -1, gain: float = 1.0,
                 ring_samples: int = 1 << 24):
        if path is None and fd < 0:
            raise ValueError("NativeIQSink needs a path or a valid fd")
        self._lib = _load()
        self._h = self._lib.iq_sink_create(
            path.encode() if path else None, int(fd),
            ctypes.c_uint64(2 * ring_samples), ctypes.c_float(gain))
        if not self._h:
            raise OSError(f"iq_sink_create failed for {path or fd}")
        self.samples_written = 0

    def write(self, iq: np.ndarray) -> None:
        """iq: complex64 array, or float32 array of interleaved/planar IQ
        whose last axis is already I/Q-interleaved memory order."""
        if iq.dtype == np.complex64:
            data = np.ascontiguousarray(iq.reshape(-1)).view(np.float32)
        else:
            data = np.ascontiguousarray(iq, dtype=np.float32).reshape(-1)
        rc = self._lib.iq_sink_write(
            self._h, data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_uint64(data.size))
        if rc != 0:
            raise OSError("iq_sink write error")
        self.samples_written += data.size // 2

    def flush(self) -> None:
        if self._lib.iq_sink_flush(self._h) != 0:
            raise OSError("iq_sink write error")

    @property
    def samples_flushed(self) -> int:
        """Samples the writer thread has written to the descriptor (all of
        ``samples_written`` after ``flush``)."""
        return int(self._lib.iq_sink_floats_written(self._h)) // 2

    @property
    def producer_stalls(self) -> int:
        return int(self._lib.iq_sink_stalls(self._h))

    def close(self) -> None:
        if self._h:
            rc = self._lib.iq_sink_destroy(self._h)
            self._h = None
            if rc != 0:
                raise OSError(
                    "iq_sink writer thread hit a write error; output "
                    "truncated")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
