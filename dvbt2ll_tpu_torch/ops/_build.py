"""Builds the package's CUDA kernels into one shared library at first use.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into
``_build/<key>/libdvbt2ll_kernels.so``, where the key is a hash of the
sources and the flags, so an edited source builds anew and an unchanged
one is loaded as it is.  The library has a plain C interface, loaded with
``ctypes``: no PyTorch headers, so a build takes seconds.  ``_build/`` is
generated and not kept in git.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_NAME = "libdvbt2ll_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")


def _sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def build_key() -> str:
    """Hash of every source and header under ``csrc/`` and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(cuda_home, "bin", "nvcc") if cuda_home
                  else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)"
                       ": the CUDA kernels cannot be built")


def build(nvcc: str | None = None) -> str:
    """Path of the built library, compiling it if this key has none."""
    path = os.path.join(BUILD_DIR, build_key(), LIB_NAME)
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [nvcc or find_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}"
                           f"\n{res.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent builder sees all or none
    return path


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    lib = ctypes.CDLL(build())
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dvbt2ll_ldpc_parity.argtypes = [ptr, ptr, ptr, ptr, ptr,
                                        i32, i32, i32, ptr]
    lib.dvbt2ll_ldpc_parity.restype = i32
    lib.dvbt2ll_error_string.argtypes = [i32]
    lib.dvbt2ll_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by a launch."""
    if code:
        msg = lib.dvbt2ll_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
