"""Builds the package's CUDA kernels into one shared library at first use.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into
``_build/<key>/libdvbt2ll_kernels.so``, where the key is a hash of the
sources and the flags, so an edited source builds anew and an unchanged
one is loaded as it is.  The library has a plain C interface, loaded with
``ctypes``: no PyTorch headers, so a build takes seconds.  Each source is
compiled by its own ``nvcc``, all started together, then one link; what
``ptxas`` reports for a source (registers, shared memory, spills) is kept
beside the library as ``<source>.log``.  ``_build/`` is generated and not
kept in git.
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
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    out = os.path.dirname(path)
    os.makedirs(out, exist_ok=True)
    nvcc = nvcc or find_nvcc()
    tag = f"{os.getpid()}.tmp"
    objs, procs = [], []
    for src in _sources():
        obj = os.path.join(out, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for cmd, src, proc in procs:  # wait for every compile before raising
        _, err = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{err}")
        else:
            with open(os.path.join(out, f"{os.path.basename(src)}.log"),
                      "w") as f:
                f.write(err)
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = f"{path}.{tag}"
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
           "-o", tmp, *objs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}"
                           f"\n{res.stderr}")
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, path)  # atomic: a concurrent builder sees all or none
    return path


def ptxas_report() -> str:
    """What ptxas said of each kernel of the built library."""
    out = os.path.dirname(build())
    lines = []
    for src in _sources():
        with open(os.path.join(out, f"{os.path.basename(src)}.log")) as f:
            lines += [ln.strip() for ln in f
                      if any(w in ln for w in ("entry", "Used", "spill"))]
    return "\n".join(lines)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    lib = ctypes.CDLL(build())
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dvbt2ll_ldpc_codeword.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
    lib.dvbt2ll_ldpc_codeword.restype = i32
    lib.dvbt2ll_bb_bch.argtypes = [ptr] * 7 + [i32] * 10 + [ptr]
    lib.dvbt2ll_bb_bch.restype = i32
    lib.dvbt2ll_ofdm_tail.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.dvbt2ll_ofdm_tail.restype = i32
    # floats as C floats: the kernel's constants rounded as torch rounds
    # the twin's Python scalars against a float32 tensor
    lib.dvbt2ll_qam_map.argtypes = ([ptr] * 4 + [i32] * 6
                                    + [ctypes.c_float] * 3 + [i32, ptr])
    lib.dvbt2ll_qam_map.restype = i32
    lib.dvbt2ll_stage_mark.argtypes = [i32, ptr]
    lib.dvbt2ll_stage_mark.restype = i32
    lib.dvbt2ll_error_string.argtypes = [i32]
    lib.dvbt2ll_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by a launch."""
    if code:
        msg = lib.dvbt2ll_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
