"""QAM constellation lookup tables (EN 302 755 section 6.2, figures 9-12).

Cells are produced by integer cell words indexing these LUTs (a jnp.take on
device).  Gray mapping, normalization and optional rotation are baked into the
table, matching reference lib/interleavermod_bc_impl.cc:169-253.
"""
import functools
import math

import numpy as np

from ..config import Constellation, L1Constellation

_AMP16 = [3.0, 1.0, -3.0, -1.0]
_AMP64 = [7.0, 5.0, 1.0, 3.0, -7.0, -5.0, -1.0, -3.0]
_AMP256 = [15.0, 13.0, 9.0, 11.0, 1.0, 3.0, 7.0, 5.0,
           -15.0, -13.0, -9.0, -11.0, -1.0, -3.0, -7.0, -5.0]

_ROTATION_DEG = {
    Constellation.QPSK: 29.0,
    Constellation.QAM16: 16.8,
    Constellation.QAM64: 8.6,
    Constellation.QAM256: 3.576334375,
}


def _base_lut(constellation: Constellation) -> np.ndarray:
    if constellation == Constellation.QPSK:
        n = math.sqrt(2.0)
        return np.array([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j]) / n
    if constellation == Constellation.QAM16:
        n = math.sqrt(10.0)
        lut = np.empty(16, dtype=complex)
        for i in range(16):
            re = ((i & 0x8) >> 2) | ((i & 0x2) >> 1)
            im = ((i & 0x4) >> 1) | (i & 0x1)
            lut[i] = complex(_AMP16[re], _AMP16[im]) / n
        return lut
    if constellation == Constellation.QAM64:
        n = math.sqrt(42.0)
        lut = np.empty(64, dtype=complex)
        for i in range(64):
            re = ((i & 0x20) >> 3) | ((i & 0x8) >> 2) | ((i & 0x2) >> 1)
            im = ((i & 0x10) >> 2) | ((i & 0x4) >> 1) | (i & 0x1)
            lut[i] = complex(_AMP64[re], _AMP64[im]) / n
        return lut
    if constellation == Constellation.QAM256:
        n = math.sqrt(170.0)
        lut = np.empty(256, dtype=complex)
        for i in range(256):
            re = (((i & 0x80) >> 4) | ((i & 0x20) >> 3) | ((i & 0x8) >> 2)
                  | ((i & 0x2) >> 1))
            im = (((i & 0x40) >> 3) | ((i & 0x10) >> 2) | ((i & 0x4) >> 1)
                  | (i & 0x1))
            lut[i] = complex(_AMP256[re], _AMP256[im]) / n
        return lut
    raise ValueError(constellation)


@functools.lru_cache(maxsize=16)
def qam_lut(constellation: Constellation, rotated: bool) -> np.ndarray:
    """complex64 LUT of size 2**mod_bits; index = cell word (first bit = MSB)."""
    lut = _base_lut(constellation)
    if rotated:
        ang = math.radians(_ROTATION_DEG[constellation])
        lut = lut * complex(math.cos(ang), math.sin(ang))
    return lut.astype(np.complex64)


@functools.lru_cache(maxsize=8)
def l1_lut(constellation: L1Constellation) -> np.ndarray:
    """L1 signalling constellations (never rotated); BPSK is +-1."""
    if constellation == L1Constellation.BPSK:
        return np.array([1.0, -1.0], dtype=np.complex64)
    m = {L1Constellation.QPSK: Constellation.QPSK,
         L1Constellation.QAM16: Constellation.QAM16,
         L1Constellation.QAM64: Constellation.QAM64}[constellation]
    return qam_lut(m, False)
