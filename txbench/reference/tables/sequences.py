"""PRBS / scrambling sequence generators (EN 302 755).

All sequences are tiny and generated host-side with numpy; they become
constants baked into the jitted transmit graph.
"""
import functools

import numpy as np

from . import table
from ..config import FRAME_SIZE_NORMAL


@functools.lru_cache(maxsize=4)
def bb_scrambler(length: int = FRAME_SIZE_NORMAL) -> np.ndarray:
    """BB frame scrambling PRBS x^15+x^14+1, seed 0x4A80 (EN 302 755 5.2.4).

    Matches reference lib/bbheaderbch_bb_impl.cc:357-369.  The same sequence
    (re-seeded) scrambles dummy cells and the L1-post (V1.3.1).
    """
    sr = 0x4A80
    out = np.empty(length, dtype=np.uint8)
    for i in range(length):
        b = (sr ^ (sr >> 1)) & 1
        out[i] = b
        sr >>= 1
        if b:
            sr |= 0x4000
    return out


@functools.lru_cache(maxsize=2)
def pilot_prbs(length: int) -> np.ndarray:
    """Pilot modulation PRBS x^11+x^2+1, seed 0x7FF (EN 302 755 9.2.1).

    Matches reference lib/pilotgenp1insert_cc_impl.cc:1245-1258 (init_prbs):
    output bit is sr&1 *before* the shift.
    """
    sr = 0x7FF
    out = np.empty(length, dtype=np.uint8)
    for i in range(length):
        b = (sr ^ (sr >> 2)) & 1
        out[i] = sr & 1
        sr >>= 1
        if b:
            sr |= 0x400
    return out


@functools.lru_cache(maxsize=1)
def pn_sequence() -> np.ndarray:
    """Per-symbol PN sequence, 2624 chips (EN 302 755 table 35), unpacked from
    the byte table; reference lib/pilotgenp1insert_cc_impl.cc:1260-1265."""
    packed = table("pn_sequence_table").astype(np.uint8)
    return np.unpackbits(packed)  # MSB-first, matches the reference unpack


@functools.lru_cache(maxsize=1)
def p1_randomizer() -> np.ndarray:
    """P1 DBPSK scrambling sequence (+-1), seed 0x4E46 (EN 302 755 9.8.2.3);
    reference lib/pilotgenp1insert_cc_impl.cc:1268-1283."""
    sr = 0x4E46
    out = np.empty(384, dtype=np.int8)
    for i in range(384):
        b = (sr ^ (sr >> 1)) & 1
        out[i] = 1 if b == 0 else -1
        sr >>= 1
        if b:
            sr |= 0x4000
    return out
