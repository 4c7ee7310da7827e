"""BCH outer-code construction (EN 302 755 section 6.1, table 7).

The BCH encoders in the reference are bit/byte-serial LFSRs
(lib/bbheaderbch_bb_impl.cc:424-531, lib/framemapperfint_cc_impl.cc:1269-1312).
BCH encoding is GF(2)-linear, so on TPU we express it as a single
(batch, kbch) x (kbch, n_parity) mod-2 matrix product that rides the MXU.
This module builds the generator matrices host-side.

Minimal polynomials below are the EN 302 755 table 7 constants, written as
integer bitmasks with bit i = coefficient of x^i.
"""
import functools

import numpy as np


def _poly(coeffs):
    v = 0
    for i, c in enumerate(coeffs):
        v |= int(c) << i
    return v


# GF(2^16) minimal polynomials g1..g12 for normal FEC frames.
_NORMAL_MINPOLYS = [_poly(c) for c in [
    [1,0,1,1,0,1,0,0,0,0,0,0,0,0,0,0,1],
    [1,1,0,0,1,1,1,0,1,0,0,0,0,0,0,0,1],
    [1,0,1,1,1,1,0,1,1,1,1,1,0,0,0,0,1],
    [1,0,1,0,1,0,1,0,0,1,0,1,1,0,1,0,1],
    [1,1,1,1,0,1,0,0,1,1,1,1,1,0,0,0,1],
    [1,0,1,0,1,1,0,1,1,1,1,0,1,1,1,1,1],
    [1,0,1,0,0,1,1,0,1,1,1,1,0,1,0,1,1],
    [1,1,1,0,0,1,1,0,1,1,0,0,1,1,1,0,1],
    [1,0,0,0,0,1,0,1,0,1,1,1,0,0,0,0,1],
    [1,1,1,0,0,1,0,1,1,0,1,0,1,1,1,0,1],
    [1,0,1,1,0,1,0,0,0,1,0,1,1,1,0,0,1],
    [1,1,0,0,0,1,1,1,0,1,0,1,1,0,0,0,1],
]]

# GF(2^14) minimal polynomials for short FEC frames.
_SHORT_MINPOLYS = [_poly(c) for c in [
    [1,1,0,1,0,1,0,0,0,0,0,0,0,0,1],
    [1,0,0,0,0,0,1,0,1,0,0,1,0,0,1],
    [1,1,1,0,0,0,1,0,0,1,1,0,0,0,1],
    [1,0,0,0,1,0,0,1,1,0,1,0,1,0,1],
    [1,0,1,0,1,0,1,0,1,1,0,1,0,1,1],
    [1,0,0,1,0,0,0,1,1,1,0,0,0,1,1],
    [1,0,1,0,0,1,1,1,0,0,1,1,0,1,1],
    [1,0,0,0,0,1,0,0,1,1,1,1,0,0,1],
    [1,1,1,1,0,0,0,0,0,1,1,0,0,0,1],
    [1,0,0,1,0,0,1,0,0,1,0,1,1,0,1],
    [1,0,0,0,1,0,0,0,0,0,0,1,1,0,1],
    [1,1,1,1,0,1,1,1,1,0,1,0,0,1,1],
]]


def _gf2_mul(a: int, b: int) -> int:
    """Carry-less polynomial product over GF(2)."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        b >>= 1
    return r


@functools.lru_cache(maxsize=8)
def generator_poly(short: bool, t: int) -> int:
    """g(x) = product of the first t minimal polynomials.

    degree(g) = 14*t (short) or 16*t (normal) = number of parity bits.
    """
    polys = _SHORT_MINPOLYS if short else _NORMAL_MINPOLYS
    g = 1
    for p in polys[:t]:
        g = _gf2_mul(g, p)
    return g


def _int_to_bits(v: int, n: int) -> np.ndarray:
    """Bits of v, index i = coefficient of x^i, as uint8[n]."""
    return np.array([(v >> i) & 1 for i in range(n)], dtype=np.uint8)


@functools.lru_cache(maxsize=8)
def parity_matrix(kbch: int, short: bool, t: int) -> np.ndarray:
    """Systematic BCH parity generator matrix G_p, uint8 (kbch, n_parity).

    parity_bits = msg_bits @ G_p  (mod 2), where msg_bits[0] is the first
    transmitted bit and parity row order is MSB-of-LFSR-first, matching the
    reference's serial encoder output (lib/bbheaderbch_bb_impl.cc:504-531).

    Row i is x^(kbch-1-i) * x^npar mod g(x).
    """
    g = generator_poly(short, t)
    npar = 14 * t if short else 16 * t
    top = 1 << npar
    mask = top - 1
    rows = np.empty((kbch, npar), dtype=np.uint8)
    r = g & mask  # x^npar mod g  (since g = x^npar + (g & mask))
    rows[kbch - 1] = _int_to_bits(r, npar)
    for i in range(kbch - 2, -1, -1):
        r <<= 1
        if r & top:
            r = (r ^ g) & mask
        rows[i] = _int_to_bits(r, npar)
    # Parity output order: the serial encoder emits the MSB (x^{npar-1}
    # coefficient) first, so flip the column order to transmit order.
    return rows[:, ::-1].copy()


def encode_ref(msg_bits: np.ndarray, short: bool, t: int) -> np.ndarray:
    """Bit-serial reference BCH encoder (test oracle, independent of the
    matrix path): returns the n_parity parity bits in transmit order."""
    g = generator_poly(short, t)
    npar = 14 * t if short else 16 * t
    top = 1 << npar
    mask = top - 1
    state = 0
    for b in msg_bits:
        fb = int(b) ^ ((state >> (npar - 1)) & 1)
        state = (state << 1) & mask
        if fb:
            state ^= g & mask
    return np.array([(state >> (npar - 1 - i)) & 1 for i in range(npar)],
                    dtype=np.uint8)
