"""Bit interleaving + cell demux as one composed permutation (EN 302 755 6.3).

The reference chains three buffer-to-buffer passes per FEC frame - LDPC
parity interleave, column-twist interleave, bit-to-cell demux
(lib/interleavermod_bc_impl.cc:270-704).  All three are static bit
permutations, so they compose into a single gather:

    cell_bits[i] = ldpc_frame_bits[perm[i]]

followed by packing groups of mod_bits into cell words (MSB first).
"""
import functools

import numpy as np

from . import table
from ..config import CodeRate, Constellation, FrameSize, T2Config


def _parity_interleave(cfg: T2Config) -> np.ndarray:
    """index map A: u[k] = frame[A[k]] (q x 360 parity transpose)."""
    n = cfg.ldpc_frame_bits
    nbch, q = cfg.nbch, cfg.q_ldpc
    A = np.arange(n, dtype=np.int64)
    t, s = np.meshgrid(np.arange(q), np.arange(360), indexing="ij")
    A[nbch + 360 * t.reshape(-1) + s.reshape(-1)] = nbch + q * s.reshape(-1) + t.reshape(-1)
    return A


@functools.lru_cache(maxsize=16)
def _twist_mux(cfg: T2Config):
    """(twist table, mux table, columns) for the config."""
    short = cfg.frame_size == FrameSize.SHORT
    c = cfg.constellation
    if c == Constellation.QAM16:
        twist = table("twist16s" if short else "twist16n")
        if cfg.code_rate == CodeRate.C3_5 and not short:
            mux = table("mux16_35")
        elif cfg.code_rate == CodeRate.C1_3 and short:
            mux = table("mux16_13")
        elif cfg.code_rate == CodeRate.C2_5 and short:
            mux = table("mux16_25")
        else:
            mux = table("mux16")
        return twist, mux, 8
    if c == Constellation.QAM64:
        twist = table("twist64s" if short else "twist64n")
        if cfg.code_rate == CodeRate.C3_5 and not short:
            mux = table("mux64_35")
        elif cfg.code_rate == CodeRate.C1_3 and short:
            mux = table("mux64_13")
        elif cfg.code_rate == CodeRate.C2_5 and short:
            mux = table("mux64_25")
        else:
            mux = table("mux64")
        return twist, mux, 12
    if c == Constellation.QAM256:
        if not short:
            if cfg.code_rate == CodeRate.C3_5:
                mux = table("mux256_35")
            elif cfg.code_rate == CodeRate.C2_3:
                mux = table("mux256_23")
            else:
                mux = table("mux256")
            return table("twist256n"), mux, 16
        if cfg.code_rate == CodeRate.C1_3:
            mux = table("mux256s_13")
        elif cfg.code_rate == CodeRate.C2_5:
            mux = table("mux256s_25")
        else:
            mux = table("mux256s")
        return table("twist256s"), mux, 8
    raise ValueError(c)


def bit_permutation(cfg: T2Config) -> np.ndarray:
    """int32 perm of length ldpc_frame_bits: cell_bits[i]=frame_bits[perm[i]].

    cell word c uses cell_bits[c*mod .. c*mod+mod-1], MSB first.
    """
    n = cfg.ldpc_frame_bits

    if cfg.constellation == Constellation.QPSK:
        if cfg.code_rate in (CodeRate.C1_3, CodeRate.C2_5):
            perm = _parity_interleave(cfg)
        else:
            # QPSK at other rates maps the LDPC frame straight through
            # (reference :309-314)
            perm = np.arange(n, dtype=np.int64)
        return perm.astype(np.int32)

    A = _parity_interleave(cfg)
    twist, mux, nc = _twist_mux(cfg)
    rows = n // nc

    # column twist + row-major readout: w[r*nc+col] = u[col*rows + (r - twist[col]) % rows]
    r = np.arange(rows)[:, None]
    col = np.arange(nc)[None, :]
    W = (col * rows + (r - twist[None, :]) % rows)  # (rows, nc) -> index into u

    # demux: stream bit g*nc+p comes from w[g*nc + inv_mux[p]]
    inv_mux = np.empty(nc, dtype=np.int64)
    inv_mux[mux] = np.arange(nc)
    D = W[:, inv_mux]  # (rows, nc) -> cell-bit order

    return A[D.reshape(-1)].astype(np.int32)
