"""LDPC inner-code construction (EN 302 755 section 6.1 / Annex A).

The reference encodes LDPC with a per-parity-bit lookup of info-bit indices
followed by a sequential XOR chain (lib/bbheaderbch_bb_impl.cc:569-646, used
disabled in-tree; active for L1 in lib/framemapperfint_cc_impl.cc:1314-1364).

TPU formulation: the accumulation step becomes ONE static gather - for each
parity position a padded list of info-bit indices - reduced with XOR, and the
final chain p[j] ^= p[j-1] is a cumulative XOR (cumsum mod 2) along the parity
axis.  This module builds the padded index matrix host-side.
"""
import functools

import numpy as np

from . import table
from ..config import CodeRate, FrameSize

# (frame size, rate) -> Annex A table name
_TABLES = {
    (FrameSize.NORMAL, CodeRate.C1_2): "ldpc_tab_1_2N",
    (FrameSize.NORMAL, CodeRate.C3_5): "ldpc_tab_3_5N",
    (FrameSize.NORMAL, CodeRate.C2_3): "ldpc_tab_2_3N_DVBT2",
    (FrameSize.NORMAL, CodeRate.C3_4): "ldpc_tab_3_4N",
    (FrameSize.NORMAL, CodeRate.C4_5): "ldpc_tab_4_5N",
    (FrameSize.NORMAL, CodeRate.C5_6): "ldpc_tab_5_6N",
    (FrameSize.SHORT, CodeRate.C1_3): "ldpc_tab_1_3S",
    (FrameSize.SHORT, CodeRate.C2_5): "ldpc_tab_2_5S",
    (FrameSize.SHORT, CodeRate.C1_2): "ldpc_tab_1_2S",
    (FrameSize.SHORT, CodeRate.C3_5): "ldpc_tab_3_5S_DVBT2",
    (FrameSize.SHORT, CodeRate.C2_3): "ldpc_tab_2_3S",
    (FrameSize.SHORT, CodeRate.C3_4): "ldpc_tab_3_4S",
    (FrameSize.SHORT, CodeRate.C4_5): "ldpc_tab_4_5S",
    (FrameSize.SHORT, CodeRate.C5_6): "ldpc_tab_5_6S",
}


def address_pairs(tab: np.ndarray, q: int, n_parity: int):
    """Expand an Annex A table into (info_index, parity_index) pairs.

    Table row r lists tab[r, 0] parity addresses for info bit r*360; info bit
    r*360+n accumulates into (address + n*q) mod n_parity.
    """
    infos, paritys = [], []
    for r in range(tab.shape[0]):
        d = int(tab[r, 0])
        addrs = tab[r, 1 : 1 + d].astype(np.int64)
        n = np.arange(360)
        p = (addrs[None, :] + n[:, None] * q) % n_parity  # (360, d)
        im = r * 360 + n
        infos.append(np.repeat(im, d))
        paritys.append(p.reshape(-1))
    return np.concatenate(infos), np.concatenate(paritys)


@functools.lru_cache(maxsize=16)
def _build(table_name: str, q: int, n_parity: int, k_ldpc: int):
    tab = table(table_name)
    assert tab.shape[0] * 360 == k_ldpc, (table_name, tab.shape, k_ldpc)
    info_idx, parity_idx = address_pairs(tab, q, n_parity)

    # Bucket info indices by parity position into a padded matrix.
    order = np.argsort(parity_idx, kind="stable")
    parity_sorted = parity_idx[order]
    info_sorted = info_idx[order]
    counts = np.bincount(parity_sorted, minlength=n_parity)
    dmax = int(counts.max())
    # sentinel k_ldpc points at an appended always-zero bit
    gather = np.full((n_parity, dmax), k_ldpc, dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    col = np.arange(len(info_sorted)) - starts[parity_sorted]
    gather[parity_sorted, col] = info_sorted
    return gather, counts.astype(np.int32)


def encoder_gather(frame_size: FrameSize, rate: CodeRate, n_parity: int,
                   k_ldpc: int, q: int):
    """Padded (n_parity, Dmax) int32 gather matrix for the data path."""
    return _build(_TABLES[(frame_size, rate)], q, n_parity, k_ldpc)


def qc_entries(frame_size: FrameSize, rate: CodeRate, q: int):
    """Quasi-cyclic encoder schedule: per accumulator column c (0..q-1), the
    list of (group row r, roll s) with acc[:, c] ^= roll(info group r, s).

    Annex A addresses are (a + n*q) mod 360q for info bits r*360+n, so in an
    accumulator laid out as (360, q) [parity p -> row p//q, col p%q] each
    table entry (r, a) touches the FULL column a%q as a cyclic shift of the
    360-bit info group by a//q - the whole encoder becomes ~100-700 static
    rolls + XORs with no gather (measured 1.4x faster than the padded
    gather on TPU, and it removes the (n_parity, Dmax) index table)."""
    tab = table(_TABLES[(frame_size, rate)])
    by_col = [[] for _ in range(q)]
    for r in range(tab.shape[0]):
        for a in tab[r, 1 : 1 + int(tab[r, 0])]:
            by_col[int(a) % q].append((r, int(a) // q))
    return tuple(tuple(col) for col in by_col)


def l1_encoder_gather(which: str):
    """Gather matrix for L1 signalling LDPC.

    'pre'  -> rate 1/4 short (k=3240, q=36), reference :1314-1338
    'post' -> rate 1/2 short (k=7200, q=25), reference :1340-1364
    """
    if which == "pre":
        return _build("ldpc_tab_1_4S", 36, 16200 - 3240, 3240)
    if which == "post":
        return _build("ldpc_tab_1_2S", 25, 16200 - 7200, 7200)
    raise ValueError(which)


def encode_ref(info_bits: np.ndarray, frame_size: FrameSize, rate: CodeRate,
               n_parity: int, q: int) -> np.ndarray:
    """Info-side scatter oracle (mirrors the standard's accumulator
    description rather than the gather formulation): returns parity bits."""
    tab = table(_TABLES[(frame_size, rate)])
    info_idx, parity_idx = address_pairs(tab, q, n_parity)
    acc = np.zeros(n_parity, dtype=np.int64)
    np.add.at(acc, parity_idx, info_bits[info_idx].astype(np.int64))
    acc &= 1
    return np.bitwise_and(np.cumsum(acc), 1).astype(np.uint8)
