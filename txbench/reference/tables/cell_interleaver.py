"""Cell interleaver and time interleaver permutations (EN 302 755 6.4/6.5).

Both interleavers are pure permutations of the payload-cell stream of one
interleaving frame, so the whole frame-mapper input stage reduces to a single
precomputed gather.  Matches reference lib/framemapperfint_cc_impl.cc:
LFSR permutation build :998-1107, per-FEC-frame bit-reversed shift and
scatter :1973-1998, time-interleaver column transpose :1999-2028.
"""
import functools

import numpy as np

from ..config import Constellation, FrameSize, T2Config

# (frame size, constellation) -> (pn_degree, taps)
_LFSR = {
    (FrameSize.NORMAL, Constellation.QPSK): (15, (0, 1, 2, 12)),
    (FrameSize.NORMAL, Constellation.QAM16): (14, (0, 1, 4, 5, 9, 11)),
    (FrameSize.NORMAL, Constellation.QAM64): (14, (0, 1, 4, 5, 9, 11)),
    (FrameSize.NORMAL, Constellation.QAM256): (13, (0, 1, 4, 6)),
    (FrameSize.SHORT, Constellation.QPSK): (13, (0, 1, 4, 6)),
    (FrameSize.SHORT, Constellation.QAM16): (12, (0, 2)),
    (FrameSize.SHORT, Constellation.QAM64): (12, (0, 2)),
    (FrameSize.SHORT, Constellation.QAM256): (11, (0, 3)),
}


@functools.lru_cache(maxsize=16)
def base_permutation(frame_size: FrameSize, constellation: Constellation,
                     cell_size: int) -> np.ndarray:
    """L_r sequence: cell written to position permutation[w] (before shift)."""
    degree, taps = _LFSR[(frame_size, constellation)]
    max_states = 1 << degree
    mask = (1 << (degree - 1)) - 1
    out = np.empty(cell_size, dtype=np.int64)
    q = 0
    lfsr = 0
    for i in range(max_states):
        if i in (0, 1):
            lfsr = 0
        elif i == 2:
            lfsr = 1
        else:
            fb = 0
            for t in taps:
                fb ^= (lfsr >> t) & 1
            lfsr &= mask
            lfsr >>= 1
            lfsr |= fb << (degree - 2)
        value = lfsr | ((i % 2) << (degree - 1))
        if value < cell_size:
            out[q] = value
            q += 1
    assert q == cell_size
    return out


def interleaver_permutation(cfg: T2Config) -> np.ndarray:
    """Combined cell+time interleaver as one gather:
    payload[k] = mapper_cells[perm[k]] for the whole T2 frame.

    The forward scatter is: time_interleave[(L[w]+shift_r) % cell_size +
    r*cell_size] = cells[r*cell_size + w]; then the TI block transpose reads
    (rows = cell_size/5, cols = 5*fec_per_ti) column-major.
    """
    cell_size = cfg.cell_size
    degree, _ = _LFSR[(cfg.frame_size, cfg.constellation)]
    base = base_permutation(cfg.frame_size, cfg.constellation, cell_size)
    small, big, n_small, n_big = cfg.ti_structure

    # forward scatter position of every input cell, per FEC frame
    scatter = np.empty(cfg.fec_blocks * cell_size, dtype=np.int64)
    fec_idx = 0
    for s in range(n_small + n_big):
        per_ti = small if s < n_small else big
        n = 0  # bit-reversed counter restarts per TI block (reference :1974)
        for _ in range(per_ti):
            while True:
                temp = n
                shift = 0
                for _ in range(degree):
                    shift |= temp & 1
                    shift <<= 1
                    temp >>= 1
                n += 1
                if shift < cell_size:
                    break
            pos = (base + shift) % cell_size + fec_idx * cell_size
            scatter[fec_idx * cell_size : (fec_idx + 1) * cell_size] = pos
            fec_idx += 1

    # invert the scatter into a gather: ti_buffer[scatter[w]] = in[w]
    inv = np.empty_like(scatter)
    inv[scatter] = np.arange(len(scatter))

    if cfg.ti_blocks == 0:
        return inv.astype(np.int32)

    # time interleaver: per TI block, read the (cols, rows) buffer column-wise
    out = np.empty_like(inv)
    rows = cell_size // 5
    ti_base = 0
    out_base = 0
    for s in range(n_small + n_big):
        per_ti = small if s < n_small else big
        cols = 5 * per_ti
        block = inv[ti_base : ti_base + rows * cols].reshape(cols, rows)
        out[out_base : out_base + rows * cols] = block.T.reshape(-1)
        ti_base += rows * cols
        out_base += rows * cols
    return out.astype(np.int32)
