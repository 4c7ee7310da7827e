"""Stage-by-stage sequential oracle (mirrors the reference C++ hot loops).

A frozen copy of the NumPy oracle ``dvbt2ll_tpu/refmodel/chain.py`` with
its imports made local (``config`` and ``tables`` beside it are frozen
copies of that package's), and ``ofdm_modulate`` taking the inverse
transform as an argument.  It imports nothing of the program."""
import numpy as np

from .config import (CodeRate, Constellation, FrameSize, InputMode, PAPR,
                      T2Config)
from .tables import cell_interleaver, constellations, freq_interleaver, table
from .tables.bbframe import _crc8_byte_table, header_bits
from .tables.bch import encode_ref as bch_encode_ref
from .tables.l1 import l1post_cells_all_frames, l1pre_cells
from .tables.ldpc import encode_ref as ldpc_encode_ref
from .tables.mapper import _twist_mux
from .tables.pilots import (CONTINUAL, DATA, P2PAPR, P2PILOT, SCATTERED,
                             TRPAPR, _INVERT_BIT, carrier_maps, p1_waveform,
                             pilot_amplitudes)
from .tables.sequences import bb_scrambler, pilot_prbs, pn_sequence


def _byte_bits(b):
    return [(int(b) >> n) & 1 for n in range(7, -1, -1)]


# ---------------------------------------------------------------- stage 1
def bbheader_frames(cfg: T2Config, ts: np.ndarray, n_frames: int,
                    state=None):
    """Mode adaptation + BB scrambling + BCH (reference general_work
    :648-742: NORMAL byte loop with CRC-8 sync replacement, HIEFF loop
    with sync removal, in-band type B on the fec_blocks cadence).
    Returns (frames (n, nbch), state)."""
    from .tables.bbframe import inband_type_b_bits

    count, crc, pos, fec_block = (state if state is not None
                                  else (0, 0, 0, 0))
    hieff = cfg.input_mode == InputMode.HIEFF
    inband = bool(cfg.in_band)
    crc_tab = _crc8_byte_table()
    out = np.zeros((n_frames, cfg.nbch), dtype=np.uint8)
    for f in range(n_frames):
        padding = 104 if (inband and fec_block == 0) else 0
        frame = np.zeros(cfg.nbch, dtype=np.uint8)
        frame[:80] = header_bits(cfg, count, padding)
        offset = 80
        n_bytes = (cfg.kbch - 80 - padding) // 8
        j = 0
        while j < n_bytes:
            if count == 0:
                assert ts[pos] == 0x47, "TS sync error"
                pos += 1
                if hieff:
                    count = (count + 1) % 188
                    continue  # sync byte removed, no output slot
                b = crc
                crc = 0
            else:
                b = int(ts[pos])
                pos += 1
                if not hieff:
                    crc = int(crc_tab[b ^ crc])
            count = (count + 1) % 188
            frame[offset : offset + 8] = _byte_bits(b)
            offset += 8
            j += 1
        if padding:
            frame[offset : offset + 104] = inband_type_b_bits(cfg.ts_rate)
            offset += 104
        if inband:
            fec_block = (fec_block + 1) % cfg.fec_blocks
        frame[: cfg.kbch] ^= bb_scrambler()[: cfg.kbch]
        frame[cfg.kbch : cfg.nbch] = bch_encode_ref(
            frame[: cfg.kbch], cfg.frame_size == FrameSize.SHORT, cfg.bch_t)
        out[f] = frame
    return out, (count, crc, pos, fec_block)


# ---------------------------------------------------------------- LDPC
def ldpc_encode(cfg: T2Config, nbch_frames: np.ndarray) -> np.ndarray:
    """Append LDPC parity: (n, nbch) -> (n, ldpc_frame_bits)."""
    n = nbch_frames.shape[0]
    out = np.zeros((n, cfg.ldpc_frame_bits), dtype=np.uint8)
    for f in range(n):
        out[f, : cfg.nbch] = nbch_frames[f]
        out[f, cfg.nbch :] = ldpc_encode_ref(
            nbch_frames[f], cfg.frame_size, cfg.code_rate,
            cfg.ldpc_parity_bits, cfg.q_ldpc)
    return out


# ---------------------------------------------------------------- stage 2
def interleave_and_map(cfg: T2Config, frames: np.ndarray) -> np.ndarray:
    """Bit interleave + demux + QAM map + rotation/cyclic-Q-delay
    (reference interleavermod general_work :270-704).
    (n, frame_bits) -> (n, cell_size) complex64."""
    n = frames.shape[0]
    nbch, q, mod = cfg.nbch, cfg.q_ldpc, cfg.mod_bits
    cells = np.empty((n, cfg.cell_size), dtype=np.complex64)
    lut = constellations.qam_lut(cfg.constellation, bool(cfg.rotation))
    for f in range(n):
        fr = frames[f]
        if cfg.constellation == Constellation.QPSK:
            if cfg.code_rate in (CodeRate.C1_3, CodeRate.C2_5):
                u = fr.copy()
                for t in range(q):
                    for s in range(360):
                        u[nbch + 360 * t + s] = fr[nbch + q * s + t]
            else:
                u = fr
            words = (u[0::2] << 1) | u[1::2]
        else:
            u = fr.copy()
            for t in range(q):
                for s in range(360):
                    u[nbch + 360 * t + s] = fr[nbch + q * s + t]
            twist, mux, nc = _twist_mux(cfg)
            rows = cfg.ldpc_frame_bits // nc
            v = np.empty_like(u)
            idx = 0
            for col in range(nc):
                offset = int(twist[col])
                for row in range(rows):
                    v[offset + rows * col] = u[idx]
                    idx += 1
                    offset += 1
                    if offset == rows:
                        offset = 0
            w = v.reshape(nc, rows).T.reshape(-1)  # row-major readout
            packs = np.zeros(rows, dtype=np.int64)
            idx = 0
            for d in range(rows):
                pack = 0
                for e in range(nc):
                    pack |= int(w[idx]) << ((nc - 1) - int(mux[e]))
                    idx += 1
                packs[d] = pack
            if nc == mod:          # short-frame 256QAM: one cell per pack
                words = packs
            else:
                words = np.empty(2 * rows, dtype=np.int64)
                words[0::2] = packs >> mod
                words[1::2] = packs & ((1 << mod) - 1)
        mapped = lut[words]
        if cfg.rotation:
            delayed = lut[np.roll(words, 1)]
            mapped = mapped.real + 1j * delayed.imag
        cells[f] = mapped
    return cells


# ---------------------------------------------------------------- stage 3
def plp_interleave(cfg: T2Config, stream_cells: np.ndarray) -> np.ndarray:
    """Cell interleaver + time interleaver for one PLP's cells of one T2
    frame (reference framemapperfint general_work :1973-2028)."""
    cs = cfg.cell_size
    perm = cell_interleaver.base_permutation(
        cfg.frame_size, cfg.constellation, cs)
    small, big, n_small, n_big = cfg.ti_structure
    degree = cell_interleaver._LFSR[(cfg.frame_size, cfg.constellation)][0]

    ti = np.empty(cfg.stream_cells, dtype=np.complex64)
    fec_idx = 0
    pos = 0
    for s in range(n_small + n_big):
        per_ti = small if s < n_small else big
        nctr = 0
        for _ in range(per_ti):
            while True:
                temp, shift = nctr, 0
                for _ in range(degree):
                    shift |= temp & 1
                    shift <<= 1
                    temp >>= 1
                nctr += 1
                if shift < cs:
                    break
            for w in range(cs):
                ti[(int(perm[w]) + shift) % cs + fec_idx * cs] = \
                    stream_cells[pos]
                pos += 1
            fec_idx += 1

    if cfg.ti_blocks != 0:
        cell_out = np.empty_like(ti)
        rows = cs // 5
        ti_base = out_base = 0
        for s in range(n_small + n_big):
            per_ti = small if s < n_small else big
            cols = 5 * per_ti
            block = ti[ti_base : ti_base + rows * cols].reshape(cols, rows)
            cell_out[out_base : out_base + rows * cols] = block.T.reshape(-1)
            ti_base += rows * cols
            out_base += rows * cols
    else:
        cell_out = ti
    return cell_out


def frame_map(cfg: T2Config, stream_cells, frame_idx: int) -> np.ndarray:
    """Interleave + L1 + frame assembly + frequency interleave (reference
    framemapperfint general_work :1948-2151).  stream_cells: one
    (stream_cells,) array, or a list with one array per PLP.
    -> (mapped_cells,)."""
    streams = (list(stream_cells) if isinstance(stream_cells, (list, tuple))
               else [stream_cells])
    assert len(streams) == cfg.num_plp
    per_plp = [plp_interleave(c, s)
               for c, s in zip(cfg.plp_configs, streams)]
    types = cfg.plp_types
    if 2 not in types:
        cell_out = np.concatenate(per_plp)
    else:
        # EN 302 755 section 8.3.6 frame order: common (type 0) and
        # type-1 PLPs contiguous, then the type-2 PLPs as sub_slices
        # rounds of one sub-slice each (independent re-derivation of the
        # fast path's payload_frame_order composition)
        chunks = [per_plp[i] for i, t in enumerate(types) if t != 2]
        t2 = [i for i, t in enumerate(types) if t == 2]
        for s in range(cfg.sub_slices):
            for i in t2:
                n = per_plp[i].size // cfg.sub_slices
                chunks.append(per_plp[i][s * n : (s + 1) * n])
        cell_out = np.concatenate(chunks)

    # frame assembly (N_P2 == 1 or zig-zag for N_P2 > 1)
    l1pre = l1pre_cells(cfg)
    l1post = l1post_cells_all_frames(cfg)[frame_idx % cfg.t2_frames]
    dummy_bits = bb_scrambler(cfg.dummy_cells) if cfg.dummy_cells else \
        np.zeros(0, np.uint8)
    dummy = (1.0 - 2.0 * dummy_bits.astype(np.float32)).astype(np.complex64)
    tail_zeros = np.zeros(cfg.n_fc - cfg.c_fc, dtype=np.complex64)
    seq = np.concatenate([l1pre, l1post, cell_out, dummy, tail_zeros])
    assert seq.size == cfg.mapped_cells

    if cfg.n_p2 == 1:
        frame = seq
    else:
        # zig-zag spread of the L1 cells across the N_P2 P2 symbols
        # (reference :2064-2101)
        frame = np.empty(cfg.mapped_cells, dtype=np.complex64)
        n_p2, c_p2 = cfg.n_p2, cfg.c_p2
        n_pre, n_post = 1840, cfg.l1post_cells
        read = 0
        for n in range(n_p2):
            idx = n * c_p2
            for j in range(n_pre // n_p2):
                frame[idx + j] = seq[read + j * n_p2]
            read += 1
        read = n_pre
        for n in range(n_p2):
            idx = n * c_p2 + n_pre // n_p2
            for j in range(n_post // n_p2):
                frame[idx + j] = seq[read + j * n_p2]
            read += 1
        read = n_pre + n_post
        fill = c_p2 - n_pre // n_p2 - n_post // n_p2
        idx0 = n_pre // n_p2 + n_post // n_p2
        for n in range(n_p2):
            idx = n * c_p2 + idx0
            for j in range(fill):
                frame[idx + j] = seq[read]
                read += 1
        # the remainder after the P2 region is straight
        frame[n_p2 * c_p2 :] = seq[read : read + cfg.mapped_cells - n_p2 * c_p2]

    # frequency interleave per symbol
    out = np.empty_like(frame)
    he_p2, ho_p2 = freq_interleaver.build_h(cfg.fft_key, cfg.c_p2)
    he_d, ho_d = freq_interleaver.build_h(cfg.fft_key, cfg.c_data)
    if cfg.has_fc_symbol:
        he_fc, ho_fc = freq_interleaver.build_h(cfg.fft_key, cfg.n_fc)
    pos = 0
    symbol = 0
    for _ in range(cfg.n_p2):
        h = he_p2 if symbol % 2 == 0 else ho_p2
        out[pos : pos + cfg.c_p2] = frame[pos + h]
        pos += cfg.c_p2
        symbol += 1
    for _ in range(cfg.num_plain_data_symbols):
        h = he_d if symbol % 2 == 0 else ho_d
        out[pos : pos + cfg.c_data] = frame[pos + h]
        pos += cfg.c_data
        symbol += 1
    if cfg.has_fc_symbol:
        h = he_fc if symbol % 2 == 0 else ho_fc
        out[pos : pos + cfg.n_fc] = frame[pos + h]
        pos += cfg.n_fc
    assert pos == cfg.mapped_cells
    return out


# ---------------------------------------------------------------- stage 4
def ofdm_modulate(cfg: T2Config, mapped: np.ndarray,
                  ifft=np.fft.ifft) -> np.ndarray:
    """Pilot insertion + IFFT + GI + P1 (reference pilotgen general_work
    :2784-2907).  (mapped_cells,) -> (samples_per_frame,).  ``ifft`` is
    the inverse transform (``frames.tf32_ifft`` for the control)."""
    fft = cfg.fft_points
    gi = cfg.guard_samples
    c_ps = cfg.c_ps
    left = (fft - c_ps) // 2 + 1
    maps = carrier_maps(cfg)
    prbs = pilot_prbs(c_ps + cfg.k_offset)[cfg.k_offset :]
    pn = pn_sequence()
    amp = pilot_amplitudes(cfg)

    out = np.empty(cfg.samples_per_frame, dtype=np.complex64)
    out[:2048] = p1_waveform(cfg)
    pos = 2048
    cell = 0
    for s in range(cfg.num_symbols):
        types = maps[s] & ~_INVERT_BIT
        inverted = (maps[s] & _INVERT_BIT) != 0
        row = np.zeros(fft, dtype=np.complex128)
        for n in range(c_ps):
            t = types[n]
            if t == DATA:
                row[left + n] = mapped[cell]
                cell += 1
            elif t in (P2PAPR, TRPAPR):
                row[left + n] = 0.0
            else:
                sign = 1.0 - 2.0 * (int(prbs[n]) ^ int(pn[s]))
                if inverted[n]:
                    sign = -sign
                row[left + n] = amp[int(t)] * sign
        if cfg.equalization:
            # inverse-sinc pre-equalization in pre-shift carrier order
            # (reference :1179-1219 build, :2887-2889 apply)
            x = np.pi * np.arange(fft // 2) / fft
            sinc = np.ones(fft // 2)
            sinc[1:] = np.sin(x[1:]) / x[1:]
            rms = np.sqrt(np.mean(sinc * sinc))
            half = rms / sinc
            row = row * np.concatenate([half[::-1], half])
        # ifftshift halves, unnormalized backward FFT, scale
        time = fft * ifft(np.fft.ifftshift(row))
        time *= cfg.ofdm_normalization
        out[pos : pos + gi] = time[fft - gi :]
        out[pos + gi : pos + gi + fft] = time
        pos += gi + fft
    assert cell == cfg.mapped_cells
    assert pos == cfg.samples_per_frame
    return out


# ---------------------------------------------------------------- end-to-end
def transmit_chain(cfg: T2Config, ts, n_t2_frames: int,
                   start_frame_idx: int = 0) -> np.ndarray:
    """TS bytes (one array, or one per PLP) -> baseband IQ for
    n_t2_frames T2 frames (FEF parts not included; see transmit_stream)."""
    streams = list(ts) if isinstance(ts, (list, tuple)) else [ts]
    assert len(streams) == cfg.num_plp
    per_plp_cells = []
    for c, s in zip(cfg.plp_configs, streams):
        n_fec = n_t2_frames * c.fec_blocks
        frames, _ = bbheader_frames(c, s, n_fec)
        coded = ldpc_encode(c, frames)
        per_plp_cells.append(interleave_and_map(c, coded))
    out = np.empty(n_t2_frames * cfg.samples_per_frame, dtype=np.complex64)
    for t in range(n_t2_frames):
        plp_streams = [
            cells[t * c.fec_blocks : (t + 1) * c.fec_blocks].reshape(-1)
            for c, cells in zip(cfg.plp_configs, per_plp_cells)]
        mapped = frame_map(cfg, plp_streams, start_frame_idx + t)
        out[t * cfg.samples_per_frame : (t + 1) * cfg.samples_per_frame] = \
            ofdm_modulate(cfg, mapped)
    return out
