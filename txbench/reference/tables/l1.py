"""L1 signalling generation (EN 302 755 section 7).

L1-pre is constant per config (the reference caches it too,
lib/framemapperfint_cc_impl.cc:988).  L1-post varies only through the 8-bit
FRAME_IDX field, so we precompute the mapped cells for every frame index
0..t2_frames-1 host-side; the jitted graph just indexes a (t2_frames, cells)
constant.  Field layouts follow reference add_l1pre (:1366-1534) and
add_l1post (:1536-1910).
"""
import functools
from typing import List, Tuple

import numpy as np

from . import table
from .bch import generator_poly
from .constellations import l1_lut
from .ldpc import l1_encoder_gather
from .sequences import bb_scrambler
from ..config import (KBCH_1_2, KBCH_1_4, L1Constellation,
                      NBCH_1_2, NBCH_1_4, NBCH_PARITY, T2Config, Version)


def _bits(value: int, width: int) -> List[int]:
    return [(value >> n) & 1 for n in range(width - 1, -1, -1)]


def crc32_bits(bits: np.ndarray) -> np.ndarray:
    """CRC-32 (poly 0x04C11DB7, init 0xFFFFFFFF, MSB-first, no final xor);
    reference lib/framemapperfint_cc_impl.cc:1205-1224."""
    crc = 0xFFFFFFFF
    for b in bits:
        fb = int(b) ^ ((crc >> 31) & 1)
        crc = (crc << 1) & 0xFFFFFFFF
        if fb:
            crc ^= 0x04C11DB7
    return np.array(_bits(crc, 32), dtype=np.uint8)


def _bch_parity(msg: np.ndarray) -> np.ndarray:
    """t=12 short-frame BCH parity (168 bits), bit-serial."""
    g = generator_poly(True, 12)
    npar = NBCH_PARITY
    top = 1 << npar
    mask = top - 1
    state = 0
    for b in msg:
        fb = int(b) ^ ((state >> (npar - 1)) & 1)
        state = (state << 1) & mask
        if fb:
            state ^= g & mask
    return np.array([(state >> (npar - 1 - i)) & 1 for i in range(npar)],
                    dtype=np.uint8)


def _ldpc_parity(info: np.ndarray, which: str) -> np.ndarray:
    gather, _ = l1_encoder_gather(which)
    ext = np.concatenate([info, np.zeros(1, np.uint8)]).astype(np.int64)
    acc = ext[gather].sum(1) & 1
    return np.bitwise_and(np.cumsum(acc), 1).astype(np.uint8)


# ------------------------------------------------------------------- L1-pre
def l1pre_fields(cfg: T2Config) -> List[Tuple[str, int, int]]:
    """(name, value, width) in serialization order; reference :114-150,
    :1379-1472."""
    l1_post_scrambled = int(cfg.l1_scrambled and cfg.version == Version.V131)
    reserved = 0xF if (cfg.reserved_bias_bits
                       and cfg.version == Version.V131) else 0
    return [
        ("type", 0, 8),                        # STREAMTYPE_TS
        ("bwt_ext", int(cfg.carrier_mode), 1),
        ("s1", int(cfg.preamble), 3),
        ("s2", int(cfg.fft_size) & 0x7, 3),
        ("s2_mixed", int(cfg.has_fef), 1),
        ("l1_repetition_flag", 0, 1),
        ("guard_interval", int(cfg.guard_interval), 3),
        ("papr", int(cfg.papr), 4),
        ("l1_mod", int(cfg.l1_constellation), 4),
        ("l1_cod", 0, 2),
        ("l1_fec_type", 0, 2),
        ("l1_post_size", cfg.n_post // cfg.eta_mod, 18),
        ("l1_post_info_size", cfg.ksig_post - 32, 18),
        ("pilot_pattern", int(cfg.pilot_pattern), 4),
        ("tx_id_availability", 0, 8),
        ("cell_id", 0, 16),
        ("network_id", cfg.network_id, 16),
        ("t2_system_id", cfg.t2_system_id, 16),
        ("num_t2_frames", cfg.t2_frames, 8),
        ("num_data_symbols", cfg.num_data_symbols, 12),
        ("regen_flag", 0, 3),
        ("l1_post_extension", 0, 1),
        ("num_rf", 1, 3),
        ("current_rf_index", 0, 3),
        ("t2_version", int(cfg.version), 4),
        ("l1_post_scrambled", l1_post_scrambled, 1),
        ("t2_base_lite", 0, 1),
        ("reserved", reserved, 4),
    ]


@functools.lru_cache(maxsize=8)
def _l1pre_cells_cached(cfg: T2Config) -> np.ndarray:
    info = []
    for _, value, width in l1pre_fields(cfg):
        info.extend(_bits(value, width))
    info = np.array(info, dtype=np.uint8)
    assert info.size == 168
    info = np.concatenate([info, crc32_bits(info)])  # 200 = KSIG_PRE

    padded = np.zeros(KBCH_1_4, dtype=np.uint8)
    padded[: info.size] = info
    codeword = np.concatenate([padded, _bch_parity(padded)])
    parity = _ldpc_parity(codeword, "pre")

    # puncture 31 full groups + 328 bits of group pre_puncture[31]
    pre_punct = table("pre_puncture")
    punctured = np.zeros(parity.size, dtype=bool)
    for c in range(31):
        punctured[np.arange(360) * 36 + pre_punct[c]] = True
    punctured[np.arange(328) * 36 + pre_punct[31]] = True

    bits = np.concatenate([
        info,                               # KSIG_PRE info+crc bits
        codeword[KBCH_1_4:NBCH_1_4],        # 168 BCH parity bits
        parity[~punctured],                 # surviving LDPC parity
    ])
    assert bits.size == 1840
    return l1_lut(L1Constellation.BPSK)[bits].astype(np.complex64)


def l1pre_cells(cfg: T2Config) -> np.ndarray:
    """1840 BPSK cells, constant per config."""
    return _l1pre_cells_cached(cfg)


# ------------------------------------------------------------------ L1-post
def l1post_fields(cfg: T2Config, frame_idx: int) -> List[Tuple[str, int, int]]:
    """Configurable + dynamic L1-post fields; reference :152-250,
    :1553-1691 (single PLP).  Generalized to NUM_PLP type-1 data PLPs (per
    EN 302 755 section 7.2.3: one 89-bit configurable and one 48-bit
    dynamic loop entry per PLP) and to FEF signalling (34 bits after the
    RF loop when S2 indicates mixed frames)."""
    v131 = cfg.version == Version.V131
    rsv = cfg.reserved_bias_bits and v131
    plp_ids = ([p.plp_id for p in cfg.plps] if cfg.plps
               else [0])
    group_ids = ([p.plp_group_id for p in cfg.plps] if cfg.plps
                 else [1])
    fields = [
        ("sub_slices_per_frame", cfg.sub_slices, 15),
        ("num_plp", cfg.num_plp, 8),
        ("num_aux", 0, 4),
        ("aux_config_rfu", 0, 8),
        ("rf_idx", 0, 3),
        ("frequency", cfg.frequency, 32),
    ]
    if cfg.has_fef:
        fields += [
            ("fef_type", cfg.fef_type, 4),
            ("fef_length", cfg.fef_length & 0x3FFFFF, 22),
            ("fef_interval", cfg.fef_interval, 8),
        ]
    for i, c in enumerate(cfg.plp_configs):
        fields += [
            ("plp_id", plp_ids[i], 8),
            ("plp_type", cfg.plp_types[i], 3),
            ("plp_payload_type", 3, 5),
            ("ff_flag", 0, 1),
            ("first_rf_idx", 0, 3),
            ("first_frame_idx", 0, 8),
            ("plp_group_id", group_ids[i], 8),
            ("plp_cod", int(c.code_rate), 3),
            ("plp_mod", int(c.constellation), 3),
            ("plp_rotation", int(c.rotation), 1),
            ("plp_fec_type", int(c.frame_size), 2),
            ("plp_num_blocks_max", c.fec_blocks, 10),
            ("frame_interval", 1, 8),
            ("time_il_length", c.ti_blocks, 8),
            ("time_il_type", 0, 1),
            ("in_band_a_flag", 0, 1),
            ("in_band_b_flag", int(cfg.in_band and v131), 1),
            ("reserved_1", 0x7FF if rsv else 0, 11),
            ("plp_mode", 0 if cfg.version == Version.V111
             else int(cfg.input_mode) + 1, 2),
            ("static_flag", 0, 1),
            ("static_padding_flag", 0, 1),
        ]
    fields += [
        ("fef_length_msb", cfg.fef_length >> 22 if v131 else 0, 2),
        ("reserved_2", 0x3FFFFFFF if rsv else 0, 30),
        ("frame_idx", frame_idx, 8),
        ("sub_slice_interval", cfg.sub_slice_interval, 22),
        ("type_2_start", cfg.type_2_start, 22),
        ("l1_change_counter", 0, 8),
        ("start_rf_idx", 0, 3),
        ("reserved_3", 0xFF if rsv else 0, 8),
    ]
    for i, c in enumerate(cfg.plp_configs):
        fields += [
            ("plp_id_dynamic", plp_ids[i], 8),
            ("plp_start", cfg.plp_frame_starts[i], 22),
            ("plp_num_blocks", c.fec_blocks, 10),
            ("reserved_4", 0xFF if rsv else 0, 8),
        ]
    fields += [
        ("reserved_5", 0xFF if rsv else 0, 8),
    ]
    return fields


def _padding_mask(cfg: T2Config, n_info_bits: int) -> np.ndarray:
    """True where KBCH_1_2 positions are zero-padding; reference :1698-1746."""
    post_padding = table({
        L1Constellation.BPSK: "post_padding_bqpsk",
        L1Constellation.QPSK: "post_padding_bqpsk",
        L1Constellation.QAM16: "post_padding_16qam",
        L1Constellation.QAM64: "post_padding_64qam",
    }[cfg.l1_constellation])
    mask = np.zeros(KBCH_1_2, dtype=bool)
    if n_info_bits <= 360:
        m = 20 - 1
        last = 360 - n_info_bits
    else:
        m = (KBCH_1_2 - n_info_bits) // 360
        last = KBCH_1_2 - n_info_bits - 360 * m
    for n in range(m):
        g = int(post_padding[n])
        size = 192 if g == 19 else 360
        mask[g * 360 : g * 360 + size] = True
    g = int(post_padding[m])
    start = g * 360 + (192 if g == 19 else 360) - last
    mask[start : start + last] = True
    return mask


def _puncture_mask(cfg: T2Config) -> np.ndarray:
    """True where the 9000 L1-post LDPC parity bits are punctured;
    reference :1787-1816."""
    post_puncture = table({
        L1Constellation.BPSK: "post_puncture_bqpsk",
        L1Constellation.QPSK: "post_puncture_bqpsk",
        L1Constellation.QAM16: "post_puncture_16qam",
        L1Constellation.QAM64: "post_puncture_64qam",
    }[cfg.l1_constellation])
    n_punc = cfg.n_punc
    mask = np.zeros(16200 - NBCH_1_2, dtype=bool)
    for c in range(n_punc // 360):
        mask[np.arange(360) * 25 + post_puncture[c]] = True
    rem = n_punc - (n_punc // 360) * 360
    mask[np.arange(rem) * 25 + post_puncture[n_punc // 360]] = True
    return mask


def _l1post_bits(cfg: T2Config, frame_idx: int) -> np.ndarray:
    """The N_post bits after padding/puncture removal and bit interleaving."""
    info = []
    for _, value, width in l1post_fields(cfg, frame_idx):
        info.extend(_bits(value, width))
    info = np.array(info, dtype=np.uint8)
    assert info.size == cfg.ksig_post - 32, info.size
    info = np.concatenate([info, crc32_bits(info)])  # ksig_post bits

    if cfg.l1_scrambled and cfg.version == Version.V131:
        info = info ^ bb_scrambler(KBCH_1_2)[: info.size]

    pad = _padding_mask(cfg, info.size)
    msg = np.zeros(KBCH_1_2, dtype=np.uint8)
    msg[~pad] = info
    codeword = np.concatenate([msg, _bch_parity(msg)])
    parity = _ldpc_parity(codeword, "post")
    punct = _puncture_mask(cfg)

    bits = np.concatenate([
        info,
        codeword[KBCH_1_2:NBCH_1_2],
        parity[~punct],
    ])
    assert bits.size == cfg.n_post, (bits.size, cfg.n_post)

    # bit interleave for 16QAM/64QAM: (numCols, rows) read column-major
    if cfg.l1_constellation in (L1Constellation.QAM16, L1Constellation.QAM64):
        cols = 8 if cfg.l1_constellation == L1Constellation.QAM16 else 12
        bits = bits.reshape(cols, cfg.n_post // cols).T.reshape(-1)
    return bits


def _map_l1post(cfg: T2Config, bits: np.ndarray) -> np.ndarray:
    lut = l1_lut(cfg.l1_constellation)
    eta = cfg.eta_mod
    if cfg.l1_constellation == L1Constellation.BPSK:
        return lut[bits].astype(np.complex64)
    if cfg.l1_constellation == L1Constellation.QPSK:
        words = bits.reshape(-1, 2) @ np.array([2, 1])
        return lut[words].astype(np.complex64)
    # 16QAM/64QAM: demux pairs of cell words through the L1 mux tables
    # (reference :1875-1908): output bit e (MSB first) = input bit mux[e].
    mux = table("mux16_l1" if cfg.l1_constellation == L1Constellation.QAM16
                else "mux64_l1")
    groups = bits.reshape(-1, 2 * eta)[:, mux]  # reorder into pack order
    weights = 1 << np.arange(2 * eta - 1, -1, -1)
    packs = groups @ weights
    hi = packs >> eta
    lo = packs & ((1 << eta) - 1)
    words = np.stack([hi, lo], axis=1).reshape(-1)
    return lut[words].astype(np.complex64)


@functools.lru_cache(maxsize=8)
def _l1post_all_cached(cfg: T2Config) -> np.ndarray:
    out = np.empty((cfg.t2_frames, cfg.l1post_cells), dtype=np.complex64)
    for f in range(cfg.t2_frames):
        out[f] = _map_l1post(cfg, _l1post_bits(cfg, f))
    return out


def l1post_cells_all_frames(cfg: T2Config) -> np.ndarray:
    """(t2_frames, l1post_cells) complex64 - one row per FRAME_IDX."""
    return _l1post_all_cached(cfg)
