"""Carrier maps, pilot planes and the P1 preamble (EN 302 755 section 9).

The reference rebuilds the per-symbol carrier map for every symbol of every
frame at runtime (lib/pilotgenp1insert_cc_impl.cc:1285-2782, called from the
hot loop at :2812).  Here the whole thing is precomputed once per config into
two dense planes over (num_symbols, fft_size):

  * ``carrier_src``  int32: index into the frame-mapper cell stream feeding
    each data carrier, or -1 where the carrier is a pilot / PAPR hole / null.
  * ``pilot_plane``  float32: the pilot amplitude (signed) on pilot carriers,
    0 elsewhere.  All DVB-T2 pilots are real-valued BPSK.

The OFDM stage is then one gather + one add per symbol.
"""
import functools
import math

import numpy as np

from . import cp_recipe, table
from .sequences import p1_randomizer, pilot_prbs, pn_sequence
from ..config import CarrierMode, MisoGroup, PAPR, T2Config

# carrier type codes (internal)
DATA = 0
P2PILOT = 1
P2PAPR = 2
SCATTERED = 3
CONTINUAL = 4
TRPAPR = 5

_INVERT_BIT = 8  # or-ed onto the type for MISO-TX2 inverted pilots


def _p2_carrier_map(cfg: T2Config) -> np.ndarray:
    """P2-symbol carrier types; reference :667-926."""
    c_ps, k_ext = cfg.c_ps, cfg.k_ext
    m = np.full(c_ps, DATA, dtype=np.int32)
    miso_tx2 = cfg.miso and cfg.miso_group == MisoGroup.TX2

    def set_p2pilot(i):
        if miso_tx2 and ((i // 3) % 2) and (i % 3 == 0):
            m[i] = P2PILOT | _INVERT_BIT
        else:
            m[i] = P2PILOT

    step = 6 if (cfg.fft_key == "32K" and not cfg.miso) else 3
    for i in range(0, c_ps, step):
        set_p2pilot(i)
    if cfg.carrier_mode == CarrierMode.EXTENDED:
        for i in range(k_ext):
            set_p2pilot(i)
            set_p2pilot(i + (c_ps - k_ext))
    if cfg.miso:
        m[k_ext + 1] = P2PILOT
        m[k_ext + 2] = P2PILOT
        m[c_ps - k_ext - 2] = P2PILOT
        m[c_ps - k_ext - 3] = P2PILOT

    papr_map = table(f"p2_papr_map_{cfg.fft_key.lower()}")
    # 1K/2K/4K have no extended mode; 8K+ offset the map by K_EXT
    offs = k_ext if cfg.fft_key in ("8K", "16K", "32K") else 0
    for v in papr_map:
        m[v + offs] = P2PAPR
    if cfg.miso:
        # extra P2 pilots flanking PAPR holes that fall on the pilot grid
        ext = papr_map + k_ext
        for i, ki in enumerate(ext):
            if ki % 3 == 1 and (i == len(ext) - 1 or ki + 1 != ext[i + 1]):
                m[ki + 1] = P2PILOT
            if ki % 3 == 2 and (i == 0 or ki - 1 != ext[i - 1]):
                m[ki - 1] = P2PILOT
    return m


def _fc_carrier_map(cfg: T2Config) -> np.ndarray:
    """Frame-closing-symbol carrier types; reference :993-1070."""
    c_ps, dx = cfg.c_ps, cfg.sp_dx
    m = np.full(c_ps, DATA, dtype=np.int32)
    miso_tx2 = cfg.miso and cfg.miso_group == MisoGroup.TX2
    for i in range(0, c_ps, dx):
        if miso_tx2 and (i // dx) % 2:
            m[i] = SCATTERED | _INVERT_BIT
        else:
            m[i] = SCATTERED
    if (cfg.fft_key, cfg.pilot_pattern.name) in (
            ("1K", "PP4"), ("1K", "PP5"), ("2K", "PP7")):
        m[c_ps - 2] = SCATTERED
    if miso_tx2 and (cfg.num_data_symbols + cfg.n_p2 - 1) % 2:
        m[0] = SCATTERED | _INVERT_BIT
        m[c_ps - 1] = SCATTERED | _INVERT_BIT
    else:
        m[0] = SCATTERED
        m[c_ps - 1] = SCATTERED
    if cfg.papr in (PAPR.TR, PAPR.BOTH):
        papr_map = table(f"p2_papr_map_{cfg.fft_key.lower()}")
        offs = cfg.k_ext if cfg.fft_key in ("8K", "16K", "32K") else 0
        for v in papr_map:
            m[v + offs] = TRPAPR
    return m


@functools.lru_cache(maxsize=8)
def _cp_positions(fft_key: str, pattern_name: str, extended: bool):
    """Continual-pilot carrier positions for (fft, pattern, carrier mode)."""
    pos = []
    for e in cp_recipe():
        if e["fft"] != fft_key or e["pattern"] != pattern_name:
            continue
        if e["extended_only"] and not extended:
            continue
        vals = table(e["table"])[: e["count"]]
        if e["mod"]:
            vals = vals % e["mod"]
        pos.extend(int(v) for v in vals)
    return pos


def _data_carrier_map(cfg: T2Config, symbol: int) -> np.ndarray:
    """Data-symbol carrier types for a given symbol index; reference
    init_pilots (:1285-2782)."""
    c_ps, k_ext, dx, dy = cfg.c_ps, cfg.k_ext, cfg.sp_dx, cfg.sp_dy
    m = np.full(c_ps, DATA, dtype=np.int32)
    miso_tx2 = cfg.miso and cfg.miso_group == MisoGroup.TX2

    # continual pilots
    for k in _cp_positions(cfg.fft_key, cfg.pilot_pattern.name,
                           cfg.carrier_mode == CarrierMode.EXTENDED):
        if miso_tx2 and ((k // dx) % 2) and (k % dx == 0):
            m[k] = CONTINUAL | _INVERT_BIT
        else:
            m[k] = CONTINUAL

    # scattered pilots
    idx = np.arange(c_ps)
    rem = np.mod(idx - k_ext, dx * dy)
    sp = rem == dx * (symbol % dy)
    if miso_tx2:
        inv = ((idx // dx) % 2).astype(bool)
        m[sp & ~inv] = SCATTERED
        m[sp & inv] = SCATTERED | _INVERT_BIT
    else:
        m[sp] = SCATTERED

    # edge pilots
    if miso_tx2 and symbol % 2:
        m[0] = SCATTERED | _INVERT_BIT
        m[c_ps - 1] = SCATTERED | _INVERT_BIT
    else:
        m[0] = SCATTERED
        m[c_ps - 1] = SCATTERED

    # TR-PAPR reserved tones, shifted along the scattered lattice
    if cfg.papr in (PAPR.TR, PAPR.BOTH):
        if cfg.carrier_mode == CarrierMode.NORMAL:
            shift = dx * (symbol % dy)
        else:
            shift = dx * ((symbol + (k_ext // dx)) % dy)
        for v in table(f"tr_papr_map_{cfg.fft_key.lower()}"):
            m[v + shift] = TRPAPR
    return m


def carrier_maps(cfg: T2Config) -> np.ndarray:
    """(num_symbols, C_PS) carrier-type plane for one T2 frame."""
    maps = np.empty((cfg.num_symbols, cfg.c_ps), dtype=np.int32)
    fc_index = cfg.num_symbols - 1 if cfg.has_fc_symbol else -1
    p2 = _p2_carrier_map(cfg)
    fc = _fc_carrier_map(cfg) if cfg.has_fc_symbol else None
    for s in range(cfg.num_symbols):
        if s < cfg.n_p2:
            maps[s] = p2
        elif s == fc_index:
            maps[s] = fc
        else:
            maps[s] = _data_carrier_map(cfg, s)
    return maps


def pilot_amplitudes(cfg: T2Config):
    return {P2PILOT: cfg.p2_amplitude, SCATTERED: cfg.sp_amplitude,
            CONTINUAL: cfg.cp_amplitude}


def build_planes(cfg: T2Config):
    """Build (carrier_src, pilot_plane) over the full fft grid, with the
    ifftshift baked in (so the OFDM stage is gather + add + plain IFFT).

    Returns:
      carrier_src  int32 (num_symbols, fft) - index into the symbol-major
                   frequency-interleaved cell stream, or -1
      pilot_plane  float32 (num_symbols, fft)
      cells_per_symbol int32 (num_symbols,)
    """
    maps = carrier_maps(cfg)
    num_symbols, c_ps = maps.shape
    fft = cfg.fft_points
    left = (fft - c_ps) // 2 + 1

    prbs = pilot_prbs(c_ps + cfg.k_offset)[cfg.k_offset:]
    pn = pn_sequence()[:num_symbols]
    amp = pilot_amplitudes(cfg)

    src_grid = np.full((num_symbols, fft), -1, dtype=np.int32)
    pilot_grid = np.zeros((num_symbols, fft), dtype=np.float32)
    cells_per_symbol = np.zeros(num_symbols, dtype=np.int32)

    cell_idx = 0
    for s in range(num_symbols):
        types = maps[s] & ~_INVERT_BIT
        inverted = (maps[s] & _INVERT_BIT) != 0
        sign = 1.0 - 2.0 * (prbs ^ pn[s]).astype(np.float32)
        sign = np.where(inverted, -sign, sign)
        row_pilot = np.zeros(c_ps, dtype=np.float32)
        for t, a in amp.items():
            sel = types == t
            row_pilot[sel] = a * sign[sel]
        is_data = types == DATA
        n_data = int(is_data.sum())
        row_src = np.full(c_ps, -1, dtype=np.int32)
        row_src[is_data] = cell_idx + np.arange(n_data, dtype=np.int32)
        cell_idx += n_data
        cells_per_symbol[s] = n_data
        src_grid[s, left : left + c_ps] = row_src
        pilot_grid[s, left : left + c_ps] = row_pilot

    # bake in ifftshift: the reference swaps halves before the backward FFT
    src_grid = np.fft.ifftshift(src_grid, axes=1)
    pilot_grid = np.fft.ifftshift(pilot_grid, axes=1)
    return src_grid, pilot_grid, cells_per_symbol


def p1_waveform(cfg: T2Config, s1: int = None, s2: int = None) -> np.ndarray:
    """The constant 2048-sample P1 preamble (C-A-B structure).

    reference lib/pilotgenp1insert_cc_impl.cc:1119-1178, 2801-2810.
    The S2 "mixed" bit signals FEF parts in the super-frame.
    """
    if s1 is None:
        s1 = int(cfg.preamble)
    if s2 is None:
        s2 = ((int(cfg.fft_size) & 0x7) << 1) | int(cfg.has_fef)
    s1_patterns = table("s1_modulation_patterns").astype(np.uint8)
    s2_patterns = table("s2_modulation_patterns").astype(np.uint8)
    mod_seq = np.concatenate([
        np.unpackbits(s1_patterns[s1]),
        np.unpackbits(s2_patterns[s2]),
        np.unpackbits(s1_patterns[s1]),
    ]).astype(np.int8)
    assert mod_seq.size == 384

    # DBPSK
    dbpsk = np.empty(385, dtype=np.float64)
    dbpsk[0] = 1
    for i in range(1, 385):
        dbpsk[i] = -dbpsk[i - 1] if mod_seq[i - 1] else dbpsk[i - 1]
    chips = dbpsk[1:] * p1_randomizer()

    freq = np.zeros(1024, dtype=np.complex128)
    active = table("p1_active_carriers") + 86
    freq[active] = chips

    def backward_fft_shifted(x):
        # FFTW backward (unnormalized IDFT) == N * ifft
        return 1024.0 * np.fft.ifft(np.fft.ifftshift(x)) / math.sqrt(384.0)

    p1_time = backward_fft_shifted(freq)
    freq_shift = np.roll(freq, 1)  # +1 bin shift for the C/B guard portions
    p1_shift = backward_fft_shifted(freq_shift)

    out = np.concatenate([p1_shift[:542], p1_time, p1_shift[542:1024]])
    return out.astype(np.complex64)


def inverse_sinc(cfg: T2Config) -> np.ndarray:
    """Per-bin inverse-sinc pre-equalization multipliers, IFFT bin order.

    The reference builds a half-table of 1/sinc(pi*f/fs) with f = i*fs/v
    (so the shape is bandwidth-independent), mirrors it about the centre
    carrier, and scales by the RMS of the sinc over the half grid
    (lib/pilotgenp1insert_cc_impl.cc:1179-1219); it is multiplied into the
    assembled carrier grid just before the IFFT (:2887-2889).
    """
    v = cfg.fft_points
    x = np.pi * np.arange(v // 2) / v
    sinc = np.ones(v // 2)
    sinc[1:] = np.sin(x[1:]) / x[1:]
    rms = math.sqrt(float(np.mean(sinc * sinc)))
    half = rms / sinc
    pre_shift = np.concatenate([half[::-1], half])
    return np.fft.ifftshift(pre_shift).astype(np.float32)


def fef_part_waveform(cfg: T2Config) -> np.ndarray:
    """(fef_length,) complex64 FEF part: its own P1 (S1 = non-T2, S2
    signalling the FEF type with the mixed bit set) followed by null
    samples.  The payload of a FEF part is outside EN 302 755's scope
    (section 8.4); null filling keeps the super-frame timing contract."""
    from ..config import Preamble
    out = np.zeros(cfg.fef_length, dtype=np.complex64)
    out[:2048] = p1_waveform(
        cfg, s1=int(Preamble.NON_T2), s2=((cfg.fef_type & 0x7) << 1) | 1)
    return out
