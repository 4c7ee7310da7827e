"""Any T2 frame of a TS stream, worked out from the stream alone, and the
comparison that decides ``correct``.

The program carries stream state across steps: the 187-byte window
before each step (whose CRC-8 becomes the next sync byte) and the T2
frame counter (which selects the L1-post dynamic part).  Here both come
again from the stream itself: T2 frame g starts at FEC frame
g * fec_blocks, which in NORMAL mode without in-band signalling starts
(kbch - 80) / 8 TS bytes a FEC frame into the stream, so the TS packet
phase and the running CRC-8 at that byte follow from the bytes before
it, and the frame counter is g mod t2_frames.
"""
from __future__ import annotations

import numpy as np

from . import chain
from .config import InBand, InputMode, T2Config
from .tables.bbframe import _crc8_byte_table


def _check_mode(cfg: T2Config) -> None:
    if cfg.input_mode != InputMode.NORMAL or cfg.in_band != InBand.OFF:
        raise ValueError("the frame reference takes NORMAL input mode "
                         "without in-band signalling")
    if cfg.num_plp != 1:
        raise ValueError("the frame reference takes one PLP")


def stream_state(cfg: T2Config, stream, offset: int) -> tuple:
    """(count, crc) of the oracle's BB framing at TS byte ``offset``:
    the byte's place in its packet, and the CRC-8 of the packet bytes
    after the last sync byte before it (at a sync byte, of the whole
    packet before)."""
    count = offset % 188
    lo = max(0, offset - (187 if count == 0 else count - 1))
    tab = _crc8_byte_table()
    crc = 0
    for b in stream(lo, offset):
        crc = int(tab[int(b) ^ crc])
    return count, crc


def t2_frame(cfg: T2Config, stream, g: int, ifft=np.fft.ifft) -> np.ndarray:
    """T2 frame ``g`` (counted from the stream's first byte) as complex64
    (samples_per_frame,).  ``stream(start, stop)`` returns TS bytes
    [start, stop) of the stream."""
    _check_mode(cfg)
    k = cfg.fec_blocks
    d = cfg.kbch // 8 - 10
    off = g * k * d
    count, crc = stream_state(cfg, stream, off)
    frames, _ = chain.bbheader_frames(cfg, stream(off, off + k * d), k,
                                      (count, crc, 0, 0))
    cells = chain.interleave_and_map(cfg, chain.ldpc_encode(cfg, frames))
    mapped = chain.frame_map(cfg, cells.reshape(-1), g % cfg.t2_frames)
    return chain.ofdm_modulate(cfg, mapped, ifft)


def _tf32(x: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32 (10 mantissa bits), to nearest."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_ifft(row: np.ndarray) -> np.ndarray:
    """The inverse DFT as a TF32 product computes it: inputs and outputs
    rounded to TF32, float32 in between.  The control: the precision
    below the float32 that the configuration's complex64 IQ states."""
    r = row.astype(np.complex64)
    r = _tf32(r.real) + 1j * _tf32(r.imag)
    t = np.fft.ifft(r.astype(np.complex64)).astype(np.complex64)
    return _tf32(t.real) + 1j * _tf32(t.imag)


def rel_err(got: np.ndarray, ref: np.ndarray) -> float:
    """||got - ref|| / ||ref|| over one frame's samples, in float64."""
    got = np.asarray(got, np.complex128).reshape(-1)
    ref = np.asarray(ref, np.complex128).reshape(-1)
    if got.shape != ref.shape:
        return float("inf")
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
