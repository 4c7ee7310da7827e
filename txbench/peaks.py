"""The table of peaks, and the roofline arithmetic the kernel metrics use.

Published figures of one NVIDIA H100 SXM (NVIDIA's data sheet, at the
full 700 W): 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the
tensor cores, the rates ``dvbt2ll_tpu_torch/tools/roofline.py`` divides
by.  A kernel's share of its roofline is the least time the card could
take for the work at the stage's interface (bytes read once and written
once, over the memory rate, or float32 operations over the float32 rate,
the larger) over the time the trace shows.
"""
from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
P1_LEN = 2048            # samples of P1
N1 = 128                 # the planar tail's second DFT factor


def bound_s(nbytes: float, flops: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)


def share_pct(nbytes: float, flops: float, seconds: float):
    """The roofline share in %, or None where no time was traced."""
    if seconds <= 0:
        return None
    return 100.0 * bound_s(nbytes, flops) / seconds


def fft_flops(frames: int, symbols: int, fft: int) -> float:
    """5 N log2 N float32 operations a complex transform of N points."""
    return 5.0 * frames * symbols * fft * math.log2(fft)


def ldpc_bytes(cfg, fec_frames: int) -> int:
    """The LDPC codeword kernel: each frame's nbch u8 bits read, its
    ldpc_frame_bits u8 codeword written."""
    return fec_frames * (cfg.nbch + cfg.ldpc_frame_bits)


def tail_bytes(cfg, frames: int) -> int:
    """The fused planar tail: the (B, S, N2, 128) re and im grids, P1
    (2048, 2), the (128, 2) and (fft, 2) twiddle tables, float32, read
    once; the (B, 2048 + S (fft + gi), 2) float32 I/Q written once."""
    s, fft, gi = cfg.num_symbols, cfg.fft_points, cfg.guard_samples
    return 4 * (2 * frames * s * fft + 2 * P1_LEN + 2 * N1 + 2 * fft
                + 2 * frames * (P1_LEN + s * (fft + gi)))

