"""The planar OFDM tail: 4-step IFFT plus guard interval on re/im float32
planes, as plain torch matmuls (``dvbt2ll_tpu/ops/ifft_pallas.py:46-98``,
the einsum form the JAX package ships as its default).

With N = N1 * N2 (N1 = 128), input element [b, s, k2, k1] holds carrier
bin N2 * k1 + k2 (the frame builder's gather emits this layout), so both
products keep n1 on the last axis, the result rows come out in natural
sample order, and the guard interval is a copy of the last gi / 128 rows.

Precision matters: the chain must stay above 100 dB SNR against the
reference, and TF32 products would not.  ``ifft_gi_einsum`` refuses to
run on CUDA unless float32 matmuls are full float32.
"""
from __future__ import annotations

import numpy as np
import torch

N1 = 128  # length of the second DFT factor, the last axis of the planes


def supported(fft: int, gi: int) -> bool:
    """Geometry gate of the planar tail: 1K-8K FFTs with fft and gi both
    multiples of 128 (n2 = fft / 128 in [8, 64])."""
    return fft % N1 == 0 and gi % N1 == 0 and 8 <= fft // N1 <= 64


def factor_matrices(fft: int, scale: float):
    """(w1r, w1i, ttr, tti, w2r, w2i) float32 numpy constants; ``scale``
    (1/N of the inverse transform times the chain's fft * ofdm_norm) is
    folded into W1."""
    n2 = fft // N1
    k1 = np.arange(N1)
    k2 = np.arange(n2)
    w1 = np.exp(2j * np.pi * np.outer(k1, k1) / N1) * scale
    t = np.exp(2j * np.pi * np.outer(k2, k1) / fft)    # T[k2, n1]
    w2 = np.exp(2j * np.pi * np.outer(k2, k2) / n2)
    return (np.float32(w1.real), np.float32(w1.imag),
            np.float32(t.real), np.float32(t.imag),
            np.float32(w2.real), np.float32(w2.imag))


def factor_tensors(fft: int, scale: float, device) -> tuple:
    return tuple(torch.from_numpy(m).to(device)
                 for m in factor_matrices(fft, scale))


def set_full_fp32_matmul() -> None:
    """Make float32 matmuls full float32 (no TF32), process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    check_full_fp32_matmul()


def check_full_fp32_matmul() -> None:
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "float32 matmuls are set to TF32 or reduced precision; the OFDM "
            "tail needs full float32 (torch.backends.cuda.matmul."
            "allow_tf32=False, set_float32_matmul_precision('highest'))")


def ifft_gi_einsum(grids_re_t: torch.Tensor, grids_im_t: torch.Tensor,
                   fft: int, gi: int, scale: float, mats=None):
    """Transposed-layout grids (B, S, N2, N1) float32 planes -> time domain
    with guard interval (B, S, fft + gi) float32 planes (re, im).
    ``mats``: ``factor_tensors(fft, scale, device)``, made once by the
    caller; built here when None."""
    if grids_re_t.is_cuda:
        check_full_fp32_matmul()
    b, s, n2, n1 = grids_re_t.shape
    if n1 != N1 or n2 != fft // N1 or gi % N1:
        raise ValueError(f"grids {tuple(grids_re_t.shape)} do not fit "
                         f"fft={fft} gi={gi}")
    gi_rows = gi // N1
    if mats is None:
        mats = factor_tensors(fft, scale, grids_re_t.device)
    w1r, w1i, ttr, tti, w2r, w2i = mats
    br = grids_re_t @ w1r - grids_im_t @ w1i
    bi = grids_re_t @ w1i + grids_im_t @ w1r
    cr = br * ttr - bi * tti
    ci = br * tti + bi * ttr
    xr = w2r @ cr - w2i @ ci
    xi = w2r @ ci + w2i @ cr
    body_re = torch.cat([xr[:, :, n2 - gi_rows:], xr], dim=2)
    body_im = torch.cat([xi[:, :, n2 - gi_rows:], xi], dim=2)
    return (body_re.reshape(b, s, fft + gi),
            body_im.reshape(b, s, fft + gi))
