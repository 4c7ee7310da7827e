"""The planar OFDM tail: P1, then the 4-step IFFT plus guard interval of
each symbol, from re/im float32 planes to the final (B, samples, 2) I/Q.
``ifft_gi`` runs the CUDA kernel ``csrc/ifft_gi.cu`` on a CUDA tensor;
``ofdm_tail_plain`` is its plain twin: ``ifft_gi_einsum`` (torch matmuls in
the einsum form the JAX package ships as its default,
``dvbt2ll_tpu/ops/ifft_pallas.py:70-98``), the P1 concat and the I/Q
stack.  The kernel replaces the Pallas TPU kernel ``ifft_gi_pallas``
(``ifft_pallas.py:181``) and that epilogue; see its source for what bounds
it on the card and what its design does about it.  The complex tail's
transform (16K, 32K and odd guard intervals) is ``fft_tail``: cuFFT through
``torch.fft``, counted like a kernel.

With N = N1 * N2 (N1 = 128), input element [b, s, k2, k1] holds carrier
bin N2 * k1 + k2 (the frame builder's gather emits this layout), so both
products keep n1 on the last axis, the result rows come out in natural
sample order, and the guard interval is a copy of the last gi / 128 rows.

Precision matters: the chain must stay above 100 dB SNR against the
reference, and TF32 products would not.  The kernel computes radix FFT
passes in full float32 with twiddles made in float64; ``ifft_gi_einsum``
refuses to run on CUDA unless float32 matmuls are full float32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

N1 = 128  # length of the second DFT factor, the last axis of the planes
P1_LEN = 2048  # samples of the P1 symbol at the head of every frame


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


@dataclasses.dataclass(frozen=True, eq=False)
class TailTables:
    """One geometry's constants, made once and kept on the device: the
    twin's factor matrices (``factor_tensors``) and the kernel's twiddle
    tables, float64 cast to float32 and interleaved (re, im): ``w128``
    (128, 2) = exp(2 pi i k / 128), ``twiddle`` (fft, 2) = scale *
    exp(2 pi i k / fft)."""

    fft: int
    mats: tuple
    w128: torch.Tensor
    twiddle: torch.Tensor


def tail_tables(fft: int, scale: float, device) -> TailTables:
    def iq(z):
        return torch.from_numpy(np.ascontiguousarray(np.stack(
            [z.real, z.imag], axis=-1), dtype=np.float32)).to(device)

    return TailTables(
        fft, factor_tensors(fft, scale, device),
        iq(np.exp(2j * np.pi * np.arange(N1) / N1)),
        iq(scale * np.exp(2j * np.pi * np.arange(fft) / fft)))


def ofdm_tail_plain(grids_re_t: torch.Tensor, grids_im_t: torch.Tensor,
                    p1_iq: torch.Tensor, fft: int, gi: int, scale: float,
                    tables: TailTables | None = None) -> torch.Tensor:
    """Transposed-layout grids (B, S, N2, N1) float32 planes and P1
    (2048, 2) -> (B, 2048 + S (fft + gi), 2) float32 I/Q: P1, then each
    symbol with its guard interval (``ifft_gi_einsum``)."""
    b = grids_re_t.shape[0]
    mats = None if tables is None else tables.mats
    body_re, body_im = ifft_gi_einsum(grids_re_t, grids_im_t, fft, gi, scale,
                                      mats)
    body = torch.stack([body_re.reshape(b, -1), body_im.reshape(b, -1)],
                       dim=-1)
    return torch.cat([p1_iq.expand(b, -1, -1), body], dim=1)


def ifft_gi(grids_re_t: torch.Tensor, grids_im_t: torch.Tensor,
            p1_iq: torch.Tensor, fft: int, gi: int, scale: float,
            tables: TailTables | None = None) -> torch.Tensor:
    """``ofdm_tail_plain``'s contract: transposed-layout grids (B, S, N2,
    N1) float32 planes and P1 (2048, 2) float32 -> the frames' final
    (B, 2048 + S (fft + gi), 2) float32 I/Q, with ``tables =
    tail_tables(fft, scale, device)`` (built when None).

    A CPU tensor goes through the plain twin.  A CUDA tensor launches
    the kernel, or raises: there is no fallback; while a CUDA graph is
    captured, ``tables`` must be given.  ``ifft_gi.launches`` counts
    kernel launches (under a CUDA graph, ``compiled.CompiledStep`` counts
    the replays' launches)."""
    shape = tuple(grids_re_t.shape)
    n2 = fft // N1
    if (not supported(fft, gi) or gi > fft
            or shape != tuple(grids_im_t.shape) or len(shape) != 4
            or shape[2:] != (n2, N1)):
        raise ValueError(f"grids {shape} and {tuple(grids_im_t.shape)} do "
                         f"not fit fft={fft} gi={gi}")
    if tuple(p1_iq.shape) != (P1_LEN, 2):
        raise ValueError(f"P1 of shape {tuple(p1_iq.shape)}, expected "
                         f"({P1_LEN}, 2)")
    if any(t.dtype != torch.float32 for t in (grids_re_t, grids_im_t, p1_iq)):
        raise ValueError(f"grids and P1 must be float32, got "
                         f"{grids_re_t.dtype}, {grids_im_t.dtype} and "
                         f"{p1_iq.dtype}")
    dev = grids_re_t.device
    if grids_im_t.device != dev or p1_iq.device != dev:
        raise ValueError(f"grids on {dev} and {grids_im_t.device}, P1 on "
                         f"{p1_iq.device}")
    if tables is not None and tables.fft != fft:
        raise ValueError(f"tables of fft={tables.fft}, expected fft={fft}")
    if dev.type == "cpu":
        return ofdm_tail_plain(grids_re_t, grids_im_t, p1_iq, fft, gi, scale,
                               tables)
    if dev.type != "cuda":
        raise ValueError(f"no OFDM tail kernel for device {dev}")
    if tables is None:
        if torch.cuda.is_current_stream_capturing():
            # the tables' upload is a host-to-device copy, which a CUDA
            # graph cannot record
            raise RuntimeError("ifft_gi: pass tables=tail_tables(...) made "
                               "before a CUDA graph capture")
        tables = tail_tables(fft, scale, dev)
    for t in (tables.w128, tables.twiddle):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"tail tables must be float32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
    for t in (grids_re_t, grids_im_t, p1_iq, tables.w128, tables.twiddle):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("grids, P1 and tail tables must be contiguous "
                             "and 16-byte aligned")
    b, s = shape[:2]
    out = torch.empty((b, P1_LEN + s * (fft + gi), 2), dtype=torch.float32,
                      device=dev)
    if b * s == 0:
        out.copy_(p1_iq.expand_as(out))
        return out
    from . import _build

    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.dvbt2ll_ofdm_tail(
            grids_re_t.data_ptr(), grids_im_t.data_ptr(), p1_iq.data_ptr(),
            tables.w128.data_ptr(), tables.twiddle.data_ptr(),
            out.data_ptr(), b, s, n2, gi // N1, torch.cuda.current_device(),
            stream)
    _build.check(lib, code, "ifft_gi launch")
    ifft_gi.launches += 1
    return out


ifft_gi.launches = 0


def fft_tail(grids: torch.Tensor, scale: float) -> torch.Tensor:
    """The complex tail's transform: (..., fft) complex64 grids -> their
    inverse DFT over the last axis times ``scale`` (``torch.fft.ifft``:
    cuFFT on a card, pocketfft or MKL on the CPU).  ``fft_tail.launches``
    counts the calls on a CUDA tensor, a slab each in the symbol-sharded
    back-end (under a CUDA graph, ``compiled.CompiledStep`` counts the
    replays'); the guard interval and P1 copies after it are not its."""
    out = torch.fft.ifft(grids, dim=-1) * scale
    if grids.is_cuda:
        fft_tail.launches += 1
    return out


fft_tail.launches = 0
