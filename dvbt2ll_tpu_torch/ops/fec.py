"""BB framing, packet CRC-8, scrambling and BCH: the CUDA kernel
(``csrc/bb_bch.cu``), which writes a step's (frames, nbch) info bits and
BCH parity, and its plain torch twin.

The kernel replaces no TPU kernel: the JAX package writes this stage as
XLA ops (``dvbt2ll_tpu/pipeline.py``'s ``bb_and_fec``), its CRC-8 and BCH
as GF(2) matrix products, which the TPU's matrix unit makes nearly free.
On the card those products were float32 GEMMs over a byte a bit.  The
reference binary fuses the same stage into one block (``bbheaderbch_bb``,
lib/bbheaderbch_bb_impl.cc:424-531), its BCH a byte-serial LFSR; the
kernel does the same on packed bytes.  See the kernel source for what
bounds it and what its design does about that.

The twin is the torch body that the port ran before the kernel: the BB
data field as reshapes and slices of the window, the CRC-8 and BCH as
GF(2) products (``_bits.gf2_matmul``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from .._bits import gf2_matmul, packbits, unpackbits
from ..config import FrameSize
from ..tables.bbframe import _crc8_byte_table
from ..tables.bch import generator_poly

REG_BITS = 192  # the kernel's remainder register: six 32-bit words


@dataclasses.dataclass(frozen=True, eq=False)
class BbBch:
    """One PLP's BB framing and BCH constants for a step of ``frames``
    FEC frames a block, read from its host plan.

    The kernel and the twin both read ``headers_b``, ``scramble_b`` and
    ``inband_b``.  The kernel alone reads ``crc_tables`` and ``bch_steps``
    (25 KB, on every device); the twin alone reads ``crc_matrix`` and
    ``bch_matrix``, which only a CPU device holds (None on a CUDA one,
    where the kernel runs)."""

    frames: int                    # FEC frames a block
    packets: int                   # sync slots in a block's fresh bytes
    sync_offset: int               # fresh-stream index of the first one
    fresh: int                     # fresh TS bytes a block
    hieff: bool
    inband: bool
    fec_blocks: int
    kbch: int
    nbch: int
    headers_b: torch.Tensor        # (frames, 10) u8, packed BB headers
    scramble_b: torch.Tensor       # (kbch / 8,) u8, packed BB scrambler
    inband_b: Optional[torch.Tensor]   # (13,) u8 in-band field, or None
    crc_tables: torch.Tensor       # (1024,) u8, ``crc8_tables``
    bch_steps: torch.Tensor        # (6144,) i32, ``bch_step_tables``
    crc_matrix: Optional[torch.Tensor]  # (1496, 8) f32, packet CRC-8
    bch_matrix: Optional[torch.Tensor]  # (kbch, nbch - kbch) f32


def _poly_mod(a: int, g: int) -> int:
    """a(x) mod g(x) over GF(2), bit i = coefficient of x^i."""
    dg = g.bit_length() - 1
    while a.bit_length() - 1 >= dg:
        a ^= g << (a.bit_length() - 1 - dg)
    return a


@functools.lru_cache(maxsize=8)
def bch_step_tables(short: bool, t: int) -> np.ndarray:
    """The kernel's BCH step tables, (4, 3, 256, 2) uint32.

    The remainder r(x) of degree < npar (npar = deg g) is held
    left-aligned in a 192-bit register of six words, word w bits
    32 w .. 32 w + 31, coefficient x^(npar - 1) at bit 191.  A step takes
    32 message bits v (first bit most significant) as
    r' = r x^32 + v(x) x^npar mod g: the register shifted up a word, XOR
    the four entries ``tab[q, :, (v' >> 8 q) & 255]`` of v' = v ^ (its
    top word), entry b of table q being b(x) x^(npar + 8 q) mod g,
    left-aligned.  An entry's six words are three pairs (w0, w1),
    (w2, w3), (w4, w5), each pair a 256-entry row."""
    g = generator_poly(short, t)
    npar = g.bit_length() - 1
    tab = np.zeros((4, 3, 256, 2), np.uint32)
    for q in range(4):
        for b in range(256):
            r = _poly_mod(b << (npar + 8 * q), g) << (REG_BITS - npar)
            for w in range(REG_BITS // 32):
                tab[q, w // 2, b, w % 2] = (r >> (32 * w)) & 0xFFFFFFFF
    return tab


def crc8_tables() -> np.ndarray:
    """(4, 256) uint8: the packet CRC-8 four bytes a step.  Row 0 is the
    byte step crc' = T0[crc ^ b]; row k is T0 applied k + 1 times, so
    after bytes b0 b1 b2 b3 crc' = T3[crc ^ b0] ^ T2[b1] ^ T1[b2] ^ T0[b3]
    (the CRC is linear and starts at 0)."""
    rows = [_crc8_byte_table()]
    for _ in range(3):
        rows.append(rows[0][rows[-1]])
    return np.stack(rows)


def bb_bch_tables(pp, device) -> BbBch:
    """A host ``PlpPlan``'s BB framing and BCH constants on ``device``."""
    cfg, bb = pp.cfg, pp.bb
    cpu = torch.device(device).type == "cpu"

    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(
            device)

    steps = bch_step_tables(cfg.frame_size == FrameSize.SHORT, cfg.bch_t)
    return BbBch(
        frames=pp.fec_frames, packets=pp.n_packets,
        sync_offset=bb.sync_offset, fresh=bb.ts_bytes_in, hieff=bb.hieff,
        inband=bb.inband, fec_blocks=cfg.fec_blocks, kbch=cfg.kbch,
        nbch=cfg.nbch,
        headers_b=dev(np.packbits(np.asarray(pp.headers, np.uint8), axis=1),
                      np.uint8),
        scramble_b=dev(np.packbits(np.asarray(pp.scramble, np.uint8)),
                       np.uint8),
        inband_b=(None if bb.inband_bits is None
                  else dev(np.packbits(np.asarray(bb.inband_bits,
                                                  np.uint8)), np.uint8)),
        crc_tables=dev(crc8_tables().reshape(-1), np.uint8),
        bch_steps=dev(steps.reshape(-1).view(np.int32), np.int32),
        crc_matrix=dev(pp.crc_matrix, np.float32) if cpu else None,
        bch_matrix=dev(pp.bch_matrix, np.float32) if cpu else None)


def _pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad the last axis of x at its end to length n."""
    if x.shape[-1] > n:
        raise ValueError(f"{x.shape[-1]} bytes do not fit in {n}")
    return torch.cat([x, x.new_zeros(*x.shape[:-1], n - x.shape[-1])],
                     dim=-1)


def bb_bch_plain(t: BbBch, ts: torch.Tensor) -> torch.Tensor:
    """(blocks, 187 + fresh) u8 windows -> (blocks * F, nbch) u8 bits, in
    torch ops: BB framing in the byte domain (the TS -> data-field map is
    affine, so it is reshapes and slices), NORMAL mode's sync bytes
    replaced with the CRC-8 of the packet before each (a GF(2) product),
    HIEFF's dropped, in-band frames carrying the in-band field; then
    scrambling and BCH (a GF(2) product)."""
    if t.crc_matrix is None:
        raise ValueError("the plain twin needs the GF(2) matrices, which "
                         "only a CPU device holds")
    f, p = t.frames, t.packets
    blocks = ts.shape[0]
    nfresh = ts.shape[1] - 187

    if t.hieff:
        stream_b = ts[:, 187:].reshape(blocks, p, 188)[:, :, 1:].reshape(
            blocks, -1)
    elif p == 0:
        # no sync slot in the window: the payload passes unmodified
        stream_b = ts[:, 187:]
    else:
        # o = fresh-stream index of the first sync slot; sync slot i sits
        # at fresh byte o + 188 i and its CRC covers the 187 bytes before
        # it: the carry window's tail for i = 0, packet row i - 1 after
        o = t.sync_offset
        aligned = _pad_to(ts[:, 187 + o:], p * 188).reshape(blocks, p, 188)
        pkt_b = torch.cat([ts[:, None, o:o + 187], aligned[:, :-1, 1:]],
                          dim=1)                           # (blocks, p, 187)
        crc = gf2_matmul(unpackbits(pkt_b.reshape(blocks * p, 187), dim=1),
                         t.crc_matrix)
        groups = torch.cat([packbits(crc, dim=1).reshape(blocks, p, 1),
                            aligned[:, :, 1:]], dim=2).reshape(blocks, -1)
        if o:
            stream_b = torch.cat([ts[:, 187:187 + o], groups],
                                 dim=1)[:, :nfresh]
        else:
            stream_b = groups[:, :nfresh]

    kbch_b = t.kbch // 8
    d_bytes = kbch_b - 10
    if not t.inband:
        df = stream_b.reshape(blocks, f, d_bytes)
        kb_bytes = torch.cat([t.headers_b.expand(blocks, -1, -1), df], dim=2)
    else:
        # first frame of each fec_blocks group: 13 fewer payload bytes,
        # then the 104-bit in-band field
        k = t.fec_blocks
        b = blocks * (f // k)                  # the groups of every block
        groups = stream_b.reshape(b, k * d_bytes - 13)
        hdrs = t.headers_b.reshape(1, f // k, k, 10).expand(
            blocks, -1, -1, -1).reshape(b, k, 10)
        ib = t.inband_b[None, :].expand(b, -1)
        kb0 = torch.cat([hdrs[:, 0], groups[:, :d_bytes - 13], ib], dim=1)
        rest = groups[:, d_bytes - 13:].reshape(b, k - 1, d_bytes)
        kbr = torch.cat([hdrs[:, 1:], rest], dim=2)
        kb_bytes = torch.cat([kb0[:, None], kbr], dim=1)

    kbch_bits = unpackbits(kb_bytes.reshape(blocks * f, kbch_b)
                           ^ t.scramble_b, dim=1)    # (blocks * F, kbch)
    bch_par = gf2_matmul(kbch_bits, t.bch_matrix)
    return torch.cat([kbch_bits, bch_par], dim=1)    # (blocks * F, nbch)


def bb_bch(t: BbBch, ts: torch.Tensor) -> torch.Tensor:
    """(blocks, 187 + fresh) u8 windows, one a block -> (blocks * F,
    nbch) u8 bits (0/1): each FEC frame's scrambled BB frame, then its
    BCH parity, the blocks' frames block after block.

    A CPU tensor goes through the plain twin.  A CUDA tensor launches
    the kernel, or raises: there is no fallback.  ``bb_bch.launches``
    counts kernel launches (under a CUDA graph, ``compiled.CompiledStep``
    counts the replays' launches)."""
    if (ts.dtype != torch.uint8 or ts.dim() != 2
            or ts.shape[1] != 187 + t.fresh):
        raise ValueError(f"expected (blocks, {187 + t.fresh}) uint8 "
                         f"windows, got {tuple(ts.shape)} {ts.dtype}")
    dev = ts.device
    if dev.type == "cpu":
        return bb_bch_plain(t, ts)
    if dev.type != "cuda":
        raise ValueError(f"no BB/BCH kernel for device {dev}")
    if not ts.is_contiguous():
        raise ValueError("the windows must be contiguous")
    if t.crc_tables.device != dev:
        raise ValueError(f"tables on {t.crc_tables.device}, windows on {dev}")
    n = ts.shape[0] * t.frames
    out = torch.empty((n, t.nbch), dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    from . import _build

    lib = _build.library()
    inband = t.inband_b.data_ptr() if t.inband else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.dvbt2ll_bb_bch(
            ts.data_ptr(), out.data_ptr(), t.headers_b.data_ptr(),
            t.scramble_b.data_ptr(), inband, t.crc_tables.data_ptr(),
            t.bch_steps.data_ptr(), n, ts.shape[1], t.frames, t.packets,
            t.sync_offset, int(t.hieff), t.fec_blocks if t.inband else 0,
            t.kbch, t.nbch, torch.cuda.current_device(), stream)
    _build.check(lib, code, "bb_bch launch")
    bb_bch.launches += 1
    return out


bb_bch.launches = 0
