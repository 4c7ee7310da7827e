"""Bit interleaving and QAM mapping: the CUDA kernel (``csrc/qam_map.cu``),
which maps a step's LDPC codewords to constellation cells in one pass,
and its plain torch twin.

The kernel replaces no TPU kernel: the JAX package writes this stage as
XLA ops (``dvbt2ll_tpu/pipeline.py``'s ``map_cells_planes``), which XLA
fuses.  On the card the same torch ops were eight and more passes over the
batch, the first an int64-indexed gather of every bit.  The reference
binary does the stage in one block (``interleavermod_bc``,
lib/interleavermod_bc_impl.cc:270-704); the kernel does the same from the
codeword to the cells.  See the kernel source for what bounds it and what
its design does about that.

The twin is the torch body that the port ran before the kernel: one
bit-interleave gather, then the closed form of the Gray-coded square QAM,
the rotation and the cyclic Q delay.  The kernel rounds the same products
and sums in the same order, so the two are bit-identical.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

# the square QAM's mean power a mod_bits (EN 302 755 section 6.2.2)
_POWER = {2: 2.0, 4: 10.0, 6: 42.0, 8: 170.0}


@dataclasses.dataclass(frozen=True, eq=False)
class QamMap:
    """One PLP's mapper constants, read from its host plan.

    The kernel reads ``perm16``, the (cell_size, mod_bits) bit indices as
    uint16 (every index is below ldpc_frame_bits <= 64800), on every
    device; the twin reads ``perm``, the same indices as int64, which only
    a CPU device holds (None on a CUDA one, where the kernel runs)."""

    mod: int                       # bits a cell
    rotation: bool
    frame_bits: int                # ldpc_frame_bits
    cells: int                     # cell_size
    inv_norm: float                # 1 / sqrt(mean power)
    cos_t: float                   # of the rotation angle (1 unrotated)
    sin_t: float
    perm16: torch.Tensor           # (cells, mod) u16
    perm: Optional[torch.Tensor]   # (cells, mod) i64, or None


def qam_tables(pp, device) -> QamMap:
    """A host ``PlpPlan``'s mapper constants on ``device``."""
    cfg = pp.cfg
    mod = cfg.mod_bits
    perm = np.asarray(pp.mapper_perm).reshape(cfg.cell_size, mod)
    if perm.min() < 0 or perm.max() >= cfg.ldpc_frame_bits:
        raise ValueError("bit permutation out of the codeword")
    ang = math.radians(cfg.rotation_angle_deg)
    return QamMap(
        mod=mod, rotation=bool(cfg.rotation),
        frame_bits=cfg.ldpc_frame_bits, cells=cfg.cell_size,
        inv_norm=1.0 / float(np.sqrt(_POWER[mod])),
        cos_t=math.cos(ang), sin_t=math.sin(ang),
        perm16=torch.from_numpy(perm.astype(np.uint16)).to(device),
        perm=(torch.from_numpy(perm.astype(np.int64))
              if torch.device(device).type == "cpu" else None))


def qam_map_plain(t: QamMap, frame_bits: torch.Tensor):
    """(F, frame_bits) u8 codewords -> ((F, cells), (F, cells)) f32 cell
    planes, in torch ops: one bit-interleave gather, then per axis
    A = (2^h - 1) - 2 G, with G the packed prefix XOR of the axis bits
    (EN 302 755 section 6.2), the scale, then rotation and the cyclic Q
    delay of one cell within each frame's row."""
    if t.perm is None:
        raise ValueError("the plain twin needs the int64 bit indices, "
                         "which only a CPU device holds")
    mod = t.mod
    h = mod // 2
    cell_bits = frame_bits[:, t.perm]                         # (F, CS, mod)

    def axis_level(bv):  # (F, CS, h) u8 bits, most significant first
        acc = bv[..., 0]
        g = acc
        for k in range(1, h):
            acc = acc ^ bv[..., k]
            g = (g << 1) | acc
        return float((1 << h) - 1) - 2.0 * g.to(torch.float32)

    i_level = axis_level(cell_bits[..., 0::2]) * t.inv_norm
    q_level = axis_level(cell_bits[..., 1::2]) * t.inv_norm
    if t.rotation:
        i_rot = i_level * t.cos_t - q_level * t.sin_t
        q_rot = i_level * t.sin_t + q_level * t.cos_t
        return i_rot, torch.roll(q_rot, 1, dims=1)
    return i_level, q_level


def qam_map(t: QamMap, frame_bits: torch.Tensor, planar: bool):
    """(F, frame_bits) u8 codewords -> each FEC frame's cells: two
    (F, cells) f32 planes (re, im) when ``planar``, else (F, cells)
    complex64.  The caller's tail decides the layout: the planar frame
    builder takes planes, the complex one complex cells.

    A CPU tensor goes through the plain twin.  A CUDA tensor launches
    the kernel, or raises: there is no fallback.  ``qam_map.launches``
    counts kernel launches (under a CUDA graph, ``compiled.CompiledStep``
    counts the replays' launches)."""
    if (frame_bits.dtype != torch.uint8 or frame_bits.dim() != 2
            or frame_bits.shape[1] != t.frame_bits):
        raise ValueError(f"expected (frames, {t.frame_bits}) uint8 "
                         f"codewords, got {tuple(frame_bits.shape)} "
                         f"{frame_bits.dtype}")
    dev = frame_bits.device
    if dev.type == "cpu":
        planes = qam_map_plain(t, frame_bits)
        return planes if planar else torch.complex(*planes)
    if dev.type != "cuda":
        raise ValueError(f"no QAM mapping kernel for device {dev}")
    if not frame_bits.is_contiguous() or frame_bits.data_ptr() % 8:
        raise ValueError("the codewords must be contiguous and 8-byte "
                         "aligned")
    if t.perm16.device != dev:
        raise ValueError(f"tables on {t.perm16.device}, codewords on {dev}")
    f = frame_bits.shape[0]
    if planar:
        out = (torch.empty((f, t.cells), dtype=torch.float32, device=dev),
               torch.empty((f, t.cells), dtype=torch.float32, device=dev))
        ptrs = (out[0].data_ptr(), out[1].data_ptr())
    else:
        out = torch.empty((f, t.cells), dtype=torch.complex64, device=dev)
        ptrs = (out.data_ptr(), None)
    if f == 0:
        return out
    from . import _build

    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.dvbt2ll_qam_map(
            frame_bits.data_ptr(), t.perm16.data_ptr(), *ptrs, f,
            t.frame_bits, t.cells, t.mod, int(t.rotation), int(not planar),
            t.inv_norm, t.cos_t, t.sin_t, torch.cuda.current_device(),
            stream)
    _build.check(lib, code, "qam_map launch")
    qam_map.launches += 1
    return out


qam_map.launches = 0
