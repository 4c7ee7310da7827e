"""Bits on tensors: ``numpy.packbits``/``unpackbits`` (most significant
bit first) and GF(2) matrix products, for any device."""
from __future__ import annotations

import torch


def _msb_first_shifts(device) -> torch.Tensor:
    return torch.arange(7, -1, -1, dtype=torch.uint8, device=device)


def unpackbits(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """uint8 bytes -> uint8 bits (0/1), eight per byte along ``dim``."""
    x = x.movedim(dim, -1)
    bits = (x.unsqueeze(-1) >> _msb_first_shifts(x.device)) & 1
    return bits.flatten(-2).movedim(-1, dim)


def packbits(bits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """uint8 bits (0/1) -> uint8 bytes along ``dim``; a ragged tail is
    padded with zero bits, as numpy does."""
    b = bits.movedim(dim, -1)
    pad = -b.shape[-1] % 8
    if pad:
        b = torch.cat([b, b.new_zeros(*b.shape[:-1], pad)], dim=-1)
    b = b.unflatten(-1, (-1, 8)) << _msb_first_shifts(b.device)
    # the eight shifted bits are disjoint, so their sum is their OR
    return b.sum(-1, dtype=torch.uint8).movedim(-1, dim)


def gf2_matmul(bits: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """(M, K) uint8 bits times a (K, N) float32 0/1 matrix over GF(2) ->
    (M, N) uint8 bits.

    The product runs in float32 (CUDA has no int8 x int8 -> int32
    ``matmul``).  It is exact: every partial sum is an integer of at most
    K <= 53840 < 2**24, and 0/1 operands lose nothing even in TF32."""
    acc = torch.matmul(bits.to(torch.float32), matrix)
    return (acc.to(torch.int32) & 1).to(torch.uint8)
