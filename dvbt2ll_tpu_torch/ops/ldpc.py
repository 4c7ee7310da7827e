"""QC-LDPC encoding: the CUDA kernel (``csrc/ldpc_parity.cu``), which
writes the whole codeword, and its plain torch twin.

The kernel replaces the Pallas TPU kernel
``dvbt2ll_tpu/ops/ldpc_pallas.py`` (``_make_kernel`` :33 and the
row-grouped ``_make_grouped_kernel`` :84) and the concat of info bits and
parity after it: one kernel covers every Annex-A table.  The parity twin
is the XLA slice schedule of ``dvbt2ll_tpu/pipeline.py:210-232`` in
torch.  See the kernel source for the math, what bounds it on the card
and what its design does about it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

ROWS = 360  # rows of the quasi-cyclic accumulator


@dataclasses.dataclass(frozen=True, eq=False)
class LdpcSchedule:
    """One Annex-A table's encoder schedule (``tables/ldpc.qc_entries``):
    per accumulator column c, the (info group, roll) entries that XOR into
    it.  ``cols`` drives the plain twin; the same entries as CSR int32
    tensors (``col_ptr[q + 1]``, ``grp[E]``, ``shift[E]``) on the device
    drive the kernel."""

    cols: tuple
    nbch: int
    plen: int
    q: int
    col_ptr: torch.Tensor
    grp: torch.Tensor
    shift: torch.Tensor


def ldpc_schedule(cols, nbch: int, plen: int, q: int,
                  device) -> LdpcSchedule:
    cols = tuple(tuple((int(r), int(s)) for r, s in col) for col in cols)
    if (len(cols) != q or plen != ROWS * q or nbch % ROWS
            or any(not (0 <= r < nbch // ROWS and 0 <= s < ROWS)
                   for col in cols for r, s in col)):
        raise ValueError(f"schedule does not fit nbch={nbch} plen={plen} "
                         f"q={q}")
    entries = np.array([e for col in cols for e in col],
                       np.int32).reshape(-1, 2)
    col_ptr = np.cumsum([0] + [len(col) for col in cols]).astype(np.int32)

    def dev(a):
        return torch.tensor(a, dtype=torch.int32, device=device)

    return LdpcSchedule(cols, nbch, plen, q, dev(col_ptr),
                        dev(entries[:, 0]), dev(entries[:, 1]))


def qc_ldpc_parity_plain(sched: LdpcSchedule,
                         nbch_bits: torch.Tensor) -> torch.Tensor:
    """(F, nbch) uint8 bits -> (F, plen) uint8 LDPC parity, in torch ops
    on any device: rolls as slices of a doubled copy, XOR prefixes as
    ``cumsum & 1``."""
    f = nbch_bits.shape[0]
    g = nbch_bits.reshape(f, sched.nbch // ROWS, ROWS)
    g2 = torch.cat([g, g], dim=2)
    cols = []
    for entries in sched.cols:
        acc = torch.zeros((f, ROWS), dtype=torch.uint8,
                          device=nbch_bits.device)
        for r, s in entries:  # roll by s: acc[m] ^= g[r, (m - s) % 360]
            acc ^= g2[:, r, ROWS - s:2 * ROWS - s]
        cols.append(acc)
    incl = torch.cumsum(torch.stack(cols, dim=2), dim=2,
                        dtype=torch.int32) & 1                # (F, 360, q)
    row_inc = torch.cumsum(incl[:, :, -1], dim=1) & 1
    row_excl = torch.cat([torch.zeros_like(row_inc[:, :1]),
                          row_inc[:, :-1]], dim=1)
    par = incl ^ row_excl[:, :, None]
    return par.to(torch.uint8).reshape(f, sched.plen)


def ldpc_codeword_plain(sched: LdpcSchedule,
                        nbch_bits: torch.Tensor) -> torch.Tensor:
    """(F, nbch) uint8 bits -> (F, nbch + plen) uint8 codewords: the info
    bits, then ``qc_ldpc_parity_plain``'s parity."""
    return torch.cat([nbch_bits, qc_ldpc_parity_plain(sched, nbch_bits)],
                     dim=1)


def ldpc_codeword(sched: LdpcSchedule,
                  nbch_bits: torch.Tensor) -> torch.Tensor:
    """(F, nbch) uint8 bits (0/1) -> (F, nbch + plen) uint8 LDPC
    codewords: the info bits passed through, then the parity.

    A CPU tensor goes through the plain twin.  A CUDA tensor launches
    the kernel, or raises: there is no fallback.
    ``ldpc_codeword.launches`` counts kernel launches (under a CUDA graph,
    ``compiled.CompiledStep`` counts the replays' launches)."""
    if (nbch_bits.dtype != torch.uint8 or nbch_bits.dim() != 2
            or nbch_bits.shape[1] != sched.nbch):
        raise ValueError(f"expected (F, {sched.nbch}) uint8 bits, got "
                         f"{tuple(nbch_bits.shape)} {nbch_bits.dtype}")
    dev = nbch_bits.device
    if dev.type == "cpu":
        return ldpc_codeword_plain(sched, nbch_bits)
    if dev.type != "cuda":
        raise ValueError(f"no LDPC kernel for device {dev}")
    if not nbch_bits.is_contiguous() or nbch_bits.data_ptr() % 8:
        raise ValueError("nbch_bits must be contiguous and 8-byte aligned")
    if sched.col_ptr.device != dev:
        raise ValueError(f"schedule on {sched.col_ptr.device}, bits on {dev}")
    f = nbch_bits.shape[0]
    out = torch.empty((f, sched.nbch + sched.plen), dtype=torch.uint8,
                      device=dev)
    if f == 0:
        return out
    from . import _build

    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.dvbt2ll_ldpc_codeword(
            nbch_bits.data_ptr(), out.data_ptr(), sched.col_ptr.data_ptr(),
            sched.grp.data_ptr(), sched.shift.data_ptr(), f, sched.nbch,
            sched.q, sched.grp.numel(), torch.cuda.current_device(), stream)
    _build.check(lib, code, "ldpc_codeword launch")
    ldpc_codeword.launches += 1
    return out


ldpc_codeword.launches = 0
