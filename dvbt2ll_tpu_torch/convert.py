"""From a host plan to device tensors.

A transmitter has no weights: its state is the plan's constant tables
plus the stream carries.  ``plan_tensors`` uploads any ``TransmitPlan``'s
numpy constants once, whether the port built the plan or
``dvbt2ll_tpu.plan.build_plan`` did; the carries of a JAX checkpoint are
numpy and load unchanged (``Transmitter.load_state``).  The tables are
the JAX package's ``_plp_consts``/``_consts``/``_planar_consts``, which it
bakes into the compiled step instead.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .ops.fec import BbBch, bb_bch_tables
from .ops.ifft import N1, TailTables, tail_tables
from .ops.ldpc import LdpcSchedule, ldpc_schedule
from .ops.qam import QamMap, qam_tables


@dataclasses.dataclass
class PlpTensors:
    """One PLP's device constants, beside its host ``PlpPlan``."""

    pp: object                      # host PlpPlan
    # BB framing, CRC-8, scrambling and BCH (ops/fec.py): the kernel's
    # tables, and the twin's GF(2) matrices on a CPU device only
    fec: BbBch
    ldpc: LdpcSchedule
    # bit interleave and QAM mapping (ops/qam.py): the kernel's u16 bit
    # indices, and the twin's int64 ones on a CPU device only
    qam: QamMap


@dataclasses.dataclass
class PlanarTail:
    """The planar step's frame and tail constants (re/im planes)."""

    l1pre_re: torch.Tensor          # (1840,) f32
    l1pre_im: torch.Tensor
    l1post_re: torch.Tensor         # (t2_frames, l1post cells) f32
    l1post_im: torch.Tensor
    dummy_re: torch.Tensor          # (dummy cells,) f32
    dummy_im: torch.Tensor
    p1_iq: torch.Tensor             # (2048, 2) f32, interleaved
    grid_t: torch.Tensor            # (S, N2, N1) i64 gather into seq
    pilot_t: torch.Tensor           # (S, N2, N1) f32
    eq_t: Optional[torch.Tensor]    # (1, N2, N1) f32 inverse sinc, or None
    ifft: TailTables                # tail_tables(fft, scale)


@dataclasses.dataclass
class ComplexTail:
    """The complex step's frame and tail constants (``_consts``)."""

    l1pre: torch.Tensor             # (1840,) c64
    l1post: torch.Tensor            # (t2_frames, l1post cells) c64
    dummy: torch.Tensor             # (dummy cells,) c64
    p1: torch.Tensor                # (2048,) c64
    grid: torch.Tensor              # (S, fft) i64 gather into seq
    pilot: torch.Tensor             # (S, fft) f32
    eq: Optional[torch.Tensor]      # (fft,) f32 inverse sinc, or None


@dataclasses.dataclass
class PlanTensors:
    """A plan's device constants: per PLP, those of one OFDM tail, and the
    step's frame offsets, to which the frame builder adds the step's first
    T2 frame index (an int, or a 0-d int64 tensor on the device)."""

    plan: object                    # host TransmitPlan
    plps: list                      # [PlpTensors]
    tail: object                    # PlanarTail or ComplexTail
    frame_offsets: torch.Tensor     # (B,) i64, 0 .. batch_frames - 1


def _t(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


def _plp_tensors(pp, device) -> PlpTensors:
    cfg = pp.cfg
    return PlpTensors(
        pp=pp,
        fec=bb_bch_tables(pp, device),
        ldpc=ldpc_schedule(pp.ldpc_cols, cfg.nbch, cfg.ldpc_parity_bits,
                           cfg.q_ldpc, device),
        qam=qam_tables(pp, device),
    )


def _seq_gather(plan) -> np.ndarray:
    """``grid_src`` (S, fft) with every pilot/null position (-1) sent to
    the trailing zero cell of the frame builder's cell sequence."""
    cfg = plan.cfg
    seq_len = (np.size(plan.l1pre) + np.shape(plan.l1post_all)[1]
               + sum(pp.cfg.stream_cells for pp in plan.plps)
               + np.size(plan.dummy) + cfg.n_fc - cfg.c_fc + 1)
    src = np.asarray(plan.grid_src)
    return np.where(src >= 0, src, seq_len - 1)


def _planar_tail(plan, device) -> PlanarTail:
    cfg = plan.cfg
    fft = cfg.fft_points
    n2 = fft // N1
    # natural (S, fft) -> transposed (S, n2, N1): [s, k2, k1] = bin n2*k1+k2
    tidx = n2 * np.arange(N1)[None, :] + np.arange(n2)[:, None]
    l1pre = np.asarray(plan.l1pre, np.complex64)
    l1post = np.asarray(plan.l1post_all, np.complex64)
    dummy = np.asarray(plan.dummy, np.complex64)
    p1 = np.asarray(plan.p1, np.complex64)
    eq_t = None
    if plan.eq is not None:
        eq = np.broadcast_to(np.asarray(plan.eq, np.float32), (1, fft))
        eq_t = _t(eq[:, tidx], np.float32, device)
    return PlanarTail(
        l1pre_re=_t(l1pre.real, np.float32, device),
        l1pre_im=_t(l1pre.imag, np.float32, device),
        l1post_re=_t(l1post.real, np.float32, device),
        l1post_im=_t(l1post.imag, np.float32, device),
        dummy_re=_t(dummy.real, np.float32, device),
        dummy_im=_t(dummy.imag, np.float32, device),
        p1_iq=_t(np.stack([p1.real, p1.imag], axis=-1), np.float32,
                 device),
        grid_t=_t(_seq_gather(plan)[:, tidx], np.int64, device),
        pilot_t=_t(np.asarray(plan.pilot_plane)[:, tidx], np.float32,
                   device),
        eq_t=eq_t,
        # 1/N of the inverse transform times the chain's N * ofdm_norm
        ifft=tail_tables(fft, cfg.ofdm_normalization, device),
    )


def _complex_tail(plan, device) -> ComplexTail:
    return ComplexTail(
        l1pre=_t(plan.l1pre, np.complex64, device),
        l1post=_t(plan.l1post_all, np.complex64, device),
        dummy=_t(plan.dummy, np.complex64, device),
        p1=_t(plan.p1, np.complex64, device),
        grid=_t(_seq_gather(plan), np.int64, device),
        pilot=_t(plan.pilot_plane, np.float32, device),
        eq=None if plan.eq is None else _t(plan.eq, np.float32, device),
    )


def plan_tensors(plan, device, planar: bool) -> PlanTensors:
    """Upload a plan's constants to ``device``: the per-PLP tables, and
    the frame and tail constants of the planar step (``planar``) or of
    the complex one, never both.  ``pipeline.select_step_iq`` says which
    step a config runs."""
    return PlanTensors(
        plan=plan,
        plps=[_plp_tensors(pp, device) for pp in plan.plps],
        tail=(_planar_tail if planar else _complex_tail)(plan, device),
        frame_offsets=torch.arange(plan.batch_frames, dtype=torch.int64,
                                   device=device),
    )
