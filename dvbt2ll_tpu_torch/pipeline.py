"""The DVB-T2 transmit chain on torch tensors: TS bytes -> baseband IQ.

The counterpart of ``dvbt2ll_tpu/pipeline.py``, function for function.
PyTorch runs eagerly: each function is the JAX one's body with torch ops,
and the plan's constants come as device tensors that
``convert.plan_tensors`` uploads once (the JAX package bakes them into
its compiled step instead).  Two OFDM tails, chosen by ``select_step_iq``:
the planar one (1K-8K FFTs with a guard interval of whole 128-sample
rows) and the complex one (``torch.fft``, every other geometry: 16K, 32K
and odd guard intervals).  On a CUDA tensor the BB framing with BCH,
the LDPC parity, the mapper and the planar tail run the hand-written
kernels of ``ops/fec.py``, ``ops/ldpc.py``, ``ops/qam.py`` and
``ops/ifft.py``; a CPU tensor takes their plain twins.  ``Transmitter``
runs its step through ``compiled.CompiledStep`` as its one block: on a
CUDA device a captured CUDA graph replayed every step, the counterpart of
the JAX step's ``jax.jit``.

The step functions take one window a PLP, (187 + fresh,) uint8, and an
int or 0-d frame index, and return (B, samples, 2); or a (blocks, 187 +
fresh) stack of windows a PLP and a (blocks,) frame index, and return
(blocks, B, samples, 2), row i bit-identical to the call on row i: the
counterpart of ``jax.vmap`` over the JAX step in the mesh's
``shard_fn``.  Inside, every block's frames are one batch of blocks * B
frames, so each kernel launches once a PLP for all of them.

While the port's tracing is on, the step functions put a device stage
mark (``observability.mark``) at their entry (``start``), after each
PLP's ``bb_and_fec`` (``fec``) and mapper (``map``), after the frame
grids (``frames``), on the complex tail after its transform (``ifft``),
and after the OFDM tail (``tail``); a step captured with tracing off
holds none.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .compiled import CompiledStep
from .config import T2Config
from .convert import PlanTensors, PlpTensors, plan_tensors
from .observability import TxCounters, check_ts_sync, mark, span
from .ops.fec import bb_bch
from .ops.ifft import fft_tail, ifft_gi, set_full_fp32_matmul, supported
from .ops.ldpc import ldpc_codeword
from .ops.qam import qam_map
from .plan import build_plan, min_batch_frames


def bb_and_fec(pt: PlpTensors, ts_padded: torch.Tensor) -> torch.Tensor:
    """TS bytes -> LDPC frame bits (blocks * F, frame_bits) u8.

    ``ts_padded`` is one window (187 carry + fresh,) or a (blocks, 187 +
    fresh) stack of them, one a block (the rows of the JAX step's
    ``jax.vmap``); a window is one block.  The blocks' FEC frames come out
    block by block, as one batch for the LDPC kernel.  Two calls, each a
    hand-written kernel on the card and its plain twin on the CPU:
    ``ops.fec.bb_bch`` (BB framing, NORMAL mode's packet CRC-8 in place of
    each sync byte, HIEFF's sync bytes dropped, the in-band field,
    scrambling and BCH) writes each frame's nbch info bits and parity, and
    ``ops.ldpc.ldpc_codeword`` the codeword after them.  Only the twin
    reads ``pt.fec``'s GF(2) matrices, which a CPU device alone holds."""
    ts = ts_padded.reshape(-1, ts_padded.shape[-1])    # (blocks, 187 + fresh)
    return ldpc_codeword(pt.ldpc, bb_bch(pt.fec, ts))


def map_cells_planes(pt: PlpTensors, frame_bits: torch.Tensor):
    """LDPC frames -> constellation cell planes ((F, cell), (F, cell)) f32:
    the bit interleave, the Gray-coded square QAM, rotation and the cyclic
    Q delay of one cell within each frame's row (``ops.qam.qam_map``, the
    kernel on the card, its plain twin on the CPU).  F counts every LDPC
    frame of the call, all blocks' (``bb_and_fec``)."""
    return qam_map(pt.qam, frame_bits, planar=True)


def map_cells(pt: PlpTensors, frame_bits: torch.Tensor) -> torch.Tensor:
    """LDPC frames -> constellation cells (F, cell_size) complex64, as
    ``map_cells_planes`` in one interleaved tensor."""
    return qam_map(pt.qam, frame_bits, planar=False)


def _as_windows(plan, ts_padded) -> List[torch.Tensor]:
    ws = (list(ts_padded) if isinstance(ts_padded, (list, tuple))
          else [ts_padded])
    if len(ws) != len(plan.plps):
        raise ValueError(f"{len(ws)} windows for {len(plan.plps)} PLPs")
    return ws


def block_view(ts_padded, out: torch.Tensor) -> torch.Tensor:
    """A step's output over the flat frame axis, (blocks * B, ...), as
    the caller's shape: (blocks, B, ...) when the windows ``ts_padded``
    (one a PLP) carry a leading block axis, as it is for one window.  A
    view, no copy: the counterpart of the ``jax.vmap`` output axis."""
    w = ts_padded[0] if isinstance(ts_padded, (list, tuple)) else ts_padded
    return out.unflatten(0, (w.shape[0], -1)) if w.dim() == 2 else out


def frame_index(tp: PlanTensors, frame_idx0) -> torch.Tensor:
    """(blocks * B,) int64 T2 frame index of each frame of the call, block
    by block: (frame_idx0[i] + 0 .. B - 1) mod t2_frames for block i.
    ``frame_idx0``, each block's first frame index, is an int or a 0-d
    int64 tensor for one window, a (blocks,) int64 tensor for a stack of
    windows, on the plan's device; ``compiled.CompiledStep`` passes a
    tensor, so that a captured step reads the index at every replay (the
    JAX step's traced ``jnp.int32(frame_idx)``)."""
    if torch.is_tensor(frame_idx0):
        frame_idx0 = frame_idx0.reshape(-1, 1)
    return ((frame_idx0 + tp.frame_offsets)
            % tp.plan.cfg.t2_frames).reshape(-1)


def frame_grids(tp: PlanTensors, ts_padded, frame_idx0):
    """Padded TS windows (one per PLP, each one window or a (blocks, ·)
    stack) -> the frame builder's transposed grids (blocks * B, S, N2,
    128) f32 re/im planes: FEC and mapping per PLP, then L1, payload and
    dummy cells gathered straight into the 4-step IFFT's layout, with
    pilots and the optional inverse sinc.  ``frame_idx0`` as in
    ``frame_index``."""
    cfg = tp.plan.cfg
    t = tp.tail

    res, ims = [], []
    for pt, w in zip(tp.plps, _as_windows(tp.plan, ts_padded)):
        bits = bb_and_fec(pt, w)
        mark("fec", bits)
        i_p, q_p = map_cells_planes(pt, bits)
        mark("map", i_p)
        res.append(i_p.reshape(-1, pt.pp.cfg.stream_cells))
        ims.append(q_p.reshape(-1, pt.pp.cfg.stream_cells))
    pay_re = torch.cat(res, dim=1)
    pay_im = torch.cat(ims, dim=1)

    idx = frame_index(tp, frame_idx0)
    b = pay_re.shape[0]                     # blocks * B frames
    zeros = pay_re.new_zeros(b, cfg.n_fc - cfg.c_fc + 1)
    seq_re = torch.cat([t.l1pre_re.expand(b, -1), t.l1post_re[idx],
                        pay_re, t.dummy_re.expand(b, -1), zeros], dim=1)
    seq_im = torch.cat([t.l1pre_im.expand(b, -1), t.l1post_im[idx],
                        pay_im, t.dummy_im.expand(b, -1), zeros], dim=1)

    g_re = seq_re[:, t.grid_t] + t.pilot_t                  # (B, S, n2, N1)
    g_im = seq_im[:, t.grid_t]
    if t.eq_t is not None:
        g_re = g_re * t.eq_t
        g_im = g_im * t.eq_t
    mark("frames", g_re)
    return g_re, g_im


def ofdm_tail(tp: PlanTensors, g_re: torch.Tensor,
              g_im: torch.Tensor) -> torch.Tensor:
    """Transposed grids -> (B, samples, 2) f32 I/Q: P1, then the 4-step
    IFFT with its guard interval, in one call (``ops/ifft.py::ifft_gi``)
    over every frame of the grids, all blocks' at once."""
    cfg = tp.plan.cfg
    t = tp.tail
    return ifft_gi(g_re, g_im, t.p1_iq, cfg.fft_points, cfg.guard_samples,
                   cfg.ofdm_normalization, t.ifft)


def transmit_step_iq_planar(tp: PlanTensors, ts_padded,
                            frame_idx0) -> torch.Tensor:
    """Padded TS windows (one per PLP) -> (B, samples, 2) f32 I/Q, or
    (blocks, B, samples, 2) for (blocks, ·) windows and a (blocks,) frame
    index: the counterpart of the JAX step under ``jax.vmap``, whose
    blocks' frames are one batch (each kernel launches once), row i
    bit-identical to the call on window row i alone.

    Cells, frame grids and the OFDM tail stay separate re/im planes.  The
    frame builder's one gather lands straight in the 4-step IFFT's
    transposed (S, N2, 128) layout, so the tail's rows come out in sample
    order and the guard interval is a row copy (ops/ifft.py)."""
    mark("start", _as_windows(tp.plan, ts_padded)[0])
    out = ofdm_tail(tp, *frame_grids(tp, ts_padded, frame_idx0))
    mark("tail", out)
    return block_view(ts_padded, out)


def build_frames(tp: PlanTensors, payload: torch.Tensor,
                 frame_idx0) -> torch.Tensor:
    """Raw mapper cells (blocks * B, total_stream) c64 -> OFDM grids
    (blocks * B, S, fft) c64: L1, payload and dummy cells, then one gather
    over the natural ``grid_src`` (which composes the cell, time and
    frequency interleavers and the carrier map), then the pilot plane.
    ``frame_idx0`` as in ``frame_index``."""
    cfg = tp.plan.cfg
    t = tp.tail
    b = payload.shape[0]
    idx = frame_index(tp, frame_idx0)
    # one trailing zero cell absorbs every pilot/null position (-1)
    seq = torch.cat([t.l1pre.expand(b, -1), t.l1post[idx], payload,
                     t.dummy.expand(b, -1),
                     payload.new_zeros(b, cfg.n_fc - cfg.c_fc + 1)], dim=1)
    return seq[:, t.grid] + t.pilot


def symbols_with_gi(cfg: T2Config, grids: torch.Tensor,
                    eq: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, S, fft) grids -> (B, S, fft + gi) c64: the optional inverse
    sinc ``eq``, the IFFT scaled by fft * ofdm_normalization
    (``ops.ifft.fft_tail``, then the stage mark ``ifft``), and the guard
    interval as a copy of each symbol's last gi samples.  A slab of
    the symbol axis (``parallel.grids_symbol_sharded``) runs the same
    operations; whether its bits equal the whole's depends on the FFT
    library's plan for the batch (on the CPU, MKL splits one 32K
    transform over threads when the batch is smaller than the thread
    count, and its sums then differ)."""
    fft = cfg.fft_points
    gi = cfg.guard_samples
    if eq is not None:
        grids = grids * eq
    sym = fft_tail(grids, fft * cfg.ofdm_normalization)
    mark("ifft", sym)
    return torch.cat([sym[..., fft - gi:], sym], dim=-1)


def ofdm_symbols(tp: PlanTensors, grids: torch.Tensor) -> torch.Tensor:
    """(B, S, fft) grids -> (B, S * (fft + gi)) c64 OFDM symbols
    (``symbols_with_gi`` with the plan's inverse sinc)."""
    return symbols_with_gi(tp.plan.cfg, grids, tp.tail.eq).reshape(
        grids.shape[0], -1)


def modulate(tp: PlanTensors, grids: torch.Tensor) -> torch.Tensor:
    """(B, S, fft) grids -> (B, samples_per_frame) c64 IQ, after P1."""
    b = grids.shape[0]
    return torch.cat([tp.tail.p1.expand(b, -1), ofdm_symbols(tp, grids)],
                     dim=1)


def complex_grids(tp: PlanTensors, ts_padded,
                  frame_idx0) -> torch.Tensor:
    """Padded TS windows (one per PLP, each one window or a (blocks, ·)
    stack) -> (blocks * B, S, fft) c64 OFDM grids: FEC and the mapper per
    PLP, then the complex frame builder."""
    payloads = []
    for pt, w in zip(tp.plps, _as_windows(tp.plan, ts_padded)):
        bits = bb_and_fec(pt, w)
        mark("fec", bits)
        payloads.append(map_cells(pt, bits).reshape(
            -1, pt.pp.cfg.stream_cells))
        mark("map", payloads[-1])
    payload = (payloads[0] if len(payloads) == 1
               else torch.cat(payloads, dim=1))
    grids = build_frames(tp, payload, frame_idx0)
    mark("frames", grids)
    return grids


def transmit_step(tp: PlanTensors, ts_padded,
                  frame_idx0) -> torch.Tensor:
    """Padded TS windows (one per PLP) -> (B, samples) c64, or (blocks,
    B, samples) as in ``transmit_step_iq_planar``: FEC and the mapper per
    PLP, then the complex frame builder and tail, whose ``torch.fft``
    runs over every block's symbols at once."""
    mark("start", _as_windows(tp.plan, ts_padded)[0])
    out = modulate(tp, complex_grids(tp, ts_padded, frame_idx0))
    mark("tail", out)
    return block_view(ts_padded, out)


def transmit_step_iq(tp: PlanTensors, ts_padded,
                     frame_idx0) -> torch.Tensor:
    """Like ``transmit_step`` but (B, samples, 2) (or (blocks, B,
    samples, 2)) f32 I/Q: on either device complex64 is interleaved (re,
    im), so this is a view."""
    return torch.view_as_real(transmit_step(tp, ts_padded, frame_idx0))


def select_step_iq(cfg: T2Config):
    """The planar/complex tail decision, in one place: returns
    (step_fn, planar).  The planar tail where ``ops/ifft.py::supported``
    holds, the complex ``torch.fft`` tail everywhere else.  Every
    transmitter of the port takes its step, and ``plan_tensors`` its
    constants, from this choice."""
    planar = supported(cfg.fft_points, cfg.guard_samples)
    return (transmit_step_iq_planar if planar else transmit_step_iq), planar


class Transmitter:
    """Streaming DVB-T2 transmitter: feed TS bytes, get baseband IQ.

    Holds the cross-step state (the 187-byte carry window per PLP and the
    T2 frame counter) on the host, and the plan's constants and its
    compiled step (``compiled.CompiledStep``) on ``device``.  The eager
    step function stays callable as ``_step_fn(tensors, windows,
    frame_idx0)``.
    """

    def __init__(self, cfg: T2Config, batch_frames: Optional[int] = None,
                 strict: bool = True, validate_ts: bool = False, *, device,
                 allow_phase_drift: bool = False, start_phases=0):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} asked for, but "
                               f"torch.cuda.is_available() is False")
        self.cfg = cfg
        self._step_fn, planar = select_step_iq(cfg)
        # start_phases: TS byte phase at the step start (build_plan)
        plan = build_plan(cfg, batch_frames, strict=strict,
                          start_phases=start_phases)
        self.plan = plan
        set_full_fp32_matmul()
        self.tensors = plan_tensors(plan, self.device, planar)
        # the counterpart of the JAX step's jax.jit, one block, captured
        # here, once: every step is then a replay, the first included, and
        # a step's launch counts are its own (the warm-up's fall to
        # construction)
        self._compiled = CompiledStep(self._step_fn, self.tensors, plan,
                                      self.device)
        self._carries = [np.zeros(187, dtype=np.uint8) for _ in plan.plps]
        self._frame_idx = 0
        self._steps_done = 0
        self._phase_invariant = all(pp.bb.phase_invariant
                                    for pp in plan.plps)
        self._allow_phase_drift = allow_phase_drift
        self._validate_ts = validate_ts
        self.counters = TxCounters()

    @property
    def bytes_per_step(self) -> int:
        """Fresh TS bytes per step (first PLP; see bytes_per_step_per_plp)."""
        return self.plan.ts_bytes_in

    @property
    def bytes_per_step_per_plp(self) -> tuple:
        return self.plan.ts_bytes_per_plp

    def _check_streamable(self) -> None:
        """Refuse a second step of a plan whose step payload is not a
        whole number of TS packets: it would start at a drifted packet
        phase and emit wrong BB headers and CRC positions.
        ``allow_phase_drift=True`` treats every step as an independent
        phase-0 stream instead (mechanism tests and throughput runs; the
        concatenated output is then not one valid DVB-T2 stream)."""
        if (self._steps_done and not self._phase_invariant
                and not self._allow_phase_drift):
            raise RuntimeError(
                f"this plan is single-shot: its step payload is not a "
                f"multiple of the TS packet length, so a second step would "
                f"start at a drifted packet phase and emit wrong BB "
                f"headers; build with strict=True or batch_frames="
                f"min_batch_frames(cfg) (= {min_batch_frames(self.cfg)}) "
                f"for streaming")

    def step_window(self, windows) -> torch.Tensor:
        """One step from pre-carried (187 + fresh) byte windows: a
        (187 + bytes_per_step,) uint8 array for one PLP, or a sequence of
        per-PLP windows.  Updates the carries, frame counter and counters
        like ``step_device``; with ``validate_ts`` each window's TS sync
        bytes are checked first and misses add to
        ``counters.sync_errors``.  The windows and the frame counter are
        staged into the compiled step, which runs (under tracing the span
        ``transmitter.step``, with ``transmitter.validate`` a PLP when
        validating).  Returns the f32 (B, samples, 2) I/Q tensor on the
        transmitter's device, which no later step writes."""
        ws = _as_windows(self.plan, windows)
        self._check_streamable()
        with span("transmitter.step"):
            ws = [np.asarray(w, dtype=np.uint8) for w in ws]
            for pp, w in zip(self.plan.plps, ws):
                if w.shape != (187 + pp.ts_bytes_in,):
                    raise ValueError(f"window of shape {w.shape}, expected "
                                     f"({187 + pp.ts_bytes_in},)")
                if self._validate_ts:
                    # a drifted per-phase plan starts mid-packet: its sync
                    # slots sit at the plan's start phase
                    with span("transmitter.validate"):
                        self.counters.sync_errors += check_ts_sync(
                            w[187:], phase=pp.bb.start_phase)
            out = self._compiled([w[None] for w in ws],
                                 [self._frame_idx])[0]
        self._carries = [w[-187:].copy() for w in ws]
        self._frame_idx = ((self._frame_idx + self.plan.batch_frames)
                           % self.cfg.t2_frames)
        self._steps_done += 1
        self.counters.record_step(
            self.plan.batch_frames, self.plan.samples_out,
            sum(w.size - 187 for w in ws))
        return out

    def step_device(self, ts_bytes) -> torch.Tensor:
        """One step of fresh TS bytes: (bytes_per_step,) uint8 for one
        PLP, or per-PLP arrays matching bytes_per_step_per_plp.  Returns
        the f32 (B, samples, 2) I/Q tensor on the device."""
        streams = (list(ts_bytes) if isinstance(ts_bytes, (list, tuple))
                   else [ts_bytes])
        if len(streams) != len(self.plan.plps):
            raise ValueError(f"{len(streams)} streams for "
                             f"{len(self.plan.plps)} PLPs")
        windows = []
        for carry, pp, ts in zip(self._carries, self.plan.plps, streams):
            ts = np.asarray(ts, dtype=np.uint8)
            if ts.shape != (pp.ts_bytes_in,):
                raise ValueError(f"TS of shape {ts.shape}, expected "
                                 f"({pp.ts_bytes_in},)")
            windows.append(np.concatenate([carry, ts]))
        return self.step_window(windows if len(windows) > 1 else windows[0])

    def __call__(self, ts_bytes) -> np.ndarray:
        """One step of fresh TS bytes -> complex64 (B, samples_per_frame)
        on the host."""
        iq = self.step_device(ts_bytes).cpu().numpy()
        return iq.reshape(iq.shape[0], -1).view(np.complex64)

    # ----------------------------------------------------- checkpoint/resume
    def state_dict(self) -> dict:
        """The complete cross-step state: the 187-byte carry window per
        PLP, the T2 frame counter and the step count.  The same keys and
        types as the JAX package's, so checkpoints move both ways."""
        return {
            "carries": np.stack(self._carries).copy(),
            "frame_idx": self._frame_idx,
            "steps_done": self._steps_done,
        }

    def load_state(self, state: dict) -> None:
        carries = np.asarray(state["carries"], dtype=np.uint8)
        if carries.shape != (len(self.plan.plps), 187):
            raise ValueError(f"carries of shape {carries.shape}, expected "
                             f"({len(self.plan.plps)}, 187)")
        self._carries = [carries[i].copy() for i in range(carries.shape[0])]
        self._frame_idx = int(state["frame_idx"]) % self.cfg.t2_frames
        # a checkpoint without a step count counts as taken after a step,
        # unless it is the untouched initial state
        if "steps_done" in state:
            self._steps_done = int(state["steps_done"])
        else:
            fresh = (self._frame_idx == 0
                     and all(not c.any() for c in self._carries))
            self._steps_done = 0 if fresh else 1

    def save(self, path: str) -> None:
        np.savez(path, **self.state_dict())

    def restore(self, path: str) -> None:
        with np.load(path) as z:
            self.load_state({k: z[k] for k in z.files})

    def stream(self, ts_bytes) -> np.ndarray:
        """Like __call__ but returns the flat emitted sample stream, with
        FEF parts after every fef_interval-th T2 frame (EN 302 755
        section 8.4; nothing is inserted when the config has no FEF)."""
        start = self._frame_idx  # global frame index before the step
        return self._with_fef(self(ts_bytes), start)

    def stream_window(self, windows) -> np.ndarray:
        """Like ``stream`` for ``step_window``'s pre-carried windows: the
        flat emitted host stream, FEF parts included."""
        start = self._frame_idx
        iq = self.step_window(windows).cpu().numpy()
        return self._with_fef(iq.reshape(iq.shape[0], -1).view(np.complex64),
                              start)

    def _with_fef(self, frames: np.ndarray, start: int) -> np.ndarray:
        cfg = self.cfg
        if not cfg.has_fef:
            return frames.reshape(-1)
        parts = []
        for i in range(frames.shape[0]):
            parts.append(frames[i])
            if (start + i) % cfg.fef_interval == cfg.fef_interval - 1:
                parts.append(self.plan.fef_part)
        return np.concatenate(parts)

