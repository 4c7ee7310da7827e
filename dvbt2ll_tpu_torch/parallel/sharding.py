"""Multi-device scale-out: the counterpart of
``dvbt2ll_tpu/parallel/sharding.py``.

The chain shards over a (mux, frame) grid of device slots:

  * ``mux``   - independent DVB-T2 channels (pure data parallelism)
  * ``frame`` - T2 frames of one channel; each shard gets a window of the
                TS stream with a 187-byte halo in front (the packet-CRC sync
                replacement looks back at most 187 bytes), so no shard
                needs another shard's data

Both axes are embarrassingly parallel through the whole chain.  The only
sequential state (TS byte phase, CRC-8 carry, T2 frame counter) is
resolved statically: the byte phase is static per plan, the CRC carry is
the halo, the frame counter is arithmetic on the step and shard index.
The JAX package proves "zero collectives" on its compiled program; here
the invariant is that each block's window goes from the host to its
slot's device, its step runs there, and its output stays there.  Host
gathers (``__call__``, ``stream``) come after the step.

A slot may repeat a device: sixteen slots of one card are sixteen blocks
on that card, which is how one card serves BASELINE config 5 (8+
independent channels).  All the blocks of one device are one
``compiled.CompiledStep``, one call of the step function on the blocks'
stacked windows (the counterpart of ``jax.vmap(one_mux)`` in the JAX
``shard_fn``: each kernel launches once a PLP a device), on a card one
CUDA graph: the counterpart of the JAX package's one
``jax.jit(_shard_map(...))`` program over the mesh, a program a card.  Under a
``torch.distributed`` process group the mesh spans every process, each
process runs only the blocks of the slots it owns, and the step still
calls no collective (the counterpart of ``_mesh_put`` under
``jax.process_count() > 1``).

``grids_symbol_sharded`` shards the symbol axis of one frame's OFDM
back-end instead, for 32K single-frame latency work, compiled as the JAX
package's ``jax.jit(fn)`` is.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..compiled import CompiledStep, Graph
from ..config import T2Config
from ..convert import plan_tensors
from ..observability import span
from ..ops.ifft import set_full_fp32_matmul
from ..pipeline import (block_view, complex_grids, select_step_iq,
                        symbols_with_gi)
from ..plan import TransmitPlan, build_plan


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceMesh:
    """A (mux, frame) grid of device slots.

    ``devices`` is a (mux, frame) object array of ``torch.device``; one
    device may fill many slots.  Under a ``torch.distributed`` process
    group the grid is global, and a slot that another process owns holds
    None."""

    devices: np.ndarray
    world: int = 1                  # processes the mesh spans

    @property
    def shape(self) -> dict:
        m, f = self.devices.shape
        return {"mux": m, "frame": f}

    def local_devices(self) -> list:
        """The distinct devices of this process's slots, in slot order."""
        return list(dict.fromkeys(d for d in self.devices.flat
                                  if d is not None))


def _slot_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {d} asked for, but "
                               f"torch.cuda.is_available() is False")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    return d


def cuda_devices() -> list:
    """Every visible CUDA card.  Raises when there is none: a missing card
    never becomes a CPU pool."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "False); pass the slots, e.g. ['cpu'] * 8")
    return [torch.device("cuda", i) for i in range(n)]


def _process() -> tuple:
    """(rank, world size) of the torch.distributed group, or (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(devices: Optional[Sequence] = None, mux: int = 1,
              frame: Optional[int] = None) -> DeviceMesh:
    """A (mux, frame) mesh over this process's device slots (default:
    every visible CUDA card, one slot each).  Slots may repeat a device:
    ``["cuda:0"] * 16`` is a 16-slot pool on one card.

    With an initialised ``torch.distributed`` process group the mesh
    spans every process: mux * frame = world size * len(devices), and
    rank r owns the r-th run of len(devices) slots in row-major order
    (the order of ``jax.devices()``).  Every process passes the same
    number of slots."""
    local = [_slot_device(d)
             for d in (cuda_devices() if devices is None else devices)]
    rank, world = _process()
    n = world * len(local)
    if frame is None:
        frame = n // mux if mux else 0
    if not local or mux * frame != n:
        raise ValueError(f"mux {mux} x frame {frame} != {world} "
                         f"process(es) x {len(local)} slots")
    flat = np.empty(n, dtype=object)
    for i, d in enumerate(local):
        flat[rank * len(local) + i] = d
    return DeviceMesh(flat.reshape(mux, frame), world)


def halo_windows(ts_streams: np.ndarray, carries: np.ndarray,
                 n_shards: int) -> np.ndarray:
    """Split (C, bytes) fresh TS streams into overlapping per-shard windows.

    Returns (C, n_shards, 187 + bytes/n_shards) uint8.  carries is the
    (C, 187) tail from the previous step.
    """
    c, total = ts_streams.shape
    per = total // n_shards
    assert per * n_shards == total
    out = np.empty((c, n_shards, 187 + per), dtype=np.uint8)
    for i in range(c):
        for s in range(n_shards):
            _write_window(out[i, s], carries[i], ts_streams[i], s * per)
    return out


def _write_window(dst: np.ndarray, carry: np.ndarray, stream: np.ndarray,
                  start: int) -> None:
    """One window of ``halo_windows``, written in place: ``dst`` = (carry
    ++ stream)[start:start + len(dst)], the window of the shard whose
    fresh bytes start ``start`` bytes into the step.  The sharded step
    writes each block's straight into its pinned staging row."""
    k = max(0, 187 - start)          # bytes that come from the carry
    dst[:k] = carry[start:start + k]
    dst[k:] = stream[start + k - 187:start + len(dst) - 187]


class ShardedTransmitter:
    """N independent DVB-T2 muxes, frames sharded over a device mesh.

    Each slot's (mux-slice, frame-slice) blocks run the single-chain step
    (``pipeline.select_step_iq``) on its own device.  The blocks of one
    device, in slot order, are one ``compiled.CompiledStep``: one call
    of the step over their stacked windows (on a card one captured
    graph); no block's data moves to another device inside the step.
    """

    def __init__(self, cfg: T2Config, mesh: DeviceMesh, n_mux: int = 1,
                 frames_per_shard: Optional[int] = None,
                 strict: bool = True, allow_phase_drift: bool = False):
        self.cfg = cfg
        self.mesh = mesh
        self.n_mux = n_mux
        mux_shards = mesh.shape["mux"]
        frame_shards = mesh.shape["frame"]
        if n_mux % mux_shards:
            raise ValueError("n_mux must divide over the mux axis")
        # each shard runs an independent plan instance of this many frames
        self.plan = build_plan(cfg, frames_per_shard, strict=strict)
        self._allow_phase_drift = allow_phase_drift
        self._phase_invariant = all(pp.bb.phase_invariant
                                    for pp in self.plan.plps)
        if (frame_shards > 1 and not allow_phase_drift
                and not self._phase_invariant):
            # shard s>0's halo window starts s*per bytes into the stream;
            # unless per is a whole number of TS packets, that shard's
            # static phase-0 plan mislabels sync/CRC slots on the VERY
            # FIRST step - refuse rather than emit an invalid stream
            raise ValueError(
                "frame sharding needs a phase-invariant per-shard plan "
                "(per-shard TS payload a multiple of 188); use "
                "frames_per_shard=min_batch_frames(cfg), or pass "
                "allow_phase_drift=True to treat every shard window as an "
                "independent phase-0 stream (NOT a valid continuous "
                "DVB-T2 stream)")
        # the same tail as the single-chain Transmitter: sharded ==
        # sequential holds bit for bit at equal per-call shapes
        self._step_fn, planar = select_step_iq(cfg)
        set_full_fp32_matmul()
        # the plan's constants once per distinct device, not per slot
        self.tensors = {d: plan_tensors(self.plan, d, planar)
                        for d in mesh.local_devices()}
        self.frame_shards = frame_shards
        self.mux_per_shard = n_mux // mux_shards
        # the blocks (c, f), one mux's share of a slot, of each device in
        # slot order, and one compiled step a device over its blocks, each
        # block's frame index a device input: the counterpart of the JAX
        # package's jax.jit(_shard_map(...)), one program a card
        self._blocks = {}
        for (m, f), dev in np.ndenumerate(mesh.devices):
            if dev is None:
                continue  # another process's slot
            self._blocks.setdefault(dev, []).extend(
                (c, f) for c in range(m * self.mux_per_shard,
                                      (m + 1) * self.mux_per_shard))
        self._steps = {dev: CompiledStep(self._step_fn, self.tensors[dev],
                                         self.plan, dev, len(blocks))
                       for dev, blocks in self._blocks.items()}
        self.frames_per_step = self.plan.batch_frames * frame_shards
        n_plp = len(self.plan.plps)
        self._carries = np.zeros((n_mux, n_plp, 187), dtype=np.uint8)
        self._step_no = 0

    def step_device(self, ts_bytes) -> list:
        """ts_bytes: (n_mux, bytes_per_step_per_mux) fresh bytes per mux
        for a single-PLP chain, or a sequence of such arrays (one per PLP,
        sized n_mux x bytes_per_step_per_mux_per_plp[i]).

        Every block's halo window and frame index is written into its
        row of its device's pinned staging and sent with one copy a PLP
        a device, then each device's step is one replay, before any result
        is read (under tracing the span ``mesh.step``: a card's
        ``compiled.wait``, ``mesh.stage``, the writing of its rows, and
        ``compiled.upload``, then each card's ``compiled.launch``).
        Returns ``out[c][s]``, for mux c and frame shard s, the
        f32 (B_local, samples, 2) I/Q tensor on that block's device (row
        j of its device's (blocks, B_local, samples, 2) output, as the
        JAX ``shard_fn`` hands out its ``vmap``'s rows), or None where
        another process owns the slot."""
        cfg = self.cfg
        if (self._step_no and not self._allow_phase_drift
                and not self._phase_invariant):
            raise RuntimeError(
                "this plan is single-shot: its per-shard step payload is "
                "not a multiple of the TS packet length, so a second step "
                "would start at a drifted packet phase; build with "
                "frames_per_shard=min_batch_frames(cfg) for streaming, or "
                "pass allow_phase_drift=True for mechanism tests/benches")
        streams = [np.asarray(s, dtype=np.uint8) for s in (
            ts_bytes if isinstance(ts_bytes, (list, tuple)) else [ts_bytes])]
        if len(streams) != len(self.plan.plps):
            raise ValueError(f"{len(streams)} streams for "
                             f"{len(self.plan.plps)} PLPs")
        for s, want in zip(streams, self.bytes_per_step_per_mux_per_plp):
            if s.shape != (self.n_mux, want):
                raise ValueError(f"TS of shape {s.shape}, expected "
                                 f"({self.n_mux}, {want})")
        # T2 frame index of the first frame of each shard; keep the step
        # counter bounded (only its value mod t2_frames matters)
        self._step_no %= cfg.t2_frames
        base = self._step_no * self.frames_per_step
        fidx = (base + np.arange(self.frame_shards) * self.plan.batch_frames
                ) % cfg.t2_frames
        with span("mesh.step", self._step_no):
            self._step_no += 1
            # the halo windows go straight into the pinned rows; every
            # device is staged before any device runs, so no staging waits
            # for another device's step
            per = [s.shape[1] // self.frame_shards for s in streams]
            for dev, step in self._steps.items():
                rows, idx = step.host_inputs()
                with span("mesh.stage"):
                    for j, (c, f) in enumerate(self._blocks[dev]):
                        idx[j] = fidx[f]
                        for i, s in enumerate(streams):
                            _write_window(rows[i][j], self._carries[c, i],
                                          s[c], f * per[i])
                step.upload()
            for i, s in enumerate(streams):
                self._carries[:, i] = s[:, -187:]
            out = [[None] * self.frame_shards for _ in range(self.n_mux)]
            for dev, step in self._steps.items():
                stacked = step.replay()
                for j, (c, f) in enumerate(self._blocks[dev]):
                    out[c][f] = stacked[j]
        return out

    def _require_whole_mesh(self) -> None:
        if self.mesh.world > 1:
            raise RuntimeError(
                f"this process owns only part of a mesh over "
                f"{self.mesh.world} processes; use step_device and gather "
                f"the shards outside the step")

    def gather(self, out: list) -> np.ndarray:
        """``step_device``'s blocks -> complex64 (n_mux, frames_per_step,
        samples_per_frame) on the host, after the step: one
        device-to-host copy a device."""
        self._require_whole_mesh()
        iq = None
        for dev, blocks in self._blocks.items():
            host = torch.stack([out[c][f] for c, f in blocks]).cpu().numpy()
            if iq is None:
                iq = np.empty((self.n_mux, self.frame_shards)
                              + host.shape[1:], host.dtype)
            for j, (c, f) in enumerate(blocks):
                iq[c, f] = host[j]
        return iq.reshape(self.n_mux, self.frames_per_step,
                          -1).view(np.complex64)

    def __call__(self, ts_bytes) -> np.ndarray:
        """Returns complex64 (n_mux, frames_per_step, samples_per_frame)."""
        self._require_whole_mesh()  # before the state advances
        return self.gather(self.step_device(ts_bytes))

    def stream(self, ts_bytes) -> np.ndarray:
        """Like __call__ but returns the flat (n_mux, samples) emitted
        stream with FEF parts inserted after every fef_interval-th T2 frame
        (EN 302 755 section 8.4; no-op when the config has no FEF).  The
        frame counter is bounded mod t2_frames, which preserves the FEF
        cadence because fef_interval divides t2_frames (validated)."""
        start = (self._step_no % self.cfg.t2_frames) * self.frames_per_step
        frames = self(ts_bytes)
        if not self.cfg.has_fef:
            return frames.reshape(frames.shape[0], -1)
        iv = self.cfg.fef_interval
        out = []
        for c in range(frames.shape[0]):
            parts = []
            for i in range(frames.shape[1]):
                parts.append(frames[c, i])
                if (start + i) % iv == iv - 1:
                    parts.append(self.plan.fef_part)
            out.append(np.concatenate(parts))
        return np.stack(out)

    @property
    def bytes_per_step_per_mux(self) -> int:
        return self.plan.ts_bytes_in * self.frame_shards

    @property
    def bytes_per_step_per_mux_per_plp(self) -> tuple:
        return tuple(pp.ts_bytes_in * self.frame_shards
                     for pp in self.plan.plps)

    # ----------------------------------------------------- checkpoint/resume
    def state_dict(self) -> dict:
        """Cross-step state: the per-mux/per-PLP TS carry windows and the
        step counter (the T2 frame index is derived from it), plus the
        config as ``T2Config.to_json()`` under ``cfg``.  The JAX
        ``ShardedTransmitter``'s keys and shapes, so checkpoints move
        between the packages: its ``load_state`` reads only ``carries``
        and ``step_no``."""
        return {"carries": self._carries.copy(), "step_no": self._step_no,
                "cfg": self.cfg.to_json()}

    def check_state(self, state: dict) -> None:
        """Raise ValueError if ``state`` is not a checkpoint of this
        transmitter: carries of another shape, a ``cfg`` key holding
        another config, or a step count that is not an integer.  A
        checkpoint without ``cfg`` (the JAX package's) is checked on the
        rest.  Changes nothing."""
        carries = np.asarray(state["carries"])
        if carries.shape != self._carries.shape:
            raise ValueError(f"carries of shape {carries.shape}, expected "
                             f"{self._carries.shape}")
        if "cfg" in state:
            saved = T2Config.from_json(str(np.asarray(state["cfg"])))
            if saved != self.cfg:
                differ = [f.name for f in dataclasses.fields(T2Config)
                          if getattr(saved, f.name) != getattr(self.cfg,
                                                               f.name)]
                raise ValueError(f"checkpoint of another config (fields "
                                 f"{differ} differ)")
        step_no = np.asarray(state["step_no"])
        if step_no.shape or step_no.dtype.kind not in "iu":
            raise ValueError(f"step_no {state['step_no']!r} is not an "
                             f"integer")

    def load_state(self, state: dict) -> None:
        """Load a checkpoint after ``check_state``: a refused one changes
        nothing."""
        self.check_state(state)
        self._carries = np.asarray(state["carries"], dtype=np.uint8).copy()
        self._step_no = int(state["step_no"])

    def save(self, path: str) -> None:
        """File-checkpoint helpers mirroring Transmitter.save/restore
        (the two FORMATS differ: sharded carries are (mux, plp, 187))."""
        np.savez(path, **self.state_dict())

    def restore(self, path: str) -> None:
        with np.load(path) as z:
            self.load_state({k: z[k] for k in z.files})


def grids_symbol_sharded(plan: TransmitPlan, mesh: DeviceMesh,
                         axis: str = "frame") -> "SymbolShardedStep":
    """Sequence-parallel OFDM back-end: shard one step's (B, S, fft) grids
    over the symbol axis for the IFFT and guard interval, for very large
    FFT sizes where a single frame's IFFTs dominate latency.

    Returns ``fn(ts_padded, frame_idx0)`` -> (B, samples, 2) f32 on the
    first slot's device, the contract of ``pipeline.transmit_step_iq``,
    compiled as the JAX package's ``jax.jit(fn)`` is
    (``SymbolShardedStep``).  FEC, the mapper and the frame builder run
    on the first slot's device; the symbol axis is zero-padded to the
    shard count and each slot of ``axis`` runs inverse sinc, IFFT, scale
    and guard interval on its contiguous slab; the slabs come back to the
    first device, are cut to S, and P1 and the I/Q planes follow.  That
    copy back is this function's own gather, outside the collective-free
    step."""
    slots = list(mesh.devices[0, :] if axis == "frame"
                 else mesh.devices[:, 0])
    if any(d is None for d in slots):
        raise ValueError(f"symbol sharding needs every slot of the {axis} "
                         f"axis in this process")
    return SymbolShardedStep(plan, slots)


class SymbolShardedStep:
    """``grids_symbol_sharded``'s callable over ``slots``.

    When every slot is on one device, the call is one
    ``compiled.CompiledStep`` of one block: on a card one CUDA graph, on
    the CPU the eager computation on its static inputs.  When the slots
    span cards, it is one CUDA graph a card segment: the front on the
    first card (FEC, mapper, frame builder, padding, and the first card's
    slabs), then each other card's slabs, then the back on the first card
    (the slabs cut to S, P1, the I/Q planes).  The slabs move between the
    segments by peer copies, which PyTorch orders with events on both
    cards' current streams; the host waits for nothing inside a call, and
    no capture holds a peer copy.  ``eager`` is the same computation op
    by op.  ``graphs`` lists the captured graphs (none on the CPU),
    ``capture_s`` and ``pool_bytes`` their sums."""

    def __init__(self, plan: TransmitPlan, slots: list):
        self.cfg = plan.cfg
        self.slots = slots
        self.dev0 = dev0 = slots[0]
        self.tp = plan_tensors(plan, dev0, planar=False)
        self._eq = {d: None if self.tp.tail.eq is None
                    else self.tp.tail.eq.to(d)
                    for d in dict.fromkeys(slots)}
        cards = list(dict.fromkeys(slots))
        if len(cards) == 1:
            self._step = CompiledStep(
                lambda tp, ws, fi: self.eager(ws, fi), self.tp, plan, dev0)
            self.graphs = ([] if self._step._graph is None
                           else [self._step._graph])
        else:
            self._step = None
            self._segments(plan, cards)
        self.capture_s = sum(g.capture_s for g in self.graphs)
        self.pool_bytes = sum(g.pool_bytes for g in self.graphs)

    def _front(self, ts_padded, frame_idx0) -> tuple:
        """FEC, mapper and frame builder, the symbol axis padded to the
        slot count: one (B, S_pad / n, fft) slab a slot (B counts every
        block's frames)."""
        cfg, n = self.cfg, len(self.slots)
        grids = complex_grids(self.tp, ts_padded, frame_idx0)
        b = grids.shape[0]
        g = torch.cat([grids, grids.new_zeros(b, (-cfg.num_symbols) % n,
                                              cfg.fft_points)], dim=1)
        return g.chunk(n, dim=1)

    def _slab(self, slab: torch.Tensor, d) -> torch.Tensor:
        return symbols_with_gi(self.cfg, slab, self._eq[d])

    def _back(self, slabs: list) -> torch.Tensor:
        b = slabs[0].shape[0]
        body = torch.cat(slabs, dim=1)[:, :self.cfg.num_symbols]
        out = torch.cat([self.tp.tail.p1.expand(b, -1), body.reshape(b, -1)],
                        dim=1)
        return torch.view_as_real(out)

    def eager(self, ts_padded, frame_idx0) -> torch.Tensor:
        """The call op by op, with no graph; like the step functions it
        also takes (blocks, ·) windows and a (blocks,) frame index."""
        chunks = self._front(ts_padded, frame_idx0)
        return block_view(ts_padded, self._back(
            [self._slab(c.to(d), d).to(self.dev0)
             for c, d in zip(chunks, self.slots)]))

    def _segments(self, plan: TransmitPlan, cards: list) -> None:
        """Capture the front, each other card's slabs and the back, each
        on its card, with static inputs for what the peer copies bring."""
        dev0 = self.dev0
        self._windows = [torch.zeros(187 + pp.ts_bytes_in,
                                     dtype=torch.uint8, device=dev0)
                         for pp in plan.plps]
        self._frame_idx = torch.zeros((), dtype=torch.int64, device=dev0)
        ws = self._windows if len(self._windows) > 1 else self._windows[0]
        mine = {d: [j for j, s in enumerate(self.slots) if s == d]
                for d in cards}

        def front():
            chunks = self._front(ws, self._frame_idx)
            # the first card's slabs as in ``eager``; the others' made
            # contiguous, as ``.to`` makes them, for one peer copy a slab
            return [self._slab(c, dev0) if self.slots[j] == dev0
                    else c.contiguous() for j, c in enumerate(chunks)]

        self._front_graph = Graph(front, dev0)
        sent = self._front_graph.out
        self._sends, self._returns, self._card_graphs = [], [], []
        slabs = list(sent)
        for d in cards[1:]:
            ins = {j: torch.empty_like(sent[j], device=d) for j in mine[d]}
            g = Graph(lambda ins=ins, d=d: {j: self._slab(x, d)
                                            for j, x in ins.items()}, d)
            self._card_graphs.append(g)
            for j in mine[d]:
                self._sends.append((ins[j], sent[j]))
                slabs[j] = torch.empty_like(g.out[j], device=dev0)
                self._returns.append((slabs[j], g.out[j]))
        self._back_graph = Graph(lambda: self._back(slabs), dev0)
        self.graphs = [self._front_graph, *self._card_graphs,
                       self._back_graph]

    def __call__(self, ts_padded, frame_idx0: int) -> torch.Tensor:
        ws = (list(ts_padded) if isinstance(ts_padded, (list, tuple))
              else [ts_padded])
        if self._step is not None:
            return self._step([w[None] for w in ws], [frame_idx0])[0]
        if len(ws) != len(self._windows):
            raise ValueError(f"{len(ws)} windows for "
                             f"{len(self._windows)} PLPs")
        for d, w in zip(self._windows, ws):
            d.copy_(w)
        self._frame_idx.fill_(frame_idx0)
        self._front_graph.replay()
        for dst, src in self._sends:
            dst.copy_(src)
        for g in self._card_graphs:
            g.replay()
        for dst, src in self._returns:
            dst.copy_(src)
        self._back_graph.replay()
        with torch.cuda.device(self.dev0):
            return self._back_graph.out.clone()
