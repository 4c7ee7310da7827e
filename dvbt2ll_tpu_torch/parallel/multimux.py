"""Heterogeneous multi-mux scale-out: N independent DVB-T2 channels with
PER-CHANNEL configs on one pool of device slots; the counterpart of
``dvbt2ll_tpu/parallel/multimux.py``.

The reference analog is "N independent flowgraphs" (BASELINE config 5:
8+ independent DVB-T2 channels).  Channels with different modes have
different tensor shapes, so one ``ShardedTransmitter`` cannot cover them:
the pool is partitioned, each group gets its own (mux, frame) mesh and
``ShardedTransmitter``, and a step enqueues every group before any result
is read, so groups on different cards overlap.  Channels that share a
config can share one group (n_mux > 1).

There is no communication between channels of any kind.
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..config import T2Config
from .sharding import ShardedTransmitter, cuda_devices, make_mesh


@dataclass
class MuxChannel:
    """One channel group: ``n_mux`` independent muxes sharing ``cfg``.

    ``n_devices`` pins the group's share of the slot pool (must be a
    multiple of ``n_mux``); None = an equal share of the remainder.
    ``frames_per_shard`` / ``allow_phase_drift`` / ``strict`` follow
    ShardedTransmitter semantics per group.
    """
    cfg: T2Config
    n_mux: int = 1
    n_devices: Optional[int] = None
    frames_per_shard: Optional[int] = None
    strict: bool = True
    allow_phase_drift: bool = False


_CHANNEL_KEY = re.compile(r"ch(\d+)_")


class MultiMuxTransmitter:
    """Independent DVB-T2 channels with heterogeneous configs.

    ``channels``: MuxChannel specs (or bare T2Configs, treated as
    single-mux groups).  ``devices``: the slots to partition (default:
    every visible CUDA card; slots may repeat a device).  Slots are
    assigned to groups in order.
    """

    def __init__(self, channels: Sequence, devices=None):
        devices = list(cuda_devices() if devices is None else devices)
        # own copies: the pool split assigns n_devices in place, and a
        # caller may legitimately reuse one MuxChannel spec object
        self.channels: List[MuxChannel] = [
            dataclasses.replace(c) if isinstance(c, MuxChannel)
            else MuxChannel(cfg=c) for c in channels]
        if not self.channels:
            raise ValueError("need at least one channel")

        # partition the pool: pinned groups first, equal split of the rest
        for c in self.channels:
            if c.n_devices is not None and c.n_devices < 1:
                raise ValueError("channel n_devices must be >= 1 when set")
        pinned = sum(c.n_devices or 0 for c in self.channels)
        floating = [c for c in self.channels if c.n_devices is None]
        if pinned > len(devices):
            raise ValueError(
                f"channel n_devices sum to {pinned} > pool {len(devices)}")
        if floating:
            rest = len(devices) - pinned
            share, odd = divmod(rest, len(floating))
            if share < 1 or odd:
                raise ValueError(
                    f"{rest} unpinned devices do not split evenly over "
                    f"{len(floating)} channels; pin n_devices per channel")
            for c in floating:
                c.n_devices = share
        elif pinned != len(devices):
            # all channels pinned but devices left over: loud, like the
            # uneven-split path (pass a sliced pool to use fewer devices)
            raise ValueError(
                f"channel n_devices sum to {pinned} but the pool has "
                f"{len(devices)} devices; slice the pool or adjust pins")
        for c in self.channels:
            if c.n_devices % c.n_mux:
                raise ValueError(
                    f"channel n_devices={c.n_devices} must be a multiple "
                    f"of n_mux={c.n_mux}")

        self.transmitters: List[ShardedTransmitter] = []
        self.meshes = []
        pos = 0
        for c in self.channels:
            group = devices[pos : pos + c.n_devices]
            pos += c.n_devices
            mesh = make_mesh(group, mux=c.n_mux)
            self.meshes.append(mesh)
            self.transmitters.append(ShardedTransmitter(
                c.cfg, mesh, n_mux=c.n_mux,
                frames_per_shard=c.frames_per_shard, strict=c.strict,
                allow_phase_drift=c.allow_phase_drift))

    @property
    def bytes_per_step(self) -> list:
        """Per-channel fresh-TS bytes per step: for each channel either an
        int (single PLP) or a tuple (per PLP), per mux."""
        out = []
        for stx in self.transmitters:
            per = stx.bytes_per_step_per_mux_per_plp
            out.append(per[0] if len(per) == 1 else per)
        return out

    def step_device(self, ts_per_channel: Sequence) -> list:
        """One step of every channel.  ``ts_per_channel[i]`` follows
        ShardedTransmitter.step_device for channel i ((n_mux, bytes) or a
        per-PLP sequence).  Every group is ENQUEUED before any result is
        read; returns each channel's ``step_device`` blocks."""
        if len(ts_per_channel) != len(self.transmitters):
            raise ValueError(f"{len(ts_per_channel)} inputs for "
                             f"{len(self.transmitters)} channels")
        return [stx.step_device(ts)
                for stx, ts in zip(self.transmitters, ts_per_channel)]

    def __call__(self, ts_per_channel: Sequence) -> list:
        """Per-channel complex64 (n_mux, frames_per_step, samples)."""
        for stx in self.transmitters:
            stx._require_whole_mesh()  # before any state advances
        outs = self.step_device(ts_per_channel)
        return [stx.gather(o) for stx, o in zip(self.transmitters, outs)]

    # ----------------------------------------------------- checkpoint/resume
    def state_dict(self) -> dict:
        """Each channel's ShardedTransmitter state under ``ch{i}_`` (the
        JAX package's keys, plus ``ch{i}_cfg``, which it ignores)."""
        return {f"ch{i}_{k}": v
                for i, stx in enumerate(self.transmitters)
                for k, v in stx.state_dict().items()}

    def load_state(self, state: dict) -> None:
        """The keys do not record the channel count, so a checkpoint whose
        ``ch{i}_`` prefixes are not exactly this transmitter's channels
        (one missing, or one more) is refused with ValueError, as is one
        whose ``ch{i}_cfg`` is not channel i's config (channels saved in
        another order).  Every channel is checked before any is loaded,
        so a refused checkpoint changes nothing."""
        found = set()
        for k in state:
            m = _CHANNEL_KEY.match(k)
            if m is None:
                raise ValueError(f"checkpoint key {k!r} is not a channel's "
                                 f"(ch<i>_...)")
            found.add(int(m.group(1)))
        want = set(range(len(self.transmitters)))
        if found != want:
            raise ValueError(f"checkpoint holds channels {sorted(found)}, "
                             f"this transmitter has {sorted(want)}")
        # split generically by prefix so fields ShardedTransmitter adds
        # later round-trip without touching this class
        per_channel = [{k[len(f"ch{i}_"):]: v for k, v in state.items()
                        if k.startswith(f"ch{i}_")}
                       for i in range(len(self.transmitters))]
        for i, (stx, sub) in enumerate(zip(self.transmitters, per_channel)):
            try:
                stx.check_state(sub)
            except (KeyError, ValueError) as e:
                raise ValueError(f"checkpoint channel {i}: {e}") from e
        for stx, sub in zip(self.transmitters, per_channel):
            stx.load_state(sub)

    def save(self, path: str) -> None:
        np.savez(path, **self.state_dict())

    def restore(self, path: str) -> None:
        with np.load(path) as z:
            self.load_state({k: z[k] for k in z.files})
