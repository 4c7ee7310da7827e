"""Observability: throughput counters, logging, and profiler hooks.

The reference's only observability is GR_LOG_WARN on malformed TS and
GR_LOG_FATAL on allocation failure (SURVEY.md section 5.5).  The port
keeps structured per-transmitter counters (frames, samples, wall time,
real-time margin) and the TS sync check, as ``dvbt2ll_tpu/observability.py``
has them, plus a ``torch.profiler`` trace context.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import os

import numpy as np
import torch

log = logging.getLogger("dvbt2ll_tpu_torch")


@dataclasses.dataclass
class TxCounters:
    """Cumulative counters for one transmit chain."""

    steps: int = 0
    frames: int = 0
    samples: int = 0
    ts_bytes: int = 0
    sync_errors: int = 0
    wall_seconds: float = 0.0

    def record_step(self, frames: int, samples: int, ts_bytes: int,
                    seconds: float) -> None:
        self.steps += 1
        self.frames += frames
        self.samples += samples
        self.ts_bytes += ts_bytes
        self.wall_seconds += seconds

    @property
    def samples_per_second(self) -> float:
        return self.samples / self.wall_seconds if self.wall_seconds else 0.0

    def realtime_margin(self, sample_rate: float) -> float:
        """How many times faster than real time the chain is running."""
        return (self.samples_per_second / sample_rate) if sample_rate else 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self) | {
            "samples_per_second": self.samples_per_second}


def check_ts_sync(ts: np.ndarray, phase: int = 0,
                  max_report: int = 3) -> int:
    """Count missing 0x47 sync bytes at packet boundaries (the check the
    reference does per-byte in its work loop,
    lib/bbheaderbch_bb_impl.cc:676,704).  Logs a warning like the
    reference's 'Malformed MPEG-TS' message; returns the error count."""
    start = (-phase) % 188
    syncs = ts[start::188]
    bad = int((syncs != 0x47).sum())
    if bad:
        log.warning("Malformed MPEG-TS: %d missing sync bytes in window "
                    "(first offsets: %s)", bad,
                    (start + 188 * np.flatnonzero(syncs != 0x47)[:max_report]
                     ).tolist())
    return bad


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Trace everything inside the block with ``torch.profiler`` (host
    operators and, where a CUDA device exists, its kernels and copies) and
    write a TensorBoard/Chrome trace file into ``logdir``.  Yields the
    profiler, whose ``key_averages()`` tabulates the same events."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir)) as prof:
        yield prof
