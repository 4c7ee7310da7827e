"""Observability: the JAX package's counters and TS sync check (shared
through ``_host``), and a ``torch.profiler`` trace context in place of its
JAX profiler one."""
from __future__ import annotations

import contextlib
import os

import torch

from ._host.observability import TxCounters, check_ts_sync, log  # noqa: F401


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
