"""Observability: counters, the TS sync check, the program's own tracing,
and a profiler trace context.

The reference's only observability is GR_LOG_WARN on malformed TS and
GR_LOG_FATAL on allocation failure (SURVEY.md section 5.5).  The port
keeps per-transmitter counts and the TS sync check, as
``dvbt2ll_tpu/observability.py`` has them, a ``torch.profiler`` trace
context, and its own tracing, off by default:

* ``span(name, step=None)`` times a layer's part of a step on
  ``time.perf_counter_ns`` (the clock of a caller's own spans).  A span
  knows its parent (the thread's innermost open span) and its step id,
  given or inherited from the parent, and goes into a ring of the newest
  ``RING_RECORDS`` records; while a ``torch.profiler`` records, it is
  also a range named ``tx:<name>``, so it lies on a device trace's clock
  too.
* ``mark(stage, x)`` launches a tiny kernel named for a boundary of the
  transmit step (``STAGES``) on ``x``'s card.  A step captured as a CUDA
  graph while tracing is on holds one mark node a boundary; one captured
  while it is off holds none.  In a device trace, a segment of device
  activity is named by the mark that ends it.
* ``device_time_ns(event, device)`` puts a timing CUDA event's completion
  on the host's ``perf_counter_ns`` clock, from an anchor event recorded
  and waited for when tracing is turned on.

With tracing off a span is one flag check and the shared ``_NO_SPAN``:
no clock is read and nothing is allocated or called in torch.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import os
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

log = logging.getLogger("dvbt2ll_tpu_torch")

# a 35 s run holds about 8 000 mesh steps of 5 spans (37 000 records at
# 4.7 ms a step) or 220 paced steps of 12; the ring keeps 3.5 times the
# larger, about 22 MB of records at its fullest
RING_RECORDS = 1 << 17
RANGE_PREFIX = "tx:"
# the boundaries of a transmit step that ``mark`` names, in step order
# (``fec`` and ``map`` once a PLP) but for ``ifft``, the last added: on the
# complex tail alone, between ``frames`` and ``tail``, after the transform
# and before the guard interval and P1 copies; csrc/stage_mark.cu has a
# kernel each, in this order
STAGES = ("start", "fec", "map", "frames", "tail", "ifft")


@dataclasses.dataclass
class TxCounters:
    """Cumulative counts of one transmit chain.  A step returns before
    the card has run it, so a rate is a caller's clock over these counts
    taken after the work is done (``StreamingExecutor.run``'s
    ``sustained_samples_per_second``)."""

    steps: int = 0
    frames: int = 0
    samples: int = 0
    ts_bytes: int = 0
    sync_errors: int = 0

    def record_step(self, frames: int, samples: int, ts_bytes: int) -> None:
        self.steps += 1
        self.frames += frames
        self.samples += samples
        self.ts_bytes += ts_bytes

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


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


# ---------------------------------------------------------------- tracing
class Record(NamedTuple):
    """One span, or one instant (``t0_ns == t1_ns``), on
    ``perf_counter_ns``; ``parent`` is the enclosing span's name."""
    name: str
    parent: Optional[str]
    step: Optional[int]
    t0_ns: int
    t1_ns: int


class _Recorder:
    """What tracing keeps: the ring of records, each thread's stack of
    open spans, and each card's anchor (an event that completed at a known
    ``perf_counter_ns``)."""

    def __init__(self, capacity: int):
        from torch.autograd.profiler import record_function
        self.record_function = record_function
        self.profiling = torch.autograd._profiler_enabled
        self.ring = collections.deque(maxlen=capacity)
        self.local = threading.local()
        self.anchors = {}
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                with torch.cuda.device(i):
                    torch.cuda.synchronize()
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    ev.synchronize()
                    self.anchors[i] = (ev, time.perf_counter_ns())

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s


_on = False
_rec: Optional[_Recorder] = None


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "step", "parent", "stack", "range", "t0")

    def __init__(self, name: str, step: Optional[int]):
        self.name, self.step = name, step

    def __enter__(self):
        rec = _rec
        stack = rec.stack()
        top = stack[-1] if stack else None
        self.parent = top.name if top is not None else None
        if self.step is None and top is not None:
            self.step = top.step
        stack.append(self)
        self.stack = stack
        # a range costs about 10 us and shows only while a profiler records
        self.range = (rec.record_function(RANGE_PREFIX + self.name)
                      if rec.profiling() else None)
        if self.range is not None:
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        self.stack.pop()
        _rec.ring.append(Record(self.name, self.parent, self.step, self.t0,
                                t1))


def enable(capacity: int = RING_RECORDS) -> None:
    """Turn tracing on, with an empty ring of ``capacity`` records; on a
    machine with CUDA cards, each card's anchor is recorded and waited
    for."""
    global _on, _rec
    _rec = _Recorder(capacity)
    _on = True


def disable() -> None:
    """Turn tracing off; the records made so far stay readable."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def records() -> list:
    """The ring's records, oldest first (empty if tracing was never
    on)."""
    return list(_rec.ring) if _rec is not None else []


def span(name: str, step: Optional[int] = None):
    """A context that records ``name`` while tracing is on (see the
    module's docstring); ``step`` None takes the parent's step id."""
    if not _on:
        return _NO_SPAN
    return _Span(name, step)


def instant(name: str, t_ns: int, step: Optional[int] = None) -> None:
    """Record a moment (``device_time_ns``'s, say) as a zero-length record
    under the thread's innermost open span."""
    if not _on:
        return
    stack = _rec.stack()
    top = stack[-1] if stack else None
    if step is None and top is not None:
        step = top.step
    _rec.ring.append(Record(name, top.name if top is not None else None,
                            step, t_ns, t_ns))


def device_time_ns(event, device) -> int:
    """The ``perf_counter_ns`` at which ``event``, a completed timing CUDA
    event recorded on ``device``, completed: the card's anchor plus the
    time between the two events on the card.  Good to the anchor's wait
    (microseconds) and the two clocks' drift."""
    if _rec is None:
        raise RuntimeError("tracing was never turned on")
    index = torch.device(device).index
    anchor, t_ns = _rec.anchors[torch.cuda.current_device()
                                if index is None else index]
    return t_ns + round(anchor.elapsed_time(event) * 1e6)


def mark(stage: str, x: torch.Tensor) -> None:
    """Launch the mark kernel of ``stage`` (one of ``STAGES``) on ``x``'s
    card, on its current stream (under a capture, into the graph).  A
    no-op unless tracing is on and ``x`` is on a CUDA device."""
    if not _on or x.device.type != "cuda":
        return
    from .ops import _build
    lib = _build.library()
    with torch.cuda.device(x.device):
        code = lib.dvbt2ll_stage_mark(
            STAGES.index(stage), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, f"stage mark {stage}")


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
