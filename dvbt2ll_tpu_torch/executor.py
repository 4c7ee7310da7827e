"""Pipelined streaming executor: ingest -> device -> sink with overlap.

The counterpart of ``dvbt2ll_tpu/executor.py``, with the same constructor,
``step``/``flush``/``run`` and stats.  Step N is enqueued on the device
before step N-1 is drained, so the host's work on N-1 (sink writes, FEF
insertion, the next TS window) overlaps N's compute.

On a CUDA transmitter each step's output goes to the host by an
asynchronous copy into pinned memory, on a side stream that waits on an
event recorded after the step on the compute stream; a second event marks
the copy done, and draining the step waits on that event alone.  The
copy overlaps the next step's compute (copy engine and SMs).  The step
is the transmitter's compiled step: its output is a device copy of the
graph's static output (``compiled.CompiledStep``), which the caching
allocator owns, so ``record_stream`` protects it as it protects any
tensor.  A CPU transmitter's output is already on the host: its drain is
a view.

Under the port's tracing (``observability``) a step is the span
``executor.step`` with the children ``executor.read`` (the sources,
waiting for TS included), ``transmitter.step``, ``executor.copy`` (the
pinned buffer, the events, the copy's enqueue), ``executor.drain`` (the
wait for the previous step's copy, FEF insertion) and ``executor.sink``;
the copy's done event is then a timing event, and the instant
``executor.copy_done`` puts its completion on the host's clock.

    executor = StreamingExecutor(tx, source=ingest_or_callable, sink=sink)
    executor.run(n_steps)
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from . import observability
from .observability import span
from .pipeline import Transmitter


class _HostCopy:
    """One step's output on its way to the host: a pinned buffer that a
    side-stream copy fills, and the event that marks the copy done.

    The device output is marked as used on the side stream
    (``record_stream``), so the caching allocator hands its memory to no
    later step before the copy has read it.  Each step gets its own
    pinned buffer from PyTorch's caching host allocator: the array a
    drain returns is a view of it and stays the caller's, and the block
    goes back to the cache only when the caller drops that array.
    ``timed`` makes ``done`` a timing event, for
    ``observability.device_time_ns``, and is kept: a copy enqueued with
    tracing off has no time to read, whenever it is drained."""

    def __init__(self, out: torch.Tensor, side: torch.cuda.Stream,
                 timed: bool = False):
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(out.device))
        self.host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        side.wait_event(ready)
        self.timed = timed
        with torch.cuda.stream(side):
            self.host.copy_(out, non_blocking=True)
            self.done = torch.cuda.Event(enable_timing=timed)
            self.done.record(side)
        out.record_stream(side)

    def wait(self) -> np.ndarray:
        self.done.synchronize()
        return self.host.numpy()


class StreamingExecutor:
    """Double-buffered transmit loop.

    source: a callable ``(n_bytes) -> np.ndarray`` per PLP stream (or a
        list of callables for multi-PLP), e.g. ``TSFileSource.read``, a
        ``TSIngest`` window closure, or a ``synthetic_ts``-style generator.
    sink: an object with ``write(iq: np.ndarray)`` (e.g. ``IQFileSink``,
        ``NativeIQSink``), or None to drop the output.

    ``step`` returns the previous step's complex64 (B, samples_per_frame)
    frames, or for a config with FEF parts the emitted stream with them
    inserted, shaped (1, samples): the JAX executor's contract.  Every
    returned array is the caller's; no later step writes to it.
    """

    def __init__(self, tx: Transmitter, source, sink=None,
                 realtime: bool = False):
        self.tx = tx
        self.sources = (list(source) if isinstance(source, (list, tuple))
                        else [source])
        if len(self.sources) != len(tx.plan.plps):
            raise ValueError(f"{len(self.sources)} sources for "
                             f"{len(tx.plan.plps)} PLPs")
        self.sink = sink
        self.realtime = realtime
        self._side = (torch.cuda.Stream(tx.device)
                      if tx.device.type == "cuda" else None)
        # (_HostCopy or CPU tensor, start frame idx, step number)
        self._pending = None
        self._steps = 0

    def _read_step_input(self):
        return [np.asarray(src(pp.ts_bytes_in), dtype=np.uint8)
                for src, pp in zip(self.sources, self.tx.plan.plps)]

    def _drain(self) -> Optional[tuple]:
        """The pending step's IQ, its copy waited for, and its step
        number.  Under tracing the instant ``executor.copy_done`` is when
        the copy completed on the card (``device_time_ns``)."""
        if self._pending is None:
            return None
        out, start, k = self._pending
        self._pending = None
        with span("executor.drain", k):
            iq = out.wait() if self._side is not None else out.numpy()
            if (self._side is not None and out.timed
                    and observability.enabled()):
                observability.instant(
                    "executor.copy_done",
                    observability.device_time_ns(out.done, self.tx.device))
            frames = iq.reshape(iq.shape[0], -1).view(np.complex64)
            if self.tx.cfg.has_fef:
                # the emitted stream carries FEF parts (like
                # Transmitter.stream)
                frames = self.tx._with_fef(frames, start)[None]
        return frames, k

    def _hand_off(self, drained: Optional[tuple]) -> Optional[np.ndarray]:
        """A drained step's IQ to the sink; returns the IQ."""
        if drained is None:
            return None
        iq, k = drained
        if self.sink is not None:
            with span("executor.sink", k):
                self.sink.write(iq)
        return iq

    def step(self) -> Optional[np.ndarray]:
        """Enqueue one device step and its copy to the host, then return
        the PREVIOUS step's IQ (None on the first call).  Under tracing
        the span ``executor.step`` carries this step's number; its
        ``executor.drain`` and ``executor.sink`` carry the previous
        step's, whose IQ they handle."""
        k = self._steps
        with span("executor.step", k):
            with span("executor.read"):
                streams = self._read_step_input()
            ts = streams if len(streams) > 1 else streams[0]
            start = self.tx._frame_idx  # frame index this step starts at
            try:
                out = self.tx.step_device(ts)
                with span("executor.copy"):
                    pending = (_HostCopy(out, self._side,
                                         observability.enabled())
                               if self._side is not None else out)
            except Exception:
                # don't lose the already-computed step N-1 held in _pending
                self.flush()
                raise
            self._steps += 1
            drained = self._drain()
            self._pending = (pending, start, k)
            return self._hand_off(drained)

    def flush(self) -> Optional[np.ndarray]:
        return self._hand_off(self._drain())

    def run(self, n_steps: int) -> dict:
        """Run n_steps with overlap; returns the transmitter counters.

        realtime=True paces at the air rate of what is emitted: for FEF
        configs each step's airtime includes the FEF parts the drain
        inserts (``emitted_frame_duration``)."""
        t0 = time.perf_counter()
        deadline = t0
        frame_t = (self.tx.plan.batch_frames
                   * self.tx.cfg.emitted_frame_duration)
        for _ in range(n_steps):
            self.step()
            if self.realtime:
                deadline += frame_t
                now = time.perf_counter()
                if deadline > now:
                    time.sleep(deadline - now)
        self.flush()
        wall = time.perf_counter() - t0
        stats = self.tx.counters.as_dict()
        stats["wall_clock_seconds"] = wall
        stats["sustained_samples_per_second"] = (
            self.tx.counters.samples / wall)
        return stats
