"""Runner ``paced``: one channel through the whole runtime at its air rate.

    generator process -> os.pipe -> io.ingest.TSIngest -> StreamingExecutor
    (strict, validate_ts) -> pinned device-to-host copy -> NativeIQSink

The TS comes from ``traffic/paced_writer.py``, a process of its own that
writes the seeded pool at the air rate of ``frames_per_step`` frames at
``sample_rate`` samples a second, on a schedule that does not slow when
the runtime does.  ``warm_steps`` steps go at once and are run in
set-up; then every step's last byte is due one step's air time after the
last.  A step's latency runs from when its last TS byte was due to when
the runtime hands its IQ to the sink (the benchmark's wrapper around
``NativeIQSink.write``, which writes to /dev/null).  Spans and per-step
readings: ``step`` around ``StreamingExecutor.step``, ``step_host`` the
same less the time the executor's source waited for the ring, and
``hold``, from the end of the ``step`` call that enqueued a step to the
hand-off of its IQ.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

from txbench.harness import Profiled, Reservoir
from txbench.traffic.ts import rng, stream_bytes, ts_pool

SOURCE_TIMEOUT = 30.0     # seconds the ring may take to give a window
POLL = 0.0002             # seconds between looks at the ring
LEAD = 0.05               # seconds from the start signal to t0


class _RecordingSink:
    """Stamps each hand-off on ``time.monotonic`` and passes it on."""

    def __init__(self, sink, on_write):
        self.sink = sink
        self.on_write = on_write
        self.times, self.sizes = [], []

    def write(self, iq) -> None:
        self.times.append(time.monotonic())
        self.sizes.append(iq.size)
        self.on_write(len(self.times) - 1, iq)
        self.sink.write(iq)


class Runner:
    def __init__(self, run):
        from dvbt2ll_tpu_torch.executor import StreamingExecutor
        from dvbt2ll_tpu_torch.io.ingest import TSIngest
        from dvbt2ll_tpu_torch.io.native_sink import NativeIQSink
        from dvbt2ll_tpu_torch.pipeline import Transmitter
        t = run.traffic
        self.run = run
        self.frames = t["frames_per_step"]
        run.card_frames = self.frames
        self.tx = Transmitter(run.cfg, self.frames, strict=True,
                              validate_ts=True, device=run.devices[0])
        run.mark("transmitter")
        n = self.tx.bytes_per_step
        self.step_s = (self.frames * run.cfg.samples_per_frame
                       / t["sample_rate"])
        self.n_steps = int(run.seconds / self.step_s)
        self.warm = t["warm_steps"]
        self.pool = ts_pool(run.seed, t["pool_steps"], 1, n)
        run.mark("pool")
        run.stream = lambda m, a, b: stream_bytes(self.pool, m, a, b)
        self.res = Reservoir(rng(run.seed, 2), t["check_steps"],
                             t["check_frames_per_step"], 1, self.frames)
        self.gen = self.ing = self.sink = None
        self.rfd = -1
        rfd, wfd = os.pipe()
        self.rfd = rfd
        writer = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "traffic", "paced_writer.py")
        try:
            self.gen = subprocess.Popen(
                [sys.executable, writer, "--fd", str(wfd),
                 "--seed", str(run.seed), "--k", str(t["pool_steps"]),
                 "--bytes-per-step", str(n),
                 "--step-seconds", repr(self.step_s),
                 "--burst", str(self.warm), "--steps",
                 str(self.n_steps + 2), "--chunks",
                 str(t["chunks_per_step"])],
                pass_fds=(wfd,), stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        finally:
            os.close(wfd)
        self.ing = TSIngest(fd=rfd, capacity=t["ring_bytes"])
        self.ing.start_thread()
        self.sink = NativeIQSink(os.devnull, gain=t["gain"])
        self.rec = _RecordingSink(self.sink, self._hand_off)
        self.ex = StreamingExecutor(self.tx, source=self._source,
                                    sink=self.rec)
        self.wait = 0.0
        self.sync_bad = []
        self.warm_writes = None
        run.mark("generator and io")
        for _ in range(self.warm):
            self.ex.step()
        self.ex.flush()
        run.sync()
        self.warm_writes = len(self.rec.times)
        run.mark("warm-up")
        run.setup_s = time.perf_counter() - run.t_start

    def _source(self, nbytes: int):
        t0 = time.perf_counter()
        deadline = time.monotonic() + SOURCE_TIMEOUT
        while True:
            w = self.ing.window(nbytes, allow_stuffing=False)
            if w is not None:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"the ingest ring gave no window in "
                                   f"{SOURCE_TIMEOUT:.0f} s")
            time.sleep(POLL)
        self.wait += time.perf_counter() - t0
        return w[187:]

    def _hand_off(self, i: int, iq) -> None:
        if self.warm_writes is None:
            return                  # a warm-up step
        k = i - self.warm_writes    # the measured step
        fetch = lambda picks: [iq[f].copy() for _, f in picks]
        if k == self.n_steps - 1:
            self.res.last(k, fetch)
        else:
            self.res.offer(k, fetch)

    def window(self) -> None:
        run, t = self.run, self.run.traffic
        trace_steps = math.ceil(t["trace_seconds"] / self.step_s)
        # the traced part: the window's last steps, at most its half
        trace_from = (max(self.n_steps // 2, self.n_steps - trace_steps - 1)
                      if run.trace_on else self.n_steps + 1)
        prof = None
        ends = []
        t0 = time.monotonic() + LEAD
        self.gen.stdin.write(f"{t0!r}\n")
        self.gen.stdin.close()
        self.gen.stdin = None
        for k in range(self.n_steps):
            if k == trace_from:
                prof = Profiled(run)
                prof.start()
            errs = self.tx.counters.sync_errors
            self.wait = 0.0
            a = time.perf_counter()
            try:
                with run.spans.span("step"):
                    self.ex.step()
            except Exception as exc:          # a failed step is counted
                run.notes.append(f"step {k} raised {exc!r}")
            ends.append(time.monotonic())
            if self.tx.counters.sync_errors != errs:
                self.sync_bad.append(k)
            if k < trace_from:
                run.per_step["step_host"].append(
                    time.perf_counter() - a - self.wait)
        self.ex.flush()
        run.sync()
        if prof is not None:
            prof.stop(self.n_steps - trace_from)
        run.window_s = time.monotonic() - t0
        writes = self.rec.times[self.warm_writes:]
        sizes = self.rec.sizes[self.warm_writes:]
        ingest = self.ing.stats
        report = self._stop_generator()
        due = report.get("due") or []
        if len(due) < len(writes):
            run.notes.append("the generator stamped fewer steps than were "
                             "handed off; the rest due on its schedule")
            due = due + [t0 + (k + 1) * self.step_s
                         for k in range(len(due), len(writes))]
        run.latencies_s = [w - d for w, d in zip(writes, due)]
        run.per_step["hold"] = [w - e for k, (w, e)
                                in enumerate(zip(writes, ends))
                                if k < trace_from]
        want = self.frames * run.cfg.samples_per_frame
        bad = ({k for k, s in enumerate(sizes) if s != want}
               | set(self.sync_bad)
               | set(range(len(writes), self.n_steps)))
        run.attempted = self.n_steps
        run.failed = len(bad)
        run.samples = sum(sizes)
        run.notes.append(
            f"generator: late p50 {report.get('late_p50_ms')!r} ms, p95 "
            f"{report.get('late_p95_ms')!r} ms, max "
            f"{report.get('late_max_ms')!r} ms over {report.get('steps')} "
            f"steps; ingest {ingest}")
        for k, picks, frames in self.res.kept:
            for (_, f), iq in zip(picks, frames):
                run.checked.append((0, (self.warm + k) * self.frames + f,
                                    iq.reshape(-1)))

    def _stop_generator(self) -> dict:
        """Close the ring and the pipe's reading end, which ends the
        writer, and read its report."""
        if self.ing is not None:
            self.ing.close()
            self.ing = None
        if self.rfd >= 0:
            os.close(self.rfd)
            self.rfd = -1
        if self.gen is None:
            return {}
        try:
            out, err = self.gen.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.gen.kill()
            out, err = self.gen.communicate()
        self.gen = None
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        if not lines:
            self.run.notes.append(f"the generator printed no report: "
                                  f"{err[-500:]!r}")
            return {}
        return json.loads(lines[-1])

    def close(self) -> None:
        try:
            self._stop_generator()
        finally:
            if self.sink is not None:
                self.sink.close()
                self.sink = None
            self.ex = self.tx = None
            if self.run.on_cuda:
                import torch
                torch.cuda.empty_cache()
