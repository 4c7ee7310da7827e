"""The closed loop that the ``mesh`` and ``single`` runners share.

Each step takes the next TS of the seeded pool, runs the port's step
(host staging and launch), then hands the step's IQ to a consumer on the
card: a sum of every sample, made on the card right after the step, whose
value comes back to the host only after the next step is enqueued.  So
one step is in flight, and the host stages step N + 1 while the card runs
step N, as a card feeding a consumer on the same card does.  The window
is every step started in ``seconds`` and the wait for the last one:
IQ samples completed over that whole time.
"""
from __future__ import annotations

import time

from .harness import Profiled, Reservoir, Run
from .traffic.ts import rng


class Consumer:
    """Sums each step's outputs on their cards; ``pull`` returns the sums
    of the step before the last ``push``."""

    def __init__(self, run: Run):
        import torch
        self.on_cuda = run.on_cuda
        self.slots = [[], []]        # the CPU's sums
        self.total = 0.0
        if self.on_cuda:
            self.host = [[torch.empty((), pin_memory=True)
                          for _ in run.devices] for _ in range(2)]
            self.events = [[torch.cuda.Event() for _ in run.devices]
                           for _ in range(2)]
        self.n = 0

    def push(self, tensors: list) -> None:
        """``tensors``: one output tensor a card, in card order."""
        slot = self.n % 2
        if not self.on_cuda:
            self.slots[slot] = [float(t.sum()) for t in tensors]
        else:
            import torch
            for t, h, e in zip(tensors, self.host[slot], self.events[slot]):
                with torch.cuda.device(t.device):
                    h.copy_(t.sum(), non_blocking=True)
                    e.record()
        self.n += 1

    def pull(self) -> None:
        if self.n < 2:
            return
        slot = (self.n - 2) % 2
        if self.on_cuda:
            for e in self.events[slot]:
                e.synchronize()
            self.total += sum(float(h) for h in self.host[slot])
        else:
            self.total += sum(self.slots[slot])


def closed_loop(run: Run, step, warm: int, n_mux: int, frames: int,
                samples_per_step: int, span: str) -> None:
    """Run ``step(s)`` for s = warm, warm + 1, ... for ``run.seconds``.

    ``step(s)`` returns (outputs, one tensor a card for the consumer;
    frame(mux, f) -> the device tensor of frame f of mux ``mux``'s
    share of step s, ``frames`` frames a mux a step).  Fills the run's
    window, samples, steps, attempted and failed counts, the frames kept
    for the output check, and with tracing the trace of
    ``traffic["trace_seconds"]`` from the window's last such time on (a
    traced window runs over by the profiler's start)."""
    t = run.traffic
    res = Reservoir(rng(run.seed, 2), t["check_steps"],
                    t["check_frames_per_step"], n_mux, frames)
    consumer = Consumer(run)
    kept = lambda frame: (lambda picks: [frame(c, f).clone()
                                         for c, f in picks])
    prof = None
    traced_from = 0
    s = warm
    last = None
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    trace_at = (deadline - t["trace_seconds"] if run.trace_on
                else float("inf"))
    trace_end = float("inf")
    while True:
        now = time.perf_counter()
        if prof is None and now >= trace_at:
            prof = Profiled(run)
            prof.start()
            traced_from = s
            trace_end = time.perf_counter() + t["trace_seconds"]
        if now >= deadline and (prof is None or now >= trace_end):
            break
        try:
            with run.spans.span(span):
                outs, frame = step(s)
        except Exception as exc:            # a failed step is counted
            run.failed += n_mux
            run.notes.append(f"step {s} raised {exc!r}")
            s += 1
            continue
        with run.spans.span("consumer"):
            consumer.push(outs)
            consumer.pull()
        res.offer(s, kept(frame))
        last = (s, frame)
        s += 1
    run.sync()
    t_end = time.perf_counter()
    if prof is not None:
        prof.stop(s - traced_from)
    run.window_s = t_end - t0
    steps = s - warm
    run.attempted = steps * n_mux
    run.samples = (steps - run.failed // n_mux) * samples_per_step
    if last is not None:
        res.last(last[0], kept(last[1]))
    for step_no, picks, tensors in res.kept:
        for (c, f), x in zip(picks, tensors):
            iq = x.cpu().numpy().reshape(-1).view("complex64")
            run.checked.append((c, step_no * frames + f, iq))
    run.notes.append(f"consumer checksum {consumer.total!r}")
