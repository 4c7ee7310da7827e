"""Runner ``single``: one channel through ``Transmitter.step_window``.

Traffic parameters: ``frames_per_step`` (strict: a whole number of TS
packets a step), the ``pool_steps`` distinct TS steps cycled as
pre-carried windows (``traffic.ts.carried_windows``), ``warm_steps``
steps in set-up, then the closed loop of ``loop.closed_loop``.  The span
``host_step`` is ``step_window``: the window staged into the compiled
step's pinned input, one graph launch, the output's device copy, the
carry and the frame counter.
"""
from __future__ import annotations

import time

from txbench.loop import closed_loop
from txbench.traffic.ts import carried_windows, stream_bytes, ts_pool


class Runner:
    def __init__(self, run):
        from dvbt2ll_tpu_torch.pipeline import Transmitter
        t = run.traffic
        self.run = run
        self.tx = Transmitter(run.cfg, t["frames_per_step"], strict=True,
                              device=run.devices[0])
        run.mark("transmitter")
        self.pool = ts_pool(run.seed, t["pool_steps"], 1,
                            self.tx.bytes_per_step)
        self.windows = carried_windows(self.pool)
        run.stream = lambda m, a, b: stream_bytes(self.pool, m, a, b)
        run.mark("pool")
        run.card_frames = t["frames_per_step"]
        for s in range(t["warm_steps"]):
            self._step(s)
        run.sync()
        run.mark("warm-up")
        run.setup_s = time.perf_counter() - run.t_start

    def _step(self, s: int):
        k = self.pool.shape[0]
        out = self.tx.step_window(self.windows[0 if s == 0 else 1 + s % k])
        return [out], lambda c, f: out[f]

    def window(self) -> None:
        run = self.run
        f = run.traffic["frames_per_step"]
        closed_loop(run, self._step, run.traffic["warm_steps"], 1, f,
                    f * run.cfg.samples_per_frame, "host_step")

    def close(self) -> None:
        self.tx = None
        if self.run.on_cuda:
            import torch
            torch.cuda.empty_cache()
