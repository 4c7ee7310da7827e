"""Runner ``mesh``: independent muxes through ``ShardedTransmitter``.

Traffic parameters: ``n_mux`` muxes, ``slots_per_mux`` frame slots a mux
(each a block of ``frames_per_block`` frames), spread over the cell's
cards in order (card i holds muxes i * n_mux / chips and on), the
``pool_steps`` distinct TS steps a mux cycled, ``warm_steps`` steps in
set-up, then the closed loop of ``loop.closed_loop``.  The span
``mesh_host`` is ``step_device``: every block's halo window written into
its card's pinned rows, one copy a PLP a card, one graph launch a card.
"""
from __future__ import annotations

import time

from txbench.loop import closed_loop
from txbench.traffic.ts import stream_bytes, ts_pool


class Runner:
    def __init__(self, run):
        from dvbt2ll_tpu_torch.parallel import ShardedTransmitter, make_mesh
        t = run.traffic
        self.run = run
        n_mux, per = t["n_mux"], t["slots_per_mux"]
        if n_mux % run.chips:
            raise ValueError(f"{n_mux} muxes over {run.chips} cards")
        slots = [d for d in run.devices
                 for _ in range(n_mux // run.chips * per)]
        self.stx = ShardedTransmitter(
            run.cfg, make_mesh(slots, mux=n_mux), n_mux=n_mux,
            frames_per_shard=t["frames_per_block"], strict=True)
        run.mark("transmitter")
        self.pool = ts_pool(run.seed, t["pool_steps"], n_mux,
                            self.stx.bytes_per_step_per_mux)
        run.stream = lambda m, a, b: stream_bytes(self.pool, m, a, b)
        run.mark("pool")
        self.n_mux = n_mux
        self.frames = self.stx.frames_per_step
        self.block = t["frames_per_block"]
        run.card_frames = n_mux // run.chips * per * self.block
        for s in range(t["warm_steps"]):
            self._step(s)
        run.sync()
        run.mark("warm-up")
        run.setup_s = time.perf_counter() - run.t_start

    def _step(self, s: int):
        out = self.stx.step_device(self.pool[s % self.pool.shape[0]])
        # the step's one output tensor a card, of which each block's
        # output is a view
        bases = {}
        for row in out:
            for x in row:
                bases.setdefault(x.device, x._base if x._base is not None
                                 else x)
        b = self.block
        return list(bases.values()), lambda c, f: out[c][f // b][f % b]

    def window(self) -> None:
        run = self.run
        closed_loop(run, self._step, run.traffic["warm_steps"], self.n_mux,
                    self.frames, self.n_mux * self.frames
                    * run.cfg.samples_per_frame, "mesh_host")

    def close(self) -> None:
        self.stx = None
        if self.run.on_cuda:
            import torch
            torch.cuda.empty_cache()
