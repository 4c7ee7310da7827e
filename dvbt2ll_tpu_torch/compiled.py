"""The compiled step: the counterpart of the JAX ``Transmitter``'s
``jax.jit(functools.partial(step_fn, plan))`` (``dvbt2ll_tpu/pipeline.py``).

On a CUDA device ``CompiledStep`` captures one call of a step function
(``pipeline.select_step_iq``) on static inputs as a ``torch.cuda.CUDAGraph``
and replays it every step, so the whole step (both hand-written kernels,
the cuBLAS products and the cuFFT transforms included) is one launch from
the host.  Its static inputs are one uint8 window a PLP (the 187 carried
bytes, then the step's fresh bytes) and the step's first T2 frame index,
a 0-d int64 tensor that the frame builder reads at every replay (the JAX
step's traced ``jnp.int32(frame_idx)``).

A call stages the windows (host arrays through pinned buffers, or tensors
by a device copy), writes the frame index, replays, and returns a copy of
the graph's static output made on the device.  The next replay overwrites
the static output, which lies in the graph's private memory pool, where
``Tensor.record_stream`` protects nothing; the copy comes from the
caching allocator, so a tensor that a step returns is the caller's and no
later step writes to it.

The kernel wrappers count their launches in Python, which a replay does
not run.  A capture launches nothing, so its increase of each count is
taken back and added at every replay instead: the counts read as in eager
mode.

On the CPU the same class stages into the same static inputs and calls
the step function, with no graph.  On a CUDA device a capture that fails
raises; there is no eager fallback.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .ops import kernel_wrappers


class CompiledStep:
    """``step_fn(tensors, windows, frame_idx0)`` for one plan on
    ``device``: a CUDA graph captured at construction, or on the CPU the
    eager call on the same static inputs.

    ``capture_s`` is the warm-up and capture time on the host clock and
    ``pool_bytes`` the device memory that the graph's private pool
    reserved (both 0 on the CPU)."""

    def __init__(self, step_fn, tensors, plan, device):
        self.device = torch.device(device)
        self._step_fn = step_fn
        self._tensors = tensors
        self._sizes = [187 + pp.ts_bytes_in for pp in plan.plps]
        self.windows = [torch.zeros(n, dtype=torch.uint8, device=self.device)
                        for n in self._sizes]
        self.frame_idx = torch.zeros((), dtype=torch.int64,
                                     device=self.device)
        self.capture_s = 0.0
        self.pool_bytes = 0
        self._graph = None
        if self.device.type == "cuda":
            # pinned staging: a host window reaches its static buffer by an
            # asynchronous copy, so the host does not wait for the card
            self._host = [torch.empty(n, dtype=torch.uint8, pin_memory=True)
                          for n in self._sizes]
            self._staged = torch.cuda.Event()
            self._capture()

    def _run(self) -> torch.Tensor:
        ws = self.windows if len(self.windows) > 1 else self.windows[0]
        return self._step_fn(self._tensors, ws, self.frame_idx)

    def _capture(self) -> None:
        """Warm up on the capture stream (the kernel library's first load,
        cuBLAS's handle and workspace, cuFFT's plans: real launches,
        counted), then capture one call."""
        dev = self.device
        t0 = time.perf_counter()
        wrappers = kernel_wrappers()
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._run()
            side.synchronize()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            before = {k: f.launches for k, f in wrappers.items()}
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, stream=side,
                                      capture_error_mode="thread_local"):
                    out = self._run()
            finally:
                self._replay_launches = {k: f.launches - before[k]
                                         for k, f in wrappers.items()}
                for k, f in wrappers.items():
                    f.launches = before[k]
            torch.cuda.synchronize(dev)
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self._graph, self._out = graph, out
        self.capture_s = time.perf_counter() - t0

    def stage(self, windows, frame_idx: int) -> None:
        """Write one step's inputs: ``windows``, one a PLP, each 187 +
        fresh bytes as a uint8 host array or tensor, and the step's first
        T2 frame index."""
        if len(windows) != len(self.windows):
            raise ValueError(f"{len(windows)} windows for "
                             f"{len(self.windows)} PLPs")
        for w, n in zip(windows, self._sizes):
            if tuple(w.shape) != (n,):
                raise ValueError(f"window of shape {tuple(w.shape)}, "
                                 f"expected ({n},)")
        if self.device.type != "cuda":
            for d, w in zip(self.windows, windows):
                if torch.is_tensor(w):
                    d.copy_(w)
                else:
                    np.copyto(d.numpy(), w, casting="no")
            self.frame_idx.fill_(frame_idx)
            return
        with torch.cuda.device(self.device):
            # the previous step's copies have read the pinned buffers
            self._staged.synchronize()
            for d, h, w in zip(self.windows, self._host, windows):
                if torch.is_tensor(w):
                    d.copy_(w)
                else:
                    np.copyto(h.numpy(), w, casting="no")
                    d.copy_(h, non_blocking=True)
            self._staged.record(torch.cuda.current_stream(self.device))
            self.frame_idx.fill_(frame_idx)

    def replay(self) -> torch.Tensor:
        """The step on the staged inputs: (B, samples, 2) f32 I/Q, a tensor
        that no later step writes."""
        if self._graph is None:
            return self._run()
        with torch.cuda.device(self.device):
            self._graph.replay()
            for k, f in kernel_wrappers().items():
                f.launches += self._replay_launches[k]
            return self._out.clone()

    def __call__(self, windows, frame_idx: int) -> torch.Tensor:
        self.stage(windows, frame_idx)
        return self.replay()
