"""The compiled step: the counterpart of the JAX ``Transmitter``'s
``jax.jit(functools.partial(step_fn, plan))`` (``dvbt2ll_tpu/pipeline.py``)
and, over the blocks of one device, of the ``ShardedTransmitter``'s
``jax.jit(_shard_map(shard_fn))`` (``dvbt2ll_tpu/parallel/sharding.py``).

``Graph`` captures a function once on a CUDA device as a
``torch.cuda.CUDAGraph`` and replays it.  ``CompiledStep`` runs a step
function (``pipeline.select_step_iq``) over ``blocks`` blocks of one plan
on one device as one call: the step function takes the blocks' windows
stacked, as the JAX ``shard_fn`` takes them under ``jax.vmap(one_mux)``,
and runs all their frames as one batch, so each kernel launches once a
PLP for every block.  On a card that call is one graph, so the whole step
of every block (both hand-written kernels, the cuBLAS products and the
cuFFT transforms included) is one launch from the host.  The
single-chain ``Transmitter`` is the case of one block.  The static inputs
are one (blocks, 187 + fresh bytes) uint8 window a PLP, row i for block
i, and a (blocks,) int64 frame index, element i block i's first T2 frame
index, which the frame builder reads at every replay (the JAX step's
traced ``jnp.int32(frame_idx)``).

A step stages its inputs through one pinned host buffer a PLP and one for
the frame indices, each reaching its static input by one asynchronous
copy (``host_inputs`` hands the pinned rows to a caller that writes them
in place), replays, and returns one copy of the (blocks, B, samples, 2)
output, made on the device.  The next replay overwrites the graph's
static output, which lies in its private memory pool, where
``Tensor.record_stream`` protects nothing; the copy comes from the
caching allocator, so a tensor that a step returns, and each block's view
of it, is the caller's and no later step writes to it.

The kernel wrappers count their launches in Python, which a replay does
not run.  A capture launches nothing, so its increase of each count is
taken back and added at every replay instead: the counts read as in eager
mode.

Under the port's tracing a step's host parts are spans:
``compiled.wait`` (waiting until the previous step's copies have read
the pinned rows), ``compiled.stage`` (writing them), ``compiled.upload``
and ``compiled.launch`` (the replay and the output copy).

On the CPU ``CompiledStep`` makes the same call on the same static
inputs, with no graph, and the host rows are the static inputs
themselves.  On a CUDA device a capture that fails raises; there is no
eager fallback.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .observability import span
from .ops import kernel_wrappers


class Graph:
    """``fn()`` captured once on the CUDA ``device``: ``out`` is what the
    capture returned (the graph's static outputs) and ``replay()`` runs the
    graph again on the device's current stream.

    The warm-up (the kernel library's first load, cuBLAS's handle and
    workspace, cuFFT's plans: real launches, counted) and the capture run
    on a side stream.  ``capture_s`` is their time on the host clock and
    ``pool_bytes`` the device memory that the graph's private pool
    reserved."""

    def __init__(self, fn, device):
        self.device = torch.device(device)
        dev = self.device
        t0 = time.perf_counter()
        wrappers = kernel_wrappers()
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                fn()
            side.synchronize()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            before = {k: f.launches for k, f in wrappers.items()}
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, stream=side,
                                      capture_error_mode="thread_local"):
                    out = fn()
            finally:
                self._launches = {k: f.launches - before[k]
                                  for k, f in wrappers.items()}
                for k, f in wrappers.items():
                    f.launches = before[k]
            torch.cuda.synchronize(dev)
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self._graph, self.out = graph, out
        self.capture_s = time.perf_counter() - t0

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            self._graph.replay()
        for k, f in kernel_wrappers().items():
            f.launches += self._launches[k]


class CompiledStep:
    """``step_fn(tensors, windows, frame_idx0)`` for one plan over
    ``blocks`` blocks on ``device``, one call on the stacked windows: one
    CUDA graph captured at construction, or on the CPU the eager call on
    the same static inputs.

    ``capture_s`` is the warm-up and capture time on the host clock and
    ``pool_bytes`` the device memory that the graph's private pool
    reserved (both 0 on the CPU)."""

    def __init__(self, step_fn, tensors, plan, device, blocks: int = 1):
        self.device = torch.device(device)
        self.blocks = blocks
        self._step_fn = step_fn
        self._tensors = tensors
        self._sizes = [187 + pp.ts_bytes_in for pp in plan.plps]
        self.windows = [torch.zeros((blocks, n), dtype=torch.uint8,
                                    device=self.device)
                        for n in self._sizes]
        self.frame_idx = torch.zeros(blocks, dtype=torch.int64,
                                     device=self.device)
        self.capture_s = 0.0
        self.pool_bytes = 0
        self._graph = None
        if self.device.type != "cuda":
            self._host, self._host_idx = self.windows, self.frame_idx
            return
        # pinned staging: the host rows reach the static inputs by
        # asynchronous copies, so the host does not wait for the card
        self._host = [torch.empty((blocks, n), dtype=torch.uint8,
                                  pin_memory=True) for n in self._sizes]
        self._host_idx = torch.empty(blocks, dtype=torch.int64,
                                     pin_memory=True)
        self._staged = torch.cuda.Event()
        self._graph = Graph(self._run, self.device)
        self._out = self._graph.out
        self.capture_s = self._graph.capture_s
        self.pool_bytes = self._graph.pool_bytes

    def _run(self) -> torch.Tensor:
        """The step function on the static inputs, every block at once:
        (blocks, B, samples, 2)."""
        ws = self.windows
        return self._step_fn(self._tensors, ws if len(ws) > 1 else ws[0],
                             self.frame_idx)

    def host_inputs(self) -> tuple:
        """The host rows of the next step, to write in place: one
        (blocks, 187 + fresh bytes) uint8 array a PLP and the (blocks,)
        int64 frame indices.  On a card they are pinned, and this first
        waits until the previous step's copies have read them; ``upload``
        then sends them.  On the CPU they are the static inputs."""
        with span("compiled.wait"):
            if self._graph is not None:
                self._staged.synchronize()
        return [h.numpy() for h in self._host], self._host_idx.numpy()

    def upload(self, plps=None) -> None:
        """Send the host rows written since ``host_inputs`` to the card:
        the frame indices and the windows of ``plps`` (default every PLP),
        one asynchronous copy each.  Nothing to do on the CPU."""
        with span("compiled.upload"):
            if self._graph is None:
                return
            plps = range(len(self._sizes)) if plps is None else plps
            with torch.cuda.device(self.device):
                for p in plps:
                    self.windows[p].copy_(self._host[p], non_blocking=True)
                self.frame_idx.copy_(self._host_idx, non_blocking=True)
                self._staged.record(torch.cuda.current_stream(self.device))

    def stage(self, windows, frame_idx) -> None:
        """Write one step's inputs: ``windows``, one a PLP, each (blocks,
        187 + fresh bytes) uint8 as a host array or a tensor (a tensor is
        copied on the device), and the blocks' first T2 frame indices."""
        if len(windows) != len(self.windows):
            raise ValueError(f"{len(windows)} windows for "
                             f"{len(self.windows)} PLPs")
        for w, n in zip(windows, self._sizes):
            if tuple(w.shape) != (self.blocks, n):
                raise ValueError(f"window of shape {tuple(w.shape)}, "
                                 f"expected ({self.blocks}, {n})")
        if len(frame_idx) != self.blocks:
            raise ValueError(f"{len(frame_idx)} frame indices for "
                             f"{self.blocks} blocks")
        rows, idx = self.host_inputs()
        with span("compiled.stage"):
            idx[:] = frame_idx
            hosted = []
            for p, (d, row, w) in enumerate(zip(self.windows, rows,
                                                windows)):
                if torch.is_tensor(w):
                    d.copy_(w)
                else:
                    np.copyto(row, w, casting="no")
                    hosted.append(p)
        self.upload(hosted)

    def replay(self) -> torch.Tensor:
        """The step on the staged inputs: (blocks, B, samples, 2) f32 I/Q,
        block i from row i of the static inputs; on a card a copy of the
        graph's output, which no later step writes."""
        with span("compiled.launch"):
            if self._graph is None:
                return self._run()
            self._graph.replay()
            with torch.cuda.device(self.device):
                return self._out.clone()

    def __call__(self, windows, frame_idx) -> torch.Tensor:
        self.stage(windows, frame_idx)
        return self.replay()
