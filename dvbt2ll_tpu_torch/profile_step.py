"""Where a step's time goes on one CUDA device.

    python -m dvbt2ll_tpu_torch.profile_step

For vv009 at each batch of 64, 128, 256 and 512 frames, and 8k_normal and
32k_extended at batch 256: ``Transmitter.step_device`` timed on the host
clock and fenced (window staging and host-to-device copy included), the
step function alone on a window already on the device (CUDA events), and
the peak device memory.  Then, at batch 256, each part of the device step
alone (CUDA events): for vv009 and 8k_normal (the planar tail)
``bb_and_fec``, ``map_cells_planes``, the rest of the frame builder, and
the fused OFDM tail kernel, P1 and the final I/Q included (and its plain
twin on the same grids); for 32k_extended (the complex tail) ``bb_and_fec``,
``map_cells``, ``build_frames``, the ``torch.fft`` tail with its guard
interval, and P1 with ``view_as_real``.  Then a ``torch.profiler`` table
of device time by operator over 5 vv009 ``step_device`` steps, and
``StreamingExecutor`` at vv009 batch 256 under ``profile_trace``: its
wall time against the device time of its kernels and of its copies.  Then
BASELINE config 5: 8 vv009 muxes through a ``ShardedTransmitter`` of 16
slots of the card (and, with several cards, of all of them in turn) beside
one ``Transmitter`` of the same 752 frames a step: wall time, and device
time under ``torch.profiler``.  The ratio of the device step to
``step_device`` is printed as an estimate of the device's busy share: two
clocks, not a trace.

    python -m dvbt2ll_tpu_torch.profile_step --ab PARENT

compares this checkout with another one of the port (an unpacked earlier
commit) on the same card instead, in turns (parent, this, this, parent),
each in its own process from its own root: at vv009 and 8k_normal batch
256, the LDPC step from (F, nbch) bits to the (F, nldpc) codeword (kernel
plus ``cat`` where the checkout has the parity kernel), the planar tail
from the grids to the final I/Q (``pipeline.ofdm_tail``) and the whole
device step, CUDA events over 20 calls each.
"""
import inspect
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import (StreamingExecutor, Transmitter, min_batch_frames,
               named_config, synthetic_ts)
from .observability import profile_trace
from .ops.ifft import ofdm_tail_plain
from .pipeline import (bb_and_fec, build_frames, frame_grids, map_cells,
                       map_cells_planes, modulate, ofdm_symbols, ofdm_tail,
                       transmit_step_iq, transmit_step_iq_planar)

BATCHES = (64, 128, 256, 512)
BATCH = 256            # the JAX package's bench default (bench.py:174)
STEPS = 20


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = STEPS) -> float:
    """Mean device milliseconds per call, after a warm-up, fenced.  The
    timed calls are queued behind a spin kernel that outlasts their
    launches, so the events measure the card's time, not the host's
    launch rate (a kernel of tens of microseconds takes the host about
    as long to launch from Python)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call_s = (time.perf_counter() - t0) / 3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # cycles at up to 2 GHz for twice the time the host takes to enqueue
    torch.cuda._sleep(int(2e9 * (2 * iters * per_call_s + 1e-3)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _setup(name: str, batch: int):
    """A batch-``batch`` transmitter of ``name`` on the card, 4 TS steps,
    and the first as a pre-carried window on the device.  Each step is
    its own phase-0 stream (allow_phase_drift), as in chip_smoke.py."""
    tx = Transmitter(named_config(name), batch, strict=False,
                     allow_phase_drift=True, device="cuda")
    ts = [synthetic_ts(tx.bytes_per_step, seed=i) for i in range(4)]
    window = torch.from_numpy(
        np.concatenate([np.zeros(187, np.uint8), ts[0]])).cuda()
    return tx, ts, window


def sweep(name: str, batch: int) -> None:
    torch.cuda.reset_peak_memory_stats()
    tx, ts, window = _setup(name, batch)
    samples = batch * tx.cfg.samples_per_frame
    for i in range(3):
        tx.step_device(ts[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(STEPS):
        tx.step_device(ts[i % 4])
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / STEPS * 1e3
    dev_ms = cuda_ms(lambda: tx._step_fn(tx.tensors, window, 0))
    print(f"{name} batch {batch}: step_device {host_ms:.3f} ms = "
          f"{samples / host_ms / 1e3:.1f} Msamples/s; device step "
          f"{dev_ms:.3f} ms = {samples / dev_ms / 1e3:.1f} Msamples/s; "
          f"busy share estimate {dev_ms / host_ms:.3f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")


def stages(name: str, batch: int) -> None:
    tx, _, window = _setup(name, batch)
    cfg, tp = tx.cfg, tx.tensors
    pt = tp.plps[0]
    bits = bb_and_fec(pt, window)
    fec = cuda_ms(lambda: bb_and_fec(pt, window))
    mapper = cuda_ms(lambda: map_cells_planes(pt, bits))
    grids = cuda_ms(lambda: frame_grids(tp, window, 0))
    g_re, g_im = frame_grids(tp, window, 0)
    tail = cuda_ms(lambda: ofdm_tail(tp, g_re, g_im))
    plain = cuda_ms(lambda: ofdm_tail_plain(
        g_re, g_im, tp.tail.p1_iq, cfg.fft_points, cfg.guard_samples,
        cfg.ofdm_normalization, tp.tail.ifft))
    whole = cuda_ms(lambda: transmit_step_iq_planar(tp, window, 0))
    samples = batch * cfg.samples_per_frame
    print(f"{name} batch {batch} device ms: bb_and_fec {fec:.4f}, "
          f"map_cells_planes {mapper:.4f}, rest of the frame builder "
          f"{grids - fec - mapper:.4f}, tail kernel with P1 and I/Q "
          f"{tail:.4f} (plain twin {plain:.4f}); whole step {whole:.4f} = "
          f"{samples / whole / 1e3:.1f} Msamples/s")


def stages_complex(name: str, batch: int) -> None:
    tx, _, window = _setup(name, batch)
    tp = tx.tensors
    pt = tp.plps[0]
    bits = bb_and_fec(pt, window)
    fec = cuda_ms(lambda: bb_and_fec(pt, window))
    mapper = cuda_ms(lambda: map_cells(pt, bits))
    payload = map_cells(pt, bits).reshape(batch, -1)
    frames = cuda_ms(lambda: build_frames(tp, payload, 0))
    grids = build_frames(tp, payload, 0)
    tail = cuda_ms(lambda: ofdm_symbols(tp, grids))
    after = cuda_ms(lambda: torch.view_as_real(modulate(tp, grids)))
    whole = cuda_ms(lambda: transmit_step_iq(tp, window, 0))
    samples = batch * tx.cfg.samples_per_frame
    print(f"{name} batch {batch} device ms: bb_and_fec {fec:.4f}, "
          f"map_cells {mapper:.4f}, build_frames {frames:.4f}, torch.fft "
          f"tail with GI {tail:.4f}, P1 + view_as_real {after - tail:.4f}; "
          f"whole step {whole:.4f} = {samples / whole / 1e3:.1f} "
          f"Msamples/s")


def executor_trace(name: str, batch: int, steps: int = 10) -> None:
    """``StreamingExecutor`` under ``profile_trace``: wall time against
    the device time of the kernels and of the memory copies.  Kernel
    plus copy time above the wall time means the copies overlapped the
    compute."""
    tx, ts, _ = _setup(name, batch)
    k = {"i": 0}

    def source(nbytes):
        k["i"] += 1
        return ts[k["i"] % 4]

    ex = StreamingExecutor(tx, source)
    ex.step()
    ex.flush()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as logdir:
        with profile_trace(logdir) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                ex.step()
            ex.flush()
            wall = (time.perf_counter() - t0) * 1e3
        files = os.listdir(logdir)
        size = sum(os.path.getsize(os.path.join(logdir, f)) for f in files)
    kern, copy = _device_ms(prof)
    samples = steps * batch * tx.cfg.samples_per_frame
    print(f"executor {name} batch {batch}, {steps} steps under "
          f"profile_trace ({len(files)} trace file, {size} bytes): wall "
          f"{wall:.3f} ms = {samples / wall / 1e3:.1f} Msamples/s; device "
          f"kernels {kern:.3f} ms, memory copies {copy:.3f} ms; busy share "
          f"of kernels {kern / wall:.3f}, of copies {copy / wall:.3f}")


def _device_ms(prof) -> tuple:
    """(kernel ms, memory-copy ms) of the device activity in a profile."""
    kern = copy = 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host operators: their kernels are counted here
        ms = ev.self_device_time_total / 1e3
        if ev.key.startswith("Memcpy"):
            copy += ms
        else:
            kern += ms
    return kern, copy


def sharded_trace(cards: int = 1, steps: int = 10, n_mux: int = 8) -> None:
    """BASELINE config 5: vv009 as ``n_mux`` strict muxes over a (n_mux,
    2) ``ShardedTransmitter`` mesh whose slots take the first ``cards``
    cards in turn, 47 frames a block, against one ``Transmitter`` of the
    same frames a step on the first card.  Each runs ``steps`` fenced
    ``step_device`` steps on the host clock, then again under
    ``torch.profiler`` for its device kernel and copy time, the host's
    graph launches and CUDA runtime calls a step
    (``tools.host_api_calls``) and the kernel wrappers' launches a step
    (a card's blocks are one batched call: each kernel once a card); that
    device time over the unprofiled wall time and the card count is the
    busy share estimate a card."""
    from .parallel import ShardedTransmitter, make_mesh
    from .tools import host_api_calls, kernel_launches, launches_since
    cfg = named_config("vv009_4kshort")
    b = min_batch_frames(cfg)
    devs = [torch.device("cuda", i) for i in range(cards)]
    slots = [devs[i % cards] for i in range(2 * n_mux)]
    stx = ShardedTransmitter(cfg, make_mesh(slots, mux=n_mux), n_mux=n_mux,
                             frames_per_shard=b)
    frames = n_mux * stx.frames_per_step
    one = Transmitter(cfg, frames, strict=True, device=devs[0])
    n = stx.bytes_per_step_per_mux
    ts = synthetic_ts(n_mux * n, seed=3).reshape(n_mux, n)
    runs = ((f"sharded over {cards} card(s)", cards,
             lambda: stx.step_device(ts)),
            ("one Transmitter", 1, lambda: one.step_device(ts.reshape(-1))))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def fenced(step):
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        for d in devs:
            torch.cuda.synchronize(d)
        return (time.perf_counter() - t0) * 1e3

    samples = steps * frames * cfg.samples_per_frame
    for label, n_cards, step in runs:
        fenced(step)  # warm-up: each card's first steps load libraries
        wall = fenced(step)
        before = kernel_launches()
        with torch.profiler.profile(activities=acts) as prof:
            prof_wall = fenced(step)
        kernels = {k: v / steps for k, v in launches_since(before).items()}
        kern, copy = _device_ms(prof)
        calls = host_api_calls(prof, steps)
        print(f"vv009 x {n_mux} muxes, {label} ({frames} frames a step), "
              f"{steps} steps: wall {wall:.3f} ms = "
              f"{samples / wall / 1e3:.1f} Msamples/s; under torch.profiler "
              f"wall {prof_wall:.3f} ms, device kernels {kern:.3f} ms, "
              f"memory copies {copy:.3f} ms; busy share estimate a card "
              f"{(kern + copy) / wall / n_cards:.3f}; a step "
              f"{calls['cudaGraphLaunch']:g} graph launches, host CUDA "
              f"calls {calls}, kernel launches {kernels}")


def operators(name: str, batch: int) -> None:
    tx, ts, _ = _setup(name, batch)
    for i in range(3):
        tx.step_device(ts[i])
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(5):
            tx.step_device(ts[i % 4])
        torch.cuda.synchronize()
    print(f"{name} batch {batch}, 5 step_device steps under torch.profiler:")
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=25, max_name_column_width=60))


# run in each checkout's root by ``ab``: only names every version of the
# port has, or checked for, and this checkout's ``cuda_ms`` for both
_AB_SNIPPET = r"""
import json, sys, time
import numpy as np, torch
from dvbt2ll_tpu_torch import Transmitter, named_config, synthetic_ts
from dvbt2ll_tpu_torch import pipeline
from dvbt2ll_tpu_torch.ops import ldpc
STEPS = %d
%s
res = {}
for name in ("vv009_4kshort", "8k_normal"):
    tx = Transmitter(named_config(name), 256, strict=False,
                     allow_phase_drift=True, device="cuda")
    tp = tx.tensors
    pt = tp.plps[0]
    window = torch.from_numpy(np.concatenate(
        [np.zeros(187, np.uint8),
         synthetic_ts(tx.bytes_per_step, seed=0)])).cuda()
    frame = pipeline.bb_and_fec(pt, window)
    nbch = frame[:, :pt.pp.cfg.nbch].contiguous()
    if hasattr(ldpc, "ldpc_codeword"):
        fec = lambda: ldpc.ldpc_codeword(pt.ldpc, nbch)
    else:
        fec = lambda: torch.cat([nbch, ldpc.qc_ldpc_parity(pt.ldpc, nbch)],
                                dim=1)
    assert torch.equal(fec(), frame)
    g_re, g_im = pipeline.frame_grids(tp, window, 0)
    res[name] = {
        "frames": nbch.shape[0],
        "ldpc_codeword_ms": cuda_ms(fec),
        "tail_with_p1_iq_ms": cuda_ms(
            lambda: pipeline.ofdm_tail(tp, g_re, g_im)),
        "device_step_ms": cuda_ms(lambda: tx._step_fn(tp, window, 0))}
print(json.dumps(res))
"""


def ab(parent: str, rounds: int = 2) -> None:
    """This checkout against ``parent`` (another checkout's root), in
    turns on the same card; one JSON line a run."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    order = [("parent", parent), ("change", here)]
    snippet = _AB_SNIPPET % (STEPS, inspect.getsource(cuda_ms))
    runs = []
    for r in range(rounds):
        runs += order if r % 2 == 0 else order[::-1]
    for label, root in runs:
        res = subprocess.run(
            [sys.executable, "-c", snippet], cwd=root,
            env=dict(os.environ, PYTHONPATH=os.path.abspath(root)),
            capture_output=True, text=True, timeout=600)
        if res.returncode:
            raise RuntimeError(f"ab {label}: rc {res.returncode}\n"
                               f"{res.stderr}")
        print(f"ab {label} {res.stdout.strip().splitlines()[-1]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    print(card_line())
    if sys.argv[1:2] == ["--ab"]:
        ab(sys.argv[2])
        return 0
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    for batch in BATCHES:
        sweep("vv009_4kshort", batch)
    sweep("8k_normal", BATCH)
    sweep("32k_extended", BATCH)
    for name in ("vv009_4kshort", "8k_normal"):
        stages(name, BATCH)
    stages_complex("32k_extended", BATCH)
    operators("vv009_4kshort", BATCH)
    executor_trace("vv009_4kshort", BATCH)
    sharded_trace()
    if torch.cuda.device_count() > 1:
        sharded_trace(torch.cuda.device_count())
    return 0


if __name__ == "__main__":
    sys.exit(main())
