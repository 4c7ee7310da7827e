"""Scaling of the frame-sharded step on the port's multi-device layer: the
twin of the JAX package's ``tools/bench_scaling.py``.

    python -m dvbt2ll_tpu_torch.tools.bench_scaling [--device cuda|cpu] [--parts ABC] [--frames 16] [--steps 10]

Three parts, each under its own time limit:

  A. Strong scaling: the same ``frames`` vv009 frames (drift mode) to a
     ``ShardedTransmitter`` over 1, 2, 4 and 8 frame slots of
     ``--device`` (slots of one card share its stream and are one
     compiled step, one CUDA graph of one batched call, so each kernel
     launches once a card a step), wall ms a step and speed-up; then
     ``API_STEPS`` more steps under ``torch.profiler`` for the host's
     graph launches and CUDA runtime calls a step (``host_api_calls``).  The blocks are held bit for bit: each against the
     single-chain ``Transmitter`` stepping the same halo window at the
     same per-call batch (the JAX package's invariant), and shard 0,
     which starts at TS phase 0 in every layout, against the first slot
     count's shard 0 on the frames both hold.  Later shards restart at
     phase 0 in drift mode,
     so their bits depend on where the shard starts (vv009's smallest
     packet-aligned shard is 47 frames).
  B. Copy audit, the counterpart of the JAX collective audit of compiled
     HLO: one 8-slot sharded step under ``torch.profiler``, its memory
     copies between two different devices counted (peer-to-peer), and
     the host's graph launches and CUDA runtime calls.  The count of peer
     copies must be 0; on one card it is 0 by construction.
  C. Multi-process efficiency: the same step as 1 process x 8 slots
     against 2 processes x 4 slots joined by ``torch.distributed`` (gloo,
     a localhost rendezvous, ``dryrun.run_workers``), wall time over the
     same steps; efficiency = t_single / t_multi.  Two processes on one
     card time-slice it.

Prints the card's name and power limit, then one JSON object.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import time

import numpy as np
import torch

from ..config import vv009_config
from ..dryrun import N_PROCS, SLOTS_PER_PROC, process_group, run_workers
from ..io import synthetic_ts
from ..parallel import ShardedTransmitter, halo_windows, make_mesh
from ..pipeline import Transmitter
from . import device_line, host_api_calls, kernel_launches, launches_since
from . import open_device, sync

TOTAL_FRAMES = 16
STEPS = 10
API_STEPS = 3          # profiled steps a slot count for the host's calls
LIMITS = {"A": 300.0, "B": 120.0, "C": 300.0}   # seconds a part


@contextlib.contextmanager
def time_limit(seconds: float, what: str):
    """Raise TimeoutError in the main thread when the block runs over
    ``seconds``."""
    def expire(signum, frame):
        raise TimeoutError(f"{what} ran over {seconds:.0f} s")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, prev)


def _sharded(slots: list, frames: int):
    """vv009 over ``slots`` (mux 1), ``frames`` frames a step in drift
    mode, and one step of TS."""
    cfg = vv009_config()
    stx = ShardedTransmitter(cfg, make_mesh(slots, mux=1), n_mux=1,
                             frames_per_shard=frames // len(slots),
                             strict=False, allow_phase_drift=True)
    ts = synthetic_ts(stx.bytes_per_step_per_mux, seed=3)[None]
    return cfg, stx, ts


def _sync(devices) -> None:
    for d in {torch.device(d) for d in devices}:
        sync(d)


def _activities(dev: torch.device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _timed(stx, ts, steps: int) -> float:
    """Seconds for ``steps`` sharded steps, fenced."""
    devices = stx.mesh.local_devices()
    _sync(devices)
    t0 = time.perf_counter()
    for _ in range(steps):
        stx.step_device(ts)
    _sync(devices)
    return time.perf_counter() - t0


def strong(device, slot_counts=(1, 2, 4, 8), frames: int = TOTAL_FRAMES,
           steps: int = STEPS) -> list:
    """Part A; one dict a slot count."""
    rows, first = [], None
    for n in slot_counts:
        cfg, stx, ts = _sharded([device] * n, frames)
        out = stx.step_device(ts)   # the first step: checked, not timed
        per = frames // n
        seq = Transmitter(cfg, per, strict=False, allow_phase_drift=True,
                          device=device)
        windows = halo_windows(ts, np.zeros((1, 187), np.uint8), n)
        for s in range(n):
            if not torch.equal(out[0][s], seq.step_window(windows[0, s])):
                raise RuntimeError(f"{n} slots: block {s} differs from the "
                                   f"sequential Transmitter")
        if first is None:
            first = out[0][0]
        k = min(per, first.shape[0])
        if not torch.equal(out[0][0][:k], first[:k]):
            raise RuntimeError(f"{n} slots: shard 0's first {k} frames "
                               f"differ from the first slot count's")
        before = kernel_launches()
        dt = _timed(stx, ts, steps)
        launches = launches_since(before)
        with torch.profiler.profile(
                activities=_activities(torch.device(device))) as prof:
            _timed(stx, ts, API_STEPS)
        calls = host_api_calls(prof, API_STEPS)
        rows.append({"slots": n, "frames_per_slot": per,
                     "wall_ms_per_step": dt / steps * 1e3,
                     "msamp_s": steps * frames * cfg.samples_per_frame
                     / dt / 1e6,
                     "launches": launches,
                     "graph_launches_per_step": calls["cudaGraphLaunch"],
                     "api_calls_per_step": calls})
    for r in rows:
        r["speedup"] = rows[0]["wall_ms_per_step"] / r["wall_ms_per_step"]
    return rows


def copy_audit(device, slots: int = 8, frames: int = TOTAL_FRAMES) -> dict:
    """Part B: one sharded step under torch.profiler; its copies between
    two different devices.  With several cards the slots take them in
    turn."""
    dev = torch.device(device)
    cards = ([torch.device("cuda", i)
              for i in range(torch.cuda.device_count())]
             if dev.type == "cuda" else [dev])
    _, stx, ts = _sharded([cards[i % len(cards)] for i in range(slots)],
                          frames)
    stx.step_device(ts)
    _sync(cards)
    with torch.profiler.profile(activities=_activities(dev)) as prof:
        stx.step_device(ts)
        _sync(cards)
    events = prof.key_averages()
    memcpy = {e.key: e.count for e in events if e.key.startswith("Memcpy")}
    peer = sum(c for k, c in memcpy.items() if "PtoP" in k)
    calls = host_api_calls(prof, 1)
    return {"slots": slots, "cards": len(cards) if dev.type == "cuda" else 0,
            "device_us": sum(e.self_device_time_total for e in events),
            "memcpy": memcpy, "peer_copies": peer,
            "graph_launches": calls["cudaGraphLaunch"], "api_calls": calls}


def _rate(cfg, frames: int, steps: int, dt: float) -> float:
    return steps * frames * cfg.samples_per_frame / dt / 1e6


def multiprocess(device, frames: int = TOTAL_FRAMES, steps: int = STEPS,
                 timeout: float = LIMITS["C"]) -> dict:
    """Part C: 1 process x 8 slots here, then 2 worker processes x 4."""
    n = N_PROCS * SLOTS_PER_PROC
    cfg, stx, ts = _sharded([device] * n, frames)
    stx.step_device(ts)
    dt = _timed(stx, ts, steps)
    single = {"slots": n, "wall_s": dt, "msamp_s": _rate(cfg, frames,
                                                         steps, dt)}
    said = run_workers(
        ["dvbt2ll_tpu_torch.tools.bench_scaling", "--role", "worker",
         "--device", device, "--frames", frames, "--steps", steps],
        timeout, "bench_scaling part C")
    multi = json.loads([ln for ln in said[0].splitlines()
                        if ln.startswith("{")][-1])
    return {"single_process": single, "two_process": multi,
            "efficiency": single["wall_s"] / multi["wall_s"]}


def _worker(device, frames: int, steps: int, rank: int, port: int) -> None:
    """One process of part C: SLOTS_PER_PROC slots of the global mesh.
    The processes start their timed steps together (a barrier); the
    slowest one's time is the step's."""
    with process_group(rank, port) as dist:
        cfg, stx, ts = _sharded([device] * SLOTS_PER_PROC, frames)
        if stx.mesh.world != N_PROCS:
            raise RuntimeError(f"mesh over {stx.mesh.world} processes")
        stx.step_device(ts)
        _sync(stx.mesh.local_devices())
        dist.barrier()
        dt = _timed(stx, ts, steps)
        walls = [None] * N_PROCS if rank == 0 else None
        dist.gather_object(dt, walls, dst=0)
        if rank == 0:
            wall = max(walls)
            print(json.dumps({"procs": N_PROCS, "slots_per_proc":
                              SLOTS_PER_PROC, "wall_s": wall,
                              "wall_s_by_rank": walls,
                              "msamp_s": _rate(cfg, frames, steps, wall)}),
                  flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of every slot (default cuda; a "
                         "missing CUDA device is an error)")
    ap.add_argument("--parts", default="ABC")
    ap.add_argument("--frames", type=int, default=TOTAL_FRAMES)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--role", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    device = open_device(args.device)
    if args.role == "worker":
        _worker(device, args.frames, args.steps, args.rank, args.port)
        return
    print(device_line(device), flush=True)
    res = {"device": device_line(device), "host_cores": os.cpu_count(),
           "frames": args.frames, "steps": args.steps}
    if "A" in args.parts:
        with time_limit(LIMITS["A"], "bench_scaling part A"):
            res["strong"] = strong(device, frames=args.frames,
                                   steps=args.steps)
    if "B" in args.parts:
        with time_limit(LIMITS["B"], "bench_scaling part B"):
            res["copy_audit"] = copy_audit(device, frames=args.frames)
        if res["copy_audit"]["peer_copies"]:
            raise RuntimeError(f"peer-to-peer copies in a sharded step: "
                               f"{res['copy_audit']['memcpy']}")
    if "C" in args.parts:
        with time_limit(LIMITS["C"] + 30, "bench_scaling part C"):
            res["multiprocess"] = multiprocess(str(device), args.frames,
                                               args.steps)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
