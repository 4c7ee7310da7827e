"""Single-T2-frame latency (BASELINE metric: T2-frame latency): the twin
of the JAX package's ``tools/bench_latency.py``.

    python -m dvbt2ll_tpu_torch.tools.bench_latency [config ...] [--device cuda|cpu]

For each config (default vv009_4kshort, 8k_normal, 32k_extended and
multiplp_fef) a ``Transmitter`` of one frame (``strict=False``) runs its
compiled step (``compiled.CompiledStep``, as the JAX tool times
``tx._step``) on a pre-carried window already on the device, then its
eager step function the same way.  Two readings of each:

* 50 calls back to back with one ``torch.cuda.synchronize()`` at the
  end, as the JAX tool times them: the time a frame at batch 1, which is
  batch-1 throughput;
* 200 calls each timed alone, from its enqueue to the ``synchronize``
  after it: the latency a T2 frame sees, as median and maximum.

Each against the config's air time of a frame (``cfg.frame_duration``).
Prints the card's name and power limit, then per config the JAX tool's
line, a per-call line, the eager step's line and one JSON line (the
compiled step's readings, its launches, and ``eager_`` ones).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import named_config
from ..io import synthetic_ts
from ..pipeline import Transmitter
from . import device_line, kernel_launches, launches_since, open_device, sync

CONFIGS = ("vv009_4kshort", "8k_normal", "32k_extended", "multiplp_fef")


def _readings(step, device, iters: int, calls: int) -> dict:
    """One warm-up call (allocations, cuFFT plans), then ``iters`` calls
    back to back and ``calls`` calls each fenced alone; and the launches
    of both."""
    step()
    sync(device)
    before = kernel_launches()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    sync(device)
    lat_ms = (time.perf_counter() - t0) / iters * 1e3
    per_call = []
    for _ in range(calls):
        t0 = time.perf_counter()
        step()
        sync(device)
        per_call.append((time.perf_counter() - t0) * 1e3)
    return {"frame_latency_ms": lat_ms,
            "per_call_ms_median": float(np.median(per_call)),
            "per_call_ms_max": max(per_call),
            "launches": launches_since(before)}


def measure(name: str, device, iters: int = 50, calls: int = 200) -> dict:
    cfg = named_config(name)
    tx = Transmitter(cfg, 1, strict=False, device=device)
    ws = [torch.from_numpy(np.concatenate(
        [np.zeros(187, np.uint8), synthetic_ts(n, seed=3 + i)])).to(device)
        for i, n in enumerate(tx.bytes_per_step_per_plp)]
    rows = [w[None] for w in ws]   # the compiled step's one block
    r = _readings(lambda: tx._compiled(rows, [0]), device, iters, calls)
    eager = _readings(lambda: tx._step_fn(
        tx.tensors, ws if len(ws) > 1 else ws[0], 0), device, iters, calls)
    fd_ms = cfg.frame_duration * 1e3
    return {"config": name, "batch": 1, "device": device_line(device),
            **r, "frame_duration_s": cfg.frame_duration,
            "x_realtime": fd_ms / r["frame_latency_ms"], "iters": iters,
            "per_call_x_realtime": fd_ms / r["per_call_ms_median"],
            "calls": calls, "capture_s": tx._compiled.capture_s,
            **{f"eager_{k}": v for k, v in eager.items()}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("configs", nargs="*", default=list(CONFIGS))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; a missing CUDA "
                         "device is an error)")
    args = ap.parse_args(argv)
    device = open_device(args.device)
    print(device_line(device), flush=True)
    for name in args.configs:
        r = measure(name, device)
        fd_ms = r["frame_duration_s"] * 1e3
        print(f"{name:22s} frame latency {r['frame_latency_ms']:7.3f} ms   "
              f"(frame duration {fd_ms:7.3f} ms, "
              f"{r['x_realtime']:6.1f}x real time)")
        print(f"{name:22s} per call: median {r['per_call_ms_median']:7.3f} "
              f"ms, max {r['per_call_ms_max']:7.3f} ms over {r['calls']} "
              f"calls ({r['per_call_x_realtime']:6.1f}x real time)")
        print(f"{name:22s} eager step: {r['eager_frame_latency_ms']:7.3f} "
              f"ms back to back, per call median "
              f"{r['eager_per_call_ms_median']:7.3f} ms, max "
              f"{r['eager_per_call_ms_max']:7.3f} ms")
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
