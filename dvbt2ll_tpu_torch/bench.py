"""Throughput of the transmit chain on one CUDA card: the twin of the JAX
package's ``bench.py``.

    python -m dvbt2ll_tpu_torch.bench [batch] [steps] [config] [--device cuda|cpu]

Defaults: 256 frames a step, 50 steps, vv009_4kshort (configs by
``config.named_config``).  Four rotating pre-carried TS windows, one per
PLP a step, each starting with the previous window's last 187 bytes
(``staged_windows``), are put on the device first.  The transmitter's
compiled step (``compiled.CompiledStep``, as ``bench.py`` times the JAX
``tx._step``) runs on them: two warm-up calls, then ``steps`` calls
fenced by ``torch.cuda.synchronize()``; no output is kept, so the caching
allocator reuses one step's memory for the next.  Then the eager step
function the same way.  Every step is its own phase-0 stream
(``allow_phase_drift``): a throughput measurement, not one valid
continuous stream.

Prints the card's name and power limit, then one JSON line with
``bench.py``'s ``metric``, ``value`` (Msamples/s of the compiled step),
``unit`` and ``vs_baseline`` (the real-time factor against the reference
app's 8e6 * 8 / 7 samples/s), plus ``device`` (the card line),
``ms_per_step``, ``step_device_msamples_s`` and ``step_device_ms_per_step``
(the same windows' fresh bytes through ``Transmitter.step_device``, host
staging and host-to-device copy included, fenced the same way), the
kernel launches of the timed compiled loop, the capture's time and pool
memory, and under ``eager_`` names the same readings of the eager step
(``eager_step_device_*``: ``step_device``'s host work before the compiled
step, a pageable window copy and the eager step function).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .config import named_config
from .io import synthetic_ts
from .pipeline import Transmitter
from .tools import device_line, kernel_launches, launches_since, open_device
from .tools import sync

BASELINE_SAMP_RATE = 8e6 * 8 / 7   # the reference app's samp_rate
WINDOWS = 4


def staged_windows(tx: Transmitter, device) -> tuple:
    """``WINDOWS`` steps of TS, as ``bench.py`` makes them: step s, PLP i
    is ``synthetic_ts(n_i, seed=16 s + i)`` behind the previous window's
    last 187 bytes (zeros before the first).  Returns (windows on
    ``device``, fresh host bytes), each a step's array, or its list of
    per-PLP arrays for a multi-PLP config."""
    per_plp = tx.bytes_per_step_per_plp
    carries = [np.zeros(187, np.uint8) for _ in per_plp]
    windows, fresh = [], []
    for s in range(WINDOWS):
        step_w, step_f = [], []
        for i, n in enumerate(per_plp):
            ts = synthetic_ts(n, seed=16 * s + i)
            padded = np.concatenate([carries[i], ts])
            carries[i] = padded[-187:]
            step_w.append(torch.from_numpy(padded).to(device))
            step_f.append(ts)
        windows.append(step_w if len(step_w) > 1 else step_w[0])
        fresh.append(step_f if len(step_f) > 1 else step_f[0])
    return windows, fresh


def _timed(step, windows, steps: int, device) -> tuple:
    """Seconds for ``steps`` calls of ``step(window)`` over the rotating
    ``windows``, after two warm-up calls, fenced; and their launches."""
    step(windows[0])
    step(windows[1])
    sync(device)
    before = kernel_launches()
    t0 = time.perf_counter()
    for i in range(steps):
        step(windows[i % WINDOWS])
    sync(device)
    return time.perf_counter() - t0, launches_since(before)


def _as_list(w) -> list:
    return w if isinstance(w, list) else [w]


def eager_step_device(tx: Transmitter):
    """``step_device``'s host work as it was before the compiled step, on
    the eager step function: the carry and the fresh bytes concatenated,
    a pageable copy to the device, the step (frame index 0, drift mode).
    Returns ``step(fresh)``."""
    carries = [np.zeros(187, np.uint8) for _ in tx.plan.plps]

    def step(fresh):
        ws = []
        for i, ts in enumerate(_as_list(fresh)):
            w = np.concatenate([carries[i], ts])
            carries[i] = w[-187:]
            ws.append(torch.tensor(w, device=tx.device))
        return tx._step_fn(tx.tensors, ws if len(ws) > 1 else ws[0], 0)

    return step


def run(batch: int, steps: int, name: str, device) -> dict:
    """The staged loop and the ``step_device`` loop on ``device``, the
    compiled step and then the eager one; the JSON line's fields."""
    cfg = named_config(name)
    tx = Transmitter(cfg, batch, strict=False, allow_phase_drift=True,
                     device=device)
    windows, fresh = staged_windows(tx, device)
    dt, launches = _timed(
        lambda w: tx._compiled([x[None] for x in _as_list(w)], [0]),
        windows, steps, device)
    dt_eager, _ = _timed(lambda w: tx._step_fn(tx.tensors, w, 0), windows,
                         steps, device)
    dt_host, _ = _timed(tx.step_device, fresh, steps, device)
    dt_host_eager, _ = _timed(eager_step_device(tx), fresh, steps, device)

    samples = steps * batch * cfg.samples_per_frame
    rate = samples / dt
    return {
        "metric": f"{name}_throughput",
        "value": round(rate / 1e6, 1),
        "unit": "Msamples/s/chip",
        "vs_baseline": round(rate / BASELINE_SAMP_RATE, 1),
        "device": device_line(device),
        "batch": batch, "steps": steps,
        "ms_per_step": dt / steps * 1e3,
        "step_device_msamples_s": samples / dt_host / 1e6,
        "step_device_ms_per_step": dt_host / steps * 1e3,
        "launches": launches,
        "capture_s": tx._compiled.capture_s,
        "pool_bytes": tx._compiled.pool_bytes,
        "eager_msamples_s": samples / dt_eager / 1e6,
        "eager_ms_per_step": dt_eager / steps * 1e3,
        "eager_step_device_msamples_s": samples / dt_host_eager / 1e6,
        "eager_step_device_ms_per_step": dt_host_eager / steps * 1e3,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=256)
    ap.add_argument("steps", nargs="?", type=int, default=50)
    ap.add_argument("config", nargs="?", default="vv009_4kshort")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; a missing CUDA "
                         "device is an error)")
    args = ap.parse_args(argv)
    device = open_device(args.device)
    print(device_line(device), flush=True)
    print(json.dumps(run(args.batch, args.steps, args.config, device)),
          flush=True)


if __name__ == "__main__":
    main()
