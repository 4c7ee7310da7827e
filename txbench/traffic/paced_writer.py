"""The paced TS generator: its own process, writing one mux's seeded TS
into a pipe at the channel's air rate.

    python txbench/traffic/paced_writer.py --fd FD --seed S --k K
        --bytes-per-step N --step-seconds T --burst W --steps M [--chunks C]

It makes the same pool as ``ts.ts_pool(S, K, 1, N)`` and writes its
cycled stream into file descriptor FD.  The first W steps (the runtime's
warm-up) go at once.  Then it reads the start time t0 (``time.monotonic``,
which on Linux is one clock for every process) as one line from its
standard input, and writes step W + k in C chunks, chunk i at
t0 + k T + (i + 1) T / C, for M steps.  The schedule never slows: a write
that blocks makes the writer late, and every later chunk is still due at
its own time.  At the end it prints one JSON object: each paced step's
due time (when its last byte was due), when its last write returned, and
how late its writes ran.  It stops early, without error, when the
reading end is closed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from txbench.traffic.ts import ts_pool  # noqa: E402


def _write_all(fd: int, buf: memoryview) -> None:
    off = 0
    while off < len(buf):       # a pipe write may be partial
        off += os.write(fd, buf[off:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fd", type=int, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--k", type=int, required=True)
    ap.add_argument("--bytes-per-step", type=int, required=True)
    ap.add_argument("--step-seconds", type=float, required=True)
    ap.add_argument("--burst", type=int, required=True)
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--chunks", type=int, default=8)
    a = ap.parse_args(argv)
    pool = ts_pool(a.seed, a.k, 1, a.bytes_per_step)[:, 0]
    n, c, t = a.bytes_per_step, a.chunks, a.step_seconds
    bounds = [n * i // c for i in range(c + 1)]
    due, done, late = [], [], []
    try:
        for s in range(a.burst):
            _write_all(a.fd, memoryview(pool[s % a.k]))
        line = sys.stdin.readline()
        if not line:
            return 0            # the harness ended before the window
        t0 = float(line)
        for k in range(a.steps):
            data = memoryview(pool[(a.burst + k) % a.k])
            for i in range(c):
                at = t0 + k * t + (i + 1) * t / c
                wait = at - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
                _write_all(a.fd, data[bounds[i]:bounds[i + 1]])
                late.append(time.monotonic() - at)
            due.append(t0 + (k + 1) * t)
            done.append(time.monotonic())
    except BrokenPipeError:
        pass                    # the reader is done
    finally:
        try:
            os.close(a.fd)
        except OSError:
            pass
        srt = sorted(late)
        print(json.dumps({
            "steps": len(due), "due": due, "written": done,
            "late_max_ms": 1e3 * srt[-1] if srt else None,
            "late_p50_ms": 1e3 * srt[len(srt) // 2] if srt else None,
            "late_p95_ms": (1e3 * srt[int(0.95 * (len(srt) - 1))]
                            if srt else None)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
