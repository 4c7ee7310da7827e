"""Sustained streaming on one CUDA card, minutes at a time: the twin of
the JAX package's ``tools/bench_sustained.py``.

    python -m dvbt2ll_tpu_torch.tools.bench_sustained [roles] [seconds] [config] [batch] [--device cuda|cpu] [--sink PATH]

The whole runtime: a feeder thread writes a cyclic ``synthetic_ts`` into
a real ``os.pipe``, the native ingest ring (``io.ingest.TSIngest``) reads
it, a strict transmitter (``validate_ts``, batch ``min_batch_frames(cfg)``
unless one is given) steps, and the native async sink
(``io.native_sink.NativeIQSink``) writes the IQ.  Roles, run in turn:

  full    ``StreamingExecutor`` on the card: ingest ring -> step ->
          pinned device-to-host copy -> native sink.
  device  the ingest ring and the step, but the IQ stays on the card and
          one scalar a step (``.sum().item()``) comes back as
          backpressure: a card feeding a consumer on the card.
  cpu     ``full`` on the CPU, whatever ``--device`` says.
  paced   ``full`` held to the config's air rate
          (``StreamingExecutor(realtime=True)``) for
          int(seconds / (batch x emitted frame duration)) steps: the
          deployment contract.  ``paced_ok`` is lag <= one step;
          ``paced_first_late_step`` is the first step that started more
          than a step behind its air schedule, or null.

``roles`` is one role, a comma-separated list, or ``all`` (device, full,
cpu); ``seconds`` one value for every role (default 60) or one a role,
comma-separated.  The sink writes to ``--sink``, or by default to
/dev/null for the unpaced roles (the card emits gigabytes a second) and
to a temporary file for ``paced``.  One warm-up step runs before the
clock and stays out of ``steps``, ``t2_frames`` and ``msamp_per_s``;
``sink_samples`` gives its samples and the timed ones apart,
``sink_written`` counts what the sink's writer thread put out, and
``sink_file_samples`` is a regular file's size / 8.  Prints the card's
name and power limit, then one JSON line a role with the JAX tool's keys.
"""
from __future__ import annotations

import argparse
import json
import os
import stat
import tempfile
import threading
import time

import numpy as np
import torch

from ..config import named_config
from ..executor import StreamingExecutor
from ..io import synthetic_ts
from ..io.ingest import TSIngest
from ..io.native_sink import NativeIQSink
from ..observability import TxCounters
from ..pipeline import Transmitter
from ..plan import min_batch_frames
from . import device_line, kernel_launches, launches_since, open_device

REF_RATE = 8e6 * 8 / 7   # the reference app's sample rate (BASELINE.md)
ROLES = ("full", "device", "cpu", "paced")
GAIN = 0.2               # the reference app's output gain
RING_BYTES = 1 << 24
SOURCE_TIMEOUT = 60.0    # seconds the ring may take to give a window


def _feeder(write_fd: int, stop: threading.Event,
            chunk_packets: int = 4096) -> None:
    """Write a cyclic synthetic TS into the pipe as fast as it drains,
    until ``stop`` or until the reading end is closed; then close the
    writing end.  One buffer is rewritten, so making TS never holds the
    ring back (the chain's time does not depend on the payload)."""
    buf = memoryview(synthetic_ts(188 * chunk_packets, seed=7).tobytes())
    try:
        while not stop.is_set():
            off = 0
            while off < len(buf):   # os.write may be partial on a pipe
                off += os.write(write_fd, buf[off:])
    except OSError:                 # the reader closed the pipe
        pass
    finally:
        os.close(write_fd)


def _file_samples(path: str):
    """A regular file's size / 8, or None for a device such as
    /dev/null."""
    st = os.stat(path)
    return st.st_size // 8 if stat.S_ISREG(st.st_mode) else None


def run_role(role: str, seconds: float, config: str, batch=None,
             device="cuda", sink_path=None) -> dict:
    """One role for ``seconds``; the JSON line's fields."""
    if role not in ROLES:
        raise ValueError(f"role {role!r}, expected one of {ROLES}")
    dev = torch.device("cpu") if role == "cpu" else open_device(str(device))
    cfg = named_config(config)
    if len(cfg.plp_configs) > 1:
        raise SystemExit(f"{config} has {len(cfg.plp_configs)} PLPs; the "
                         f"pipe feeds one TS stream")
    if batch is None:
        # the smallest phase-invariant batch: every step continues the TS
        # packet phase, so the output is one valid continuous stream
        batch = min_batch_frames(cfg)
    tx = Transmitter(cfg, batch, strict=True, validate_ts=True, device=dev)
    n = tx.bytes_per_step

    rfd, wfd = os.pipe()
    stop = threading.Event()
    feeder = threading.Thread(target=_feeder, args=(wfd, stop), daemon=True)
    feeder.start()
    tmp = (tempfile.TemporaryDirectory()
           if sink_path is None and role == "paced" else None)
    path = sink_path or (os.path.join(tmp.name, "paced.cf32") if tmp
                         else os.devnull)
    ing = sink = None
    starts = []   # when each step asked for its TS
    try:
        ing = TSIngest(fd=rfd, capacity=RING_BYTES)
        ing.start_thread()

        def source(nbytes):
            # the ring's window carries its own 187-byte overlap; the
            # Transmitter keeps the stream state, so it takes fresh bytes
            starts.append(time.perf_counter())
            deadline = time.monotonic() + SOURCE_TIMEOUT
            while time.monotonic() < deadline:
                w = ing.window(nbytes, allow_stuffing=False)
                if w is not None:
                    return w[187:]
                time.sleep(0.0005)
            raise RuntimeError(f"the ingest ring gave no window in "
                               f"{SOURCE_TIMEOUT:.0f} s")

        if role == "device":
            def one():
                w = np.concatenate([tx._carries[0], source(n)])
                return tx.step_window(w)[..., 0].sum().item()

            one()   # warm-up, outside the clock
            tx.counters = TxCounters()
            before = kernel_launches()
            acc = 0.0
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                acc += one()
            wall = time.perf_counter() - t0
            extra = {"checksum": acc}
        else:
            sink = NativeIQSink(path, gain=GAIN)
            ex = StreamingExecutor(tx, source=source, sink=sink,
                                   realtime=role == "paced")
            ex.step()   # warm-up, outside the clock; its output is sunk
            ex.flush()
            warm = sink.samples_written
            tx.counters = TxCounters()
            before = kernel_launches()
            extra = {}
            if role == "paced":
                # emitted_frame_duration: FEF parts count toward airtime
                step_t = batch * cfg.emitted_frame_duration
                n_steps = max(1, int(seconds / step_t))
                starts.clear()
                t0 = time.perf_counter()
                ex.run(n_steps)
                sink.flush()
                wall = time.perf_counter() - t0
                lag = wall - n_steps * step_t   # > 0: behind the air
                late = [t - (t0 + k * step_t) for k, t in enumerate(starts)]
                first = next((k for k, v in enumerate(late) if v > step_t),
                             None)
                extra = {"paced_steps": n_steps, "paced_lag_s": lag,
                         # one step of slack: the pipelined drain of the
                         # last step trails its enqueue; more is underrun
                         "paced_ok": bool(lag <= step_t),
                         "paced_first_late_step": first,
                         "paced_max_start_lag_s": max(late)}
            else:
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < seconds:
                    ex.step()
                ex.flush()
                sink.flush()
                wall = time.perf_counter() - t0
            extra.update({
                "sink": path,
                "sink_samples": {"warmup": warm,
                                 "timed": sink.samples_written - warm},
                "sink_written": sink.samples_flushed,
                "producer_stalls": sink.producer_stalls})
            sink.close()
            extra["sink_file_samples"] = _file_samples(path)
        launches = launches_since(before)
        ing_stats = ing.stats   # before close() frees the native ring
    finally:
        stop.set()
        if sink is not None:
            sink.close()
        if ing is not None:
            ing.close()
        os.close(rfd)   # ends a feeder blocked on a full pipe
        feeder.join(timeout=10)
        if tmp is not None:
            tmp.cleanup()
    if feeder.is_alive():
        raise RuntimeError("the pipe feeder did not stop")

    c = tx.counters
    rate = c.samples / wall
    return {
        "role": role, "config": config, "device": device_line(dev),
        "batch": batch, "sustained_s": wall, "steps": c.steps,
        "t2_frames": c.frames, "frames_per_s": c.frames / wall,
        "msamp_per_s": rate / 1e6,
        "x_realtime": rate / REF_RATE,
        # the configured channel's own air rate (bandwidth-derived): vv009
        # is the 1.7 MHz profile at 1.845 Msamples/s; x_realtime keeps the
        # reference app's 9.143 Msamples/s clock as the yardstick
        "profile_msamp_per_s": cfg.sample_rate / 1e6,
        "x_realtime_profile": rate / cfg.sample_rate,
        "ts_mbyte_per_s": c.ts_bytes / wall / 1e6,
        "sync_errors": c.sync_errors,
        "ingest": ing_stats, "launches": launches, **extra,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roles", nargs="?", default="all",
                    help=f"all, or some of {','.join(ROLES)}")
    ap.add_argument("seconds", nargs="?", default="60",
                    help="one for every role, or one a role")
    ap.add_argument("config", nargs="?", default="vv009_4kshort")
    ap.add_argument("batch", nargs="?", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of every role but cpu (default "
                         "cuda; a missing CUDA device is an error)")
    ap.add_argument("--sink", default=None,
                    help="file the sink writes (default: /dev/null, and a "
                         "temporary file for paced)")
    args = ap.parse_args(argv)
    roles = (["device", "full", "cpu"] if args.roles == "all"
             else args.roles.split(","))
    unknown = sorted(set(roles) - set(ROLES))
    if unknown:
        ap.error(f"unknown roles {unknown}")
    secs = [float(s) for s in args.seconds.split(",")]
    if len(secs) == 1:
        secs *= len(roles)
    if len(secs) != len(roles):
        ap.error(f"{len(secs)} durations for {len(roles)} roles")
    on_card = any(r != "cpu" for r in roles)
    dev = open_device(args.device) if on_card else torch.device("cpu")
    print(device_line(dev), flush=True)
    for role, s in zip(roles, secs):
        print(json.dumps(run_role(role, s, args.config, args.batch, dev,
                                  args.sink)), flush=True)


if __name__ == "__main__":
    main()
