"""Multi-mux demo (BASELINE.json config 5) on the PyTorch port: N
independent DVB-T2 channels sharded over a pool of device slots, the
counterpart of the JAX package's ``apps/multimux.py``.

Channels may be HETEROGENEOUS: pass --config repeatedly (one JSON per
channel group) and the pool is partitioned into per-config meshes
(MultiMuxTransmitter), the literal "N independent flowgraphs" analog.
With zero or one --config, all muxes share one config and one
ShardedTransmitter.  The pool is --slots N slots of --device (a slot may
repeat a device, so one card serves many muxes); --slots 0 takes every
visible CUDA card, one slot each.

    python -m dvbt2ll_tpu_torch.apps.multimux --mux 4 --slots 8 --steps 3
    python -m dvbt2ll_tpu_torch.apps.multimux --slots 8 --steps 2 \
        --config ch_8mhz.json --config ch_1p7mhz.json
"""
import argparse
import time


def _load_cfg(path):
    from ..config import T2Config
    try:
        cfg = T2Config.from_json_file(path)
    except ValueError as e:
        raise SystemExit(f"--config {path}: {e}")
    if len(cfg.plps) > 1:
        raise SystemExit(
            f"--config {path} describes {len(cfg.plps)} PLPs; this demo "
            "feeds one synthetic stream per mux - multi-PLP muxes go "
            "through the ShardedTransmitter API with per-PLP sources")
    return cfg


def _fence(outs) -> None:
    """Wait for every CUDA device that holds one of the blocks."""
    import torch
    devs = {o.device for rows in outs for row in rows for o in row}
    for d in devs:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mux", type=int, default=4,
                    help="independent DVB-T2 channels (per config group)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the slots (default cuda; a "
                         "missing CUDA device is an error)")
    ap.add_argument("--slots", type=int, default=0,
                    help="slots of --device in the pool (0 = every visible "
                         "CUDA card, one slot each)")
    ap.add_argument("--frames-per-shard", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--config", action="append", default=[],
                    help="T2Config JSON (repeat for heterogeneous channel "
                         "groups; default vv009-4kshort)")
    args = ap.parse_args()

    import numpy as np
    import torch

    from .. import synthetic_ts, vv009_config
    from ..parallel.sharding import cuda_devices

    if torch.device(args.device).type == "cuda" and not (
            torch.cuda.is_available()):
        raise SystemExit(f"--device {args.device}: no CUDA device "
                         f"(torch.cuda.is_available() is False)")
    if args.slots > 0:
        devices = [args.device] * args.slots
    elif torch.device(args.device).type == "cuda":
        devices = cuda_devices()
    else:
        raise SystemExit(f"--slots 0 takes every visible CUDA card; give "
                         f"--slots N for --device {args.device}")
    rng = np.random.default_rng(0)

    if len(args.config) > 1:
        _run_hetero(args, devices, [_load_cfg(p) for p in args.config], rng)
        return

    from ..parallel import ShardedTransmitter, make_mesh
    cfg = _load_cfg(args.config[0]) if args.config else vv009_config()
    if args.mux % len(devices) and len(devices) % args.mux:
        raise SystemExit("--mux must divide or be divisible by the slot "
                         "count")
    mesh = make_mesh(devices, mux=min(args.mux, len(devices)))
    stx = ShardedTransmitter(cfg, mesh, n_mux=args.mux,
                             frames_per_shard=args.frames_per_shard,
                             allow_phase_drift=True, strict=False)
    nbytes = stx.bytes_per_step_per_mux
    print(f"mesh={mesh.shape} slots={len(devices)} of "
          f"{mesh.local_devices()} muxes={args.mux} "
          f"frames/step={stx.frames_per_step} ts_bytes/mux/step={nbytes}")

    def feed():
        return np.stack([synthetic_ts(nbytes, seed=rng.integers(1 << 30))
                         for _ in range(args.mux)])

    _fence([stx.step_device(feed())])  # warm-up, outside the timed loop
    t0 = time.perf_counter()
    total_samples = 0
    for _ in range(args.steps):
        _fence([stx.step_device(feed())])
        total_samples += args.mux * stx.frames_per_step * cfg.samples_per_frame
    dt = time.perf_counter() - t0
    rt = cfg.sample_rate  # per-channel real-time sample rate
    print(f"{total_samples/1e6:.1f} Msamples in {dt:.2f}s = "
          f"{total_samples/dt/1e6:.1f} Msamp/s aggregate "
          f"({total_samples/dt/(rt*args.mux):.1f}x real time x {args.mux} "
          f"muxes)")


def _run_hetero(args, devices, cfgs, rng):
    """One mesh per config group (heterogeneous channels)."""
    import numpy as np

    from .. import synthetic_ts
    from ..parallel import MultiMuxTransmitter, MuxChannel

    mm = MultiMuxTransmitter(
        [MuxChannel(cfg, n_mux=args.mux,
                    frames_per_shard=args.frames_per_shard,
                    strict=False, allow_phase_drift=True) for cfg in cfgs],
        devices=devices)
    per = mm.bytes_per_step
    for i, (ch, stx) in enumerate(zip(mm.channels, mm.transmitters)):
        print(f"channel {i}: {ch.n_devices} slots x {ch.n_mux} muxes, "
              f"{stx.frames_per_step} frames/step, "
              f"ts_bytes/mux/step={per[i]}, "
              f"{ch.cfg.sample_rate/1e6:.3f} Msamp/s real time")

    def feed():
        return [np.stack([synthetic_ts(per[i], seed=rng.integers(1 << 30))
                          for _ in range(args.mux)])
                for i in range(len(cfgs))]

    _fence(mm.step_device(feed()))  # warm-up
    t0 = time.perf_counter()
    totals = np.zeros(len(cfgs))
    for _ in range(args.steps):
        _fence(mm.step_device(feed()))
        for i, stx in enumerate(mm.transmitters):
            totals[i] += (args.mux * stx.frames_per_step
                          * mm.channels[i].cfg.samples_per_frame)
    dt = time.perf_counter() - t0
    agg = totals.sum()
    rt = sum(c.sample_rate * args.mux for c in cfgs)
    print(f"{agg/1e6:.1f} Msamples in {dt:.2f}s = {agg/dt/1e6:.1f} Msamp/s "
          f"aggregate ({agg/dt/rt:.1f}x the summed real-time rate of "
          f"{len(cfgs)} heterogeneous groups x {args.mux} muxes)")


if __name__ == "__main__":
    main()
