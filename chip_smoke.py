#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dvbt2ll_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs a CUDA device, ``nvcc`` and the repository around this file; it
imports no JAX.  Phases, each of which raises on failure:

1. setup: the card's name and power limit (nvidia-smi), then the build of
   the CUDA kernels from ``dvbt2ll_tpu_torch/csrc``;
2. the LDPC parity kernel against its plain torch twin, on the card,
   bit for bit, on the vv009 table (2048 frames, one batch-256 step) and
   the 8k_normal table (512 frames), with both timings;
3. the reference-binary goldens ``tests/golden_ref/{vv009_4kshort,
   8k_normal}.npz`` through ``Transmitter`` on the card: FEC bits exact,
   IQ above 100 dB SNR;
4. the main path at full width: vv009 at batch 256 through
   ``Transmitter.step_device``.  The first step's FEC bits equal the port
   on the CPU exactly and its IQ is above 120 dB SNR against it; then
   streaming steps, timed, with the frame counter and carries checked and
   every kernel launched.

Prints the kernel table as one JSON line, then, as its last line,
``{"ok": true, "device": {...}}``.  Exits non-zero, without that line,
when there is no CUDA device or any phase fails.
"""
import json
import os
import sys
import time

import numpy as np

SEED = 2026
BATCH = 256            # the JAX package's bench default (bench.py:174)
STREAM_STEPS = 20
IQ_GOLDEN_DB = 100.0   # the JAX package's bar against the reference binary
IQ_CPU_DB = 120.0      # card vs the port on the CPU, same math
GOLDENS = ("vv009_4kshort", "8k_normal")
LDPC_CASES = (("vv009_4kshort", 8 * BATCH), ("8k_normal", 512))
ROOT = os.path.dirname(os.path.abspath(__file__))


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def snr_db(ref, x) -> float:
    ref = np.asarray(ref, np.complex128).ravel()
    x = np.asarray(x, np.complex128).ravel()
    err = float(np.sum(np.abs(x - ref) ** 2))
    return float("inf") if err == 0 else float(
        10 * np.log10(np.sum(np.abs(ref) ** 2) / err))


def ldpc_phase(torch, dev, rng) -> dict:
    from dvbt2ll_tpu_torch import named_config
    from dvbt2ll_tpu_torch._host.tables.ldpc import encode_ref, qc_entries
    from dvbt2ll_tpu_torch.ops.ldpc import (ldpc_schedule, qc_ldpc_parity,
                                            qc_ldpc_parity_plain)
    from dvbt2ll_tpu_torch.profile_step import cuda_ms
    times = {}
    for name, frames in LDPC_CASES:
        cfg = named_config(name)
        sched = ldpc_schedule(
            qc_entries(cfg.frame_size, cfg.code_rate, cfg.q_ldpc), cfg.nbch,
            cfg.ldpc_parity_bits, cfg.q_ldpc, dev)
        host = rng.integers(0, 2, (frames, cfg.nbch), dtype=np.uint8)
        bits = torch.from_numpy(host).to(dev)
        got = qc_ldpc_parity(sched, bits)
        want = qc_ldpc_parity_plain(sched, bits)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        require(err == 0, f"{name}: LDPC kernel differs from its twin")
        got_h = got.cpu().numpy()
        for i in (0, frames - 1):  # and the numpy scatter oracle
            ref = encode_ref(host[i], cfg.frame_size, cfg.code_rate,
                             cfg.ldpc_parity_bits, cfg.q_ldpc)
            require((got_h[i] == ref).all(), f"{name}: frame {i} != oracle")
        ms = cuda_ms(lambda: qc_ldpc_parity(sched, bits))
        plain_ms = cuda_ms(lambda: qc_ldpc_parity_plain(sched, bits))
        print(f"ldpc {name} F={frames}: bit-exact, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms ({plain_ms / ms:.2f}x)")
        times[name] = (err, ms, plain_ms)
    return times


def golden_phase(torch, dev) -> None:
    from dvbt2ll_tpu_torch import Transmitter, named_config, synthetic_ts
    from dvbt2ll_tpu_torch.pipeline import bb_and_fec
    for name in GOLDENS:
        with np.load(os.path.join(ROOT, "tests", "golden_ref",
                                  f"{name}.npz")) as z:
            g = {k: z[k] for k in z.files}
        cfg = named_config(name)
        nframes = int(g["nframes"])
        ts = synthetic_ts(int(g["ts_bytes"]), seed=int(g["ts_seed"]))
        tx = Transmitter(cfg, nframes, strict=False, device=dev)
        padded = torch.from_numpy(
            np.concatenate([np.zeros(187, np.uint8), ts])).to(dev)
        bits = bb_and_fec(tx.tensors.plps[0], padded).cpu().numpy()
        ref2 = np.unpackbits(g["stage2_bits_packed"])[
            :int(g["stage2_count"])].reshape(bits.shape)
        require(np.array_equal(bits, ref2), f"{name}: FEC bits != golden")
        iq = tx(ts)
        snr = snr_db(g["stage5_iq"].reshape(iq.shape), iq)
        print(f"golden {name} ({nframes} frames): FEC bit-exact, "
              f"IQ {snr:.2f} dB")
        require(snr > IQ_GOLDEN_DB, f"{name}: IQ {snr:.2f} dB")


def main_path_phase(torch, dev) -> dict:
    from dvbt2ll_tpu_torch import Transmitter, synthetic_ts, vv009_config
    from dvbt2ll_tpu_torch.ops.ldpc import qc_ldpc_parity
    from dvbt2ll_tpu_torch.pipeline import bb_and_fec
    cfg = vv009_config()
    # 256 frames is not a whole number of TS packets (min_batch_frames is
    # 47): each step is its own phase-0 stream, as in bench.py
    kw = dict(strict=False, allow_phase_drift=True)
    tx = Transmitter(cfg, BATCH, device=dev, **kw)
    ref = Transmitter(cfg, BATCH, device="cpu", **kw)
    n = tx.bytes_per_step
    ts = [synthetic_ts(n, seed=SEED + i) for i in range(1 + STREAM_STEPS)]

    w0 = np.concatenate([np.zeros(187, np.uint8), ts[0]])
    bits = bb_and_fec(tx.tensors.plps[0], torch.from_numpy(w0).to(dev))
    bits_ref = bb_and_fec(ref.tensors.plps[0], torch.from_numpy(w0))
    require(torch.equal(bits.cpu(), bits_ref), "FEC bits: card != CPU")
    print(f"main vv009 batch {BATCH}: FEC bits of {bits.shape[0]} frames "
          f"equal the CPU's")

    qc_ldpc_parity.launches = 0
    iq0 = tx.step_device(ts[0])
    snr = snr_db(ref(ts[0]), iq0.cpu().numpy().reshape(BATCH, -1).view(
        np.complex64))
    require(snr > IQ_CPU_DB, f"step 0 IQ vs CPU {snr:.2f} dB")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, 1 + STREAM_STEPS):
        out = tx.step_device(ts[i])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = qc_ldpc_parity.launches

    samples = STREAM_STEPS * BATCH * cfg.samples_per_frame
    require(tuple(out.shape) == (BATCH, cfg.samples_per_frame, 2),
            f"output shape {tuple(out.shape)}")
    require(bool(torch.isfinite(out).all()), "non-finite IQ")
    state = tx.state_dict()
    require(state["steps_done"] == 1 + STREAM_STEPS, "step count")
    require(state["frame_idx"]
            == (1 + STREAM_STEPS) * BATCH % cfg.t2_frames, "frame counter")
    require(np.array_equal(state["carries"][0], ts[-1][-187:]), "carry")
    require(tx.counters.frames == (1 + STREAM_STEPS) * BATCH, "counters")
    require(launches == 1 + STREAM_STEPS,
            f"LDPC kernel launched {launches} times in "
            f"{1 + STREAM_STEPS} steps")
    rate = samples / dt / 1e6
    print(f"main vv009 batch {BATCH}: step 0 IQ vs CPU {snr:.2f} dB; "
          f"{STREAM_STEPS} streaming steps in {dt:.4f} s = {rate:.2f} "
          f"Msamples/s; ldpc launches {launches}")
    return {"ldpc_parity": launches}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from dvbt2ll_tpu_torch.ops import _build
    from dvbt2ll_tpu_torch.profile_step import card_line

    dev = torch.device("cuda")
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({_build.build_key()}, sm_90a)")

    times = ldpc_phase(torch, dev, np.random.default_rng(SEED))
    golden_phase(torch, dev)
    launches = main_path_phase(torch, dev)

    err, ms, plain_ms = times["vv009_4kshort"]
    print(json.dumps({"kernels": [{
        "name": "ldpc_parity", "route": "cuda",
        "source": "dvbt2ll_tpu_torch/csrc/ldpc_parity.cu",
        "replaces": "dvbt2ll_tpu/ops/ldpc_pallas.py:61",
        "also_replaces": "dvbt2ll_tpu/ops/ldpc_pallas.py:137",
        "launches": launches["ldpc_parity"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
