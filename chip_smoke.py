#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dvbt2ll_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs a CUDA device, ``nvcc`` and the repository around this file; it
imports no JAX.  Phases, each of which raises on failure:

1. setup: the card's name and power limit (nvidia-smi), then the build of
   the CUDA kernels from ``dvbt2ll_tpu_torch/csrc`` (one nvcc a source,
   in parallel) with what ptxas reports;
2. the LDPC parity kernel against its plain torch twin, on the card,
   bit for bit, on the vv009 table (2048 frames, one batch-256 step) and
   the 8k_normal table (512 frames), with both timings;
3. the OFDM tail kernel (4-step IFFT + guard interval) against its plain
   twin on the same grids, above 120 dB SNR: vv009 and 8k_normal at batch
   256, timed, and every other planar (fft, gi) shape;
4. the twelve planar reference-binary goldens (``tests/golden_ref``)
   through ``Transmitter`` on the card: FEC bits exact, IQ above 100 dB;
5. the main path at full width: vv009 at batch 256 through
   ``Transmitter.step_device``.  The first step's FEC bits equal the port
   on the CPU exactly and its IQ is above 120 dB SNR against it; then
   streaming steps, timed, with the frame counter and carries checked and
   both kernels launched once a step;
6. 8k_normal at batch 256 the same way, over fewer steps;
7. multiplp_fef (two PLPs, FEF parts), strict, at three times its
   smallest streamable batch: ``stream_window`` on the card against
   ``stream`` on the CPU, FEF parts and state included.

The kernel launch counts are set to 0 just before each of phases 5-7 and
read just after.  Prints the kernel table as one JSON line, then, as its
last line, ``{"ok": true, "device": {...}}``.  Exits non-zero, without
that line, when there is no CUDA device or any phase fails.
"""
import json
import os
import sys
import time

import numpy as np

SEED = 2026
BATCH = 256            # the JAX package's bench default (bench.py:174)
STREAM_STEPS = 20      # vv009 main path
STEPS_8K = 5
MPLP_STEPS = 3
IQ_GOLDEN_DB = 100.0   # the JAX package's bar against the reference binary
IQ_CPU_DB = 120.0      # card vs the port on the CPU, same math
GOLDENS = ("vv009_4kshort", "8k_normal", "hieff_4k", "inband_2k",
           "8k_miso_tx1", "8k_miso_tx2", "1k_pp4", "qpsk_short_c13",
           "ti_off_4k", "t2lite_4k", "v121_4k", "eq_2k_5mhz")
LDPC_CASES = (("vv009_4kshort", 8 * BATCH), ("8k_normal", 512))
TAIL_DB = 120.0        # tail kernel vs its twin: both float32, sums reordered
# ((B, S), fft, gi, name when timed): vv009 and 8k_normal at batch 256, then
# the other planar geometries for correctness
TAIL_CASES = (((BATCH, 7), 4096, 128, "vv009_4kshort"),
              ((BATCH, 10), 8192, 512, "8k_normal"),
              ((16, 8), 1024, 128, None), ((16, 8), 1024, 256, None),
              ((16, 8), 2048, 256, None), ((16, 8), 4096, 1024, None),
              ((16, 8), 8192, 2048, None))
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


def tail_phase(torch, dev, rng) -> dict:
    """The OFDM tail kernel against its plain twin on the same grids."""
    from dvbt2ll_tpu_torch.ops.ifft import (factor_tensors, ifft_gi,
                                            ifft_gi_einsum)
    from dvbt2ll_tpu_torch.profile_step import cuda_ms
    times = {}
    for (b, s), fft, gi, timed in TAIL_CASES:
        shape = (b, s, fft // 128, 128)
        re, im = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev) for _ in range(2))
        scale = 1.0 / np.sqrt(fft)
        mats = factor_tensors(fft, scale, dev)
        got = ifft_gi(re, im, fft, gi, scale, mats)
        want = ifft_gi_einsum(re, im, fft, gi, scale, mats)
        torch.cuda.synchronize()
        snr = snr_db(torch.complex(*want).cpu().numpy(),
                     torch.complex(*got).cpu().numpy())
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        require(all(tuple(g.shape) == (b, s, fft + gi) for g in got),
                f"tail {fft}/{gi}: output shape")
        require(snr > TAIL_DB, f"tail {fft}/{gi}: kernel vs twin {snr:.2f} dB")
        line = (f"ifft_gi fft {fft} gi {gi} grids {shape}: kernel vs twin "
                f"{snr:.2f} dB, max abs err {err:.3e}")
        if timed:
            ms = cuda_ms(lambda: ifft_gi(re, im, fft, gi, scale, mats))
            plain_ms = cuda_ms(lambda: ifft_gi_einsum(re, im, fft, gi,
                                                      scale, mats))
            times[timed] = (err, ms, plain_ms)
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                     f"({plain_ms / ms:.2f}x)")
        print(line)
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


def reset_launches() -> None:
    from dvbt2ll_tpu_torch.ops.ifft import ifft_gi
    from dvbt2ll_tpu_torch.ops.ldpc import qc_ldpc_parity
    qc_ldpc_parity.launches = 0
    ifft_gi.launches = 0


def launches() -> dict:
    from dvbt2ll_tpu_torch.ops.ifft import ifft_gi
    from dvbt2ll_tpu_torch.ops.ldpc import qc_ldpc_parity
    return {"ldpc_parity": qc_ldpc_parity.launches,
            "ifft_gi": ifft_gi.launches}


def full_width_phase(torch, dev, name: str, steps: int) -> dict:
    """``name`` at batch 256 through ``step_device``: step 0 against the
    port on the CPU, then ``steps`` streaming steps, timed."""
    from dvbt2ll_tpu_torch import Transmitter, named_config, synthetic_ts
    from dvbt2ll_tpu_torch.pipeline import bb_and_fec
    cfg = named_config(name)
    # 256 frames is not a whole number of TS packets: each step is its own
    # phase-0 stream, as in bench.py
    kw = dict(strict=False, allow_phase_drift=True)
    tx = Transmitter(cfg, BATCH, device=dev, **kw)
    ref = Transmitter(cfg, BATCH, device="cpu", **kw)
    n = tx.bytes_per_step
    ts = [synthetic_ts(n, seed=SEED + i) for i in range(1 + steps)]

    w0 = np.concatenate([np.zeros(187, np.uint8), ts[0]])
    bits = bb_and_fec(tx.tensors.plps[0], torch.from_numpy(w0).to(dev))
    bits_ref = bb_and_fec(ref.tensors.plps[0], torch.from_numpy(w0))
    require(torch.equal(bits.cpu(), bits_ref), f"{name}: FEC bits: card "
            f"!= CPU")

    reset_launches()
    iq0 = tx.step_device(ts[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, 1 + steps):
        out = tx.step_device(ts[i])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launches()
    snr = snr_db(ref(ts[0]), iq0.cpu().numpy().reshape(BATCH, -1).view(
        np.complex64))
    require(snr > IQ_CPU_DB, f"{name}: step 0 IQ vs CPU {snr:.2f} dB")

    samples = steps * BATCH * cfg.samples_per_frame
    require(tuple(out.shape) == (BATCH, cfg.samples_per_frame, 2),
            f"{name}: output shape {tuple(out.shape)}")
    require(bool(torch.isfinite(out).all()), f"{name}: non-finite IQ")
    state = tx.state_dict()
    require(state["steps_done"] == 1 + steps, f"{name}: step count")
    require(state["frame_idx"] == (1 + steps) * BATCH % cfg.t2_frames,
            f"{name}: frame counter")
    require(np.array_equal(state["carries"][0], ts[-1][-187:]),
            f"{name}: carry")
    require(tx.counters.frames == (1 + steps) * BATCH, f"{name}: counters")
    for kernel, count in counts.items():
        require(count == 1 + steps, f"{name}: {kernel} launched {count} "
                f"times in {1 + steps} steps")
    rate = samples / dt / 1e6
    print(f"{name} batch {BATCH}: FEC bits of {bits.shape[0]} frames equal "
          f"the CPU's; step 0 IQ vs CPU {snr:.2f} dB; {steps} streaming "
          f"steps in {dt:.4f} s = {rate:.2f} Msamples/s; launches {counts}")
    return counts


def _check_fef(cfg, fef_part, stream, start: int, frames: int) -> None:
    """The FEF part follows every fef_interval-th T2 frame, from global
    frame index ``start``."""
    spf, pos = cfg.samples_per_frame, 0
    for f in range(start, start + frames):
        pos += spf
        if f % cfg.fef_interval == cfg.fef_interval - 1:
            require(np.array_equal(stream[pos:pos + cfg.fef_length],
                                   fef_part), f"FEF part after frame {f}")
            pos += cfg.fef_length
    require(pos == stream.size, f"stream of {stream.size} samples, "
            f"expected {pos}")


def multiplp_phase(torch, dev) -> dict:
    """multiplp_fef, strict: ``stream_window`` on the card with carries
    kept here, against ``stream`` on the port on the CPU."""
    from dvbt2ll_tpu_torch import (Transmitter, min_batch_frames,
                                   named_config, synthetic_ts)
    cfg = named_config("multiplp_fef")
    b = 3 * min_batch_frames(cfg)  # the smallest streamable batch >= 256
    tx = Transmitter(cfg, b, strict=True, device=dev)
    ref = Transmitter(cfg, b, strict=True, device="cpu")
    ns = tx.bytes_per_step_per_plp
    ts = [synthetic_ts(MPLP_STEPS * n, seed=SEED + 100 + i)
          for i, n in enumerate(ns)]
    fresh = [[t[k * n:(k + 1) * n] for t, n in zip(ts, ns)]
             for k in range(MPLP_STEPS)]
    carries = [np.zeros(187, np.uint8) for _ in ns]

    reset_launches()
    got = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(MPLP_STEPS):
        windows = [np.concatenate([c, f]) for c, f in zip(carries, fresh[k])]
        carries = [w[-187:] for w in windows]
        got.append(tx.stream_window(windows))
    dt = time.perf_counter() - t0
    counts = launches()
    want = [ref.stream(f) for f in fresh]

    for k, (g, w) in enumerate(zip(got, want)):
        require(g.shape == w.shape, f"multiplp step {k}: {g.shape} samples "
                f"on the card, {w.shape} on the CPU")
        _check_fef(cfg, tx.plan.fef_part, g, k * b, b)
        _check_fef(cfg, ref.plan.fef_part, w, k * b, b)
    snr = snr_db(np.concatenate(want), np.concatenate(got))
    require(snr > IQ_CPU_DB, f"multiplp: IQ vs CPU {snr:.2f} dB")
    sa, sb = tx.state_dict(), ref.state_dict()
    require(np.array_equal(sa["carries"], sb["carries"])
            and sa["frame_idx"] == sb["frame_idx"]
            and sa["steps_done"] == sb["steps_done"] == MPLP_STEPS,
            "multiplp: state_dict card != CPU")
    require(np.array_equal(sa["carries"], np.stack(carries)),
            "multiplp: carries")
    require(counts == {"ldpc_parity": len(ns) * MPLP_STEPS,
                       "ifft_gi": MPLP_STEPS},
            f"multiplp: launches {counts} in {MPLP_STEPS} steps of "
            f"{len(ns)} PLPs")
    fefs = sum(g.size for g in got) - MPLP_STEPS * b * cfg.samples_per_frame
    rate = sum(g.size for g in got) / dt / 1e6
    print(f"multiplp_fef batch {b} ({len(ns)} PLPs), {MPLP_STEPS} strict "
          f"steps through stream_window: {fefs // cfg.fef_length} FEF parts "
          f"in place, lengths equal, IQ vs CPU stream {snr:.2f} dB, "
          f"state equal; {dt:.4f} s = {rate:.2f} Msamples/s emitted "
          f"(device-to-host copy included); launches {counts}")
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from dvbt2ll_tpu_torch.ops import _build
    from dvbt2ll_tpu_torch.profile_step import card_line

    start = time.perf_counter()
    dev = torch.device("cuda")
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({_build.build_key()}, sm_90a)")
    print(_build.ptxas_report())

    rng = np.random.default_rng(SEED)
    ldpc_times = ldpc_phase(torch, dev, rng)
    tail_times = tail_phase(torch, dev, rng)
    golden_phase(torch, dev)
    paths = {"vv009_4kshort": full_width_phase(torch, dev, "vv009_4kshort",
                                               STREAM_STEPS),
             "8k_normal": full_width_phase(torch, dev, "8k_normal",
                                           STEPS_8K),
             "multiplp_fef": multiplp_phase(torch, dev)}

    def by_path(kernel):
        return {p: c[kernel] for p, c in paths.items()}

    main_path = paths["vv009_4kshort"]
    err, ms, plain_ms = ldpc_times["vv009_4kshort"]
    t_err, t_ms, t_plain = tail_times["vv009_4kshort"]
    _, t8_ms, t8_plain = tail_times["8k_normal"]
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "ldpc_parity", "route": "cuda",
        "source": "dvbt2ll_tpu_torch/csrc/ldpc_parity.cu",
        "replaces": "dvbt2ll_tpu/ops/ldpc_pallas.py:61",
        "also_replaces": "dvbt2ll_tpu/ops/ldpc_pallas.py:137",
        "launches": main_path["ldpc_parity"],
        "launches_by_path": by_path("ldpc_parity"), "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms}, {
        "name": "ifft_gi", "route": "cuda",
        "source": "dvbt2ll_tpu_torch/csrc/ifft_gi.cu",
        "replaces": "dvbt2ll_tpu/ops/ifft_pallas.py:226",
        "launches": main_path["ifft_gi"],
        "launches_by_path": by_path("ifft_gi"), "max_abs_err": t_err,
        "ms": t_ms, "plain_ms": t_plain,
        "ms_8k_normal": t8_ms, "plain_ms_8k_normal": t8_plain}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
