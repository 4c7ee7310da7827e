#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dvbt2ll_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs a CUDA device, ``nvcc`` and the repository around this file; it
imports no JAX.  Phases, each of which raises on failure:

1. setup: the card's name and power limit (nvidia-smi), then the build of
   the CUDA kernels from ``dvbt2ll_tpu_torch/csrc`` (one nvcc a source,
   in parallel) with what ptxas reports;
2. the LDPC codeword kernel against its plain torch twin, on the card,
   bit for bit, and the parity of the first and last frames against the
   numpy oracle, on the vv009 table (2048 frames, one batch-256 step;
   6016 frames, one step of BASELINE config 5's 16 blocks batched), the
   8k_normal table (512 frames) and the uk_t2_32k table (9494 frames,
   its 47-frame step), timed beside its plain twin and its bound;
2b. the BB/BCH kernel (BB framing, packet CRC-8, scrambling, BCH)
   against its plain twin on the card, bit for bit, on vv009 and
   8k_normal windows at batch 256, config 5's 16 blocks of 47 vv009
   frames (6016 frames) and uk_t2_32k's 47-frame window (9494 frames of
   kbch 43040), timed beside its plain twin and its bound;
2c. the mapper kernel (bit interleave, Gray QAM levels, rotation, cyclic
   Q delay) against its plain twin on the card, bit for bit, in both
   layouts (the planar tail's two planes, the complex tail's complex64),
   at vv009 and 8k_normal at batch 256, config 5's 6016 frames and the
   UK mux's 9494 normal frames, timed beside its plain twin and its
   bound;
3. the fused OFDM tail kernel (P1, then each symbol's 4-step IFFT and
   guard interval as final I/Q) against its plain twin on the same grids
   and P1: P1 bit for bit, the rest above 120 dB SNR, at vv009 and
   8k_normal at batch 256 and vv009 at config 5's 752 frames, timed
   beside its plain twin, its bound and
   ``torch.fft.ifft`` on the same transforms, and every other planar
   (fft, gi) shape;
4. all seventeen reference-binary goldens (``tests/golden_ref``) through
   ``Transmitter`` on the card, the twelve planar ones and the five of the
   complex ``torch.fft`` tail (16K, 32K, GI 1216): FEC bits exact, IQ
   above 100 dB;
4b. the JAX package's config matrix (``MATRIX``: every config of
   tests/test_configs_e2e.py and tests/test_modes.py), each case at its
   test batch through ``Transmitter.step_device`` on the card against the
   port on the CPU (FEC bits exact, IQ above 120 dB, ``bb_bch`` and
   ``ldpc_parity`` once a step, ``ifft_gi`` once a step on the planar
   tail and never on the complex one; the two streaming cases one
   Transmitter a step with ``start_phases``, resumed from the previous
   one's checkpoint), then two
   steps at batch 256 in drift mode (HIEFF: the largest multiple of its
   smallest batch up to 256), checked like phase 6, each timed;
5. the main path at full width: vv009 at batch 256 through
   ``Transmitter.step_device``.  The first step's FEC bits equal the port
   on the CPU exactly and its IQ is above 120 dB SNR against it; then
   streaming steps, timed, with the frame counter and carries checked and
   both kernels launched once a step;
6. 8k_normal and 32k_extended at batch 256 the same way, over fewer
   steps; 32k_extended runs the complex tail, so the LDPC kernel launches
   once a step and the tail kernel never;
7. multiplp_fef (two PLPs, FEF parts), strict, at three times its
   smallest streamable batch: ``stream_window`` on the card against
   ``stream`` on the CPU, FEF parts and state included;
8. the runtime, vv009 strict at its smallest streamable batch, fed by the
   native TS ingest ring reading a real OS pipe: ``StreamingExecutor``'s
   sink stream bit-identical to ``Transmitter.stream`` on the card; a
   paced run of about 10 s of air into the native async sink (lag at most
   one step, no sync errors, the sink's sample count exact, warm-up step
   included); the app ``dvbt2ll_tpu_torch.apps.vv009_4kshort`` as a
   subprocess on the card against the port on the CPU; and the
   executor's emitted rate, device-to-host copy included, for vv009 at
   batch 256 and multiplp_fef, beside ``stream``/``stream_window``;
9. the multi-device layer (``dvbt2ll_tpu_torch.parallel``): (a) BASELINE
   config 5 at full width, vv009 as 8 independent muxes in the
   valid-stream mode, a (mux 8, frame 2) ``ShardedTransmitter`` over 16
   slots of the card, 47 frames a shard, strict, 2 steps of 752 frames:
   each mux bit-identical to its own strict ``Transmitter`` of 47 frames
   streamed over 4 steps, both kernels launched once a card a step (the
   card's 16 blocks are one batched call, the counterpart of the JAX
   ``shard_fn``'s ``jax.vmap``), and the aggregate rate beside one
   ``Transmitter`` of 752 frames (information, not a claim); (b) a
   heterogeneous ``MultiMuxTransmitter``, a vv009
   group of 2 muxes (planar tail) beside a 32k_extended group (complex
   tail, drift mode), each channel bit-identical to its standalone
   ``ShardedTransmitter`` and a checkpoint round trip reproducing the
   next step; (c) the symbol-sharded back-end at 32k_extended, 1 frame
   over 4 slots, compiled (one CUDA graph on one card), bit-identical to
   its eager form and to ``transmit_step_iq``, both timed, with the
   graphs' pool; (d) ``dryrun_multichip``, ``dryrun_multihost`` as two
   processes sharing the card, and the multi-mux app as a subprocess
   with two ``--config`` files; (e) with two or more cards, (a) over the
   real cards with one graph launch a card and no peer-to-peer copy in a
   profiled step, and (c) over the cards (a graph a card segment), else
   a line saying why not;
9b. the compiled step (``compiled.CompiledStep``, one CUDA graph a
   transmitter, and one a card for all of a ``ShardedTransmitter``'s
   blocks there: the counterparts of the JAX step's ``jax.jit`` and of
   its mesh step's ``jax.jit(_shard_map(...))``; every phase above
   already runs through it): on vv009 at batch 256 and at its
   47-frame strict batch (odd: the frame index alternates), 8k_normal and
   32k_extended at 256 and multiplp_fef strict at 282, four steps, every
   output kept, each bit-identical to the eager step function on the same
   window and frame index; then ``step_device`` compiled against the
   eager step's host path, each timed, with the capture's time, the
   graph's pool and the peak memory each reserved, and on the card's
   clock a replay, the eager step and the output's copy; batch-1 latency
   compiled and eager (``bench_latency.measure``); and BASELINE config 5
   (8 vv009 muxes over 16 slots of the card, one graph of one batched
   call, each kernel launched once a step) block by block against the
   one-block eager step for t2_frames + 1 steps, bit for bit, with both
   aggregate rates, the graph launches a step under torch.profiler and
   the pool;
10. the measuring entry points, each a subprocess on the card whose
   output starts with the card line, each JSON line printed:
   ``tools.roofline`` at batch 256 on vv009, 8k_normal and 32k_extended
   (its tail kernel bound equal to phase 3's; arithmetic on the host, so
   it runs beside the next two), ``bench`` at vv009 batch 256 for 10
   steps, ``tools.bench_latency`` on its four configs,
   ``tools.bench_sustained`` ``device`` and ``full`` for 5 s each and
   ``paced`` for about 10 s of air (no sync errors, the paced lag at most
   one step, the sink's warm-up and timed samples exact), and
   ``tools.bench_scaling`` parts A and B, with part C when the phase so
   far took less than 90 s; then part A's 1-, 4- and 8-slot steps again
   in this process under torch.profiler (wall time, the card's kernel
   time, the host's graph launches and CUDA runtime calls a step).  Each tool counts its kernel launches in
   its own process and reports them; a replayed graph counts as the
   launches its capture recorded.

The kernel launch counts are set to 0 just before each path of phases
4b-9b and read just after.  Prints the kernel table as one JSON line, then,
as its last line, ``{"ok": true, "device": {...}}``.  Exits non-zero,
without that line, when there is no CUDA device or any phase fails.
"""
import concurrent.futures
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

SEED = 2026
BATCH = 256            # the JAX package's bench default (bench.py:174)
STREAM_STEPS = 20      # vv009 main path
STEPS_8K = 5
STEPS_32K = 3
MPLP_STEPS = 3
RUNTIME_STEPS = 4      # executor vs stream, bit for bit
PACED_SECONDS = 10.0   # of air, at vv009's profile rate
RATE_STEPS = 10        # executor and stream rate runs
GAIN = 0.2             # the reference app's output gain
IQ_GOLDEN_DB = 100.0   # the JAX package's bar against the reference binary
IQ_CPU_DB = 120.0      # card vs the port on the CPU, same math
GOLDENS = ("vv009_4kshort", "8k_normal", "hieff_4k", "inband_2k",
           "8k_miso_tx1", "8k_miso_tx2", "1k_pp4", "qpsk_short_c13",
           "ti_off_4k", "t2lite_4k", "v121_4k", "eq_2k_5mhz",
           # the complex tail
           "32k_extended", "32k_papr_tr", "16k_l1qpsk_both",
           "t2lite_16k_t2gi", "t2lite_8k_t2gi_miso")
# BASELINE config 5 on one card: 16 blocks of 47 vv009 frames, one batch
# of 752 frames a step (each kernel launched once a step)
CONFIG5_FRAMES = 16 * 47
# the UK DVB-T2 HD mux's strict step: 47 frames of 202 FEC blocks
UK_FRAMES = 47
# (key, config, LDPC frames): vv009 at batch 256 (8 a T2 frame), 8k_normal,
# vv009 at config 5's batch, and the UK mux's step (9494 frames)
LDPC_CASES = (("vv009_4kshort", "vv009_4kshort", 8 * BATCH),
              ("8k_normal", "8k_normal", 512),
              ("config5", "vv009_4kshort", 8 * CONFIG5_FRAMES),
              ("uk_t2_32k", "uk_t2_32k", 202 * UK_FRAMES))
# (key, config, batch, blocks) of the BB/BCH kernel's checks: vv009 and
# 8k_normal at batch 256, config 5's 16 blocks of 47 vv009 frames, and the
# UK mux's step
BB_BCH_CASES = (("vv009_4kshort", "vv009_4kshort", BATCH, 1),
                ("8k_normal", "8k_normal", BATCH, 1),
                ("config5", "vv009_4kshort", 47, 16),
                ("uk_t2_32k", "uk_t2_32k", UK_FRAMES, 1))
# (key, config, FEC frames) of the mapper kernel's checks: vv009 and
# 8k_normal (64QAM unrotated, normal frames) at batch 256, config 5's
# batch, and the UK mux's step
QAM_CASES = (("vv009_4kshort", "vv009_4kshort", 8 * BATCH),
             ("8k_normal", "8k_normal", 2 * BATCH),
             ("config5", "vv009_4kshort", 8 * CONFIG5_FRAMES),
             ("uk_t2_32k", "uk_t2_32k", 202 * UK_FRAMES))
TAIL_DB = 120.0        # tail kernel vs its twin: both float32, sums reordered
# ((B, S), fft, gi, key when timed): vv009 and 8k_normal at batch 256 and
# vv009 at config 5's batch, then the other planar geometries for
# correctness
TAIL_CASES = (((BATCH, 7), 4096, 128, "vv009_4kshort"),
              ((BATCH, 10), 8192, 512, "8k_normal"),
              ((CONFIG5_FRAMES, 7), 4096, 128, "config5"),
              ((16, 8), 1024, 128, None), ((16, 8), 1024, 256, None),
              ((16, 8), 2048, 256, None), ((16, 8), 4096, 1024, None),
              ((16, 8), 8192, 2048, None))
# The JAX package's config matrix (tests/test_configs_e2e.py and
# tests/test_modes.py), one case per config its tests run: ``kw`` builds a
# T2Config with ``T2Config.from_dict`` (enums by name, the rest default,
# which is vv009), at the test's ``batch`` on TS of ``seed``; ``steps`` > 1
# drives one Transmitter a step with ``start_phases=bb.next_phase``.
# tests/test_torch_configs_e2e.py holds each case against the JAX package
# and refmodel on the CPU, and this script on the card against the CPU.
_2K = dict(frame_size="SHORT", code_rate="C1_2", constellation="QPSK",
           rotation="OFF", fft_size="FFT_2K", guard_interval="GI_1_8",
           pilot_pattern="PP1", fec_blocks=1, ti_blocks=1, t2_frames=2)
_MODES = dict(_2K, num_data_symbols=8, l1_constellation="BPSK")
_8K = dict(frame_size="NORMAL", code_rate="C2_3", constellation="QAM64",
           rotation="OFF", fft_size="FFT_8K", guard_interval="GI_1_16",
           pilot_pattern="PP3", fec_blocks=2, ti_blocks=1, t2_frames=2,
           num_data_symbols=8)
_64QAM = dict(frame_size="SHORT", code_rate="C2_3", constellation="QAM64",
              rotation="OFF", fec_blocks=2, ti_blocks=1, t2_frames=2)
_8K_EXT = dict(_64QAM, fft_size="FFT_8K", guard_interval="GI_1_16",
               pilot_pattern="PP3", carrier_mode="EXTENDED",
               num_data_symbols=8)
_E2E, _MODES_PY = "tests/test_configs_e2e.py", "tests/test_modes.py"


def _case(id, test, kw, seed, batch=1, steps=1):
    return dict(id=id, test=test, kw=kw, seed=seed, batch=batch,
                steps=steps)


MATRIX = (
    _case("8k_normal_pp3", f"{_E2E}:23", _8K, 31),
    _case("32k_extended", f"{_E2E}:34", dict(
        frame_size="NORMAL", code_rate="C4_5", fft_size="FFT_32K",
        carrier_mode="EXTENDED", fec_blocks=4, ti_blocks=2,
        num_data_symbols=4), 31),
    _case("16k_extended_16qam", f"{_E2E}:47", dict(
        frame_size="SHORT", code_rate="C3_5", constellation="QAM16",
        fft_size="FFT_16K", guard_interval="GI_1_8", pilot_pattern="PP3",
        carrier_mode="EXTENDED", fec_blocks=3, ti_blocks=1,
        num_data_symbols=6), 31),
    _case("2k_qpsk", f"{_E2E}:58", dict(_2K, num_data_symbols=16), 31),
    _case("1k_qpsk", f"{_E2E}:197",
          dict(_2K, fft_size="FFT_1K", num_data_symbols=24), 51),
    _case("vv009_eq", f"{_E2E}:68", dict(equalization=True), 31),
    *(_case(f"vv009_eq_bw{i}", f"{_E2E}:376",
            dict(equalization=True, bandwidth=bw), 84 + i)
      for i, bw in ((0, "BW_1_7_MHZ"), (3, "BW_7_0_MHZ"),
                    (5, "BW_10_0_MHZ"))),
    *(_case(f"miso_2k_{g.lower()}", f"{_E2E}:81", dict(
        _2K, num_data_symbols=8, preamble="T2_MISO", miso_group=g,
        l1_constellation="BPSK"), 91) for g in ("TX1", "TX2")),
    *(_case(f"miso_ext_{name}_{g.lower()}", f"{_E2E}:115", dict(
        _64QAM, fft_size=fft, guard_interval=gi, pilot_pattern=pp,
        carrier_mode="EXTENDED", preamble="T2_MISO", miso_group=g,
        num_data_symbols=nds), seed)
      for name, fft, gi, pp, g, nds, seed in (
          ("8k", "FFT_8K", "GI_1_16", "PP3", "TX1", 8, 122),
          ("16k", "FFT_16K", "GI_1_16", "PP3", "TX2", 6, 129),
          ("32k", "FFT_32K", "GI_1_32", "PP7", "TX1", 4, 130),
          ("32k", "FFT_32K", "GI_1_32", "PP7", "TX2", 4, 131))),
    _case("miso_tr_8k_ext", f"{_E2E}:138", dict(
        _8K_EXT, preamble="T2_MISO", miso_group="TX1", papr="TR"), 130),
    _case("papr_both", f"{_E2E}:163", dict(papr="BOTH",
                                           num_data_symbols=4), 131),
    _case("papr_tr_8k_ext", f"{_E2E}:182", dict(_8K_EXT, papr="TR"), 132),
    _case("papr_tr", f"{_E2E}:208", dict(papr="TR", num_data_symbols=4),
          52),
    _case("papr_ace", f"{_E2E}:342", dict(papr="ACE"), 82),
    *(_case(f"l1_{c.lower()}", f"{_E2E}:222", dict(
        _2K, num_data_symbols=12, l1_constellation=c), 53 + i)
      for i, c in ((1, "QPSK"), (2, "QAM16"), (3, "QAM64"))),
    _case("v131_l1_scrambled", f"{_E2E}:237",
          dict(version="V131", l1_scrambled=True), 57),
    _case("v131_reserved_bias", f"{_E2E}:328",
          dict(version="V131", reserved_bias_bits=True), 81),
    *(_case(f"t2gi_{name}", f"{_E2E}:253", dict(
        _64QAM, fft_size=fft, guard_interval=gi, pilot_pattern=pp,
        num_data_symbols=4), seed)
      for name, fft, gi, pp, seed in (
          ("8k_19_128_pp8", "FFT_8K_T2GI", "GI_19_128", "PP8", 67),
          ("32k_19_256_pp8", "FFT_32K_T2GI", "GI_19_256", "PP8", 68),
          ("32k_1_128_pp7", "FFT_32K_T2GI", "GI_1_128", "PP7", 68))),
    _case("ti_off_vv009", f"{_E2E}:271", dict(ti_blocks=0), 91, batch=2),
    _case("ti_off_8k_normal", f"{_E2E}:290", dict(_8K, ti_blocks=0), 92),
    *(_case(f"t2lite_{mode}", f"{_E2E}:302", dict(
        preamble=pre, miso_group="TX1", version="V131", code_rate="C3_4",
        num_data_symbols=nds), seed)
      for mode, pre, nds, seed in (("siso", "T2_LITE_SISO", 3, 74),
                                   ("miso", "T2_LITE_MISO", 4, 75))),
    _case("vv009_fef", f"{_E2E}:357",
          dict(fef_length=4096, fef_interval=2), 83),
    _case("hieff", f"{_MODES_PY}:36,50", dict(_MODES, input_mode="HIEFF"),
          82, batch=17),
    _case("inband", f"{_MODES_PY}:59,73", dict(
        _MODES, in_band="ON", fec_blocks=2, ts_rate=4_000_000), 84,
        batch=2),
    _case("inband_hieff", f"{_MODES_PY}:82", dict(
        _MODES, in_band="ON", input_mode="HIEFF", fec_blocks=2), 85,
        batch=187),
    _case("inband_stream", f"{_MODES_PY}:96", dict(
        _MODES, in_band="ON", fec_blocks=2), 86, batch=2, steps=3),
    _case("normal_drift", f"{_MODES_PY}:123", _MODES, 87, steps=4),
)
SHARD_MUX = 8          # BASELINE.json config 5: 8+ independent channels
SHARD_FRAME = 2
SHARD_STEPS = 2
SYMBOL_SLOTS = 4
TOOL_TIMEOUT = 300     # seconds for each measuring tool's subprocess
BENCH_STEPS = 10       # phase 10: bench at vv009 batch 256
SUSTAINED_SECONDS = 5.0   # phase 10: bench_sustained device and full
TOOLS_C_BUDGET = 90.0  # phase 10 runs bench_scaling part C when the
                       # phase's earlier tools took less, in seconds
# phase 9b: (config, batch or None for 3 x its smallest streamable batch,
# strict) of each full-width path, compiled against eager; vv009 strict at
# 47 frames is the odd batch, where the frame index alternates
COMPILED_PATHS = (("vv009_4kshort", BATCH, False), ("vv009_4kshort", 47, True),
                  ("8k_normal", BATCH, False), ("32k_extended", BATCH, False),
                  ("multiplp_fef", None, True))
COMPILED_CHECK = 4     # steps held bit for bit: t2_frames + 2
COMPILED_STEPS = 10    # timed steps, compiled and eager
LATENCY_ITERS = 20     # phase 9b's batch-1 latency, back to back
LATENCY_CALLS = 50     # and fenced alone
TRACE_STEPS = 5        # phase 10's profiled 1-, 4- and 8-slot steps
SYMBOL_CALLS = 10      # timed symbol-sharded calls, compiled and eager
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


def tail_bound(re, im, p1, tables, out, fft: int) -> tuple:
    """The fused tail kernel's bound on these tensors (``roofline.bound``):
    the grids, P1 and both tables read once, the I/Q written once; 5 N
    log2 N float32 operations a symbol."""
    from dvbt2ll_tpu_torch.tools.roofline import bound
    b, s = re.shape[:2]
    nbytes = sum(t.numel() * 4 for t in (re, im, p1, tables.w128,
                                         tables.twiddle, out))
    return bound(nbytes, 5.0 * b * s * fft * np.log2(fft))


def ldpc_phase(torch, dev, rng) -> dict:
    """The LDPC codeword kernel against its plain twin, bit for bit, and
    the numpy scatter oracle; timed beside its bound.  No single PyTorch
    call computes QC-LDPC parity, so there is no library time."""
    from dvbt2ll_tpu_torch import named_config
    from dvbt2ll_tpu_torch.ops.ldpc import (ldpc_codeword,
                                            ldpc_codeword_plain,
                                            ldpc_schedule)
    from dvbt2ll_tpu_torch.profile_step import cuda_ms
    from dvbt2ll_tpu_torch.tables.ldpc import encode_ref, qc_entries
    from dvbt2ll_tpu_torch.tools.roofline import bound
    times = {}
    for key, name, frames in LDPC_CASES:
        cfg = named_config(name)
        sched = ldpc_schedule(
            qc_entries(cfg.frame_size, cfg.code_rate, cfg.q_ldpc), cfg.nbch,
            cfg.ldpc_parity_bits, cfg.q_ldpc, dev)
        host = rng.integers(0, 2, (frames, cfg.nbch), dtype=np.uint8)
        bits = torch.from_numpy(host).to(dev)
        got = ldpc_codeword(sched, bits)
        want = ldpc_codeword_plain(sched, bits)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        require(err == 0, f"{name}: LDPC kernel differs from its twin")
        got_h = got.cpu().numpy()
        require(np.array_equal(got_h[:, :cfg.nbch], host),
                f"{name}: info bits not passed through")
        for i in (0, frames - 1):  # and the numpy scatter oracle
            ref = encode_ref(host[i], cfg.frame_size, cfg.code_rate,
                             cfg.ldpc_parity_bits, cfg.q_ldpc)
            require((got_h[i, cfg.nbch:] == ref).all(),
                    f"{name}: frame {i} != oracle")
        ms = cuda_ms(lambda: ldpc_codeword(sched, bits))
        plain_ms = cuda_ms(lambda: ldpc_codeword_plain(sched, bits))
        # each bit a byte: nbch read, the codeword written; 360 rows x E
        # XORs plus the row scans are integer work far under the bytes
        bound_ms, by = bound(frames * (cfg.nbch + cfg.ldpc_frame_bits), 0.0)
        print(f"ldpc_codeword {name} F={frames}: bit-exact, kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"({plain_ms / ms:.2f}x); bound {bound_ms:.4f} ms "
              f"({by}), share of bound {bound_ms / ms:.3f}")
        times[key] = dict(err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=by, library_ms=None)
    return times


def bb_bch_phase(torch, dev) -> dict:
    """The BB/BCH kernel against its plain twin run on the card, on the
    same windows, bit for bit; timed beside its bound and the twin.  No
    single PyTorch call computes CRC-8, scrambling and BCH, so there is no
    library time."""
    import dataclasses
    from dvbt2ll_tpu_torch import build_plan, named_config, synthetic_ts
    from dvbt2ll_tpu_torch.ops.fec import (bb_bch, bb_bch_plain,
                                           bb_bch_tables)
    from dvbt2ll_tpu_torch.profile_step import cuda_ms
    from dvbt2ll_tpu_torch.tools.roofline import bound
    times = {}
    for key, name, batch, blocks in BB_BCH_CASES:
        pp = build_plan(named_config(name), batch, strict=False).plps[0]
        t, host = bb_bch_tables(pp, dev), bb_bch_tables(pp, "cpu")
        # the twin on the card: its GF(2) matrices moved there
        plain = dataclasses.replace(t, crc_matrix=host.crc_matrix.to(dev),
                                    bch_matrix=host.bch_matrix.to(dev))
        ts = torch.from_numpy(np.stack([np.concatenate(
            [np.zeros(187, np.uint8),
             synthetic_ts(t.fresh, seed=SEED + i)]) for i in range(blocks)
        ])).to(dev)
        got = bb_bch(t, ts)
        want = bb_bch_plain(plain, ts)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        require(err == 0, f"{name}: BB/BCH kernel differs from its twin")
        frames = got.shape[0]
        ms = cuda_ms(lambda: bb_bch(t, ts))
        plain_ms = cuda_ms(lambda: bb_bch_plain(plain, ts))
        # the windows read once, a byte a bit written; the CRC and BCH
        # walks are integer work under the bytes
        bound_ms, by = bound(ts.numel() + frames * t.nbch, 0.0)
        print(f"bb_bch {name} F={frames} ({blocks} block(s)): bit-exact, "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"({plain_ms / ms:.2f}x); bound {bound_ms:.4f} ms ({by}), "
              f"share of bound {bound_ms / ms:.3f}")
        times[key] = dict(err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=by, library_ms=None)
    return times


def qam_phase(torch, dev, rng) -> dict:
    """The mapper kernel against its plain twin run on the card, on the
    same codewords, bit for bit, in both layouts; timed, in the layout the
    configuration's tail takes, beside its bound and the twin.  No PyTorch
    call maps DVB-T2 cells, so there is no library time."""
    import dataclasses
    from dvbt2ll_tpu_torch import build_plan, named_config
    from dvbt2ll_tpu_torch.ops.qam import qam_map, qam_map_plain, qam_tables
    from dvbt2ll_tpu_torch.pipeline import select_step_iq
    from dvbt2ll_tpu_torch.profile_step import cuda_ms
    from dvbt2ll_tpu_torch.tools.roofline import bound
    times = {}
    for key, name, frames in QAM_CASES:
        cfg = named_config(name)
        pp = build_plan(cfg, 1, strict=False).plps[0]
        t = qam_tables(pp, dev)
        # the twin on the card: its int64 indices moved there
        plain = dataclasses.replace(t, perm=qam_tables(pp, "cpu").perm.to(dev))
        bits = torch.from_numpy(rng.integers(
            0, 2, (frames, t.frame_bits), dtype=np.uint8)).to(dev)
        re, im = qam_map(t, bits, planar=True)
        cells = qam_map(t, bits, planar=False)
        want_re, want_im = qam_map_plain(plain, bits)
        torch.cuda.synchronize()
        require(torch.equal(re, want_re) and torch.equal(im, want_im),
                f"{name}: mapper kernel's planes differ from its twin")
        require(torch.equal(cells, torch.complex(want_re, want_im)),
                f"{name}: mapper kernel's complex cells differ from its twin")
        planar = select_step_iq(cfg)[1]

        def twin():
            planes = qam_map_plain(plain, bits)
            return planes if planar else torch.complex(*planes)

        ms = cuda_ms(lambda: qam_map(t, bits, planar))
        other_ms = cuda_ms(lambda: qam_map(t, bits, not planar))
        plain_ms = cuda_ms(twin)
        # each codeword bit a byte read once, each cell's 8 bytes written
        # once; the levels and the rotation are a few operations a cell
        bound_ms, by = bound(frames * (t.frame_bits + t.cells * 8), 0.0)
        layout = "planar" if planar else "complex"
        print(f"qam_map {name} F={frames}: bit-exact in both layouts, "
              f"kernel ({layout}) {ms:.4f} ms, other layout "
              f"{other_ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"({plain_ms / ms:.2f}x); bound {bound_ms:.4f} ms ({by}), "
              f"share of bound {bound_ms / ms:.3f}")
        times[key] = dict(err=0, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=by, library_ms=None,
                          other_layout_ms=other_ms)
    return times


def tail_phase(torch, dev, rng) -> dict:
    """The fused OFDM tail kernel against its plain twin on the same grids
    and P1: P1 bit for bit, the rest above TAIL_DB; the timed shapes
    beside their bound and ``torch.fft.ifft`` (cuFFT) on (B S, fft)
    complex64, the one PyTorch call that computes the transform."""
    from dvbt2ll_tpu_torch.ops.ifft import (P1_LEN, ifft_gi,
                                            ofdm_tail_plain, tail_tables)
    from dvbt2ll_tpu_torch.profile_step import cuda_ms
    times = {}
    for (b, s), fft, gi, timed in TAIL_CASES:
        shape = (b, s, fft // 128, 128)
        re, im = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev) for _ in range(2))
        p1 = torch.from_numpy(rng.standard_normal((P1_LEN, 2)).astype(
            np.float32)).to(dev)
        scale = 1.0 / np.sqrt(fft)
        tables = tail_tables(fft, scale, dev)
        got = ifft_gi(re, im, p1, fft, gi, scale, tables)
        want = ofdm_tail_plain(re, im, p1, fft, gi, scale, tables)
        torch.cuda.synchronize()
        require(tuple(got.shape) == tuple(want.shape)
                == (b, P1_LEN + s * (fft + gi), 2)
                and got.stride() == want.stride()
                and got.dtype == torch.float32,
                f"tail {fft}/{gi}: output shape, strides or dtype")
        require(torch.equal(got[:, :P1_LEN], want[:, :P1_LEN]),
                f"tail {fft}/{gi}: P1 not in place")
        snr = snr_db(torch.view_as_complex(want).cpu().numpy(),
                     torch.view_as_complex(got).cpu().numpy())
        err = float((got - want).abs().max())
        require(snr > TAIL_DB, f"tail {fft}/{gi}: kernel vs twin {snr:.2f} dB")
        line = (f"ifft_gi fft {fft} gi {gi} grids {shape}: kernel vs twin "
                f"{snr:.2f} dB, max abs err {err:.3e}")
        if timed:
            ms = cuda_ms(lambda: ifft_gi(re, im, p1, fft, gi, scale, tables))
            plain_ms = cuda_ms(lambda: ofdm_tail_plain(re, im, p1, fft, gi,
                                                       scale, tables))
            natural = torch.complex(re, im).reshape(b * s, fft)
            library_ms = cuda_ms(lambda: torch.fft.ifft(natural, dim=-1))
            bound_ms, by = tail_bound(re, im, p1, tables, got, fft)
            times[timed] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=by,
                                library_ms=library_ms)
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                     f"({plain_ms / ms:.2f}x), torch.fft.ifft on ({b * s}, "
                     f"{fft}) {library_ms:.4f} ms; bound {bound_ms:.4f} ms "
                     f"({by}), share of bound {bound_ms / ms:.3f}")
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


def kernel_counts(fec, tail, fft=0) -> dict:
    """Launch counts of the kernels: ``fec`` of the BB/BCH, the LDPC and
    the mapper kernel (each once a PLP a step), ``tail`` of the planar
    tail kernel, ``fft`` of the complex tail's transform (once a step, or
    a slab)."""
    return {"bb_bch": fec, "ldpc_parity": fec, "qam_map": fec,
            "ifft_gi": tail, "fft_tail": fft}


def reset_launches() -> None:
    from dvbt2ll_tpu_torch.ops import kernel_wrappers
    for f in kernel_wrappers().values():
        f.launches = 0


def launches() -> dict:
    from dvbt2ll_tpu_torch.tools import kernel_launches
    return kernel_launches()


def full_width_phase(torch, dev, name: str, steps: int) -> dict:
    """``name`` at batch 256 through ``step_device``: step 0 against the
    port on the CPU, then ``steps`` streaming steps, timed."""
    from dvbt2ll_tpu_torch import Transmitter, named_config, synthetic_ts
    from dvbt2ll_tpu_torch.pipeline import bb_and_fec, select_step_iq
    cfg = named_config(name)
    planar = select_step_iq(cfg)[1]
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
    want = kernel_counts(1 + steps, (1 + steps) * planar,
                         (1 + steps) * (not planar))
    require(counts == want, f"{name}: launches {counts} in {1 + steps} "
            f"steps, expected {want}")
    rate = samples / dt / 1e6
    print(f"{name} batch {BATCH} ({'planar' if planar else 'complex'} "
          f"tail): FEC bits of {bits.shape[0]} frames equal "
          f"the CPU's; step 0 IQ vs CPU {snr:.2f} dB; {steps} streaming "
          f"steps in {dt:.4f} s = {rate:.2f} Msamples/s; launches {counts}")
    return counts


def matrix_config(case):
    """A MATRIX case's T2Config (the port's)."""
    from dvbt2ll_tpu_torch.config import T2Config
    return T2Config.from_dict(case["kw"]).validate()


def matrix_case(torch, dev, case) -> dict:
    """One MATRIX case at its test batch, on ``dev`` against the port on
    the CPU, through ``Transmitter.step_device``: a step's FEC bits equal
    exactly, its IQ is above IQ_CPU_DB, and it launches ``bb_bch`` and
    ``ldpc_parity`` once and ``ifft_gi`` once on the planar tail, never
    on the complex one.  With ``steps`` > 1 each step has its own
    Transmitter, built with ``start_phases`` = the previous plan's
    ``bb.next_phase`` and resumed from the previous one's checkpoint, on
    either device.  Returns the
    tail, the lowest SNR, the launches summed over the steps and the
    steps' time on the host clock, fenced."""
    from dvbt2ll_tpu_torch import Transmitter, synthetic_ts
    from dvbt2ll_tpu_torch.pipeline import bb_and_fec, select_step_iq
    cfg = matrix_config(case)
    planar = select_step_iq(cfg)[1]
    b, steps = case["batch"], case["steps"]
    kw = dict(strict=False, allow_phase_drift=True)
    tx = ref = ts = None
    pos, phase, snrs, dt = 0, 0, [], 0.0
    total = kernel_counts(0, 0)
    for k in range(steps):
        states = None if tx is None else (tx.state_dict(), ref.state_dict())
        tx = Transmitter(cfg, b, start_phases=phase, device=dev, **kw)
        ref = Transmitter(cfg, b, start_phases=phase, device="cpu", **kw)
        if states:
            tx.load_state(states[0])
            ref.load_state(states[1])
        n = tx.bytes_per_step
        if ts is None:
            ts = synthetic_ts(steps * n, seed=case["seed"])
        fresh, pos = ts[pos:pos + n], pos + n
        window = np.concatenate([tx.state_dict()["carries"][0], fresh])
        bits = bb_and_fec(tx.tensors.plps[0], torch.from_numpy(window).to(dev))
        bits_ref = bb_and_fec(ref.tensors.plps[0], torch.from_numpy(window))
        require(torch.equal(bits.cpu(), bits_ref),
                f"{case['id']} step {k}: FEC bits, card != CPU")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        iq = tx.step_device(fresh)
        torch.cuda.synchronize()
        dt += time.perf_counter() - t0
        counts = launches()
        require(counts == kernel_counts(1, int(planar), int(not planar)),
                f"{case['id']} step {k}: launches {counts}")
        total = {key: total[key] + counts[key] for key in total}
        got = iq.cpu().numpy().reshape(b, -1).view(np.complex64)
        snrs.append(snr_db(ref(fresh), got))
        require(snrs[-1] > IQ_CPU_DB, f"{case['id']} step {k}: IQ vs CPU "
                f"{snrs[-1]:.2f} dB")
        require(tuple(iq.shape) == (b, cfg.samples_per_frame, 2)
                and bool(torch.isfinite(iq).all()),
                f"{case['id']} step {k}: shape {tuple(iq.shape)} or "
                f"non-finite IQ")
        phase = tx.plan.plps[0].bb.next_phase
    return dict(tail="planar" if planar else "complex", snr=min(snrs),
                launches=total, ms=dt * 1e3)


def full_width_batch(cfg) -> int:
    """BATCH, or for HIEFF, whose steps must hold whole TS packets, the
    largest multiple of its smallest batch that is not above BATCH."""
    from dvbt2ll_tpu_torch import min_batch_frames
    from dvbt2ll_tpu_torch.config import InputMode
    if cfg.input_mode != InputMode.HIEFF:
        return BATCH
    m = min_batch_frames(cfg)
    return max(m, BATCH - BATCH % m)


def matrix_full_width(torch, dev, case) -> dict:
    """A MATRIX case at ``full_width_batch`` in drift mode, as
    ``full_width_phase`` runs its configs: one step, then a second one,
    each timed on the host clock (the first pays the geometry's first
    call: allocations and, for ``torch.fft``, its plans); the output's
    shape, finite values, frame counter, carry, counters and launches.
    The rates are information."""
    from dvbt2ll_tpu_torch import Transmitter, synthetic_ts
    from dvbt2ll_tpu_torch.pipeline import select_step_iq
    cfg = matrix_config(case)
    planar = select_step_iq(cfg)[1]
    b = full_width_batch(cfg)
    tx = Transmitter(cfg, b, strict=False, allow_phase_drift=True,
                     device=dev)
    n = tx.bytes_per_step
    ts = synthetic_ts(2 * n, seed=SEED + case["seed"])
    torch.cuda.synchronize()
    reset_launches()
    ms = []
    for k in range(2):
        t0 = time.perf_counter()
        out = tx.step_device(ts[k * n:(k + 1) * n])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = launches()
    name = f"{case['id']} batch {b}"
    require(tuple(out.shape) == (b, cfg.samples_per_frame, 2),
            f"{name}: output shape {tuple(out.shape)}")
    require(bool(torch.isfinite(out).all()), f"{name}: non-finite IQ")
    state = tx.state_dict()
    require(state["frame_idx"] == 2 * b % cfg.t2_frames
            and state["steps_done"] == 2, f"{name}: frame counter")
    require(np.array_equal(state["carries"][0], ts[-187:]), f"{name}: carry")
    require(tx.counters.frames == 2 * b, f"{name}: counters")
    require(counts == kernel_counts(2, 2 * int(planar),
                                    2 * int(not planar)),
            f"{name}: launches {counts} in 2 steps")
    return dict(batch=b, launches=counts, ms=ms,
                rate=b * cfg.samples_per_frame / ms[1] / 1e3)


def matrix_phase(torch, dev) -> dict:
    """Phase 4b: every MATRIX case at its test batch against the CPU
    (``matrix_case``), then at full width (``matrix_full_width``); one
    line a case.  Returns the launches of each part, summed."""
    t_start = time.perf_counter()
    paths = {"matrix": kernel_counts(0, 0),
             "matrix_full_width": kernel_counts(0, 0)}
    for case in MATRIX:
        got = matrix_case(torch, dev, case)
        wide = matrix_full_width(torch, dev, case)
        for path, counts in (("matrix", got["launches"]),
                             ("matrix_full_width", wide["launches"])):
            for key in counts:
                paths[path][key] += counts[key]
        print(f"matrix {case['id']} ({case['test']}; {got['tail']} tail): "
              f"batch {case['batch']} x {case['steps']} step(s), FEC "
              f"bit-exact, IQ vs CPU {got['snr']:.2f} dB, launches "
              f"{got['launches']}, {got['ms']:.2f} ms; batch "
              f"{wide['batch']}: first step {wide['ms'][0]:.2f} ms, second "
              f"{wide['ms'][1]:.2f} ms = {wide['rate']:.2f} Msamples/s, "
              f"launches {wide['launches']}")
        torch.cuda.empty_cache()
    print(f"matrix: {len(MATRIX)} cases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    return paths


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
    require(counts == kernel_counts(len(ns) * MPLP_STEPS,
                                    MPLP_STEPS),
            f"multiplp: launches {counts} in {MPLP_STEPS} steps of "
            f"{len(ns)} PLPs")
    fefs = sum(g.size for g in got) - MPLP_STEPS * b * cfg.samples_per_frame
    rate = sum(g.size for g in got) / dt / 1e6
    print(f"multiplp_fef batch {b} ({len(ns)} PLPs), {MPLP_STEPS} strict "
          f"steps through stream_window: {fefs // cfg.fef_length} FEF parts "
          f"in place, lengths equal, IQ vs CPU stream {snr:.2f} dB, "
          f"state equal; {dt:.4f} s = {rate:.2f} Msamples/s emitted "
          f"(device-to-host copy included); launches {counts}")
    return counts, rate


@contextlib.contextmanager
def pipe_ingest(data: np.ndarray):
    """``data`` written into a real OS pipe by a thread and read back by
    the native TS ingest ring's pump thread.  Yields (source, ingest):
    ``source(n)`` gives the next n fresh TS bytes, waiting for the ring."""
    from dvbt2ll_tpu_torch.io.ingest import TSIngest
    rfd, wfd = os.pipe()

    def feed():
        with os.fdopen(wfd, "wb") as f:
            f.write(data.tobytes())

    feeder = threading.Thread(target=feed, daemon=True)
    feeder.start()
    try:
        with TSIngest(fd=rfd, capacity=1 << 25) as ing:
            ing.start_thread()

            def source(nbytes):
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    w = ing.window(nbytes, allow_stuffing=False)
                    if w is not None:
                        return w[187:]
                    time.sleep(0.0002)
                raise RuntimeError("chip_smoke: the ingest ring gave no "
                                   "window in 60 s")

            yield source, ing
    finally:
        feeder.join(timeout=30)
        os.close(rfd)
        require(not feeder.is_alive(), "the pipe feeder did not finish")


class ListSink:
    def __init__(self):
        self.chunks = []

    def write(self, iq):
        self.chunks.append(iq)


def executor_phase(torch, dev) -> dict:
    """vv009 strict through ``StreamingExecutor`` on the card, fed by the
    native ingest ring over a pipe: every step's output, kept by the
    caller until the end, bit-identical to ``Transmitter.stream`` on the
    card over the same TS."""
    from dvbt2ll_tpu_torch import (StreamingExecutor, Transmitter,
                                   min_batch_frames, synthetic_ts,
                                   vv009_config)
    from dvbt2ll_tpu_torch.executor import _HostCopy
    cfg = vv009_config()
    b = min_batch_frames(cfg)
    tx = Transmitter(cfg, b, validate_ts=True, device=dev)
    ref = Transmitter(cfg, b, device=dev)
    n = tx.bytes_per_step
    ts = synthetic_ts(RUNTIME_STEPS * n, seed=SEED + 200)
    want = [ref.stream(ts[k * n:(k + 1) * n]) for k in range(RUNTIME_STEPS)]

    sink = ListSink()
    with pipe_ingest(ts) as (source, ing):
        ex = StreamingExecutor(tx, source, sink)
        reset_launches()
        got = [ex.step() for _ in range(RUNTIME_STEPS)]
        pending = ex._pending[0]
        got.append(ex.flush())
        counts = launches()
        stats = ing.stats
    require(got[0] is None, "executor: first step returned IQ")
    require(isinstance(pending, _HostCopy) and pending.host.is_pinned(),
            "executor: the card's output did not go to pinned memory")
    for k, (g, w, c) in enumerate(zip(got[1:], want, sink.chunks)):
        require(g is c and g.shape == (b, cfg.samples_per_frame)
                and np.array_equal(g.reshape(-1), w),
                f"executor step {k}: not bit-identical to stream")
    require(len(sink.chunks) == RUNTIME_STEPS, "executor: sink writes")
    require(stats["sync_errors"] == 0 and tx.counters.sync_errors == 0,
            f"executor: sync errors {stats} {tx.counters}")
    require(counts == kernel_counts(RUNTIME_STEPS, RUNTIME_STEPS),
            f"executor: launches {counts} in {RUNTIME_STEPS} steps")
    print(f"executor vv009 batch {b}, {RUNTIME_STEPS} strict steps from a "
          f"pipe through the native ingest ring: every returned array "
          f"bit-identical to stream on the card after the last step; "
          f"pinned host copies; ingest {stats}; launches {counts}")
    return counts


def paced_phase(torch, dev, tmp: str) -> dict:
    """About PACED_SECONDS of vv009 air through the executor, paced at the
    profile's rate, from the ingest ring into the native async sink."""
    from dvbt2ll_tpu_torch import (StreamingExecutor, Transmitter,
                                   min_batch_frames, synthetic_ts,
                                   vv009_config)
    from dvbt2ll_tpu_torch.io.native_sink import NativeIQSink
    cfg = vv009_config()
    b = min_batch_frames(cfg)
    tx = Transmitter(cfg, b, validate_ts=True, device=dev)
    n = tx.bytes_per_step
    step_t = b * cfg.emitted_frame_duration
    steps = max(2, round(PACED_SECONDS / step_t))
    path = os.path.join(tmp, "paced.cf32")
    ts = synthetic_ts((1 + steps) * n, seed=SEED + 300)
    with pipe_ingest(ts) as (source, ing):
        sink = NativeIQSink(path, gain=GAIN)
        try:
            ex = StreamingExecutor(tx, source, sink, realtime=True)
            ex.step()   # warm-up, outside the schedule; its output counts
            ex.flush()
            reset_launches()
            t0 = time.perf_counter()
            ex.run(steps)
            sink.flush()
            wall = time.perf_counter() - t0
            counts = launches()
            written, stalls = sink.samples_written, sink.producer_stalls
        finally:
            sink.close()
        stats = ing.stats
    lag = wall - steps * step_t
    want = (1 + steps) * b * cfg.samples_per_frame   # warm-up step included
    require(lag <= step_t, f"paced: lag {lag:.4f} s over {steps} steps of "
            f"{step_t:.4f} s")
    require(tx.counters.sync_errors == 0 and stats["sync_errors"] == 0
            and stats["null_stuffed"] == 0, f"paced: ingest {stats}, "
            f"{tx.counters.sync_errors} sync errors")
    require(written == want and os.path.getsize(path) == 8 * want,
            f"paced: sink {written} samples, file {os.path.getsize(path)} "
            f"bytes, expected {want} samples")
    require(counts == kernel_counts(steps, steps),
            f"paced: launches {counts} in {steps} steps")
    print(f"paced vv009 batch {b}: {steps} steps of {step_t:.4f} s air "
          f"({steps * step_t:.2f} s) in {wall:.4f} s, lag {lag:.4f} s "
          f"(bound {step_t:.4f}), sync errors 0, sink {written} samples = "
          f"(1 warm-up + {steps}) x {b} x {cfg.samples_per_frame}, "
          f"producer stalls {stalls}; launches {counts}")
    return counts


def app_phase(torch, dev, tmp: str) -> None:
    """The app as a subprocess on the card against the port on the CPU."""
    from dvbt2ll_tpu_torch import (Transmitter, min_batch_frames,
                                   synthetic_ts, vv009_config)
    cfg = vv009_config()
    b = min_batch_frames(cfg)
    out = os.path.join(tmp, "app.cf32")
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "dvbt2ll_tpu_torch.apps.vv009_4kshort", out,
         "--frames", str(2 * b), "--native-sink", "--device", str(dev)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    dt = time.perf_counter() - t0
    require(res.returncode == 0, f"app: rc {res.returncode}\n{res.stderr}")
    tx = Transmitter(cfg, b, device="cpu")
    want = np.concatenate([tx.stream(synthetic_ts(tx.bytes_per_step,
                                                  seed=i))
                           for i in range(2)]) * np.float32(GAIN)
    got = np.fromfile(out, dtype=np.complex64)
    require(got.shape == want.shape, f"app: {got.size} samples, expected "
            f"{want.size}")
    snr = snr_db(want, got)
    require(snr > IQ_CPU_DB, f"app: cf32 vs CPU {snr:.2f} dB")
    print(f"app vv009_4kshort --device {dev} --native-sink, 2 strict steps "
          f"of {b} frames, subprocess {dt:.2f} s: cf32 vs CPU stream x "
          f"{GAIN} {snr:.2f} dB; it said: {res.stdout.strip()}")


def rate_phase(torch, dev, name: str, batch: int, strict: bool,
               stream_rate=None) -> dict:
    """Emitted Msamples/s of ``StreamingExecutor`` (pinned asynchronous
    copy, overlapped) and of a ``stream`` loop (pageable blocking copy),
    both with the device-to-host copy and FEF insertion included."""
    from dvbt2ll_tpu_torch import (StreamingExecutor, Transmitter,
                                   named_config, synthetic_ts)
    cfg = named_config(name)
    kw = (dict(strict=True) if strict
          else dict(strict=False, allow_phase_drift=True))
    tx = Transmitter(cfg, batch, device=dev, **kw)
    ns = tx.bytes_per_step_per_plp
    data = [synthetic_ts((2 + RATE_STEPS) * m, seed=SEED + 400 + i)
            for i, m in enumerate(ns)]

    def one(k):
        ts = [d[k * m:(k + 1) * m] for d, m in zip(data, ns)]
        return ts if len(ts) > 1 else ts[0]

    pos = [0] * len(ns)

    def reader(i):
        def source(nbytes):
            o = pos[i]
            pos[i] += nbytes
            return data[i][o:o + nbytes]
        return source

    ex = StreamingExecutor(tx, [reader(i) for i in range(len(ns))])
    ex.step()
    ex.flush()   # warm-up
    emitted = 0
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RATE_STEPS):
        prev = ex.step()
        emitted += 0 if prev is None else prev.size
    emitted += ex.flush().size
    dt = time.perf_counter() - t0
    counts = launches()
    ex_rate = emitted / dt / 1e6
    if stream_rate is None:
        ref = Transmitter(cfg, batch, device=dev, **kw)
        ref.stream(one(0))
        t0 = time.perf_counter()
        total = sum(ref.stream(one(1 + k)).size for k in range(RATE_STEPS))
        stream_rate = total / (time.perf_counter() - t0) / 1e6
        label = "stream"
    else:
        label = "stream_window (phase 7)"
    want = kernel_counts(RATE_STEPS * len(ns), RATE_STEPS)
    require(counts == want, f"rate {name}: launches {counts}, expected {want}")
    print(f"executor {name} batch {batch}: {RATE_STEPS} steps, "
          f"{emitted} samples emitted in {dt:.4f} s = {ex_rate:.2f} "
          f"Msamples/s (pinned asynchronous copy included); {label} "
          f"{stream_rate:.2f} Msamples/s (pageable copy included); "
          f"launches {counts}")
    return counts


def pinned_cost(torch) -> None:
    """What the executor's pinned buffers cost: a fresh pinned allocation
    of one vv009 batch-256 step (the price when the caller keeps every
    array) against one from the caching host allocator (the price when
    the caller lets the previous one go)."""
    from dvbt2ll_tpu_torch import vv009_config
    nbytes = BATCH * vv009_config().samples_per_frame * 8
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        times.append((time.perf_counter() - t0) * 1e3)
        del buf
    print(f"pinned host buffer of {nbytes} bytes: fresh {times[0]:.4f} ms, "
          f"from the cache {times[1]:.4f} ms")


def sync(torch, devices) -> None:
    for d in {torch.device(d) for d in devices}:
        torch.cuda.synchronize(d)


def same_blocks(torch, got, want, what: str) -> None:
    """Two ``step_device`` block lists, bit for bit, each block on its
    slot's device."""
    for c, (g_row, w_row) in enumerate(zip(got, want)):
        for s, (g, w) in enumerate(zip(g_row, w_row)):
            require(g.device == w.device and torch.equal(g, w),
                    f"{what}: block ({c}, {s}) differs")


def sharded_phase(torch, slots, label: str) -> tuple:
    """BASELINE config 5 at full width: vv009 as SHARD_MUX independent
    muxes, strict at 47 frames a shard, over a (SHARD_MUX, SHARD_FRAME)
    mesh of ``slots``; each mux held bit for bit against its own strict
    ``Transmitter`` of 47 frames on the block's device."""
    from dvbt2ll_tpu_torch import (ShardedTransmitter, Transmitter,
                                   make_mesh, min_batch_frames, synthetic_ts,
                                   vv009_config)
    cfg = vv009_config()
    b = min_batch_frames(cfg)
    mesh = make_mesh(slots, mux=SHARD_MUX)
    require(mesh.shape == {"mux": SHARD_MUX, "frame": SHARD_FRAME},
            f"{label}: mesh {mesh.shape}")
    stx = ShardedTransmitter(cfg, mesh, n_mux=SHARD_MUX, frames_per_shard=b)
    n = stx.bytes_per_step_per_mux
    ts = np.stack([synthetic_ts(SHARD_STEPS * n, seed=SEED + 500 + c)
                   for c in range(SHARD_MUX)])
    devices = mesh.local_devices()
    for d in devices:  # a card's first step loads its libraries: not timed
        warm = Transmitter(cfg, b, strict=True, device=d)
        warm.step_device(np.zeros(warm.bytes_per_step, np.uint8))
    sync(torch, devices)
    reset_launches()
    t0 = time.perf_counter()
    outs = [stx.step_device(ts[:, k * n:(k + 1) * n])
            for k in range(SHARD_STEPS)]
    sync(torch, devices)
    dt = time.perf_counter() - t0
    counts = launches()
    blocks = SHARD_MUX * SHARD_FRAME
    # a card's blocks are one batched call: each kernel once a card a step
    want = kernel_counts(len(devices) * SHARD_STEPS,
                         len(devices) * SHARD_STEPS)
    require(counts == want, f"{label}: launches {counts} in {SHARD_STEPS} "
            f"steps of {blocks} blocks on {len(devices)} card(s), expected "
            f"{want}")

    for c in range(SHARD_MUX):
        tx = Transmitter(cfg, b, strict=True, device=mesh.devices[c, 0])
        m = tx.bytes_per_step
        for k in range(SHARD_STEPS):
            for s in range(SHARD_FRAME):
                o = outs[k][c][s]
                require(o.device == mesh.devices[c, s],
                        f"{label}: block ({c}, {s}) on {o.device}")
                i = k * SHARD_FRAME + s
                ref = tx.step_device(ts[c, i * m:(i + 1) * m])
                require(torch.equal(o, ref.to(o.device)),
                        f"{label}: mux {c} step {k} shard {s} differs from "
                        f"its sequential Transmitter")
    require(bool(all(torch.isfinite(o).all() for row in outs[-1]
                     for o in row)), f"{label}: non-finite IQ")
    state = stx.state_dict()
    require(np.array_equal(state["carries"][:, 0], ts[:, -187:])
            and state["step_no"] % cfg.t2_frames
            == SHARD_STEPS % cfg.t2_frames,
            f"{label}: state {state['step_no']}")

    frames = SHARD_MUX * stx.frames_per_step   # a step, all muxes
    rate = SHARD_STEPS * frames * cfg.samples_per_frame / dt / 1e6
    # one Transmitter of the same total frames a step (752 = 16 x 47,
    # phase-invariant)
    one = Transmitter(cfg, frames, strict=True, device=devices[0])
    one_ts = synthetic_ts((1 + SHARD_STEPS) * one.bytes_per_step,
                          seed=SEED + 600)
    one.step_device(one_ts[:one.bytes_per_step])   # warm-up, new shapes
    sync(torch, devices)
    t0 = time.perf_counter()
    for k in range(1, 1 + SHARD_STEPS):
        one.step_device(one_ts[k * one.bytes_per_step:
                               (k + 1) * one.bytes_per_step])
    sync(torch, devices)
    one_rate = (SHARD_STEPS * frames * cfg.samples_per_frame
                / (time.perf_counter() - t0) / 1e6)
    print(f"{label}: vv009 x {SHARD_MUX} muxes, mesh {mesh.shape} over "
          f"{len(slots)} slots of {[str(d) for d in devices]}, {b} frames "
          f"a shard, strict, {SHARD_STEPS} steps of {frames} frames "
          f"({frames * cfg.samples_per_frame * 8 / 1e6:.1f} MB of IQ a "
          f"step): every mux bit-identical to its own strict Transmitter "
          f"of {b} frames over {SHARD_STEPS * SHARD_FRAME} steps; launches "
          f"{counts} (one of each kernel a card a step for {blocks} "
          f"blocks); aggregate "
          f"{rate:.2f} Msamples/s ({SHARD_STEPS} steps in {dt:.4f} s, host "
          f"staging included) beside one Transmitter of {frames} frames "
          f"at {one_rate:.2f} Msamples/s (information, not a claim)")
    return counts, stx, ts


def no_peer_copies(torch, stx, ts) -> None:
    """One more step of ``stx`` under torch.profiler: device activity
    recorded, no peer-to-peer memcpy among it, and one graph launch a
    card."""
    from torch.profiler import ProfilerActivity, profile
    from dvbt2ll_tpu_torch.tools import host_api_calls
    n = stx.bytes_per_step_per_mux
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stx.step_device(ts[:, :n])
        sync(torch, stx.mesh.local_devices())
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events)
    p2p = [e.key for e in events if "PtoP" in e.key]
    require(device_us > 0, "profiled sharded step: no device time recorded")
    require(not p2p, f"profiled sharded step: peer-to-peer copies {p2p}")
    cards = len(stx.mesh.local_devices())
    calls = host_api_calls(prof, 1)
    require(calls["cudaGraphLaunch"] == cards, f"profiled sharded step: "
            f"{calls['cudaGraphLaunch']} graph launches on {cards} cards")
    print(f"profiled sharded step over {cards} cards: {device_us:.1f} us "
          f"of device time, no peer-to-peer memcpy, one graph launch a "
          f"card; host CUDA calls {calls}")


def multimux_phase(torch, dev, tmp: str) -> dict:
    """A heterogeneous ``MultiMuxTransmitter`` on 6 slots of the card: a
    vv009 group (2 muxes, strict at 47 frames a shard, planar tail) beside
    a 32k_extended group (1 mux, 2 frames a shard, drift mode, complex
    tail), 2 steps; each channel bit-identical to its standalone
    ``ShardedTransmitter``, and a restored checkpoint reproducing step 2."""
    from dvbt2ll_tpu_torch import (MultiMuxTransmitter, MuxChannel,
                                   ShardedTransmitter, make_mesh,
                                   min_batch_frames, named_config,
                                   synthetic_ts, vv009_config)
    cfg_a, cfg_b = vv009_config(), named_config("32k_extended")
    b_a = min_batch_frames(cfg_a)
    specs = [MuxChannel(cfg_a, n_mux=2, n_devices=4, frames_per_shard=b_a),
             MuxChannel(cfg_b, n_mux=1, n_devices=2, frames_per_shard=2,
                        strict=False, allow_phase_drift=True)]
    slots = [dev] * 6
    mm = MultiMuxTransmitter(specs, devices=slots)
    na, nb = mm.bytes_per_step
    steps = [[np.stack([synthetic_ts(na, seed=SEED + 700 + 10 * k + c)
                        for c in range(2)]),
              synthetic_ts(nb, seed=SEED + 800 + k)[None]] for k in range(2)]
    path = os.path.join(tmp, "multimux.npz")
    reset_launches()
    out1 = mm.step_device(steps[0])
    mm.save(path)
    out2 = mm.step_device(steps[1])
    sync(torch, [dev])
    counts = {"multimux": launches()}
    # each group's blocks on the card are one batched call
    want = kernel_counts(2 * (1 + 1), 2 * 1, 2 * 1)
    require(counts["multimux"] == want, f"multimux: launches "
            f"{counts['multimux']} in 2 steps, expected {want}")

    refs = [ShardedTransmitter(cfg_a, make_mesh(slots[:4], mux=2), n_mux=2,
                               frames_per_shard=b_a),
            ShardedTransmitter(cfg_b, make_mesh(slots[4:], mux=1), n_mux=1,
                               frames_per_shard=2, strict=False,
                               allow_phase_drift=True)]
    for i, (ref, name) in enumerate(zip(refs, ("multimux_vv009",
                                               "multimux_32k"))):
        reset_launches()
        r1 = ref.step_device(steps[0][i])
        r2 = ref.step_device(steps[1][i])
        sync(torch, [dev])
        counts[name] = launches()
        same_blocks(torch, out1[i], r1, f"{name} step 1")
        same_blocks(torch, out2[i], r2, f"{name} step 2")
    require(counts["multimux_vv009"] == kernel_counts(2, 2)
            and counts["multimux_32k"] == kernel_counts(2, 0, 2),
            f"multimux channels: launches {counts}")

    mm2 = MultiMuxTransmitter(specs, devices=slots)
    mm2.restore(path)
    again = mm2.step_device(steps[1])
    for i in range(2):
        same_blocks(torch, again[i], out2[i], f"multimux restored ch{i}")
    print(f"multimux on {len(slots)} slots of {dev}: vv009 (2 muxes x 2 "
          f"shards x {b_a} frames, planar tail) + 32k_extended (1 mux x 2 "
          f"shards x 2 frames, complex tail), 2 steps: each channel "
          f"bit-identical to its standalone ShardedTransmitter; checkpoint "
          f"after step 1 restored into a new transmitter reproduced step 2 "
          f"bit for bit; launches {counts}")
    return counts


def symbol_sharded_phase(torch, slots) -> dict:
    """32k_extended, 1 frame, the symbol axis over ``slots``: the compiled
    callable (a graph on one card, else a graph a card segment) against
    its eager form and the whole complex step on the first slot's card,
    bit for bit, at frame indices 0 and 1; then both timed on the host
    clock, fenced, a call at a time."""
    from dvbt2ll_tpu_torch import (build_plan, grids_symbol_sharded,
                                   make_mesh, named_config, plan_tensors,
                                   synthetic_ts, transmit_step_iq)
    cfg = named_config("32k_extended")
    plan = build_plan(cfg, 1, strict=False)
    fn = grids_symbol_sharded(plan, make_mesh(slots, mux=1))
    dev = fn.dev0
    cards = list(dict.fromkeys(str(d) for d in fn.slots))
    require(len(fn.graphs) == (1 if len(cards) == 1 else len(cards) + 1),
            f"symbol-sharded over {cards}: {len(fn.graphs)} graphs")
    padded = torch.from_numpy(np.concatenate(
        [np.zeros(187, np.uint8),
         synthetic_ts(plan.ts_bytes_in, seed=SEED + 900)])).to(dev)
    tp = plan_tensors(plan, dev, False)
    counts = kernel_counts(0, 0)
    for idx in (0, 1):
        sync(torch, slots)
        reset_launches()
        got = fn(padded, idx)
        sync(torch, slots)
        counts = {k: counts[k] + v for k, v in launches().items()}
        require(torch.equal(got, fn.eager(padded, idx)),
                f"symbol-sharded 32k_extended over {cards} differs from its "
                f"eager form at frame index {idx}")
        require(torch.equal(got, transmit_step_iq(tp, padded, idx)),
                f"symbol-sharded 32k_extended over {cards} differs from "
                f"transmit_step_iq at frame index {idx}")
    require(counts == kernel_counts(2, 0, 2 * len(slots)),
            f"symbol-sharded: launches {counts}")

    def per_call(call) -> float:
        call(padded, 0)
        sync(torch, slots)
        times = []
        for _ in range(SYMBOL_CALLS):
            t0 = time.perf_counter()
            call(padded, 0)
            sync(torch, slots)
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    ms, eager_ms = per_call(fn), per_call(fn.eager)
    print(f"symbol-sharded 32k_extended, 1 frame ({cfg.num_symbols} "
          f"symbols, padded to {-(-cfg.num_symbols // len(slots))} a slab) "
          f"over {len(slots)} slots of {cards}: compiled ({len(fn.graphs)} "
          f"graph(s), capture {fn.capture_s * 1e3:.1f} ms, pools "
          f"{_mb(fn.pool_bytes):.1f} MiB) bit-identical to its eager form "
          f"and to transmit_step_iq at frame indices 0 and 1; a call "
          f"fenced, median of {SYMBOL_CALLS}: {ms:.4f} ms compiled, "
          f"{eager_ms:.4f} ms eager; launches {counts}")
    return counts


def dryrun_app_phase(torch, dev, tmp: str) -> None:
    """Both dry runs on the card, and the multi-mux app as a subprocess
    with two --config files."""
    from dvbt2ll_tpu_torch import named_config
    from dvbt2ll_tpu_torch.dryrun import dryrun_multichip, dryrun_multihost
    t0 = time.perf_counter()
    res = dryrun_multichip(8, dev)
    print(f"dryrun_multichip(8, {dev}): {res}, "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    line = dryrun_multihost(dev)
    print(f"dryrun_multihost on {dev}, {time.perf_counter() - t0:.2f} s: "
          f"{line}")
    paths = []
    for name in ("vv009_4kshort", "8k_normal"):
        p = os.path.join(tmp, f"{name}.json")
        with open(p, "w") as f:
            f.write(named_config(name).to_json())
        paths += ["--config", p]
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "dvbt2ll_tpu_torch.apps.multimux",
         "--device", str(dev), "--slots", "4", "--mux", "1", "--steps", "2",
         *paths], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    require(res.returncode == 0, f"multimux app: rc {res.returncode}\n"
            f"{res.stderr}")
    require("2 heterogeneous groups" in res.stdout,
            f"multimux app said: {res.stdout}")
    said = " | ".join(res.stdout.strip().splitlines())
    print(f"app multimux --device {dev} --slots 4, two --config groups, "
          f"subprocess {time.perf_counter() - t0:.2f} s: {said}")


def multi_device_phase(torch, dev, tmp: str) -> dict:
    """Phase 9: the multi-device layer, (a)-(e)."""
    counts, _, _ = sharded_phase(torch, [dev] * (SHARD_MUX * SHARD_FRAME),
                                 "sharded one card")
    paths = {"sharded_vv009_8mux": counts}
    mm_counts = multimux_phase(torch, dev, tmp)
    paths.update(mm_counts)
    paths["symbol_sharded_32k"] = symbol_sharded_phase(
        torch, [dev] * SYMBOL_SLOTS)
    dryrun_app_phase(torch, dev, tmp)
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        cards = [torch.device("cuda", i) for i in range(n_cards)]
        slots = [cards[i % n_cards] for i in range(SHARD_MUX * SHARD_FRAME)]
        counts, stx, ts = sharded_phase(torch, slots,
                                        f"sharded over {n_cards} cards")
        paths["sharded_vv009_8mux_cards"] = counts
        no_peer_copies(torch, stx, ts)
        paths["symbol_sharded_32k_cards"] = symbol_sharded_phase(
            torch, [cards[i % n_cards] for i in range(SYMBOL_SLOTS)])
    else:
        print(f"sharded over several cards: not run, "
              f"torch.cuda.device_count() is {n_cards}")
    return paths


def _one(x):
    return x if len(x) > 1 else x[0]


def _mb(nbytes: int) -> float:
    return nbytes / 2 ** 20


def compiled_path(torch, dev, name: str, batch, strict: bool) -> dict:
    """One full-width path through the compiled step: COMPILED_CHECK
    steps, every output kept until the end, each bit-identical to the
    eager step function on the same window and frame index; then
    COMPILED_STEPS steps of ``step_device`` on the host clock, fenced,
    beside the eager step's host path (``bench.eager_step_device``), each
    after a warm-up step and with its peak reserved memory; the capture's
    time and pool."""
    from dvbt2ll_tpu_torch import (Transmitter, min_batch_frames,
                                   named_config, synthetic_ts)
    from dvbt2ll_tpu_torch.bench import eager_step_device
    from dvbt2ll_tpu_torch.pipeline import select_step_iq
    from dvbt2ll_tpu_torch.profile_step import cuda_ms
    cfg = named_config(name)
    b = batch or 3 * min_batch_frames(cfg)
    kw = (dict(strict=True) if strict
          else dict(strict=False, allow_phase_drift=True))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r0 = torch.cuda.memory_reserved(dev)
    tx = Transmitter(cfg, b, device=dev, **kw)
    ns = tx.bytes_per_step_per_plp
    total = COMPILED_CHECK + 2 * (1 + COMPILED_STEPS)
    data = [synthetic_ts(total * n, seed=SEED + 1000 + i)
            for i, n in enumerate(ns)]
    fresh = [[d[k * n:(k + 1) * n] for d, n in zip(data, ns)]
             for k in range(total)]
    label = f"compiled {name} batch {b}"

    carries = [np.zeros(187, np.uint8) for _ in ns]
    kept = []
    for k in range(COMPILED_CHECK):
        ws = [np.concatenate([c, f]) for c, f in zip(carries, fresh[k])]
        carries = [w[-187:] for w in ws]
        kept.append((ws, tx._frame_idx, tx.step_window(_one(ws))))
    for k, (ws, idx, got) in enumerate(kept):
        want = tx._step_fn(tx.tensors, _one(
            [torch.from_numpy(w).to(dev) for w in ws]), idx)
        require(torch.equal(got, want), f"{label}: step {k} (frame index "
                f"{idx}) differs from the eager step")
    indices = [idx for _, idx, _ in kept]
    del kept

    def timed(step, first: int) -> tuple:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        step(_one(fresh[first]))   # warm-up: the caching allocator's blocks
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        for k in range(first + 1, first + 1 + COMPILED_STEPS):
            step(_one(fresh[k]))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return (dt / COMPILED_STEPS * 1e3, launches(),
                torch.cuda.max_memory_reserved(dev) - r0)

    ms, counts, peak = timed(tx.step_device, COMPILED_CHECK)
    eager_ms, _, eager_peak = timed(eager_step_device(tx),
                                    COMPILED_CHECK + 1 + COMPILED_STEPS)
    step = tx._compiled
    planar = select_step_iq(cfg)[1]
    want = kernel_counts(COMPILED_STEPS * len(ns),
                         COMPILED_STEPS * planar,
                         COMPILED_STEPS * (not planar))
    require(counts == want, f"{label}: launches {counts} under replay, "
            f"expected {want}")
    # the card's time: a replay, the eager step on the same static inputs,
    # and the copy that hands each step's output to the caller
    replay_ms = cuda_ms(step._graph.replay)
    eager_dev_ms = cuda_ms(lambda: tx._step_fn(
        tx.tensors, _one([w[0] for w in step.windows]), step.frame_idx[0]))
    copy_ms = cuda_ms(step._out.clone)
    print(f"{label}: {COMPILED_CHECK} steps (frame indices {indices}) "
          f"bit-identical to the eager step; device {replay_ms:.4f} ms a "
          f"replay, {eager_dev_ms:.4f} eager, output copy {copy_ms:.4f} "
          f"ms; step_device {ms:.4f} ms a "
          f"step compiled, {eager_ms:.4f} eager ({eager_ms / ms:.2f}x); "
          f"capture {step.capture_s * 1e3:.1f} ms, graph pool "
          f"{_mb(step.pool_bytes):.1f} MiB; peak reserved {_mb(peak):.1f} "
          f"MiB compiled (pool included), "
          f"{_mb(eager_peak - step.pool_bytes):.1f} MiB eager (pool left "
          f"out); launches {counts}")
    return dict(ms=ms, eager_ms=eager_ms, capture_s=step.capture_s,
                pool=step.pool_bytes, launches=counts, copy_ms=copy_ms)


def compiled_sharded(torch, dev) -> dict:
    """BASELINE config 5 through the compiled mesh step: vv009 as
    SHARD_MUX muxes, strict at 47 frames a block, over a (SHARD_MUX,
    SHARD_FRAME) mesh of 16 slots of the card, one graph of one batched
    call for all 16 blocks (each kernel launched once a step),
    t2_frames + 1 steps, every block bit-identical to the one-block
    eager step on its halo window and frame index; then the aggregate
    rate of the compiled step beside the eager blocks', and one step
    under torch.profiler: one graph launch, and the host's CUDA calls."""
    from torch.profiler import ProfilerActivity, profile
    from dvbt2ll_tpu_torch import (ShardedTransmitter, make_mesh,
                                   min_batch_frames, synthetic_ts,
                                   vv009_config)
    from dvbt2ll_tpu_torch.parallel import halo_windows
    from dvbt2ll_tpu_torch.tools import host_api_calls
    cfg = vv009_config()
    b = min_batch_frames(cfg)
    stx = ShardedTransmitter(cfg, make_mesh([dev] * (SHARD_MUX * SHARD_FRAME),
                                            mux=SHARD_MUX),
                             n_mux=SHARD_MUX, frames_per_shard=b)
    n = stx.bytes_per_step_per_mux
    total = cfg.t2_frames + 1 + 2 * (1 + SHARD_STEPS)
    ts = [np.stack([synthetic_ts(n, seed=SEED + 1100 + 16 * k + c)
                    for c in range(SHARD_MUX)]) for k in range(total)]
    carries = np.zeros((SHARD_MUX, 187), np.uint8)
    for k in range(cfg.t2_frames + 1):
        windows = halo_windows(ts[k], carries, SHARD_FRAME)
        carries = ts[k][:, -187:]
        base = (k % cfg.t2_frames) * stx.frames_per_step
        out = stx.step_device(ts[k])
        for c in range(SHARD_MUX):
            for s in range(SHARD_FRAME):
                d = stx.mesh.devices[c, s]
                want = stx._step_fn(stx.tensors[d], torch.from_numpy(
                    windows[c, s]).to(d), (base + s * b) % cfg.t2_frames)
                require(torch.equal(out[c][s], want), f"compiled sharded: "
                        f"step {k} block ({c}, {s}) differs from the eager "
                        f"step")

    def eager_step(step_ts):
        nonlocal carries
        windows = halo_windows(step_ts, carries, SHARD_FRAME)
        carries = step_ts[:, -187:]
        staged = [(stx.mesh.devices[c, s],
                   torch.tensor(windows[c, s], device=stx.mesh.devices[c, s]))
                  for c in range(SHARD_MUX) for s in range(SHARD_FRAME)]
        return [stx._step_fn(stx.tensors[d], w, 0) for d, w in staged]

    def timed(step, first: int) -> tuple:
        step(ts[first])
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        for k in range(first + 1, first + 1 + SHARD_STEPS):
            step(ts[k])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / SHARD_STEPS * 1e3, launches()

    first = cfg.t2_frames + 1
    ms, counts = timed(stx.step_device, first)
    eager_ms, _ = timed(eager_step, first + 1 + SHARD_STEPS)
    blocks = SHARD_MUX * SHARD_FRAME
    require(counts == kernel_counts(SHARD_STEPS, SHARD_STEPS),
            f"compiled sharded: launches {counts} in {SHARD_STEPS} steps")
    samples = SHARD_MUX * stx.frames_per_step * cfg.samples_per_frame
    steps = list(stx._steps.values())
    require([st.blocks for st in steps] == [blocks],
            f"compiled sharded: blocks a graph {[st.blocks for st in steps]}")
    capture_s = sum(st.capture_s for st in steps)
    pool = sum(st.pool_bytes for st in steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for k in range(TRACE_STEPS):
            stx.step_device(ts[k])
        torch.cuda.synchronize()
    calls = host_api_calls(prof, TRACE_STEPS)
    require(calls["cudaGraphLaunch"] == len(steps),
            f"compiled sharded: {calls['cudaGraphLaunch']} graph launches a "
            f"step on {len(steps)} card(s)")
    print(f"compiled sharded: vv009 x {SHARD_MUX} muxes over {blocks} slots "
          f"of {dev}, {b} frames a block, {cfg.t2_frames + 1} steps "
          f"bit-identical to the eager step block by block; a step "
          f"{ms:.4f} ms compiled = {samples / ms / 1e3:.2f} Msamples/s, "
          f"{eager_ms:.4f} ms eager = {samples / eager_ms / 1e3:.2f} "
          f"Msamples/s (host staging included); {len(steps)} graph of "
          f"{blocks} blocks, capture {capture_s * 1e3:.1f} ms, pool "
          f"{_mb(pool):.1f} MiB; profiled, a step: "
          f"{calls['cudaGraphLaunch']:g} graph launch, host CUDA calls "
          f"{calls}; launches {counts}")
    return counts


def compiled_phase(torch, dev) -> dict:
    """Phase 9b: the compiled step against the eager one on every
    full-width path (``compiled_path``), batch-1 latency compiled and
    eager (``bench_latency.measure``), and the 16-slot multi-mux
    (``compiled_sharded``).  Returns the launches by path."""
    from dvbt2ll_tpu_torch.tools.bench_latency import CONFIGS, measure
    t_start = time.perf_counter()
    paths = {}
    for name, batch, strict in COMPILED_PATHS:
        r = compiled_path(torch, dev, name, batch, strict)
        paths[f"compiled_{name}_{batch or 'strict'}"] = r["launches"]
        torch.cuda.empty_cache()
    for name in CONFIGS:
        r = measure(name, dev, iters=LATENCY_ITERS, calls=LATENCY_CALLS)
        print(f"compiled latency {name} batch 1: per call median "
              f"{r['per_call_ms_median']:.4f} ms (max "
              f"{r['per_call_ms_max']:.4f}), back to back "
              f"{r['frame_latency_ms']:.4f}; eager median "
              f"{r['eager_per_call_ms_median']:.4f} ms (max "
              f"{r['eager_per_call_ms_max']:.4f}), back to back "
              f"{r['eager_frame_latency_ms']:.4f}; capture "
              f"{r['capture_s'] * 1e3:.1f} ms")
    paths["compiled_sharded_16"] = compiled_sharded(torch, dev)
    print(f"phase 9b: the compiled step passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    return paths


def slot_trace(torch, dev) -> None:
    """``bench_scaling`` part A's 1-, 4- and 8-slot steps again, in this
    process, under torch.profiler: wall time a step beside the card's
    kernel time, the host's time in graph launches, and the host's graph
    launches (one a step: the card's slots are one graph) and CUDA
    runtime calls a step, to say whether the host or the card sets the
    step's time and that the host's work does not grow with the slots."""
    from torch.profiler import ProfilerActivity, profile
    from dvbt2ll_tpu_torch.tools import host_api_calls
    from dvbt2ll_tpu_torch.tools.bench_scaling import TOTAL_FRAMES, _sharded
    for n in (1, 4, 8):
        _, stx, ts = _sharded([dev] * n, TOTAL_FRAMES)
        stx.step_device(ts)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(TRACE_STEPS):
                stx.step_device(ts)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / TRACE_STEPS * 1e3
        events = prof.key_averages()
        device_ms = sum(e.self_device_time_total
                        for e in events) / TRACE_STEPS / 1e3
        launch_ms = sum(e.cpu_time_total for e in events
                        if e.key == "cudaGraphLaunch") / TRACE_STEPS / 1e3
        calls = host_api_calls(prof, TRACE_STEPS)
        require(device_ms > 0, f"slot trace {n}: no device time recorded")
        require(calls["cudaGraphLaunch"] == 1, f"slot trace {n}: "
                f"{calls['cudaGraphLaunch']} graph launches a step")
        print(f"slot trace, {n} slots of {dev} ({TOTAL_FRAMES} frames, "
              f"profiled): {wall:.4f} ms a step, device {device_ms:.4f} ms "
              f"(busy {device_ms / wall:.3f}), cudaGraphLaunch on the host "
              f"{launch_ms:.4f} ms; a step {calls['cudaGraphLaunch']:g} "
              f"graph launch, host CUDA calls {calls}")


def run_tool(args: list, card: str) -> list:
    """``python -m <args>`` from this checkout: exit code 0 and the card
    line first; prints and returns its JSON lines."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", *map(str, args)], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=TOOL_TIMEOUT)
    dt = time.perf_counter() - t0
    name = args[0].rsplit(".", 1)[-1]
    require(res.returncode == 0, f"{name}: rc {res.returncode}\n"
            f"{res.stdout}\n{res.stderr}")
    lines = res.stdout.splitlines()
    require(lines and lines[0] == card,
            f"{name}: first line {lines[:1]}, not the card line")
    out = [json.loads(ln) for ln in lines if ln.startswith("{")]
    for o in out:
        print(f"{name} ({' '.join(map(str, args[1:]))}; subprocess "
              f"{dt:.1f} s): {json.dumps(o)}")
    return out


def bench_and_latency(card: str) -> dict:
    """Phase 10's ``bench`` at vv009 batch 256 and ``bench_latency`` on
    its four configs; their kernel launches by path."""
    from dvbt2ll_tpu_torch import named_config
    from dvbt2ll_tpu_torch.tools.bench_latency import CONFIGS
    (b,) = run_tool(["dvbt2ll_tpu_torch.bench", BATCH, BENCH_STEPS,
                     "vv009_4kshort"], card)
    require({"metric", "value", "unit", "vs_baseline"} <= b.keys()
            and b["device"] == card and b["value"] > 0
            and b["step_device_msamples_s"] > 0, f"bench: {b}")
    require(b["launches"] == kernel_counts(BENCH_STEPS, BENCH_STEPS),
            f"bench: launches {b['launches']}")

    lats = run_tool(["dvbt2ll_tpu_torch.tools.bench_latency"], card)
    require([r["config"] for r in lats] == list(CONFIGS),
            f"bench_latency: {[r['config'] for r in lats]}")
    total = kernel_counts(0, 0)
    for r in lats:
        cfg = named_config(r["config"])
        calls = r["iters"] + r["calls"]
        planar = r["launches"]["ifft_gi"] == calls
        require(r["frame_duration_s"] == cfg.frame_duration
                and 0 < r["per_call_ms_median"] <= r["per_call_ms_max"]
                and r["launches"]["ldpc_parity"]
                == r["launches"]["qam_map"] == calls * len(cfg.plp_configs)
                and (planar or r["launches"]["ifft_gi"] == 0)
                and r["launches"]["fft_tail"] == calls * (not planar),
                f"bench_latency {r['config']}: {r}")
        total = {k: total[k] + r["launches"][k] for k in total}
    return {"tool_bench": b["launches"], "tool_latency": total}


def tools_phase(torch, tail_times: dict) -> dict:
    """Phase 10: the measuring entry points, each a subprocess on the
    card, briefly, then ``slot_trace``; their kernel launches by path."""
    from dvbt2ll_tpu_torch import min_batch_frames, named_config
    from dvbt2ll_tpu_torch.profile_step import card_line
    card = card_line()
    t_start = time.perf_counter()
    paths = {}
    # the roofline is arithmetic on the host: it runs beside the next two
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        roofs = pool.submit(run_tool, [
            "dvbt2ll_tpu_torch.tools.roofline", BATCH, "vv009_4kshort",
            "8k_normal", "32k_extended"], card)
        paths.update(bench_and_latency(card))
        roofs = roofs.result()
    for r in roofs:
        parts = {p["name"]: p for p in r["parts"]}
        if r["config"] in tail_times:
            got = parts["tail_kernel"]["bound_ms"]
            want = tail_times[r["config"]]["bound_ms"]
            require(abs(got - want) <= 1e-12 * want, f"roofline "
                    f"{r['config']}: tail bound {got} ms, phase 3 {want} ms")
        else:
            require({"fft_gi", "p1_iq"} <= parts.keys(),
                    f"roofline {r['config']}: parts {sorted(parts)}")

    cfg = named_config("vv009_4kshort")
    step_samples = min_batch_frames(cfg) * cfg.samples_per_frame
    for r in run_tool(["dvbt2ll_tpu_torch.tools.bench_sustained",
                       "device,full,paced", f"{SUSTAINED_SECONDS},"
                       f"{SUSTAINED_SECONDS},{PACED_SECONDS}"], card):
        role = r["role"]
        require(r["steps"] > 0 and r["sync_errors"] == 0
                and r["ingest"]["sync_errors"] == 0
                and r["ingest"]["null_stuffed"] == 0,
                f"bench_sustained {role}: {r}")
        require(r["launches"] == kernel_counts(r["steps"],
                                               r["steps"]),
                f"bench_sustained {role}: launches {r['launches']} in "
                f"{r['steps']} steps")
        if role != "device":
            sunk = r["sink_samples"]
            require(sunk["warmup"] == step_samples
                    and sunk["timed"] == r["steps"] * step_samples
                    and sunk["warmup"] + sunk["timed"] == r["sink_written"],
                    f"bench_sustained {role}: sink {sunk}, wrote "
                    f"{r['sink_written']}, {r['steps']} steps")
        if role == "paced":
            require(r["paced_ok"] and r["sink_file_samples"]
                    == r["sink_written"], f"bench_sustained paced: {r}")
        paths[f"tool_sustained_{role}"] = r["launches"]

    parts = ("ABC" if time.perf_counter() - t_start < TOOLS_C_BUDGET
             else "AB")
    (s,) = run_tool(["dvbt2ll_tpu_torch.tools.bench_scaling", "--parts",
                     parts], card)
    require(s["copy_audit"]["peer_copies"] == 0,
            f"bench_scaling: copy audit {s['copy_audit']}")
    total = kernel_counts(0, 0)
    for row in s["strong"]:
        # the slots of one card are one batched call: once a step
        n = s["steps"]
        require(row["launches"] == kernel_counts(n, n),
                f"bench_scaling: {row}")
        total = {k: total[k] + row["launches"][k] for k in total}
    paths["tool_scaling_strong"] = total
    wall = {row["slots"]: row["wall_ms_per_step"] for row in s["strong"]}
    print(f"bench_scaling part A: {wall[4]:.4f} ms at 4 slots, "
          f"{wall[8]:.4f} at 8: "
          f"{'4 slots slower than 8' if wall[4] > wall[8] else 'in order'}")
    slot_trace(torch, torch.device("cuda"))
    if "C" not in parts:
        print(f"bench_scaling part C: not run, the phase's tools took over "
              f"{TOOLS_C_BUDGET:.0f} s")
    print(f"phase 10: the measuring entry points passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    return paths


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from dvbt2ll_tpu_torch import min_batch_frames, named_config
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
    bb_bch_times = bb_bch_phase(torch, dev)
    qam_times = qam_phase(torch, dev, rng)
    tail_times = tail_phase(torch, dev, rng)
    golden_phase(torch, dev)
    matrix_paths = matrix_phase(torch, dev)
    paths = {"vv009_4kshort": full_width_phase(torch, dev, "vv009_4kshort",
                                               STREAM_STEPS),
             "8k_normal": full_width_phase(torch, dev, "8k_normal",
                                           STEPS_8K),
             "32k_extended": full_width_phase(torch, dev, "32k_extended",
                                              STEPS_32K)}
    paths.update(matrix_paths)
    paths["multiplp_fef"], mplp_rate = multiplp_phase(torch, dev)
    with tempfile.TemporaryDirectory() as tmp:
        paths["executor"] = executor_phase(torch, dev)
        paths["paced"] = paced_phase(torch, dev, tmp)
        app_phase(torch, dev, tmp)
    pinned_cost(torch)   # before any batch-256 pinned buffer is cached
    paths["executor_vv009_4kshort"] = rate_phase(
        torch, dev, "vv009_4kshort", BATCH, strict=False)
    paths["executor_multiplp_fef"] = rate_phase(
        torch, dev, "multiplp_fef",
        3 * min_batch_frames(named_config("multiplp_fef")), strict=True,
        stream_rate=mplp_rate)
    with tempfile.TemporaryDirectory() as tmp:
        paths.update(multi_device_phase(torch, dev, tmp))
    paths.update(compiled_phase(torch, dev))
    paths.update(tools_phase(torch, tail_times))

    def by_path(kernel):
        return {p: c[kernel] for p, c in paths.items()}

    main_path = paths["vv009_4kshort"]

    def row(name, source, replaces, times, **extra):
        """One kernel's entry: the vv009 numbers under the contract's
        keys, the 8k_normal ones and those at BASELINE config 5's batch
        (its one launch a step, phase 9b) with those suffixes."""
        main = times["vv009_4kshort"]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, **extra,
                 "launches": main_path[name],
                 "launches_per_step": main_path[name] // (1 + STREAM_STEPS),
                 "launches_by_path": by_path(name),
                 "max_abs_err": main["err"]}
        for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
            entry[key] = main[key]
        for suffix in ("8k_normal", "config5"):
            for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms"):
                entry[f"{key}_{suffix}"] = times[suffix][
                    "err" if key == "max_abs_err" else key]
        entry["launches_per_step_8k_normal"] = (paths["8k_normal"][name]
                                                // (1 + STEPS_8K))
        entry["launches_per_step_config5"] = (
            paths["compiled_sharded_16"][name] // SHARD_STEPS)
        return entry

    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": [
        row("bb_bch", "dvbt2ll_tpu_torch/csrc/bb_bch.cu",
            "none: the JAX package's stage is XLA ops, its CRC-8 and BCH "
            "GF(2) matrix products (dvbt2ll_tpu/pipeline.py bb_and_fec)",
            bb_bch_times),
        row("qam_map", "dvbt2ll_tpu_torch/csrc/qam_map.cu",
            "none: the JAX package's mapper is XLA ops "
            "(dvbt2ll_tpu/pipeline.py map_cells_planes), which XLA fuses",
            qam_times, **{f"{k}_uk_t2_32k": v for k, v in
                          qam_times["uk_t2_32k"].items()}),
        row("ldpc_parity", "dvbt2ll_tpu_torch/csrc/ldpc_parity.cu",
            "dvbt2ll_tpu/ops/ldpc_pallas.py:61", ldpc_times,
            also_replaces="dvbt2ll_tpu/ops/ldpc_pallas.py:137"),
        row("ifft_gi", "dvbt2ll_tpu_torch/csrc/ifft_gi.cu",
            "dvbt2ll_tpu/ops/ifft_pallas.py:226", tail_times)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
