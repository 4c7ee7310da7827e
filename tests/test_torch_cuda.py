"""The port's CUDA kernels on the GPU: they run only where a CUDA device
and nvcc exist, and skip elsewhere.  It imports no JAX, so it runs on a
machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets up JAX.)  It imports nothing
from ``tests``: where an installed package is named ``tests``, that name
does not reach this directory.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import chip_smoke
from dvbt2ll_tpu_torch import (MultiMuxTransmitter, MuxChannel,
                               ShardedTransmitter, StreamingExecutor,
                               Transmitter, build_plan, grids_symbol_sharded,
                               halo_windows, make_mesh, min_batch_frames, named_config,
                               plan_tensors, synthetic_ts, transmit_step_iq,
                               vv009_config)
from dvbt2ll_tpu_torch.config import (CodeRate, Constellation, FrameSize,
                                      InputMode, Rotation, T2Config)
from dvbt2ll_tpu_torch.tables.ldpc import qc_entries
from dvbt2ll_tpu_torch.executor import _HostCopy
from dvbt2ll_tpu_torch.ops import ifft
from dvbt2ll_tpu_torch.ops.fec import bb_bch, bb_bch_tables
from dvbt2ll_tpu_torch.ops.ldpc import (ldpc_codeword, ldpc_codeword_plain,
                                        ldpc_schedule)
from dvbt2ll_tpu_torch.ops.qam import qam_map, qam_map_plain, qam_tables
from dvbt2ll_tpu_torch.pipeline import bb_and_fec, select_step_iq
from dvbt2ll_tpu_torch.tables.mapper import bit_permutation

# every named config with a reference-binary golden (planar and complex
# tail), and multi-PLP
_ON_CARD = ["vv009_4kshort", "8k_normal", "hieff_4k", "inband_2k",
            "8k_miso_tx1", "8k_miso_tx2", "1k_pp4", "qpsk_short_c13",
            "ti_off_4k", "t2lite_4k", "v121_4k", "eq_2k_5mhz",
            "multiplp_fef", "32k_extended", "32k_papr_tr",
            "16k_l1qpsk_both", "t2lite_16k_t2gi", "t2lite_8k_t2gi_miso"]
_TAIL = [(n2, rows) for n2 in (8, 16, 32, 64) for rows in (1, n2 // 4)]

pytestmark = pytest.mark.cuda

_TABLES = [(fs, r) for fs in (FrameSize.SHORT, FrameSize.NORMAL)
           for r in (CodeRate.C1_3, CodeRate.C2_5, CodeRate.C1_2,
                     CodeRate.C3_5, CodeRate.C2_3, CodeRate.C3_4,
                     CodeRate.C4_5, CodeRate.C5_6)
           if not (fs == FrameSize.NORMAL
                   and r in (CodeRate.C1_3, CodeRate.C2_5))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")
    return torch.device("cuda")


@pytest.mark.parametrize("frames", [67, 1101])
@pytest.mark.parametrize("frame_size,rate", _TABLES,
                         ids=[f"{fs.name}-{r.name}" for fs, r in _TABLES])
def test_kernel_matches_plain_every_table(cuda, frame_size, rate, frames):
    """The codeword kernel bit for bit against its twin, at odd frame
    counts on either side of 8 blocks a SM on an H100 (132 SMs), where
    the launch changes its block size."""
    cfg = T2Config(frame_size=frame_size, code_rate=rate, fec_blocks=1,
                   ti_blocks=1)
    sched = ldpc_schedule(qc_entries(frame_size, rate, cfg.q_ldpc),
                          cfg.nbch, cfg.ldpc_parity_bits, cfg.q_ldpc, cuda)
    bits = torch.from_numpy(np.random.default_rng(3).integers(
        0, 2, (frames, cfg.nbch), dtype=np.uint8)).to(cuda)
    before = ldpc_codeword.launches
    got = ldpc_codeword(sched, bits)
    assert ldpc_codeword.launches == before + 1
    torch.cuda.synchronize()
    assert got.shape == (frames, cfg.ldpc_frame_bits) and got.is_contiguous()
    assert torch.equal(got, ldpc_codeword_plain(sched, bits))


def _fec_windows(t, blocks, seed, corrupt):
    """``blocks`` random windows of a PLP, a sync byte at every packet
    start (or, with ``corrupt``, none set)."""
    ts = np.random.default_rng(seed).integers(
        0, 256, (blocks, 187 + t.fresh), dtype=np.uint8)
    if not corrupt:
        ts[:, 187 + (0 if t.hieff else t.sync_offset)::188] = 0x47
    return torch.from_numpy(ts)


def _bb_bch_vs_twin(cuda, pp, blocks, seed, **replace):
    """The BB/BCH kernel on ``blocks`` card windows of a PLP against the
    twin on the same windows on the CPU, valid and corrupted sync bytes;
    ``replace`` overrides fields of both sides' tables."""
    import dataclasses
    dev = dataclasses.replace(bb_bch_tables(pp, cuda), **replace)
    cpu = dataclasses.replace(bb_bch_tables(pp, "cpu"), **replace)
    for corrupt in (False, True):
        ts = _fec_windows(cpu, blocks, seed, corrupt)
        before = bb_bch.launches
        got = bb_bch(dev, ts.to(cuda))
        assert bb_bch.launches == before + 1
        torch.cuda.synchronize()
        assert got.shape == (blocks * pp.fec_frames, pp.cfg.nbch)
        assert torch.equal(got.cpu(), bb_bch(cpu, ts)), corrupt


@pytest.mark.parametrize("blocks", [1, 16])
@pytest.mark.parametrize("name", _ON_CARD)
def test_bb_bch_kernel_matches_twin(cuda, name, blocks):
    """Every PLP of every named config at two frames (HIEFF: its smallest
    batch), one block and 16."""
    cfg = named_config(name)
    batch = (min_batch_frames(cfg) if cfg.input_mode == InputMode.HIEFF
             else 2)
    for i, pp in enumerate(build_plan(cfg, batch, strict=False).plps):
        _bb_bch_vs_twin(cuda, pp, blocks, seed=60 + i)


_FEC_PLANS = {
    # BASELINE config 5's shape (16 blocks: 6016 frames) and one block of
    # it, 376 frames: a block of 8 frames at the grid's end
    "vv009_47": (lambda: build_plan(vv009_config(), 47, strict=False), 16),
    # NORMAL mode with the first sync slot inside the window
    "normal_nonzero_offset": (lambda: _matrix_plan("normal_drift", 1), 3),
    "inband_nonzero_offset": (lambda: _matrix_plan("inband_stream", 1), 3),
}


def _matrix_plan(case_id, steps_in):
    """A MATRIX case's plan at its test batch, at the TS phase its
    streaming run reaches after ``steps_in`` steps."""
    case = {c["id"]: c for c in chip_smoke.MATRIX}[case_id]
    cfg = chip_smoke.matrix_config(case)
    phase = 0
    for _ in range(steps_in):
        phase = build_plan(cfg, case["batch"], strict=False,
                           start_phases=phase).plps[0].bb.next_phase
    return build_plan(cfg, case["batch"], strict=False, start_phases=phase)


@pytest.mark.parametrize("case", list(_FEC_PLANS))
def test_bb_bch_kernel_offsets_and_no_packets(cuda, case):
    """Plans no named config gives: a nonzero sync offset, the full
    config-5 width, and (built by hand) a window with no sync slot."""
    make, blocks = _FEC_PLANS[case]
    pp = make().plps[0]
    assert (pp.bb.sync_offset != 0) == case.endswith("nonzero_offset")
    for b in (1, blocks):
        _bb_bch_vs_twin(cuda, pp, b, seed=70 + b)
    _bb_bch_vs_twin(cuda, pp, blocks, seed=80, packets=0)


def test_bb_bch_kernel_refuses_what_it_does_not_take(cuda):
    pp = build_plan(vv009_config(), 2, strict=False).plps[0]
    t = bb_bch_tables(pp, cuda)
    ts = _fec_windows(t, 2, 0, False).to(cuda)
    before = bb_bch.launches
    for bad in (ts.to(torch.int16), ts[0], ts[:, 1:], ts[:, ::2],
                ts.t().contiguous()):
        with pytest.raises(ValueError):
            bb_bch(t, bad)
    with pytest.raises(ValueError):
        bb_bch(bb_bch_tables(pp, "cpu"), ts)     # tables on the CPU
    assert bb_bch.launches == before


def _snr_db(ref, x):
    ref = np.asarray(ref, np.complex128).ravel()
    x = np.asarray(x, np.complex128).ravel()
    err = np.sum(np.abs(x - ref) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(np.abs(ref) ** 2)
                                                 / err)


def _grids(cuda, n2, b=3, s=5, seed=4):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(
        (b, s, n2, 128)).astype(np.float32)).to(cuda) for _ in range(3))


def _tail_vs_twin(cuda, n2, gi_rows, b, s):
    """The fused tail kernel against its twin: P1 in place bit for bit,
    the symbols above 120 dB (both float32, the sums taken in another
    order), the output's shape, strides and dtype as the twin's."""
    fft, gi = 128 * n2, 128 * gi_rows
    re, im, noise = _grids(cuda, n2, b, s)
    p1 = noise.reshape(-1)[:2 * ifft.P1_LEN].reshape(-1, 2)
    tables = ifft.tail_tables(fft, 0.25, cuda)
    before = ifft.ifft_gi.launches
    got = ifft.ifft_gi(re, im, p1, fft, gi, 0.25, tables)
    assert ifft.ifft_gi.launches == before + 1
    want = ifft.ofdm_tail_plain(re, im, p1, fft, gi, 0.25, tables)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b, ifft.P1_LEN + s * (fft + gi), 2)
    assert got.stride() == want.stride() and got.dtype == torch.float32
    assert torch.equal(got[:, :ifft.P1_LEN], p1.expand(b, -1, -1))
    g = got.cpu().numpy()
    w = want.cpu().numpy()
    snr = _snr_db(w[..., 0] + 1j * w[..., 1], g[..., 0] + 1j * g[..., 1])
    assert snr > 120, f"{snr:.1f} dB"


@pytest.mark.parametrize("n2,gi_rows", _TAIL,
                         ids=[f"n2_{n}-gi_{g}" for n, g in _TAIL])
def test_tail_kernel_matches_twin(cuda, n2, gi_rows):
    """15 symbols: at 1K and 2K the last tile holds fewer symbols than
    its room."""
    _tail_vs_twin(cuda, n2, gi_rows, 3, 5)


@pytest.mark.parametrize("n2", [8, 64])
def test_tail_kernel_walks_many_tiles(cuda, n2):
    """More tiles than the card holds blocks: each block walks several,
    through both shared-memory buffers."""
    _tail_vs_twin(cuda, n2, n2 // 4, 40, 33)


def test_tail_kernel_refusals(cuda):
    re, im, _ = _grids(cuda, 32)
    p1 = torch.zeros((ifft.P1_LEN, 2), device=cuda)
    tables = ifft.tail_tables(4096, 1.0, cuda)
    wide = torch.zeros((3, 5, 32, 256), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ifft.ifft_gi(wide[..., ::2], wide[..., 1::2], p1, 4096, 128, 1.0,
                     tables)
    with pytest.raises(ValueError, match="float32"):
        ifft.ifft_gi(re.double(), im.double(), p1, 4096, 128, 1.0, tables)
    with pytest.raises(ValueError, match="P1 on"):
        ifft.ifft_gi(re, im, p1.cpu(), 4096, 128, 1.0, tables)
    with pytest.raises(ValueError, match="do not fit"):
        ifft.ifft_gi(re[..., :64], im[..., :64], p1, 4096, 128, 1.0, tables)
    on_cpu = ifft.tail_tables(4096, 1.0, "cpu")
    with pytest.raises(ValueError, match="tail tables"):
        ifft.ifft_gi(re, im, p1, 4096, 128, 1.0, on_cpu)
    before = ifft.ifft_gi.launches
    ifft.ifft_gi(re, im, p1, 4096, 128, 1.0)  # tables built on the card
    assert ifft.ifft_gi.launches == before + 1


def test_kernel_refuses_what_it_does_not_take(cuda):
    cfg = named_config("vv009_4kshort")
    cols = qc_entries(cfg.frame_size, cfg.code_rate, cfg.q_ldpc)
    sched = ldpc_schedule(cols, cfg.nbch, cfg.ldpc_parity_bits, cfg.q_ldpc,
                          cuda)
    bits = torch.zeros((4, 2 * cfg.nbch), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ldpc_codeword(sched, bits[:, ::2])
    with pytest.raises(ValueError, match="aligned"):
        ldpc_codeword(sched, bits.reshape(-1)[4:4 + 4 * cfg.nbch].reshape(
            4, cfg.nbch))
    with pytest.raises(ValueError, match="uint8"):
        ldpc_codeword(sched, bits[:, :cfg.nbch].int())
    on_cpu = ldpc_schedule(cols, cfg.nbch, cfg.ldpc_parity_bits,
                           cfg.q_ldpc, "cpu")
    with pytest.raises(ValueError, match="schedule"):
        ldpc_codeword(on_cpu, bits[:, :cfg.nbch].contiguous())


def test_tail_refuses_tf32(cuda):
    g = torch.zeros((1, 1, 32, 128), device=cuda)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            ifft.ifft_gi_einsum(g, g, 4096, 128, 1.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("name", _ON_CARD)
def test_transmitter_on_card_matches_cpu(cuda, name):
    """Two frames (HIEFF: its smallest batch of whole packets): FEC bits
    equal, IQ above 120 dB (the kernels and cuFFT sum in another order
    than the CPU), the BB/BCH and LDPC kernels launched once per PLP a
    step, the tail kernel once a step on the planar tail and never on the
    complex one."""
    cfg = named_config(name)
    batch = (min_batch_frames(cfg) if cfg.input_mode == InputMode.HIEFF
             else 2)
    tx = Transmitter(cfg, batch, strict=False, device=cuda)
    ref = Transmitter(cfg, batch, strict=False, device="cpu")
    streams = [synthetic_ts(n, seed=5 + i)
               for i, n in enumerate(tx.bytes_per_step_per_plp)]
    for pt, pr, ts in zip(tx.tensors.plps, ref.tensors.plps, streams):
        w = torch.from_numpy(np.concatenate([np.zeros(187, np.uint8), ts]))
        assert torch.equal(bb_and_fec(pt, w.to(cuda)).cpu(),
                           bb_and_fec(pr, w))
    before = _launches()
    got = tx(streams if len(streams) > 1 else streams[0])
    assert _launches() == _added(before, len(streams),
                                 select_step_iq(cfg)[1])
    want = ref(streams if len(streams) > 1 else streams[0])
    assert got.shape == want.shape
    snr = _snr_db(want, got)
    assert snr > 120, f"{snr:.1f} dB"


def _executor_vs_stream(cuda, batch, steps, seed, **kw):
    """The executor on the card, every returned array kept until the end,
    against ``Transmitter.stream`` on the card over the same TS: bit for
    bit (the same device, the same math)."""
    cfg = vv009_config()
    tx = Transmitter(cfg, batch, device=cuda, **kw)
    ref = Transmitter(cfg, batch, device=cuda, **kw)
    n = tx.bytes_per_step
    ts = synthetic_ts(steps * n, seed=seed)
    want = [ref.stream(ts[k * n:(k + 1) * n]) for k in range(steps)]
    pos = {"o": 0}

    def source(nbytes):
        o = pos["o"]
        pos["o"] += nbytes
        return ts[o:o + nbytes]

    ex = StreamingExecutor(tx, source)
    got = [ex.step() for _ in range(steps)]
    assert isinstance(ex._pending[0], _HostCopy)
    assert ex._pending[0].host.is_pinned()
    got = got[1:] + [ex.flush()]
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (batch, cfg.samples_per_frame), k
        assert np.array_equal(g.reshape(-1), w), f"step {k}"


def test_executor_pinned_path_matches_stream(cuda):
    _executor_vs_stream(cuda, min_batch_frames(vv009_config()), 3, seed=6)


def test_executor_output_survives_allocator_reuse(cuda):
    """Many small steps: the caching allocator hands each freed output
    block to a later step at once, so an output whose side-stream copy
    were not fenced (``record_stream``) would be overwritten before it
    reached the host."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _executor_vs_stream(cuda, 1, 40, seed=7, strict=False,
                        allow_phase_drift=True)


def _launches():
    """(BB/BCH, LDPC, tail) kernel launches so far."""
    return bb_bch.launches, ldpc_codeword.launches, ifft.ifft_gi.launches


def _added(before, fec, tail):
    """``before`` plus ``fec`` launches of both FEC kernels (BB/BCH and
    LDPC, once each a PLP a call) and ``tail`` of the tail kernel."""
    return before[0] + fec, before[1] + fec, before[2] + tail


def _drift_sharded(cfg, slots, n_mux):
    return ShardedTransmitter(cfg, make_mesh(slots, mux=2), n_mux=n_mux,
                              frames_per_shard=1, strict=False,
                              allow_phase_drift=True)


def _sharded_vs_sequential(slots):
    """A (2, len(slots) / 2) vv009 mesh, one frame a block: every block on
    its slot's card, bit-identical to the sequential Transmitter at the
    same per-call batch, both kernels launched once a card (a card's
    blocks are one batched call)."""
    cfg = vv009_config()
    stx = _drift_sharded(cfg, slots, 2)
    ts = np.stack([synthetic_ts(stx.bytes_per_step_per_mux, seed=11 + c)
                   for c in range(2)])
    before = _launches()
    out = stx.step_device(ts)
    cards = len(set(slots))
    assert _launches() == _added(before, cards, cards)
    for c in range(2):
        tx = Transmitter(cfg, 1, strict=False, allow_phase_drift=True,
                         device=stx.mesh.devices[c, 0])
        n = tx.bytes_per_step
        for s in range(stx.frame_shards):
            o = out[c][s]
            assert o.device == stx.mesh.devices[c, s]
            ref = tx.step_device(ts[c, s * n:(s + 1) * n])
            assert torch.equal(o, ref.to(o.device)), (c, s)


def test_sharded_equals_sequential_on_four_slots(cuda):
    _sharded_vs_sequential([cuda] * 4)


def test_sharded_launches_each_kernel_once_a_card(cuda):
    """4 muxes over a (2, 2) mesh of one card: 2 muxes a block row, 8
    blocks a step as one batched call, so each kernel launches once a
    step, every step: the BB/BCH kernel once a PLP a card a step, as
    the LDPC kernel, and the tail once."""
    stx = _drift_sharded(vv009_config(), [cuda] * 4, 4)
    for step in range(2):
        ts = np.stack([synthetic_ts(stx.bytes_per_step_per_mux,
                                    seed=20 + 4 * step + c)
                       for c in range(4)])
        before = _launches()
        stx.step_device(ts)
        assert _launches() == _added(before, 1, 1), step


def test_sharded_over_two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    cards = [torch.device("cuda", i) for i in range(2)]
    _sharded_vs_sequential(cards * 2)


def test_hetero_multimux_on_card(cuda):
    """A vv009 group (planar tail) beside a 32k_extended group (complex
    tail: LDPC launches, no tail kernel), each channel bit-identical to its
    standalone ShardedTransmitter on the card; each group's blocks are one
    batched call, so one LDPC launch a group and one tail launch."""
    cfg_a, cfg_b = vv009_config(), named_config("32k_extended")
    drift = dict(frames_per_shard=1, strict=False, allow_phase_drift=True)
    mm = MultiMuxTransmitter([MuxChannel(cfg_a, n_mux=2, n_devices=4,
                                         **drift),
                              MuxChannel(cfg_b, n_devices=2, **drift)],
                             devices=[cuda] * 6)
    na, nb = mm.bytes_per_step
    ts = [np.stack([synthetic_ts(na, seed=30 + c) for c in range(2)]),
          synthetic_ts(nb, seed=32)[None]]
    before = _launches()
    out = mm.step_device(ts)
    assert _launches() == _added(before, 2, 1)
    refs = [_drift_sharded(cfg_a, [cuda] * 4, 2),
            ShardedTransmitter(cfg_b, make_mesh([cuda] * 2), **drift)]
    for got, ref, t in zip(out, refs, ts):
        for g_row, r_row in zip(got, ref.step_device(t)):
            assert all(torch.equal(g, r) for g, r in zip(g_row, r_row))


def _symbol_sharded_vs_eager(slots, graphs):
    """32k_extended, 1 frame over ``slots``: the compiled call (``graphs``
    CUDA graphs) bit-identical to its eager form and to the whole complex
    step (cuFFT's transform of a slab is the whole's) at frame indices 0
    and 1, one LDPC launch a call."""
    plan = build_plan(named_config("32k_extended"), 1, strict=False)
    fn = grids_symbol_sharded(plan, make_mesh(slots))
    assert len(fn.graphs) == graphs and fn.pool_bytes > 0
    dev = fn.dev0
    padded = torch.from_numpy(np.concatenate(
        [np.zeros(187, np.uint8),
         synthetic_ts(plan.ts_bytes_in, seed=40)])).to(dev)
    for idx in (0, 1):
        before = _launches()
        got = fn(padded, idx)
        assert _launches() == _added(before, 1, 0)
        assert got.device == dev
        assert torch.equal(got, fn.eager(padded, idx)), idx
        assert torch.equal(got, transmit_step_iq(
            plan_tensors(plan, dev, False), padded, idx)), idx


def test_symbol_sharded_on_card(cuda):
    """4 slots of one card: one graph."""
    _symbol_sharded_vs_eager([cuda] * 4, 1)


def test_symbol_sharded_over_cards(cuda):
    """4 slots over the cards in turn: a graph a card segment (the front
    and the back on the first card, one graph on each other card), the
    slabs moved by peer copies between them."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    cards = [torch.device("cuda", i) for i in range(n)]
    slots = [cards[i % n] for i in range(4)]
    _symbol_sharded_vs_eager(slots, len(set(slots)) + 1)


def test_bench_on_card(cuda):
    """The port's bench at a small size: the staged loop launches both
    kernels once a step, and both rates are positive."""
    from dvbt2ll_tpu_torch import bench
    from dvbt2ll_tpu_torch.profile_step import card_line
    r = bench.run(8, 3, "vv009_4kshort", cuda)
    assert r["device"] == card_line()
    assert r["value"] > 0 and r["step_device_msamples_s"] > 0
    assert r["launches"] == {"bb_bch": 3, "ldpc_parity": 3, "qam_map": 3,
                             "ifft_gi": 3, "fft_tail": 0}


def test_bench_latency_on_card(cuda):
    from dvbt2ll_tpu_torch.tools import bench_latency
    r = bench_latency.measure("vv009_4kshort", cuda, iters=3, calls=4)
    assert 0 < r["per_call_ms_median"] <= r["per_call_ms_max"]
    assert r["frame_latency_ms"] > 0
    assert r["launches"] == {"bb_bch": 7, "ldpc_parity": 7, "qam_map": 7,
                             "ifft_gi": 7, "fft_tail": 0}


def test_roofline_tail_bound_under_the_kernel_time(cuda):
    """The roofline's tail bound at vv009 batch 256 against the kernel's
    time on the card: the kernel takes at least the bound (share of bound
    at most 1.05, room for the timing's noise)."""
    from dvbt2ll_tpu_torch.profile_step import cuda_ms
    from dvbt2ll_tpu_torch.tools import roofline
    b, s, fft, gi = 256, 7, 4096, 128
    r = roofline.roofline("vv009_4kshort", b)
    bound_ms = {p["name"]: p for p in r["parts"]}["tail_kernel"]["bound_ms"]
    re, im, _ = _grids(cuda, fft // 128, b, s)
    p1 = torch.zeros((ifft.P1_LEN, 2), device=cuda)
    tables = ifft.tail_tables(fft, 1.0 / 64, cuda)
    ms = cuda_ms(lambda: ifft.ifft_gi(re, im, p1, fft, gi, 1.0 / 64, tables))
    assert bound_ms / ms <= 1.05, (bound_ms, ms)


@pytest.mark.parametrize("case", chip_smoke.MATRIX,
                         ids=[c["id"] for c in chip_smoke.MATRIX])
def test_config_matrix_on_card_matches_cpu(cuda, case):
    """Every case of the JAX package's config matrix at its test batch
    (``chip_smoke.matrix_case``): FEC bits equal the port on the CPU,
    IQ above 120 dB, ``ldpc_parity`` once a step and ``ifft_gi`` once a
    step on the planar tail only, ``fft_tail`` on the complex one,
    ``qam_map`` once a step; the
    streaming cases one Transmitter a step with ``start_phases``, resumed
    from a checkpoint."""
    got = chip_smoke.matrix_case(torch, cuda, case)
    planar = select_step_iq(chip_smoke.matrix_config(case))[1]
    assert got["tail"] == ("planar" if planar else "complex")
    assert got["launches"] == {"bb_bch": case["steps"],
                               "ldpc_parity": case["steps"],
                               "qam_map": case["steps"],
                               "ifft_gi": case["steps"] * planar,
                               "fft_tail": case["steps"] * (not planar)}
    assert got["snr"] > 120


# ----------------------------------------------------------- compiled step
def _capture(fn):
    """``fn()`` captured as a CUDA graph after one warm-up call on the
    capture stream: (graph, its static output)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    return graph, out


def test_ldpc_launcher_captured_in_a_graph(cuda):
    """The ctypes launcher's launch, recorded on PyTorch's capturing
    stream, replays on new bits: the codeword of the new bits, bit for
    bit against the twin."""
    cfg = vv009_config()
    sched = ldpc_schedule(qc_entries(cfg.frame_size, cfg.code_rate,
                                     cfg.q_ldpc), cfg.nbch,
                          cfg.ldpc_parity_bits, cfg.q_ldpc, cuda)
    rng = np.random.default_rng(50)
    bits = torch.from_numpy(rng.integers(0, 2, (67, cfg.nbch),
                                         dtype=np.uint8)).to(cuda)
    graph, out = _capture(lambda: ldpc_codeword(sched, bits))
    for _ in range(2):
        bits.copy_(torch.from_numpy(rng.integers(0, 2, (67, cfg.nbch),
                                                 dtype=np.uint8)))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ldpc_codeword_plain(sched, bits))


def test_bb_bch_launcher_captured_in_a_graph(cuda):
    """The BB/BCH launcher's launch replays on new windows: their bits,
    bit for bit against the twin."""
    pp = build_plan(vv009_config(), 47, strict=False).plps[0]
    t, ref = bb_bch_tables(pp, cuda), bb_bch_tables(pp, "cpu")
    ts = _fec_windows(t, 3, 90, False).to(cuda)
    graph, out = _capture(lambda: bb_bch(t, ts))
    for seed in (91, 92):
        new = _fec_windows(t, 3, seed, False)
        ts.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), bb_bch(ref, new))


def test_tail_launcher_captured_in_a_graph(cuda):
    """The same for the tail kernel, at vv009's geometry."""
    re, im, noise = _grids(cuda, 32)
    p1 = noise.reshape(-1)[:2 * ifft.P1_LEN].reshape(-1, 2).clone()
    tables = ifft.tail_tables(4096, 0.25, cuda)
    graph, out = _capture(lambda: ifft.ifft_gi(re, im, p1, 4096, 128, 0.25,
                                               tables))
    for seed in (5, 6):
        r2, i2, _ = _grids(cuda, 32, seed=seed)
        re.copy_(r2)
        im.copy_(i2)
        graph.replay()
        want = ifft.ofdm_tail_plain(re, im, p1, 4096, 128, 0.25, tables)
        torch.cuda.synchronize()
        g, w = out.cpu().numpy(), want.cpu().numpy()
        snr = _snr_db(w[..., 0] + 1j * w[..., 1], g[..., 0] + 1j * g[..., 1])
        assert snr > 120, f"{snr:.1f} dB"


def test_tail_refuses_to_build_tables_while_capturing(cuda):
    re, im, _ = _grids(cuda, 32)
    p1 = torch.zeros((ifft.P1_LEN, 2), device=cuda)
    ifft.ifft_gi(re, im, p1, 4096, 128, 1.0)   # warm-up
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            ifft.ifft_gi(re, im, p1, 4096, 128, 1.0)


def _windows(tx, steps, seed):
    """``steps`` consecutive pre-carried windows a PLP (one array, or a
    list for several PLPs), with each step's first frame index."""
    carries = [np.zeros(187, np.uint8) for _ in tx.plan.plps]
    out, idx = [], 0
    for k in range(steps):
        ws = []
        for i, n in enumerate(tx.bytes_per_step_per_plp):
            w = np.concatenate([carries[i],
                                synthetic_ts(n, seed=seed + 10 * k + i)])
            carries[i] = w[-187:]
            ws.append(w)
        out.append((ws, idx))
        idx = (idx + tx.plan.batch_frames) % tx.cfg.t2_frames
    return out


_COMPILED = [("vv009_4kshort", 47, True), ("vv009_4kshort", 256, False),
             ("8k_normal", 256, False), ("32k_extended", 256, False),
             ("multiplp_fef", None, True)]


@pytest.mark.parametrize("name,batch,strict", _COMPILED,
                         ids=[f"{n}-{b}" for n, b, _ in _COMPILED])
def test_compiled_step_equals_eager(cuda, name, batch, strict):
    """t2_frames + 1 steps through the compiled step, every output kept
    until the end, each bit-identical to the eager step function on the
    same window and frame index (47 frames: the index alternates), and
    both kernels launched once a PLP a step under replay."""
    cfg = named_config(name)
    if batch is None:
        batch = 3 * min_batch_frames(cfg)
    kw = (dict(strict=True) if strict
          else dict(strict=False, allow_phase_drift=True))
    tx = Transmitter(cfg, batch, device=cuda, **kw)
    steps = _windows(tx, cfg.t2_frames + 1, seed=60)
    before = _launches()
    got = [tx.step_window(ws if len(ws) > 1 else ws[0]) for ws, _ in steps]
    n = len(steps) * len(tx.plan.plps)
    assert _launches() == _added(before, n,
                                 len(steps) * select_step_iq(cfg)[1])
    assert tx.state_dict()["frame_idx"] == (
        len(steps) * batch % cfg.t2_frames)
    for k, ((ws, idx), g) in enumerate(zip(steps, got)):
        dev_ws = [torch.from_numpy(w).to(cuda) for w in ws]
        want = tx._step_fn(tx.tensors, dev_ws if len(ws) > 1 else dev_ws[0],
                           idx)
        assert torch.equal(g, want), f"step {k}, frame index {idx}"


def test_compiled_step_restores_the_frame_index(cuda):
    """A checkpoint loaded mid-stream: the next step stages the restored
    frame index (vv009 at 47 frames, where it alternates)."""
    cfg = vv009_config()
    tx = Transmitter(cfg, 47, device=cuda)
    steps = _windows(tx, 3, seed=70)
    tx.step_window(steps[0][0][0])
    state = tx.state_dict()
    again = Transmitter(cfg, 47, device=cuda)
    again.load_state(state)
    assert state["frame_idx"] == 1
    got = again.step_window(steps[1][0][0])
    want = tx._step_fn(tx.tensors, torch.from_numpy(steps[1][0][0]).to(cuda),
                       1)
    assert torch.equal(got, want)


def test_executor_on_the_compiled_step_matches_eager(cuda):
    """The executor's stream at vv009's 47 frames, every returned array
    kept, against the eager step function's output on the same windows."""
    cfg = vv009_config()
    tx = Transmitter(cfg, 47, device=cuda)
    steps = _windows(tx, 4, seed=80)
    fresh = iter([ws[0][187:] for ws, _ in steps])
    ex = StreamingExecutor(tx, lambda n: next(fresh))
    got = [ex.step() for _ in steps][1:] + [ex.flush()]
    for k, ((ws, idx), g) in enumerate(zip(steps, got)):
        want = tx._step_fn(tx.tensors, torch.from_numpy(ws[0]).to(cuda), idx)
        w = want.cpu().numpy()
        assert np.array_equal(g, w.reshape(47, -1).view(np.complex64)), k


def _graph_launches(stx, ts) -> tuple:
    """One ``step_device`` of ``stx`` under torch.profiler: the host's
    graph launches and the peer-to-peer copies."""
    from dvbt2ll_tpu_torch.tools import host_api_calls
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        stx.step_device(ts)
        for d in stx.mesh.local_devices():
            torch.cuda.synchronize(d)
    peer = [e.key for e in prof.key_averages() if "PtoP" in e.key]
    return host_api_calls(prof, 1)["cudaGraphLaunch"], peer


def test_sixteen_compiled_slots_of_one_card(cuda):
    """BASELINE config 5: 8 vv009 muxes strict at 47 frames a block over
    16 slots of the card, t2_frames + 1 steps, all 16 blocks one compiled
    step (one graph launch a step) of one batched call, each block
    bit-identical to the one-block eager step on its halo window and frame
    index, both kernels launched once a step."""
    cfg = vv009_config()
    stx = ShardedTransmitter(cfg, make_mesh([cuda] * 16, mux=8), n_mux=8,
                             frames_per_shard=47)
    (step,) = stx._steps.values()
    assert step.blocks == 16 and step._graph is not None
    carries = np.zeros((8, 187), np.uint8)
    for k in range(cfg.t2_frames + 1):
        ts = np.stack([synthetic_ts(stx.bytes_per_step_per_mux,
                                    seed=90 + 8 * k + c) for c in range(8)])
        windows = halo_windows(ts, carries, 2)
        carries = ts[:, -187:]
        before = _launches()
        out = stx.step_device(ts)
        assert _launches() == _added(before, 1, 1)
        for c in range(8):
            for s in range(2):
                idx = (k * 94 + 47 * s) % cfg.t2_frames
                dev = stx.mesh.devices[c, s]
                want = stx._step_fn(stx.tensors[dev], torch.from_numpy(
                    windows[c, s]).to(dev), idx)
                assert torch.equal(out[c][s], want), (k, c, s)
    assert _graph_launches(stx, ts) == (1, [])


_BLOCKS = [("vv009_4kshort", 47, 16, True), ("32k_extended", 4, 4, False)]


@pytest.mark.parametrize("name,batch,blocks,strict", _BLOCKS,
                         ids=[f"{n}-{k}x{b}" for n, b, k, _ in _BLOCKS])
def test_batched_step_equals_one_block_calls(cuda, name, batch, blocks,
                                             strict):
    """The step function on (blocks, ·) windows and a (blocks,) frame
    index on the card: (blocks, B, samples, 2), one LDPC launch a PLP and
    one tail launch on the planar tail, row i bit-identical to the
    one-block call on row i (cuFFT over blocks * B * S transforms at
    32K); and a ``CompiledStep`` over the same blocks replays it."""
    from dvbt2ll_tpu_torch.compiled import CompiledStep
    cfg = named_config(name)
    kw = (dict(strict=True) if strict
          else dict(strict=False, allow_phase_drift=True))
    tx = Transmitter(cfg, batch, device=cuda, **kw)
    ws = [torch.from_numpy(np.stack([
        synthetic_ts(187 + n, seed=140 + 100 * p + i) for i in range(blocks)
    ])).to(cuda) for p, n in enumerate(tx.bytes_per_step_per_plp)]
    idx = [i * batch % cfg.t2_frames for i in range(blocks)]
    before = _launches()
    out = tx._step_fn(tx.tensors, ws if len(ws) > 1 else ws[0],
                      torch.tensor(idx, device=cuda))
    assert _launches() == _added(before, len(ws), select_step_iq(cfg)[1])
    assert out.shape == (blocks, batch, cfg.samples_per_frame, 2)
    for i in range(blocks):
        one = [w[i] for w in ws]
        want = tx._step_fn(tx.tensors, one if len(one) > 1 else one[0],
                           idx[i])
        assert torch.equal(out[i], want), (i, idx[i])
    step = CompiledStep(tx._step_fn, tx.tensors, tx.plan, cuda, blocks)
    assert torch.equal(step(ws, idx), out)


def test_mesh_over_cards_is_one_graph_a_card(cuda):
    """A (2, 2) vv009 mesh over the cards in turn: one compiled step a
    card, one graph launch a card in a profiled step and no peer copy,
    the blocks bit-identical to the sequential Transmitter."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    cards = [torch.device("cuda", i) for i in range(n)]
    slots = [cards[i % n] for i in range(4)]
    _sharded_vs_sequential(slots)
    stx = _drift_sharded(vv009_config(), slots, 2)
    assert set(stx._steps) == set(slots)
    ts = np.stack([synthetic_ts(stx.bytes_per_step_per_mux, seed=13 + c)
                   for c in range(2)])
    assert _graph_launches(stx, ts) == (len(set(slots)), [])


# ------------------------------------------------------------ tracing
def _device_kernels(run, steps: int) -> list:
    """Names of the card's kernels, in start order, over ``steps`` calls
    of ``run`` under torch.profiler (the device copies of profiler ranges
    left out)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    evs = []
    for e in prof.profiler.kineto_results.events():
        if (str(e.device_type()).endswith("CUDA")
                and not e.name().startswith("tx:")):
            start = getattr(e, "start_ns", None)
            evs.append((start() if start else e.start_us() * 1000,
                        e.name()))
    return [n for _, n in sorted(evs)]


def _traced_transmitter(cuda, name, trace: bool):
    from dvbt2ll_tpu_torch import observability
    cfg = named_config(name)
    if trace:
        observability.enable()
    try:
        tx = Transmitter(cfg, min_batch_frames(cfg), device=cuda)
    finally:
        observability.disable()
    streams = [synthetic_ts(n, seed=150 + i)
               for i, n in enumerate(tx.bytes_per_step_per_plp)]
    return lambda: tx.step_device(streams if len(streams) > 1
                                  else streams[0])


_MARKED = ["vv009_4kshort", "multiplp_fef", "32k_extended", "uk_t2_32k"]


@pytest.mark.parametrize("name", _MARKED)
def test_capture_with_tracing_on_holds_the_stage_marks(cuda, name):
    """A step captured while tracing is on (planar tail, two PLPs, the
    complex tail, the UK mux's 47-frame 32K step) replays one mark a
    boundary, in step order (``ifft`` on the complex tail only), in every
    replay, whether or not tracing is still on; one captured while it is
    off replays the same kernels, as many times each, and no mark."""
    from collections import Counter
    # a graph captured before the process's first profiler session shows
    # some of its device-to-device copies as ``memcpy32_post`` kernels, one
    # captured after it as ``Memcpy DtoD``: both captures come after one
    _device_kernels(lambda: (torch.ones(4, device=cuda) * 2).sum().item(), 1)
    on = _device_kernels(_traced_transmitter(cuda, name, True), 3)
    off = _device_kernels(_traced_transmitter(cuda, name, False), 3)
    marks = [n[len("dvbt2ll_mark_"):] for n in on
             if n.startswith("dvbt2ll_mark_")]
    planar = select_step_iq(named_config(name))[1]
    one = (["start"] + ["fec", "map"] * named_config(name).num_plp
           + ["frames"] + ["ifft"] * (not planar) + ["tail"])
    assert marks == one * 3
    assert not [n for n in off if "dvbt2ll_mark_" in n]
    assert Counter(n for n in on if not n.startswith("dvbt2ll_mark_")) \
        == Counter(off)


def test_copy_done_lies_between_enqueue_and_drain(cuda):
    """``device_time_ns`` of each step's copy to the host: after the
    ``executor.copy`` span that enqueued it began, before the drain that
    waited for it returned."""
    from dvbt2ll_tpu_torch import observability
    cfg = vv009_config()
    tx = Transmitter(cfg, min_batch_frames(cfg), device=cuda)
    n = tx.bytes_per_step
    ts = synthetic_ts(5 * n, seed=160)
    pos = {"o": 0}

    def source(nbytes):
        pos["o"] += nbytes
        return ts[pos["o"] - nbytes:pos["o"]]

    ex = StreamingExecutor(tx, source)
    observability.enable()
    try:
        for _ in range(4):
            ex.step()
        ex.flush()
    finally:
        observability.disable()
    recs = observability.records()
    copy = {r.step: r for r in recs if r.name == "executor.copy"}
    drain = {r.step: r for r in recs if r.name == "executor.drain"}
    done = {r.step: r.t0_ns for r in recs if r.name == "executor.copy_done"}
    assert sorted(done) == sorted(copy) == sorted(drain) == [0, 1, 2, 3]
    for k, t in done.items():
        assert copy[k].t0_ns < t < drain[k].t1_ns, k


def test_tracing_turned_on_between_steps_loses_no_step(cuda):
    """Tracing turned on while a step's copy, enqueued with it off, is
    pending: every step's IQ still reaches the sink, bit for bit
    ``Transmitter.stream``'s, and only the copies enqueued with tracing on
    have an ``executor.copy_done`` instant."""
    from dvbt2ll_tpu_torch import observability
    cfg = vv009_config()
    batch = min_batch_frames(cfg)
    tx = Transmitter(cfg, batch, device=cuda)
    ref = Transmitter(cfg, batch, device=cuda)
    n = tx.bytes_per_step
    ts = synthetic_ts(4 * n, seed=161)
    want = [ref.stream(ts[k * n:(k + 1) * n]) for k in range(4)]
    pos = {"o": 0}

    def source(nbytes):
        pos["o"] += nbytes
        return ts[pos["o"] - nbytes:pos["o"]]

    sunk = []

    class Sink:
        def write(self, iq):
            sunk.append(np.array(iq))

    ex = StreamingExecutor(tx, source, sink=Sink())
    observability.disable()
    ex.step()
    observability.enable()
    try:
        for _ in range(3):
            ex.step()
        ex.flush()
    finally:
        observability.disable()
    assert len(sunk) == 4
    for k, (g, w) in enumerate(zip(sunk, want)):
        assert np.array_equal(g.reshape(-1), w), f"step {k}"
    done = sorted(r.step for r in observability.records()
                  if r.name == "executor.copy_done")
    assert done == [1, 2, 3]


def test_uk_mux_step_through_the_graph_matches_the_reference(cuda):
    """The UK DVB-T2 HD mux at its smallest strict step, 47 frames of 32K
    with 202 FEC blocks each (9494 FEC frames a launch): two steps through
    the captured graph, the complex tail's transform counted once a
    replay, and frame 0 of the first step and frame 37 of the second
    (an odd frame, the other L1-post dynamic part) against the
    benchmark's plain reference within its output check's 1e-5."""
    from txbench.reference.config import T2Config as RefConfig
    from txbench.reference.frames import rel_err, t2_frame
    from txbench.traffic.ts import rng, ts_packets
    cfg = named_config("uk_t2_32k")
    tx = Transmitter(cfg, min_batch_frames(cfg), device=cuda)
    assert tx._compiled._graph is not None
    n = tx.bytes_per_step
    ts = ts_packets(2 * n, rng(2**31 + 161, 1))
    windows = [np.concatenate([np.zeros(187, np.uint8), ts[:n]]),
               ts[n - 187:]]
    before = ifft.fft_tail.launches
    kept = [tx.step_window(w)[f].cpu().numpy() for w, f in zip(windows,
                                                                 (0, 37))]
    assert ifft.fft_tail.launches == before + 2
    ref_cfg = RefConfig.from_dict(cfg.to_dict())
    for g, iq in zip((0, 47 + 37), kept):
        ref = t2_frame(ref_cfg, lambda a, b: ts[a:b], g)
        assert rel_err(iq.reshape(-1).view(np.complex64), ref) <= 1e-5, g


@pytest.mark.parametrize("name,per_step", [("uk_t2_32k", 1),
                                           ("vv009_4kshort", 0)])
def test_fft_tail_counter_reads_one_a_replay(cuda, name, per_step):
    """``ops.ifft.fft_tail.launches``, registered in ``kernel_wrappers``:
    one a replay of a complex-tail step, none on the planar tail."""
    from dvbt2ll_tpu_torch.ops import kernel_wrappers
    assert kernel_wrappers()["fft_tail"] is ifft.fft_tail
    tx = Transmitter(named_config(name), 2, strict=False,
                     allow_phase_drift=True, device=cuda)
    before = ifft.fft_tail.launches
    for k in range(3):
        tx.step_device(synthetic_ts(tx.bytes_per_step, seed=170 + k))
    assert ifft.fft_tail.launches == before + 3 * per_step


# ------------------------------------------------------------- QAM mapper
_QAM_MODES = [(fs, c, r) for fs in (FrameSize.SHORT, FrameSize.NORMAL)
              for c in (Constellation.QPSK, Constellation.QAM16,
                        Constellation.QAM64, Constellation.QAM256)
              for r in (Rotation.OFF, Rotation.ON)]


def _qam(cfg, dev):
    """A PLP config's mapper tables on ``dev``, and the twin's: the same
    with the CPU's int64 indices moved to ``dev``."""
    pp = types.SimpleNamespace(cfg=cfg, mapper_perm=bit_permutation(cfg))
    t = qam_tables(pp, dev)
    return t, dataclasses.replace(t, perm=qam_tables(pp, "cpu").perm.to(dev))


def _qam_check(t, plain, bits):
    """Both layouts of the kernel against the twin on the card, bit for
    bit, each call one launch; the rows' first and last cells (the Q
    delay's wrap) checked on their own."""
    before = qam_map.launches
    re, im = qam_map(t, bits, planar=True)
    assert qam_map.launches == before + 1
    cells = qam_map(t, bits, planar=False)
    assert qam_map.launches == before + 2
    torch.cuda.synchronize()
    want_re, want_im = qam_map_plain(plain, bits)
    assert re.shape == im.shape == cells.shape == (bits.shape[0], t.cells)
    assert cells.dtype == torch.complex64 and cells.is_contiguous()
    for col in (0, -1):
        assert torch.equal(im[:, col], want_im[:, col])
        assert torch.equal(cells.imag[:, col], want_im[:, col])
    assert torch.equal(re, want_re) and torch.equal(im, want_im)
    assert torch.equal(cells, torch.complex(want_re, want_im))


@pytest.mark.parametrize("frames", [1, 37])
@pytest.mark.parametrize("frame_size,constellation,rotation", _QAM_MODES,
                         ids=[f"{fs.name}-{c.name}-rot{int(r)}"
                              for fs, c, r in _QAM_MODES])
def test_qam_kernel_matches_plain_every_mode(cuda, frame_size,
                                            constellation, rotation,
                                            frames):
    """Every frame size x modulation x rotation, one frame and an odd
    count: the planar and the interleaved kernel bit for bit against the
    twin."""
    cfg = T2Config(frame_size=frame_size, constellation=constellation,
                   rotation=rotation, code_rate=CodeRate.C2_3, fec_blocks=1,
                   ti_blocks=1)
    t, plain = _qam(cfg, cuda)
    bits = torch.from_numpy(np.random.default_rng(frames).integers(
        0, 2, (frames, t.frame_bits), dtype=np.uint8)).to(cuda)
    _qam_check(t, plain, bits)


@pytest.mark.parametrize("name,frames", [("uk_t2_32k", 202 * 47),
                                         ("vv009_4kshort", 16 * 47 * 8)])
def test_qam_kernel_matches_plain_at_the_cells_steps(cuda, name, frames):
    """The closed-loop cells' batches: the UK mux's 9494 normal frames and
    config 5's 6016 short ones, codewords from the LDPC kernel's range of
    values."""
    t, plain = _qam(named_config(name).plp_configs[0], cuda)
    gen = torch.Generator(device=cuda).manual_seed(frames)
    bits = torch.randint(0, 2, (frames, t.frame_bits), generator=gen,
                         dtype=torch.uint8, device=cuda)
    _qam_check(t, plain, bits)


def test_qam_wrapper_refuses_and_launches_nothing(cuda):
    cfg = named_config("vv009_4kshort")
    t, _ = _qam(cfg, cuda)
    host, _ = _qam(cfg, "cpu")
    bits = torch.zeros((4, t.frame_bits), dtype=torch.uint8, device=cuda)
    wide = torch.zeros((4, t.frame_bits + 8), dtype=torch.uint8, device=cuda)
    before = qam_map.launches
    bad = [(host, bits),                       # tables on the CPU
           (t, bits.to(torch.int32)),          # dtype
           (t, wide),                          # width
           (t, wide[:, :t.frame_bits]),        # not contiguous
           (t, bits[0])]                       # not 2-D
    for tables, x in bad:
        for planar in (True, False):
            with pytest.raises(ValueError):
                qam_map(tables, x, planar)
    assert qam_map.launches == before


@pytest.mark.parametrize("name,per_step", [("uk_t2_32k", 1),
                                           ("vv009_4kshort", 1),
                                           ("multiplp_fef", 2)])
def test_qam_counter_reads_one_a_plp_a_replay(cuda, name, per_step):
    """``ops.qam.qam_map.launches``, registered in ``kernel_wrappers``:
    one a PLP a replay, the complex tail's interleaved form and the
    planar tail's planes alike."""
    from dvbt2ll_tpu_torch.ops import kernel_wrappers
    assert kernel_wrappers()["qam_map"] is qam_map
    tx = Transmitter(named_config(name), 2, strict=False,
                     allow_phase_drift=True, device=cuda)
    before = qam_map.launches
    for k in range(3):
        tx.step_device([synthetic_ts(n, seed=180 + k)
                        for n in tx.bytes_per_step_per_plp])
    assert qam_map.launches == before + 3 * per_step
