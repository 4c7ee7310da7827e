"""The UK DVB-T2 HD multiplex (``named_config("uk_t2_32k")``: 32K
extended carriers, GI 1/128, PP7, 256QAM rotated, CR 2/3, 64800-bit FEC,
202 FEC blocks a frame): its frame arithmetic at full size, and the port
on the CPU against the benchmark's plain reference
(``txbench/reference/frames.t2_frame``) at a cut of the same mode.

The cut keeps every field of the mode but the frame's length: 7 FEC
blocks in 3 data symbols, with 3 TI blocks of 2, 2 and 3 FEC blocks, so
the time interleaver's blocks are uneven as at full size (67, 67, 68).
The bar is the benchmark's output check, 1e-5 relative error (100 dB).
The port's full-size step stays out of these tests: one frame of it runs
in ``test_torch_complex_tail.py::test_every_named_config_runs``."""
import dataclasses

import numpy as np
import pytest
import torch

from dvbt2ll_tpu_torch import Transmitter, min_batch_frames, named_config
from dvbt2ll_tpu_torch.pipeline import select_step_iq
from dvbt2ll_tpu_torch.plan import build_plan
from txbench.reference.config import T2Config as RefConfig
from txbench.reference.frames import rel_err, t2_frame
from txbench.traffic.ts import rng, ts_packets

LIMIT = 1e-5          # txbench/configs/uk_t2_32k.json's iq_rel_err_max
STEP_FRAMES = 47      # the cell 32k.single's frames a step


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_full_size_arithmetic():
    """The frame the sources and the assumed fields give: whole TS
    packets every 47 frames, 978 dummy cells, 60 symbols of 32768 + 256
    samples after P1, three uneven TI blocks, and a 47-frame step of
    50 982 780 TS bytes on the complex tail."""
    cfg = named_config("uk_t2_32k")
    assert min_batch_frames(cfg) == STEP_FRAMES
    assert cfg.dummy_cells == 978
    assert cfg.num_symbols == 60
    assert cfg.samples_per_frame == 2048 + 60 * (32768 + 256) == 1983488
    assert cfg.ti_structure == (67, 68, 2, 1)
    assert cfg.frame_duration < 0.25
    assert (cfg.kbch, cfg.ldpc_frame_bits, cfg.bch_t) == (43040, 64800, 10)
    assert not select_step_iq(cfg)[1]
    plan = build_plan(cfg, STEP_FRAMES, strict=True)
    assert plan.ts_bytes_in == 50982780 == STEP_FRAMES * 202 * 5370
    assert plan.fec_frames == 9494
    # the FEC kernels' flat indices stay inside 32 bits
    assert plan.fec_frames * cfg.ldpc_frame_bits < 2**31


def _cut():
    return dataclasses.replace(named_config("uk_t2_32k"), fec_blocks=7,
                               num_data_symbols=3).validate()


@pytest.fixture(scope="module")
def cut_step():
    """The cut's first step of 2 frames from seeded TS, on the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cfg = _cut()
        tx = Transmitter(cfg, 2, strict=False, device="cpu")
        n = tx.bytes_per_step
        ts = ts_packets(-(-(n + 188) // 188) * 188, rng(2**31 + 16, 7))
        iq = tx(ts[:n])
    finally:
        torch.set_num_threads(prev)
    return cfg, ts, iq


def test_cut_keeps_uneven_ti_blocks_and_the_complex_tail(cut_step):
    cfg, _, iq = cut_step
    assert cfg.ti_structure == (2, 3, 2, 1)
    assert not select_step_iq(cfg)[1]
    assert iq.shape == (2, cfg.samples_per_frame)


@pytest.mark.parametrize("frame", [0, 1])
def test_cut_matches_the_plain_reference(cut_step, frame):
    """Frame 0 and frame 1 (the other L1-post dynamic part) of the port's
    step against the reference worked out from the same TS bytes."""
    cfg, ts, iq = cut_step
    ref = t2_frame(RefConfig.from_dict(cfg.to_dict()),
                   lambda a, b: ts[a:b], frame)
    assert rel_err(iq[frame], ref) <= LIMIT
