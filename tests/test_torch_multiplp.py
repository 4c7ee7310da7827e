"""Multi-PLP frames, FEF insertion and the pre-carried-window entry of the
port's ``Transmitter``, after tests/test_multiplp_fef.py: against the JAX
``Transmitter`` (above 120 dB SNR, the bar between two formulations of
the same float32 math) and against ``refmodel.transmit_chain``, the
sequential numpy oracle (above 100 dB, the JAX package's bar).  No
reference-binary golden covers this surface."""
import numpy as np
import pytest
import torch

from dvbt2ll_tpu import refmodel
from dvbt2ll_tpu.pipeline import Transmitter as JaxTransmitter
from dvbt2ll_tpu_torch import (Transmitter, min_batch_frames, named_config,
                               synthetic_ts)
from dvbt2ll_tpu_torch.config import (CodeRate, Constellation, FFTSize,
                                      FrameSize, GuardInterval, PilotPattern,
                                      PLPConfig, Rotation, T2Config)
from tests.torch_compare import snr_db


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _mixed_plp_cfg():
    """Two type-1 data PLPs with different code rates and constellations
    (tests/test_multiplp_fef.py::_mixed_plp_cfg)."""
    return T2Config(
        frame_size=FrameSize.SHORT, code_rate=CodeRate.C4_5,
        constellation=Constellation.QAM256, rotation=Rotation.ON,
        fft_size=FFTSize.FFT_4K, guard_interval=GuardInterval.GI_1_32,
        pilot_pattern=PilotPattern.PP7,
        plps=(
            PLPConfig(plp_id=0, code_rate=CodeRate.C4_5,
                      constellation=Constellation.QAM256,
                      rotation=Rotation.ON, frame_size=FrameSize.SHORT,
                      fec_blocks=4, ti_blocks=2),
            PLPConfig(plp_id=1, code_rate=CodeRate.C1_2,
                      constellation=Constellation.QAM16,
                      rotation=Rotation.OFF, frame_size=FrameSize.SHORT,
                      fec_blocks=2, ti_blocks=1),
        ),
        fec_blocks=4, ti_blocks=2, t2_frames=2,
        num_data_symbols=3).validate()


def _typed_plp_cfg():
    """A common PLP (type 0), a type-1 and two sub-sliced type-2 PLPs
    (tests/test_multiplp_fef.py::_typed_plp_cfg)."""
    return T2Config(
        frame_size=FrameSize.SHORT, code_rate=CodeRate.C4_5,
        constellation=Constellation.QAM256, rotation=Rotation.ON,
        fft_size=FFTSize.FFT_4K, guard_interval=GuardInterval.GI_1_32,
        pilot_pattern=PilotPattern.PP7, sub_slices=2,
        plps=(
            PLPConfig(plp_id=0, plp_type=0, code_rate=CodeRate.C1_2,
                      constellation=Constellation.QAM16,
                      rotation=Rotation.OFF, frame_size=FrameSize.SHORT,
                      fec_blocks=1, ti_blocks=1),
            PLPConfig(plp_id=1, plp_type=1, code_rate=CodeRate.C4_5,
                      constellation=Constellation.QAM256,
                      rotation=Rotation.ON, frame_size=FrameSize.SHORT,
                      fec_blocks=2, ti_blocks=1),
            PLPConfig(plp_id=2, plp_type=2, code_rate=CodeRate.C1_2,
                      constellation=Constellation.QAM16,
                      rotation=Rotation.OFF, frame_size=FrameSize.SHORT,
                      fec_blocks=2, ti_blocks=1),
            PLPConfig(plp_id=3, plp_type=2, code_rate=CodeRate.C3_5,
                      constellation=Constellation.QAM16,
                      rotation=Rotation.OFF, frame_size=FrameSize.SHORT,
                      fec_blocks=1, ti_blocks=1),
        ),
        fec_blocks=4, ti_blocks=2, t2_frames=2,
        num_data_symbols=8).validate()


_CONFIGS = {"multiplp_fef": lambda: named_config("multiplp_fef"),
            "mixed": _mixed_plp_cfg, "typed": _typed_plp_cfg}


@pytest.mark.parametrize("which", sorted(_CONFIGS))
def test_multi_plp_matches_jax_and_oracle(which):
    cfg = _CONFIGS[which]()
    assert cfg.num_plp > 1
    tx = Transmitter(cfg, 1, strict=False, device="cpu")
    streams = [synthetic_ts(n, seed=62 + i)
               for i, n in enumerate(tx.bytes_per_step_per_plp)]
    got = tx(streams)
    jtx = JaxTransmitter(cfg, 1, strict=False, use_pallas=False)
    assert jtx.bytes_per_step_per_plp == tx.bytes_per_step_per_plp
    snr = snr_db(jtx(streams), got)
    assert snr > 120, f"vs JAX {snr:.1f} dB"
    ref = refmodel.transmit_chain(cfg, streams, 1).reshape(got.shape)
    snr = snr_db(ref, got)
    assert snr > 100, f"vs oracle {snr:.1f} dB"


def test_fef_insertion_through_stream():
    cfg = named_config("multiplp_fef")
    tx = Transmitter(cfg, 2, strict=False, device="cpu")
    streams = [synthetic_ts(n, seed=63 + i)
               for i, n in enumerate(tx.bytes_per_step_per_plp)]
    out = tx.stream(streams)
    spf = cfg.samples_per_frame
    # frames 0 and 1, then one FEF part after frame 1 (fef_interval 2)
    assert out.dtype == np.complex64
    assert out.size == 2 * spf + cfg.fef_length
    np.testing.assert_array_equal(out[2 * spf:], tx.plan.fef_part)
    fef = out[2 * spf:]
    assert np.abs(fef[:2048]).max() > 0       # its own P1
    assert np.abs(fef[2048:]).max() == 0      # then nulls
    assert not np.allclose(fef[:2048], out[:2048])
    want = JaxTransmitter(cfg, 2, strict=False, use_pallas=False).stream(
        streams)
    assert want.shape == out.shape
    assert snr_db(want, out) > 120


def test_stream_window_matches_stream():
    """Two strict steps of multiplp_fef: per-PLP pre-carried windows
    through ``stream_window`` give the stream that fresh bytes give
    through ``stream``, FEF parts and state included."""
    cfg = named_config("multiplp_fef")
    b = min_batch_frames(cfg)   # phase-invariant: streamable across steps
    tx_a = Transmitter(cfg, b, device="cpu")
    tx_b = Transmitter(cfg, b, device="cpu")
    ns = tx_a.bytes_per_step_per_plp
    ts = [synthetic_ts(2 * n, seed=64 + i) for i, n in enumerate(ns)]
    total = 0
    for step in range(2):
        fresh = [t[step * n:(step + 1) * n] for t, n in zip(ts, ns)]
        a = tx_a.stream(fresh)
        windows = [np.concatenate([
            np.zeros(187, np.uint8) if step == 0
            else t[step * n - 187:step * n], f])
            for t, n, f in zip(ts, ns, fresh)]
        got = tx_b.stream_window(windows)
        assert np.array_equal(a, got)
        total += got.size
    # one FEF part after every odd frame of the 2 * b frames
    assert total == 2 * b * cfg.samples_per_frame + b * cfg.fef_length
    sa, sb = tx_a.state_dict(), tx_b.state_dict()
    np.testing.assert_array_equal(sa["carries"], sb["carries"])
    assert (sa["frame_idx"], sa["steps_done"]) == (sb["frame_idx"],
                                                   sb["steps_done"])


def test_validate_ts_counts_sync_errors_like_jax():
    cfg = named_config("multiplp_fef")
    tx = Transmitter(cfg, 1, strict=False, validate_ts=True, device="cpu")
    off = Transmitter(cfg, 1, strict=False, device="cpu")
    jtx = JaxTransmitter(cfg, 1, strict=False, validate_ts=True,
                         use_pallas=False)
    windows = []
    for i, n in enumerate(tx.bytes_per_step_per_plp):
        w = np.concatenate([np.zeros(187, np.uint8),
                            synthetic_ts(n, seed=65 + i)])
        w[187 + 188 * (i + 1)] ^= 0xFF   # two broken sync bytes a window
        w[187 + 188 * 3] = 0x00
        windows.append(w)
    tx.step_window(windows)
    off.step_window(windows)
    jtx.step_window(windows)
    assert tx.counters.sync_errors == jtx.counters.sync_errors == 4
    assert off.counters.sync_errors == 0
