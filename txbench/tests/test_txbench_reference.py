"""The plain reference against the reference binary's vectors
(``tests/golden_ref``), and its T2 frame at any place in a stream against
the whole chain."""
import os

import numpy as np
import pytest

from txbench.reference import chain
from txbench.reference.config import T2Config
from txbench.reference.frames import rel_err, t2_frame, tf32_ifft
from txbench.tests.conftest import REPO
from txbench.traffic.ts import ts_packets

GOLDEN = os.path.join(REPO, "tests", "golden_ref")


def _case(name):
    # the fields the vectors were made with, as the repo names them
    from dvbt2ll_tpu_torch.config import named_config
    cfg = T2Config.from_dict(named_config(name).to_dict())
    z = np.load(os.path.join(GOLDEN, name + ".npz"))
    n = int(z["ts_bytes"])
    # the vectors' TS: io.synthetic_ts(n, seed), whole packets cut to n
    ts = ts_packets(-(-n // 188) * 188,
                    np.random.default_rng(int(z["ts_seed"])))[:n]
    return cfg, z, ts


def _bits(z, stage):
    return np.unpackbits(z[f"{stage}_bits_packed"])[:int(z[f"{stage}_count"])]


@pytest.mark.parametrize("name", ["vv009_4kshort", "32k_extended"])
def test_reference_matches_the_reference_binary(name):
    """FEC bits exact, IQ above 100 dB SNR against the reference C++."""
    cfg, z, ts = _case(name)
    nframes = int(z["nframes"])
    fec = nframes * cfg.fec_blocks
    frames, _ = chain.bbheader_frames(cfg, ts, fec)
    np.testing.assert_array_equal(frames.reshape(-1), _bits(z, "stage1"))
    coded = chain.ldpc_encode(cfg, frames)
    np.testing.assert_array_equal(coded.reshape(-1), _bits(z, "stage2"))
    iq = chain.transmit_chain(cfg, ts, nframes)
    assert rel_err(iq, z["stage5_iq"]) < 1e-5      # above 100 dB


@pytest.mark.parametrize("name", ["vv009_4kshort", "32k_extended"])
def test_frame_anywhere_in_the_stream(name):
    """``t2_frame`` works the stream state out from the bytes before the
    frame: every frame of the vectors equals the reference binary's."""
    cfg, z, ts = _case(name)
    spf = cfg.samples_per_frame
    gold = z["stage5_iq"].reshape(-1, spf)
    stream = lambda a, b: ts[a:b]
    for g in range(gold.shape[0]):
        assert rel_err(t2_frame(cfg, stream, g), gold[g]) < 1e-5


def test_control_fails_the_limit():
    """The control (the reference's transform in TF32) reads far above
    the limit on a frame; the reference itself reads nothing."""
    cfg, z, ts = _case("vv009_4kshort")
    stream = lambda a, b: ts[a:b]
    ref = t2_frame(cfg, stream, 1)
    assert rel_err(t2_frame(cfg, stream, 1, tf32_ifft), ref) > 10 * 1e-5
    assert rel_err(ref, ref) == 0.0
