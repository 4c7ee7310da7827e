"""The port's ``Transmitter`` on the CPU against vectors the unmodified
reference C++ produced (``tests/golden_ref``, see
tests/test_reference_golden.py), for every golden: the planar tail's
(1K-8K FFTs, guard intervals of whole 128-sample rows) and the complex
tail's (16K, 32K, and the 1216-sample guard interval of
t2lite_8k_t2gi_miso).  FEC bits exact, mapper cells within atol 2e-6, IQ
above 100 dB SNR - the JAX package's own bars."""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from dvbt2ll_tpu_torch import Transmitter, named_config, synthetic_ts
from dvbt2ll_tpu_torch.config import NAMED_CONFIGS
from dvbt2ll_tpu_torch.ops.ifft import supported
from dvbt2ll_tpu_torch.pipeline import bb_and_fec, map_cells
from tests.torch_compare import jax_named_config

_DIR = os.path.join(os.path.dirname(__file__), "golden_ref")
_NAMES = ["vv009_4kshort", "8k_normal", "hieff_4k", "inband_2k",
          "8k_miso_tx1", "8k_miso_tx2", "1k_pp4", "qpsk_short_c13",
          "ti_off_4k", "t2lite_4k", "v121_4k", "eq_2k_5mhz",
          # the complex tail
          "32k_extended", "32k_papr_tr", "16k_l1qpsk_both",
          "t2lite_16k_t2gi", "t2lite_8k_t2gi_miso"]


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _snr_db(ref, x):
    ref = np.asarray(ref, np.complex128).ravel()
    x = np.asarray(x, np.complex128).ravel()
    err = np.sum(np.abs(x - ref) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(np.abs(ref) ** 2)
                                                 / err)


@pytest.fixture(scope="module", params=_NAMES)
def golden(request):
    name = request.param
    with np.load(os.path.join(_DIR, f"{name}.npz")) as z:
        g = {k: z[k] for k in z.files}
    for stage in ("stage1", "stage2"):
        g[f"{stage}_bits"] = np.unpackbits(g[f"{stage}_bits_packed"])[
            : int(g[f"{stage}_count"])]
    cfg = named_config(name)
    ts = synthetic_ts(int(g["ts_bytes"]), seed=int(g["ts_seed"]))
    tx = Transmitter(cfg, int(g["nframes"]), strict=False, device="cpu")
    return name, cfg, g, ts, tx


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(os.path.dirname(__file__), "..", "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", NAMED_CONFIGS)
def test_named_config_matches_bench(bench, name):
    assert (dataclasses.asdict(named_config(name))
            == dataclasses.asdict(jax_named_config(bench._named_config,
                                                   name)))


def test_registry_is_whole():
    """Every golden has a named config and is a case here, on both tails,
    and an unknown name raises."""
    goldens = {f[:-4] for f in os.listdir(_DIR) if f.endswith(".npz")}
    assert goldens < set(NAMED_CONFIGS)
    assert set(_NAMES) == goldens and len(_NAMES) == len(goldens)
    planar = {n for n in goldens
              if supported(named_config(n).fft_points,
                           named_config(n).guard_samples)}
    assert 0 < len(planar) < len(goldens)
    with pytest.raises(ValueError, match="unknown"):
        named_config("no_such_config")


def test_fec_bit_exact(golden):
    name, cfg, g, ts, tx = golden
    padded = torch.from_numpy(np.concatenate([np.zeros(187, np.uint8), ts]))
    bits = bb_and_fec(tx.tensors.plps[0], padded).numpy()
    f = tx.plan.plps[0].fec_frames
    assert bits.shape == (f, cfg.ldpc_frame_bits)
    np.testing.assert_array_equal(bits[:, :cfg.nbch],
                                  g["stage1_bits"].reshape(f, cfg.nbch))
    np.testing.assert_array_equal(
        bits, g["stage2_bits"].reshape(f, cfg.ldpc_frame_bits))


def test_mapper_cells(golden):
    name, cfg, g, ts, tx = golden
    f = tx.plan.plps[0].fec_frames
    ref2 = torch.from_numpy(g["stage2_bits"].reshape(f, -1))
    cells = map_cells(tx.tensors.plps[0], ref2).numpy()
    np.testing.assert_allclose(cells, g["stage3_cells"].reshape(f, -1),
                               rtol=0, atol=2e-6)


def test_iq_waveform(golden):
    """Through the user's entry point: one Transmitter call from the
    initial (all-zero) carry."""
    name, cfg, g, ts, _ = golden
    tx = Transmitter(cfg, int(g["nframes"]), strict=False, device="cpu")
    iq = tx(ts)
    ref5 = g["stage5_iq"].reshape(iq.shape)
    snr = _snr_db(ref5, iq)
    assert snr > 100, f"IQ SNR {snr:.1f} dB vs reference"


def test_vv009_waveform_is_pinned():
    """tests/golden_vv009.npz, the oracle-made vectors that
    tests/test_golden.py holds the JAX chain to, with its tolerances."""
    tx = Transmitter(named_config("vv009_4kshort"), 1, strict=False,
                     device="cpu")
    iq = tx(synthetic_ts(tx.bytes_per_step, seed=1234))[0]
    with np.load(os.path.join(os.path.dirname(__file__),
                              "golden_vv009.npz")) as z:
        assert np.abs(iq[:2048] - z["p1"]).max() < 1e-5
        assert np.abs(iq[2048:2048 + 4224] - z["sym0"]).max() < 1e-5
        checksum = z["checksum"]
    assert abs(np.abs(iq).sum() - checksum) / checksum < 1e-5
