"""The port's planar OFDM tail (``dvbt2ll_tpu_torch/ops/ifft.py``) against
the JAX package's Pallas kernel, run as that package's own tests run it
on the CPU (interpret mode), and the kernel wrapper's contract on the CPU.

Bar: above 120 dB SNR per plane pair, the JAX package's bar between two
formulations of the same float32 math (tests/test_planar_tail.py).
"""
import numpy as np
import pytest
import torch

from dvbt2ll_tpu.ops.ifft_pallas import ifft_gi_pallas
from dvbt2ll_tpu_torch.ops import ifft

_CASES = [(1024, 128), (1024, 256), (2048, 256), (4096, 128), (4096, 1024),
          (8192, 512), (8192, 2048)]


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _grids(fft, b=2, s=3, seed=7):
    rng = np.random.default_rng(seed)
    shape = (b, s, fft // ifft.N1, ifft.N1)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _snr_db(ref_re, ref_im, re, im):
    ref = np.asarray(ref_re, np.float64) + 1j * np.asarray(ref_im, np.float64)
    x = np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)
    err = np.sum(np.abs(x - ref) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(np.abs(ref) ** 2)
                                                 / err)


@pytest.mark.parametrize("fft,gi", _CASES,
                         ids=[f"{f}-{g}" for f, g in _CASES])
def test_twin_matches_pallas_kernel(fft, gi):
    re, im = _grids(fft)
    scale = 1.0 / np.sqrt(fft)
    want_re, want_im = ifft_gi_pallas(re, im, fft, gi, scale, interpret=True)
    got_re, got_im = ifft.ifft_gi_einsum(torch.from_numpy(re),
                                         torch.from_numpy(im), fft, gi,
                                         scale)
    assert got_re.shape == (2, 3, fft + gi) == tuple(want_re.shape)
    snr = _snr_db(want_re, want_im, got_re.numpy(), got_im.numpy())
    assert snr > 120, f"{snr:.1f} dB"


def test_cpu_tensor_takes_the_twin():
    re, im = (torch.from_numpy(a) for a in _grids(4096))
    mats = ifft.factor_tensors(4096, 0.5, "cpu")
    before = ifft.ifft_gi.launches
    got = ifft.ifft_gi(re, im, 4096, 128, 0.5, mats)
    want = ifft.ifft_gi_einsum(re, im, 4096, 128, 0.5, mats)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # mats built on the grids' device when not given
    assert all(torch.equal(g, w) for g, w in
               zip(ifft.ifft_gi(re, im, 4096, 128, 0.5), want))
    assert ifft.ifft_gi.launches == before


def test_wrapper_refusals():
    re, im = (torch.from_numpy(a) for a in _grids(2048))
    with pytest.raises(ValueError, match="float32"):
        ifft.ifft_gi(re.double(), im.double(), 2048, 256, 1.0)
    with pytest.raises(ValueError, match="do not fit"):
        ifft.ifft_gi(re[..., :64], im[..., :64], 2048, 256, 1.0)
    with pytest.raises(ValueError, match="do not fit"):
        ifft.ifft_gi(re, im, 4096, 256, 1.0)  # 16 rows, not 32
    with pytest.raises(ValueError, match="do not fit"):
        ifft.ifft_gi(re, im, 2048, 64, 1.0)   # GI not whole rows
    big = torch.zeros((1, 1, 128, 128))
    with pytest.raises(ValueError, match="do not fit"):
        ifft.ifft_gi(big, big, 16384, 128, 1.0)  # 16K: the complex tail
    with pytest.raises(ValueError, match="do not fit"):
        ifft.ifft_gi(re, im, 2048, 4096, 1.0)    # GI longer than the FFT
