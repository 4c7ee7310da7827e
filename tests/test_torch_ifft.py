"""The port's planar OFDM tail (``dvbt2ll_tpu_torch/ops/ifft.py``) against
the JAX package's Pallas kernel, run as that package's own tests run it
on the CPU (interpret mode): the einsum twin alone, and the fused twin
(P1, then each symbol with its guard interval, as final I/Q) against the
Pallas kernel with the JAX planar step's P1 concat and I/Q stack
(``dvbt2ll_tpu/pipeline.py:419-423``).  Then the kernel wrapper's
contract on the CPU and the kernel's twiddle tables.

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


def _p1(seed=9):
    return np.random.default_rng(seed).standard_normal(
        (ifft.P1_LEN, 2)).astype(np.float32)


@pytest.mark.parametrize("fft,gi", _CASES,
                         ids=[f"{f}-{g}" for f, g in _CASES])
def test_fused_twin_matches_pallas_kernel(fft, gi):
    """The fused twin's (B, 2048 + S (fft + gi), 2) I/Q: P1 exact, the
    symbols above 120 dB against the Pallas kernel after the JAX planar
    step's P1 concat and I/Q stack."""
    re, im = _grids(fft)
    p1 = _p1()
    scale = 1.0 / np.sqrt(fft)
    body_re, body_im = (np.asarray(a).reshape(2, -1) for a in ifft_gi_pallas(
        re, im, fft, gi, scale, interpret=True))
    want = np.concatenate([np.broadcast_to(p1, (2, ifft.P1_LEN, 2)),
                           np.stack([body_re, body_im], axis=-1)], axis=1)
    got = ifft.ofdm_tail_plain(torch.from_numpy(re), torch.from_numpy(im),
                               torch.from_numpy(p1), fft, gi, scale).numpy()
    assert got.shape == want.shape == (2, ifft.P1_LEN + 3 * (fft + gi), 2)
    np.testing.assert_array_equal(got[:, :ifft.P1_LEN], want[:, :ifft.P1_LEN])
    snr = _snr_db(want[..., 0], want[..., 1], got[..., 0], got[..., 1])
    assert snr > 120, f"{snr:.1f} dB"


@pytest.mark.parametrize("fft", [1024, 8192])
def test_tail_tables(fft):
    """The kernel's twiddles: exp(2 pi i k / M) made in float64, rounded
    once to float32, interleaved (re, im); the scale in the 4-step one."""
    t = ifft.tail_tables(fft, 0.25, "cpu")
    for table, m, scale in ((t.w128, 128, 1.0), (t.twiddle, fft, 0.25)):
        z = scale * np.exp(2j * np.pi * np.arange(m) / m)
        assert table.dtype == torch.float32 and table.shape == (m, 2)
        np.testing.assert_array_equal(
            table.numpy(), np.stack([z.real, z.imag], -1).astype(np.float32))
    assert all(torch.equal(a, b) for a, b in
               zip(t.mats, ifft.factor_tensors(fft, 0.25, "cpu")))


def test_cpu_tensor_takes_the_twin():
    re, im = (torch.from_numpy(a) for a in _grids(4096))
    p1 = torch.from_numpy(_p1())
    tables = ifft.tail_tables(4096, 0.5, "cpu")
    before = ifft.ifft_gi.launches
    got = ifft.ifft_gi(re, im, p1, 4096, 128, 0.5, tables)
    want = ifft.ofdm_tail_plain(re, im, p1, 4096, 128, 0.5, tables)
    assert got.shape == (2, ifft.P1_LEN + 3 * (4096 + 128), 2)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got, want)
    # the twin is the einsum form with P1 in front and the planes stacked
    body_re, body_im = ifft.ifft_gi_einsum(re, im, 4096, 128, 0.5)
    assert torch.equal(got[:, ifft.P1_LEN:, 0], body_re.reshape(2, -1))
    assert torch.equal(got[:, ifft.P1_LEN:, 1], body_im.reshape(2, -1))
    # tables built on the grids' device when not given
    assert torch.equal(ifft.ifft_gi(re, im, p1, 4096, 128, 0.5), want)
    assert ifft.ifft_gi.launches == before


def test_wrapper_refusals():
    re, im = (torch.from_numpy(a) for a in _grids(2048))
    p1 = torch.from_numpy(_p1())
    with pytest.raises(ValueError, match="float32"):
        ifft.ifft_gi(re.double(), im.double(), p1, 2048, 256, 1.0)
    with pytest.raises(ValueError, match="float32"):
        ifft.ifft_gi(re, im, p1.double(), 2048, 256, 1.0)
    with pytest.raises(ValueError, match="P1"):
        ifft.ifft_gi(re, im, p1[:1024], 2048, 256, 1.0)
    with pytest.raises(ValueError, match="tables"):
        ifft.ifft_gi(re, im, p1, 2048, 256, 1.0,
                     ifft.tail_tables(4096, 1.0, "cpu"))
    with pytest.raises(ValueError, match="do not fit"):
        ifft.ifft_gi(re[..., :64], im[..., :64], p1, 2048, 256, 1.0)
    with pytest.raises(ValueError, match="do not fit"):
        ifft.ifft_gi(re, im, p1, 4096, 256, 1.0)  # 16 rows, not 32
    with pytest.raises(ValueError, match="do not fit"):
        ifft.ifft_gi(re, im, p1, 2048, 64, 1.0)   # GI not whole rows
    big = torch.zeros((1, 1, 128, 128))
    with pytest.raises(ValueError, match="do not fit"):
        ifft.ifft_gi(big, big, p1, 16384, 128, 1.0)  # 16K: the complex tail
    with pytest.raises(ValueError, match="do not fit"):
        ifft.ifft_gi(re, im, p1, 2048, 4096, 1.0)    # GI longer than the FFT
