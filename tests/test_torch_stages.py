"""Each stage of the port against its JAX counterpart, on the same plan
(``dvbt2ll_tpu.plan.build_plan(cfg, 2, strict=False)``) and the same TS
bytes, for vv009 (short frames, 4K) and 8k_normal (normal frames, 8K).

Bars: FEC bits exact; mapper planes within atol 2e-6, the golden test's
own tolerance for float32 cells; the planar step's IQ above 120 dB SNR,
the JAX package's bar between two formulations of the same math.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbt2ll_tpu import pipeline as jpipe
from dvbt2ll_tpu.io import synthetic_ts
from dvbt2ll_tpu.plan import build_plan
from dvbt2ll_tpu_torch import _bits, named_config, plan_tensors
from dvbt2ll_tpu_torch import pipeline as tpipe


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


@pytest.fixture(scope="module", params=["vv009_4kshort", "8k_normal"])
def case(request):
    plan = build_plan(named_config(request.param), 2, strict=False)
    ts = synthetic_ts(plan.ts_bytes_in, seed=31)
    window = np.concatenate([np.full(187, 0x5A, np.uint8), ts])
    bits = np.array(jax.jit(functools.partial(
        jpipe.bb_and_fec, plan.plps[0]))(jnp.asarray(window)))
    return plan, plan_tensors(plan, "cpu", planar=True), window, bits


def test_bb_and_fec_matches_jax(case):
    plan, tp, window, want = case
    got = tpipe.bb_and_fec(tp.plps[0], torch.from_numpy(window)).numpy()
    assert got.shape == (plan.plps[0].fec_frames, plan.cfg.ldpc_frame_bits)
    np.testing.assert_array_equal(got, want)


def test_map_cells_planes_matches_jax(case):
    plan, tp, _, bits = case
    j_re, j_im = jax.jit(functools.partial(
        jpipe.map_cells_planes, plan.plps[0]))(jnp.asarray(bits))
    t_re, t_im = tpipe.map_cells_planes(tp.plps[0], torch.from_numpy(bits))
    np.testing.assert_allclose(t_re.numpy(), np.asarray(j_re), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(t_im.numpy(), np.asarray(j_im), rtol=0,
                               atol=2e-6)
    cells = tpipe.map_cells(tp.plps[0], torch.from_numpy(bits))
    assert torch.equal(cells, torch.complex(t_re, t_im))


def test_transmit_step_iq_planar_matches_jax(case):
    """Two frames from frame index 1, so the per-frame L1-post rows wrap
    the t2_frames counter."""
    plan, tp, window, _ = case
    want = np.asarray(jax.jit(functools.partial(
        jpipe.transmit_step_iq_planar, plan))(jnp.asarray(window),
                                              jnp.int32(1)))
    got = tpipe.transmit_step_iq_planar(tp, torch.from_numpy(window), 1)
    assert got.dtype == torch.float32 and got.shape == want.shape
    got = got.numpy()
    snr = _snr_db(want[..., 0] + 1j * want[..., 1],
                  got[..., 0] + 1j * got[..., 1])
    assert snr > 120, f"{snr:.1f} dB"


@pytest.mark.parametrize("shape,dim", [((5, 24), 1), ((16, 3), 0),
                                       ((2, 3, 13), -1)])
def test_bits_match_numpy(shape, dim):
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    bits = np.unpackbits(x, axis=dim)
    np.testing.assert_array_equal(
        _bits.unpackbits(torch.from_numpy(x), dim).numpy(), bits)
    np.testing.assert_array_equal(
        _bits.packbits(torch.from_numpy(bits), dim).numpy(), x)
    # a ragged tail packs as numpy pads it: with zero bits
    ragged = np.take(bits, np.arange(bits.shape[dim] - 3), axis=dim)
    np.testing.assert_array_equal(
        _bits.packbits(torch.from_numpy(ragged), dim).numpy(),
        np.packbits(ragged, axis=dim))


def test_gf2_matmul_is_exact():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 2, (7, 3000), dtype=np.uint8)
    m = rng.integers(0, 2, (3000, 9)).astype(np.float32)
    want = (a.astype(np.int64) @ m.astype(np.int64)) & 1
    got = _bits.gf2_matmul(torch.from_numpy(a), torch.from_numpy(m))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
