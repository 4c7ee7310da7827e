"""The port's complex OFDM tail (``build_frames``, ``modulate``,
``transmit_step_iq``: the ``torch.fft`` path of every geometry the planar
tail does not take) against the JAX package's stage functions, called
eagerly on one plan and the same TS bytes, for a 32K, a 16K and a
GI-1216 config; the tail choice and the constants each tail uploads; and
every named config through ``Transmitter``.

Bars: grids within atol 2e-6 (the same gather of the same float32
cells); IQ above 120 dB SNR, the JAX package's bar between two
formulations of the same float32 math."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbt2ll_tpu import pipeline as jpipe
from dvbt2ll_tpu.io import synthetic_ts
from dvbt2ll_tpu.plan import build_plan
from dvbt2ll_tpu_torch import (Transmitter, min_batch_frames, named_config,
                               plan_tensors)
from dvbt2ll_tpu_torch import pipeline as tpipe
from dvbt2ll_tpu_torch.config import NAMED_CONFIGS, InputMode
from dvbt2ll_tpu_torch.convert import ComplexTail, PlanarTail
from dvbt2ll_tpu_torch.ops.ifft import supported
from tests.torch_compare import snr_db

# (name, frames): 32K extended carriers, 16K with PAPR and L1 QPSK, and the
# 8K T2-Lite MISO config whose guard interval (19/128: 1216 samples) is
# not a whole number of 128-sample rows
_CASES = [("32k_extended", 1), ("16k_l1qpsk_both", 2),
          ("t2lite_8k_t2gi_miso", 2)]


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=_CASES, ids=[c[0] for c in _CASES])
def case(request):
    """One plan, a window with a non-zero carry, and the JAX stages on it
    eagerly, from frame index 1 (so L1-post rows wrap t2_frames)."""
    name, frames = request.param
    plan = build_plan(named_config(name), frames, strict=False)
    ts = synthetic_ts(plan.ts_bytes_in, seed=81)
    window = np.concatenate([np.full(187, 0x5A, np.uint8), ts])
    pp = plan.plps[0]
    cells = jpipe.map_cells(pp, jpipe.bb_and_fec(pp, jnp.asarray(window)))
    payload = np.array(cells).reshape(frames, -1)
    grids = jpipe.build_frames(plan, jnp.asarray(payload), jnp.int32(1))
    iq = np.asarray(jpipe.modulate(plan, grids))
    tp = plan_tensors(plan, "cpu", planar=False)
    return plan, tp, window, payload, np.array(grids), iq


def test_build_frames_matches_jax(case):
    plan, tp, _, payload, grids, _ = case
    got = tpipe.build_frames(tp, torch.from_numpy(payload), 1)
    assert got.dtype == torch.complex64 and tuple(got.shape) == grids.shape
    np.testing.assert_allclose(got.numpy(), grids, rtol=0, atol=2e-6)


def test_modulate_matches_jax(case):
    plan, tp, _, _, grids, iq = case
    got = tpipe.modulate(tp, torch.from_numpy(grids))
    assert got.dtype == torch.complex64 and tuple(got.shape) == iq.shape
    assert iq.shape == (plan.batch_frames, plan.cfg.samples_per_frame)
    snr = snr_db(iq, got.numpy())
    assert snr > 120, f"{snr:.1f} dB"


def test_transmit_step_iq_matches_jax(case):
    """The whole complex step against the JAX ``transmit_step_iq``."""
    plan, tp, window, _, _, _ = case
    want = np.asarray(jpipe.transmit_step_iq(plan, jnp.asarray(window),
                                             jnp.int32(1)))
    got = tpipe.transmit_step_iq(tp, torch.from_numpy(window), 1)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert got.is_contiguous()
    got = got.numpy()
    snr = snr_db(want[..., 0] + 1j * want[..., 1],
                 got[..., 0] + 1j * got[..., 1])
    assert snr > 120, f"{snr:.1f} dB"


@pytest.mark.parametrize("name", ["vv009_4kshort", "eq_2k_5mhz"])
def test_complex_tail_equals_planar_tail(name):
    """Where both tails apply (here with and without the inverse sinc),
    the complex step and the planar step agree above 120 dB."""
    plan = build_plan(named_config(name), 2, strict=False)
    window = torch.from_numpy(np.concatenate(
        [np.zeros(187, np.uint8), synthetic_ts(plan.ts_bytes_in, seed=82)]))
    planar = tpipe.transmit_step_iq_planar(
        plan_tensors(plan, "cpu", planar=True), window, 1).numpy()
    cplx = tpipe.transmit_step_iq(
        plan_tensors(plan, "cpu", planar=False), window, 1).numpy()
    assert cplx.shape == planar.shape
    snr = snr_db(planar[..., 0] + 1j * planar[..., 1],
                 cplx[..., 0] + 1j * cplx[..., 1])
    assert snr > 120, f"{snr:.1f} dB"


def test_each_tail_uploads_only_its_constants():
    """A 32K plan builds no planar factor matrices or transposed gather;
    a 4K plan builds no natural grid."""
    big = Transmitter(named_config("32k_extended"), 1, strict=False,
                      device="cpu").tensors.tail
    small = Transmitter(named_config("vv009_4kshort"), 1, strict=False,
                        device="cpu").tensors.tail
    assert isinstance(big, ComplexTail) and isinstance(small, PlanarTail)
    assert not any(f.name in ("ifft", "grid_t")
                   for f in dataclasses.fields(big))
    assert not any(f.name == "grid" for f in dataclasses.fields(small))
    assert big.grid.shape == (5, 32768) and big.grid.dtype == torch.int64
    assert small.grid_t.shape == (7, 32, 128)


@pytest.mark.parametrize("name", NAMED_CONFIGS)
def test_every_named_config_runs(name):
    """Every config of the registry constructs and runs a step, on the
    tail ``select_step_iq`` picks for it: one frame (HIEFF: its smallest
    batch of whole packets)."""
    cfg = named_config(name)
    batch = (min_batch_frames(cfg) if cfg.input_mode == InputMode.HIEFF
             else 1)
    tx = Transmitter(cfg, batch, strict=False, device="cpu")
    step_fn, planar = tpipe.select_step_iq(cfg)
    assert planar == supported(cfg.fft_points, cfg.guard_samples)
    assert step_fn is (tpipe.transmit_step_iq_planar if planar
                       else tpipe.transmit_step_iq)
    assert isinstance(tx.tensors.tail, PlanarTail if planar else ComplexTail)
    streams = [synthetic_ts(n, seed=83 + i)
               for i, n in enumerate(tx.bytes_per_step_per_plp)]
    iq = tx(streams if len(streams) > 1 else streams[0])
    assert iq.dtype == np.complex64
    assert iq.shape == (batch, cfg.samples_per_frame)
    assert np.isfinite(iq).all() and np.abs(iq).max() > 0
