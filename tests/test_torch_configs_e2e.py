"""The JAX package's config matrix on the port: every case of
``chip_smoke.MATRIX`` (one per config that tests/test_configs_e2e.py and
tests/test_modes.py run) through the port on the CPU, held to the JAX
package's own bars:

- plan: the port's plan equals the JAX package's, field by field;
- FEC bits: ``bb_and_fec`` equals the JAX ``bb_and_fec`` and
  ``refmodel.ldpc_encode(refmodel.bbheader_frames(...))``, bit for bit
  (for the streaming cases at every step);
- IQ: the port's ``Transmitter`` above 100 dB SNR against
  ``refmodel.transmit_chain`` (the JAX package's bar against its oracle)
  and above 120 dB against the JAX ``Transmitter`` on the same TS (two
  formulations of the same float32 math);
- every "differs" assertion of the JAX test, on the port's outputs.

torch runs at 2 threads: MKL's 32K FFT bits change with the batch when it
is smaller than the thread count (ROADMAP section C).
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dvbt2ll_tpu import config as jax_config
from dvbt2ll_tpu import pipeline as jax_pipeline
from dvbt2ll_tpu import refmodel
from dvbt2ll_tpu.pipeline import Transmitter as JaxTransmitter
from dvbt2ll_tpu.plan import build_plan as jax_build_plan
from dvbt2ll_tpu.tables.pilots import inverse_sinc as jax_inverse_sinc
from dvbt2ll_tpu_torch import (Transmitter, bb_and_fec, build_plan,
                               min_batch_frames, plan_tensors, synthetic_ts,
                               vv009_config)
from dvbt2ll_tpu_torch.config import (PAPR, Bandwidth, MisoGroup, Preamble,
                                      Version)
from dvbt2ll_tpu_torch.pipeline import select_step_iq
from dvbt2ll_tpu_torch.tables.pilots import (_INVERT_BIT, P2PILOT,
                                             _p2_carrier_map, inverse_sinc)
from tests.torch_compare import same, snr_db

_E2E, _MODES = "tests/test_configs_e2e.py", "tests/test_modes.py"
# the JAX test each case mirrors, by file:line, kept here apart from
# chip_smoke.MATRIX so that a case added to or dropped from either shows
_MIRRORS = {
    "8k_normal_pp3": f"{_E2E}:23", "32k_extended": f"{_E2E}:34",
    "16k_extended_16qam": f"{_E2E}:47", "2k_qpsk": f"{_E2E}:58",
    "1k_qpsk": f"{_E2E}:197", "vv009_eq": f"{_E2E}:68",
    "vv009_eq_bw0": f"{_E2E}:376", "vv009_eq_bw3": f"{_E2E}:376",
    "vv009_eq_bw5": f"{_E2E}:376", "miso_2k_tx1": f"{_E2E}:81",
    "miso_2k_tx2": f"{_E2E}:81", "miso_ext_8k_tx1": f"{_E2E}:115",
    "miso_ext_16k_tx2": f"{_E2E}:115", "miso_ext_32k_tx1": f"{_E2E}:115",
    "miso_ext_32k_tx2": f"{_E2E}:115", "miso_tr_8k_ext": f"{_E2E}:138",
    "papr_both": f"{_E2E}:163", "papr_tr_8k_ext": f"{_E2E}:182",
    "papr_tr": f"{_E2E}:208", "papr_ace": f"{_E2E}:342",
    "l1_qpsk": f"{_E2E}:222", "l1_qam16": f"{_E2E}:222",
    "l1_qam64": f"{_E2E}:222", "v131_l1_scrambled": f"{_E2E}:237",
    "v131_reserved_bias": f"{_E2E}:328",
    "t2gi_8k_19_128_pp8": f"{_E2E}:253",
    "t2gi_32k_19_256_pp8": f"{_E2E}:253",
    "t2gi_32k_1_128_pp7": f"{_E2E}:253", "ti_off_vv009": f"{_E2E}:271",
    "ti_off_8k_normal": f"{_E2E}:290", "t2lite_siso": f"{_E2E}:302",
    "t2lite_miso": f"{_E2E}:302", "vv009_fef": f"{_E2E}:357",
    "hieff": f"{_MODES}:36,50", "inband": f"{_MODES}:59,73",
    "inband_hieff": f"{_MODES}:82", "inband_stream": f"{_MODES}:96",
    "normal_drift": f"{_MODES}:123",
}
# JAX tests whose configs the cases above already run, mirrored by a
# test of this file
_ALSO = {f"{_E2E}:97": "test_miso_groups_differ",
         f"{_E2E}:387": "test_inverse_sinc_bandwidth_invariance"}

_BY_ID = {c["id"]: c for c in chip_smoke.MATRIX}
_ONE_STEP = [c["id"] for c in chip_smoke.MATRIX if c["steps"] == 1]
_STREAMING = [c["id"] for c in chip_smoke.MATRIX if c["steps"] > 1]


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _configs(case):
    """The port's and the JAX package's T2Config of one case, from the
    same keyword dict."""
    return (chip_smoke.matrix_config(case),
            jax_config.T2Config.from_dict(case["kw"]).validate())


def _jax_fec(pp, window: np.ndarray) -> np.ndarray:
    return np.asarray(jax.jit(lambda x: jax_pipeline.bb_and_fec(pp, x))(
        jnp.asarray(window)))


def _oracle_fec(jcfg, ts: np.ndarray, fec_frames: int) -> np.ndarray:
    frames, _ = refmodel.bbheader_frames(jcfg, ts, fec_frames)
    return refmodel.ldpc_encode(jcfg, frames)


def _port_iq(cfg, batch, ts) -> np.ndarray:
    return Transmitter(cfg, batch, strict=False, device="cpu")(ts)


def test_matrix_is_the_jax_tests():
    """chip_smoke.MATRIX holds exactly the cases above, each mirrored
    line is where a JAX test starts, and every test of the two JAX files
    is mirrored by a case or by a test here."""
    assert {c["id"]: c["test"] for c in chip_smoke.MATRIX} == _MIRRORS
    assert len(chip_smoke.MATRIX) == len(_MIRRORS)
    mirrored = set(_ALSO)
    for ref in list(_MIRRORS.values()) + list(_ALSO):
        path, lines = ref.split(":")
        for line in lines.split(","):
            mirrored.add(f"{path}:{line}")
    starts = set()   # each test's first line: its decorator, or its def
    for path in (_E2E, _MODES):
        with open(path) as f:
            lines = f.read().splitlines()
        for i, text in enumerate(lines):
            if re.match(r"def test_", text):
                while i and lines[i - 1].strip():
                    i -= 1
                starts.add(f"{path}:{i + 1}")
    assert mirrored == starts
    assert all(callable(globals().get(name)) for name in _ALSO.values())


@pytest.fixture(scope="module", params=_ONE_STEP)
def case(request):
    """One step of one case: both packages' configs and plans, and the TS
    of the case's seed."""
    c = _BY_ID[request.param]
    cfg, jcfg = _configs(c)
    plan = build_plan(cfg, c["batch"], strict=False)
    jplan = jax_build_plan(jcfg, c["batch"], strict=False)
    ts = synthetic_ts(plan.ts_bytes_in, seed=c["seed"])
    return c, cfg, jcfg, plan, jplan, ts


def test_plan_equals_the_jax_packages(case):
    c, _, _, plan, jplan, _ = case
    same(plan, jplan, f"{c['id']} plan")


def test_fec_bits_equal_jax_and_oracle(case):
    """Bit for bit: the port's ``bb_and_fec``, the JAX one and the
    oracle, on the case's step with a zero carry."""
    c, cfg, jcfg, plan, jplan, ts = case
    window = np.concatenate([np.zeros(187, np.uint8), ts])
    _, planar = select_step_iq(cfg)
    pt = plan_tensors(plan, "cpu", planar).plps[0]
    got = bb_and_fec(pt, torch.from_numpy(window)).numpy()
    np.testing.assert_array_equal(got, _jax_fec(jplan.plps[0], window))
    np.testing.assert_array_equal(
        got, _oracle_fec(jcfg, ts, plan.plps[0].fec_frames))


def test_iq_matches_jax_and_oracle(case):
    """The port's ``Transmitter`` above 100 dB against
    ``refmodel.transmit_chain`` and above 120 dB against the JAX
    ``Transmitter``, on the same TS."""
    c, cfg, jcfg, _, _, ts = case
    got = _port_iq(cfg, c["batch"], ts)
    assert got.shape == (c["batch"], cfg.samples_per_frame)
    ref = refmodel.transmit_chain(jcfg, ts, c["batch"]).reshape(got.shape)
    snr = snr_db(ref, got)
    assert snr > 100, f"vs refmodel {snr:.1f} dB"
    want = JaxTransmitter(jcfg, c["batch"], strict=False)(ts)
    snr = snr_db(want, got)
    assert snr > 120, f"vs JAX {snr:.1f} dB"


@pytest.mark.parametrize("case_id", _STREAMING)
def test_streaming_per_step_plans(case_id):
    """tests/test_modes.py:96 and :123 on the port: one plan a step with
    ``start_phases`` = the previous plan's ``bb.next_phase``.  Every
    step's plan equals the JAX one and its FEC bits the JAX ones; all
    steps' bits together equal the continuous oracle.  The same steps
    through one ``Transmitter`` a step of each package, each resumed from
    the previous one's checkpoint: above 120 dB a step against JAX, and
    above 100 dB together against ``refmodel.transmit_chain``."""
    c = _BY_ID[case_id]
    cfg, jcfg = _configs(c)
    b, steps = c["batch"], c["steps"]
    n = build_plan(cfg, b, strict=False).ts_bytes_in
    ts = synthetic_ts(steps * n, seed=c["seed"])
    carry, phase = np.zeros(187, np.uint8), 0
    bits, iq = [], []
    tx = jtx = None
    drift = dict(strict=False, allow_phase_drift=True)
    for k in range(steps):
        plan = build_plan(cfg, b, strict=False, start_phases=phase)
        jplan = jax_build_plan(jcfg, b, strict=False, start_phases=phase)
        same(plan, jplan, f"{case_id} step {k} plan")
        bb = plan.plps[0].bb
        assert bb.start_phase == phase and bb.ts_bytes_in == n
        if k:
            assert not bb.phase_invariant
        fresh = ts[k * n:(k + 1) * n]
        window = np.concatenate([carry, fresh])
        got = bb_and_fec(plan_tensors(plan, "cpu", True).plps[0],
                         torch.from_numpy(window)).numpy()
        np.testing.assert_array_equal(got, _jax_fec(jplan.plps[0], window))
        bits.append(got)

        states = None if tx is None else (tx.state_dict(), jtx.state_dict())
        tx = Transmitter(cfg, b, start_phases=phase, device="cpu", **drift)
        jtx = JaxTransmitter(jcfg, b, start_phases=phase, **drift)
        if states:
            tx.load_state(states[0])
            jtx.load_state(states[1])
        iq.append(tx(fresh))
        snr = snr_db(jtx(fresh), iq[-1])
        assert snr > 120, f"step {k} vs JAX {snr:.1f} dB"
        carry, phase = window[-187:], bb.next_phase
    np.testing.assert_array_equal(
        np.concatenate(bits), _oracle_fec(jcfg, ts, steps * b
                                          * cfg.fec_blocks))
    ref = refmodel.transmit_chain(jcfg, ts, steps * b)
    snr = snr_db(ref, np.concatenate(iq))
    assert snr > 100, f"vs refmodel {snr:.1f} dB"


# ------------------------------------------------ the JAX tests' "differs"


def _iq(cfg, seed, batch=1) -> np.ndarray:
    tx = Transmitter(cfg, batch, strict=False, device="cpu")
    return tx(synthetic_ts(tx.bytes_per_step, seed=seed))


def _cfg(case_id):
    return chip_smoke.matrix_config(_BY_ID[case_id])


def test_equalized_output_differs():
    """tests/test_configs_e2e.py:68: inverse sinc changes the output."""
    cfg = _cfg("vv009_eq")
    plain = dataclasses.replace(cfg, equalization=False)
    assert not np.allclose(_iq(cfg, 41), _iq(plain, 41))


def test_inverse_sinc_bandwidth_invariance():
    """tests/test_configs_e2e.py:387: the table is the same for every
    bandwidth (fs cancels), and the JAX package's."""
    cfg = _cfg("vv009_eq")
    eqs = [inverse_sinc(dataclasses.replace(cfg, bandwidth=bw))
           for bw in Bandwidth]
    for bw, eq in zip(Bandwidth, eqs):
        np.testing.assert_array_equal(eq, eqs[0], err_msg=bw.name)
        jcfg = jax_config.T2Config.from_json(
            dataclasses.replace(cfg, bandwidth=bw).to_json())
        np.testing.assert_array_equal(eq, jax_inverse_sinc(jcfg))


def test_miso_groups_differ():
    """tests/test_configs_e2e.py:97: MISO TX1 and TX2 differ."""
    tx1, tx2 = _cfg("miso_2k_tx1"), _cfg("miso_2k_tx2")
    assert tx2 == dataclasses.replace(tx1, miso_group=MisoGroup.TX2)
    assert not np.allclose(_iq(tx1, 92), _iq(tx2, 92))


def test_miso_papr_extra_p2_pilots_fire():
    """tests/test_configs_e2e.py:138: some carrier is a P2 pilot in the
    MISO + TR map that is none in the SISO map."""
    cfg = _cfg("miso_tr_8k_ext")
    siso = dataclasses.replace(cfg, preamble=Preamble.T2_SISO).validate()
    m_miso = _p2_carrier_map(cfg) & ~np.int32(_INVERT_BIT)
    m_siso = _p2_carrier_map(siso)
    assert ((m_miso == P2PILOT) & (m_siso != P2PILOT)).sum() > 0


def test_papr_both_differs_from_tr():
    """tests/test_configs_e2e.py:163: BOTH reserves TR's tones and
    signals otherwise."""
    both = _cfg("papr_both")
    tr = dataclasses.replace(both, papr=PAPR.TR).validate()
    assert both.c_data == tr.c_data
    tx = Transmitter(both, 1, strict=False, device="cpu")
    ts = synthetic_ts(tx.bytes_per_step, seed=131)
    assert not np.allclose(tx(ts), _port_iq(tr, 1, ts))


def test_papr_tr_reserves_tones():
    """tests/test_configs_e2e.py:208."""
    assert _cfg("papr_tr").c_data < vv009_config().c_data


def test_papr_ace_signals_only():
    """tests/test_configs_e2e.py:342: no reserved tone, another L1."""
    ace = _cfg("papr_ace")
    assert ace.c_data == vv009_config().c_data
    tx = Transmitter(ace, 1, strict=False, device="cpu")
    ts = synthetic_ts(tx.bytes_per_step, seed=82)
    assert not np.allclose(tx(ts), _port_iq(vv009_config(), 1, ts))


@pytest.mark.parametrize("case_id,base", [
    ("v131_l1_scrambled", {}),                          # :237
    ("v131_reserved_bias", {"version": Version.V131}),  # :328
])
def test_v131_l1_options_differ(case_id, base):
    cfg = _cfg(case_id)
    plain = dataclasses.replace(vv009_config(), **base).validate()
    tx = Transmitter(cfg, 1, strict=False, device="cpu")
    ts = synthetic_ts(tx.bytes_per_step, seed=_BY_ID[case_id]["seed"])
    assert not np.allclose(tx(ts), _port_iq(plain, 1, ts))


def test_ti_off_differs():
    """tests/test_configs_e2e.py:271: TI off changes the waveform."""
    cfg = _cfg("ti_off_vv009")
    tx = Transmitter(cfg, 1, strict=False, device="cpu")
    ts = synthetic_ts(tx.bytes_per_step, seed=91)
    assert not np.allclose(tx(ts), _port_iq(vv009_config(), 1, ts))


@pytest.mark.parametrize("case_id", ["t2lite_siso", "t2lite_miso"])
def test_t2_lite_p1_differs(case_id):
    """tests/test_configs_e2e.py:302: a T2-Lite P1 is not a T2 P1."""
    a = _iq(_cfg(case_id), 71)
    b = _iq(vv009_config(), 71)
    assert not np.allclose(a[:, :2048], b[:, :2048])


def test_non_t2_refused_and_fef_p1_differs():
    """tests/test_configs_e2e.py:357: NON_T2 is no transmitter preamble,
    and the FEF part's P1 is not the frame's."""
    cfg = _cfg("vv009_fef")
    with pytest.raises(ValueError, match="NON_T2"):
        dataclasses.replace(vv009_config(),
                            preamble=Preamble.NON_T2).validate()
    tx = Transmitter(cfg, 1, strict=False, device="cpu")
    frame = tx(synthetic_ts(tx.bytes_per_step, seed=83))
    assert not np.allclose(tx.plan.fef_part[:2048], frame[0, :2048])


def test_hieff_and_inband_step_sizes():
    """tests/test_modes.py:36 and :59: HIEFF's smallest whole-packet
    batch and payload, in-band's 13 bytes short a T2-frame group."""
    hieff = _cfg("hieff")
    assert min_batch_frames(hieff) == 17
    assert build_plan(hieff, 17).ts_bytes_in == 17 * 869 + 79
    inband = _cfg("inband")
    assert (build_plan(inband, 2, strict=False).ts_bytes_in
            == 2 * (2 * 869 - 13))
    assert _BY_ID["inband_hieff"]["batch"] == min_batch_frames(
        _cfg("inband_hieff"))
