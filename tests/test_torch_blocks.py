"""The block axis of the port's step functions on the CPU: one call on a
(blocks, 187 + fresh bytes) window a PLP and a (blocks,) frame index,
the counterpart of ``jax.vmap(one_mux)`` in the JAX ``ShardedTransmitter``'s
``shard_fn`` (``dvbt2ll_tpu/parallel/sharding.py``), returns (blocks, B,
samples, 2), row i bit-identical to the one-block call on row i.  Inside,
the blocks' frames are one batch, so each kernel would launch once.

The cases reach every branch of ``bb_and_fec`` that a config reaches:
the sync-slot path at offset 0 (vv009, the planar tail; multiplp_fef, two
PLPs and FEF; t2lite_8k_t2gi_miso, the complex tail) and at a nonzero
offset (a streaming step of ``chip_smoke.MATRIX``'s ``normal_drift`` and
``inband_stream`` cases), HIEFF and in-band.  No config reaches the
branch without a sync slot (``n_packets == 0``): a step carries at least
one data field of 374 bytes or more, so every window holds a sync slot.

Then the port's ``ShardedTransmitter`` against the JAX one whose
``shard_fn`` vmaps two muxes a device, above 120 dB a mux (the JAX
package's bar between two formulations of the same float32 math), over
t2_frames + 1 steps with a checkpoint round trip."""
import jax
import numpy as np
import pytest
import torch

import chip_smoke
from dvbt2ll_tpu.parallel import ShardedTransmitter as JaxSharded
from dvbt2ll_tpu.parallel import make_mesh as jax_make_mesh
from dvbt2ll_tpu_torch import (ShardedTransmitter, Transmitter, build_plan,
                               make_mesh, named_config, synthetic_ts,
                               vv009_config)
from dvbt2ll_tpu_torch.pipeline import bb_and_fec, select_step_iq
from tests.torch_compare import snr_db

_DRIFT = dict(strict=False, allow_phase_drift=True)
_MATRIX = {c["id"]: c for c in chip_smoke.MATRIX}


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _named(name, batch):
    return named_config(name), batch, 0


def _matrix(case_id, steps_in=0):
    """A MATRIX case's config at its test batch, at the TS phase its
    streaming run reaches after ``steps_in`` steps."""
    case = _MATRIX[case_id]
    cfg = chip_smoke.matrix_config(case)
    phase = 0
    for _ in range(steps_in):
        phase = build_plan(cfg, case["batch"], strict=False,
                           start_phases=phase).plps[0].bb.next_phase
    return cfg, case["batch"], phase


# (id, (config, batch, start phase), the bb_and_fec branch it reaches)
_CASES = {
    "vv009_4kshort": (lambda: _named("vv009_4kshort", 3), "sync, offset 0"),
    "multiplp_fef": (lambda: _named("multiplp_fef", 1), "sync, offset 0"),
    "t2lite_8k_t2gi_miso": (lambda: _named("t2lite_8k_t2gi_miso", 1),
                            "sync, offset 0"),
    "hieff": (lambda: _matrix("hieff"), "HIEFF"),
    "inband": (lambda: _matrix("inband"), "in-band"),
    "normal_drift_step1": (lambda: _matrix("normal_drift", 1),
                           "sync, nonzero offset"),
    "inband_stream_step1": (lambda: _matrix("inband_stream", 1),
                            "in-band, nonzero offset"),
}


def _rows(tx, blocks, seed):
    """``blocks`` independent pre-carried windows a PLP, stacked."""
    return [torch.from_numpy(np.stack([
        synthetic_ts(187 + n, seed=seed + 100 * p + i)
        for i in range(blocks)]))
        for p, n in enumerate(tx.bytes_per_step_per_plp)]


def _one(ws):
    return ws if len(ws) > 1 else ws[0]


@pytest.mark.parametrize("blocks", [1, 2, 3, 8])
@pytest.mark.parametrize("case", list(_CASES))
def test_batched_call_equals_one_block_calls(case, blocks):
    """One call over ``blocks`` stacked windows against ``blocks``
    one-block calls, bit for bit: the FEC bits of each PLP, block after
    block, and the step's I/Q, row i against the call on row i with
    block i's frame index (block i starts i * B frames into a stream,
    so at an odd batch the index alternates)."""
    make, branch = _CASES[case]
    cfg, batch, phase = make()
    tx = Transmitter(cfg, batch, start_phases=phase, device="cpu", **_DRIFT)
    bb = tx.plan.plps[0].bb
    assert tx.plan.plps[0].n_packets > 0 and bb.hieff == (branch == "HIEFF")
    assert bb.inband == branch.startswith("in-band")
    assert (bb.sync_offset != 0) == branch.endswith("nonzero offset")
    ws = _rows(tx, blocks, seed=blocks)
    t2 = cfg.t2_frames
    idx = [i * batch % t2 for i in range(blocks)]

    for pt, w in zip(tx.tensors.plps, ws):
        got = bb_and_fec(pt, w)
        assert got.shape == (blocks * pt.pp.fec_frames,
                             pt.ldpc.nbch + pt.ldpc.plen)
        want = torch.cat([bb_and_fec(pt, w[i]) for i in range(blocks)])
        assert torch.equal(got, want)

    step_fn = select_step_iq(cfg)[0]
    assert step_fn is tx._step_fn
    out = step_fn(tx.tensors, _one(ws), torch.tensor(idx))
    assert out.shape == (blocks, batch, cfg.samples_per_frame, 2)
    for i in range(blocks):
        want = step_fn(tx.tensors, _one([w[i] for w in ws]), idx[i])
        assert torch.equal(out[i], want), (i, idx[i])


def test_one_block_contract_is_unchanged():
    """A 1-D window and an int or 0-d index still give (B, samples, 2),
    equal to row 0 of the same window stacked as one block."""
    tx = Transmitter(vv009_config(), 3, device="cpu", **_DRIFT)
    (w,) = _rows(tx, 1, seed=7)
    for idx in (1, torch.tensor(1)):
        one = tx._step_fn(tx.tensors, w[0], idx)
        assert one.shape == (3, tx.cfg.samples_per_frame, 2)
        stacked = tx._step_fn(tx.tensors, w, torch.tensor([1]))
        assert torch.equal(stacked[0], one)


def test_matches_the_jax_vmap_in_shard_fn(tmp_path):
    """vv009, 4 muxes over a (mux 2, frame 1) mesh at 3 frames a block: on
    the JAX side ``shard_fn`` vmaps 2 muxes a device; on the port's, the
    two CPU slots are one device, one call over 4 blocks.  Every mux above
    120 dB against the JAX one for t2_frames + 1 steps (3 frames: the
    frame index alternates); after the first step the port's checkpoint
    goes through an ``.npz`` into a new port transmitter and into the
    JAX one, and both go on from it."""
    cfg = vv009_config()
    jx = JaxSharded(cfg, jax_make_mesh(jax.devices("cpu")[:2], mux=2),
                    n_mux=4, frames_per_shard=3, **_DRIFT)
    assert jx.mux_per_shard == 2

    def port_tx():
        return ShardedTransmitter(cfg, make_mesh(["cpu"] * 2, mux=2),
                                  n_mux=4, frames_per_shard=3, **_DRIFT)

    port = port_tx()
    (step,) = port._steps.values()
    assert port.mux_per_shard == 2 and step.blocks == 4
    n = port.bytes_per_step_per_mux
    assert n == jx.bytes_per_step_per_mux
    for k in range(cfg.t2_frames + 1):
        ts = np.stack([synthetic_ts(n, seed=130 + 4 * k + c)
                       for c in range(4)])
        want, got = jx(ts), port(ts)
        assert got.shape == want.shape == (4, 3, cfg.samples_per_frame)
        for c in range(4):
            snr = snr_db(want[c], got[c])
            assert snr > 120, f"step {k} mux {c}: {snr:.1f} dB"
        s_port, s_jax = port.state_dict(), jx.state_dict()
        np.testing.assert_array_equal(s_port["carries"], s_jax["carries"])
        assert s_port["step_no"] == s_jax["step_no"]
        if k == 0:
            path = str(tmp_path / "port.npz")
            port.save(path)
            port = port_tx()
            port.restore(path)
            jx.restore(path)
            assert port.state_dict()["step_no"] == 1
