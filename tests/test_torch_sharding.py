"""The port's multi-device layer on a pool of CPU slots: every case of
tests/test_sharding.py, bit-identical to the port's sequential
``Transmitter`` at equal per-call shapes (the CPU twins' BLAS sums may
change bits with the batch, so both sides run the same batch), plus
``halo_windows`` against the JAX one, blocks on their slot's device, the
JAX ``ShardedTransmitter`` above 120 dB with checkpoints moving both
ways (as dicts and through ``.npz`` files), the symbol-sharded back-end,
and the refusals, a checkpoint of another config among them."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from dvbt2ll_tpu.parallel import ShardedTransmitter as JaxSharded
from dvbt2ll_tpu.parallel import halo_windows as jax_halo_windows
from dvbt2ll_tpu.parallel import make_mesh as jax_make_mesh
from dvbt2ll_tpu_torch import (ShardedTransmitter, Transmitter, build_plan,
                               grids_symbol_sharded, halo_windows, make_mesh,
                               min_batch_frames, named_config, plan_tensors,
                               synthetic_ts, transmit_step_iq, vv009_config)
from dvbt2ll_tpu_torch.dryrun import phase_invariant_config
from tests.test_torch_multiplp import _mixed_plp_cfg
from tests.torch_compare import snr_db


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _drift(cfg, mesh, n_mux=1):
    return ShardedTransmitter(cfg, mesh, n_mux=n_mux, frames_per_shard=1,
                              allow_phase_drift=True, strict=False)


def _sequential(cfg, ts, n_steps, batch, **kw):
    """n_steps steps of ``batch`` frames through one port Transmitter."""
    kw = kw or dict(strict=False, allow_phase_drift=True)
    tx = Transmitter(cfg, batch, device="cpu", **kw)
    n = tx.bytes_per_step
    return np.concatenate([tx(ts[i * n:(i + 1) * n])
                           for i in range(n_steps)], axis=0)


def test_frame_sharded_equals_sequential():
    cfg = vv009_config()
    stx = _drift(cfg, make_mesh(["cpu"] * 8, mux=1))
    ts = synthetic_ts(stx.bytes_per_step_per_mux, seed=21)
    sharded = stx(ts[None, :])[0]            # (8 frames, samples)
    seq = _sequential(cfg, ts, 8, 1)
    assert sharded.shape == seq.shape
    assert np.array_equal(sharded, seq)      # bit-identical, not just close


def test_mux_and_frame_sharded_equals_sequential():
    cfg = vv009_config()
    stx = _drift(cfg, make_mesh(["cpu"] * 8, mux=2), n_mux=2)
    nbytes = stx.bytes_per_step_per_mux
    ts = np.stack([synthetic_ts(nbytes, seed=22),
                   synthetic_ts(nbytes, seed=23)])
    sharded = stx(ts)                        # (2, 4 frames, samples)
    for c in range(2):
        assert np.array_equal(sharded[c], _sequential(cfg, ts[c], 4, 1))


def test_frame_sharded_streaming_carry():
    """The halo carry holds across sharded steps too."""
    cfg = vv009_config()
    stx = _drift(cfg, make_mesh(["cpu"] * 4, mux=1))
    n = stx.bytes_per_step_per_mux
    ts = synthetic_ts(2 * n, seed=24)
    out = np.concatenate([stx(ts[None, :n])[0], stx(ts[None, n:])[0]])
    assert np.array_equal(out, _sequential(cfg, ts, 8, 1))


def test_phase_invariant_sharded_valid_stream():
    """The production sharded mode: no allow_phase_drift, strict plans,
    three steps over 4 slots, bit-identical to the strict sequential
    Transmitter at the same one frame a call (min_batch_frames == 1)."""
    cfg = phase_invariant_config()
    assert min_batch_frames(cfg) == 1
    stx = ShardedTransmitter(cfg, make_mesh(["cpu"] * 4, mux=1), n_mux=1,
                             frames_per_shard=1)
    n = stx.bytes_per_step_per_mux
    ts = synthetic_ts(3 * n, seed=40)
    sharded = np.concatenate(
        [stx(ts[None, i * n:(i + 1) * n])[0] for i in range(3)])
    seq = _sequential(cfg, ts, 12, 1, strict=True)
    assert sharded.shape == seq.shape
    assert np.array_equal(sharded, seq)


def test_phase_invariant_sharded_vv009_min_batch():
    """vv009 in the valid-stream sharded configuration (frames_per_shard
    = min_batch_frames = 47), 2 shards x 2 steps, against the strict
    sequential chain at 47 frames a call over 4 steps."""
    cfg = vv009_config()
    b = min_batch_frames(cfg)
    assert b == 47
    stx = ShardedTransmitter(cfg, make_mesh(["cpu"] * 2, mux=1), n_mux=1,
                             frames_per_shard=b)
    n = stx.bytes_per_step_per_mux
    ts = synthetic_ts(2 * n, seed=41)
    sharded = np.concatenate([stx(ts[None, :n])[0], stx(ts[None, n:])[0]])
    assert np.array_equal(sharded, _sequential(cfg, ts, 4, b, strict=True))
    assert stx.state_dict()["step_no"] == 2


def test_symbol_sharded_modulate_matches():
    """7 symbols over 8 slots (one slab all padding), bit-identical to
    the whole complex step."""
    cfg = vv009_config()
    plan = build_plan(cfg, 1, strict=False)
    assert cfg.num_symbols == 7
    fn = grids_symbol_sharded(plan, make_mesh(["cpu"] * 8, mux=1))
    ts = synthetic_ts(plan.ts_bytes_in, seed=25)
    padded = torch.from_numpy(np.concatenate([np.zeros(187, np.uint8), ts]))
    want = transmit_step_iq(plan_tensors(plan, "cpu", False), padded, 0)
    got = fn(padded, 0)
    assert got.shape == want.shape == (1, cfg.samples_per_frame, 2)
    assert torch.equal(got, want)


def test_multi_plp_sharded_equals_sequential():
    """Frame-sharding a multi-PLP mux: per-PLP halo windows."""
    cfg = _mixed_plp_cfg()
    stx = _drift(cfg, make_mesh(["cpu"] * 4, mux=1))
    nb = stx.bytes_per_step_per_mux_per_plp
    ts = [synthetic_ts(nb[0], seed=26)[None], synthetic_ts(nb[1], seed=27)[None]]
    sharded = stx(ts)[0]                       # (4 frames, samples)

    tx = Transmitter(cfg, 1, strict=False, allow_phase_drift=True,
                     device="cpu")
    per = tx.bytes_per_step_per_plp
    seq = np.concatenate([tx([ts[p][0, i * per[p]:(i + 1) * per[p]]
                              for p in range(2)]) for i in range(4)])
    assert np.array_equal(sharded, seq)


def test_sharded_checkpoint_resume(tmp_path):
    """Restoring state_dict reproduces the same output stream; the file
    helpers round-trip the same state ((mux, plp, 187) carries)."""
    cfg = vv009_config()
    mesh = make_mesh(["cpu"] * 4, mux=1)
    stx = _drift(cfg, mesh)
    n = stx.bytes_per_step_per_mux
    ts = synthetic_ts(3 * n, seed=30)
    stx(ts[None, :n])
    snap = stx.state_dict()
    a = stx(ts[None, n:2 * n])
    b = stx(ts[None, 2 * n:])

    stx2 = _drift(cfg, mesh)
    stx2.load_state(snap)
    assert np.array_equal(a, stx2(ts[None, n:2 * n]))
    assert np.array_equal(b, stx2(ts[None, 2 * n:]))

    p = str(tmp_path / "stx.npz")
    stx2.save(p)
    stx3 = _drift(cfg, mesh)
    stx3.restore(p)
    assert stx3.state_dict()["step_no"] == stx2.state_dict()["step_no"]
    assert np.array_equal(stx3.state_dict()["carries"],
                          stx2.state_dict()["carries"])


def test_sharded_fef_stream_matches_sequential():
    """FEF insertion under frame sharding equals the sequential stream()."""
    cfg = dataclasses.replace(vv009_config(), fef_length=4096,
                              fef_interval=2).validate()
    stx = _drift(cfg, make_mesh(["cpu"] * 4, mux=1))
    ts = synthetic_ts(stx.bytes_per_step_per_mux, seed=33)
    sharded = stx.stream(ts[None])[0]

    tx = Transmitter(cfg, 1, strict=False, allow_phase_drift=True,
                     device="cpu")
    n = tx.bytes_per_step
    seq = np.concatenate([tx.stream(ts[i * n:(i + 1) * n])
                          for i in range(4)])
    assert np.array_equal(sharded, seq)


def test_halo_windows_equal_the_jax_ones():
    rng = np.random.default_rng(5)
    ts = rng.integers(0, 256, (3, 4 * 500), dtype=np.uint8)
    carries = rng.integers(0, 256, (3, 187), dtype=np.uint8)
    got = halo_windows(ts, carries, 4)
    assert got.shape == (3, 4, 187 + 500)
    np.testing.assert_array_equal(got, jax_halo_windows(ts, carries, 4))


def test_blocks_stay_on_their_slot_device():
    """Every block comes back on its slot's device, and a device that
    fills several slots holds the plan's constants once."""
    mesh = make_mesh(["cpu"] * 4, mux=2)
    stx = _drift(vv009_config(), mesh, n_mux=4)
    assert mesh.shape == {"mux": 2, "frame": 2} and stx.mux_per_shard == 2
    assert list(stx.tensors) == [torch.device("cpu")]
    ts = np.stack([synthetic_ts(stx.bytes_per_step_per_mux, seed=90 + c)
                   for c in range(4)])
    out = stx.step_device(ts)
    assert len(out) == 4 and all(len(row) == 2 for row in out)
    for c, row in enumerate(out):
        for s, o in enumerate(row):
            assert o.device == mesh.devices[c // 2, s]
            assert o.shape == (1, stx.cfg.samples_per_frame, 2)
            assert o.dtype == torch.float32


def test_matches_the_jax_sharded_transmitter():
    """One mux-2 x frame-2 vv009 step against the JAX ShardedTransmitter
    on the CPU mesh (its complex tail; the port's planar one): above 120
    dB, state equal, and each side's checkpoint resumes the other bit for
    bit."""
    cfg = vv009_config()
    cpu = jax.devices("cpu")
    jx = JaxSharded(cfg, jax_make_mesh(cpu[:4], mux=2), n_mux=2,
                    frames_per_shard=1, allow_phase_drift=True, strict=False)
    port = _drift(cfg, make_mesh(["cpu"] * 4, mux=2), n_mux=2)
    n = port.bytes_per_step_per_mux
    assert n == jx.bytes_per_step_per_mux
    ts1, ts2 = (np.stack([synthetic_ts(n, seed=s + c) for c in range(2)])
                for s in (60, 70))
    want, got = jx(ts1), port(ts1)
    assert got.shape == want.shape and got.dtype == np.complex64
    snr = snr_db(want, got)
    assert snr > 120, f"{snr:.1f} dB"
    s_jax, s_port = jx.state_dict(), port.state_dict()
    assert set(s_port) == set(s_jax) | {"cfg"}   # the JAX side has no cfg
    assert s_port["cfg"] == cfg.to_json()
    np.testing.assert_array_equal(s_port["carries"], s_jax["carries"])
    assert s_port["step_no"] == s_jax["step_no"] == 1

    j2, p2 = jx(ts2), port(ts2)
    jx.load_state(s_port)
    port.load_state(s_jax)
    assert np.array_equal(jx(ts2), j2)
    assert np.array_equal(port(ts2), p2)


def test_refusals():
    cfg = vv009_config()
    mesh = make_mesh(["cpu"] * 2, mux=1)
    with pytest.raises(ValueError, match="phase-invariant"):
        ShardedTransmitter(cfg, mesh, frames_per_shard=1, strict=False)
    with pytest.raises(ValueError, match="n_mux"):
        _drift(cfg, make_mesh(["cpu"] * 2, mux=2), n_mux=3)
    single = ShardedTransmitter(cfg, make_mesh(["cpu"], mux=1),
                                frames_per_shard=1, strict=False)
    ts = synthetic_ts(single.bytes_per_step_per_mux, seed=3)[None]
    with pytest.raises(ValueError, match="shape"):
        single(ts[:, :-1])
    single(ts)
    with pytest.raises(RuntimeError, match="single-shot"):
        single(ts)  # 1 frame is not a whole number of TS packets
    with pytest.raises(ValueError, match="carries"):
        single.load_state({"carries": np.zeros((2, 1, 187), np.uint8),
                           "step_no": 0})


def test_checkpoint_of_another_config_is_refused(tmp_path):
    """``cfg`` names the config a checkpoint was made with: another
    config's is refused (naming the fields that differ) and changes
    nothing, through a dict and through a ``.npz``; without ``cfg`` (the
    JAX package's checkpoints) the carries' shape and the step count are
    checked."""
    mesh = make_mesh(["cpu"], mux=1)
    vv = _drift(vv009_config(), mesh)
    lite = _drift(named_config("t2lite_4k"), mesh)
    vv(synthetic_ts(vv.bytes_per_step_per_mux, seed=4)[None])
    before = lite.state_dict()
    with pytest.raises(ValueError, match=r"another config.*'preamble'"):
        lite.load_state(vv.state_dict())
    p = str(tmp_path / "vv.npz")
    vv.save(p)
    with pytest.raises(ValueError, match="another config"):
        lite.restore(p)
    after = lite.state_dict()
    np.testing.assert_array_equal(after["carries"], before["carries"])
    assert (after["step_no"], after["cfg"]) == (before["step_no"],
                                                before["cfg"])
    lite.load_state({k: v for k, v in vv.state_dict().items() if k != "cfg"})
    np.testing.assert_array_equal(lite.state_dict()["carries"],
                                  vv.state_dict()["carries"])
    with pytest.raises(ValueError, match="step_no"):
        lite.load_state({"carries": before["carries"], "step_no": 1.5})


def test_checkpoints_move_both_ways_through_npz(tmp_path):
    """The port's ``.npz`` (with ``cfg``) restores into the JAX
    ``ShardedTransmitter``, and the JAX one's (without) into the port."""
    cfg = vv009_config()
    port = _drift(cfg, make_mesh(["cpu"] * 2, mux=1))
    port(synthetic_ts(port.bytes_per_step_per_mux, seed=6)[None])
    jx = JaxSharded(cfg, jax_make_mesh(jax.devices("cpu")[:2], mux=1),
                    n_mux=1, frames_per_shard=1, allow_phase_drift=True,
                    strict=False)
    p_port, p_jax = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    port.save(p_port)
    jx.restore(p_port)
    np.testing.assert_array_equal(jx.state_dict()["carries"],
                                  port.state_dict()["carries"])
    assert jx.state_dict()["step_no"] == 1
    jx.save(p_jax)
    back = _drift(cfg, make_mesh(["cpu"] * 2, mux=1))
    back.restore(p_jax)
    np.testing.assert_array_equal(back.state_dict()["carries"],
                                  port.state_dict()["carries"])
    assert back.state_dict()["step_no"] == 1


def test_make_mesh():
    mesh = make_mesh(["cpu"] * 6, mux=3)
    assert mesh.shape == {"mux": 3, "frame": 2}
    assert mesh.devices.shape == (3, 2) and mesh.world == 1
    assert mesh.local_devices() == [torch.device("cpu")]
    with pytest.raises(ValueError, match="mux"):
        make_mesh(["cpu"] * 6, mux=4, frame=2)
    with pytest.raises(ValueError):
        make_mesh([], mux=1)


def test_make_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh(["cuda"] * 2)
