"""The port's heterogeneous multi-mux on a pool of CPU slots: the cases of
tests/test_multimux.py, each channel bit-identical to its standalone port
``ShardedTransmitter``, plus the refusal of a checkpoint whose channels
are not the transmitter's."""
import numpy as np
import pytest
import torch

from dvbt2ll_tpu_torch import (MultiMuxTransmitter, MuxChannel,
                               ShardedTransmitter, make_mesh, synthetic_ts,
                               vv009_config)
from dvbt2ll_tpu_torch.dryrun import phase_invariant_config
from tests.test_torch_multiplp import _mixed_plp_cfg

CPU = ["cpu"] * 6


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _drift(cfg, slots, n_mux=1):
    return ShardedTransmitter(cfg, make_mesh(CPU[:slots], mux=n_mux),
                              n_mux=n_mux, frames_per_shard=1,
                              strict=False, allow_phase_drift=True)


def test_hetero_channels_bit_identical():
    """vv009 (4K short, drift mode) + a HIEFF 17-block config (strict,
    phase-invariant) side by side; each equals its standalone run."""
    cfg_a, cfg_b = vv009_config(), phase_invariant_config()
    mm = MultiMuxTransmitter([
        MuxChannel(cfg_a, n_mux=1, frames_per_shard=1, strict=False,
                   allow_phase_drift=True),
        MuxChannel(cfg_b, n_mux=1, frames_per_shard=1),
    ], devices=CPU[:4])
    na, nb = mm.bytes_per_step
    ts_a = synthetic_ts(na, seed=50)
    ts_b = synthetic_ts(nb, seed=51)
    out_a, out_b = mm([ts_a[None], ts_b[None]])

    ref_a = _drift(cfg_a, 2)(ts_a[None])
    ref_b = ShardedTransmitter(cfg_b, make_mesh(CPU[:2], mux=1), n_mux=1,
                               frames_per_shard=1)(ts_b[None])
    assert np.array_equal(out_a, ref_a)
    assert np.array_equal(out_b, ref_b)


def test_shared_config_group_and_pinned_devices():
    """A 2-mux shared-config group next to a pinned single-mux channel;
    two streaming steps with per-channel carries."""
    cfg = phase_invariant_config()
    mm = MultiMuxTransmitter([
        MuxChannel(cfg, n_mux=2, n_devices=4, frames_per_shard=1),
        MuxChannel(cfg, n_mux=1, frames_per_shard=1),
    ], devices=CPU)
    assert mm.channels[1].n_devices == 2
    (n2, n1) = mm.bytes_per_step
    ts = [np.stack([synthetic_ts(2 * n2, seed=60 + m) for m in range(2)]),
          synthetic_ts(2 * n1, seed=62)[None]]
    step1 = mm.step_device([ts[0][:, :n2], ts[1][:, :n1]])
    step2 = mm.step_device([ts[0][:, n2:], ts[1][:, n1:]])

    ref = ShardedTransmitter(cfg, make_mesh(CPU[:2], mux=1), n_mux=1,
                             frames_per_shard=1)
    stx = mm.transmitters[0]
    for m in range(2):  # each mux of the group == its own sequential run
        ref.load_state({"carries": np.zeros((1, 1, 187), np.uint8),
                        "step_no": 0})
        r1 = ref(ts[0][m, :n2][None])
        r2 = ref(ts[0][m, n2:][None])
        for step, r in ((step1, r1), (step2, r2)):
            one = stx.gather(step[0])[m].reshape(1, ref.frames_per_step, -1)
            assert np.array_equal(one, r)


def test_hetero_with_multi_plp_channel():
    """A multi-PLP mux next to a single-PLP mux: the multi-PLP group takes
    a per-PLP sequence; outputs equal the standalone runs."""
    cfg_a, cfg_b = _mixed_plp_cfg(), vv009_config()
    mm = MultiMuxTransmitter([
        MuxChannel(cfg_a, frames_per_shard=1, strict=False,
                   allow_phase_drift=True),
        MuxChannel(cfg_b, frames_per_shard=1, strict=False,
                   allow_phase_drift=True),
    ], devices=CPU[:4])
    per_a = mm.bytes_per_step[0]
    assert isinstance(per_a, tuple) and len(per_a) == 2
    ts_a = [synthetic_ts(per_a[0], seed=80)[None],
            synthetic_ts(per_a[1], seed=81)[None]]
    ts_b = synthetic_ts(mm.bytes_per_step[1], seed=82)[None]
    out_a, out_b = mm([ts_a, ts_b])
    assert np.array_equal(out_a, _drift(cfg_a, 2)(ts_a))
    assert np.array_equal(out_b, _drift(cfg_b, 2)(ts_b))


def test_pool_partition_errors():
    cfg = vv009_config()
    drift = dict(strict=False, allow_phase_drift=True)
    with pytest.raises(ValueError, match="split evenly"):
        MultiMuxTransmitter([MuxChannel(cfg, **drift)] * 2, devices=CPU[:3])
    with pytest.raises(ValueError, match="multiple"):
        MultiMuxTransmitter([MuxChannel(cfg, n_mux=3, n_devices=4, **drift)],
                            devices=CPU[:4])
    with pytest.raises(ValueError, match="> pool"):
        MultiMuxTransmitter([MuxChannel(cfg, n_devices=5, **drift)],
                            devices=CPU[:4])
    with pytest.raises(ValueError, match="slice the pool"):
        MultiMuxTransmitter([MuxChannel(cfg, n_devices=2, **drift)],
                            devices=CPU[:4])
    with pytest.raises(ValueError, match="at least one"):
        MultiMuxTransmitter([], devices=CPU[:4])


def test_checkpoint_roundtrip(tmp_path):
    cfg = phase_invariant_config()
    spec = MuxChannel(cfg, frames_per_shard=1)
    mm = MultiMuxTransmitter([spec] * 2, devices=CPU[:4])
    (na, nb) = mm.bytes_per_step
    ts1 = [synthetic_ts(na, seed=70)[None], synthetic_ts(nb, seed=71)[None]]
    ts2 = [synthetic_ts(na, seed=72)[None], synthetic_ts(nb, seed=73)[None]]
    mm(ts1)
    p = str(tmp_path / "mm.npz")
    mm.save(p)
    out = mm(ts2)

    mm2 = MultiMuxTransmitter([spec] * 2, devices=CPU[:4])
    mm2.restore(p)
    for a, b in zip(out, mm2(ts2)):
        assert np.array_equal(a, b)
    assert sorted(mm2.state_dict()) == ["ch0_carries", "ch0_step_no",
                                        "ch1_carries", "ch1_step_no"]


def test_checkpoint_with_other_channels_is_refused():
    """The keys do not record the channel count: a checkpoint with a
    channel missing, one too many, or keys of no channel is refused."""
    cfg = phase_invariant_config()
    spec = MuxChannel(cfg, frames_per_shard=1)
    two = MultiMuxTransmitter([spec] * 2, devices=CPU[:4])
    three = MultiMuxTransmitter([spec] * 3, devices=CPU[:6])
    with pytest.raises(ValueError, match=r"channels \[0, 1\]"):
        three.load_state(two.state_dict())
    with pytest.raises(ValueError, match=r"channels \[0, 1, 2\]"):
        two.load_state(three.state_dict())
    with pytest.raises(ValueError, match="not a channel"):
        two.load_state(two.transmitters[0].state_dict())
    before = two.state_dict()
    two.load_state(before)  # its own checkpoint loads
    assert sorted(two.state_dict()) == sorted(before)
