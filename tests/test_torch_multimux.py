"""The port's heterogeneous multi-mux on a pool of CPU slots: the cases of
tests/test_multimux.py, each channel bit-identical to its standalone port
``ShardedTransmitter``, plus the refusal of a checkpoint whose channels
are not the transmitter's (missing, extra, or saved in another order), a
refused checkpoint changing nothing, and checkpoints moving both ways
with the JAX ``MultiMuxTransmitter`` through ``.npz`` files."""
import numpy as np
import pytest
import torch

from dvbt2ll_tpu_torch import (MultiMuxTransmitter, MuxChannel,
                               ShardedTransmitter, make_mesh, named_config,
                               synthetic_ts, vv009_config)
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
    assert sorted(mm2.state_dict()) == ["ch0_carries", "ch0_cfg",
                                        "ch0_step_no", "ch1_carries",
                                        "ch1_cfg", "ch1_step_no"]


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


def _named_pair(names):
    """vv009_4kshort and t2lite_4k channels, one frame a shard in drift
    mode: their carries are (1, 1, 187) alike, so only ``ch{i}_cfg`` tells
    the channels apart."""
    drift = dict(frames_per_shard=1, strict=False, allow_phase_drift=True)
    return MultiMuxTransmitter([MuxChannel(named_config(n), **drift)
                                for n in names], devices=CPU[:4])


def _stepped_pair(names, seed):
    mm = _named_pair(names)
    mm.step_device([synthetic_ts(n, seed=seed + i)[None]
                    for i, n in enumerate(mm.bytes_per_step)])
    return mm


def _same_state(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


_PAIR = ["vv009_4kshort", "t2lite_4k"]


def test_reordered_checkpoint_is_refused():
    """A checkpoint of [vv009_4kshort, t2lite_4k] loaded into a
    transmitter of [t2lite_4k, vv009_4kshort]: every key and shape fits,
    but channel 0's ``cfg`` is another config's, so it is refused and
    nothing is loaded; the same channels in their own order load."""
    saved = _stepped_pair(_PAIR, seed=100).state_dict()
    other = _named_pair(_PAIR[::-1])
    before = other.state_dict()
    with pytest.raises(ValueError, match="channel 0: checkpoint of another "
                                         "config"):
        other.load_state(saved)
    _same_state(other.state_dict(), before)
    same = _named_pair(_PAIR)
    same.load_state(saved)
    _same_state(same.state_dict(), saved)


@pytest.mark.parametrize("key,bad", [
    ("ch1_carries", np.zeros((2, 1, 187), np.uint8)),
    ("ch1_step_no", np.float32(1.5)),
    ("ch1_cfg", vv009_config().to_json()),
], ids=["carries", "step_no", "cfg"])
def test_refused_checkpoint_changes_nothing(key, bad):
    """A checkpoint whose second channel is refused leaves the first
    channel, and every other part of ``state_dict()``, as it was."""
    mm = _stepped_pair(_PAIR, seed=110)
    before = mm.state_dict()
    ckpt = dict(_stepped_pair(_PAIR, seed=120).state_dict(), **{key: bad})
    assert not np.array_equal(ckpt["ch0_carries"], before["ch0_carries"])
    with pytest.raises(ValueError, match="channel 1"):
        mm.load_state(ckpt)
    _same_state(mm.state_dict(), before)


def _jax_pair(names):
    import jax

    from dvbt2ll_tpu.config import T2Config as JaxT2Config
    from dvbt2ll_tpu.parallel import MultiMuxTransmitter as JaxMultiMux
    from dvbt2ll_tpu.parallel import MuxChannel as JaxMuxChannel
    drift = dict(frames_per_shard=1, strict=False, allow_phase_drift=True)
    return JaxMultiMux([JaxMuxChannel(JaxT2Config.from_json(
        named_config(n).to_json()), **drift) for n in names],
        devices=jax.devices("cpu")[:4])


def test_jax_checkpoint_without_cfg_loads(tmp_path):
    """The JAX package writes no ``ch{i}_cfg``: its checkpoint, through a
    ``.npz``, still loads, and the port then steps on as the transmitter
    that made the state."""
    port = _stepped_pair(_PAIR, seed=130)
    jx = _jax_pair(_PAIR)
    jx.load_state({k: v for k, v in port.state_dict().items()
                   if not k.endswith("_cfg")})
    p = str(tmp_path / "jax.npz")
    jx.save(p)
    with np.load(p) as z:
        assert not any(k.endswith("_cfg") for k in z.files)
    resumed = _named_pair(_PAIR)
    resumed.restore(p)
    ts = [synthetic_ts(n, seed=140 + i)[None]
          for i, n in enumerate(port.bytes_per_step)]
    for a, b in zip(port(ts), resumed(ts)):
        assert np.array_equal(a, b)


def test_port_checkpoint_restores_into_jax(tmp_path):
    """A port checkpoint, ``ch{i}_cfg`` included, restores into the JAX
    ``MultiMuxTransmitter`` through a ``.npz``: it reads the carries and
    step counts and ignores the config."""
    port = _stepped_pair(_PAIR, seed=150)
    p = str(tmp_path / "port.npz")
    port.save(p)
    with np.load(p) as z:
        assert {"ch0_cfg", "ch1_cfg"} <= set(z.files)
    jx = _jax_pair(_PAIR)
    jx.restore(p)
    want = {k: v for k, v in port.state_dict().items()
            if not k.endswith("_cfg")}
    _same_state(jx.state_dict(), want)
