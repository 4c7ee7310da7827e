"""The port's ``Transmitter`` against the JAX package's: streaming steps,
checkpoints that move between the packages, plan conversion, the
refusals, and that the port never imports jax."""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbt2ll_tpu import pipeline as jpipe
from dvbt2ll_tpu.config import vv009_config as jax_vv009_config
from dvbt2ll_tpu.io import synthetic_ts
from dvbt2ll_tpu.pipeline import Transmitter as JaxTransmitter
from dvbt2ll_tpu.plan import build_plan as jax_build_plan
from dvbt2ll_tpu_torch import (Transmitter, build_plan, min_batch_frames,
                               named_config, plan_tensors, vv009_config)
from dvbt2ll_tpu_torch.config import FFTSize
from dvbt2ll_tpu_torch.ops.ifft import TailTables
from dvbt2ll_tpu_torch.ops.ldpc import LdpcSchedule
from dvbt2ll_tpu_torch.pipeline import select_step_iq

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


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


def _assert_same_state(a, b):
    np.testing.assert_array_equal(a["carries"], b["carries"])
    assert a["frame_idx"] == b["frame_idx"]
    assert a["steps_done"] == b["steps_done"]


@pytest.fixture(scope="module")
def jax_run():
    """Two steps of a phase-invariant (strict, min_batch_frames) vv009
    stream through the JAX Transmitter: the outputs and the state after
    each step."""
    cfg = jax_vv009_config()
    tx = JaxTransmitter(cfg, min_batch_frames(cfg), strict=True)
    ts = [synthetic_ts(tx.bytes_per_step, seed=40 + i) for i in range(2)]
    outs, states = [], []
    for t in ts:
        outs.append(tx(t))
        states.append(tx.state_dict())
    return ts, outs, states


def _port_tx():
    cfg = vv009_config()
    return Transmitter(cfg, min_batch_frames(cfg), strict=True,
                       device="cpu")


def test_two_streaming_steps_match_jax(jax_run):
    ts, outs, states = jax_run
    tx = _port_tx()
    for t, want, state in zip(ts, outs, states):
        got = tx(t)
        assert got.dtype == np.complex64 and got.shape == want.shape
        snr = _snr_db(want, got)
        assert snr > 120, f"{snr:.1f} dB"
        _assert_same_state(tx.state_dict(), state)
    assert tx.counters.steps == 2
    assert tx.counters.frames == 2 * tx.plan.batch_frames


def test_load_state_of_jax_checkpoint_resumes_bit_identically(jax_run):
    ts, outs, states = jax_run
    straight = _port_tx()
    straight(ts[0])
    want = straight.step_device(ts[1])
    resumed = _port_tx()
    resumed.load_state(states[0])
    got = resumed.step_device(ts[1])
    assert torch.equal(got, want)
    _assert_same_state(resumed.state_dict(), states[1])


def test_save_restore_round_trip(jax_run, tmp_path):
    ts = jax_run[0]
    tx = _port_tx()
    tx(ts[0])
    path = str(tmp_path / "ckpt.npz")
    tx.save(path)
    other = _port_tx()
    other.restore(path)
    _assert_same_state(other.state_dict(), tx.state_dict())
    assert torch.equal(other.step_device(ts[1]), tx.step_device(ts[1]))
    # a checkpoint without the step count (older JAX ones) still loads
    state = tx.state_dict()
    del state["steps_done"]
    other.load_state(state)
    assert other.state_dict()["steps_done"] == 1


def _assert_same_tensors(a, b):
    assert type(a) is type(b)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
        elif isinstance(x, (LdpcSchedule, TailTables)) or f.name == "tail":
            _assert_same_tensors(x, y)
        elif isinstance(x, tuple) and x and isinstance(x[0], torch.Tensor):
            assert all(torch.equal(u, v) for u, v in zip(x, y)), f.name
        elif f.name == "plps":
            for u, v in zip(x, y):
                _assert_same_tensors(u, v)
        elif x is None:
            assert y is None, f.name


@pytest.mark.parametrize("name", ["vv009_4kshort", "8k_normal",
                                  "32k_extended", "t2lite_8k_t2gi_miso"])
def test_plan_tensors_of_jax_plan_equal_the_ports(name):
    cfg = named_config(name)
    planar = select_step_iq(cfg)[1]
    ours = plan_tensors(build_plan(cfg, 2, strict=False), "cpu", planar)
    theirs = plan_tensors(jax_build_plan(cfg, 2, strict=False), "cpu",
                          planar)
    _assert_same_tensors(ours, theirs)


def test_refusals():
    cfg = vv009_config()
    tx = Transmitter(cfg, 1, strict=False, device="cpu")
    ts = synthetic_ts(tx.bytes_per_step, seed=3)
    with pytest.raises(ValueError):
        tx(ts[:-1])
    tx(ts)
    with pytest.raises(RuntimeError, match="single-shot"):
        tx(ts)  # 1 frame is not a whole number of TS packets
    drift = Transmitter(cfg, 1, strict=False, allow_phase_drift=True,
                        device="cpu")
    drift(ts)
    drift(ts)


def test_32k_strict_steps_match_jax_eager():
    """A 32K transmitter streams two strict steps (the carry between them
    included) equal to the JAX stage functions called eagerly on the same
    windows: above 120 dB, state equal to the JAX ``Transmitter``'s
    bookkeeping.  Short frames, one FEC block a frame, so the smallest
    streamable batch (47 frames) stays small."""
    cfg = dataclasses.replace(vv009_config(), fft_size=FFTSize.FFT_32K,
                              fec_blocks=1, ti_blocks=1).validate()
    b = min_batch_frames(cfg)
    tx = Transmitter(cfg, b, strict=True, device="cpu")
    assert not select_step_iq(cfg)[1]
    plan = jax_build_plan(cfg, b, strict=True)
    pp = plan.plps[0]
    carry = np.zeros(187, np.uint8)
    for step in range(2):
        ts = synthetic_ts(tx.bytes_per_step, seed=70 + step)
        window = jnp.asarray(np.concatenate([carry, ts]))
        cells = jpipe.map_cells(pp, jpipe.bb_and_fec(pp, window))
        grids = jpipe.build_frames(plan, cells.reshape(b, -1),
                                   jnp.int32(step * b % cfg.t2_frames))
        want = np.asarray(jpipe.modulate(plan, grids))
        got = tx(ts)
        assert got.shape == want.shape == (b, cfg.samples_per_frame)
        snr = _snr_db(want, got)
        assert snr > 120, f"step {step}: {snr:.1f} dB"
        carry = ts[-187:]
    state = tx.state_dict()
    np.testing.assert_array_equal(state["carries"][0], carry)
    assert state["frame_idx"] == 2 * b % cfg.t2_frames
    assert state["steps_done"] == 2


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Transmitter(vv009_config(), 1, strict=False, device="cuda")


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import dvbt2ll_tpu_torch as p\n"
        "import dvbt2ll_tpu_torch.ops._build, dvbt2ll_tpu_torch.ops.ifft\n"
        "import dvbt2ll_tpu_torch.executor\n"
        "import dvbt2ll_tpu_torch.apps.vv009_4kshort\n"
        "import dvbt2ll_tpu_torch.apps.multimux\n"
        "import dvbt2ll_tpu_torch.parallel, dvbt2ll_tpu_torch.dryrun\n"
        "stx = p.ShardedTransmitter(p.vv009_config(), p.make_mesh(['cpu'] "
        "* 2), frames_per_shard=1, strict=False, allow_phase_drift=True)\n"
        "stx(p.synthetic_ts(stx.bytes_per_step_per_mux)[None])\n"
        "from dvbt2ll_tpu_torch.observability import profile_trace\n"
        "tx = p.Transmitter(p.vv009_config(), 1, strict=False, "
        "device='cpu')\n"
        "tx(p.synthetic_ts(tx.bytes_per_step))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'dvbt2ll_tpu.')) or m == 'dvbt2ll_tpu')\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=_ROOT, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
