"""The port's streaming runtime on the CPU: ``StreamingExecutor`` after
tests/test_executor.py (sequential equality, multi-PLP sources, realtime
pacing, FEF parts), against the JAX ``StreamingExecutor``, fed by the
native TS ingest ring through a real pipe into the native async sink, and
the app ``dvbt2ll_tpu_torch.apps.vv009_4kshort`` as a subprocess."""
import dataclasses
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dvbt2ll_tpu.executor import StreamingExecutor as JaxExecutor
from dvbt2ll_tpu.pipeline import Transmitter as JaxTransmitter
from dvbt2ll_tpu_torch import (StreamingExecutor, Transmitter,
                               min_batch_frames, synthetic_ts, vv009_config)
from tests.test_torch_multiplp import _mixed_plp_cfg

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
GAIN = 0.2


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


class _ListSink:
    """Keeps what it is given, without a copy: an executor that wrote to
    an array it returned would show here."""

    def __init__(self):
        self.chunks = []

    def write(self, iq):
        self.chunks.append(iq)


def _reader(data):
    pos = {"o": 0}

    def source(nbytes):
        o = pos["o"]
        pos["o"] += nbytes
        return data[o:o + nbytes]
    return source


def _drift_tx(cfg):
    # batch-1 vv009 is not phase-invariant (12352 % 188 != 0); the executor
    # mechanics under test don't care, so opt out of the streamability guard
    return Transmitter(cfg, 1, strict=False, allow_phase_drift=True,
                       device="cpu")


def test_executor_matches_sequential():
    """Every array the executor returns or hands the sink still holds its
    step's IQ after the later steps ran."""
    cfg = vv009_config()
    n_steps = 3
    tx_seq = _drift_tx(cfg)
    n = tx_seq.bytes_per_step
    ts = synthetic_ts(n_steps * n, seed=101)
    expected = [tx_seq(ts[i * n:(i + 1) * n]) for i in range(n_steps)]

    sink = _ListSink()
    ex = StreamingExecutor(_drift_tx(cfg), _reader(ts), sink)
    returned = [ex.step() for _ in range(n_steps)] + [ex.flush()]
    assert returned[0] is None and ex.flush() is None
    for got, want, sunk in zip(returned[1:], expected, sink.chunks):
        assert got is sunk
        np.testing.assert_array_equal(got, want)
    assert len(sink.chunks) == n_steps

    sink = _ListSink()
    tx = _drift_tx(cfg)
    stats = StreamingExecutor(tx, _reader(ts), sink).run(n_steps)
    np.testing.assert_array_equal(np.concatenate(sink.chunks),
                                  np.concatenate(expected))
    assert stats["steps"] == n_steps
    assert stats["sustained_samples_per_second"] > 0


def test_executor_multi_plp_sources():
    """One source callable per PLP stream (the executor's list form)
    matches the sequential multi-PLP chain."""
    cfg = _mixed_plp_cfg()
    n_steps = 2
    tx_seq = _drift_tx(cfg)
    per = tx_seq.bytes_per_step_per_plp
    streams = [synthetic_ts(n_steps * m, seed=110 + k)
               for k, m in enumerate(per)]
    expected = np.concatenate([
        tx_seq([s[i * m:(i + 1) * m] for s, m in zip(streams, per)])
        for i in range(n_steps)])

    sink = _ListSink()
    stats = StreamingExecutor(
        _drift_tx(cfg), [_reader(s) for s in streams], sink).run(n_steps)
    np.testing.assert_array_equal(np.concatenate(sink.chunks), expected)
    assert stats["steps"] == n_steps
    with pytest.raises(ValueError, match="sources"):
        StreamingExecutor(_drift_tx(cfg), _reader(streams[0]))


def test_executor_realtime_pacing():
    """run(realtime=True) holds the air schedule: N steps take at least
    about N times the batch's frame airtime even when compute is far
    faster."""
    cfg = vv009_config()
    tx = _drift_tx(cfg)
    ts = synthetic_ts(6 * tx.bytes_per_step, seed=103)
    ex = StreamingExecutor(tx, _reader(ts), _ListSink(), realtime=True)
    ex.step()  # warm up outside the pacing window
    t0 = time.perf_counter()
    ex.run(5)
    wall = time.perf_counter() - t0
    frame_t = tx.plan.batch_frames * cfg.frame_duration
    assert wall >= 5 * frame_t * 0.9, (wall, frame_t)


def test_executor_emits_fef_parts():
    """For FEF configs the sink stream equals the sequential
    ``Transmitter.stream`` (FEF parts after every fef_interval-th frame),
    each drain shaped (1, samples) as in the JAX executor."""
    cfg = dataclasses.replace(vv009_config(), fef_length=4096,
                              fef_interval=2).validate()
    tx_seq = _drift_tx(cfg)
    n = tx_seq.bytes_per_step
    ts = synthetic_ts(4 * n, seed=104)
    expected = np.concatenate(
        [tx_seq.stream(ts[i * n:(i + 1) * n]) for i in range(4)])

    sink = _ListSink()
    StreamingExecutor(_drift_tx(cfg), _reader(ts), sink).run(4)
    assert all(c.ndim == 2 and c.shape[0] == 1 for c in sink.chunks)
    got = np.concatenate([c.reshape(-1) for c in sink.chunks])
    np.testing.assert_array_equal(got, expected)


def test_executor_matches_jax_executor():
    """The port's executor sink stream against the JAX
    ``StreamingExecutor``'s on the same TS, strict vv009."""
    cfg = vv009_config()
    b = min_batch_frames(cfg)
    n_steps = 2
    tx = Transmitter(cfg, b, device="cpu")
    ts = synthetic_ts(n_steps * tx.bytes_per_step, seed=105)
    ours, theirs = _ListSink(), _ListSink()
    StreamingExecutor(tx, _reader(ts), ours).run(n_steps)
    jtx = JaxTransmitter(cfg, b, use_pallas=False)
    JaxExecutor(jtx, _reader(ts), theirs).run(n_steps)
    got, want = np.concatenate(ours.chunks), np.concatenate(theirs.chunks)
    assert got.shape == want.shape == (n_steps * b, cfg.samples_per_frame)
    snr = _snr_db(want, got)
    assert snr > 120, f"{snr:.1f} dB"
    assert tx.state_dict()["frame_idx"] == jtx.state_dict()["frame_idx"]


def _feed(fd: int, data: np.ndarray) -> threading.Thread:
    """Write ``data`` into a pipe from a thread, then close it."""
    def run():
        with os.fdopen(fd, "wb") as f:
            f.write(data.tobytes())
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def test_native_ingest_pipe_to_native_sink(tmp_path):
    """TS through a real pipe into the native ingest ring, the executor,
    and the native async sink: the file holds ``stream`` x gain exactly,
    with no sync errors."""
    if shutil.which("g++") is None:
        pytest.skip("the native ingest ring and sink build with g++")
    from dvbt2ll_tpu_torch.io.ingest import TSIngest
    from dvbt2ll_tpu_torch.io.native_sink import NativeIQSink

    cfg = vv009_config()
    b = min_batch_frames(cfg)
    n_steps = 3
    tx = Transmitter(cfg, b, validate_ts=True, device="cpu")
    n = tx.bytes_per_step
    ts = synthetic_ts(n_steps * n, seed=106)
    ref = Transmitter(cfg, b, device="cpu")
    want = np.concatenate([ref.stream(ts[i * n:(i + 1) * n])
                           for i in range(n_steps)])

    rfd, wfd = os.pipe()
    feeder = _feed(wfd, ts)
    path = str(tmp_path / "out.cf32")
    try:
        with TSIngest(fd=rfd, capacity=1 << 24) as ing:
            ing.start_thread()

            def source(nbytes):
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    w = ing.window(nbytes, allow_stuffing=False)
                    if w is not None:
                        return w[187:]
                    time.sleep(0.001)
                raise TimeoutError("the ingest ring gave no window")

            with NativeIQSink(path, gain=GAIN) as sink:
                StreamingExecutor(tx, source, sink).run(n_steps)
                assert sink.samples_written == want.size
            stats = ing.stats
    finally:
        feeder.join(timeout=10)
        os.close(rfd)
    assert not feeder.is_alive()
    assert stats["sync_errors"] == 0 and stats["null_stuffed"] == 0
    assert tx.counters.sync_errors == 0
    got = np.fromfile(path, dtype=np.float32)
    np.testing.assert_array_equal(
        got, want.view(np.float32) * np.float32(GAIN))


def _app(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=_ROOT, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "dvbt2ll_tpu_torch.apps.vv009_4kshort",
         *args], cwd=_ROOT, env=env, capture_output=True, text=True,
        timeout=timeout)


def test_app_runs_on_cpu(tmp_path):
    """Two strict steps of the app's default (synthetic) source on the
    CPU: its cf32 file is the port's ``stream`` x gain."""
    cfg = vv009_config()
    b = min_batch_frames(cfg)
    out = str(tmp_path / "app.cf32")
    res = _app([out, "--frames", str(2 * b), "--device", "cpu"])
    assert res.returncode == 0, res.stderr
    assert f"emitted {2 * b} T2 frames" in res.stdout
    tx = Transmitter(cfg, b, device="cpu")
    want = np.concatenate([tx.stream(synthetic_ts(tx.bytes_per_step, seed=i))
                           for i in range(2)]) * np.float32(GAIN)
    got = np.fromfile(out, dtype=np.complex64)
    assert got.shape == want.shape
    snr = _snr_db(want, got)
    assert snr > 120, f"{snr:.1f} dB"


def test_app_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _app([str(tmp_path / "x.cf32"), "--frames", "1"])
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert not os.path.exists(tmp_path / "x.cf32")


def test_profile_trace_writes_a_trace(tmp_path):
    """``profile_trace`` records a transmitter step's operators and
    writes a trace file into its directory."""
    from dvbt2ll_tpu_torch.observability import profile_trace

    tx = _drift_tx(vv009_config())
    logdir = tmp_path / "trace"
    with profile_trace(str(logdir)) as prof:
        tx(synthetic_ts(tx.bytes_per_step, seed=107))
    names = {ev.key for ev in prof.key_averages()}
    assert any(n.startswith("aten::") for n in names)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    assert "aten::" in (logdir / files[0]).read_text()
