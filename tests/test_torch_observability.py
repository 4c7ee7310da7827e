"""The port's tracing on the CPU (``dvbt2ll_tpu_torch.observability``):
spans off and on, the ring, the span trees of a ``StreamingExecutor``
step and of a ``ShardedTransmitter`` step, and the counters.  The device
parts (stage marks in a captured step, ``device_time_ns``) are card tests
in ``tests/test_torch_cuda.py``."""
import os
import re
import time

import numpy as np
import pytest
import torch

from dvbt2ll_tpu_torch import (ShardedTransmitter, StreamingExecutor,
                               Transmitter, make_mesh, min_batch_frames,
                               synthetic_ts, vv009_config)
from dvbt2ll_tpu_torch import observability as obs


@pytest.fixture(autouse=True)
def _tracing_off_after():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)
    obs.disable()


def _tree(records):
    """(name, parent, step) of each record, in the order they closed."""
    return [(r.name, r.parent, r.step) for r in records]


def test_off_span_is_the_shared_noop_and_records_nothing():
    obs.enable()
    obs.disable()
    assert not obs.enabled()
    ctx = obs.span("a", step=3)
    assert ctx is obs.span("b") is obs._NO_SPAN
    with obs.span("a"):
        with obs.span("b", step=1):
            pass
    obs.instant("c", 5)
    obs.mark("fec", torch.zeros(1))
    assert obs.records() == []


def test_every_stage_has_its_mark_kernel_in_order():
    """``STAGES`` and ``csrc/stage_mark.cu`` agree: a kernel
    ``dvbt2ll_mark_<stage>`` a stage, launched for the stage's index; the
    complex tail's ``ifft`` is the last added."""
    src = open(os.path.join(os.path.dirname(obs.__file__), "csrc",
                            "stage_mark.cu")).read()
    cases = re.findall(r"case (\d+): dvbt2ll_mark_(\w+)<<<", src)
    assert [(int(i), s) for i, s in cases] == list(enumerate(obs.STAGES))
    kernels = re.findall(r"__global__ void dvbt2ll_mark_(\w+)\(\)", src)
    assert kernels == list(obs.STAGES)
    assert obs.STAGES[-1] == "ifft"


def test_complex_tail_counts_no_launch_on_the_cpu():
    """``ops.ifft.fft_tail``, the complex tail's transform, is a kernel
    wrapper: the step of a 32K config counts no launch on the CPU, where
    no kernel runs, and the transform is the one ``torch.fft`` gives."""
    from dvbt2ll_tpu_torch import named_config
    from dvbt2ll_tpu_torch.ops import ifft, kernel_wrappers
    from dvbt2ll_tpu_torch.pipeline import symbols_with_gi
    assert kernel_wrappers()["fft_tail"] is ifft.fft_tail
    cfg = named_config("32k_extended")
    g = torch.complex(*torch.randn(2, 1, 2, cfg.fft_points))
    before = ifft.fft_tail.launches
    obs.enable()
    got = symbols_with_gi(cfg, g, None)
    assert ifft.fft_tail.launches == before
    scale = cfg.fft_points * cfg.ofdm_normalization
    sym = torch.fft.ifft(g, dim=-1) * scale
    gi = cfg.guard_samples
    assert torch.equal(got, torch.cat([sym[..., -gi:], sym], dim=-1))


def test_nested_spans_record_parent_step_and_ordered_times():
    obs.enable()
    assert obs.enabled()
    with obs.span("root", step=7):
        with obs.span("child"):
            time.sleep(0.001)
            with obs.span("grandchild", step=2):
                pass
        obs.instant("moment", 123)
    recs = obs.records()
    assert _tree(recs) == [("grandchild", "child", 2),
                           ("child", "root", 7),
                           ("moment", "root", 7),
                           ("root", None, 7)]
    gc, child, moment, root = recs
    assert root.t0_ns <= child.t0_ns <= gc.t0_ns <= gc.t1_ns
    assert gc.t1_ns <= child.t1_ns <= root.t1_ns
    assert child.t1_ns - child.t0_ns >= 1_000_000
    assert moment.t0_ns == moment.t1_ns == 123
    # the recorder's clock is perf_counter's
    assert abs(root.t1_ns - time.perf_counter_ns()) < 10**9


def test_ring_keeps_only_the_newest_records():
    obs.enable(capacity=4)
    for i in range(10):
        with obs.span("s", step=i):
            pass
    assert [r.step for r in obs.records()] == [6, 7, 8, 9]
    obs.enable()                      # a fresh, empty ring
    assert obs.records() == []


def test_span_is_a_profiler_range():
    obs.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("ranged"):
            torch.ones(4).add_(1)
    assert any(e.key == "tx:ranged" for e in prof.key_averages())


def _executor(validate: bool):
    cfg = vv009_config()
    tx = Transmitter(cfg, min_batch_frames(cfg), validate_ts=validate,
                     device="cpu")
    ts = synthetic_ts(4 * tx.bytes_per_step, seed=91)
    pos = [0]

    def source(n):
        pos[0] += n
        return ts[pos[0] - n:pos[0]]
    return StreamingExecutor(tx, source=source, sink=_Sink())


class _Sink:
    def __init__(self):
        self.n = 0

    def write(self, iq):
        self.n += iq.size


def test_executor_step_records_the_span_tree():
    ex = _executor(validate=True)
    ex.step()                         # step 0: nothing to drain yet
    obs.enable()
    ex.step()                         # step 1: drains and sinks step 0
    ex.flush()                        # drains and sinks step 1
    assert _tree(obs.records()) == [
        ("executor.read", "executor.step", 1),
        ("transmitter.validate", "transmitter.step", 1),
        ("compiled.wait", "transmitter.step", 1),
        ("compiled.stage", "transmitter.step", 1),
        ("compiled.upload", "transmitter.step", 1),
        ("compiled.launch", "transmitter.step", 1),
        ("transmitter.step", "executor.step", 1),
        ("executor.copy", "executor.step", 1),
        ("executor.drain", "executor.step", 0),
        ("executor.sink", "executor.step", 0),
        ("executor.step", None, 1),
        ("executor.drain", None, 1),
        ("executor.sink", None, 1)]
    assert ex.sink.n == 2 * ex.tx.plan.samples_out


def test_sharded_step_records_the_span_tree():
    cfg = vv009_config()
    stx = ShardedTransmitter(cfg, make_mesh(["cpu"] * 2, mux=2), n_mux=2,
                             frames_per_shard=min_batch_frames(cfg))
    ts = np.stack([synthetic_ts(stx.bytes_per_step_per_mux, seed=s)
                   for s in (1, 2)])
    stx.step_device(ts)
    obs.enable()
    stx.step_device(ts)
    # both slots on one device: one compiled step of two blocks
    per_card = [("compiled.wait", "mesh.step", 1),
                ("mesh.stage", "mesh.step", 1),
                ("compiled.upload", "mesh.step", 1)]
    assert _tree(obs.records()) == per_card + [
        ("compiled.launch", "mesh.step", 1),
        ("mesh.step", None, 1)]


def test_turning_tracing_off_stops_recording():
    ex = _executor(validate=False)
    obs.enable()
    ex.step()
    n = len(obs.records())
    assert n > 0
    obs.disable()
    ex.step()
    ex.flush()
    assert len(obs.records()) == n


def test_counters_count_steps_frames_samples_bytes_and_sync_errors():
    cfg = vv009_config()
    tx = Transmitter(cfg, min_batch_frames(cfg), validate_ts=True,
                     device="cpu")
    n = tx.bytes_per_step
    ts = synthetic_ts(2 * n, seed=92)
    tx.step_device(ts[:n])
    bad = ts[n:].copy()
    bad[188] = 0x00                   # one missing sync byte
    tx.step_device(bad)
    c = tx.counters
    assert c.as_dict() == {"steps": 2, "frames": 2 * tx.plan.batch_frames,
                           "samples": 2 * tx.plan.samples_out,
                           "ts_bytes": 2 * n, "sync_errors": 1}
