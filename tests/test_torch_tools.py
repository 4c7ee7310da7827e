"""The port's measuring entry points on the CPU, against the JAX package:
``dvbt2ll_tpu_torch.bench`` against ``bench.py``, and ``tools/roofline``,
``bench_latency``, ``bench_sustained`` and ``bench_scaling`` of
``dvbt2ll_tpu_torch.tools`` against their twins in ``tools/``.

Run alone: ``python -m pytest tests/test_torch_tools.py -q``.
"""
import contextlib
import functools
import importlib.util
import json
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dvbt2ll_tpu.io import synthetic_ts as jax_synthetic_ts
from dvbt2ll_tpu.pipeline import Transmitter as JaxTransmitter
from dvbt2ll_tpu.plan import build_plan as jax_build_plan
from dvbt2ll_tpu_torch import Transmitter, bench, min_batch_frames
from dvbt2ll_tpu_torch.config import NAMED_CONFIGS, InputMode, named_config
from dvbt2ll_tpu_torch.ops.ifft import P1_LEN, tail_tables
from dvbt2ll_tpu_torch.plan import build_plan
from dvbt2ll_tpu_torch.tools import (bench_latency, bench_scaling,
                                     bench_sustained, roofline)
from tests.torch_compare import jax_named_config, same, snr_db

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
# the keys of tools/bench_sustained.py:190-207, and of its roles' sink
# statistics (:159-166, :179-180)
_SUSTAINED_KEYS = {"role", "config", "device", "batch", "sustained_s",
                   "steps", "t2_frames", "frames_per_s", "msamp_per_s",
                   "x_realtime", "profile_msamp_per_s", "x_realtime_profile",
                   "ts_mbyte_per_s", "sync_errors", "ingest"}
_SINK_KEYS = {"sink_samples", "producer_stalls"}
_PACED_KEYS = {"paced_steps", "paced_lag_s", "paced_ok"}


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def _on_path(path):
    sys.path.insert(0, path)
    try:
        yield
    finally:
        sys.path.remove(path)


@functools.lru_cache(maxsize=None)
def _jax_tool(name):
    """``tools/<name>.py`` of the JAX package, imported with ``tools/`` on
    ``sys.path`` as it runs (its ``_common`` and the root ``bench.py``)."""
    with _on_path(os.path.join(_ROOT, "tools")), _on_path(_ROOT):
        spec = importlib.util.spec_from_file_location(
            f"jax_tools_{name}", os.path.join(_ROOT, "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


def _jax_cfg(name):
    return jax_named_config(_jax_tool("roofline")._named_config, name)


@pytest.mark.parametrize("name", NAMED_CONFIGS)
def test_roofline_rows_equal_the_jax_tools(name):
    """``stage_traffic``: the JAX tool's stage names, bytes and notes,
    exactly, each plan built by its own package (HIEFF at its smallest
    batch of whole packets)."""
    ours = named_config(name)
    batch = (min_batch_frames(ours) if ours.input_mode == InputMode.HIEFF
             else 4)
    theirs = _jax_cfg(name)
    got = roofline.stage_traffic(ours, build_plan(ours, batch, strict=False),
                                 batch)
    want = _jax_tool("roofline").stage_traffic(
        theirs, jax_build_plan(theirs, batch, strict=False), batch)
    same(list(got[0]), list(want[0]), name)
    assert got[1] == want[1]


def test_roofline_tail_bound_is_chip_smokes():
    """The port's planar tail bound at vv009 batch 256 equals
    ``chip_smoke.tail_bound`` on tensors of the kernel's shapes, (256, 7,
    32, 128) grids, which phase 3 times."""
    b, s, fft, gi = 256, 7, 4096, 128
    re, im = (torch.empty((b, s, fft // 128, 128)) for _ in range(2))
    p1 = torch.empty((P1_LEN, 2))
    out = torch.empty((b, P1_LEN + s * (fft + gi), 2))
    want = chip_smoke.tail_bound(re, im, p1, tail_tables(fft, 1.0, "cpu"),
                                 out, fft)
    r = roofline.roofline("vv009_4kshort", b)
    tail = {p["name"]: p for p in r["parts"]}["tail_kernel"]
    assert (tail["bound_ms"], tail["bound_by"]) == want
    assert round(tail["bound_ms"], 4) == 0.0369
    assert r["step_bound_ms"] == sum(p["bound_ms"] for p in r["parts"])


def _bench_py_windows(name, batch):
    """``bench.py:263-273``'s four steps of windows, in numpy, with the
    JAX package's ``synthetic_ts``."""
    jtx_plan = jax_build_plan(_jax_cfg(name), batch, strict=False)
    per_plp = jtx_plan.ts_bytes_per_plp
    carries = [np.zeros(187, np.uint8) for _ in per_plp]
    out = []
    for s in range(4):
        step_in = []
        for i, n_p in enumerate(per_plp):
            padded = np.concatenate([carries[i],
                                     jax_synthetic_ts(n_p, seed=16 * s + i)])
            carries[i] = padded[-187:]
            step_in.append(padded)
        out.append(step_in)
    return out


@pytest.mark.parametrize("name", ["vv009_4kshort", "multiplp_fef"])
def test_bench_windows_equal_bench_pys(name):
    tx = Transmitter(named_config(name), 2, strict=False,
                     allow_phase_drift=True, device="cpu")
    windows, fresh = bench.staged_windows(tx, "cpu")
    want = _bench_py_windows(name, 2)
    assert len(windows) == len(want) == 4
    for w, f, ref in zip(windows, fresh, want):
        ws = w if isinstance(w, list) else [w]
        fs = f if isinstance(f, list) else [f]
        assert len(ws) == len(fs) == len(ref)
        for t, fr, r in zip(ws, fs, ref):
            assert t.dtype == torch.uint8
            np.testing.assert_array_equal(t.numpy(), r)
            np.testing.assert_array_equal(fr, r[187:])


@pytest.mark.parametrize("name", ["vv009_4kshort", "multiplp_fef"])
def test_bench_first_staged_step_matches_jax(name):
    """The first staged step of the port's bench at batch 2 against the
    JAX ``Transmitter``'s ``_step`` on the same window."""
    tx = Transmitter(named_config(name), 2, strict=False,
                     allow_phase_drift=True, device="cpu")
    windows, _ = bench.staged_windows(tx, "cpu")
    got = tx._step_fn(tx.tensors, windows[0], 0).numpy()
    jtx = JaxTransmitter(_jax_cfg(name), 2, strict=False, use_pallas=False)
    w = [jnp.asarray(a) for a in _bench_py_windows(name, 2)[0]]
    want = np.asarray(jtx._step(w if len(w) > 1 else w[0], jnp.int32(0)))
    assert got.shape == want.shape
    snr = snr_db(want[..., 0] + 1j * want[..., 1],
                 got[..., 0] + 1j * got[..., 1])
    assert snr > 120, f"{snr:.1f} dB"


def test_bench_prints_bench_pys_fields(capsys):
    bench.main(["2", "2", "vv009_4kshort", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu"
    r = json.loads(lines[-1])
    assert {"metric", "value", "unit", "vs_baseline", "device"} <= r.keys()
    assert r["metric"] == "vv009_4kshort_throughput"
    assert r["unit"] == "Msamples/s/chip" and r["device"] == "cpu"
    assert r["value"] > 0 and r["vs_baseline"] > 0
    assert r["step_device_msamples_s"] > 0
    assert r["launches"] == {"bb_bch": 0, "ldpc_parity": 0, "qam_map": 0,
                             "ifft_gi": 0, "fft_tail": 0}


def test_bench_latency_frame_duration_is_jaxs(capsys):
    bench_latency.main(["inband_2k", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu"
    assert lines[1].startswith("inband_2k") and "frame latency" in lines[1]
    r = json.loads(lines[-1])
    assert r["frame_duration_s"] == _jax_cfg("inband_2k").frame_duration
    assert r["batch"] == 1 and r["calls"] == 200 and r["iters"] == 50
    assert 0 < r["per_call_ms_median"] <= r["per_call_ms_max"]
    assert r["x_realtime"] == pytest.approx(
        r["frame_duration_s"] * 1e3 / r["frame_latency_ms"])


@pytest.mark.parametrize("role", ["cpu", "paced"])
def test_bench_sustained_on_cpu(role):
    """hieff_4k (17 frames a strict step) from a real pipe through the
    native ingest ring into the native sink: the JAX tool's keys, no sync
    errors, the warm-up step outside the counters, and every sample the
    sink was given written out (paced: into its file).  On the CPU paced
    checks keys and counts, not ``paced_ok``."""
    if shutil.which("g++") is None:
        pytest.skip("the native ingest ring and sink build with g++")
    r = bench_sustained.run_role(role, 2.0, "hieff_4k", device="cpu")
    keys = _SUSTAINED_KEYS | _SINK_KEYS | (_PACED_KEYS if role == "paced"
                                           else set())
    assert keys <= r.keys()
    assert r["device"] == "cpu" and r["batch"] == 17
    assert r["sync_errors"] == 0 and r["ingest"]["sync_errors"] == 0
    assert r["ingest"]["null_stuffed"] == 0
    cfg = named_config("hieff_4k")
    step = 17 * cfg.samples_per_frame
    sunk = r["sink_samples"]
    assert r["steps"] > 0 and r["t2_frames"] == 17 * r["steps"]
    assert sunk == {"warmup": step, "timed": r["steps"] * step}
    assert sunk["warmup"] + sunk["timed"] == r["sink_written"]
    if role == "paced":
        assert r["paced_steps"] == r["steps"] == int(
            2.0 / (17 * cfg.emitted_frame_duration))
        assert r["sink_file_samples"] == r["sink_written"]
        assert isinstance(r["paced_ok"], bool)
    else:
        assert r["sink"] == os.devnull and r["sink_file_samples"] is None


@pytest.mark.parametrize("order", [(1, 2, 4), (4, 2, 1)])
def test_bench_scaling_strong_on_cpu_slots(order):
    """Part A over 1, 2 and 4 CPU slots of 4 frames, in either order:
    every block equal to the sequential Transmitter at the same per-call
    batch and shard 0 to the first slot count's on the frames both hold
    (``strong`` raises otherwise)."""
    rows = bench_scaling.strong("cpu", order, frames=4, steps=1)
    assert tuple(r["slots"] for r in rows) == order
    assert [r["frames_per_slot"] for r in rows] == [4 // n for n in order]
    assert rows[0]["speedup"] == 1.0
    assert all(r["wall_ms_per_step"] > 0 for r in rows)


def test_bench_scaling_copy_audit_on_cpu():
    r = bench_scaling.copy_audit("cpu", frames=8)
    assert r["peer_copies"] == 0 and r["slots"] == 8


def test_bench_scaling_multiprocess_within_its_limit():
    """Part C: one process of 8 CPU slots, then two gloo processes of 4,
    under the part's time limit."""
    with bench_scaling.time_limit(bench_scaling.LIMITS["C"], "part C"):
        r = bench_scaling.multiprocess("cpu", frames=8, steps=1,
                                       timeout=120)
    assert r["two_process"]["procs"] == 2
    assert len(r["two_process"]["wall_s_by_rank"]) == 2
    assert r["efficiency"] > 0


@pytest.mark.parametrize("main", [
    bench.main, roofline.main, bench_latency.main, bench_sustained.main,
    bench_scaling.main], ids=["bench", "roofline", "bench_latency",
                              "bench_sustained", "bench_scaling"])
def test_tool_refuses_a_missing_card(main, capsys):
    """With no card and no ``--device cpu``, each tool exits non-zero
    with a message and prints nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        main([])
    assert e.value.code not in (0, None)
    assert "no CUDA device" in str(e.value.code)
    assert capsys.readouterr().out == ""
