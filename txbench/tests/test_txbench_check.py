"""A whole run of each runner on the CPU (the look for a card skipped):
the result line's keys, a cell and a metric added as files only, and the
output check's verdict with the timed path broken underneath."""
import json
import os

import numpy as np
import pytest
import torch

from txbench import harness
from txbench.tests.conftest import TINY

CELLS = ["vv009." + n for n in TINY]
SEED = 2**31 + 77


def _run(root, cell, trace=False, seconds=2.0, control=False):
    return harness.execute(cell, SEED, seconds, trace, 0.0, root=root,
                           device="cpu", control=control)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(checkout, cell):
    res, lines = _run(checkout, cell)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert "setup_s" in res["metrics"]
    for k, v in res["checks"].items():
        assert set(v) == {"value", "limit"}
    # the numbers compared, each beside its limit, are the last lines
    assert lines[-3:] == [f"{k} {v['value']!r} limit {v['limit']!r}"
                          for k, v in res["checks"].items()]
    assert res["checks"]["iq_rel_err_max"]["value"] < 1e-6


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(checkout, cell):
    """The control (the reference with its transform in TF32) in the
    program's place goes through the run's own check and comes out not
    correct, by its relative error alone."""
    res, lines = _run(checkout, cell, control=True)
    c = res["checks"]
    assert not res["correct"], c
    assert c["iq_rel_err_max"]["value"] > 10 * c["iq_rel_err_max"]["limit"]
    assert c["frames_checked"]["value"] >= c["frames_checked"]["limit"]
    assert c["failed"]["value"] == 0
    assert any(ln.startswith("control:") for ln in lines)
    assert any(ln.startswith("setup phases (s): imports") for ln in lines)


def test_new_cell_and_metric_are_files_only(checkout):
    """A metric added as a file and named in BENCHMARK.json is read in a
    cell added as a traffic file and an entry, with no harness edit."""
    with open(os.path.join(checkout, "txbench", "metrics",
                           "steps_traced.py"), "w") as f:
        f.write("def read(run):\n"
                "    return run.trace.steps if run.trace else None\n")
    path = os.path.join(checkout, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "steps_traced", "unit": "steps", "better": "higher",
        "source": "device_trace", "layer": "device",
        "moves": "msamples_s", "workloads": ["vv009.tiny_single"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    res, _ = _run(checkout, "vv009.tiny_single", trace=True)
    assert res["metrics"]["steps_traced"]["value"] > 0
    assert res["device"]["window_s"] > 0
    assert res["correct"]


def _mesh_faults(monkeypatch, fault):
    from dvbt2ll_tpu_torch.parallel import ShardedTransmitter
    step = ShardedTransmitter.step_device

    def broken(self, ts):
        state = (self._carries.copy(), self._step_no)
        out = step(self, ts)
        if fault == "state":
            self._carries, self._step_no = state
        elif fault == "half":
            for c in range(self.n_mux // 2, self.n_mux):
                out[c] = [torch.zeros_like(x) for x in out[c]]
        else:
            for row in out:
                for x in row:
                    x[:, 5000, 0] *= -1
        return out

    monkeypatch.setattr(ShardedTransmitter, "step_device", broken)


def _chain_faults(monkeypatch, fault):
    from dvbt2ll_tpu_torch.pipeline import Transmitter
    step = Transmitter.step_window

    def broken(self, windows):
        state = ([c.copy() for c in self._carries], self._frame_idx)
        out = step(self, windows)
        if fault == "state":
            self._carries, self._frame_idx = state
        elif fault == "half":
            out[out.shape[0] // 2:] = 0
        else:
            out[:, 5000, 0] *= -1
        return out

    monkeypatch.setattr(Transmitter, "step_window", broken)


@pytest.mark.parametrize("fault", ["state", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(checkout, monkeypatch, cell,
                                          fault):
    """Each fault the cells can have: a step that leaves its stream state
    unchanged, half of the batch (muxes or frames) left out, one sample
    of an answer altered where it is produced.  No cell exchanges data
    between cards, so that fault has no place here."""
    if "mesh" in cell:
        _mesh_faults(monkeypatch, fault)
    else:
        _chain_faults(monkeypatch, fault)
    res, _ = _run(checkout, cell)
    assert not res["correct"], res["checks"]
    assert res["checks"]["iq_rel_err_max"]["value"] > 1e-5
