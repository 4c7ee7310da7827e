"""Each cell of ``BENCHMARK.json`` as the command runs it, briefly, on
the card: ``correct`` true and the result line's keys.  Marked ``cuda``;
skips without a card.  Run on the GPU with
``python -m pytest txbench/tests/test_txbench_cuda.py -q``."""
import json
import subprocess
import sys

import pytest

from txbench import harness
from txbench.tests.conftest import REPO

BENCH = harness.benchmark(REPO)


@pytest.fixture
def cards():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.cuda.device_count()


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_the_card(cards, cell, trace):
    w = harness.find_cell(BENCH, cell)
    if w["chips"] > cards:
        pytest.skip(f"{cell} needs {w['chips']} cards")
    p = subprocess.run(
        [sys.executable, "txbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 101), "--seconds", "4", "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["count"] == w["chips"]
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in harness.cell_metrics(BENCH, cell, kind)}
    assert set(res["metrics"]) == want
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        for name, m in res["metrics"].items():
            if "roofline" in name:
                assert 0 < m["value"] <= 100


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_on_the_card_is_not_correct(cards, cell):
    """The control in the program's place, through a whole run on the
    card: the run's own check finds it not correct."""
    w = harness.find_cell(BENCH, cell)
    if w["chips"] > cards:
        pytest.skip(f"{cell} needs {w['chips']} cards")
    p = subprocess.run(
        [sys.executable, "txbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 102), "--seconds", "4", "--trace", "0", "--control",
         "1"], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    c = res["checks"]
    assert not res["correct"], c
    assert c["iq_rel_err_max"]["value"] > c["iq_rel_err_max"]["limit"]
