"""The port's multi-device dry runs and multi-mux app on the CPU:
``dryrun_multichip`` over 8 CPU slots, ``dryrun_multihost`` as two real
processes joined by torch.distributed (gloo, localhost), and
``dvbt2ll_tpu_torch.apps.multimux`` as a subprocess."""
import os
import subprocess
import sys

import pytest
import torch

from dvbt2ll_tpu_torch import named_config, vv009_config
from dvbt2ll_tpu_torch.dryrun import dryrun_multichip, dryrun_multihost

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_dryrun_multichip_on_cpu_slots():
    res = dryrun_multichip(8, "cpu")
    assert res == {"blocks": 8, "mux": 2}


def test_dryrun_multihost_two_processes_bit_identical():
    """Two gloo processes, each its half of a (2, 4) mesh, gathered after
    the steps: bit-identical to the single-process run.  The workers'
    time limit sits well inside the suite's."""
    line = dryrun_multihost("cpu", slots=4, timeout=240)
    assert "2-process outputs BIT-IDENTICAL" in line
    assert "{'mux': 2, 'frame': 4}" in line


def _app(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=_ROOT, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "dvbt2ll_tpu_torch.apps.multimux", *args],
        cwd=_ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def test_app_one_config_on_cpu_slots():
    res = _app(["--device", "cpu", "--slots", "4", "--mux", "2",
                "--steps", "1"])
    assert res.returncode == 0, res.stderr
    assert "mesh={'mux': 2, 'frame': 2} slots=4" in res.stdout
    assert "frames/step=4" in res.stdout
    assert "Msamp/s aggregate" in res.stdout


def test_app_heterogeneous_configs_on_cpu_slots(tmp_path):
    paths = []
    for name, cfg in (("a", vv009_config()),
                      ("b", named_config("8k_normal"))):
        p = tmp_path / f"{name}.json"
        p.write_text(cfg.to_json())
        paths += ["--config", str(p)]
    res = _app(["--device", "cpu", "--slots", "4", "--mux", "1",
                "--steps", "1", "--frames-per-shard", "1", *paths])
    assert res.returncode == 0, res.stderr
    assert "channel 0: 2 slots x 1 muxes, 2 frames/step" in res.stdout
    assert "channel 1: 2 slots x 1 muxes, 2 frames/step" in res.stdout
    assert "2 heterogeneous groups" in res.stdout


def test_app_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _app(["--steps", "1"])
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    res = _app(["--device", "cpu", "--steps", "1"])  # --slots 0: the cards
    assert res.returncode != 0
    assert "every visible CUDA card" in res.stderr
