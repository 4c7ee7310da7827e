"""``BENCHMARK.json`` against the benchmark contract, every file found by
name, the frozen kernel counts against ``tools/roofline.py``, the module
check, and the command's refusals."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from txbench import harness, peaks
from txbench.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "cell": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}
BENCH = harness.benchmark(REPO)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_limits():
    b = BENCH
    assert set(b) == KEYS["top"]
    assert b["paths"] == ["txbench"] and b["command"][1] == "txbench/run.py"
    assert all(_line(w) for w in b["command"]) and len(b["command"]) <= 32
    assert isinstance(b["run_seconds"], int) and 35 <= b["run_seconds"] <= 51
    n = len(b["workloads"])
    # a full check: 2 + 14 runs a cell, each run_seconds + 60, 180 s a
    # cell to compile, 1200 spare, within 43200 s, for 24 cells
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= n <= 24 and 1 <= len(b["configs"]) <= 24
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, n // 4)
    assert len(json.dumps(b)) <= 64 * 1024


def test_names_units_and_keys():
    b = BENCH
    metrics = b["end_to_end"] + b["per_layer"]
    for group in (b["configs"], b["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(x) for x in names)
    for c in b["configs"]:
        assert set(c) == KEYS["config"] and _line(c["source"])
        assert _line(c["why"])
        assert c["file"].startswith("txbench/") and len(c["reduced"]) <= 16
        assert os.path.exists(os.path.join(REPO, c["file"]))
    for w in b["workloads"]:
        assert set(w) == KEYS["cell"] and _line(w["why"])
        assert w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["e2e"]
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                          "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["layer"] and _line(m["layer"])
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_the_contract_asks():
    b = BENCH
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for w in b["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(b, w["name"],
                                                       "end_to_end")}
        layer = harness.cell_metrics(b, w["name"], "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        # a per-layer metric moves an end-to-end metric its cell reports
        assert all(m["moves"] in e2e for m in layer)


def test_files_found_by_name():
    b = BENCH
    for c in b["configs"]:
        cfg = harness.load_json(os.path.join(REPO, c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["limits"]["iq_rel_err_max"] > 0
        assert c["file"] == f"txbench/configs/{c['name']}.json"
    for w in b["workloads"]:
        t = harness.load_json(harness.bench_file(
            REPO, "traffic", w["traffic"] + ".json"))
        assert os.path.exists(harness.bench_file(
            REPO, "runners", t["runner"] + ".py"))
        assert t["check_frames_min"] >= t["check_frames_per_step"]
    for m in b["end_to_end"] + b["per_layer"]:
        mod = harness.load_module(harness.bench_file(
            REPO, "metrics", m["name"] + ".py"), "m")
        assert callable(mod.read)


def test_configs_are_the_ports_named_configs():
    """Each configuration file holds the fields of the port's configuration
    of that name, and the reference reads the same fields."""
    from dvbt2ll_tpu_torch.config import named_config
    from txbench.reference.config import T2Config
    for c in BENCH["configs"]:
        fields = harness.load_json(os.path.join(REPO, c["file"]))["t2config"]
        assert fields == named_config(c["name"]).to_dict()
        assert T2Config.from_dict(fields).to_dict() == fields


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_kernel_counts_equal_the_ports_roofline(cell):
    """The frozen byte and operation counts of the kernel metrics equal
    ``dvbt2ll_tpu_torch/tools/roofline.py``'s (and ``chip_smoke.py``'s
    LDPC count) at the cell's shapes."""
    from dvbt2ll_tpu_torch.config import named_config
    from dvbt2ll_tpu_torch.plan import build_plan
    from dvbt2ll_tpu_torch.tools import roofline
    from txbench.reference.config import T2Config
    w = harness.find_cell(BENCH, cell)
    t = harness.load_json(harness.bench_file(REPO, "traffic",
                                             w["traffic"] + ".json"))
    cfg = T2Config.from_dict(named_config(w["config"]).to_dict())
    per_mux = (t["frames_per_block"] * t["slots_per_mux"]
               if "frames_per_block" in t else t["frames_per_step"])
    frames = per_mux * t.get("n_mux", 1) // w["chips"]
    assert peaks.HBM_BYTES_PER_S == roofline.HBM_BYTES_PER_S
    assert peaks.FP32_FLOP_PER_S == roofline.FP32_FLOP_PER_S
    s, fft, gi = cfg.num_symbols, cfg.fft_points, cfg.guard_samples
    assert peaks.tail_bytes(cfg, frames) == roofline.tail_kernel_bytes(
        frames, s, fft, gi)
    assert peaks.fft_flops(frames, s, fft) == roofline.fft_flops(frames, s,
                                                                 fft)
    plan = build_plan(named_config(w["config"]), frames, strict=False)
    fec = plan.plps[0].fec_frames
    assert peaks.ldpc_bytes(cfg, fec) == fec * (cfg.nbch
                                                + cfg.ldpc_frame_bits)


def test_module_check_compares_whole_top_level_names():
    found = harness.forbidden_modules(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         "dvbt2ll_tpu", "dvbt2ll_tpu.config", "dvbt2ll_tpu_torch",
         "dvbt2ll_tpu_torch.pipeline", "jaxtyping", "flaxen", "numpy"])
    assert found == ["dvbt2ll_tpu", "dvbt2ll_tpu.config", "flax.linen",
                     "jax", "jax.numpy", "jaxlib.xla_client"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import txbench.reference.frames, txbench.traffic.ts; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'dvbt2ll_tpu', 'dvbt2ll_tpu_torch', "
            "'torch')]; print(bad); sys.exit(1 if bad else 0)")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr


def _run(cwd):
    return subprocess.run(
        [sys.executable, "txbench/run.py", "--workload", "vv009.mux8",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_refuses_without_a_card_or_the_port(tmp_path):
    """Here, with no CUDA card, the command exits non-zero and prints no
    result; so does it in a directory of only ``BENCHMARK.json`` and the
    benchmark's folder, where the port is missing."""
    import torch
    if not torch.cuda.is_available():
        p = _run(REPO)
        assert p.returncode != 0 and '"correct"' not in p.stdout
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "txbench"), tmp_path / "txbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and '"correct"' not in p.stdout
