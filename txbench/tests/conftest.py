"""Fixtures of the benchmark's own tests: a temporary checkout with small
cells added as files, run on the CPU (``harness.execute(device="cpu")``
skips the look for a card and runs the rest of a run)."""
import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# small traffic of each runner: a CPU step of 47-94 vv009 frames takes a
# few tens of milliseconds, so a window of seconds holds tens of steps
TINY = {
    "tiny_mesh": {"runner": "mesh", "n_mux": 2, "slots_per_mux": 1,
                  "frames_per_block": 47, "pool_steps": 2, "warm_steps": 1,
                  "check_steps": 3, "check_frames_per_step": 2,
                  "check_frames_min": 8, "trace_seconds": 1},
    "tiny_single": {"runner": "single", "frames_per_step": 47,
                    "pool_steps": 2, "warm_steps": 1, "check_steps": 3,
                    "check_frames_per_step": 2, "check_frames_min": 8,
                    "trace_seconds": 1},
    # 47 frames every 80 ms
    "tiny_paced": {"runner": "paced", "frames_per_step": 47,
                   "sample_rate": 47 * 31616 / 0.08, "chunks_per_step": 4,
                   "pool_steps": 2, "warm_steps": 1, "ring_bytes": 1 << 23,
                   "gain": 0.2, "check_steps": 3, "check_frames_per_step": 2,
                   "check_frames_min": 8, "trace_seconds": 0.5},
}


def make_checkout(dst: str) -> str:
    """``BENCHMARK.json`` and the benchmark's folder copied to ``dst``,
    with one cell ``vv009.<traffic>`` a traffic of ``TINY`` added as files
    and entries; returns ``dst``."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(REPO, "txbench"),
                    os.path.join(dst, "txbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(dst, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, traffic in TINY.items():
        with open(os.path.join(dst, "txbench", "traffic",
                               name + ".json"), "w") as f:
            json.dump(traffic, f)
        bench["workloads"].append({
            "name": "vv009." + name, "config": "vv009_4kshort",
            "traffic": name, "chips": 1, "why": "a test's small cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += ["vv009." + n for n in TINY]
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst


@pytest.fixture(scope="package")
def checkout(tmp_path_factory):
    return make_checkout(str(tmp_path_factory.mktemp("checkout")))
