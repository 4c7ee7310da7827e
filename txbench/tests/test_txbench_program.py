"""The port's tracing read for the benchmark (``txbench/program.py``):
the segment splitter on made-up device activity, CPU runs of the small
mesh and paced cells with the program's tracing on, and ``run.py``'s
own path, which leaves the program's tracing off."""
import pytest

from dvbt2ll_tpu_torch import observability
from txbench import harness, program

SEED = 2**31 + 79
SPANS_MESH = {"mesh_stage_ms", "mesh_wait_ms"}
SPANS_PACED = {"stage_ms.paced", "copy_ms.paced", "drain_ms.paced",
               "sink_ms.paced"}


@pytest.fixture(autouse=True)
def _tracing_off_after():
    yield
    observability.disable()


def _mark(stage, t):
    return (f"dvbt2ll_mark_{stage}", t, t + 2)


def test_segments_of_two_steps_of_two_plps():
    """Each moment of device work goes to the mark that ends its segment;
    the marks' own time apart, work after the last mark to ``rest``, and
    overlapping work counted once."""
    acts = []
    for base in (0, 1000):
        acts += [("h2d", base + 0, base + 10), _mark("start", base + 10),
                 ("gemm", base + 12, base + 40), _mark("fec", base + 40),
                 ("gather", base + 42, base + 50), _mark("map", base + 50),
                 ("gemm", base + 52, base + 70), _mark("fec", base + 70),
                 ("gather", base + 72, base + 75),
                 ("copy", base + 73, base + 80),    # overlaps the gather
                 _mark("map", base + 80),
                 ("cat", base + 82, base + 100), _mark("frames", base + 100),
                 ("tail", base + 102, base + 130), _mark("tail", base + 130),
                 ("clone", base + 132, base + 140)]
    seg = program.segments(acts, (0, 2000))
    # the first step's clone lies before the second step's start mark
    assert seg == {"start": 10 + 8 + 10, "fec": 2 * (28 + 18),
                   "map": 2 * (8 + 8), "frames": 2 * 18, "tail": 2 * 28,
                   "mark": 2 * 7 * 2, "rest": 8}
    busy = sum(e - s for _, s, e in acts) - 2 * 2    # copy/gather overlap
    assert sum(seg.values()) == busy
    # a window that ends inside the second step's second mapper: what
    # follows its last mark inside the window is rest
    seg = program.segments(acts, (0, 1075))
    assert seg["map"] == 8 + 8 + 8 and seg["rest"] == 3
    assert seg["frames"] == 18


def test_segments_without_marks_are_rest():
    assert program.segments([("k", 0, 5)], (0, 10)) == {"mark": 0,
                                                         "rest": 5}


def test_summed_children_and_handoff_lags():
    R = observability.Record
    recs = [R("compiled.wait", "mesh.step", 0, 10, 12),
            R("mesh.stage", "mesh.step", 0, 12, 20),
            R("mesh.step", None, 0, 5, 30),
            R("mesh.stage", "mesh.step", 1, 42, 45),
            R("mesh.stage", "mesh.step", 1, 46, 50),
            R("mesh.step", None, 1, 40, 60),
            R("executor.copy_done", "executor.drain", 3, 100, 100),
            R("executor.sink", "executor.step", 3, 150, 170),
            R("executor.sink", "executor.step", 4, 180, 190)]
    assert program.summed_under(recs, "mesh.step", "mesh.stage") == [
        pytest.approx(8e-9), pytest.approx(7e-9)]
    assert program.summed_under(recs, "mesh.step", "compiled.wait") == [
        pytest.approx(2e-9), 0.0]
    assert program.handoff_lags(recs) == [pytest.approx(50e-9)]


@pytest.mark.parametrize("cell,want", [("vv009.tiny_mesh", SPANS_MESH),
                                       ("vv009.tiny_paced", SPANS_PACED)])
def test_traced_cpu_run_reports_the_program_spans(checkout, cell, want):
    res, _ = program.execute(cell, SEED, 2.0, True, 0.0, root=checkout,
                             device="cpu")
    assert res["failed"] == 0
    got = set(res["metrics"]) & set(program.READERS)
    # the device segments and the copy's device time need a card
    assert got == want
    assert all(res["metrics"][m]["value"] > 0 for m in want)
    assert not observability.enabled()
    # the harness is as it was
    assert harness.parse_profile.__module__ == "txbench.harness"
    assert harness.read_metrics.__module__ == "txbench.harness"


@pytest.mark.parametrize("trace", [False, True])
def test_run_py_path_leaves_the_program_tracing_off(checkout, trace):
    """``run.py``'s own path never turns the port's tracing on: no span
    is recorded and no program reading appears."""
    observability.enable()
    observability.disable()
    res, _ = harness.execute("vv009.tiny_mesh", SEED, 1.0, trace, 0.0,
                             root=checkout, device="cpu")
    assert res["failed"] == 0
    assert not observability.enabled() and observability.records() == []
    assert not set(res["metrics"]) & set(program.READERS)
