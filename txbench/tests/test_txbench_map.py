"""``map_roofline``: its byte count against
``dvbt2ll_tpu_torch/tools/roofline.py``'s mapper row at both closed-loop
cells' steps, and its reader on made-up device activity: nothing without
a ``qam_map`` kernel, the exact share with one."""
import pytest

from txbench import harness, peaks
from txbench.reference.config import T2Config
from txbench.tests.conftest import REPO

BENCH = harness.benchmark(REPO)
# the cell, its configuration's FEC frames a card a step, and the bytes
# the mapper moves a step (codewords read, 8-byte cells written)
CELLS = {"vv009.mux8": (6016, 6016 * (16200 + 2025 * 8)),
         "32k.single": (9494, 9494 * (64800 + 8100 * 8))}


def _metric():
    return harness.load_module(
        harness.bench_file(REPO, "metrics", "map_roofline.py"),
        "txbench_metric_map_roofline")


def _cfg(cell):
    from dvbt2ll_tpu_torch.config import named_config
    name = harness.find_cell(BENCH, cell)["config"]
    return T2Config.from_dict(named_config(name).to_dict())


class _Run:
    """What the reader takes of a finished run: a step's T2 frames on
    one card, as the cell's runner sets them."""

    def __init__(self, cell, trace):
        self.trace, self.ref_cfg, self.chips = trace, _cfg(cell), 1
        self.card_frames = CELLS[cell][0] // self.ref_cfg.fec_blocks


def _trace(acts, steps=2):
    return harness.Trace({0: acts}, [], (0, 10**9), steps)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_bytes_are_the_roofline_tools_mapper_row(cell):
    from dvbt2ll_tpu_torch.config import named_config
    from dvbt2ll_tpu_torch.plan import build_plan
    from dvbt2ll_tpu_torch.tools import roofline
    fec, want = CELLS[cell]
    run = _Run(cell, None)
    assert _metric().map_bytes(run.ref_cfg, fec) == want
    # the tool at one T2 frame, scaled: it sums the PLPs' FEC frames
    ours = named_config(harness.find_cell(BENCH, cell)["config"])
    plan = build_plan(ours, 1, strict=False)
    parts = {r[0]: r for r in roofline.part_traffic(ours, plan, 1,
                                                    False)}
    assert parts["mapper"][2] * run.card_frames == want


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_reader_finds_nothing_without_the_kernel(cell):
    read = _metric().read
    assert read(_Run(cell, None)) is None
    assert read(_Run(cell, _trace([], steps=0))) is None
    ms = 10**6
    others = [("void at::native::index_elementwise_kernel<128, 4>", 0, ms),
              ("ldpc_codeword_kernel", ms, 2 * ms),
              ("dvbt2ll_mark_map", 2 * ms, 2 * ms + 10)]
    assert read(_Run(cell, _trace(others))) is None


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_reader_takes_the_kernels_time(cell):
    """Two steps, the kernel 0.5 ms in each, beside kernels and a mark
    that are not counted: the share is two steps' bytes over 1 ms at
    3.35 TB/s."""
    ms = 10**6
    acts = [("void (anonymous namespace)::qam_map_kernel<8>(unsigned char "
             "const*, unsigned int const*, float*, float*, int, int, int, "
             "int, float, float, float)", 0, ms // 2),
            ("dvbt2ll_mark_map", ms // 2, ms // 2 + 10),
            ("void (anonymous namespace)::qam_map_kernel<8>(...)", ms,
             ms + ms // 2),
            ("ldpc_codeword_kernel", 2 * ms, 3 * ms)]
    got = _metric().read(_Run(cell, _trace(acts)))
    want = 100.0 * 2 * CELLS[cell][1] / peaks.HBM_BYTES_PER_S / 1e-3
    assert got == pytest.approx(want, rel=1e-12)
    assert got == pytest.approx(peaks.share_pct(2 * CELLS[cell][1], 0.0,
                                                1e-3))
