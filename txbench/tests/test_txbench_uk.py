"""The cell ``32k.single`` (configuration ``uk_t2_32k``): the byte and
operation counts of its kernel metrics against
``dvbt2ll_tpu_torch/tools/roofline.py`` at the cell's shapes, and the
readers on made-up device activity."""
import os

import pytest

from txbench import harness, peaks
from txbench.reference.config import T2Config
from txbench.tests.conftest import REPO

BENCH = harness.benchmark(REPO)
CELL = harness.find_cell(BENCH, "32k.single")
TRAFFIC = harness.load_json(harness.bench_file(REPO, "traffic",
                                               CELL["traffic"] + ".json"))


def _metric(name):
    return harness.load_module(
        harness.bench_file(REPO, "metrics", name + ".py"),
        "txbench_metric_" + name.replace(".", "_"))


def _cfg():
    from dvbt2ll_tpu_torch.config import named_config
    return T2Config.from_dict(named_config(CELL["config"]).to_dict())


def test_cell_runs_the_configurations_smallest_strict_step():
    from dvbt2ll_tpu_torch.config import named_config
    from dvbt2ll_tpu_torch.plan import min_batch_frames
    assert CELL["chips"] == 1 and TRAFFIC["runner"] == "single"
    assert TRAFFIC["frames_per_step"] == min_batch_frames(
        named_config(CELL["config"])) == 47
    # a kept step's frame 0 and one drawn frame, 2 steps kept, the last
    # step's 2 more where it was not kept
    assert TRAFFIC["check_frames_min"] == (TRAFFIC["check_steps"]
                                           * TRAFFIC["check_frames_per_step"])
    assert os.path.exists(os.path.join(REPO, "txbench", "configs",
                                       CELL["config"] + ".json"))


def test_fec_bytes_are_the_roofline_tools_interface():
    """The FEC layer's interface at 47 frames: the roofline tool's
    ``bb_and_fec`` part (the fresh TS, the (F, nbch) bits, the codewords)
    without the bits that pass between the two kernels, and with the
    window's 187 carried bytes."""
    from dvbt2ll_tpu_torch.config import named_config
    from dvbt2ll_tpu_torch.plan import build_plan
    from dvbt2ll_tpu_torch.tools import roofline
    ours = named_config(CELL["config"])
    f = TRAFFIC["frames_per_step"]
    plan = build_plan(ours, f, strict=True)
    parts = {r[0]: r for r in roofline.part_traffic(ours, plan, f, False)}
    fec_part = parts["bb_and_fec"][2]
    got = _metric("fec_roofline.32k").interface_bytes(_cfg(), f, 1)
    assert got == fec_part - plan.fec_frames * ours.nbch + 187
    assert got == 187 + 50982780 + 9494 * 64800


def test_fft_bound_is_the_roofline_tools_tail():
    from dvbt2ll_tpu_torch.tools import roofline
    cfg, f = _cfg(), TRAFFIC["frames_per_step"]
    s, fft, gi = cfg.num_symbols, cfg.fft_points, cfg.guard_samples
    assert (s, fft, gi) == (60, 32768, 256)
    assert peaks.tail_bytes(cfg, f) == roofline.tail_kernel_bytes(f, s, fft,
                                                                  gi)
    assert peaks.fft_flops(f, s, fft) == roofline.fft_flops(f, s, fft)
    # bytes bind, not operations
    assert (peaks.bound_s(peaks.tail_bytes(cfg, f))
            > peaks.fft_flops(f, s, fft) / peaks.FP32_FLOP_PER_S)


def test_ldpc_bytes_are_the_kernels_at_the_cells_step():
    """``ldpc_roofline`` at 32k.single: 9494 FEC frames a step, each
    nbch bits read and a 64800-bit codeword written, a byte a bit, as
    ``chip_smoke.py`` bounds the kernel."""
    from dvbt2ll_tpu_torch.config import named_config
    ours = named_config(CELL["config"])
    fec = TRAFFIC["frames_per_step"] * ours.fec_blocks
    assert fec == 9494
    assert peaks.ldpc_bytes(_cfg(), fec) == fec * (ours.nbch
                                                   + ours.ldpc_frame_bits)
    assert peaks.ldpc_bytes(_cfg(), fec) == 9494 * (43200 + 64800)


def test_cell_reports_the_device_and_kernel_metrics():
    """Beside its own, the cell reports the accepted metrics whose readers
    find something in a single-transmitter run."""
    names = {m["name"] for m in harness.cell_metrics(BENCH, "32k.single",
                                                     "per_layer")}
    assert names == {"device_step_ms", "ldpc_roofline", "device_idle_pct",
                     "peak_mem_gib", "fft_roofline.32k", "fec_roofline.32k",
                     "host_step_ms.32k"}


class _Run:
    """What the readers take of a finished run."""

    def __init__(self, trace, spans=None):
        self.trace, self.ref_cfg = trace, _cfg()
        self.card_frames, self.chips = TRAFFIC["frames_per_step"], 1
        self.spans = spans


def _trace(acts, steps=2):
    return harness.Trace({0: acts}, [], (0, 10**9), steps)


@pytest.mark.parametrize("name", ["fft_roofline.32k", "fec_roofline.32k",
                                  "device_step_ms", "ldpc_roofline"])
def test_readers_find_nothing_without_a_trace_or_their_kernels(name):
    read = _metric(name).read
    assert read(_Run(None)) is None
    if name != "device_step_ms":
        assert read(_Run(_trace([("elementwise", 0, 10**6)]))) is None


def test_fft_reader_reads_nothing_where_cufft_runs_other_kernels():
    """A plan that splits the transform over kernels of other names would
    be timed only in part; the stage mark ``dvbt2ll_mark_ifft`` is not
    such a kernel."""
    ms = 10**6
    fft = ("void vector_fft<32768u, EPT<32u>, 1u, 0u>", 0, ms)
    read = _metric("fft_roofline.32k").read
    assert read(_Run(_trace([fft, ("dvbt2ll_mark_ifft", ms, ms + 10)])))
    assert read(_Run(_trace([fft, ("void regular_fft<2048u>", ms,
                                   2 * ms)]))) is None


def test_host_step_reader_takes_the_median_before_the_traced_part():
    spans = harness.Spans(False)
    spans.spans["host_step"] = [(0.0, 0.012), (1.0, 1.011), (2.0, 2.015),
                                (3.0, 3.5)]
    spans.mark = 2.5
    read = _metric("host_step_ms.32k").read
    assert read(_Run(None, spans)) == pytest.approx(12.0)
    assert read(_Run(None, harness.Spans(False))) is None


def test_readers_on_made_up_activity():
    """Two steps: cuFFT's kernels 1.5 ms, the FEC kernels 1.2 ms (LDPC
    0.2), marks and other kernels not counted; the busy time a step."""
    ms = 10**6
    acts = [("dvbt2ll_mark_fec", 0, ms // 100),
            ("_anonymous_namespace_::bb_bch_kernel(unsigned char", ms, 2 * ms),
            ("ldpc_codeword_kernel", 2 * ms, 2 * ms + ms // 5),
            ("void vector_fft<32768u, EPT<32u>, 1u, 0u>", 3 * ms, 4 * ms),
            ("void vector_fft<32768u, EPT<32u>, 1u, 0u>", 4 * ms,
             4 * ms + ms // 2),
            ("dvbt2ll_mark_ifft", 5 * ms, 5 * ms + ms // 100),
            ("Memcpy DtoD (Device -> Device)", 6 * ms, 8 * ms)]
    run = _Run(_trace(acts))
    cfg, f = run.ref_cfg, 2 * TRAFFIC["frames_per_step"]
    want = peaks.share_pct(peaks.tail_bytes(cfg, f), 0.0, 1.5e-3)
    assert _metric("fft_roofline.32k").read(run) == pytest.approx(want)
    fec = _metric("fec_roofline.32k")
    want = peaks.share_pct(fec.interface_bytes(cfg, f, 2), 0.0, 1.2e-3)
    assert fec.read(run) == pytest.approx(want)
    want = peaks.share_pct(peaks.ldpc_bytes(cfg, f * cfg.fec_blocks), 0.0,
                           0.2e-3)
    assert _metric("ldpc_roofline").read(run) == pytest.approx(want)
    busy = (1 + 0.2 + 1 + 0.5 + 2) * ms + 2 * (ms // 100)
    assert _metric("device_step_ms").read(run) == pytest.approx(
        busy * 1e-6 / 2)
