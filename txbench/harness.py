"""The benchmark's loop: one run of one cell, driven by data.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Its
``config`` names ``configs/<config>.json`` (the port's ``T2Config``
fields, the source, the limits of the output check), its ``traffic``
names ``traffic/<traffic>.json`` (the runner and its parameters), the
runner is ``runners/<runner>.py``, and every metric is read by
``metrics/<metric>.py``.  A later cell, configuration, traffic mix or
metric is a new file; nothing here names one.

A run: set-up (the runner builds the port's object and warms it up),
the window (the runner measures for ``seconds``; with ``trace`` it also
profiles a steady part), then, after the window, the device's memory
peak, the program's state freed, the output check against the
reference, the metrics, and the module check.  With ``control`` the
frames kept from the window are replaced by the control's before the
check (``put_control``), which must then find them not correct.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import os
import sys
import time
from collections import defaultdict
from typing import Optional

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "dvbt2ll_tpu")
SPAN_PREFIX = "txb:"
NAME_LEN = 96            # a device op's name in the breakdown


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``:
    ``dvbt2ll_tpu_torch`` is not ``dvbt2ll_tpu``."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def bench_file(root: str, *parts: str) -> str:
    """A file under the benchmark's folder of the checkout at ``root``."""
    return os.path.join(root, os.path.basename(BENCH_DIR), *parts)


def load_module(path: str, name: str):
    """The Python file ``path`` as a module (metric and runner files are
    named after metrics, whose names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those whose ``workloads`` list it, or that have no
    such list."""
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]


# ---------------------------------------------------------------- spans
class Spans:
    """The benchmark's own spans, kept in memory: name -> [(start, end)]
    on ``time.perf_counter``.  While tracing, each is also a
    ``torch.profiler.record_function`` range named ``txb:<name>``, so the
    trace's idle gaps can be set against what the host was doing."""

    def __init__(self, annotate: bool):
        self.annotate = annotate
        self.spans = defaultdict(list)
        self.mark = None         # perf_counter at the traced part's start

    @contextlib.contextmanager
    def span(self, name: str):
        if self.annotate:
            import torch
            rf = torch.profiler.record_function(SPAN_PREFIX + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if self.annotate:
                rf.__exit__(None, None, None)
            self.spans[name].append((t0, t1))

    def durations(self, name: str) -> list:
        """Seconds of each ``name`` span that ended before the traced
        part began (the profiler slows the host)."""
        end = self.mark if self.mark is not None else float("inf")
        return [b - a for a, b in self.spans.get(name, []) if b <= end]


# ---------------------------------------------------------------- trace
@dataclasses.dataclass
class Trace:
    """Device activity of the traced part: per card index a list of
    (name, start_ns, end_ns) of every kernel, copy and set, the host's
    ``txb:`` ranges, the traced window (start_ns, end_ns) and the steps
    it holds."""
    devices: dict
    host: list
    window: tuple
    steps: int

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self, dev: int) -> list:
        """The card's merged busy intervals inside the window."""
        lo, hi = self.window
        iv = sorted((max(s, lo), min(e, hi))
                    for _, s, e in self.devices.get(dev, [])
                    if e > lo and s < hi)
        out = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self, dev: int) -> float:
        return sum(e - s for s, e in self.busy_intervals(dev)) * 1e-9

    def kernel_s(self, dev: int, match) -> float:
        """Seconds of the card's activities whose name ``match`` takes."""
        return sum(e - s for n, s, e in self.devices.get(dev, [])
                   if match(n)) * 1e-9

    def breakdown(self) -> dict:
        """The ten device ops that took most time (summed over the cards)
        and the ten longest idle gaps by the host range that covered
        them ("none" where no ``txb:`` range did)."""
        ops = defaultdict(float)
        for acts in self.devices.values():
            for n, s, e in acts:
                ops[n[:NAME_LEN]] += (e - s) * 1e-9
        gaps = defaultdict(float)
        host = sorted(self.host, key=lambda h: h[1])
        for dev in self.devices:
            busy = self.busy_intervals(dev)
            edges = ([self.window[0]] + [x for iv in busy for x in iv]
                     + [self.window[1]])
            for a, b in zip(edges[0::2], edges[1::2]):
                if b > a:
                    gaps[_covering(host, (a + b) / 2)] += (b - a) * 1e-9
        top = lambda d: sorted(([k, v] for k, v in d.items()),
                               key=lambda kv: -kv[1])[:10]
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def _covering(host: list, t: float) -> str:
    """The innermost (latest-starting) host range covering time t."""
    best = "none"
    for name, s, e in host:
        if s > t:
            break
        if e >= t:
            best = name
    return best


def _ns(e, which: str) -> int:
    f = getattr(e, f"{which}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{which}_us")()
                                              * 1000)


def parse_profile(prof, steps: int) -> Trace:
    """A stopped ``torch.profiler.profile`` -> ``Trace``.  The window is
    the host range ``txb:traced``."""
    devices, host = defaultdict(list), []
    window = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        if str(e.device_type()).endswith("CUDA"):
            # the device copy of a host range is no device work
            if not name.startswith(SPAN_PREFIX):
                devices[int(e.device_index())].append((name, start, end))
        elif name.startswith(SPAN_PREFIX):
            if name == SPAN_PREFIX + "traced":
                window = (start, end)
            else:
                host.append((name[len(SPAN_PREFIX):], start, end))
    if window is None:
        raise RuntimeError("the trace holds no txb:traced range")
    return Trace(dict(devices), host, window, steps)


def warm_profiler(run: "Run") -> None:
    """Start and stop ``torch.profiler`` once in set-up: its first start
    loads and initialises CUPTI, which takes seconds."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if run.on_cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        torch.ones(1, device=run.devices[0]).add_(1)
        run.sync()


class Profiled:
    """The traced part of a window: ``start()`` waits for the cards,
    starts ``torch.profiler`` (host and CUDA activity) and opens the
    ``txb:traced`` range; ``stop(steps)`` waits for the cards again,
    closes both and keeps the parsed ``Trace``."""

    def __init__(self, run: "Run"):
        self.run = run
        self.prof = self.rf = None

    def start(self) -> None:
        import torch
        self.run.sync()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.run.on_cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.rf = torch.profiler.record_function(SPAN_PREFIX + "traced")
        self.rf.__enter__()
        self.run.spans.mark = time.perf_counter()

    def stop(self, steps: int) -> None:
        self.run.sync()
        self.rf.__exit__(None, None, None)
        self.prof.stop()
        self.run.trace = parse_profile(self.prof, steps)
        self.prof = None


# ---------------------------------------------------------------- checks
class Reservoir:
    """A uniform sample, drawn from the seed, of the frames due in the
    window: every step offers ``per_step`` frames picked from the seed,
    the first of them a mux's frame 0, the one frame whose bytes the
    carried stream state (the 187 bytes before the step) reaches;
    ``keep`` steps are kept (reservoir sampling), and the window's last
    step is always added.  ``fetch(picks)`` makes a kept step's copy of
    its frames (a device copy, read back after the window)."""

    def __init__(self, gen: np.random.Generator, keep: int, per_step: int,
                 n_mux: int, frames: int):
        self.gen, self.keep, self.per_step = gen, keep, per_step
        self.n_mux, self.frames = n_mux, frames
        self.kept = []           # [(step, picks, frames)]
        self.seen = 0

    def picks(self) -> list:
        """``per_step`` distinct (mux, frame of the step) pairs, the
        first with frame 0."""
        first = int(self.gen.integers(0, self.n_mux))
        rest = [i for i in self.gen.choice(
            self.n_mux * self.frames, self.per_step, replace=False)
            if i != first * self.frames][:self.per_step - 1]
        return [(first, 0)] + [(int(i) // self.frames, int(i) % self.frames)
                               for i in rest]

    def offer(self, step: int, fetch) -> None:
        picks = self.picks()
        if len(self.kept) < self.keep:
            self.kept.append((step, picks, fetch(picks)))
        else:
            j = int(self.gen.integers(0, self.seen + 1))
            if j < self.keep:
                self.kept[j] = (step, picks, fetch(picks))
        self.seen += 1

    def last(self, step: int, fetch) -> None:
        if not any(s == step for s, _, _ in self.kept):
            picks = self.picks()
            self.kept.append((step, picks, fetch(picks)))


# ---------------------------------------------------------------- the run
@dataclasses.dataclass
class Run:
    """One run of one cell: its inputs, and what the runner measured."""
    cell: dict
    traffic: dict
    config: dict
    seed: int
    seconds: float
    trace_on: bool
    devices: list
    t_start: float
    spans: Spans = None
    cfg: object = None           # the port's T2Config
    ref_cfg: object = None       # the reference's T2Config
    setup_s: float = 0.0
    window_s: float = 0.0
    samples: int = 0             # IQ samples completed in the window
    card_frames: int = 0         # T2 frames a card a step
    attempted: int = 0
    failed: int = 0
    latencies_s: list = dataclasses.field(default_factory=list)
    per_step: dict = dataclasses.field(
        default_factory=lambda: defaultdict(list))
    trace: Optional[Trace] = None
    memory_peak_bytes: int = 0
    checked: list = dataclasses.field(default_factory=list)
    stream: object = None        # stream(mux, start, stop) -> TS bytes
    notes: list = dataclasses.field(default_factory=list)
    marks: list = dataclasses.field(default_factory=list)

    def mark(self, phase: str) -> None:
        """End of a phase of set-up, on the clock of ``t_start``."""
        self.marks.append((phase, time.perf_counter()))

    def setup_note(self) -> str:
        """Seconds of each phase of set-up, in order."""
        t, parts = self.t_start, []
        for phase, at in self.marks:
            parts.append(f"{phase} {at - t:.3f}")
            t = at
        return "setup phases (s): " + ", ".join(parts)

    @property
    def on_cuda(self) -> bool:
        return self.devices[0].type == "cuda"

    @property
    def chips(self) -> int:
        return len(self.devices)

    def sync(self) -> None:
        if self.on_cuda:
            import torch
            for d in self.devices:
                torch.cuda.synchronize(d)


def _open_devices(chips: int, device: Optional[str]) -> list:
    import torch
    if device is not None:
        return [torch.device(device)] * chips
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is "
                         "False): the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell asks for {chips} cards; "
                         f"{torch.cuda.device_count()} visible")
    return [torch.device("cuda", i) for i in range(chips)]


def make_run(root: str, cell_name: str, seed: int, seconds: float,
             trace: bool, t_start: float, device: Optional[str]) -> Run:
    bench = benchmark(root)
    cell = find_cell(bench, cell_name)
    traffic = load_json(bench_file(root, "traffic", cell["traffic"] + ".json"))
    config = load_json(bench_file(root, "configs", cell["config"] + ".json"))
    devices = _open_devices(cell["chips"], device)
    from dvbt2ll_tpu_torch.config import T2Config
    from .reference.config import T2Config as RefConfig
    run = Run(cell=cell, traffic=traffic, config=config, seed=seed,
              seconds=seconds, trace_on=trace, devices=devices,
              t_start=t_start, spans=Spans(trace),
              cfg=T2Config.from_dict(config["t2config"]),
              ref_cfg=RefConfig.from_dict(config["t2config"]))
    run.mark("imports")
    if run.on_cuda:
        # the port's native kernels, built on a checkout's first run and
        # loaded from its build directory after
        from dvbt2ll_tpu_torch.ops import _build
        _build.library()
        run.mark("kernels")
    return run


def put_control(run: Run) -> None:
    """The control of the output check, in the program's place: each
    frame kept from the window becomes the reference's frame at the same
    place in the stream, worked out with its inverse transform in TF32
    (``reference.frames.tf32_ifft``), the precision below the float32
    of the configuration's complex64 IQ.  ``correct`` must come out
    false."""
    from .reference.frames import t2_frame, tf32_ifft
    run.checked = [
        (mux, g, t2_frame(run.ref_cfg,
                          lambda a, b, m=mux: run.stream(m, a, b), g,
                          tf32_ifft))
        for mux, g, _ in run.checked]
    run.notes.append("control: the kept frames are the reference's with "
                     "its inverse transform in TF32")


def check_outputs(run: Run) -> dict:
    """Every kept frame against the reference frame worked out from the
    same TS: the worst relative error, the frames checked, the failed
    mux-steps, each beside its limit."""
    from .reference.frames import rel_err, t2_frame
    worst = 0.0
    for mux, g, iq in run.checked:
        ref = t2_frame(run.ref_cfg, lambda a, b, m=mux: run.stream(m, a, b),
                       g)
        worst = max(worst, rel_err(iq, ref))
    lim = run.config["limits"]
    return {
        "iq_rel_err_max": {"value": worst, "limit": lim["iq_rel_err_max"]},
        "frames_checked": {"value": len(run.checked),
                           "limit": run.traffic["check_frames_min"]},
        "failed": {"value": run.failed, "limit": 0},
    }


def is_correct(checks: dict) -> bool:
    c = checks
    return (c["iq_rel_err_max"]["value"] <= c["iq_rel_err_max"]["limit"]
            and c["frames_checked"]["value"] >= c["frames_checked"]["limit"]
            and c["failed"]["value"] <= c["failed"]["limit"])


def read_metrics(run: Run, root: str, metrics: list) -> dict:
    out = {}
    for m in metrics:
        mod = load_module(bench_file(root, "metrics", m["name"] + ".py"),
                          "txbench_metric_" + m["name"].replace(".", "_"))
        value = mod.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_block(run: Run) -> dict:
    import torch
    d = {"platform": "gpu" if run.on_cuda else run.devices[0].type,
         "kind": (torch.cuda.get_device_name(run.devices[0])
                  if run.on_cuda else "cpu"),
         "count": run.chips,
         "memory_peak_bytes": run.memory_peak_bytes}
    if run.trace is not None:
        d["busy_s"] = (sum(run.trace.busy_s(i.index or 0)
                           for i in run.devices) / run.chips
                       if run.on_cuda else 0.0)
        d["window_s"] = run.trace.window_s
    return d


def execute(cell_name: str, seed: int, seconds: float, trace: bool,
            t_start: float, root: str = ROOT,
            device: Optional[str] = None, control: bool = False) -> tuple:
    """One run; returns (result line dict, check lines).  ``device``
    (tests only) puts every chip of the cell on that torch device
    instead of the CUDA cards; ``control`` checks the control's frames
    in place of the program's (``put_control``)."""
    run = make_run(root, cell_name, seed, seconds, trace, t_start, device)
    if trace:
        warm_profiler(run)
        run.mark("profiler")
    runner = load_module(
        bench_file(root, "runners", run.traffic["runner"] + ".py"),
        "txbench_runner_" + run.traffic["runner"]).Runner(run)
    try:
        runner.window()
        if run.on_cuda:
            import torch
            run.memory_peak_bytes = max(torch.cuda.max_memory_reserved(d)
                                        for d in run.devices)
    finally:
        runner.close()
    del runner
    run.notes.append(run.setup_note())
    if control:
        put_control(run)
    bench = benchmark(root)
    kind = "per_layer" if trace else "end_to_end"
    metrics = read_metrics(run, root, cell_metrics(bench, cell_name, kind))
    checks = check_outputs(run)
    result = {"correct": is_correct(checks), "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics,
              "device": device_block(run)}
    if trace and run.trace is not None and run.on_cuda:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    lines = [f"{k} {v['value']!r} limit {v['limit']!r}"
             for k, v in checks.items()]
    return result, run.notes + lines


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="txbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="check the control's frames in the program's "
                         "place; the run must come out not correct")
    a = ap.parse_args(argv)
    result, lines = execute(a.workload, a.seed, a.seconds, bool(a.trace),
                            t_start, control=bool(a.control))
    found = forbidden_modules(sys.modules)
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
