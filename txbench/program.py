"""The port's own tracing read for the benchmark: its spans, its stage
marks and its copy-done instants (``dvbt2ll_tpu_torch.observability``).

    python3 txbench/program.py --workload CELL --seed N --seconds S \\
        --trace 0|1

runs one cell as ``run.py`` does, with the port's tracing turned on
before the runner builds anything, so that the steps it captures carry
the stage marks (``run.py`` is the same run with the tracing off).  With
``--trace 0`` the result line holds the end-to-end metrics, as
``run.py``'s, read with the program's tracing on: set beside
``run.py``'s, they give what the tracing costs.  With ``--trace 1`` it
also holds every reading of ``READERS`` that found something, each
segment of the busiest card's step (``segment_ms.<stage>``,
``segment_ms.rest`` after the last mark), the marks' own device time
(``mark_ms``) and the median of each span (``span_ms.<name>``); and the
breakdown's idle gaps are named by the program's spans (``tx:`` ranges)
where one covered them.  For that ``execute`` wraps the harness's profile parser and
metric reader for the run, and ``run.py``'s own path is left as it is.

The readers, each a function of the finished run:
- ``fec_device_ms``, ``map_device_ms``, ``frames_device_ms``: the card's
  busy time, marks excluded, in the segments that end in a ``fec``,
  ``map`` or ``frames`` mark (``segments``), on the busiest card, over
  the steps traced (ms a step, as ``device_step_ms``);
- ``mesh_stage_ms``, ``mesh_wait_ms``: median over ``mesh.step`` spans of
  the summed ``mesh.stage`` or ``compiled.wait`` spans inside it;
- ``stage_ms.paced``, ``copy_ms.paced``, ``drain_ms.paced``,
  ``sink_ms.paced``: median ``transmitter.step``, ``executor.copy``,
  ``executor.drain``, ``executor.sink`` span;
- ``handoff_lag_ms.paced``: median over steps of the start of the
  ``executor.sink`` span that hands step k's IQ off, less the instant
  ``executor.copy_done`` of step k (when its copy to the host completed
  on the card, on the host's clock).
Spans and instants count only between the window's start and the traced
part's (the profiler slows the host), as the benchmark's own spans do.
A program without the tracing gives no records, and every reader None.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

import numpy as np  # noqa: E402

PROGRAM_PREFIX = "tx:"           # the port's profiler ranges
MARK_PREFIX = "dvbt2ll_mark_"    # its mark kernels: dvbt2ll_mark_<stage>


# ---------------------------------------------------------------- spans
def program_records(run) -> list:
    """The port's records that ended inside the window before the traced
    part began; [] where the port records none."""
    try:
        from dvbt2ll_tpu_torch import observability
        recs = observability.records()
    except (ImportError, AttributeError):
        return []
    lo = (run.t_start + run.setup_s) * 1e9
    hi = run.spans.mark * 1e9 if run.spans.mark is not None else np.inf
    return [r for r in recs if lo <= r.t1_ns <= hi]


def _ms(seconds: list):
    return float(np.median(seconds)) * 1e3 if seconds else None


def span_seconds(recs: list, name: str) -> list:
    return [(r.t1_ns - r.t0_ns) * 1e-9 for r in recs if r.name == name]


def summed_under(recs: list, root: str, child: str) -> list:
    """For each ``root`` span, the seconds of its ``child`` spans (those
    whose parent is ``root`` and that lie within its time) added up."""
    kids = sorted((r.t0_ns, r.t1_ns) for r in recs
                  if r.name == child and r.parent == root)
    starts = [k[0] for k in kids]
    out = []
    for r in recs:
        if r.name != root:
            continue
        i = bisect.bisect_left(starts, r.t0_ns)
        total = 0
        while i < len(kids) and kids[i][1] <= r.t1_ns:
            total += kids[i][1] - kids[i][0]
            i += 1
        out.append(total * 1e-9)
    return out


def handoff_lags(recs: list) -> list:
    """Seconds from each step's copy done on the card to the start of the
    sink span that hands its IQ off."""
    done = {r.step: r.t0_ns for r in recs if r.name == "executor.copy_done"}
    return [(r.t0_ns - done[r.step]) * 1e-9 for r in recs
            if r.name == "executor.sink" and r.step in done]


# ---------------------------------------------------------------- marks
def mark_stage(name: str):
    """The stage a device activity's name marks, or None."""
    return name[len(MARK_PREFIX):] if name.startswith(MARK_PREFIX) else None


def segments(acts: list, window: tuple) -> dict:
    """Busy ns of one card's activities ``acts`` ((name, start_ns,
    end_ns)) inside ``window``, by the mark that ends each segment: a
    moment belongs to the first mark that starts at or after it, and the
    time after the last mark to ``rest``.  The marks' own time is
    ``mark``."""
    lo, hi = window
    marks = sorted((s, mark_stage(n), e) for n, s, e in acts
                   if mark_stage(n) is not None and e > lo and s < hi)
    iv = sorted((max(s, lo), min(e, hi)) for n, s, e in acts
                if mark_stage(n) is None and e > lo and s < hi)
    busy = []
    for s, e in iv:
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    starts = [m[0] for m in marks]
    out = defaultdict(int)
    out["mark"] = sum(min(e, hi) - max(s, lo) for s, _, e in marks)
    for a, b in busy:
        i = bisect.bisect_left(starts, a)
        while a < b:
            end = min(b, starts[i]) if i < len(starts) else b
            out[marks[i][1] if i < len(starts) else "rest"] += end - a
            a, i = end, i + 1
    return dict(out)


def stage_ms(run) -> dict:
    """``segments`` of the busiest card in ms a traced step; {} without a
    trace or without marks in it."""
    tr = run.trace
    if tr is None or not tr.steps or not tr.devices:
        return {}
    card = max(tr.devices, key=tr.busy_s)
    seg = segments(tr.devices[card], tr.window)
    if set(seg) <= {"mark", "rest"}:
        return {}
    return {k: v * 1e-6 / tr.steps for k, v in seg.items()}


READERS = {
    "fec_device_ms": lambda run: stage_ms(run).get("fec"),
    "map_device_ms": lambda run: stage_ms(run).get("map"),
    "frames_device_ms": lambda run: stage_ms(run).get("frames"),
    "mesh_stage_ms": lambda run: _ms(summed_under(
        program_records(run), "mesh.step", "mesh.stage")),
    "mesh_wait_ms": lambda run: _ms(summed_under(
        program_records(run), "mesh.step", "compiled.wait")),
    "stage_ms.paced": lambda run: _ms(span_seconds(
        program_records(run), "transmitter.step")),
    "copy_ms.paced": lambda run: _ms(span_seconds(
        program_records(run), "executor.copy")),
    "drain_ms.paced": lambda run: _ms(span_seconds(
        program_records(run), "executor.drain")),
    "sink_ms.paced": lambda run: _ms(span_seconds(
        program_records(run), "executor.sink")),
    "handoff_lag_ms.paced": lambda run: _ms(handoff_lags(
        program_records(run))),
}


def read_program(run) -> dict:
    """Every reader's value that is not None, then each segment and the
    marks' own time (ms a step), then the median of every span by name
    (``span_ms.<name>``), as result-line metrics."""
    out = {}
    for name, read in READERS.items():
        v = read(run)
        if v is not None:
            out[name] = {"value": v, "unit": "ms"}
    for k, v in sorted(stage_ms(run).items()):
        out["mark_ms" if k == "mark" else "segment_ms." + k] = {
            "value": v, "unit": "ms"}
    recs = program_records(run)
    for name in sorted({r.name for r in recs if r.t1_ns > r.t0_ns}):
        out["span_ms." + name] = {"value": _ms(span_seconds(recs, name)),
                                  "unit": "ms"}
    return out


# ---------------------------------------------------------------- the run
def with_program_ranges(tr, prof):
    """A ``Trace`` parsed by ``harness.parse_profile`` from ``prof``, with
    the port's ranges: the host copy of each ``tx:`` range joins the
    trace's host ranges under its own name (``tx:executor.read``, ...),
    and its device copy, like the benchmark's own, is no device work."""
    from txbench import harness
    tr.devices = {d: [a for a in acts if not a[0].startswith(PROGRAM_PREFIX)]
                  for d, acts in tr.devices.items()}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if (name.startswith(PROGRAM_PREFIX)
                and not str(e.device_type()).endswith("CUDA")):
            start = harness._ns(e, "start")
            tr.host.append((name, start, start + harness._ns(e, "duration")))
    return tr


def execute(cell: str, seed: int, seconds: float, trace: bool,
            t_start: float, **kw) -> tuple:
    """``harness.execute`` with the port's tracing on from before the
    runner is built; a traced run's trace takes the port's ranges
    (``with_program_ranges``) and its metrics the program's readings
    (``read_program``).  The harness is as it was afterwards."""
    from dvbt2ll_tpu_torch import observability
    from txbench import harness
    parse, read = harness.parse_profile, harness.read_metrics
    harness.parse_profile = lambda prof, steps: with_program_ranges(
        parse(prof, steps), prof)

    def read_metrics(run, root, metrics):
        out = read(run, root, metrics)
        if run.trace_on:
            out.update(read_program(run))
        return out
    harness.read_metrics = read_metrics
    observability.enable()
    try:
        return harness.execute(cell, seed, seconds, trace, t_start, **kw)
    finally:
        harness.parse_profile, harness.read_metrics = parse, read
        observability.disable()


def main(argv, t_start: float) -> int:
    from txbench import harness
    ap = argparse.ArgumentParser(prog="txbench/program.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    result, lines = execute(a.workload, a.seed, a.seconds, bool(a.trace),
                            t_start)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    sys.exit(main(sys.argv[1:], T_START))
