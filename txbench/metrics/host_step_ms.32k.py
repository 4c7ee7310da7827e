"""host_step_ms.32k: median host time of ``Transmitter.step_window`` in
the runner ``single`` (the benchmark's span ``host_step``: the window
staged into the compiled step's pinned input, one graph launch, the
output's device copy, the carry and the frame counter), steps before the
traced part."""
import numpy as np


def read(run):
    d = run.spans.durations("host_step")
    return float(np.median(d)) * 1e3 if d else None
