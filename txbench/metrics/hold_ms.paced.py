"""hold_ms.paced: median time from the end of the ``StreamingExecutor.step``
call that enqueued a step to the hand-off of that step's IQ to the sink,
steps before the traced part (host clock)."""
import numpy as np


def read(run):
    d = run.per_step.get("hold")
    return float(np.median(d)) * 1e3 if d else None
