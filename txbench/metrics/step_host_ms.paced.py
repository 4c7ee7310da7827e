"""step_host_ms.paced: median host time of ``StreamingExecutor.step``
less the time its source waited for TS (ingest window, validate_ts, the
step, the copy's enqueue, the previous step's drain and sink hand-off),
steps before the traced part."""
import numpy as np


def read(run):
    d = run.per_step.get("step_host")
    return float(np.median(d)) * 1e3 if d else None
