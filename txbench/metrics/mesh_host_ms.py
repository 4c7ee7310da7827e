"""mesh_host_ms: median host time of ``ShardedTransmitter.step_device``
(the benchmark's span ``mesh_host``: halo staging into the pinned rows,
the copies and a graph launch a card), steps before the traced part."""
import numpy as np


def read(run):
    d = run.spans.durations("mesh_host")
    return float(np.median(d)) * 1e3 if d else None
