"""latency_p95_ms: the 95th percentile over every step of the window of
the time from when the step's last TS byte was due on the generator's
schedule to when the runtime handed the step's IQ to the sink (host
clock, ms)."""
import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(run.latencies_s, 95)) * 1e3
