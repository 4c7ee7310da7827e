"""Device time a step: every kernel, copy and set on the card in the
traced part over the steps traced, on the busiest card (torch.profiler,
ms).  The benchmark's consumer, one sum over the step's IQ, is in it."""


def read(run):
    tr = run.trace
    if tr is None or not tr.steps or not tr.devices:
        return None
    return max(tr.busy_s(d) for d in tr.devices) / tr.steps * 1e3
