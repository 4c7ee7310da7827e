"""device_idle_pct: share of the traced window in which no kernel, copy
or set ran on the card; on several cards the idlest (torch.profiler)."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.devices:
        return None
    cards = [d.index or 0 for d in run.devices]
    return max(100.0 * (1.0 - tr.busy_s(c) / tr.window_s) for c in cards)
