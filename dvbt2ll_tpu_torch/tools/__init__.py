"""The port's measuring entry points: the twins of the JAX package's
``tools/roofline.py``, ``tools/bench_latency.py``,
``tools/bench_sustained.py`` and ``tools/bench_scaling.py`` (its
``bench.py`` is ``dvbt2ll_tpu_torch.bench``).

Each runs on the CUDA card unless ``--device cpu`` is passed, and exits
non-zero with a message when asked for a card that is not there.  On the
card each prints the card's name and power limit
(``profile_step.card_line``) before anything else.
"""
from __future__ import annotations

import torch


def open_device(name: str) -> torch.device:
    """The torch device ``name``; a missing CUDA device ends the program
    with a message, never a CPU run."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device "
                         f"(torch.cuda.is_available() is False); pass "
                         f"--device cpu to run on the CPU")
    return dev


def device_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    from ..profile_step import card_line
    return card_line()


def sync(dev: torch.device) -> None:
    """Wait for ``dev``'s queued work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def kernel_launches() -> dict:
    """The kernel wrappers' launch counts, as ``chip_smoke.py`` reads
    them: a tool reports the difference over its timed work."""
    from ..ops import kernel_wrappers
    return {name: f.launches for name, f in kernel_wrappers().items()}


def launches_since(before: dict) -> dict:
    now = kernel_launches()
    return {k: now[k] - before[k] for k in now}


# the host's CUDA runtime calls that a step's launches are made of
API_CALLS = ("cudaGraphLaunch", "cudaMemcpyAsync", "cudaLaunchKernel")


def host_api_calls(prof, steps: int) -> dict:
    """The host's CUDA runtime calls a step in a ``torch.profiler``
    profile of ``steps`` steps: each of ``API_CALLS``, and ``all``, every
    runtime call but the synchronisations that close a timed window.
    All 0 where the profile holds no CUDA call (the CPU)."""
    calls = {k: 0 for k in API_CALLS}
    calls["all"] = 0
    for e in prof.key_averages():
        if e.key.startswith("cuda") and "Synchronize" not in e.key:
            calls["all"] += e.count
            if e.key in calls:
                calls[e.key] += e.count
    return {k: v / steps for k, v in calls.items()}
