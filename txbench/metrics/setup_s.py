"""setup_s: seconds from the process's start to the window's: torch
imported, the kernels built or loaded, the plan, the graph captures, the
TS pool and the warm-up steps (host clock)."""


def read(run):
    return run.setup_s
