"""peak_mem_gib: the device memory that PyTorch's caching allocator held
at its peak over the run, graph pools included
(``torch.cuda.max_memory_reserved``), on the fullest card."""


def read(run):
    if not run.memory_peak_bytes:
        return None
    return run.memory_peak_bytes / 2**30
