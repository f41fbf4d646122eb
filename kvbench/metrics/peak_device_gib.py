"""``torch.cuda.max_memory_allocated()`` from the process's start to the
window's end, in GiB; nothing on the CPU."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes > 0 else None
