"""torch.cuda.max_memory_allocated() over the window, reset at its start,
in GiB."""


def read(run):
    return run.peak_bytes / 2**30
