"""Seconds over the window of the program's stage batch_mel: the batch's
mel on the critical path, or the wait for the prefetched one."""

from pbcore.readers import stage_s


def read(run):
    return stage_s(run, "batch_mel")
