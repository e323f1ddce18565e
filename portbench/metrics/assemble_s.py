"""Seconds of host word assembly over the window: the program's stage
batch_assemble (on the assembly thread, one batch behind the decode)."""

from pbcore.readers import stage_s


def read(run):
    return stage_s(run, "batch_assemble")
