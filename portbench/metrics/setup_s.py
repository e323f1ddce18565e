"""Seconds from the start of the process to the opening of the window:
the kernels loaded (built in a checkout's first run), the weights and
the audio made, the cell's graph keys warmed up."""


def read(run):
    return run.setup_s
