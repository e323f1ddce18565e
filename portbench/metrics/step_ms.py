"""Milliseconds a decode step over the window: the program's stage
decode_loop (each captured chunk of steps ends in a host sync) over its
count decode_steps."""

from pbcore.readers import step_ms


def read(run):
    return step_ms(run)
