"""Device milliseconds of one encoder call (one window iteration), by
CUDA events the benchmark records around the program's encode in the
traced stretch of the window."""

from pbcore.readers import encoder_ms


def read(run):
    return encoder_ms(run)
