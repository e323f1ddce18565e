"""Model FLOPs of the window rows the window completed (pbcore/work.py;
only the rows of streams still live in each window iteration, as the
program's window bookkeeping lists them) over the window's length times
the bf16 peak, in %."""

from pbcore.readers import mfu


def read(run):
    return mfu(run)
