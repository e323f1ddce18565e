"""Share of the traced stretch of the window in which no kernel or copy
ran on the device, in %."""

from pbcore.readers import idle_share


def read(run):
    return idle_share(run)
