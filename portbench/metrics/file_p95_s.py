"""95th percentile over every clip of the window of the time from its due
arrival to the yield of its result (the clip service)."""

from pbcore.readers import latency_quantile


def read(run):
    return latency_quantile(run, 0.95)
