"""The device trace of a ``--trace 1`` run: ``torch.profiler`` with CPU and
CUDA activity over a stretch of the measured window, reduced to the
device's busy time (the union of its kernels' and copies' intervals), the
time of each kernel by name, and the idle gaps by the program stage
(``pb:<stage>`` range) the host was in."""

from __future__ import annotations

import bisect
import collections
import time
from typing import Dict, List, Optional, Tuple


def _events(prof) -> list:
    """(name, on_device, start_us, end_us) of every traced event."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        out.append((e.name(), e.device_type() == cuda, start, start + e.duration_ns() / 1e3))
    return out


def short(name: str) -> str:
    """A kernel's name without its arguments, return type and anonymous
    namespaces."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(", 1)[0]
    return (name[5:] if name.startswith("void ") else name)[:120]


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


class Tracer:
    """Starts at the first call of ``tick`` from ``not_before`` on and stops
    at the first later call ``seconds`` after it (or at ``close``). Stopping parses the trace
    while the window's serving loop waits: ``stall`` is that stretch, which
    the traced run's rates and latencies leave out."""

    def __init__(self, enabled: bool, seconds: float, spans=None):
        self.enabled, self.seconds, self.spans = enabled, seconds, spans
        self.prof = None
        self.t_start: Optional[float] = None
        self.window_s: Optional[float] = None
        self.summary: Optional[dict] = None
        self.stall_s = 0.0  # the window's time spent stopping the profiler
        self.stall = (float("inf"), float("inf"))  # its start and end, perf_counter
        self.not_before = 0.0  # perf_counter time before which ``tick`` starts nothing

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def warm(self) -> None:
        """One short trace in set-up, so the window's start pays no
        profiler initialisation."""
        if not self.enabled:
            return
        import torch

        with self._profile():
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def tick(self) -> None:
        if not self.enabled or self.summary is not None:
            return
        import torch

        now = time.perf_counter()
        if self.prof is None and now < self.not_before:
            return
        if self.prof is None:
            torch.cuda.synchronize()
            self.prof = self._profile()
            self.prof.start()
            if self.spans is not None:
                self.spans.active = True
            self.t_start = time.perf_counter()
        elif now - self.t_start >= self.seconds:
            self.close()

    def close(self) -> None:
        if self.prof is None or self.summary is not None:
            return
        import torch

        torch.cuda.synchronize()
        t_stop = time.perf_counter()
        self.window_s = t_stop - self.t_start
        if self.spans is not None:
            self.spans.active = False
        self.prof.stop()
        self.summary = self._reduce(_events(self.prof))
        self.prof = None
        self.stall = (t_stop, time.perf_counter())
        self.stall_s = self.stall[1] - t_stop

    def _reduce(self, events) -> dict:
        # the device copies of the benchmark's own ranges span their kernels
        # and the gaps between them: not device work
        dev = [(s, e, short(n)) for n, on_dev, s, e in events
               if on_dev and e > s and not n.startswith("pb:")]
        merged = _merge([(s, e) for s, e, _ in dev])
        busy_us = sum(e - s for s, e in merged)
        kernels: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
        for s, e, n in dev:
            kernels[n][0] += (e - s) / 1e6
            kernels[n][1] += 1
        spans = sorted((s, e, n) for n, on_dev, s, e in events
                       if not on_dev and n.startswith("pb:"))
        starts = [s for s, _, _ in spans]
        reach = []  # the latest end among spans[:i + 1]
        for _, e, _ in spans:
            reach.append(max(e, reach[-1]) if reach else e)
        idle: Dict[str, float] = collections.defaultdict(float)
        for (_, a), (b, _) in zip(merged, merged[1:]):
            mid = (a + b) / 2
            label = "outside any program stage"
            # the latest-starting stage range that holds the gap's middle
            for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                if reach[i] < mid:
                    break
                if spans[i][1] >= mid:
                    label = spans[i][2][3:]
                    break
            idle[label] += (b - a) / 1e6
        return {
            "busy_s": busy_us / 1e6,
            "kernels": {n: (t, c) for n, (t, c) in kernels.items()},
            "device_ops": sorted(([n, t] for n, (t, _) in kernels.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(([n, t] for n, t in idle.items()), key=lambda x: -x[1])[:10],
        }

    def kernel_time(self, prefix: str, exclude: str = None) -> Tuple[float, int]:
        """Total seconds and calls of the kernels whose name contains
        ``prefix`` (and not ``exclude``)."""
        t, c = 0.0, 0
        for name, (secs, calls) in (self.summary or {}).get("kernels", {}).items():
            if prefix in name and not (exclude and exclude in name):
                t += secs
                c += calls
        return t, c
