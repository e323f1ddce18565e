"""What the metric modules (``metrics/<name>.py``) share. A reader returns
None where its run has nothing to read; the harness then leaves the metric
out of the line."""

from __future__ import annotations

import statistics
from typing import Optional


def stage_s(run, name: str) -> Optional[float]:
    """Seconds the program's stage timer ``name`` summed over the window."""
    t = run.stages.get(name)
    return t["total_s"] if t else None


def step_ms(run) -> Optional[float]:
    steps = run.counts.get("decode_steps", 0)
    loop = stage_s(run, "decode_loop")
    return 1e3 * loop / steps if steps and loop else None


def encoder_ms(run) -> Optional[float]:
    if run.spans is None or not run.spans.encoder_events:
        return None
    ms = run.spans.encoder_ms()
    return sum(ms) / len(ms)


def latency_quantile(run, q: float) -> Optional[float]:
    """The ``q`` quantile of the clips' latencies; in a traced run, of the
    clips answered before the profiler stopped (the stop holds the serving
    loop, and every clip answered after it waited behind that)."""
    spans = getattr(run.out, "spans", None)
    if not spans:
        return None
    lat = [done - due for due, done in spans if done < run.tracer.stall[0]]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[round(q * 100) - 1]


def idle_share(run) -> Optional[float]:
    s = run.tracer.summary
    if not s or not run.tracer.window_s:
        return None
    return 100.0 * (1.0 - s["busy_s"] / run.tracer.window_s)


def mfu(run) -> Optional[float]:
    if run.peaks is None or not run.live_rows or run.window_s <= 0:
        return None
    flops = run.work.completed_flops(run.config["dims"], run.live_rows)
    return 100.0 * flops / (run.window_s * run.peaks["bf16_flops"])


def roofline(run, kernel) -> Optional[float]:
    """Sum of each traced call's least time (the larger of its operations
    over the bf16 peak and its bytes over the memory rate) over the
    kernel's traced device time, in %. ``kernel`` is a ``roofline/``
    module."""
    if run.tracer.summary is None or run.peaks is None:
        return None
    secs, n = run.tracer.kernel_time(kernel.KERNEL, kernel.EXCLUDE)
    calls = kernel.calls(run)
    if not n or secs <= 0 or not calls or sum(calls.values()) != n:
        return None
    least = sum(c * max(fl / run.peaks["bf16_flops"], by / run.peaks["hbm_bytes_per_s"])
                for (fl, by), c in calls.items())
    return 100.0 * least / secs
