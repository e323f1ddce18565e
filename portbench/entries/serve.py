"""An open-loop clip service: clips arrive on a schedule drawn from the
seed at the cell's offered rate, and a batcher hands
``transcribe_batch_stream`` every clip that has arrived, up to B, each
time the stream asks for its next batch (the rule of
``examples/serving.py``'s ``watch_batches``, woken by the next arrival
instead of polling a directory). Arrivals stop when ``--seconds`` have
passed; the window lasts until the last clip is yielded.

End-to-end: ``file_p95_s``, the 95th percentile over every clip of the
time from its due arrival to the yield of its result."""

from __future__ import annotations

import threading
import time

from pbcore import traffic as traffic_mod
from entries.stream import warm_batches  # noqa: F401  (the same warm-up)


def planned(ctx):
    """Every clip of the window's schedule."""
    return traffic_mod.arrivals(ctx.cell.traffic, ctx.seed, len(ctx.pool),
                                ctx.rate or ctx.cell.spec["rate_per_s"], ctx.seconds)


def window(ctx):
    B = ctx.cell.spec["batch_size"]
    schedule = planned(ctx)
    fills = []
    lateness = []  # how late the batcher took each clip past its due time
    lock = threading.Lock()
    t0 = time.perf_counter()
    # trace the window's last arrivals: stopping the profiler holds the
    # serving loop for seconds, and the clips queued behind that stall would
    # read as the service's latency
    ctx.tracer.not_before = t0 + max(0.0, ctx.seconds - ctx.tracer.seconds - 3.0)

    def source():
        i = 0
        while i < len(schedule):
            now = time.perf_counter() - t0
            if schedule[i].due_s > now:
                time.sleep(schedule[i].due_s - now)
                now = time.perf_counter() - t0
            j = i
            while j < len(schedule) and j - i < B and schedule[j].due_s <= now:
                j += 1
            group = schedule[i:j]
            with lock:
                fills.append(len(group))
                lateness.extend(now - it.due_s for it in group)
            i = j
            yield {it.name: traffic_mod.audio_of(ctx.pool, it) for it in group}

    results, answered = {}, {}
    for res in ctx.transcribe(source()):
        t = time.perf_counter()
        for name in res:
            answered[name] = t
        results.update(res)
        ctx.tracer.tick()
    end = time.perf_counter()
    ctx.tracer.close()
    done = [it for it in schedule if it.name in results]
    # (due, answered) of every clip, perf_counter
    spans = [(t0 + it.due_s, answered[it.name]) for it in done]
    return dict(t0=t0, end=end, items=schedule, done=done, results=results,
                audio_s=sum(it.seconds for it in done), batches=len(fills),
                latencies=[b - a for a, b in spans], spans=spans, fills=fills,
                batcher_late_s=max(lateness) if lateness else 0.0)
