"""Bulk long-form transcription: closed batches of streams through
``transcribe_batch_stream``, as fast as it takes them. The window feeds
whole batches while ``--seconds`` have not passed since it opened, and
lasts until the last of them is yielded.

End-to-end: ``audio_s_per_s``, the audio of every yielded batch over the
time from the window's opening to the last yield."""

from __future__ import annotations

import time

from pbcore import traffic as traffic_mod


def warm_batches(ctx):
    """One batch at the cell's B whose streams run two windows, so that the
    token loop is captured for both prompt regions (the first window's and
    the conditioned ones')."""
    n = int(ctx.cell.spec["warm_seconds"] * traffic_mod.SAMPLE_RATE)
    items = [traffic_mod.Item(f"warm{i:03d}", 0, n) for i in range(ctx.cell.spec["batch_size"])]
    return [{it.name: traffic_mod.audio_of(ctx.pool, it) for it in items}]


def planned(ctx):
    """The streams the window surely sends: its first batch."""
    return next(traffic_mod.batches(ctx.cell.traffic, ctx.seed, len(ctx.pool)))


def window(ctx):
    plan = traffic_mod.batches(ctx.cell.traffic, ctx.seed, len(ctx.pool))
    fed = []
    t0 = time.perf_counter()

    def source():
        while time.perf_counter() - t0 < ctx.seconds:
            items = next(plan)
            fed.append(items)
            yield {it.name: traffic_mod.audio_of(ctx.pool, it) for it in items}

    yields = []
    results = {}
    for res in ctx.transcribe(source()):
        yields.append(time.perf_counter())
        results.update(res)
        ctx.tracer.tick()
    end = yields[-1] if yields else time.perf_counter()
    ctx.tracer.close()
    items = [it for batch in fed for it in batch]
    done = [it for it in items if it.name in results]
    return dict(t0=t0, end=end, items=items, done=done, results=results,
                audio_s=sum(it.seconds for it in done), batches=len(yields))
