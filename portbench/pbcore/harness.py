"""One run of one cell: set-up (weights, model, engine, audio, warm-up),
the measured window through the cell's entry, the guard on imports, the
comparison with the reference, and the metrics by their readers."""

from __future__ import annotations

import gc
import sys
import time
from types import SimpleNamespace
from typing import Callable, Optional

import torch

from reference import rules

from . import check, device, guard, manifest, program, traffic, weights, work
from .tracing import Tracer

def _live_rows(cell, windows):
    """(prompt length, sampled tokens) of every decoded window row, the
    prompts rebuilt by whisper's rules from the tokens served before."""
    vocab = cell.config["vocabulary"]
    history, rows = {}, []
    for name, seek, toks, _ in windows:
        hist = history.setdefault(name, [])
        prompt = rules.prompt_tokens(vocab, hist if cell.spec["condition_on_previous_text"] else [])
        rows.append((len(prompt), len(toks)))
        used, _ = rules.advance(vocab, toks, seek, 1 << 30)
        hist.extend(toks[:used])
    return rows


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, dev,
             process_t0: float, *, control: Optional[str] = None, rate: Optional[float] = None,
             log: Callable = print, break_program: Optional[Callable] = None) -> dict:
    spec, cfg = cell.spec, cell.config
    on_cuda = torch.device(dev).type == "cuda"
    w = weights.make(cfg["dims"], cfg["weight_seed"], dev)
    model = program.build_model(cfg, w)
    del w
    tok = program.build_tokenizer(cfg)
    if control not in (None, "fp8"):
        raise ValueError(f"unknown control {control!r}")
    levers = program.engine_levers(spec["levers"])
    engine = program.build_engine(model, tok, levers)
    options = program.request_options(spec, cfg, spec["tokens"])
    spans = program.Spans() if trace else None
    if break_program is not None:
        break_program()
    pool = traffic.make_pool(cell.traffic["audio"], seed, dev)
    entry = manifest.load_module("entries", spec["entry"])
    tracer = Tracer(trace and on_cuda, spec.get("trace_seconds", 8.0), spans)
    ctx = SimpleNamespace(cell=cell, seed=seed, seconds=seconds, pool=pool, rate=rate,
                          tracer=tracer,
                          transcribe=lambda b: program.transcribe_stream(model, b, tok, engine, options))
    # the requests the check judges, drawn before the window from those the
    # window surely sends, so that their alignment is kept as it is made
    picked = check.sample(entry.planned(ctx), spec["sample_requests"], seed)
    program.Observer()
    for _ in ctx.transcribe(iter(entry.warm_batches(ctx))):
        pass
    if on_cuda:
        torch.cuda.synchronize()
        tracer.warm()
        torch.cuda.reset_peak_memory_stats()
    observer = program.Observer(watch=[it.name for it in picked])
    observer.reset_counters()
    setup_s = time.perf_counter() - process_t0

    out = SimpleNamespace(**entry.window(ctx))
    if on_cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    stages, counts, launches = observer.counters()
    leaked = guard.loaded()
    if leaked:
        raise SystemExit(f"portbench: sys.modules holds {leaked} after the window")
    log(f"window: {len(out.items)} requests, {len(out.done)} answered, {out.batches} batches, "
        f"{out.end - out.t0:.3f} s; decode_capture in the window: "
        f"{counts.get('decode_capture', 0)}; decode steps {counts.get('decode_steps', 0)}")

    if getattr(out, "latencies", None):
        lat = sorted(out.latencies)
        half = len(out.latencies) // 2
        by_due = [done - due for due, done in sorted(out.spans)]
        log(f"serve: {len(lat)} clips, latency p50 {lat[len(lat) // 2]:.3f} s, p95 "
            f"{lat[int(0.95 * (len(lat) - 1))]:.3f} s, mean of the first / second half of the "
            f"arrivals {sum(by_due[:half]) / max(half, 1):.3f} / "
            f"{sum(by_due[half:]) / max(len(by_due) - half, 1):.3f} s; batch fill "
            f"{sum(out.fills) / len(out.fills):.2f} of {spec['batch_size']}; the batcher at most "
            f"{out.batcher_late_s:.3f} s late")
    if trace and on_cuda and not (spans.encoder_events and spans.flash_calls):
        raise SystemExit("portbench: the traced window recorded no encoder call or no "
                         "flash_attention call: a hook the benchmark puts in the program "
                         "is no longer on its path")
    if trace:
        log(f"trace: {tracer.window_s} s traced, {tracer.stall_s:.3f} s stopping it; flash calls "
            f"counted {sum(spans.flash_calls.values())}, traced "
            f"{tracer.kernel_time('flash_attention_kernel', '<true>')[1]}")
    windows = list(observer.windows)
    observer.to_host()
    del ctx, engine, model, options
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    unanswered = len(out.items) - len(out.done)
    numbers = check.compare(cell, seed, dev, pool, picked, windows, unanswered, log=log,
                            control=control == "fp8", rows=observer.rows,
                            segments=observer.segments)

    kind = torch.cuda.get_device_name(0) if on_cuda else "cpu"
    run = SimpleNamespace(
        cell=cell, spec=spec, config=cfg, out=out, stages=stages, counts=counts,
        launches=launches, tracer=tracer, spans=spans, peak_bytes=peak, setup_s=setup_s,
        window_s=out.end - out.t0 - tracer.stall_s, peaks=device.peaks(kind) if on_cuda else None,
        live_rows=_live_rows(cell, windows), work=work)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": check.passed(numbers), "attempted": len(out.items),
              "failed": unanswered, "metrics": metrics,
              "device": device.describe(spec["chips"], peak) if on_cuda else
              {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}}
    if trace and tracer.summary is not None:
        result["device"]["busy_s"] = tracer.summary["busy_s"]
        result["device"]["window_s"] = tracer.window_s
        result["breakdown"] = {"device_ops": tracer.summary["device_ops"],
                               "idle_gaps": tracer.summary["idle_gaps"]}
    result["levers"] = levers
    result["checks"] = numbers
    return result


def print_result(result: dict) -> None:
    for name, v in result["checks"].items():
        print(f"check {name}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    import json

    print(json.dumps(result), flush=True)
