"""Per-stage wall-clock timers and counters.

Framework-free counterpart of ``whisper_timestamped_tpu/utils/profiling.py``
(``stage_timer`` and its accessors, and ``trace``: a ``torch.profiler``
trace where JAX's takes a ``jax.profiler`` one). Stages that end in a device
synchronisation (the decode loop syncs once per chunk of
``decoding.STOP_CHECK_STEPS`` steps, and at its end) measure device time;
others measure host enqueue time only. The timers take a lock: the batch
serving loop times stages from its assembly thread too.

Stage names in use:

- serial path: ``mel``, ``decode``, ``encode``, ``prefill``,
  ``decode_capture`` (a CUDA graph's warm-up and capture, once per key of
  an engine), ``decode_loop`` (with the count ``decode_steps``, the steps
  run before the stop), ``align``;
- batch pipeline (``parallel/batch.py``): ``prepare_audio`` (upload and mel
  dispatch), ``batch_mel`` (the same on the critical path, or the wait for a
  prefetched batch), ``decode_prompt_build``, ``decode_dispatch`` (one
  window decode of the batch), ``decode_fetch_unpack``,
  ``devflow_dispatch`` (device flow: decode plus state advance),
  ``devflow_done_fetch`` (its one blocking read per window),
  ``batch_prepare`` and ``batch_align`` (alignment queued per window),
  ``batch_assemble`` (host word assembly).
"""

from __future__ import annotations

import collections
import contextlib
import logging
import threading
import time
from typing import Dict

logger = logging.getLogger("whisper_timestamped_tpu_torch")

_timings: Dict[str, float] = collections.defaultdict(float)
_counts: Dict[str, int] = collections.defaultdict(int)
_lock = threading.Lock()


@contextlib.contextmanager
def stage_timer(name: str):
    """Accumulate wall time under ``name`` (e.g. 'mel', 'decode', 'align')."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            _timings[name] += dt
            _counts[name] += 1
        logger.debug("stage %s: %.1f ms", name, dt * 1000)


def add_count(name: str, n: int) -> None:
    """Accumulate a plain event count (e.g. decode steps) beside the timers."""
    with _lock:
        _counts[name] += int(n)


def get_stage_timings() -> Dict[str, dict]:
    with _lock:
        return {
            k: {"total_s": _timings[k], "count": _counts[k],
                "mean_ms": 1000 * _timings[k] / max(_counts[k], 1)}
            for k in _timings
        }


def get_counts() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


def reset_stage_timings() -> None:
    with _lock:
        _timings.clear()
        _counts.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block to ``log_dir`` (made
    if missing): CPU activity, and CUDA activity where a card is present,
    written on exit as a Chrome trace file (``<host>_<pid>.<time>.pt.trace.json``,
    which TensorBoard's profiler plugin and Perfetto open)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
