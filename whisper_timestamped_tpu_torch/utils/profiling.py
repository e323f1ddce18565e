"""Per-stage wall-clock timers and counters.

Framework-free counterpart of ``whisper_timestamped_tpu/utils/profiling.py``
(``stage_timer`` and its accessors). Stages that end in a device
synchronisation (the decode loop syncs once per step) measure device time;
others measure host enqueue time only.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import time
from typing import Dict

logger = logging.getLogger("whisper_timestamped_tpu_torch")

_timings: Dict[str, float] = collections.defaultdict(float)
_counts: Dict[str, int] = collections.defaultdict(int)


@contextlib.contextmanager
def stage_timer(name: str):
    """Accumulate wall time under ``name`` (e.g. 'mel', 'decode', 'align')."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _timings[name] += dt
        _counts[name] += 1
        logger.debug("stage %s: %.1f ms", name, dt * 1000)


def add_count(name: str, n: int) -> None:
    """Accumulate a plain event count (e.g. decode steps) beside the timers."""
    _counts[name] += int(n)


def get_stage_timings() -> Dict[str, dict]:
    return {
        k: {"total_s": _timings[k], "count": _counts[k], "mean_ms": 1000 * _timings[k] / max(_counts[k], 1)}
        for k in _timings
    }


def get_counts() -> Dict[str, int]:
    return dict(_counts)


def reset_stage_timings() -> None:
    _timings.clear()
    _counts.clear()
