"""Median filter along the last axis, on the host (numpy).

Copy of ``median_filter_numpy`` from ``whisper_timestamped_tpu/ops/median.py``
(that module imports JAX at the top). Replaces
``scipy.ndimage.median_filter(x, (1, 1, w))``: reflect-mode edges (numpy
``symmetric``), odd window.
"""

from __future__ import annotations

import numpy as np


def median_filter_numpy(x: np.ndarray, width: int = 9) -> np.ndarray:
    """Width-``width`` sliding median with symmetric edge padding."""
    assert width % 2 == 1
    half = width // 2
    pad = [(0, 0)] * (x.ndim - 1) + [(half, half)]
    xp = np.pad(x, pad, mode="symmetric")
    windows = np.lib.stride_tricks.sliding_window_view(xp, width, axis=-1)
    return np.median(windows, axis=-1)
