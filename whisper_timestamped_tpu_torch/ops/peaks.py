"""Pure-numpy peak detection with scipy.signal.find_peaks semantics.

Copy of ``whisper_timestamped_tpu/ops/peaks.py`` (the JAX package's
``__init__`` imports JAX, so the port keeps its own). The reference's
disfluency detector calls ``scipy.signal.find_peaks(x, width=3,
prominence=0.02)`` (reference ``transcribe.py:1663-1666``) and consumes
``left_ips``/``left_bases``. This is a dependency-free reimplementation of
the subset used (local maxima with flat plateaus, prominences, interpolated
widths at rel_height=0.5, min-threshold filtering).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def _local_maxima(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Indices of local maxima (midpoints of flat plateaus), plus plateau edges."""
    mids, lefts, rights = [], [], []
    i, n = 1, len(x) - 1
    while i < n:
        if x[i - 1] < x[i]:
            ahead = i + 1
            while ahead < n and x[ahead] == x[i]:
                ahead += 1
            if x[ahead] < x[i]:
                left = i
                right = ahead - 1
                mids.append((left + right) // 2)
                lefts.append(left)
                rights.append(right)
                i = ahead
                continue
        i += 1
    return np.array(mids, int), np.array(lefts, int), np.array(rights, int)


def _prominences(x: np.ndarray, peaks: np.ndarray):
    n = len(x)
    prominences = np.empty(len(peaks))
    left_bases = np.empty(len(peaks), int)
    right_bases = np.empty(len(peaks), int)
    for k, p in enumerate(peaks):
        h = x[p]
        # walk left while samples are not higher than the peak
        i = p
        left_min = h
        left_base = p
        while i > 0 and x[i - 1] <= h:
            i -= 1
            if x[i] < left_min:
                left_min = x[i]
                left_base = i
        # walk right
        i = p
        right_min = h
        right_base = p
        while i < n - 1 and x[i + 1] <= h:
            i += 1
            if x[i] < right_min:
                right_min = x[i]
                right_base = i
        prominences[k] = h - max(left_min, right_min)
        left_bases[k] = left_base
        right_bases[k] = right_base
    return prominences, left_bases, right_bases


def _widths(x, peaks, prominences, left_bases, right_bases, rel_height=0.5):
    widths = np.empty(len(peaks))
    width_heights = np.empty(len(peaks))
    left_ips = np.empty(len(peaks))
    right_ips = np.empty(len(peaks))
    for k, p in enumerate(peaks):
        height = x[p] - prominences[k] * rel_height
        width_heights[k] = height
        # left intersection point
        i = p
        while i > left_bases[k] and x[i] > height:
            i -= 1
        lip = float(i)
        if x[i] < height:
            lip = i + (height - x[i]) / (x[i + 1] - x[i])
        # right intersection point
        i = p
        while i < right_bases[k] and x[i] > height:
            i += 1
        rip = float(i)
        if x[i] < height:
            rip = i - (height - x[i]) / (x[i - 1] - x[i])
        left_ips[k] = lip
        right_ips[k] = rip
        widths[k] = rip - lip
    return widths, width_heights, left_ips, right_ips


def find_peaks(
    x: np.ndarray,
    width: Optional[float] = None,
    prominence: Optional[float] = None,
    rel_height: float = 0.5,
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """scipy-compatible subset: min-``prominence`` and min-``width`` filters."""
    x = np.asarray(x, np.float64)
    properties: Dict[str, np.ndarray] = {}
    if len(x) < 3:
        return np.array([], int), properties
    peaks, _, _ = _local_maxima(x)
    if prominence is not None or width is not None:
        prom, lb, rb = _prominences(x, peaks)
        if prominence is not None:
            keep = prom >= prominence
            peaks, prom, lb, rb = peaks[keep], prom[keep], lb[keep], rb[keep]
        properties.update(prominences=prom, left_bases=lb, right_bases=rb)
    if width is not None:
        widths, wh, lip, rip = _widths(
            x, peaks, properties["prominences"], properties["left_bases"],
            properties["right_bases"], rel_height,
        )
        keep = widths >= width
        peaks = peaks[keep]
        for name in ("prominences", "left_bases", "right_bases"):
            properties[name] = properties[name][keep]
        properties.update(
            widths=widths[keep], width_heights=wh[keep],
            left_ips=lip[keep], right_ips=rip[keep],
        )
    return peaks, properties
