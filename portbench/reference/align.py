"""Whisper-timestamped's word aligner (``timing.py`` of openai/whisper and
``transcribe.py``'s ``perform_word_alignment`` of whisper-timestamped),
written plainly: the DTW cost of a segment from its tokens' alignment-head
attention scores, the DTW through it, and each token's start frame on the
path.

cost: the scores of the segment's frames [start, start + span) (zero past
the audio's end), a width-9 median over frames with the edges mirrored
(scipy's ``median_filter`` mode "reflect": column -1 reads column 0, and
column span reads column span - 1), a softmax over the span, the mean over
the heads, each frame column divided by its L2 norm over the tokens, and
negated; then 0 at every token row but the last from column ``maxdur`` on,
and cost[0, 0] set to the least cost. In float64, or in the type ``dtype``
names (the control of the comparison computes it in bfloat16).

DTW: the least-cost monotone path from (0, 0) to (n - 1, m - 1) by steps
down the diagonal, to the left and up; a cell adds its cost to the best
of the three, in float32 as the cost is given; ties are broken the way
the system's aligner states it: the diagonal unless the left step is
strictly better, then the up step only if strictly better than both. The
walk back from the end steps left along row 0 and up along column 0. A
token's start frame is the first column of its row on the path."""

from __future__ import annotations

import numpy as np
import torch

MEDIAN_WIDTH = 9


def cost(rows: torch.Tensor, n: int, span: int, maxdur: int, start: int,
         dtype=torch.float64) -> torch.Tensor:
    """rows (n, K, T) pre-softmax scores of the segment's tokens -> (n, span)
    cost, in ``dtype``."""
    T = rows.shape[-1]
    x = torch.zeros((rows.shape[0], rows.shape[1], span), dtype=dtype, device=rows.device)
    lo, hi = min(start, T), min(start + span, T)
    x[..., : hi - lo] = rows[..., lo:hi].to(dtype)
    half = MEDIAN_WIDTH // 2
    idx = torch.arange(-half, span + half, device=rows.device)
    idx = torch.where(idx < 0, -idx - 1, idx)
    idx = torch.where(idx >= span, 2 * span - 1 - idx, idx).clamp(0, span - 1)
    med = x[..., idx].unfold(-1, MEDIAN_WIDTH, 1).median(dim=-1).values  # (n, K, span)
    mean = torch.softmax(med, dim=-1).mean(dim=1)  # (n, span)
    c = -(mean / torch.linalg.vector_norm(mean, dim=0, keepdim=True))
    if maxdur < span:
        c[: n - 1, maxdur:] = 0
    c[0, 0] = c.min()
    return c


DIAG, LEFT, UP = 0, 1, 2


def dtw_starts(c: np.ndarray) -> np.ndarray:
    """(n, m) float32 cost -> (n,) int64 start frame of each row on the
    least-cost path."""
    c = np.asarray(c, dtype=np.float32)
    n, m = c.shape
    g = np.full((n, m), np.inf, dtype=np.float32)
    step = np.zeros((n, m), dtype=np.int8)
    for d in range(n + m - 1):
        i = np.arange(max(0, d - m + 1), min(n - 1, d) + 1)
        j = d - i
        if d == 0:
            g[0, 0] = c[0, 0]
            continue
        diag = np.where((i >= 1) & (j >= 1), g[np.maximum(i - 1, 0), np.maximum(j - 1, 0)], np.inf)
        left = np.where(j >= 1, g[i, np.maximum(j - 1, 0)], np.inf)
        up = np.where(i >= 1, g[np.maximum(i - 1, 0), j], np.inf)
        best, code = diag, np.full(i.shape, DIAG, dtype=np.int8)
        code = np.where(left < best, LEFT, code)
        best = np.minimum(best, left)
        code = np.where(up < best, UP, code)
        best = np.minimum(best, up)
        g[i, j] = (c[i, j] + best).astype(np.float32)
        step[i, j] = code
    starts = np.zeros(n, dtype=np.int64)
    i, j = n - 1, m - 1
    while True:
        starts[i] = j
        if i == 0 and j == 0:
            return starts
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        elif step[i, j] == DIAG:
            i, j = i - 1, j - 1
        elif step[i, j] == LEFT:
            j -= 1
        else:
            i -= 1
