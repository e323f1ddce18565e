"""Dynamic-time-warping over attention cost matrices, on the host (numpy).

Copy of the numpy half of ``whisper_timestamped_tpu/ops/dtw.py``
(``dtw_path_numpy_wavefront`` and ``dtw_path_numpy``; that module imports JAX
at the top). Step pattern ``symmetric1`` moves diagonal / left / up with tie
order diagonal, left, up; ``allow_vertical=False`` is the reference's custom
pattern (diagonal / left only). The batched device DP is ``ops.kernels.dtw_codes``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# step codes in the choice matrix
DIAG, LEFT, UP = 0, 1, 2


def dtw_path_numpy_wavefront(
    x: np.ndarray, allow_vertical: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized numpy anti-diagonal DP (same semantics as ``dtw_path_numpy``)."""
    x = np.asarray(x, np.float64)
    N, M = x.shape
    steps = np.zeros((N, M), np.int8)
    i_vec = np.arange(N)
    g1 = np.full(N, np.inf)
    g2 = np.full(N, np.inf)
    inf1 = np.array([np.inf])
    for d in range(N + M - 1):
        j_vec = d - i_vec
        valid = (j_vec >= 0) & (j_vec < M)
        lo = max(0, d - M + 1)
        hi = min(d, N - 1)
        x_d = np.full(N, np.inf)
        x_d[lo : hi + 1] = x[i_vec[lo : hi + 1], j_vec[lo : hi + 1]]

        g1_up = np.concatenate([inf1, g1[:-1]])
        g2_diag = np.concatenate([inf1, g2[:-1]])
        cand_diag = np.where((i_vec >= 1) & (j_vec >= 1), g2_diag, np.inf)
        cand_left = np.where(j_vec >= 1, g1, np.inf)
        cand_up = (
            np.where(i_vec >= 1, g1_up, np.inf) if allow_vertical else np.full(N, np.inf)
        )
        best = cand_diag
        code = np.zeros(N, np.int8)
        better = cand_left < best
        code[better] = LEFT
        best = np.minimum(best, cand_left)
        better = cand_up < best
        code[better] = UP
        best = np.minimum(best, cand_up)

        g_new = np.where((i_vec == 0) & (j_vec == 0), x_d, x_d + best)
        g_new[~valid] = np.inf
        steps[i_vec[lo : hi + 1], j_vec[lo : hi + 1]] = code[lo : hi + 1]
        g2, g1 = g1, g_new
    return _backtrace_dense(steps, N, M)


def dtw_path_numpy(x: np.ndarray, allow_vertical: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Full-matrix DP + backtrace. Returns (index1s, index2s) like dtw-python."""
    x = np.asarray(x, np.float64)
    N, M = x.shape
    g = np.full((N, M), np.inf)
    steps = np.zeros((N, M), np.int8)
    g[0, 0] = x[0, 0]
    for j in range(1, M):
        g[0, j] = g[0, j - 1] + x[0, j]
        steps[0, j] = LEFT
    if allow_vertical:
        for i in range(1, N):
            g[i, 0] = g[i - 1, 0] + x[i, 0]
            steps[i, 0] = UP
    for i in range(1, N):
        row_prev = g[i - 1]
        row = g[i]
        for j in range(1, M):
            best = row_prev[j - 1]
            code = DIAG
            if row[j - 1] < best:
                best = row[j - 1]
                code = LEFT
            if allow_vertical and row_prev[j] < best:
                best = row_prev[j]
                code = UP
            row[j] = x[i, j] + best
            steps[i, j] = code
    return _backtrace_dense(steps, N, M)


def _backtrace_dense(steps: np.ndarray, N: int, M: int):
    i, j = N - 1, M - 1
    path = [(i, j)]
    while i > 0 or j > 0:
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            s = steps[i, j]
            if s == DIAG:
                i, j = i - 1, j - 1
            elif s == LEFT:
                j -= 1
            else:
                i -= 1
        path.append((i, j))
    path.reverse()
    arr = np.array(path, np.int64)
    return arr[:, 0], arr[:, 1]
