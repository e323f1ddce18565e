"""Backend-computed token-level timestamps (``use_backend_timestamps=True``).

Copy of ``whisper_timestamped_tpu/backend_timestamps.py`` (numpy only), so
the port needs nothing of the JAX package. The reference delegates this
option to HuggingFace ``generate(..., return_token_timestamps=True)``
(reference ``transcribe.py:2667-2806``), whose timestamp algorithm differs
from whisper-timestamped's own alignment: per-head **z-score normalization
over the token axis** (not softmax + L2), **median filter of width 7**
(whisper-timestamped uses 9) over the frame axis, head mean, then DTW; each
token's timestamp is its first frame on the optimal path, and a word's end
is the NEXT token's timestamp (reference ``transcribe.py:2783-2795``).

Here the same algorithm runs over the alignment-head attention captured
during the single decode pass: no second forward.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .audio import AUDIO_TIME_PER_TOKEN

MEDIAN_FILTER_WIDTH = 7  # whisper config default (HF config.median_filter_width)


def _median_filter_reflect(x: np.ndarray, width: int) -> np.ndarray:
    """Median along the last axis with torch-style 'reflect' padding (edge
    sample not repeated) — the padding HF's ``_median_filter`` uses, which
    differs from scipy/whisper-timestamped's symmetric mode at the borders."""
    half = width // 2
    if x.shape[-1] <= half:
        return x
    pad = [(0, 0)] * (x.ndim - 1) + [(half, half)]
    xp = np.pad(x, pad, mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(xp, width, axis=-1)
    return np.median(windows, axis=-1)


def _dtw_hf(matrix: np.ndarray):
    """Monotonic 3-way DTW with HF/openai-whisper's exact tie-breaking
    (ties fall to the LEFT step) and backtrace. Vectorized anti-diagonal
    sweep: cell (i, j) depends only on cells of the two previous
    anti-diagonals, so each diagonal updates at once — the O(N*M) Python
    loop of the naive form would dominate long windows."""
    n, m = matrix.shape
    INF = np.float64(np.inf)
    cost = np.full((n + 1, m + 1), INF)
    trace = np.full((n + 1, m + 1), -1, np.int8)
    cost[0, 0] = 0.0
    # anti-diagonal d holds cells with i + j == d (1-indexed DP coordinates)
    for d in range(2, n + m + 1):
        i_lo, i_hi = max(1, d - m), min(n, d - 1)
        if i_lo > i_hi:
            continue
        i = np.arange(i_lo, i_hi + 1)
        j = d - i
        c0 = cost[i - 1, j - 1]
        c1 = cost[i - 1, j]
        c2 = cost[i, j - 1]
        # HF rule: diag only if STRICTLY smallest, up only if strictly
        # smallest, otherwise left
        t = np.where(
            (c0 < c1) & (c0 < c2), 0, np.where((c1 < c0) & (c1 < c2), 1, 2)
        ).astype(np.int8)
        c = np.where(t == 0, c0, np.where(t == 1, c1, c2))
        cost[i, j] = matrix[i - 1, j - 1] + c
        trace[i, j] = t
    trace[0, :] = 2
    trace[:, 0] = 1
    i, j = n, m
    text_indices, time_indices = [], []
    while i > 0 or j > 0:
        text_indices.append(i - 1)
        time_indices.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.array(text_indices[::-1]), np.array(time_indices[::-1])


def hf_token_timestamps(
    attn_scores: np.ndarray,  # (n_tokens, K, frames) PRE-softmax qk scores
    num_frames: Optional[int] = None,
    median_width: int = MEDIAN_FILTER_WIDTH,
    time_precision: float = AUDIO_TIME_PER_TOKEN,
) -> np.ndarray:
    """Per-token start times (seconds, window-relative) via HF's algorithm.

    ``attn_scores`` are the decode loop's captured alignment-head rows (the
    same buffer the normal aligner reads); softmax over frames converts them
    to the attention probabilities HF's ``output_attentions=True`` returns.
    Returns ``(n_tokens,)`` float seconds.
    """
    w = np.asarray(attn_scores, np.float64)
    w = np.exp(w - w.max(axis=-1, keepdims=True))
    w /= w.sum(axis=-1, keepdims=True)
    w = np.transpose(w, (1, 0, 2))  # (K, n_tokens, frames)
    if num_frames is not None:
        w = w[..., : num_frames // 2]
    std = w.std(axis=-2, keepdims=True)  # over the token axis, ddof=0
    mean = w.mean(axis=-2, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = (w - mean) / std
    w = _median_filter_reflect(w, median_width)
    matrix = w.mean(axis=0)  # (n_tokens, frames)
    text_indices, time_indices = _dtw_hf(-matrix)
    jumps = np.pad(np.diff(text_indices), (1, 0), constant_values=1).astype(bool)
    return time_indices[jumps] * time_precision


def backend_words_for_window(
    window_tokens: List[int],
    token_times: np.ndarray,  # hf_token_timestamps(window.attn)
    segments,  # [(idx_segment, (a, b))] window-relative token spans
    tok,
    *,
    use_space: bool,
    remove_punctuation_from_words: bool,
    time_offset: float,
) -> List[dict]:
    """Words from backend token timestamps, per the reference adapter's
    construction (``transcribe.py:2770-2795``): split the segment's text
    tokens into words, word start = its first token's timestamp, word end =
    the FOLLOWING token's timestamp (the next word's first token, or the
    segment's closing timestamp token). No confidence — the backend path
    returns none (reference ``words_dicts``, probability commented out)."""
    from .alignment import split_tokens_on_spaces, split_tokens_on_unicode

    split_tokens = split_tokens_on_spaces if use_space else split_tokens_on_unicode
    out: List[dict] = []
    last_t = len(token_times) - 1
    for idx_segment, (a, b) in segments:
        # text tokens sit between the segment's timestamp tokens
        text_pos = [p for p in range(a, b) if window_tokens[p] < tok.eot]
        if not text_pos:
            continue
        words, _word_tokens, word_tokens_indices = split_tokens(
            [window_tokens[p] for p in text_pos],
            tok,
            remove_punctuation_from_words=remove_punctuation_from_words,
        )
        i_end = 0
        for w, toks in zip(words, word_tokens_indices):
            i_start = i_end
            i_end = i_start + len(toks)
            if not toks:
                continue
            p_start = text_pos[i_start]
            # boundary token after the word: next text token, or the
            # closing timestamp row right after the segment's last text token
            p_end = text_pos[i_end] if i_end < len(text_pos) else text_pos[-1] + 1
            out.append(
                {
                    "text": w,
                    "start": round(time_offset + float(token_times[min(p_start, last_t)]), 2),
                    "end": round(time_offset + float(token_times[min(p_end, last_t)]), 2),
                    "idx_segment": idx_segment,
                }
            )
    return out
