"""Word alignment: DTW over cross-attention -> word-level timestamps.

Port of ``whisper_timestamped_tpu/alignment.py`` (token splitting,
``plan_alignment``, ``perform_word_alignment`` with disfluency detection).
A segment's jumps come from one of three routes:

- the batched device aligner (``device_align.py``), through
  ``precomputed_jumps`` (and ``precomputed_cost`` for disfluencies);
- the per-segment kernels (``use_device_kernels``): the ``attention_to_cost``
  kernel on ``device``, the weight edits on the host in float64, then
  ``dtw_codes`` on ``device`` with the backtrace on the host;
- the host: the cost in numpy (f32) and the DTW in numpy (float64).

The routes keep the JAX package's precisions, so they can break DTW ties
differently, as the JAX package's routes do. The host DTW is the C++ core
(``native.py``) when it is built, else the numpy wavefront, as in the JAX
package.
"""

from __future__ import annotations

import string
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .audio import AUDIO_TIME_PER_TOKEN, N_FRAMES
from .models.load import default_device
from .ops import kernels
from .ops.dtw import dtw_path_numpy_wavefront
from .ops.median import median_filter_numpy
from .ops.peaks import find_peaks
from .utils import stage_timer

DISFLUENCY_MARK = "[*]"


def dtw_path(x, allow_vertical: bool = True):
    """Host DTW (float64): the C++ core when built (``native.py``), the
    numpy wavefront otherwise (``alignment.py:31-47`` of the JAX package).

    Only the import and availability probe is guarded: an error that the
    native DTW raises on a valid input propagates."""
    use_native = False
    try:
        from .native import available, dtw_path_native

        use_native = available()
    except Exception:
        pass
    if use_native:
        return dtw_path_native(x, allow_vertical)
    return dtw_path_numpy_wavefront(x, allow_vertical)

# punctuation set (reference ``transcribe.py:1813``)
_punctuation = (
    "".join(c for c in string.punctuation if c not in ["-", "'"]) + "。，！？：”、…"
)


def round_confidence(x: float) -> float:
    return round(float(x), 3)


def round_timestamp(x: float) -> float:
    return round(float(x), 2)


# ---------------------------------------------------------------------------
# Token -> word splitting (reference ``transcribe.py:1815-1868``)
# ---------------------------------------------------------------------------


class _WordGroup:
    """One word under construction: visible text plus the flat per-token
    decoded-string / token-id sequences."""

    __slots__ = ("text", "token_strs", "token_ids")

    def __init__(self):
        self.text = ""
        self.token_strs: List[str] = []
        self.token_ids: List[int] = []

    def take(self, piece_text: str, piece_ids: List[int], shown: Optional[str] = None):
        self.text += piece_text if shown is None else shown
        # only the final token of a multi-token piece carries the decoded text
        self.token_strs += [""] * (len(piece_ids) - 1) + [piece_text]
        self.token_ids += piece_ids


def _as_triple(groups: List[_WordGroup]):
    return (
        [g.text for g in groups],
        [g.token_strs for g in groups],
        [g.token_ids for g in groups],
    )


def _iter_unicode_pieces(tokens: Sequence[int], tokenizer):
    """Yield the shortest token runs whose decode is complete UTF-8; a
    trailing incomplete run is dropped, as in the reference."""
    pending: List[int] = []
    for tok in tokens:
        pending.append(int(tok))
        printable = [
            t for t in pending if t < tokenizer.eot or t >= tokenizer.timestamp_begin
        ]
        text = tokenizer.decode_with_timestamps(printable)
        if "�" in text:
            continue
        yield text, pending
        pending = []


def split_tokens_on_unicode(
    tokens: Sequence[int],
    tokenizer,
    remove_punctuation_from_words: bool = False,
    isolate_punctuations: bool = False,
):
    """Group tokens into unicode-complete chunks; a pure-punctuation piece
    joins the preceding word unless that word ends in a timestamp token."""
    groups: List[_WordGroup] = []
    for text, ids in _iter_unicode_pieces(tokens, tokenizer):
        bare = text.strip()
        glue = (
            not isolate_punctuations
            and bare != ""
            and bare in _punctuation
            and not (groups and groups[-1].token_ids
                     and groups[-1].token_ids[-1] >= tokenizer.timestamp_begin)
        )
        if glue:
            if not groups:
                groups.append(_WordGroup())
            groups[-1].take(text, ids, shown="" if remove_punctuation_from_words else None)
        else:
            groups.append(_WordGroup())
            groups[-1].take(text, ids)
    return _as_triple(groups)


def split_tokens_on_spaces(
    tokens: Sequence[int], tokenizer, remove_punctuation_from_words: bool = False
):
    """Group unicode chunks into space-delimited words (space languages)."""
    texts, _strs, ids = split_tokens_on_unicode(
        tokens, tokenizer, remove_punctuation_from_words=remove_punctuation_from_words
    )
    n = len(texts)
    ts_begin = tokenizer.timestamp_begin
    is_timestamp = [seq[0] >= ts_begin for seq in ids]
    is_blank = [t.strip() == "" for t in texts]

    def _opens_word(i: int) -> bool:
        if is_timestamp[i]:
            return True
        if i > 0 and is_blank[i - 1]:
            return False  # whatever follows a bare-space chunk merges into it
        if i > 0 and is_timestamp[i - 1]:
            return True  # first text after a timestamp token
        if is_blank[i]:
            # a space chunk opens a word, unless it pads a following timestamp
            return i + 1 >= n or not is_timestamp[i + 1]
        # leading space opens a word, except for punctuation, which glues back
        return texts[i].startswith(" ") and texts[i].strip() not in _punctuation

    groups: List[_WordGroup] = []
    for i in range(n):
        if i == 0 or _opens_word(i):
            groups.append(_WordGroup())
        g = groups[-1]
        g.text += texts[i].strip()
        g.token_strs += _strs[i]
        g.token_ids += ids[i]
    return _as_triple(groups)


def _attention_to_cost(scores: np.ndarray, medfilt_width: int, qk_scale: float) -> np.ndarray:
    """Host cost: median filter -> softmax -> head-mean -> per-frame L2 norm
    -> negate, over (K, n_tokens, span) scores (reference
    ``transcribe.py:1546-1550``)."""
    w = median_filter_numpy(np.asarray(scores, np.float32), medfilt_width)
    w = w * qk_scale
    w = np.exp(w - w.max(axis=-1, keepdims=True))
    w /= w.sum(axis=-1, keepdims=True)
    w = w.mean(axis=0)  # (tokens, span)
    w = w / np.linalg.norm(w, axis=-2, keepdims=True)
    return -w.astype(np.float64)


def _attention_to_cost_device(scores: np.ndarray, device=None) -> np.ndarray:
    """``_attention_to_cost`` with medfilt_width=9 and qk_scale=1 through
    the ``attention_to_cost`` kernel on ``device`` (None: the card). As the
    JAX wrapper does (``alignment.py:218-233``), tokens pad to a multiple of
    16 and frames to 128 with zeros; the padded block goes to the card
    through pinned memory. Returns the (n_tokens, span) cost in float64."""
    dev = default_device(device)
    K, N, span = scores.shape
    Np = int(np.ceil(max(N, 1) / 16) * 16)
    M = int(np.ceil(max(span, 1) / 128) * 128)
    with stage_timer("align_upload"):
        host = torch.zeros((K, Np, M), dtype=torch.float32, pin_memory=dev.type == "cuda")
        host.numpy()[:, :N, :span] = scores
        padded = host.to(dev)
    cost = kernels.attention_to_cost(padded, span, n_tokens=N)
    return cost[:N, :span].cpu().numpy().astype(np.float64)


# ---------------------------------------------------------------------------
# Alignment planning, shared by the host path and the device aligner
# ---------------------------------------------------------------------------


class AlignmentPlan(NamedTuple):
    """Resolved alignment extent for one segment (reference
    ``transcribe.py:1466-1535``)."""

    tokens: List[int]  # final tokens (tail-truncated if needed)
    row_indices: np.ndarray  # rows of the caller's attention feeding each token
    start_token: int
    end_token: int
    unfinished: bool
    empty: bool  # alignment degenerates to [] (zero-duration segment)


def plan_alignment(
    tokens: Sequence[int],
    tokenizer,
    refine_whisper_precision_nframes: int = 0,
    unfinished_decoding: bool = False,
) -> AlignmentPlan:
    tokens = [int(t) for t in tokens]
    assert len(tokens) > 1, f"Got unexpected sequence of tokens of length {len(tokens)}"
    rows = np.arange(len(tokens))
    unfinished = unfinished_decoding
    while True:
        start_token = tokens[0] - tokenizer.timestamp_begin
        end_token = tokens[-1] - tokenizer.timestamp_begin

        if start_token < 0:
            raise RuntimeError(
                f"Missing start token in: {tokenizer.decode_with_timestamps(tokens)}"
            )
        if len(tokens) == 1 or end_token < 0:
            end_token = N_FRAMES // 2  # stuck as a language model: no end timestamp
        if end_token == start_token and refine_whisper_precision_nframes == 0:
            return AlignmentPlan(tokens, rows, start_token, end_token, unfinished, True)

        # minimal duration given the token count (reference issue #67 rule)
        end_token = min(N_FRAMES // 2, max(end_token, start_token + len(tokens)))

        if refine_whisper_precision_nframes > 0:
            start_token = max(start_token - refine_whisper_precision_nframes, 0)
            end_token = min(end_token + refine_whisper_precision_nframes, N_FRAMES // 2)

        if end_token <= start_token:
            raise RuntimeError(
                f"Got segment with null or negative duration: {start_token} {end_token}"
            )

        num_frames = end_token - start_token
        if len(tokens) <= num_frames:
            return AlignmentPlan(tokens, rows, start_token, end_token, unfinished, False)
        # too much text for the audio span: drop the tail and retry, unfinished
        tokens = tokens[: num_frames - 1] + [tokens[-1]]
        rows = np.concatenate([rows[: num_frames - 1], rows[-1:]])
        unfinished = True


# ---------------------------------------------------------------------------
# perform_word_alignment (reference ``transcribe.py:1428-1793``)
# ---------------------------------------------------------------------------


def perform_word_alignment(
    tokens: Sequence[int],
    attention_scores: Optional[np.ndarray],  # (n_tokens, K, n_audio_ctx) pre-softmax
    tokenizer,
    use_space: bool = True,
    max_duration: Optional[int] = None,  # token positions before padding (frames//2)
    refine_whisper_precision_nframes: int = 0,
    remove_punctuation_from_words: bool = False,
    include_punctuation_in_timing: bool = False,
    unfinished_decoding: bool = False,
    medfilt_width: int = 9,
    qk_scale: float = 1.0,
    detect_disfluencies: bool = True,
    subwords_can_be_empty: bool = True,
    plot=False,
    plot_mfcc: Optional[np.ndarray] = None,  # (n_mels, n_frames) window mel
    use_device_kernels: bool = False,
    precomputed_jumps: Optional[np.ndarray] = None,
    precomputed_cost: Optional[np.ndarray] = None,
    device=None,
) -> List[dict]:
    """Words with start/end times for one segment.

    ``precomputed_jumps``: per-token start frames of the planned tokens
    (length len(plan.tokens) + 1) from the batched device aligner, with
    ``precomputed_cost``, its (n_tokens, span) cost (weight edits applied),
    required when ``detect_disfluencies``: peak detection reads its rows.
    Otherwise the cost and the DTW run here from ``attention_scores``: through
    the ``attention_to_cost`` and ``dtw_codes`` kernels on ``device`` (None:
    the card) with ``use_device_kernels``, where their gates hold
    (medfilt_width 9 and qk_scale 1 for the cost, subwords_can_be_empty for
    the DTW), else in numpy. ``plot`` (True, or a path prefix) draws the
    cost, the path and the words (``plotting.plot_alignment``), with the
    window's mel (``plot_mfcc``) and, with disfluencies, each token's
    peaks; it needs the cost and the path, so not the precomputed jumps."""
    plan = plan_alignment(
        tokens, tokenizer, refine_whisper_precision_nframes, unfinished_decoding
    )
    if plan.empty:
        return []
    tokens = plan.tokens
    start_token, end_token = plan.start_token, plan.end_token
    unfinished_decoding = plan.unfinished

    start_time = start_token * AUDIO_TIME_PER_TOKEN

    split_tokens = split_tokens_on_spaces if use_space else split_tokens_on_unicode
    words, word_tokens, word_tokens_indices = split_tokens(
        tokens, tokenizer, remove_punctuation_from_words=remove_punctuation_from_words
    )

    # final punctuation grouped with the final timestamp rather than trailing
    # silence/noise
    num_punctuations_per_tokens = [
        0 if len(w) == 1 or w[-1] not in _punctuation else 1 for w in word_tokens
    ]
    if include_punctuation_in_timing:
        num_punctuations_per_tokens[:-2] = [0] * (len(num_punctuations_per_tokens) - 2)

    if precomputed_jumps is not None:
        assert not plot
        assert not detect_disfluencies or precomputed_cost is not None
        jumps = np.asarray(precomputed_jumps, np.int64)
        assert len(jumps) == len(tokens) + 1, (
            f"Jumps have wrong length: {len(jumps)} != {len(tokens) + 1}"
        )
        weights = None if precomputed_cost is None else np.asarray(precomputed_cost)
        if weights is not None:
            assert weights.shape[0] == len(tokens), (
                f"Cost has wrong row count: {weights.shape[0]} != {len(tokens)}"
            )
    else:
        attention_scores = np.asarray(attention_scores)
        assert attention_scores.shape[0] > int(plan.row_indices.max()), (
            f"Attention has wrong length: {attention_scores.shape[0]} rows, "
            f"need row {int(plan.row_indices.max())}"
        )
        attention_scores = attention_scores[plan.row_indices]
        # (n_tokens, K, ctx) -> (K, n_tokens, span)
        sliced = np.transpose(attention_scores, (1, 0, 2))[..., start_token:end_token]
        if use_device_kernels and medfilt_width == 9 and qk_scale == 1.0:
            weights = _attention_to_cost_device(sliced, device)
        else:
            weights = _attention_to_cost(sliced, medfilt_width, qk_scale)
        if max_duration and start_token < max_duration:
            # the column index is absolute in the reference even though the
            # matrix is sliced (transcribe.py:1565), kept for parity
            weights[:-1, max_duration:] = 0.0
        weights[0, 0] = weights.min()  # encourage the path to start early
        if use_device_kernels and subwords_can_be_empty:
            cost = torch.from_numpy(weights.astype(np.float32)).to(default_device(device))
            index1s, index2s = kernels.dtw_path(cost)
        else:
            index1s, index2s = dtw_path(weights, allow_vertical=subwords_can_be_empty)
        jumps = np.diff(index1s)
        jumps = np.pad(jumps, (1, 0), constant_values=1).astype(bool)
        jumps = index2s[jumps]
        jumps = np.pad(jumps, (0, 1), constant_values=index2s[-1])

    jumps_start = jumps
    disfluences = {}
    peak_traces = [] if (plot and detect_disfluencies) else None
    if detect_disfluencies:
        # a token whose cost row has several attention peaks starts at the
        # last one; the span before it becomes a disfluency mark
        # (reference ``transcribe.py:1656-1736``)
        jumps_start = jumps.copy()
        for i_token, (tok_id, begin, end) in enumerate(zip(tokens, jumps[:-1], jumps[1:])):
            attention_row = -weights[i_token, begin:end]
            peaks, properties = find_peaks(attention_row, width=3, prominence=0.02)
            if peak_traces is not None:
                peak_traces.append((int(begin), int(end), attention_row, peaks, properties))
            if len(peaks) > 1:
                if "left_ips" in properties:
                    left = [round(x) for x in properties["left_ips"]]
                else:
                    left = properties["left_bases"]
                new_begin = left[-1] + begin
                jumps_start[i_token] = new_begin
                if new_begin != begin:
                    is_punctuation = (
                        tokenizer.decode_with_timestamps([tok_id]) in _punctuation
                    )
                    if not is_punctuation:
                        disfluences[i_token] = (begin, jumps_start[i_token])
                    else:
                        disfluences[i_token + 1] = (begin, end)

    word_boundaries = np.cumsum([len(t) for t in word_tokens])
    word_boundaries = np.pad(word_boundaries, (1, 0))
    begin_times = jumps_start[word_boundaries[:-1]] * AUDIO_TIME_PER_TOKEN
    end_times = jumps[word_boundaries[1:] - num_punctuations_per_tokens] * AUDIO_TIME_PER_TOKEN

    if detect_disfluencies:
        to_be_added = []
        i_start = 0
        for i_word, toks in enumerate(word_tokens[:-1]):
            i_end = i_start + len(toks)
            if i_start in disfluences and i_word > 0:
                begin, end = disfluences[i_start]
                to_be_added.append(
                    (i_word, begin * AUDIO_TIME_PER_TOKEN, end * AUDIO_TIME_PER_TOKEN)
                )
            i_start = i_end
        for i_word, begin, end in to_be_added[::-1]:
            words.insert(i_word, DISFLUENCY_MARK)
            word_tokens.insert(i_word, [])
            word_tokens_indices.insert(i_word, [])
            begin_times = np.insert(begin_times, i_word, begin)
            end_times = np.insert(end_times, i_word, end)

    # edge rules: ignore the start/end timestamp pseudo-words (the len guards
    # cover a segment whose only text is an incomplete UTF-8 byte)
    if not refine_whisper_precision_nframes and len(begin_times) > 1:
        begin_times[1] = begin_times[0]
    if not refine_whisper_precision_nframes and len(end_times) > 1:
        end_times[-2] = end_times[-1]
    if unfinished_decoding:
        words = words[1:]
        word_tokens = word_tokens[1:]
        word_tokens_indices = word_tokens_indices[1:]
        begin_times = begin_times[1:]
        end_times = end_times[1:]
    else:
        words = words[1:-1]
        word_tokens = word_tokens[1:-1]
        word_tokens_indices = word_tokens_indices[1:-1]
        begin_times = begin_times[1:-1]
        end_times = end_times[1:-1]

    out = [
        dict(
            text=word,
            start=round_timestamp(begin + start_time),
            end=round_timestamp(end + start_time),
            tokens=toks,
            tokens_indices=toks_indices,
        )
        for word, begin, end, toks, toks_indices in zip(
            words, begin_times, end_times, word_tokens, word_tokens_indices
        )
        if not word.startswith("<|")
    ]
    if plot:
        from .plotting import plot_alignment

        plot_alignment(
            weights, index1s, index2s, out, start_time, plot,
            mfcc=plot_mfcc, mfcc_span=(start_token, end_token),
            peak_traces=peak_traces,
        )
    return out
