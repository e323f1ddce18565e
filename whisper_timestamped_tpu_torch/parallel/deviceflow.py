"""Device-resident window-advance state for the batch pipeline's fast path.

Port of ``whisper_timestamped_tpu/parallel/deviceflow.py``. Everything the
next window's dispatch depends on (each stream's seek, its done flag, and
the rolling token history that feeds ``condition_on_previous_text``
prompts) stays in tensors on the model's device:

    decode(N)  ->  advance_window_state (seek', hist', done')   [device]
                        |
    build_prompt_batch(hist') + window gather  ->  decode(N+1)  [device]

The functions are plain tensor code on whatever device their inputs live
on, with no read to the host. Their rules equal the host path's bit for bit
(``tests/test_torch_batch.py`` holds them to the JAX functions, which
``tests/test_deviceflow.py`` holds to ``extract_window_segments`` and
``DecodeEngine.build_prompt``):

* seek advance: a full ``segment_size`` unless the window ends with an
  incomplete segment after a consecutive-timestamp pair; then seek moves
  to the last paired timestamp; with ``no_speech_threshold`` set, a skipped
  (silent) window advances in full and adds nothing to the history;
* history: the tokens of every completed segment, kept to the last
  ``n_text_ctx // 2 - 1``, the truncation ``build_prompt`` applies;
* prompt: right-aligned ``[sot_prev, history..., sot, lang, task]`` with
  per-row lengths, as ``build_prompt(region=PROMPT_REGION)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..audio import N_FRAMES
from ..engine import INPUT_STRIDE


class WindowState(NamedTuple):
    """Per-stream state between window iterations (all (B,) or (B, H))."""

    seek: torch.Tensor  # int32 mel-frame cursor per stream
    done: torch.Tensor  # bool: seek >= content_frames
    hist: torch.Tensor  # int32 (B, H) rolling prompt history, right-aligned
    count: torch.Tensor  # int32 valid entries in hist (<= H)


def _at(vals: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """vals[b, max(pos[b], 0)] for each row."""
    return torch.gather(vals, 1, pos.clamp(min=0).long()[:, None])[:, 0]


def advance_window_state(
    tokens: torch.Tensor,  # (B, M) int32 decode output (eot-padded)
    state: WindowState,
    content_frames: torch.Tensor,  # (B,) int32
    *,
    eot: int,
    ts_begin: int,
    no_speech_prob: Optional[torch.Tensor] = None,  # (B,) f32, with a threshold
    sum_logprobs: Optional[torch.Tensor] = None,  # (B,) f32, with a threshold
    no_speech_threshold: Optional[float] = None,
    logprob_threshold: Optional[float] = None,
) -> WindowState:
    """One window's seek and history update, all rows at once
    (``deviceflow.py:76``): ``extract_window_segments``'s seek rule and its
    ``all_tokens.extend(seg.tokens)``; with ``no_speech_threshold`` also its
    no-speech skip."""
    B, M = tokens.shape
    tokens = tokens.to(torch.int32)
    idx = torch.arange(M, dtype=torch.int32, device=tokens.device)

    is_eot = tokens == eot
    has_eot = is_eot.any(dim=1)
    first_eot = torch.argmax(is_eot.to(torch.int32), dim=1).to(torch.int32)
    n_text = torch.where(has_eot, first_eot, torch.full_like(first_eot, M))

    valid = idx[None, :] < n_text[:, None]
    is_ts = (tokens >= ts_begin) & valid
    # consec[i]: the SECOND token of a consecutive-timestamp pair
    prev_ts = torch.cat([torch.zeros_like(is_ts[:, :1]), is_ts[:, :-1]], dim=1)
    consec = is_ts & prev_ts
    has_consec = consec.any(dim=1)
    last_consec = torch.where(consec, idx[None, :], torch.full_like(tokens, -1)).amax(dim=1)

    single_ending = (n_text >= 2) & _at(is_ts, n_text - 1) & ~_at(is_ts, n_text - 2)

    segment_size = torch.clamp(content_frames - state.seek, max=N_FRAMES)
    partial_adv = has_consec & ~single_ending
    # tokens that enter the prompt history (completed segments only)
    consumed = torch.where(partial_adv, last_consec, n_text)
    last_ts_pos = _at(tokens, last_consec - 1) - ts_begin
    advance = torch.where(partial_adv, last_ts_pos * INPUT_STRIDE, segment_size)

    if no_speech_threshold is not None:
        # whisper's skip rule: silence advances a full window and adds
        # nothing to the prompt
        skip = no_speech_prob > no_speech_threshold
        if logprob_threshold is not None:
            avg_lp = sum_logprobs / (n_text + 1).to(torch.float32)
            skip = skip & ~(avg_lp > logprob_threshold)
        advance = torch.where(skip, segment_size, advance)
        consumed = torch.where(skip, torch.zeros_like(consumed), consumed)

    new_seek = torch.where(state.done, state.seek, state.seek + advance).to(torch.int32)
    consumed = torch.where(state.done, torch.zeros_like(consumed), consumed)
    done = new_seek >= content_frames

    # slide the right-aligned history left by `consumed`
    H = state.hist.shape[1]
    combined = torch.cat([state.hist, tokens], dim=1)
    start = consumed.clamp(0, M).long()
    cols = start[:, None] + torch.arange(H, device=tokens.device)[None, :]
    new_hist = torch.gather(combined, 1, cols)
    new_count = torch.clamp(state.count + consumed, max=H).to(torch.int32)
    return WindowState(seek=new_seek, done=done, hist=new_hist, count=new_count)


def build_prompt_batch(
    hist: torch.Tensor,  # (B, H) right-aligned history
    count: torch.Tensor,  # (B,)
    sot_seq: torch.Tensor,  # (B, S) int32: [sot, lang, task] (or [sot])
    *,
    region: int,
    eot: int,
    sot_prev: int,
):
    """Device counterpart of ``DecodeEngine.build_prompt`` for a uniform
    full-region batch (``deviceflow.py:151``): right-aligned
    ``[pad..., sot_prev?, history, sot_seq]`` and per-row valid lengths.
    Junk slots hold eot, which the decode masks through ``prompt_len``."""
    B, H = hist.shape
    S = sot_seq.shape[1]
    c = torch.clamp(count, max=H)
    # one extra slot on the left for sot_prev, placed at index H - c
    ext = torch.cat([torch.full((B, 1), eot, dtype=hist.dtype, device=hist.device), hist], dim=1)
    pos = torch.arange(H + 1, device=hist.device)[None, :]
    at_prev = (pos == (H - c)[:, None]) & (c > 0)[:, None]
    ext = torch.where(at_prev, torch.full_like(ext, sot_prev), ext)
    pad_cols = region - (H + 1) - S
    if pad_cols < 0:
        raise ValueError(f"prompt region {region} < history {H} + 1 + sot {S}")
    buf = torch.cat([torch.full((B, pad_cols), eot, dtype=hist.dtype, device=hist.device),
                     ext, sot_seq.to(hist.dtype)], dim=1)
    plen = torch.where(c > 0, c + 1 + S, torch.full_like(c, S)).to(torch.int32)
    return buf, plen


def pack_host_outputs(tokens, token_logprobs, sum_logprobs, no_speech_prob,
                      state: WindowState) -> torch.Tensor:
    """Every per-window output the host needs in ONE (B, 2M+4) float32
    tensor ``[tokens (int32 bits) | logprobs | sum | nsp | done | seek
    (int32 bits)]`` (``deviceflow.py:182``), so the host drains a window
    with one read."""
    as_f32 = lambda t: t.to(torch.int32).contiguous().view(torch.float32)  # noqa: E731
    return torch.cat([
        as_f32(tokens),
        token_logprobs.to(torch.float32),
        sum_logprobs.to(torch.float32)[:, None],
        no_speech_prob.to(torch.float32)[:, None],
        state.done.to(torch.float32)[:, None],
        as_f32(state.seek)[:, None],
    ], dim=1)


def split_host_outputs(packed: np.ndarray, M: int):
    """Host-side inverse of ``pack_host_outputs`` on the fetched array.
    Returns (tokens, token_logprobs, sum_logprobs, no_speech_prob, done,
    seek)."""
    p = np.ascontiguousarray(packed, np.float32)
    tokens = p[:, :M].view(np.int32)
    logprobs = p[:, M: 2 * M]
    sums = p[:, 2 * M]
    nsp = p[:, 2 * M + 1]
    done = p[:, 2 * M + 2] != 0.0
    seek = p[:, 2 * M + 3: 2 * M + 4].view(np.int32)[:, 0]
    return tokens, logprobs, sums, nsp, done, seek


def initial_state(streams_tokens, seeks, content_frames, batch_size: int, hist_len: int,
                  eot: int, device=None):
    """Upload the host's per-stream state (token histories, seeks, content
    frames) as a ``WindowState`` on ``device``; rows past the streams are
    done from the start. Returns (state, content_frames tensor)."""
    B = batch_size
    hist = np.full((B, hist_len), eot, np.int32)
    count = np.zeros((B,), np.int32)
    seek = np.zeros((B,), np.int32)
    frames = np.zeros((B,), np.int32)
    for i, toks in enumerate(streams_tokens):
        tail = list(toks)[-hist_len:]
        if tail:
            hist[i, hist_len - len(tail):] = tail
        count[i] = min(len(toks), hist_len)
        seek[i] = seeks[i]
        frames[i] = content_frames[i]
    put = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    state = WindowState(seek=put(seek), done=put(seek >= frames), hist=put(hist), count=put(count))
    return state, put(frames)
