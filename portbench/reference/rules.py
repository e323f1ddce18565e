"""Whisper's decoding rules, as openai/whisper ``decoding.py`` and
``transcribe.py`` state them, written plainly: the prompt of a window, the
logit filters of greedy decoding (SuppressTokens, SuppressBlank,
ApplyTimestampRules), and the seek advance and prompt history after a
window. ``vocab`` is the configuration file's ``vocabulary`` section."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

HISTORY = 223  # n_text_ctx // 2 - 1 prompt tokens at most
FRAMES_PER_POSITION = 2  # mel frames per timestamp step (0.02 s)
N_FRAMES = 3000


def prompt_tokens(vocab: Dict, history: Sequence[int]) -> List[int]:
    """[sot_prev, last 223 history tokens] when there is history, then the
    start sequence [sot, language, task]."""
    start = [vocab["sot"], vocab["language_en"], vocab["transcribe"]]
    if not history:
        return start
    return [vocab["sot_prev"], *list(history)[-HISTORY:], *start]


def suppressed(vocab: Dict, suppress_tokens: Sequence[int]) -> List[int]:
    """SuppressTokens' list: the request's ids plus the task and start
    tokens and <|nospeech|>."""
    extra = [vocab[k] for k in ("transcribe", "translate", "sot", "sot_prev", "sot_lm", "no_speech")]
    return sorted(set(int(t) for t in suppress_tokens) | set(extra))


def _filtered(logits_row: torch.Tensor, prev: Sequence[int], vocab: Dict, base: torch.Tensor,
              ids: torch.Tensor, is_ts: torch.Tensor, max_initial_index: int) -> torch.Tensor:
    """float64 log-probabilities of one row under the rules that depend
    only on the tokens ``prev`` sampled before it."""
    ts_begin, eot = vocab["timestamp_begin"], vocab["eot"]
    row = logits_row.double() + base
    if not prev:
        row[[vocab["blank"], eot]] = float("-inf")
        row = row.masked_fill(~is_ts | (ids > ts_begin + max_initial_index), float("-inf"))
    else:
        last_ts = prev[-1] >= ts_begin
        penult_ts = len(prev) < 2 or prev[-2] >= ts_begin
        if last_ts and penult_ts:
            row = row.masked_fill(is_ts, float("-inf"))
        elif last_ts:
            row = row.masked_fill(ids < eot, float("-inf"))
        stamps = [t for t in prev if t >= ts_begin]
        if stamps:
            floor = stamps[-1] if (last_ts and not penult_ts) else stamps[-1] + 1
            row = row.masked_fill(is_ts & (ids < floor), float("-inf"))
    return torch.log_softmax(row, -1)


def _judge(lp: torch.Tensor, y: int, is_ts: torch.Tensor, ts_begin: int) -> Tuple[float, float]:
    """(gap, log-probability) of token ``y`` in the row ``lp``."""
    if not torch.isfinite(lp[y]):
        return float("inf"), float("inf")
    ts_mass = torch.logsumexp(lp[is_ts], 0)
    text_max = lp[~is_ts].max()
    m = float(ts_mass - text_max) if torch.isfinite(ts_mass) else float("-inf")
    if y >= ts_begin:
        return max(0.0, -m) + float(lp[is_ts].max() - lp[y]), float(lp[y] - ts_mass)
    return max(0.0, m) + float(text_max - lp[y]), float(lp[y])


def _first(lp: torch.Tensor, is_ts: torch.Tensor) -> int:
    """The token greedy decoding takes from the row ``lp``: a timestamp when
    the timestamps' summed probability beats every other token's, else the
    most likely token."""
    ts_mass = torch.logsumexp(lp[is_ts], 0)
    if torch.isfinite(ts_mass) and ts_mass > lp[~is_ts].max():
        return int(torch.where(is_ts, lp, torch.full_like(lp, float("-inf"))).argmax())
    return int(lp.argmax())


def window_numbers(logits: torch.Tensor, served: Sequence[int], vocab: Dict,
                   suppress: Sequence[int], max_initial_index: int,
                   control: torch.Tensor = None) -> Dict[str, List[float]]:
    """Per served token: ``gap`` and ``lp``, and with ``control`` also
    ``control_gap`` and ``control_lp``. ``logits`` (M, V) float32 row j
    predicts ``served[j]`` after ``served[:j]``; ``control`` is the same
    computed in a lower precision.

    A gap is how far a token's reference log-probability lies below the
    best the rules allow, in nats. The rules that depend only on the tokens
    before (suppression, the blank at the first position, timestamps in
    pairs, never decreasing, the first one within ``max_initial_index``)
    mask the row; a token they forbid reads +inf. The rule that depends on
    the logits (a timestamp is forced when the timestamps' summed
    probability beats every other token's) is judged by its margin m =
    logsumexp(timestamps) - max(text): a timestamp where m < 0 adds -m, a
    text token where m > 0 adds m; to that the token's shortfall from the
    best of its own class.

    ``lp`` is the served token's log-probability under the filtered logits
    as greedy decoding reports it, the forcing rule decided as the served
    token's class says (a timestamp: forced; text: not). The control's gap
    is that of the token the control puts first, its ``lp`` the served
    token's under the control's logits."""
    M, V = logits.shape
    ts_begin = vocab["timestamp_begin"]
    dev = logits.device
    ids = torch.arange(V, device=dev)
    is_ts = ids >= ts_begin
    base = torch.zeros(V, dtype=torch.float64, device=dev)
    base[list(suppress)] = float("-inf")
    base[vocab["no_timestamps"]] = float("-inf")
    out: Dict[str, List[float]] = {"gap": [], "lp": []}
    if control is not None:
        out.update(control_gap=[], control_lp=[])
    for j in range(M):
        prev = list(served[:j])
        y = int(served[j])
        lp = _filtered(logits[j], prev, vocab, base, ids, is_ts, max_initial_index)
        gap, lp_y = _judge(lp, y, is_ts, ts_begin)
        out["gap"].append(gap)
        out["lp"].append(lp_y)
        if control is not None:
            lpc = _filtered(control[j], prev, vocab, base, ids, is_ts, max_initial_index)
            out["control_gap"].append(_judge(lp, _first(lpc, is_ts), is_ts, ts_begin)[0])
            out["control_lp"].append(_judge(lpc, y, is_ts, ts_begin)[1])
    return out


def advance(vocab: Dict, tokens: Sequence[int], seek: int, content_frames: int) -> Tuple[int, int]:
    """(tokens that enter the history, new seek) after a window decoded at
    ``seek``: whisper's segmentation at consecutive timestamps. A window
    that ends inside a segment gives back the tokens after the last pair and
    seeks to that pair's time; otherwise all tokens enter and the seek moves
    a whole window (or to the end of the content)."""
    ts_begin = vocab["timestamp_begin"]
    toks = list(tokens)
    is_ts = [t >= ts_begin for t in toks]
    size = min(N_FRAMES, content_frames - seek)
    single_ending = len(toks) >= 2 and is_ts[-1] and not is_ts[-2]
    pairs = [i + 1 for i in range(len(toks) - 1) if is_ts[i] and is_ts[i + 1]]
    if pairs and not single_ending:
        last = pairs[-1]
        return last, seek + (toks[last - 1] - ts_begin) * FRAMES_PER_POSITION
    return len(toks), seek + size
