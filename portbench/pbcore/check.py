"""The comparison that decides ``correct``.

After the window has closed and the program is freed, a sample of the
finished streams, drawn from the seed and holding the longest, is
transcribed again by the plain reference (``reference/``), window by
window from the stream's own audio: the reference's log-mel and encoder,
then its decoder teacher-forced over the prompt that whisper's rules build
from the tokens served before, and the tokens the program served in that
window. Numbers compared, each beside its limit (the cell's ``limits``):

- ``token_gap``: the widest gap, in nats, by which a served token's
  reference log-probability lies below the best that the decoding rules
  allow at its position (``reference.rules.token_gaps``);
- ``logprob_error`` and ``logprob_error_mean``: the widest and the mean
  difference, in nats, between the log-probability the program reports
  for a served token and the reference's for it under the same rules: they
  read the program's logits error at every position, not only where it
  flips a token;
- ``window_mismatches``: windows whose seek differs from the one the rules
  give after the tokens served before, and streams whose windows end early
  or late (limit 0);
- ``unanswered``: requests due in the window without a result (limit 0).

and of the word aligner, on the alignment the program made for the same
windows as it made it (``program.Observer``), each stage judged on what
the program gave it:

- ``align_score_error`` and ``align_score_error_mean``: the widest and the
  mean difference between the alignment heads' pre-softmax scores the
  decode wrote for each served token and the reference's, teacher-forced
  at the same position (the rows the aligner reads);
- ``align_cost_error``: the widest difference between the cost the
  ``align_cost`` kernel made of each segment and the one the plain aligner
  (``reference.align.cost``) makes of the same rows, frames and limits;
- ``align_start_mismatches``: tokens whose start frame, found by the
  ``dtw`` kernel on that cost, is not the one the plain DTW finds on it
  (``reference.align.dtw_starts``): the frames the word times are made of
  (limit 0);
- ``align_unjudged``: sampled windows whose alignment rows were not seen,
  and 1 if no segment's alignment was (limit 0).

The reference's weights are made again from the seed, in the served type;
it reads the program's served tokens, rows, costs and start frames only
to judge them.

The control (``control=True``): the reference computed one precision
lower in the program's place, at the same prompts and served tokens: the
forward in float8 e4m3 (``reference.model.fp8``; its gap is that of the
token it puts first, its log-probabilities and scores its own), the cost
in bfloat16, and the start frames the plain DTW finds on that cost. The
numbers are then the control's."""

from __future__ import annotations

import collections
import time
from typing import Dict, List

import numpy as np
import torch

from reference import align as ref_align
from reference import mel as ref_mel
from reference import rules
from reference.model import ReferenceModel, fp8, no_tf32

from . import traffic as traffic_mod
from . import weights as weights_mod

GAP_UNSERVABLE = 1e9  # a served token the rules forbid: reported as this many nats


def sample(finished: List[traffic_mod.Item], n: int, seed: int) -> List[traffic_mod.Item]:
    """``n`` finished requests drawn from the seed, the longest among them."""
    if not finished:
        return []
    longest = max(finished, key=lambda it: (it.samples, it.name))
    rest = sorted((it for it in finished if it is not longest), key=lambda it: it.name)
    rng = np.random.default_rng([int(seed), 7])
    picked = [rest[i] for i in rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)]
    return [longest, *picked]


def compare(cell, seed: int, device, pool: np.ndarray, picked: List[traffic_mod.Item],
            windows: List[tuple], unanswered: int, log=print, control: bool = False,
            rows: Dict[tuple, torch.Tensor] = None, segments: List[dict] = ()) -> Dict[str, dict]:
    cfg = cell.config
    dims, vocab = cfg["dims"], cfg["vocabulary"]
    heads = [tuple(h) for h in cfg["alignment_heads"]]
    suppress = rules.suppressed(vocab, cfg["request"]["suppress_tokens"])
    max_init = round(cfg["request"]["max_initial_timestamp_s"] / 0.02)
    rows = rows or {}
    by_stream: Dict[str, List[tuple]] = collections.defaultdict(list)
    for name, seek, toks, lps in windows:
        by_stream[name].append((seek, toks, lps))
    by_window: Dict[tuple, List[dict]] = collections.defaultdict(list)
    for seg in segments:
        by_window[(seg["stream"], seg["seek"])].append(seg)

    t0 = time.perf_counter()
    w = weights_mod.make(dims, cfg["weight_seed"], device)
    ref = ReferenceModel(dims, w)
    low = ReferenceModel(dims, w, lowp=fp8) if control else None
    gaps: List[float] = []
    lp_errors: List[float] = []
    score_max, score_sum, score_n = 0.0, 0.0, 0
    cost_errors: List[float] = []
    start_mismatches = unjudged = n_segments = 0
    mismatches = 0
    n_windows = 0
    with torch.no_grad(), no_tf32():
        for item in picked:
            audio = torch.from_numpy(np.ascontiguousarray(traffic_mod.audio_of(pool, item)))
            logmel = ref_mel.log_mel(audio.to(device), dims["n_mels"]).to(torch.float32)
            content = item.samples // ref_mel.HOP
            seek, history = 0, []
            served = by_stream.get(item.name, [])
            for got_seek, toks, got_lps in served:
                if got_seek != seek or seek >= content or not toks:
                    mismatches += 1
                    log(f"check: {item.name} window at seek {got_seek}, the rules give {seek} "
                        f"(content {content} frames, {len(toks)} tokens)")
                    break
                mel = logmel[None, :, seek: seek + ref_mel.N_FRAMES]
                prompt = rules.prompt_tokens(vocab, history)
                seq = torch.tensor(prompt + toks[:-1], dtype=torch.long, device=device)
                logits, scores = ref.logits(ref.encode(mel), seq, heads)
                logits, scores = logits[len(prompt) - 1:], scores[:, len(prompt) - 1:]
                if control:
                    lowp, low_scores = low.logits(low.encode(mel), seq, heads)
                    lowp, low_scores = lowp[len(prompt) - 1:], low_scores[:, len(prompt) - 1:]
                else:
                    lowp = None
                nums = rules.window_numbers(logits, toks, vocab, suppress, max_init, lowp)
                g = nums["control_gap"] if control else nums["gap"]
                judged = nums["control_lp"] if control else got_lps
                gaps.extend(min(float(x), GAP_UNSERVABLE) for x in g)
                lp_errors.extend(min(abs(a - b), GAP_UNSERVABLE)
                                 for a, b in zip(nums["lp"], judged))
                # the alignment rows: row j of the window's buffer predicts token j
                got_rows = rows.get((item.name, got_seek))
                if got_rows is None:
                    unjudged += 1
                else:
                    m = min(len(toks), got_rows.shape[0])
                    prog = (low_scores.transpose(0, 1)[:m] if control else
                            got_rows[:m].to(device)).double()
                    diff = (prog[..., : scores.shape[-1]] - scores.transpose(0, 1)[:m].double()).abs()
                    score_max = max(score_max, float(diff.max()))
                    score_sum += float(diff.sum())
                    score_n += diff.numel()
                    for seg in by_window.get((item.name, got_seek), []):
                        n, span, maxdur, start = seg["dims"]
                        if int(seg["rows"].max()) >= got_rows.shape[0]:
                            unjudged += 1
                            continue
                        seg_rows = got_rows[torch.as_tensor(seg["rows"])].to(device)
                        want = ref_align.cost(seg_rows, n, span, maxdur, start)
                        if control:
                            got_cost = ref_align.cost(seg_rows, n, span, maxdur, start,
                                                      dtype=torch.bfloat16).float().cpu()
                            got_starts = ref_align.dtw_starts(got_cost.numpy())
                        else:
                            got_cost, got_starts = seg["cost"], seg["starts"]
                        cost_errors.append(float((got_cost.double().to(device) - want).abs().max()))
                        plain = ref_align.dtw_starts(got_cost.numpy())
                        start_mismatches += int((plain != got_starts).sum())
                        n_segments += 1
                n_windows += 1
                used, seek = rules.advance(vocab, toks, seek, content)
                history.extend(toks[:used])
            else:
                if seek < content:
                    mismatches += 1
                    log(f"check: {item.name} ends at seek {seek} of {content} frames")
    if not n_segments:
        unjudged += 1
    arr = np.asarray(gaps) if gaps else np.zeros(1)
    err = np.asarray(lp_errors) if lp_errors else np.zeros(1)
    log(f"check: reference over {len(picked)} requests, {n_windows} windows, {len(gaps)} served "
        f"tokens, {n_segments} aligned segments in {time.perf_counter() - t0:.1f} s; gap mean "
        f"{arr.mean():.6f}, p99 {np.quantile(arr, 0.99):.6f}, tokens off the reference's best "
        f"{int((arr > 1e-9).sum())}; log-probability error mean {err.mean():.6f}, "
        f"p99 {np.quantile(err, 0.99):.6f}")
    limits = cell.spec["limits"]
    return {
        "token_gap": {"value": float(arr.max()) if gaps else GAP_UNSERVABLE,
                      "limit": limits["token_gap"]},
        "logprob_error": {"value": float(err.max()) if lp_errors else GAP_UNSERVABLE,
                          "limit": limits["logprob_error"]},
        "logprob_error_mean": {"value": float(err.mean()) if lp_errors else GAP_UNSERVABLE,
                               "limit": limits["logprob_error_mean"]},
        "align_score_error": {"value": score_max if score_n else GAP_UNSERVABLE,
                              "limit": limits["align_score_error"]},
        "align_score_error_mean": {"value": score_sum / score_n if score_n else GAP_UNSERVABLE,
                                   "limit": limits["align_score_error_mean"]},
        "align_cost_error": {"value": max(cost_errors) if cost_errors else GAP_UNSERVABLE,
                             "limit": limits["align_cost_error"]},
        "align_start_mismatches": {"value": start_mismatches, "limit": 0},
        "align_unjudged": {"value": unjudged, "limit": 0},
        "window_mismatches": {"value": mismatches, "limit": 0},
        "unanswered": {"value": unanswered, "limit": 0},
    }


def passed(numbers: Dict[str, dict]) -> bool:
    return all(v["value"] <= v["limit"] for v in numbers.values())
