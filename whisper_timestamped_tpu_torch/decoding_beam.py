"""Beam-search window decoding (whisper ``BeamSearchDecoder`` semantics).

Port of ``whisper_timestamped_tpu/decoding_beam.py``. The B windows' K
beams fold into the batch axis as B·K rows, window-major (row ``b*K + k``),
and decode through the greedy engine's ``decode_step``, so the beam path
runs the same kernels: ``flash_attention`` for the encoder and the prompt
prefill, ``self_attn_decode`` with its fused row write over the B·K rows,
and ``xattn_decode`` (or ``xattn_decode_int8``) with ``beam_group=K``,
without scores: a window's K beams read the window's one cross-KV row
(row ``b // K``), which is never tiled.

The prompt region is prefilled once per window (B rows, through the greedy
``_prefill``); the self caches are then tiled to the B·K rows. Each step
applies whisper's logit filters per beam row, takes the flat top 2K of each
window's (K·V) candidates in ``lax.top_k``'s order (``top_candidates``),
walks them in that order (``beam_walk``: EOT candidates retire to a
finished pool of ``max_candidates`` = round(K · patience), the others fill
the K beams), reorders the beam state and the written self-cache slots
along the chosen source beams, and feeds the chosen tokens. Each window
stops on its own (pool full, or the text context used up); a frozen
window's rows ride the loop as no-ops. The loop checks on the host, once
a step, whether every window has stopped. ``rank_beam_results`` (whisper's
``finalize`` and ``MaximumLikelihoodRanker``) runs on the host.

The KV-cache levers as the JAX package applies them to beam search: the
cross K/V is int8 when the engine asks for ``kv_int8`` without ``kv_int4``
(so ``kv_int4`` gives a bf16 cross K/V here), and the self cache is never
quantized (``self_kv_int8`` does not apply).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .decoding import _prefill, apply_timestamp_rules
from .models.whisper_torch import WhisperTorch, _ln, _logits, decode_step, encode, init_cache
from .utils.profiling import add_count, stage_timer

NEG = -1e30  # the score of a beam that does not exist yet


def _sortable(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 with the same order (-inf lowest): the sign-magnitude
    bits as a two's-complement integer."""
    b = x.contiguous().view(torch.int32).long()
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def top_candidates(flat: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``n`` largest entries of each row of ``flat`` (B, N) in
    ``lax.top_k``'s order: descending, equal values by ascending index.
    ``torch.topk`` promises no order among ties, so it runs on a unique
    int64 key, the value's order bits above the reversed index. Returns
    (scores (B, n) f32, indices (B, n) int64)."""
    N = flat.shape[-1]
    rev = (N - 1) - torch.arange(N, device=flat.device)
    key = _sortable(flat) * (1 << 32) + rev
    idx = (N - 1) - (torch.topk(key, n, dim=-1).values & 0xFFFFFFFF)
    return torch.gather(flat, 1, idx), idx


def beam_walk(top_scores, src_beam, token, active, n_finished, sum_logprobs, *,
              eot: int, beam_size: int, max_candidates: int):
    """The candidate walk of one step, for every window at once.

    Each window's 2K candidates (``top_scores``, ``src_beam``, ``token``,
    (B, 2K), best first) are taken in order: an EOT candidate goes to the
    finished pool while the pool has room, any other fills the next of the
    K beams; the walk ends when K beams are filled (whisper's break at K).
    A window that is not ``active`` takes nothing and keeps its beams (its
    sources the identity, its token EOT, its scores ``sum_logprobs``).
    Computed by cumulative sums over the candidates, with no host sync.

    Returns (sel_src, sel_tok, sel_score) (B, K), the pool slot of each
    candidate (B, 2K; ``max_candidates`` where the candidate is not
    pooled) and the pool's new fill count (B,)."""
    K, C = beam_size, max_candidates
    B = token.shape[0]
    dev = token.device
    is_eot = token == eot
    live = active[:, None]
    # non-EOT candidates before each one: the beam slot it would fill
    before = torch.cumsum((~is_eot).long(), dim=1) - (~is_eot).long()
    open_ = (before < K) & live
    take_beam = ~is_eot & open_
    eligible = is_eot & open_
    fin_rank = n_finished[:, None] + torch.cumsum(eligible.long(), dim=1) - eligible.long()
    take_fin = eligible & (fin_rank < C)
    fin_slot = torch.where(take_fin, fin_rank, torch.full_like(fin_rank, C))

    slot = torch.where(take_beam, before, torch.full_like(before, K))
    sel_src = torch.zeros((B, K + 1), dtype=torch.long, device=dev).scatter_(1, slot, src_beam)
    sel_tok = torch.zeros((B, K + 1), dtype=torch.long, device=dev).scatter_(1, slot, token)
    sel_score = torch.zeros((B, K + 1), dtype=torch.float32, device=dev).scatter_(1, slot,
                                                                                  top_scores)
    ident = torch.arange(K, device=dev)[None].expand(B, K)
    sel_src = torch.where(live, sel_src[:, :K], ident)
    sel_tok = torch.where(live, sel_tok[:, :K], eot)
    sel_score = torch.where(live, sel_score[:, :K], sum_logprobs)
    n_fin = n_finished + take_fin.long().sum(dim=1)
    return sel_src, sel_tok, sel_score, fin_slot, n_fin


def reorder_rows(cur: torch.Tensor, spare: torch.Tensor, rows: torch.Tensor,
                 n_slots: int) -> torch.Tensor:
    """Gather rows ``rows`` of the self cache ``cur`` (L, R, ctx, D) into
    ``spare``, slots [0, n_slots) only: the slots written so far. Returns
    ``spare``, which becomes the cache; later slots are written before they
    are read."""
    torch.index_select(cur[:, :, :n_slots], 1, rows, out=spare[:, :, :n_slots])
    return spare


@torch.no_grad()
def decode_window_beam_batch(
    model: WhisperTorch,
    mels: torch.Tensor,  # (B, n_mels, 3000)
    prompts: torch.Tensor,  # (B, P) right-aligned
    prompt_lens: torch.Tensor,  # (B,)
    suppress_mask: torch.Tensor,
    blank_mask: torch.Tensor,
    **kw,
) -> dict:
    """B windows' beam searches in one loop (``decode_window_beam_batch_jit``,
    ``decoding_beam.py:90``): the encoder over the batch, then
    ``beam_core``. Every returned tensor has a leading window axis."""
    with stage_timer("encode"):
        xa = encode(model, mels.to(model.device))
    return beam_core(model, xa, prompts, prompt_lens, suppress_mask, blank_mask, **kw)


def decode_window_beam(model: WhisperTorch, mel: torch.Tensor, prompt: torch.Tensor,
                       prompt_len, suppress_mask, blank_mask, **kw) -> dict:
    """Single-window beam decode (``decode_window_beam_jit``,
    ``decoding_beam.py:48``): the B=1 case of the batch, its window axis
    dropped."""
    out = decode_window_beam_batch(
        model, mel.reshape(1, *mel.shape[-2:]), prompt.reshape(1, -1),
        torch.as_tensor(prompt_len).reshape(1), suppress_mask, blank_mask, **kw)
    return {k: v[0] for k, v in out.items()}


@torch.no_grad()
def beam_core(
    model: WhisperTorch,
    xa: torch.Tensor,  # (B, T, D) encoded audio
    prompts: torch.Tensor,  # (B, P)
    prompt_lens: torch.Tensor,  # (B,)
    suppress_mask: torch.Tensor,
    blank_mask: torch.Tensor,
    *,
    beam_size: int,
    max_candidates: int,
    max_new: int,
    eot: int,
    ts_begin: int,
    no_timestamps: int,
    sot_index_from_end: int,
    max_initial_timestamp_index: Optional[int],
    suppress_blank: bool = True,
    without_timestamps: bool = False,
    kv_int8: bool = False,
) -> dict:
    """B windows' beam searches in lock-step over encoded audio
    (``_beam_core_batched``, ``decoding_beam.py:135``). Returns per window:
    finished_seqs (B, C, max_new), finished_scores (B, C), finished_len
    (B, C), n_finished (B,), beam_tokens (B, K, max_new), beam_scores
    (B, K), n_steps (B,) and no_speech_prob (B,)."""
    dims = model.dims
    dev = xa.device
    B = xa.shape[0]
    K, C = beam_size, max_candidates
    P = prompts.shape[1]
    V = dims.n_vocab
    no_speech = no_timestamps - 1
    prompts = prompts.to(dev).long()
    prompt_lens = prompt_lens.to(dev)
    bidx = torch.arange(B, device=dev)

    ctx_len = min(((P + max_new + 7) // 8) * 8, ((dims.n_text_ctx + 7) // 8) * 8 + 8)
    cache = init_cache(model, xa, ctx_len=ctx_len, quantize_cross=kv_int8)
    pad_b = (P - prompt_lens).to(torch.int32)
    pad_len = pad_b.repeat_interleave(K)  # (B*K,) each row's left padding

    with stage_timer("prefill"):
        # one prefill a window: a window's beams are equal until the first
        # sampled token (beam 0 alone starts at score 0)
        x, _ = _prefill(model, cache, prompts, pad_b, [])
        x_sel = x[:, [P - sot_index_from_end, P - 1]]
        sel_logits = _logits(_ln(x_sel, model.decoder["ln_g"], model.decoder["ln_b"]),
                             model.decoder)
        no_speech_prob = torch.softmax(sel_logits[:, 0].float(), dim=-1)[:, no_speech]
        last_logits = sel_logits[:, 1].float().repeat_interleave(K, dim=0)  # (B*K, V)
    # the self caches tiled to K rows a window; the cross K/V stays (L, B, T, D)
    k_cur = cache.k.repeat_interleave(K, dim=1)
    v_cur = cache.v.repeat_interleave(K, dim=1)
    cache = cache._replace(k=k_cur, v=v_cur)
    k_spare, v_spare = torch.empty_like(k_cur), torch.empty_like(v_cur)

    last_token = prompts[:, -1:].expand(B, K)
    penult_token = prompts[:, -2:-1].expand(B, K)
    max_timestamp = torch.full((B, K), ts_begin - 1, dtype=torch.long, device=dev)
    tokens = torch.full((B, K, max_new), eot, dtype=torch.long, device=dev)
    sum_logprobs = torch.full((B, K), NEG, dtype=torch.float32, device=dev)
    sum_logprobs[:, 0] = 0.0
    # the finished pool, with one spare slot that takes the candidates not pooled
    fin_seqs = torch.full((B, C + 1, max_new), eot, dtype=torch.long, device=dev)
    fin_scores = torch.full((B, C + 1), NEG, dtype=torch.float32, device=dev)
    fin_len = torch.zeros((B, C + 1), dtype=torch.long, device=dev)
    n_finished = torch.zeros((B,), dtype=torch.long, device=dev)
    steps = torch.zeros((B,), dtype=torch.long, device=dev)

    i = 0
    with stage_timer("decode_loop"):
        while i < max_new:
            # per-window stop: pool full, or the text context used up
            done = (n_finished >= C) | ((prompt_lens + i) >= dims.n_text_ctx - 1)
            if bool(done.all()):
                break
            active = ~done
            logits = last_logits
            if suppress_blank and i == 0:
                logits = logits + blank_mask[None]
            logits = logits + suppress_mask[None]
            if not without_timestamps:
                logits = apply_timestamp_rules(
                    logits, last_token.reshape(-1), penult_token.reshape(-1),
                    max_timestamp.reshape(-1), i,
                    ts_begin=ts_begin, eot=eot, no_timestamps=no_timestamps,
                    max_initial_timestamp_index=max_initial_timestamp_index,
                )
            logprobs = torch.log_softmax(logits, dim=-1).reshape(B, K, V)
            flat = (sum_logprobs[:, :, None] + logprobs).reshape(B, K * V)
            top_scores, top_idx = top_candidates(flat, 2 * K)
            src_beam, token = top_idx // V, top_idx % V
            sel_src, sel_tok, sel_score, fin_slot, n_finished_new = beam_walk(
                top_scores, src_beam, token, active, n_finished, sum_logprobs,
                eot=eot, beam_size=K, max_candidates=C)

            # pooled candidates keep their source's tokens before token i
            seqs = tokens[bidx[:, None], src_beam]  # (B, 2K, max_new)
            fin_seqs.scatter_(1, fin_slot[:, :, None].expand(-1, -1, max_new), seqs)
            fin_scores.scatter_(1, fin_slot, top_scores)
            fin_len.scatter_(1, fin_slot, torch.full_like(fin_slot, i))
            n_finished = n_finished_new

            # the beam state follows the selected source beams
            tokens = tokens[bidx[:, None], sel_src]
            tokens[:, :, i] = torch.where(active[:, None], sel_tok, tokens[:, :, i])
            max_ts_g = max_timestamp[bidx[:, None], sel_src]
            max_timestamp = torch.where((sel_tok >= ts_begin) & active[:, None],
                                        torch.maximum(max_ts_g, sel_tok), max_ts_g)
            penult_token = last_token[bidx[:, None], sel_src]
            last_token = sel_tok
            sum_logprobs = sel_score
            rows = (bidx[:, None] * K + sel_src).reshape(-1)
            with stage_timer("beam_reorder"):
                k_next = reorder_rows(cache.k, k_spare, rows, P + i)
                v_next = reorder_rows(cache.v, v_spare, rows, P + i)
                k_spare, v_spare = cache.k, cache.v
                cache = cache._replace(k=k_next, v=v_next)
            logits_new, _ = decode_step(
                model, sel_tok.reshape(-1, 1), cache, P + i,
                pos_offset=pad_len, kv_valid_from=pad_len, beam_group=K,
            )
            last_logits = logits_new[:, -1].float()
            steps = torch.where(active, i + 1, steps)
            i += 1
    add_count("decode_steps", i)
    return dict(
        finished_seqs=fin_seqs[:, :C],
        finished_scores=fin_scores[:, :C],
        finished_len=fin_len[:, :C],
        n_finished=n_finished,
        beam_tokens=tokens,
        beam_scores=sum_logprobs,
        n_steps=steps,
        no_speech_prob=no_speech_prob,
    )


def rank_beam_results(
    out: dict, eot: int, length_penalty: Optional[float]
) -> Tuple[list, float]:
    """Host-side finalization + MaximumLikelihoodRanker (whisper semantics),
    ``decoding_beam.py:396`` of the JAX package, as it is.

    Returns (tokens excluding eot, sum_logprob of the winner).
    """
    n_fin = int(out["n_finished"])
    seqs = np.asarray(out["finished_seqs"])[:n_fin]
    scores = np.asarray(out["finished_scores"])[:n_fin].tolist()
    lens = np.asarray(out["finished_len"])[:n_fin].tolist()
    candidates = [(seqs[j][: lens[j]].tolist(), scores[j]) for j in range(n_fin)]

    beam_size = int(np.asarray(out["beam_tokens"]).shape[0])
    if len(candidates) < beam_size:
        # whisper's BeamSearchDecoder.finalize: only when fewer than beam_size
        # sequences finished, pad with still-running beams (descending score)
        # until beam_size candidates exist — NOT up to max_candidates
        beam_tokens = np.asarray(out["beam_tokens"])
        beam_scores = np.asarray(out["beam_scores"])
        order = np.argsort(-beam_scores)
        n_steps = int(np.asarray(out["n_steps"]).reshape(-1)[0])
        for b in order:
            if len(candidates) >= beam_size:
                break
            toks = beam_tokens[b][:n_steps].tolist()
            toks = toks[: toks.index(eot)] if eot in toks else toks
            candidates.append((toks, float(beam_scores[b])))

    assert candidates, "beam search produced no candidates"

    def penalty(length):
        if length_penalty is None:
            return max(length, 1)
        return ((5.0 + length) / 6.0) ** length_penalty

    ranked = max(candidates, key=lambda ts: ts[1] / penalty(len(ts[0])))
    return ranked[0], ranked[1]
