"""Beam-search window decoding (whisper ``BeamSearchDecoder`` semantics).

Port of ``whisper_timestamped_tpu/decoding_beam.py``. The B windows' K
beams fold into the batch axis as B·K rows, window-major (row ``b*K + k``),
and decode through the greedy engine's ``decode_step``, so the beam path
runs the same kernels: ``flash_attention`` for the encoder and the prompt
prefill, ``self_attn_decode`` with its fused row write over the B·K rows,
and ``xattn_decode`` (or ``xattn_decode_int8``) with ``beam_group=K``,
without scores: a window's K beams read the window's one cross-KV row
(row ``b // K``), which is never tiled.

The token loop is the counterpart of JAX's one-program beam decode: one
step function (``_beam_step``, JAX's ``body``) over device state
(``_BeamLoopState``), updated in place, with no host read. Each step
applies whisper's logit filters per beam row, takes the flat top 2K of
each window's (K·V) candidates in ``lax.top_k``'s order
(``top_candidates``), walks them in that order (``beam_walk``: EOT
candidates retire to a finished pool of ``max_candidates`` = round(K ·
patience), the others fill the K beams), moves the beam state along the
chosen source beams, and feeds the chosen tokens. Each window stops on its
own (pool full, or the text context used up); a frozen window's rows ride
the loop as no-ops. A step run after JAX's loop would have stopped (every
window stopped, or ``max_new`` steps) changes nothing, so the host tests
for the stop only every ``decoding.STOP_CHECK_STEPS`` steps: on the card
those steps are one captured CUDA graph of the engine's ``DecodeGraphs``,
replayed until the stop; on the CPU the same function runs eagerly in the
same chunks. ``rank_beam_results`` (whisper's ``finalize`` and
``MaximumLikelihoodRanker``) runs on the host.

The self cache is never reordered. JAX gathers the whole cache by the
chosen source rows each step (``decoding_beam.py:354-357``); here a row
table ``src_row`` (B·K, ctx) int32 names, for every beam row and slot, the
physical cache row that holds it, and the self-attention kernel reads
through it. A step updates the table (``src_row = src_row[rows]``, then
column P + i set to each row's own index) and the kernel writes the step's
K/V into its own row at slot P + i, a slot no live beam has read. The
prompt slots are prefilled once a window, into beam row ``b*K`` only, and
the table's prompt columns point every beam of window b at that row: no
tiled copy of the prompt region.

The KV-cache levers as the JAX package applies them to beam search: the
cross K/V is int8 when the engine asks for ``kv_int8`` without ``kv_int4``
(so ``kv_int4`` gives a bf16 cross K/V here), and the self cache is never
quantized (``self_kv_int8`` does not apply).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from . import decoding
from .decoding import (DecodeGraphs, _cache_slots, _prefill, apply_timestamp_rules,
                       stop_together, tp_runs_eagerly)
from .models.whisper_torch import (
    WhisperTorch,
    _ln,
    _logits,
    alloc_cache,
    decode_step,
    encode,
    init_cache,
)
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


@dataclass(frozen=True)
class _BeamConfig:
    """What the beam step takes as constants: a captured graph bakes them
    in, so each is part of its key (``DecodeGraphs``)."""

    B: int  # windows
    K: int  # beams a window
    C: int  # finished-pool capacity, max_candidates
    P: int  # prompt region
    max_new: int
    extent: int  # self-cache slots the self-attention spans: P + max_new, within the cache
    n_ctx: int
    eot: int
    ts_begin: int
    no_timestamps: int
    max_initial_timestamp_index: Optional[int]
    suppress_blank: bool
    without_timestamps: bool
    steps: int  # steps a chunk (STOP_CHECK_STEPS)


@dataclass
class _BeamLoopState:
    """The beam loop's state on the device, updated in place by each step
    (JAX's ``while_loop`` carry, ``decoding_beam.py:237-252``), and the
    inputs each window batch fills in (``pad_len``, ``prompt_lens``, the
    masks): a captured graph reads and writes these very tensors.
    ``status`` is (running, steps run), what the host reads after each
    chunk. The pool's arrays have one spare slot, C, that takes the
    candidates not pooled."""

    i: torch.Tensor  # () long: steps run, JAX's loop counter
    status: torch.Tensor  # (2,) long
    last_logits: torch.Tensor  # (B·K, V) f32
    last_token: torch.Tensor  # (B, K) long
    penult_token: torch.Tensor
    max_timestamp: torch.Tensor
    tokens: torch.Tensor  # (B, K, max_new) long
    sum_logprobs: torch.Tensor  # (B, K) f32
    fin_seqs: torch.Tensor  # (B, C + 1, max_new) long
    fin_scores: torch.Tensor  # (B, C + 1) f32
    fin_len: torch.Tensor  # (B, C + 1) long
    n_finished: torch.Tensor  # (B,) long
    steps: torch.Tensor  # (B,) long: each window's steps at its stop
    src_row: torch.Tensor  # (B·K, ctx) int32: the physical row of each beam row's slot
    pad_len: torch.Tensor  # (B·K,) int32
    prompt_lens: torch.Tensor  # (B,) long
    suppress_mask: torch.Tensor  # (V,) f32
    blank_mask: torch.Tensor


def _alloc_beam_state(B: int, K: int, C: int, max_new: int, V: int, ctx: int,
                      device) -> _BeamLoopState:
    z = dict(device=device)
    lng, f32 = dict(dtype=torch.long, **z), dict(dtype=torch.float32, **z)
    return _BeamLoopState(
        i=torch.zeros((), **lng), status=torch.zeros((2,), **lng),
        last_logits=torch.zeros((B * K, V), **f32),
        last_token=torch.zeros((B, K), **lng), penult_token=torch.zeros((B, K), **lng),
        max_timestamp=torch.zeros((B, K), **lng), tokens=torch.zeros((B, K, max_new), **lng),
        sum_logprobs=torch.zeros((B, K), **f32),
        fin_seqs=torch.zeros((B, C + 1, max_new), **lng), fin_scores=torch.zeros((B, C + 1), **f32),
        fin_len=torch.zeros((B, C + 1), **lng), n_finished=torch.zeros((B,), **lng),
        steps=torch.zeros((B,), **lng), src_row=torch.zeros((B * K, ctx), dtype=torch.int32, **z),
        pad_len=torch.zeros((B * K,), dtype=torch.int32, **z),
        prompt_lens=torch.zeros((B,), **lng),
        suppress_mask=torch.zeros((V,), **f32), blank_mask=torch.zeros((V,), **f32),
    )


def _window_done(st: _BeamLoopState, cfg: _BeamConfig) -> torch.Tensor:
    """(B,) each window's stop: pool full, or the total token count would
    exceed n_text_ctx (JAX's ``window_done``)."""
    return (st.n_finished >= cfg.C) | ((st.prompt_lens + st.i) >= cfg.n_ctx - 1)


def _beam_step(model: WhisperTorch, cache, st: _BeamLoopState, cfg: _BeamConfig) -> None:
    """One step of the beam loop, the counterpart of ``body`` at
    ``whisper_timestamped_tpu/decoding_beam.py:275-381``, in place on
    ``st`` and the cache, with no host read. A window takes part when it
    has not stopped and i < max_new (``active``); a step in which no window
    does (JAX's loop has ended) changes no beam, score, pool entry or step
    count and does not advance ``i``. Its cache rows land in slot P + i
    (clamped inside the extent), which no later step of the window reads;
    its pool writes go to the spare slot."""
    B, K, C, V, max_new = cfg.B, cfg.K, cfg.C, model.dims.n_vocab, cfg.max_new
    dev = st.i.device
    i = st.i
    active = ~_window_done(st, cfg) & (i < max_new)  # (B,)
    live = active[:, None]
    logits = st.last_logits
    # filters in whisper's order: blank, suppress, timestamp rules
    if cfg.suppress_blank:
        logits = torch.where(i == 0, logits + st.blank_mask[None], logits)
    logits = logits + st.suppress_mask[None]
    if not cfg.without_timestamps:
        logits = apply_timestamp_rules(
            logits, st.last_token.reshape(-1), st.penult_token.reshape(-1),
            st.max_timestamp.reshape(-1), i,
            ts_begin=cfg.ts_begin, eot=cfg.eot, no_timestamps=cfg.no_timestamps,
            max_initial_timestamp_index=cfg.max_initial_timestamp_index,
        )
    logprobs = torch.log_softmax(logits, dim=-1).reshape(B, K, V)
    flat = (st.sum_logprobs[:, :, None] + logprobs).reshape(B, K * V)
    top_scores, top_idx = top_candidates(flat, 2 * K)
    src_beam, token = top_idx // V, top_idx % V
    sel_src, sel_tok, sel_score, fin_slot, n_fin = beam_walk(
        top_scores, src_beam, token, active, st.n_finished, st.sum_logprobs,
        eot=cfg.eot, beam_size=K, max_candidates=C)

    # pooled candidates keep their source's tokens before token i
    bidx = torch.arange(B, device=dev)[:, None]
    st.fin_seqs.scatter_(1, fin_slot[:, :, None].expand(-1, -1, max_new),
                         st.tokens[bidx, src_beam])
    st.fin_scores.scatter_(1, fin_slot, top_scores)
    st.fin_len.scatter_(1, fin_slot, torch.zeros_like(fin_slot).add_(i))
    st.n_finished.copy_(n_fin)

    # the beam state follows the selected source beams; token i goes to
    # column i (a step with i = max_new writes column max_new - 1 back as
    # it is: JAX's mode="drop")
    tokens = st.tokens[bidx, sel_src]
    col = i.clamp(max=max_new - 1).reshape(1)
    tok_i = torch.where(live, sel_tok, tokens.index_select(2, col)[:, :, 0])
    st.tokens.copy_(tokens.index_copy_(2, col, tok_i[:, :, None]))
    max_ts = st.max_timestamp[bidx, sel_src]
    st.max_timestamp.copy_(torch.where((sel_tok >= cfg.ts_begin) & live,
                                       torch.maximum(max_ts, sel_tok), max_ts))
    st.penult_token.copy_(torch.where(live, st.last_token[bidx, sel_src], st.penult_token))
    st.last_token.copy_(torch.where(live, sel_tok, st.last_token))
    st.sum_logprobs.copy_(sel_score)

    # no cache reorder: the row table follows the source beams, and slot
    # P + i of every row is its own, written by this step's forward
    rows = (bidx * K + sel_src).reshape(-1)
    slot = (cfg.P + i).clamp(max=cfg.extent - 1).to(torch.int32)
    st.src_row.copy_(st.src_row[rows])
    st.src_row.index_copy_(1, slot.long().reshape(1),
                           torch.arange(B * K, dtype=torch.int32, device=dev)[:, None])
    logits_new, _ = decode_step(
        model, sel_tok.reshape(-1, 1), cache, slot, pos_offset=st.pad_len,
        kv_valid_from=st.pad_len, beam_group=K, extent=cfg.extent, src_row=st.src_row,
    )
    rows_live = live.expand(B, K).reshape(-1, 1)
    st.last_logits.copy_(torch.where(rows_live, logits_new[:, -1].float(), st.last_logits))
    st.steps.copy_(torch.where(active, i + 1, st.steps))
    st.i.add_(active.any().long())


def _beam_chunk(model, cache, st: _BeamLoopState, cfg: _BeamConfig, n: int) -> None:
    """``n`` steps (at most ``cfg.steps``), then the status the host reads:
    (running, steps run); running is JAX's ``cond``, the MAX over ``tp`` on a
    tensor-parallel module (``decoding.stop_together``)."""
    for _ in range(n):
        _beam_step(model, cache, st, cfg)
    running = (st.i < cfg.max_new) & (~_window_done(st, cfg)).any()
    st.status.copy_(torch.stack([running.long(), st.i]))
    stop_together(model, st.status)


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
    graphs: Optional[DecodeGraphs] = None,
    uncaptured: bool = False,
) -> dict:
    """B windows' beam searches in lock-step over encoded audio
    (``_beam_core_batched``, ``decoding_beam.py:135``). Returns per window:
    finished_seqs (B, C, max_new), finished_scores (B, C), finished_len
    (B, C), n_finished (B,), beam_tokens (B, K, max_new), beam_scores
    (B, K), n_steps (B,) and no_speech_prob (B,). The count
    ``beam_chunks`` gets the loop's chunks of ``STOP_CHECK_STEPS`` steps
    (graph replays on the card, each one host sync).

    On CUDA the loop replays the captured graphs of ``graphs`` (the
    engine's; a new ``DecodeGraphs`` when None) on their persistent
    buffers: a cache per (B, K, cross lever) with B cross-KV rows and B·K
    self rows, and the loop state; the results are copied out of them.
    ``uncaptured=True`` runs the same step function eagerly on buffers of
    its own instead, the run a captured one is compared with; no path of
    the package passes it. On the CPU the loop always runs eagerly; a
    tensor-parallel module's loop is captured over NCCL and runs eagerly
    over gloo, counted in ``tp_eager_chunks`` (``decoding.decode_window``)."""
    dims = model.dims
    dev = xa.device
    B, T = xa.shape[:2]
    K, C = beam_size, max_candidates
    R = B * K
    P = prompts.shape[1]
    V = dims.n_vocab
    no_speech = no_timestamps - 1
    prompts = prompts.to(dev).long()
    prompt_lens = prompt_lens.to(dev)
    eager_tp = tp_runs_eagerly(model)
    captured = dev.type == "cuda" and not uncaptured and not eager_tp
    if captured and graphs is None:
        graphs = DecodeGraphs()

    # the cross K/V at B rows (read with beam_group=K), the self cache at B·K
    if captured:
        out = graphs.cache(model, B, T, xa.dtype, kv_int8, False, self_rows=R)
    else:
        out = alloc_cache(model, B, T, _cache_slots(model, P, max_new), xa.dtype, dev, kv_int8,
                          self_rows=R)
    cache = init_cache(model, xa, quantize_cross=kv_int8, out=out)
    ctx = cache.k.shape[2]
    pad_b = (P - prompt_lens).to(torch.int32)

    with stage_timer("prefill"):
        # one prefill a window, into beam row b*K: a window's beams are
        # equal until the first sampled token (beam 0 alone starts at score 0)
        x, _ = _prefill(model, cache._replace(k=cache.k[:, ::K], v=cache.v[:, ::K]), prompts,
                        pad_b, [])
        x_sel = x[:, [P - sot_index_from_end, P - 1]]
        sel_logits = _logits(_ln(x_sel, model.decoder["ln_g"], model.decoder["ln_b"]),
                             model.decoder)
        no_speech_prob = torch.softmax(sel_logits[:, 0].float(), dim=-1)[:, no_speech]
        last_logits = sel_logits[:, 1].float()

    k = decoding.STOP_CHECK_STEPS
    cfg = _BeamConfig(
        B=B, K=K, C=C, P=P, max_new=max_new, extent=min(P + max_new, ctx), n_ctx=dims.n_text_ctx,
        eot=eot, ts_begin=ts_begin, no_timestamps=no_timestamps,
        max_initial_timestamp_index=max_initial_timestamp_index, suppress_blank=suppress_blank,
        without_timestamps=without_timestamps, steps=k,
    )

    def make_state():
        return _alloc_beam_state(B, K, C, max_new, V, ctx, dev)

    st = graphs.state(("beam", B, K, C, max_new, ctx), make_state) if captured else make_state()

    def chunk(n: int) -> None:
        _beam_chunk(model, cache, st, cfg, n)

    key = (cfg, cache.k.dtype, cache.xk.dtype)
    if captured:
        graphs.ensure(key, chunk, k, False)
    # this window batch's initial state (JAX's ``init``), in place
    st.i.zero_()
    st.last_logits.copy_(last_logits[:, None].expand(B, K, V).reshape(R, V))
    st.last_token.copy_(prompts[:, -1:].expand(B, K))
    st.penult_token.copy_(prompts[:, -2:-1].expand(B, K))
    st.max_timestamp.fill_(ts_begin - 1)
    st.tokens.fill_(eot)
    st.sum_logprobs.fill_(NEG)
    st.sum_logprobs[:, 0] = 0.0
    st.fin_seqs.fill_(eot)
    st.fin_scores.fill_(NEG)
    st.fin_len.zero_()
    st.n_finished.zero_()
    st.steps.zero_()
    # the prompt slots of every beam of window b are row b*K's
    row = torch.arange(R, device=dev)
    st.src_row.copy_(torch.where(torch.arange(ctx, device=dev)[None] < P, (row // K * K)[:, None],
                                 row[:, None]))
    st.pad_len.copy_(pad_b[:, None].expand(B, K).reshape(R))
    st.prompt_lens.copy_(prompt_lens)
    st.suppress_mask.copy_(suppress_mask)
    st.blank_mask.copy_(blank_mask)

    n_steps = chunks = 0
    with stage_timer("decode_loop"):
        for chunks in range(1, -(-max_new // k) + 1):
            if captured:
                graphs.replay(key)
            else:
                chunk(k)
            running, n_steps = st.status.tolist()  # the chunk's one host sync
            if not running:
                break
    add_count("decode_steps", n_steps)
    add_count("beam_chunks", chunks)
    if eager_tp:
        add_count("tp_eager_chunks", chunks)
    # copies: the state is the next window batch's
    return dict(
        finished_seqs=st.fin_seqs[:, :C].clone(),
        finished_scores=st.fin_scores[:, :C].clone(),
        finished_len=st.fin_len[:, :C].clone(),
        n_finished=st.n_finished.clone(),
        beam_tokens=st.tokens.clone(),
        beam_scores=st.sum_logprobs.clone(),
        n_steps=st.steps.clone(),
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
