"""Window decoding with whisper's logit filters, in PyTorch.

Port of ``whisper_timestamped_tpu/decoding.py``. ``decode_window`` is the
counterpart of ``decode_window_jit``: it encodes a batch of 30-s windows,
prefills the right-aligned prompt region, then runs the token loop into
preallocated buffers of fixed shape: the chosen tokens, their filtered
log-probabilities, the timestamp-slice log-probabilities, and the
alignment heads' cross-attention rows. Row convention as in the reference:
``attn[:, k]`` is the attention of the forward that predicted token k.

The token loop is the counterpart of JAX's ``lax.while_loop``: one step
function (``_loop_step``, JAX's ``body``) over device state, with no host
read. Its step index is a device tensor, and a step that runs after JAX's
loop would have stopped (every row finished, or ``max_new`` steps) changes
nothing, so the host tests for the stop only every ``STOP_CHECK_STEPS``
steps. On the card, ``STOP_CHECK_STEPS`` steps are one captured CUDA graph
(``DecodeGraphs``, owned by the engine), replayed until the stop: at most
ceil(max_new / STOP_CHECK_STEPS) host syncs a window. On the CPU the same
function runs eagerly, in the same chunks. The encoder and the prefill stay
eager, once a window. On a tensor-parallel module over NCCL the steps' sums
over ``tp`` are captured inside the chunk's graph, and the chunk ends with
a MAX over ``tp`` of its running flag, so that every rank of the group
replays the same chunks and stops after the same one (a graph whose
collectives one rank never joins would hang the others); over gloo, which
reduces on the host, the loop runs eagerly.

At temperature 0 the token is the argmax of the filtered logits. Above it
the token is sampled as ``jax.random.categorical`` samples it, by the
Gumbel-max rule: ``argmax(logits / T + g)`` with ``g`` a (B, V) draw of
standard Gumbel noise per executed step, from ``make_gumbel_source`` (the
one place the loop gets its noise from; the greedy loop draws nothing).

``decode`` and ``DecodingResult`` are the public single-window surface
(``whisper.decode``), routing to the engine's greedy, best_of and beam
decodes.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .models.whisper_torch import (
    KVCache,
    WhisperTorch,
    _attention,
    _int8_attention,
    _linear,
    _align_hits,
    _ln,
    _local_heads,
    _logits,
    _mlp,
    _mlp_params,
    _out_linear,
    _prefill_flash_attention,
    _tp,
    alloc_cache,
    cross_attention_rows,
    decode_full,
    decode_step,
    encode,
    init_cache,
)
from .ops import kernels
from .ops.quant import int4_scales_frame_order, quantize_rows, unpack_int4_rows
from .tokenizer import Tokenizer
from .utils.profiling import add_count, stage_timer

# Fixed prompt-region size: sot_prev + up to (n_ctx//2 - 1) prompt tokens +
# sot sequence (<=4) + prefix. 232 = next multiple of 8 above 228.
PROMPT_REGION = 232
# Compact region for promptless windows (sot sequence + small prefix only).
PROMPT_REGION_SMALL = 8
MAX_NEW_TOKENS = 224  # whisper's sample_len default: n_text_ctx // 2
PREFILL_FLASH_MIN_SLOTS = 16  # larger prompt regions prefill through flash_attention
# decode steps between two host reads of the loop's stop flag: one captured
# CUDA graph on the card, one eager chunk on the CPU
STOP_CHECK_STEPS = 16


@dataclass(frozen=True)
class DecodingOptions:
    """Mirror of whisper's DecodingOptions."""

    task: str = "transcribe"
    language: Optional[str] = None
    temperature: float = 0.0
    sample_len: Optional[int] = None
    best_of: Optional[int] = None
    beam_size: Optional[int] = None
    patience: Optional[float] = None
    length_penalty: Optional[float] = None
    prompt: Optional[Sequence[int]] = None
    prefix: Optional[Sequence[int]] = None
    suppress_tokens: Optional[str] = "-1"
    suppress_blank: bool = True
    without_timestamps: bool = False
    max_initial_timestamp: Optional[float] = 1.0


@dataclass
class DecodingResult:
    """Mirror of the JAX package's ``DecodingResult`` (``decoding.py:81``),
    what ``decode`` returns."""

    tokens: List[int]
    text: str
    avg_logprob: float
    no_speech_prob: float
    temperature: float
    compression_ratio: float
    language: Optional[str] = None
    language_probs: Optional[dict] = None
    token_logprobs: Optional[np.ndarray] = None  # (n_sampled,)
    cross_attention: Optional[np.ndarray] = None  # (n_sampled, K, T_audio)
    audio_features: Optional[Any] = None


def compression_ratio(text: str) -> float:
    b = text.encode("utf-8")
    return len(b) / len(zlib.compress(b)) if b else 0.0


def make_gumbel_source(seed: int, device,
                       generator: Optional[torch.Generator] = None) -> Callable[[int, int], torch.Tensor]:
    """The sampler's noise: a function ``draw(B, V)`` that returns the next
    step's (B, V) f32 tensor of standard Gumbel noise on ``device``, from a
    ``torch.Generator`` seeded with ``seed`` (``generator``, reseeded, when
    given: the one a captured loop registered with its graphs). ``-log(E)``
    with ``E`` a unit exponential draw is Gumbel; ``E`` is kept above the
    smallest normal float so no column gets infinite noise. No host sync,
    so the draw can be captured in a CUDA graph."""
    gen = generator if generator is not None else torch.Generator(device=device)
    gen.manual_seed(int(seed))
    tiny = torch.finfo(torch.float32).tiny

    def draw(B: int, V: int) -> torch.Tensor:
        e = torch.empty((B, V), dtype=torch.float32, device=device).exponential_(generator=gen)
        return e.clamp_min_(tiny).log_().neg_()

    return draw


def temperature_divisor(temperature: float, device) -> torch.Tensor:
    """max(T, 1e-6) in f32, as the scalar tensor that ``sample_tokens``
    divides by (JAX's ``logits / jnp.maximum(temperature, 1e-6)``): a
    tensor divisor keeps the IEEE quotient on CUDA too, where a Python
    scalar becomes a multiply by its reciprocal."""
    return torch.tensor(max(np.float32(temperature), np.float32(1e-6)), dtype=torch.float32,
                        device=device)


def sample_tokens(logits: torch.Tensor, t_div: torch.Tensor, draw) -> torch.Tensor:
    """One sampled token per row of the filtered f32 logits (B, V):
    ``argmax(logits / t_div + g)`` with ``g = draw(B, V)``, the Gumbel-max
    form of ``jax.random.categorical``. A -inf column stays -inf; ties go
    to the first maximum."""
    return torch.argmax(logits / t_div + draw(*logits.shape), dim=-1)


# ---------------------------------------------------------------------------
# Static filter masks (built per tokenizer+options on host)
# ---------------------------------------------------------------------------


def build_suppress_mask(tokenizer: Tokenizer, options: DecodingOptions, n_vocab: int) -> np.ndarray:
    """Additive mask (-inf at suppressed ids) — whisper's SuppressTokens."""
    suppress: List[int] = []
    st = options.suppress_tokens
    if isinstance(st, str) and st:
        ids = [int(t) for t in st.split(",") if t.strip()]
        suppress.extend(t for t in ids if t != -1)
        if -1 in ids:
            suppress.extend(tokenizer.non_speech_tokens)
    elif isinstance(st, (list, tuple)):
        suppress.extend(int(t) for t in st if int(t) != -1)
        if -1 in list(st):
            suppress.extend(tokenizer.non_speech_tokens)
    suppress.extend(
        [tokenizer.transcribe, tokenizer.translate, tokenizer.sot, tokenizer.sot_prev,
         tokenizer.sot_lm]
    )
    if tokenizer.no_speech is not None:
        suppress.append(tokenizer.no_speech)
    mask = np.zeros((n_vocab,), np.float32)
    ids = [t for t in sorted(set(suppress)) if 0 <= t < n_vocab]
    mask[ids] = -np.inf
    return mask


def build_blank_mask(tokenizer: Tokenizer, n_vocab: int) -> np.ndarray:
    """SuppressBlank: ' ' and EOT at the first sampled position."""
    mask = np.zeros((n_vocab,), np.float32)
    ids = list(tokenizer.encode(" ")) + [tokenizer.eot]
    mask[[t for t in ids if 0 <= t < n_vocab]] = -np.inf
    return mask


# ---------------------------------------------------------------------------
# Timestamp rules (vectorized whisper ApplyTimestampRules)
# ---------------------------------------------------------------------------


def apply_timestamp_rules(
    logits: torch.Tensor,  # (B, V) f32
    last_token: torch.Tensor,  # (B,) y_{i-1}
    penult_token: torch.Tensor,  # (B,)
    max_timestamp: torch.Tensor,  # (B,) highest timestamp sampled so far (or ts_begin-1)
    n_sampled,  # tokens sampled so far: an int, or the loop's () device step index
    *,
    ts_begin: int,
    eot: int,
    no_timestamps: int,
    max_initial_timestamp_index: Optional[int],
) -> torch.Tensor:
    B, V = logits.shape
    neg_inf = float("-inf")
    vocab_ids = torch.arange(V, device=logits.device)[None]
    is_ts = vocab_ids >= ts_begin
    is_text = vocab_ids < eot

    logits = logits.masked_fill(vocab_ids == no_timestamps, neg_inf)

    last_was = (last_token >= ts_begin) & (n_sampled >= 1)
    penult_was = (penult_token >= ts_begin) | (n_sampled < 2)

    # after a lone timestamp: force text/EOT; after a pair: forbid timestamps
    forbid_ts = last_was & penult_was
    forbid_text = last_was & ~penult_was
    logits = logits.masked_fill(forbid_ts[:, None] & is_ts, neg_inf)
    logits = logits.masked_fill(forbid_text[:, None] & is_text, neg_inf)

    # timestamps must be non-decreasing
    has_ts = max_timestamp >= ts_begin
    ts_last = torch.where(last_was & ~penult_was, max_timestamp, max_timestamp + 1)
    logits = logits.masked_fill(has_ts[:, None] & is_ts & (vocab_ids < ts_last[:, None]), neg_inf)

    # the first sampled position: a timestamp, bounded by max_initial_timestamp
    # (a masked select, so that a device step index needs no host read)
    first = vocab_ids < ts_begin
    if max_initial_timestamp_index is not None:
        first = first | (vocab_ids > ts_begin + max_initial_timestamp_index)
    logits = logits.masked_fill(first & (n_sampled == 0), neg_inf)

    # sample a timestamp when its total probability beats the best
    # non-timestamp token (EOT included)
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    ts_logprob = torch.logsumexp(logprobs.masked_fill(~is_ts, neg_inf), dim=-1)
    max_text = logprobs.masked_fill(is_ts, neg_inf).amax(dim=-1)
    force_ts = ts_logprob > max_text
    return logits.masked_fill(force_ts[:, None] & ~is_ts, neg_inf)


# ---------------------------------------------------------------------------
# The window decode
# ---------------------------------------------------------------------------


def _prefill(model: WhisperTorch, cache, prompt, pad_len, align_heads):
    """Run the P-slot prompt region through the decoder at once, filling
    cache slots [0, P). Returns (x (B, P, D), rows (B, K, T) f32): rows are
    the alignment heads' pre-softmax scores of the LAST prompt position,
    which predicts the first sampled token.

    Regions of more than 16 slots send the self- and cross-attention
    through the ``flash_attention`` kernel (``decoding.py:309-314`` of the
    JAX package); smaller ones keep the plain masked ``_attention``.

    A quantized cache (``decoding.py:316-436``): an int8 self cache takes
    the rows quantized, while the prefill's own attention uses the exact
    rows; an int8 or int4 cross K/V is dequantized, one layer at a time, for
    the flash path, and read by ``_int8_attention`` (int4 unpacked) on the
    small path.

    The last row's scores: on the small path, the last row of that pass's
    scores (``decoding.py:372-380``); on the flash path, through the cache's
    decode kernel (``cross_attention_rows``). On a tensor-parallel module
    (``models.whisper_torch``) the pass runs on the rank's heads and the
    rows are summed over ``tp``."""
    dims = model.dims
    dec = model.decoder
    H = _local_heads(model, dims.n_text_head)
    tp = _tp(model)
    B, P = prompt.shape
    self_int8 = cache.k.dtype == torch.int8
    cross_q = cache.xk.dtype == torch.int8
    slot = torch.arange(P, device=prompt.device)
    pos_ids = torch.clamp(slot[None] - pad_len[:, None], min=0)
    x = (dec["tok_emb"][prompt] + dec["pos_emb"][pos_ids]).to(
        dec["tok_emb"].dtype if self_int8 else cache.k.dtype)
    use_flash = P > PREFILL_FLASH_MIN_SLOTS
    if not use_flash:
        # query slot q attends keys k with pad_len <= k <= q; a padding-slot
        # query keeps its own slot (a fully masked row would turn into NaN)
        q_ids, k_ids = slot[:, None], slot[None, :]
        valid = ((k_ids[None] >= pad_len[:, None, None]) & (k_ids <= q_ids)[None]) | (k_ids == q_ids)[None]
        mask = torch.zeros(valid.shape, dtype=x.dtype, device=x.device).masked_fill(~valid, float("-inf"))
        mask = mask[:, None]  # (B, 1, P, P)
    K = len(align_heads)
    rows = torch.zeros((B, K, cache.n_frames), dtype=torch.float32, device=x.device)
    for l in range(dims.n_text_layer):
        xn = _ln(x, dec["attn_ln_g"][l], dec["attn_ln_b"][l])
        k_new = _linear(xn, dec["attn_k_w"][l])
        v_new = _linear(xn, dec["attn_v_w"][l], dec["attn_v_b"][l])
        if self_int8:
            cache.k[l, :, :P], cache.k_scale[l, :, :P] = quantize_rows(k_new, tp)
            cache.v[l, :, :P], cache.v_scale[l, :, :P] = quantize_rows(v_new, tp)
        else:
            cache.k[l, :, :P] = k_new
            cache.v[l, :, :P] = v_new
        q_self = _linear(xn, dec["attn_q_w"][l], dec["attn_q_b"][l])
        if use_flash:
            a = _prefill_flash_attention(q_self, k_new, v_new, H, pad_len=pad_len, causal=True)
        else:
            a, _ = _attention(q_self, k_new, v_new, H, mask=mask)
        x = x + _out_linear(a, dec["attn_o_w"][l], dec["attn_o_b"][l], tp)
        xc = _ln(x, dec["cross_ln_g"][l], dec["cross_ln_b"][l])
        qc = _linear(xc, dec["cross_q_w"][l], dec["cross_q_b"][l])
        hits = _align_hits(model, align_heads, l)
        w = None
        if use_flash:
            if cross_q:  # this layer dequantized to the model's type
                xk8, xks, xv8, xvs = _cross_layer_int8(cache, l)
                c = _prefill_flash_attention(qc, xk8.to(x.dtype) * xks[..., None].to(x.dtype),
                                             xv8.to(x.dtype) * xvs[..., None].to(x.dtype), H)
            else:
                c = _prefill_flash_attention(qc, cache.xk[l], cache.xv[l], H)
        elif cross_q:
            c, w = _int8_attention(qc, *_cross_layer_int8(cache, l), H)
        else:
            c, w = _attention(qc, cache.xk[l], cache.xv[l], H, return_scores=bool(hits))
        if hits:
            # only alignment-head layers: the last row's scores, from the
            # small region's own pass, else through the decode
            # cross-attention kernel (the same single-query function)
            if w is None:
                _, w = cross_attention_rows(qc[:, -1:].contiguous(), cache, l, H, True)
            for k, j in hits:
                rows[:, k] = w[:, j, -1]
        x = x + _out_linear(c, dec["cross_o_w"][l], dec["cross_o_b"][l], tp)
        x = _mlp(x, _mlp_params(dec, l), tp)
    if tp is not None and K:
        tp.sum_(rows)
    return x, rows


def _cross_layer_int8(cache, l: int):
    """Layer ``l`` of a quantized cross K/V as int8 codes and frame-ordered
    scales (B, T, D), (B, T): int4 is unpacked."""
    if cache.cross_int4:
        return (unpack_int4_rows(cache.xk[l]), int4_scales_frame_order(cache.xk_scale[l]),
                unpack_int4_rows(cache.xv[l]), int4_scales_frame_order(cache.xv_scale[l]))
    return cache.xk[l], cache.xk_scale[l], cache.xv[l], cache.xv_scale[l]


@dataclass(frozen=True)
class _LoopConfig:
    """What the token loop's step takes as constants: a captured graph
    bakes them in, so each is part of its key (``DecodeGraphs``)."""

    P: int  # prompt region
    max_new: int
    extent: int  # cache slots the self-attention spans: P + max_new, within the cache
    n_ctx: int
    eot: int
    ts_begin: int
    no_timestamps: int
    max_initial_timestamp_index: Optional[int]
    suppress_blank: bool
    without_timestamps: bool
    align_heads: Tuple[Tuple[int, int], ...]  # empty: no alignment rows kept
    sampled: bool
    steps: int  # steps a chunk (STOP_CHECK_STEPS)


@dataclass
class _LoopState:
    """The token loop's state on the device, updated in place by each step
    (JAX's ``while_loop`` carry, ``decoding.py:453-476``), and the inputs
    each window fills in (``pad_len``, ``t_div``, the masks): a captured
    graph reads and writes these very tensors. ``status`` is (running,
    steps run), what the host reads after each chunk of ``steps`` steps.
    The per-token outputs (the token, its log-prob, the timestamp
    log-probs, the alignment rows) go to the ``*_rows`` staging buffers,
    row ``j`` for step ``j`` of the chunk, which the host copies into the
    window's own buffers after the chunk (``_drain_rows``): what stays on
    the card between windows is a chunk's rows, not a window's."""

    i: torch.Tensor  # () long: steps run, JAX's loop counter
    status: torch.Tensor  # (2,) long
    last_logits: torch.Tensor  # (B, V), the model's dtype
    last_token: torch.Tensor  # (B,) long
    penult_token: torch.Tensor
    max_timestamp: torch.Tensor
    finished: torch.Tensor  # (B,) bool
    sum_logprobs: torch.Tensor  # (B,) f32
    tok_rows: torch.Tensor  # (B, steps) int32: column j, step j's token
    lp_rows: torch.Tensor  # (B, steps) f32: its log-prob (0 once finished)
    ts_rows: Optional[torch.Tensor]  # (B, steps, V - ts_begin) f32
    attn_rows: Optional[torch.Tensor]  # (B, steps, K, T_audio) f32: step j's forward
    pad_len: torch.Tensor  # (B,) int32
    t_div: torch.Tensor  # () f32
    suppress_mask: torch.Tensor  # (V,) f32
    blank_mask: torch.Tensor


def _alloc_loop_state(B: int, V: int, steps: int, ts_begin: int, K: int, T_audio: int,
                      capture_attention: bool, logits_dtype, device) -> _LoopState:
    z = dict(device=device)
    return _LoopState(
        i=torch.zeros((), dtype=torch.long, **z),
        status=torch.zeros((2,), dtype=torch.long, **z),
        last_logits=torch.zeros((B, V), dtype=logits_dtype, **z),
        last_token=torch.zeros((B,), dtype=torch.long, **z),
        penult_token=torch.zeros((B,), dtype=torch.long, **z),
        max_timestamp=torch.zeros((B,), dtype=torch.long, **z),
        finished=torch.zeros((B,), dtype=torch.bool, **z),
        sum_logprobs=torch.zeros((B,), dtype=torch.float32, **z),
        tok_rows=torch.zeros((B, steps), dtype=torch.int32, **z),
        lp_rows=torch.zeros((B, steps), dtype=torch.float32, **z),
        ts_rows=(torch.zeros((B, steps, V - ts_begin), dtype=torch.float32, **z)
                 if capture_attention else None),
        attn_rows=(torch.zeros((B, steps, K, T_audio), dtype=torch.float32, **z)
                   if capture_attention else None),
        pad_len=torch.zeros((B,), dtype=torch.int32, **z),
        t_div=torch.ones((), dtype=torch.float32, **z),
        suppress_mask=torch.zeros((V,), dtype=torch.float32, **z),
        blank_mask=torch.zeros((V,), dtype=torch.float32, **z),
    )


def _loop_step(model: WhisperTorch, cache: KVCache, st: _LoopState, cfg: _LoopConfig,
               draw, j: int) -> None:
    """Step ``j`` of a chunk of the token loop, the counterpart of ``body``
    at ``whisper_timestamped_tpu/decoding.py:483-560``, in place on ``st``
    and the cache, with no host read. The step is gated on ``active``, "the
    JAX loop would run this step" (i < max_new and not every row
    finished): a step past the stop writes no buffer row, adds nothing to
    ``sum_logprobs`` and does not count in ``i``; its cache write lands in
    a slot no later step reads, its staging rows (row ``j``) are never
    drained."""
    i = st.i
    active = (i < cfg.max_new) & ~st.finished.all()
    logits = st.last_logits.float()
    # filters in whisper's order: blank, suppress, timestamp rules
    if cfg.suppress_blank:
        logits = torch.where(i == 0, logits + st.blank_mask[None], logits)
    logits = logits + st.suppress_mask[None]
    if not cfg.without_timestamps:
        logits = apply_timestamp_rules(
            logits, st.last_token, st.penult_token, st.max_timestamp, i,
            ts_begin=cfg.ts_begin, eot=cfg.eot, no_timestamps=cfg.no_timestamps,
            max_initial_timestamp_index=cfg.max_initial_timestamp_index,
        )
    logprobs = torch.log_softmax(logits, dim=-1)
    tok = sample_tokens(logits, st.t_div, draw) if cfg.sampled else torch.argmax(logits, dim=-1)
    # sequence-length cap: force EOT when the true position would exceed n_ctx
    overflow = (cfg.P + i - st.pad_len) >= (cfg.n_ctx - 1)
    tok = torch.where(st.finished | overflow, cfg.eot, tok)

    tok_logprob = torch.gather(logprobs, 1, tok[:, None])[:, 0]
    unfinished = ~st.finished
    newly = unfinished & active
    st.tok_rows[:, j] = tok
    st.lp_rows[:, j] = torch.where(unfinished, tok_logprob, 0.0)
    if st.ts_rows is not None:
        st.ts_rows[:, j] = logprobs[:, cfg.ts_begin:]
    st.sum_logprobs.add_(torch.where(newly, tok_logprob, 0.0))
    st.max_timestamp.copy_(torch.where((tok >= cfg.ts_begin) & newly,
                                       torch.maximum(st.max_timestamp, tok), st.max_timestamp))
    st.finished.logical_or_((tok == cfg.eot) & active)

    # feed the chosen token; its forward predicts token i+1 (the slot stays
    # inside the extent on a step past the stop)
    slot = (cfg.P + i).clamp(max=cfg.extent - 1).to(torch.int32)
    logits_new, rows = decode_step(
        model, tok[:, None], cache, slot, pos_offset=st.pad_len, kv_valid_from=st.pad_len,
        align_heads=cfg.align_heads, extent=cfg.extent,
    )
    if rows is not None:  # the attention row of token i + 1
        st.attn_rows[:, j] = rows[:, :, 0]
    st.last_logits.copy_(torch.where(active, logits_new[:, -1], st.last_logits))
    st.penult_token.copy_(torch.where(active, st.last_token, st.penult_token))
    st.last_token.copy_(torch.where(active, tok, st.last_token))
    st.i.add_(active.long())


def _loop_chunk(model, cache, st: _LoopState, cfg: _LoopConfig, draw, n: int) -> None:
    """``n`` steps (at most ``cfg.steps``), then the status the host reads:
    (running, steps run), the running flag the MAX over ``tp`` on a
    tensor-parallel module."""
    for j in range(n):
        _loop_step(model, cache, st, cfg, draw, j)
    running = (st.i < cfg.max_new) & ~st.finished.all()
    st.status.copy_(torch.stack([running.long(), st.i]))
    stop_together(model, st.status)


def stop_together(model, status: torch.Tensor) -> None:
    """The running flag ``status[0]`` as the MAX over the module's ``tp``
    group (nothing without one): the ranks' flags agree already, being
    computed from the same logits, and this makes the agreement structural,
    so that no rank stops while another replays a chunk whose collectives
    it waits on."""
    tp = _tp(model)
    if tp is not None:
        tp.max_(status[:1])


def _drain_rows(st: _LoopState, out: dict, first: int, last: int, max_new: int) -> None:
    """Copy the staging rows of the chunk that ran steps [first, last) into
    the window's buffers ``out``: step i's token, log-prob and timestamp
    log-probs to column i, its forward's alignment rows to ``attn[:, i +
    1]`` (dropped at max_new, as JAX's ``mode="drop"``)."""
    if last <= first:
        return
    n = last - first
    out["tokens"][:, first:last] = st.tok_rows[:, :n]
    out["token_logprobs"][:, first:last] = st.lp_rows[:, :n]
    if out["attn"] is not None:
        out["ts_logprobs"][:, first:last] = st.ts_rows[:, :n]
        top = min(last + 1, max_new)
        out["attn"][:, first + 1 : top] = st.attn_rows[:, : top - first - 1]


class DecodeGraphs:
    """The captured token loops of one ``DecodeEngine`` and the persistent
    buffers they run on (one lever set; freed with the engine).

    A graph is a chunk of ``STOP_CHECK_STEPS`` steps of ``_loop_step``
    captured on the card, keyed by the batch B, the prompt region P, ``max_new``, the
    alignment heads, ``capture_attention``, greedy or sampled and the
    levers (``_LoopConfig`` and the cache's layout), or of beam search's
    ``decoding_beam._beam_step`` (keyed by its ``_BeamConfig``: B, K, the
    pool, P, ``max_new``, the filters, and the cross lever; its cache has
    B·K self rows over B cross-KV rows); the temperature is a
    device scalar filled before each window, so one sampled graph serves
    every temperature of the fallback schedule. A graph bakes in addresses,
    so what its steps read and write is persistent, filled in place by each
    window: the cache, one per (B, levers) with the self cache at the
    larger prompt region's extent, shared by the graphs of both regions,
    and the loop state (``_LoopState``: the carry and a chunk's staging
    rows), one per (B, steps, heads, capture_attention). The graphs
    allocate their temporaries from one shared memory pool. The sampler's
    generator is one, registered with every sampled graph and reseeded per
    window, so that a replayed window draws what the uncaptured run of the
    same seed draws.

    Capture: one eager step first, on the current stream (every library
    and kernel loaded, each kernel's attributes set), then the capture, with
    ``capture_error_mode="thread_local"`` (the serving loop's prefetch
    thread uploads and computes mel on its own stream meanwhile). The
    kernels' launches during the capture count into the graph's record,
    added to ``ops.kernels.LAUNCHES`` at each replay. A failed capture
    raises: nothing falls back to the uncaptured loop.

    On a tensor-parallel module over NCCL the graph holds the steps'
    collectives: the warm-up step issues every one of them first (the
    communicator is made at its group's first collective, which a capture
    cannot hold), and the keys hold the rank's module, whose buffers are
    sized from the rank's heads."""

    def __init__(self):
        self.graphs: Dict[Any, Tuple[Any, dict]] = {}
        self.caches: Dict[Any, KVCache] = {}
        self.states: Dict[Any, _LoopState] = {}
        self.captures = 0
        self._pool = None
        self._generator = None

    def cache(self, model: WhisperTorch, B: int, T: int, dtype, quantize_cross,
              quantize_self: bool, self_rows: Optional[int] = None) -> KVCache:
        """The persistent cache of B cross-KV rows and ``self_rows`` self
        rows (B unless given: beam search's B·K)."""
        key = (B, T, dtype, quantize_cross, quantize_self, self_rows)
        if key not in self.caches:
            self.caches[key] = alloc_cache(model, B, T, _cache_slots(model, PROMPT_REGION),
                                           dtype, model.device, quantize_cross, quantize_self,
                                           self_rows)
        return self.caches[key]

    def state(self, key, make) -> _LoopState:
        if key not in self.states:
            self.states[key] = make()
        return self.states[key]

    def generator(self, device) -> torch.Generator:
        if self._generator is None:
            self._generator = torch.Generator(device=device)
        return self._generator

    def ensure(self, key, chunk: Callable[[int], None], steps: int, sampled: bool) -> None:
        """Capture the graph of ``key`` unless it exists: ``chunk(n)`` runs
        n steps on the persistent buffers, the graph ``steps`` of them. The
        eager warm-up step changes the buffers, so a window fills its state
        after this."""
        if key not in self.graphs:
            with stage_timer("decode_capture"):
                self.graphs[key] = self._capture(chunk, steps, sampled)

    def replay(self, key) -> None:
        graph, record = self.graphs[key]
        graph.replay()
        kernels.add_launches(record)

    def _capture(self, chunk, steps: int, sampled: bool):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        # the warm-up runs on the current stream: a new stream a capture
        # would give cuBLAS a new workspace each time, kept for the process
        chunk(1)
        graph = torch.cuda.CUDAGraph()
        if sampled:
            graph.register_generator_state(self._generator)
        record: Dict[str, int] = {}
        with kernels.counting_into(record), torch.cuda.graph(
                graph, pool=self._pool, capture_error_mode="thread_local"):
            chunk(steps)
        self.captures += 1
        return graph, record


def tp_runs_eagerly(model) -> bool:
    """A tensor-parallel module whose collectives a CUDA graph cannot hold
    (gloo's, through the host): its token loops run eagerly."""
    tp = _tp(model)
    return tp is not None and tp.via_host


def _cache_slots(model: WhisperTorch, P: int, max_new: int = MAX_NEW_TOKENS) -> int:
    """Self-cache slots of a window: the decode extent P + max_new,
    8-aligned, at most n_text_ctx (8-aligned) + 8."""
    n_ctx = model.dims.n_text_ctx
    return min(((P + max_new + 7) // 8) * 8, ((n_ctx + 7) // 8) * 8 + 8)


@torch.no_grad()
def decode_window(
    model: WhisperTorch,
    mel: torch.Tensor,  # (B, n_mels, 3000)
    prompt: torch.Tensor,  # (B, P) right-aligned, invalid slots arbitrary
    prompt_len: torch.Tensor,  # (B,) valid prompt tokens (incl. sot sequence)
    suppress_mask: torch.Tensor,  # (V,)
    blank_mask: torch.Tensor,  # (V,)
    *,
    align_heads: Sequence[Tuple[int, int]],
    eot: int,
    ts_begin: int,
    no_timestamps: int,
    sot_index_from_end: int,
    max_initial_timestamp_index: Optional[int],
    max_new: int = MAX_NEW_TOKENS,
    suppress_blank: bool = True,
    without_timestamps: bool = False,
    kv_int8: bool = False,
    kv_int4: bool = False,
    self_kv_int8: bool = False,
    temperature: float = 0.0,
    rng_seed: int = 0,
    capture_attention: bool = True,
    graphs: Optional[DecodeGraphs] = None,
    uncaptured: bool = False,
):
    """Decode one 30-s window for a batch. Returns a dict of buffers: tokens
    (B, max_new) int32 (EOT-filled), n_steps (the steps JAX's loop runs),
    sum_logprobs (B,), token_logprobs (B, max_new), ts_logprobs (B,
    max_new, V-ts_begin), attn (B, max_new, K, T_audio), no_speech_prob
    (B,), n_sampled (B,), and ``chunks``, the loop's chunks of
    ``STOP_CHECK_STEPS`` steps (graph replays on the card, each one host
    sync).

    ``temperature`` > 0 samples each token from the filtered logits scaled
    by 1 / max(T, 1e-6), with noise from ``make_gumbel_source(rng_seed)``;
    the log-probabilities stay those of the unscaled logits, as in JAX.
    ``capture_attention=False`` keeps no alignment rows: no scores are
    asked of the cross-attention kernel, and ``attn`` and ``ts_logprobs``
    are None.

    ``kv_int8`` / ``kv_int4`` store the encoder's cross K/V as int8 / int4
    (int4 wins when both are set), ``self_kv_int8`` the self-attention cache
    as int8 (``init_cache``).

    On CUDA the token loop replays the captured graphs of ``graphs`` (the
    engine's; a new ``DecodeGraphs`` when None) on its persistent buffers;
    after each chunk the host copies the chunk's staging rows into this
    window's own buffers, which it returns. ``uncaptured=True`` runs the
    same step function eagerly on buffers of its own instead, the run a
    captured one is compared with; no path of the package passes it. On
    the CPU the loop always runs eagerly. A tensor-parallel module's loop
    is captured with its steps' collectives over NCCL; over gloo (sums
    through the host, which a graph cannot hold) it runs eagerly, counted
    in ``tp_eager_chunks``."""
    dims = model.dims
    dev = model.device
    B = mel.shape[0]
    P = prompt.shape[1]
    V = dims.n_vocab
    no_speech = no_timestamps - 1  # layout fact: <|nospeech|> precedes <|notimestamps|>
    mel, prompt, prompt_len = mel.to(dev), prompt.to(dev).long(), prompt_len.to(dev)
    eager_tp = tp_runs_eagerly(model)
    captured = dev.type == "cuda" and not uncaptured and not eager_tp
    if captured and graphs is None:
        graphs = DecodeGraphs()
    quantize_cross = "int4" if kv_int4 else kv_int8

    with stage_timer("encode"):
        xa = encode(model, mel)
    if captured:
        cache = init_cache(model, xa, quantize_cross=quantize_cross, quantize_self=self_kv_int8,
                           out=graphs.cache(model, B, xa.shape[1], xa.dtype, quantize_cross,
                                            self_kv_int8))
    else:
        cache = init_cache(model, xa, ctx_len=_cache_slots(model, P, max_new),
                           quantize_cross=quantize_cross, quantize_self=self_kv_int8)
    pad_len = (P - prompt_len).to(torch.int32)

    align_heads = tuple(tuple(h) for h in align_heads) if capture_attention else ()
    with stage_timer("prefill"):
        x, prefill_rows = _prefill(model, cache, prompt, pad_len, list(align_heads))
        sot_slot = P - sot_index_from_end
        x_sel = x[:, [sot_slot, P - 1]]
        sel_logits = _logits(_ln(x_sel, model.decoder["ln_g"], model.decoder["ln_b"]), model.decoder)
        no_speech_prob = torch.softmax(sel_logits[:, 0].float(), dim=-1)[:, no_speech]
        last_logits = sel_logits[:, 1]

    K = len(align_heads)
    T_audio = xa.shape[1]
    k = STOP_CHECK_STEPS
    cfg = _LoopConfig(
        P=P, max_new=max_new, extent=min(P + max_new, cache.k.shape[2]), n_ctx=dims.n_text_ctx,
        eot=eot, ts_begin=ts_begin, no_timestamps=no_timestamps,
        max_initial_timestamp_index=max_initial_timestamp_index, suppress_blank=suppress_blank,
        without_timestamps=without_timestamps, align_heads=align_heads,
        sampled=temperature > 0, steps=k,
    )

    def make_state():
        return _alloc_loop_state(B, V, k, ts_begin, K, T_audio, capture_attention,
                                 last_logits.dtype, dev)

    st = graphs.state((B, k, align_heads, capture_attention), make_state) if captured \
        else make_state()
    draw = None
    if cfg.sampled:
        draw = (make_gumbel_source(rng_seed, dev, generator=graphs.generator(dev)) if captured
                else make_gumbel_source(rng_seed, dev))

    def chunk(n: int) -> None:
        _loop_chunk(model, cache, st, cfg, draw, n)

    key = (cfg, B, cache.k.dtype, cache.xk.dtype, cache.cross_int4)
    if captured:
        graphs.ensure(key, chunk, k, cfg.sampled)
    # this window's initial state (JAX's ``init``), in place
    st.i.zero_()
    st.last_logits.copy_(last_logits)
    st.last_token.copy_(prompt[:, -1])
    st.penult_token.copy_(prompt[:, -2])
    st.max_timestamp.fill_(ts_begin - 1)
    st.finished.zero_()
    st.sum_logprobs.zero_()
    st.pad_len.copy_(pad_len)
    st.suppress_mask.copy_(suppress_mask)
    st.blank_mask.copy_(blank_mask)
    if cfg.sampled:
        st.t_div.copy_(temperature_divisor(temperature, dev))
        if captured:  # the warm-up drew from it
            graphs.generator(dev).manual_seed(int(rng_seed))
    # the window's own buffers, filled from the staging rows chunk by chunk
    out = dict(tokens=torch.full((B, max_new), eot, dtype=torch.int32, device=dev),
               token_logprobs=torch.zeros((B, max_new), dtype=torch.float32, device=dev),
               ts_logprobs=None, attn=None)
    if capture_attention:
        out["ts_logprobs"] = torch.zeros((B, max_new, V - ts_begin), dtype=torch.float32,
                                         device=dev)
        out["attn"] = torch.zeros((B, max_new, K, T_audio), dtype=torch.float32, device=dev)
        out["attn"][:, 0] = prefill_rows
    n_steps = chunks = 0
    with stage_timer("decode_loop"):
        for chunks in range(1, -(-max_new // k) + 1):
            if captured:
                graphs.replay(key)
            else:
                chunk(k)
            first = n_steps
            running, n_steps = st.status.tolist()  # the chunk's one host sync
            _drain_rows(st, out, first, n_steps, max_new)
            if not running:
                break
    add_count("decode_steps", n_steps)
    if eager_tp:
        add_count("tp_eager_chunks", chunks)

    tokens = out["tokens"]
    n_sampled = (tokens != eot).sum(dim=-1) + (tokens == eot).any(dim=-1).to(torch.long)
    # the sum stays in the persistent state: the next window resets it
    return dict(out, sum_logprobs=st.sum_logprobs.clone(), n_steps=n_steps,
                no_speech_prob=no_speech_prob, n_sampled=n_sampled, chunks=chunks)


# ---------------------------------------------------------------------------
# Language identification
# ---------------------------------------------------------------------------


@torch.no_grad()
def detect_language(model: WhisperTorch, mel: torch.Tensor, tokenizer: Tokenizer):
    """Language-id over a (B, n_mels, 3000) mel window. Returns (codes,
    probs_dicts)."""
    if mel.ndim == 2:
        mel = mel[None]
    dims = model.dims
    xa = encode(model, mel.to(model.device))
    tokens = torch.full((mel.shape[0], 1), tokenizer.sot, dtype=torch.long, device=xa.device)
    logits, _ = decode_full(model, tokens, xa)
    logits = logits[:, 0].float()
    mask = torch.full((dims.n_vocab,), float("-inf"), device=xa.device)
    lang_tokens = list(tokenizer.all_language_tokens)
    mask[lang_tokens] = 0.0
    probs = torch.softmax(logits + mask[None], dim=-1).cpu().numpy()
    codes, prob_dicts = [], []
    lang_codes = list(tokenizer.all_language_codes)
    for b in range(probs.shape[0]):
        d = {code: float(probs[b, t]) for code, t in zip(lang_codes, lang_tokens)}
        codes.append(max(d, key=d.get))
        prob_dicts.append(d)
    return codes, prob_dicts


def decode(model, mel, options: Optional[DecodingOptions] = None, tokenizer=None) -> DecodingResult:
    """Single-window decode, the counterpart of ``whisper.decode`` and of
    the JAX package's ``decode`` (``decoding.py:625``).

    ``model`` a ``WhisperModel``; ``mel`` (n_mels, 3000) or (B, n_mels,
    3000), moved to the model's device. Without a language the
    multilingual model detects it first; ``beam_size`` runs beam search,
    ``temperature`` > 0 with ``best_of`` > 1 the best of that many
    samples, anything else ``decode_window``. Returns the first row's
    ``DecodingResult``, with its per-token log-probs and alignment-head
    cross-attention."""
    from .api import _resolve_tokenizer
    from .engine import DecodeEngine

    options = options or DecodingOptions()
    tok = _resolve_tokenizer(model, tokenizer, options.language, options.task)
    engine = DecodeEngine(model, tok)
    mel = torch.as_tensor(mel, dtype=torch.float32, device=model.device)
    language = options.language
    language_probs = None
    if language is None and tok.is_multilingual:
        codes, probs = detect_language(model.module, mel, tok)
        language, language_probs = codes[0], probs[0]
        options = DecodingOptions(**{**options.__dict__, "language": language})
    elif language is None:
        language = "en"

    if options.beam_size:
        res = engine.decode_window_beam(mel, options, prompt_tokens=options.prompt or ())
    elif options.temperature and (options.best_of or 0) > 1:
        res = engine.decode_window_best_of(mel, options, options.prompt or (),
                                           float(options.temperature), 0)
        res.temperature = float(options.temperature)
    else:
        res = engine.decode_window(mel, options, prompt_tokens=options.prompt or (),
                                   temperature=options.temperature)[0]
    return DecodingResult(
        tokens=res.tokens,
        text=res.text,
        avg_logprob=res.avg_logprob,
        no_speech_prob=res.no_speech_prob,
        temperature=res.temperature,
        compression_ratio=res.compression_ratio,
        language=language,
        language_probs=language_probs,
        token_logprobs=res.token_logprobs,
        cross_attention=res.attn,
    )
