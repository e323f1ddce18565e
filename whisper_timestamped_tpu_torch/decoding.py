"""Window decoding with whisper's logit filters, in PyTorch.

Port of ``whisper_timestamped_tpu/decoding.py``. ``decode_window`` is the
counterpart of ``decode_window_jit``: it encodes a batch of 30-s windows,
prefills the right-aligned prompt region, then runs the token loop (a
Python loop over tokens where JAX has ``lax.while_loop``) into
preallocated buffers of fixed shape: the chosen tokens, their filtered
log-probabilities, the timestamp-slice log-probabilities, and the
alignment heads' cross-attention rows. Row convention as in the reference:
``attn[:, k]`` is the attention of the forward that predicted token k.

At temperature 0 the token is the argmax of the filtered logits. Above it
the token is sampled as ``jax.random.categorical`` samples it, by the
Gumbel-max rule: ``argmax(logits / T + g)`` with ``g`` a (B, V) draw of
standard Gumbel noise per executed step, from ``make_gumbel_source`` (the
one place the loop gets its noise from; the greedy loop draws nothing).

The loop checks ``finished.all()`` on the host once per step (one device
sync per step, where the JAX loop tests its condition on the device).

``decode`` and ``DecodingResult`` are the public single-window surface
(``whisper.decode``), routing to the engine's greedy, best_of and beam
decodes.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .models.whisper_torch import (
    WhisperTorch,
    _attention,
    _int8_attention,
    _linear,
    _ln,
    _logits,
    _mlp,
    _mlp_params,
    _prefill_flash_attention,
    cross_attention_rows,
    decode_full,
    decode_step,
    encode,
    init_cache,
)
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


def make_gumbel_source(seed: int, device) -> Callable[[int, int], torch.Tensor]:
    """The sampler's noise: a function ``draw(B, V)`` that returns the next
    step's (B, V) f32 tensor of standard Gumbel noise on ``device``, from a
    ``torch.Generator`` seeded with ``seed``. ``-log(E)`` with ``E`` a unit
    exponential draw is Gumbel; ``E`` is kept above the smallest normal
    float so no column gets infinite noise. No host sync, so the draw can
    be captured in a CUDA graph."""
    gen = torch.Generator(device=device)
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
    n_sampled: int,
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
    if n_sampled == 0:
        logits = logits.masked_fill(vocab_ids < ts_begin, neg_inf)
        if max_initial_timestamp_index is not None:
            logits = logits.masked_fill(vocab_ids > ts_begin + max_initial_timestamp_index, neg_inf)

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
    decode kernel (``cross_attention_rows``)."""
    dims = model.dims
    dec = model.decoder
    H = dims.n_text_head
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
            cache.k[l, :, :P], cache.k_scale[l, :, :P] = quantize_rows(k_new)
            cache.v[l, :, :P], cache.v_scale[l, :, :P] = quantize_rows(v_new)
        else:
            cache.k[l, :, :P] = k_new
            cache.v[l, :, :P] = v_new
        q_self = _linear(xn, dec["attn_q_w"][l], dec["attn_q_b"][l])
        if use_flash:
            a = _prefill_flash_attention(q_self, k_new, v_new, H, pad_len=pad_len, causal=True)
        else:
            a, _ = _attention(q_self, k_new, v_new, H, mask=mask)
        x = x + _linear(a, dec["attn_o_w"][l], dec["attn_o_b"][l])
        xc = _ln(x, dec["cross_ln_g"][l], dec["cross_ln_b"][l])
        qc = _linear(xc, dec["cross_q_w"][l], dec["cross_q_b"][l])
        hits = [k for k, (hl, _) in enumerate(align_heads) if hl == l]
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
            for k in hits:
                rows[:, k] = w[:, align_heads[k][1], -1]
        x = x + _linear(c, dec["cross_o_w"][l], dec["cross_o_b"][l])
        x = _mlp(x, _mlp_params(dec, l))
    return x, rows


def _cross_layer_int8(cache, l: int):
    """Layer ``l`` of a quantized cross K/V as int8 codes and frame-ordered
    scales (B, T, D), (B, T): int4 is unpacked."""
    if cache.cross_int4:
        return (unpack_int4_rows(cache.xk[l]), int4_scales_frame_order(cache.xk_scale[l]),
                unpack_int4_rows(cache.xv[l]), int4_scales_frame_order(cache.xv_scale[l]))
    return cache.xk[l], cache.xk_scale[l], cache.xv[l], cache.xv_scale[l]


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
):
    """Decode one 30-s window for a batch. Returns a dict of buffers: tokens
    (B, max_new) int32 (EOT-filled), n_steps, sum_logprobs (B,),
    token_logprobs (B, max_new), ts_logprobs (B, max_new, V-ts_begin), attn
    (B, max_new, K, T_audio), no_speech_prob (B,), n_sampled (B,).

    ``temperature`` > 0 samples each token from the filtered logits scaled
    by 1 / max(T, 1e-6), with noise from ``make_gumbel_source(rng_seed)``;
    the log-probabilities stay those of the unscaled logits, as in JAX.
    ``capture_attention=False`` keeps no alignment rows: no scores are
    asked of the cross-attention kernel, and ``attn`` and ``ts_logprobs``
    are None.

    ``kv_int8`` / ``kv_int4`` store the encoder's cross K/V as int8 / int4
    (int4 wins when both are set), ``self_kv_int8`` the self-attention cache
    as int8 (``init_cache``)."""
    dims = model.dims
    dev = model.device
    B = mel.shape[0]
    P = prompt.shape[1]
    V = dims.n_vocab
    no_speech = no_timestamps - 1  # layout fact: <|nospeech|> precedes <|notimestamps|>
    mel, prompt, prompt_len = mel.to(dev), prompt.to(dev).long(), prompt_len.to(dev)

    with stage_timer("encode"):
        xa = encode(model, mel)
    # cache sized to the decode extent (8-aligned)
    ctx_len = min(((P + max_new + 7) // 8) * 8, ((dims.n_text_ctx + 7) // 8) * 8 + 8)
    cache = init_cache(model, xa, ctx_len=ctx_len,
                       quantize_cross="int4" if kv_int4 else kv_int8,
                       quantize_self=self_kv_int8)
    pad_len = (P - prompt_len).to(torch.int32)

    align_heads = list(align_heads) if capture_attention else []
    with stage_timer("prefill"):
        x, prefill_rows = _prefill(model, cache, prompt, pad_len, align_heads)
        sot_slot = P - sot_index_from_end
        x_sel = x[:, [sot_slot, P - 1]]
        sel_logits = _logits(_ln(x_sel, model.decoder["ln_g"], model.decoder["ln_b"]), model.decoder)
        no_speech_prob = torch.softmax(sel_logits[:, 0].float(), dim=-1)[:, no_speech]
        last_logits = sel_logits[:, 1]

    K = len(align_heads)
    T_audio = xa.shape[1]
    tokens = torch.full((B, max_new), eot, dtype=torch.int32, device=dev)
    token_logprobs = torch.zeros((B, max_new), dtype=torch.float32, device=dev)
    ts_logprobs = attn = None
    if capture_attention:
        ts_logprobs = torch.zeros((B, max_new, V - ts_begin), dtype=torch.float32, device=dev)
        attn = torch.zeros((B, max_new, K, T_audio), dtype=torch.float32, device=dev)
        attn[:, 0] = prefill_rows
    if temperature > 0:
        t_div = temperature_divisor(temperature, dev)
        gumbel = make_gumbel_source(rng_seed, dev)
    sum_logprobs = torch.zeros((B,), dtype=torch.float32, device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    last_token = prompt[:, -1]
    penult_token = prompt[:, -2]
    max_timestamp = torch.full((B,), ts_begin - 1, dtype=torch.long, device=dev)

    i = 0
    with stage_timer("decode_loop"):
        while i < max_new and not bool(finished.all()):
            logits = last_logits.float()
            # filters in whisper's order: blank, suppress, timestamp rules
            if suppress_blank and i == 0:
                logits = logits + blank_mask[None]
            logits = logits + suppress_mask[None]
            if not without_timestamps:
                logits = apply_timestamp_rules(
                    logits, last_token, penult_token, max_timestamp, i,
                    ts_begin=ts_begin, eot=eot, no_timestamps=no_timestamps,
                    max_initial_timestamp_index=max_initial_timestamp_index,
                )
            logprobs = torch.log_softmax(logits, dim=-1)
            if temperature > 0:
                tok = sample_tokens(logits, t_div, gumbel)
            else:
                tok = torch.argmax(logits, dim=-1)
            # sequence-length cap: force EOT when the true position would exceed n_ctx
            overflow = (P + i - pad_len) >= (dims.n_text_ctx - 1)
            tok = torch.where(finished | overflow, eot, tok)

            tok_logprob = torch.gather(logprobs, 1, tok[:, None])[:, 0]
            newly = ~finished
            sum_logprobs += torch.where(newly, tok_logprob, 0.0)
            tokens[:, i] = tok.to(torch.int32)
            token_logprobs[:, i] = torch.where(newly, tok_logprob, 0.0)
            if capture_attention:
                ts_logprobs[:, i] = logprobs[:, ts_begin:]
            max_timestamp = torch.where((tok >= ts_begin) & newly,
                                        torch.maximum(max_timestamp, tok), max_timestamp)
            finished = finished | (tok == eot)

            # feed the chosen token; its forward predicts token i+1
            logits_new, rows = decode_step(
                model, tok[:, None], cache, P + i,
                pos_offset=pad_len, kv_valid_from=pad_len, align_heads=align_heads,
            )
            if i + 1 < max_new and rows is not None:
                attn[:, i + 1] = rows[:, :, 0]
            last_logits = logits_new[:, -1]
            penult_token, last_token = last_token, tok
            i += 1
    add_count("decode_steps", i)

    n_sampled = (tokens != eot).sum(dim=-1) + (tokens == eot).any(dim=-1).to(torch.long)
    return dict(
        tokens=tokens,
        n_steps=i,
        sum_logprobs=sum_logprobs,
        token_logprobs=token_logprobs,
        ts_logprobs=ts_logprobs,
        attn=attn,
        no_speech_prob=no_speech_prob,
        n_sampled=n_sampled,
    )


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
