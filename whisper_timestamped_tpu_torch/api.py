"""Public API: ``transcribe_timestamped``, the orchestrator.

Port of ``whisper_timestamped_tpu/api.py`` for the default call: the greedy
single-pass engine with alignment on the device (``_transcribe_efficient``'s
``full_device`` branch: on the card through the CUDA kernels, on the CPU
through their plain versions), and the per-segment alignment helpers the
batch pipeline shares (``prefetch_ts_repair_rows``,
``prepare_segment_tokens``, ``device_align_segments``). Options outside
that path raise ``NotImplementedError`` naming the option.
"""

from __future__ import annotations

import logging
import sys
from typing import List, Optional, Union

import numpy as np
import torch

from .alignment import _punctuation, perform_word_alignment, round_confidence, round_timestamp
from .audio import AUDIO_TIME_PER_TOKEN, HOP_LENGTH, N_FRAMES, SAMPLE_RATE, load_audio
from .decoding import DecodingOptions
from .device_align import MAX_K, compute_jumps_batch, make_task
from .engine import DecodeEngine, Segment, transcribe_windows
from .languages import LANGUAGES, LANGUAGES_WITHOUT_SPACES, normalize_language
from .models.load import WhisperModel, load_model
from .postprocess import ensure_increasing_positions, remove_last_null_duration_words
from .tokenizer import Tokenizer, get_tokenizer
from .utils import not_ported, stage_timer

logger = logging.getLogger("whisper_timestamped_tpu_torch")

LANGUAGE_NAMES = {c: n.title() for c, n in LANGUAGES.items()}


def should_use_space(language: Optional[str]) -> bool:
    return normalize_language(language or "en") not in LANGUAGES_WITHOUT_SPACES


def format_timestamp(seconds: float) -> str:
    """[hh:]mm:ss.mmm (the JAX package's ``writers.format_timestamp`` with
    its defaults)."""
    if seconds < 0:
        raise ValueError("non-negative timestamp expected")
    ms = round(seconds * 1000.0)
    hours, ms = divmod(ms, 3_600_000)
    minutes, ms = divmod(ms, 60_000)
    secs, ms = divmod(ms, 1_000)
    hours_marker = f"{hours:02d}:" if hours > 0 else ""
    return f"{hours_marker}{minutes:02d}:{secs:02d}.{ms:03d}"


def print_timestamped(w: dict) -> None:
    line = f"[{format_timestamp(w['start'])} --> {format_timestamp(w['end'])}] {w['text']}\n"
    sys.stdout.write(line.encode(sys.getdefaultencoding(), errors="replace").decode())
    sys.stdout.flush()


def _resolve_tokenizer(model: WhisperModel, tokenizer, language, task) -> Tokenizer:
    if isinstance(tokenizer, Tokenizer):
        tokenizer.language = normalize_language(language) if language else tokenizer.language
        tokenizer.task = task
        return tokenizer
    if isinstance(tokenizer, str):
        return get_tokenizer(
            multilingual=model.is_multilingual, num_languages=model.num_languages,
            language=language, task=task, vocab_path=tokenizer,
        )
    if model.tokenizer_ranks is not None:
        # n_vocab = n_base + 2 + n_langs + 6 + 1501
        n_base = max(model.tokenizer_ranks.values()) + 1
        n_langs = model.dims.n_vocab - n_base - 1509
        if not (0 < n_langs <= 100):
            n_langs = model.num_languages
        multilingual = (
            model.tokenizer_multilingual
            if model.tokenizer_multilingual is not None
            else model.is_multilingual
        )
        return get_tokenizer(
            multilingual=multilingual, num_languages=n_langs, language=language,
            task=task, ranks=model.tokenizer_ranks,
        )
    raise ValueError(
        "No tokenizer vocabulary available: pass tokenizer=<Tokenizer or "
        "path to .tiktoken/vocab.json>, or place the vocabulary next to the "
        "model checkpoint."
    )


def _check_ported(temperature, best_of, beam_size, naive_approach, vad,
                  detect_disfluencies, trust_whisper_timestamps,
                  plot_word_alignment, use_backend_timestamps, device_alignment):
    temps = list(temperature) if isinstance(temperature, (list, tuple)) else [temperature]
    refused = [
        (any(float(t) > 0 for t in temps), "temperature > 0 (sampling)"),
        (len(temps) != 1, "a temperature fallback schedule"),
        ((best_of or 0) > 1, "best_of"),
        (beam_size is not None, "beam_size"),
        (naive_approach, "naive_approach"),
        (vad is not False and vad is not None, "vad"),
        (detect_disfluencies, "detect_disfluencies"),
        (not trust_whisper_timestamps, "trust_whisper_timestamps=False"),
        (bool(plot_word_alignment), "plot_word_alignment"),
        (use_backend_timestamps, "use_backend_timestamps"),
        (device_alignment is False, "device_alignment=False (host alignment)"),
    ]
    for cond, option in refused:
        if cond:
            raise not_ported(option)


def transcribe_timestamped(
    # Main options
    model: Union[WhisperModel, str],
    audio,
    language: Optional[str] = None,
    task: str = "transcribe",
    # Word-alignment options
    remove_punctuation_from_words: bool = False,
    compute_word_confidence: bool = True,
    include_punctuation_in_confidence: bool = False,
    refine_whisper_precision: float = 0.5,
    min_word_duration: float = 0.02,
    plot_word_alignment: Union[bool, str] = False,
    word_alignment_most_top_layers: Optional[int] = None,
    remove_empty_words: bool = False,
    use_backend_timestamps: bool = False,
    # Reproducibility
    seed: Optional[int] = 1234,
    vad=False,
    detect_disfluencies: bool = False,
    trust_whisper_timestamps: bool = True,
    naive_approach: bool = False,
    # Whisper decode options
    temperature=0.0,
    best_of: Optional[int] = None,
    beam_size: Optional[int] = None,
    patience: Optional[float] = None,
    length_penalty: Optional[float] = None,
    compression_ratio_threshold: Optional[float] = 2.4,
    logprob_threshold: Optional[float] = -1.0,
    no_speech_threshold: Optional[float] = 0.6,
    fp16=None,
    condition_on_previous_text: bool = True,
    initial_prompt: Optional[str] = None,
    suppress_tokens: Optional[str] = "-1",
    sample_len: Optional[int] = None,
    verbose: Optional[bool] = False,
    # framework extras
    tokenizer: Union[Tokenizer, str, None] = None,
    device_alignment: Optional[bool] = None,
) -> dict:
    """Transcribe audio with word-level timestamps and confidences.

    Same option surface and result schema as the JAX package's
    ``transcribe_timestamped``: a dict with ``text``, ``segments`` (each with
    ``words`` carrying text/start/end/confidence), ``language``, plus
    ``language_probs`` on auto-detection. The model's device and dtype
    decide where and in what precision it runs (``fp16`` is accepted and,
    as in the JAX package, not read). ``seed`` seeds the ``torch.Generator``
    handed to the decoder; the greedy path draws nothing from it.
    Alignment always runs on the model's device; ``device_alignment=False``
    (host alignment) and the other options listed in ``_check_ported`` are
    not yet ported and raise ``NotImplementedError``.
    """
    assert (
        refine_whisper_precision >= 0
        and round(refine_whisper_precision / AUDIO_TIME_PER_TOKEN)
        == refine_whisper_precision / AUDIO_TIME_PER_TOKEN
    ), f"refine_whisper_precision must be a positive multiple of {AUDIO_TIME_PER_TOKEN}"
    refine_whisper_precision_nframes = round(refine_whisper_precision / AUDIO_TIME_PER_TOKEN)
    assert min_word_duration >= 0, "min_word_duration must be a positive number"
    assert (
        word_alignment_most_top_layers is None or word_alignment_most_top_layers > 0
    ), "word_alignment_most_top_layers must be a strictly positive number"
    if isinstance(temperature, (list, tuple)) and len(temperature) == 1:
        temperature = temperature[0]
    _check_ported(temperature, best_of, beam_size, naive_approach, vad,
                  detect_disfluencies, trust_whisper_timestamps,
                  plot_word_alignment, use_backend_timestamps, device_alignment)

    if isinstance(model, str):
        model = load_model(model)
    if language is not None:
        language = normalize_language(language)
    tok = _resolve_tokenizer(model, tokenizer, language, task)

    alignment_heads = model.alignment_heads if word_alignment_most_top_layers is None else None
    if alignment_heads is None:
        top = word_alignment_most_top_layers or 6
        L, H = model.dims.n_text_layer, model.dims.n_text_head
        alignment_heads = [(l, h) for l in range(max(0, L - top), L) for h in range(H)]
    engine = DecodeEngine(
        WhisperModel(module=model.module, alignment_heads=alignment_heads,
                     model_name=model.model_name, tokenizer_ranks=model.tokenizer_ranks),
        tok,
    )
    if len(engine.align_heads) > MAX_K:
        raise not_ported(
            f"{len(engine.align_heads)} alignment heads (device alignment takes {MAX_K}; "
            "host alignment)"
        )

    audio = load_audio(audio)
    generator = torch.Generator(device=model.device)
    generator.manual_seed(seed or 0)

    transcription, words = _transcribe_efficient(
        engine,
        audio,
        language=language,
        task=task,
        temperatures=[float(temperature)],
        compression_ratio_threshold=compression_ratio_threshold,
        logprob_threshold=logprob_threshold,
        no_speech_threshold=no_speech_threshold,
        condition_on_previous_text=condition_on_previous_text,
        initial_prompt=initial_prompt,
        suppress_tokens=suppress_tokens,
        sample_len=sample_len,
        generator=generator,
        refine_whisper_precision_nframes=refine_whisper_precision_nframes,
        remove_punctuation_from_words=remove_punctuation_from_words,
        compute_word_confidence=compute_word_confidence,
        include_punctuation_in_confidence=include_punctuation_in_confidence,
        verbose=verbose,
    )
    return finalize_transcription(
        transcription,
        words,
        remove_empty_words=remove_empty_words,
        min_word_duration=min_word_duration,
        refine_whisper_precision=refine_whisper_precision,
        print_words=bool(verbose),
    )


def finalize_transcription(
    transcription: dict,
    words: List[dict],
    *,
    remove_empty_words: bool,
    min_word_duration: float,
    refine_whisper_precision: float,
    print_words: bool = False,
) -> dict:
    """Hallucination pruning, monotonicity repair and the word->segment
    merge (reference ``transcribe.py:313-339``)."""
    if remove_empty_words:
        transcription, words = remove_last_null_duration_words(
            transcription, words, recompute_text=True
        )
    ensure_increasing_positions(words, min_duration=min_word_duration)

    whisper_segments = transcription["segments"]
    for word in words:
        if print_words:
            print_timestamped(word)
        word.pop("tokens", None)
        word.pop("tokens_indices", None)
        word.pop("avg_logprob_reliable", None)
        idx_segment = word.pop("idx_segment")
        assert idx_segment < len(whisper_segments)
        segment = whisper_segments[idx_segment]
        if "words" in segment:
            segment["words"].append(word)
        else:
            segment["words"] = [word]
            if refine_whisper_precision:
                segment["start"] = word["start"]
        if refine_whisper_precision:
            segment["end"] = word["end"]
    return transcription


def _transcribe_efficient(
    engine: DecodeEngine,
    audio: np.ndarray,
    *,
    language,
    task,
    temperatures,
    compression_ratio_threshold,
    logprob_threshold,
    no_speech_threshold,
    condition_on_previous_text,
    initial_prompt,
    suppress_tokens,
    sample_len,
    generator,
    refine_whisper_precision_nframes,
    remove_punctuation_from_words,
    compute_word_confidence,
    include_punctuation_in_confidence,
    verbose,
):
    """The single-pass engine with full on-device alignment: the attention
    buffers never leave the device; only tokens, log-probs and jumps do."""
    tok = engine.tokenizer

    def verbose_cb(seg: Segment):
        line = f"[{format_timestamp(seg.start)} --> {format_timestamp(seg.end)}] {seg.text}"
        print(line.encode(sys.getdefaultencoding(), errors="replace").decode())

    opts = DecodingOptions(suppress_tokens=suppress_tokens, sample_len=sample_len)
    result = transcribe_windows(
        engine,
        audio,
        language=language,
        task=task,
        temperature=temperatures,
        compression_ratio_threshold=compression_ratio_threshold,
        logprob_threshold=logprob_threshold,
        no_speech_threshold=no_speech_threshold,
        condition_on_previous_text=condition_on_previous_text,
        initial_prompt=initial_prompt,
        decode_options=opts,
        return_language_probs=language is None,
        verbose_callback=verbose_cb if verbose else None,
        generator=generator,
    )
    if verbose and language is None and result.language is not None:
        print(f"Detected language: {LANGUAGE_NAMES.get(result.language, result.language)}")

    use_space = should_use_space(result.language)
    entries = [(seg, prepare_segment_tokens(seg, tok)) for seg in result.segments]
    with stage_timer("align"):
        all_jumps = device_align_segments(entries, tok, refine_whisper_precision_nframes)

    words: List[dict] = []
    segment_dicts: List[dict] = []
    for (seg, prep), jumps in zip(entries, all_jumps):
        if prep is None:
            continue
        with stage_timer("align"):
            ws, seg_dict = align_and_score_segment(
                seg,
                tok,
                prep,
                jumps,
                use_space=use_space,
                refine_whisper_precision_nframes=refine_whisper_precision_nframes,
                remove_punctuation_from_words=remove_punctuation_from_words,
                compute_word_confidence=compute_word_confidence,
                include_punctuation_in_confidence=include_punctuation_in_confidence,
            )
        if ws is None:
            continue  # segment dropped (no aligned words)
        idx = len(segment_dicts)
        for w in ws:
            w["idx_segment"] = idx
        seg_dict["id"] = idx
        segment_dicts.append(seg_dict)
        words.extend(ws)

    transcription = {
        "text": "".join(s["text"] for s in segment_dicts),
        "segments": segment_dicts,
        "language": result.language,
    }
    if result.language_probs:
        transcription["language_probs"] = result.language_probs
    return transcription, words


def device_align_segments(
    entries,  # [(Segment, prepare_segment_tokens output or None)]
    tok: Tokenizer,
    refine_whisper_precision_nframes: int,
    max_windows_per_chunk: int = 16,
    fetch: bool = True,
):
    """Batched on-device alignment. Returns per-entry jumps (None where the
    entry was not alignable). Chunked so the flattened attention buffer
    stays bounded for long audio.

    ``fetch=False`` (``api.py:716``) queues the aligner and its copies to the
    host and returns a zero-argument resolver for the same list, which the
    batch pipeline calls at assembly time."""
    jumps_out: List[Optional[np.ndarray]] = [None] * len(entries)
    deferred = []

    def flush(chunk):
        if not chunk:
            return
        bufs, offsets, total = [], {}, 0
        for _, seg, _ in chunk:
            w = seg.window
            key = id(w.attn_dev)
            if key not in offsets:
                offsets[key] = total
                bufs.append(w.attn_dev)
                total += w.attn_dev.shape[0] * w.attn_dev.shape[1]
        flat = torch.cat([b.reshape(-1, *b.shape[2:]) for b in bufs], dim=0)
        tasks, idxs = [], []
        for ei, seg, prep in chunk:
            tokens, local_rows, unfinished, max_duration = prep
            w = seg.window
            off = offsets[id(w.attn_dev)] + w.batch_index * w.attn_dev.shape[1]
            task = make_task(
                tokens, off, local_rows, tok,
                refine_whisper_precision_nframes=refine_whisper_precision_nframes,
                unfinished_decoding=unfinished, max_duration=max_duration,
            )
            if task is None:
                # empty plan: perform_word_alignment returns [] before reading jumps
                jumps_out[ei] = np.zeros((0,), np.int64)
                continue
            tasks.append(task)
            idxs.append(ei)
        deferred.append((idxs, compute_jumps_batch(flat, tasks, fetch=False)))

    chunk, windows_seen = [], set()
    for ei, (seg, prep) in enumerate(entries):
        if prep is None or len(prep[0]) <= 1:
            continue
        windows_seen.add((id(seg.window.attn_dev), seg.window.batch_index))
        chunk.append((ei, seg, prep))
        if len(windows_seen) >= max_windows_per_chunk:
            flush(chunk)
            chunk, windows_seen = [], set()
    flush(chunk)

    def resolve():
        for idxs, sub in deferred:
            for ei, j in zip(idxs, sub()):
                jumps_out[ei] = j
        return jumps_out

    return resolve() if fetch else resolve


def _needs_end_repair(tokens: List[int], tok: Tokenizer) -> bool:
    """True when the end<=start timestamp re-estimation fires (reference
    ``transcribe.py:528-538``)."""
    return (
        len(tokens) >= 2
        and tokens[-1] >= tok.timestamp_begin
        and tokens[0] >= tok.timestamp_begin
        and tokens[-1] <= tokens[0]
    )


def prefetch_ts_repair_rows(segments, tok: Tokenizer) -> dict:
    """One batched read of every timestamp-logprob row the end<=start repair
    of ``segments`` will need, keyed by ``id(seg)`` (``api.py:822``): the
    batch pipeline calls it between windows, so the repair costs one read
    per window buffer instead of one per segment."""
    need = [s for s in segments
            if s.window is not None
            and s.window.ts_logprobs_dev is not None
            and _needs_end_repair(s.tokens, tok)
            # the bound ts_logprob_row checks: out of range falls through to it
            and s.token_span[1] - 1 < s.window.ts_logprobs_dev.shape[1]]
    by_buf: dict = {}
    for s in need:
        by_buf.setdefault(id(s.window.ts_logprobs_dev), []).append(s)
    out = {}
    for group in by_buf.values():
        buf = group[0].window.ts_logprobs_dev
        bi = torch.as_tensor([s.window.batch_index for s in group], device=buf.device)
        ri = torch.as_tensor([s.token_span[1] - 1 for s in group], device=buf.device)
        for s, row in zip(group, buf[bi, ri].cpu().numpy()):
            out[id(s)] = row
    return out


def prepare_segment_tokens(seg: Segment, tok: Tokenizer, ts_row=None):
    """Pre-alignment token decisions for one segment: early-EOT append,
    stuck-LM flagging, end-token re-estimation (reference
    ``transcribe.py:490-538``). Returns (tokens, local_rows, unfinished,
    max_duration), or None when the segment has no tokens; ``local_rows[k]``
    is the attention row (in the window's buffer) feeding token k.
    ``ts_row`` injects the end-repair row (``prefetch_ts_repair_rows``);
    without it the row is read when the repair needs it."""
    window = seg.window
    a, b = seg.token_span
    tokens = list(seg.tokens)
    local_rows = list(range(a, b))
    is_last_of_window = b == len(window.tokens)
    unfinished = False

    if len(tokens) == 0:
        return None

    if tokens[-1] < tok.timestamp_begin:
        if is_last_of_window and window.hit_limit:
            unfinished = True  # stuck LM: decoding hit the token limit
        elif not window.hit_limit and is_last_of_window:
            # early EOT: append <|endoftext|> and the row that predicted it
            tokens = tokens + [tok.eot]
            local_rows = local_rows + [len(window.tokens)]
        else:
            unfinished = True

    if _needs_end_repair(tokens, tok):
        start_off = tokens[0] - tok.timestamp_begin
        row = ts_row if ts_row is not None else window.ts_logprob_row(b - 1)
        if row is not None and start_off + 1 < len(row):
            new_end = int(np.argmax(row[start_off + 1 :])) + start_off + 1
            tokens[-1] = tok.timestamp_begin + new_end

    max_duration = seg.segment_frames // 2 if seg.segment_frames < N_FRAMES else None
    return tokens, local_rows, unfinished, max_duration


def align_and_score_segment(
    seg: Segment,
    tok: Tokenizer,
    prepared,
    jumps: Optional[np.ndarray],
    *,
    use_space: bool,
    refine_whisper_precision_nframes: int,
    remove_punctuation_from_words: bool,
    compute_word_confidence: bool,
    include_punctuation_in_confidence: bool,
):
    """Words and confidences of one segment from its device-aligned jumps
    (reference per-segment flush work, ``transcribe.py:490-538, 965-995``).
    Returns (words, segment dict), or (None, None) when nothing aligned."""
    window = seg.window
    a, _ = seg.token_span
    tokens, _, unfinished, max_duration = prepared
    if len(tokens) <= 1:
        return None, None
    ws = perform_word_alignment(
        tokens, None, tok,
        use_space=use_space,
        max_duration=max_duration,
        refine_whisper_precision_nframes=refine_whisper_precision_nframes,
        remove_punctuation_from_words=remove_punctuation_from_words,
        unfinished_decoding=unfinished,
        precomputed_jumps=jumps,
    )
    if len(ws) == 0:
        return None, None

    offset = seg.seek * HOP_LENGTH / SAMPLE_RATE
    for w in ws:
        w["start"] = round_timestamp(w["start"] + offset)
        w["end"] = round_timestamp(w["end"] + offset)

    seg_dict = seg.to_dict()
    if compute_word_confidence:
        # per-text-token logprobs of the segment (timestamps excluded)
        lps = [window.token_logprobs[a + i] for i, t in enumerate(seg.tokens) if t < tok.eot]
        _attach_confidences(ws, seg_dict, lps, include_punctuation_in_confidence)
    return ws, seg_dict


def _attach_confidences(ws, seg_dict, lps, include_punctuation_in_confidence):
    """Word confidence = exp(mean) of its tokens' logprobs (trailing
    punctuation optionally excluded); segment confidence over them all
    (reference ``transcribe.py:965-995``)."""
    logprobs = np.array(lps, np.float64)
    if include_punctuation_in_confidence:
        seg_dict["confidence"] = round_confidence(
            float(np.exp(logprobs.mean())) if len(logprobs) else 0.0
        )
        logprobs_nopunc = None
    else:
        logprobs_nopunc = []
    i_end = 0
    for w in ws:
        i_start = i_end
        tokens_w = w["tokens"]
        i_end = min(i_end + len(tokens_w), len(logprobs))
        if include_punctuation_in_confidence:
            word_logprobs = logprobs[i_start:i_end]
        else:
            while (
                len(tokens_w) > 1
                and len(tokens_w[-1])
                and tokens_w[-1][-1] in _punctuation
            ):
                tokens_w = tokens_w[:-1]
            word_logprobs = logprobs[i_start : i_start + len(tokens_w)]
            logprobs_nopunc.append(word_logprobs)
        w["confidence"] = round_confidence(
            float(np.exp(word_logprobs.mean())) if len(word_logprobs) else 0.0
        )
    if i_end not in (len(logprobs), len(logprobs) - 1):
        # special tokens inside a segment break the word<->logprob tiling
        logger.warning(
            "Got inconsistent length for segment (%d != %d). Some words have been ignored.",
            len(logprobs), i_end,
        )
    if not include_punctuation_in_confidence:
        cat = np.concatenate(logprobs_nopunc) if logprobs_nopunc else np.array([])
        seg_dict["confidence"] = round_confidence(
            float(np.exp(cat.mean())) if len(cat) else 0.0
        )
