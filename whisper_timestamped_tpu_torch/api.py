"""Public API: ``transcribe_timestamped``, the orchestrator.

Port of ``whisper_timestamped_tpu/api.py``. It routes as the JAX package
does: ``beam_size``, ``best_of`` > 1, ``use_backend_timestamps`` or
``naive_approach`` take the two-pass engine
(``engine_naive.transcribe_naive``, beam search in its first pass), everything
else the single-pass engine (``_transcribe_efficient``), greedy or sampled,
with the temperature fallback. The single-pass engine has three alignment
routes: the batched device aligner (``full_device``: device alignment on,
at most ``MAX_K`` alignment heads, whisper's timestamps trusted), the
per-segment kernels (device alignment on, outside those gates) and the host
(``device_alignment=False``, or off by default on a CPU model); with
``detect_disfluencies`` and ``trust_whisper_timestamps=False`` (whole-window
alignment). On the card the kernels run, on the CPU their plain versions.
The per-segment helpers are shared with the batch pipeline
(``prefetch_ts_repair_rows``, ``prepare_segment_tokens``,
``device_align_segments``, ``align_and_score_segment``). ``vad`` runs
before the engines as the JAX package runs it (``vad.py``; silero on the
model's device) and maps the word times back to the original audio
(``finalize_transcription``); ``plot_word_alignment`` draws the alignment
figures (``plotting.py``) on the host route.
"""

from __future__ import annotations

import logging
import sys
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .alignment import _punctuation, perform_word_alignment, round_confidence, round_timestamp
from .audio import (
    AUDIO_TIME_PER_TOKEN,
    HOP_LENGTH,
    N_FRAMES,
    SAMPLE_RATE,
    load_audio,
    log_mel_spectrogram,
)
from .decoding import DecodingOptions
from .device_align import MAX_K, compute_jumps_batch, default_device_alignment, make_task
from .engine import DecodeEngine, Segment, transcribe_windows
from .languages import LANGUAGES, LANGUAGES_WITHOUT_SPACES, normalize_language
from .models.load import WhisperModel, load_model
from .postprocess import ensure_increasing_positions, remove_last_null_duration_words
from .tokenizer import Tokenizer, get_tokenizer
from .utils import stage_timer
from .vad import check_vad_method, remove_non_speech
from .writers import format_timestamp

logger = logging.getLogger("whisper_timestamped_tpu_torch")

LANGUAGE_NAMES = {c: n.title() for c, n in LANGUAGES.items()}


def should_use_space(language: Optional[str]) -> bool:
    return normalize_language(language or "en") not in LANGUAGES_WITHOUT_SPACES


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
    ``language_probs`` on auto-detection and ``speech_activity`` when
    ``vad`` runs. The model's device and dtype
    decide where and in what precision it runs (``fp16`` is accepted and,
    as in the JAX package, not read). ``seed`` seeds the sampler: the
    window at frame ``seek`` samples with ``(seed or 0) + seek`` (greedy
    decoding draws nothing). ``beam_size``, ``best_of`` > 1,
    ``use_backend_timestamps`` and ``naive_approach`` run the two-pass
    engine.

    ``device_alignment`` runs the alignment cost and DTW on the model's
    device: the batched aligner where its gates hold, else the per-segment
    kernels. None (the default) means on when the model is on CUDA, off on
    the CPU; the WTT_DEVICE_ALIGN env var ("1"/"0") overrides it.

    ``vad`` (True, "silero", "silero:vX.Y", "auditok"/"energy", or explicit
    (start, end) second pairs) cuts the non-speech out before decoding, the
    silero network on the model's device; the words are mapped back to the
    original audio's time. ``plot_word_alignment`` (True, or a path prefix
    for the saved figures) draws each segment's alignment, and the VAD
    overlay; it needs matplotlib and the host cost matrix.
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
    if beam_size is not None or (best_of or 0) > 1 or use_backend_timestamps:
        naive_approach = True  # as the JAX package routes (api.py:172-175)

    if plot_word_alignment:
        from .plotting import reset_plot_counter

        reset_plot_counter()  # figure numbering restarts per call

    vad = check_vad_method(vad)
    if isinstance(model, str):
        model = load_model(model)
    device_alignment_explicit = device_alignment is not None
    if device_alignment is None:
        device_alignment = default_device_alignment(model.device)
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

    audio = load_audio(audio)
    speech_convert = None
    vad_segments = None
    if vad is not None:
        audio, vad_segments, speech_convert = remove_non_speech(
            audio, method=vad, sample_rate=SAMPLE_RATE, avoid_empty_speech=True,
            plot=plot_word_alignment, device=engine.device,
        )
    # with VAD, live printing would show speech-time timestamps: the word
    # lines are printed after the back-conversion instead
    live_verbose = verbose if (vad is None or verbose is not True) else False
    temperatures = (
        [float(t) for t in temperature] if isinstance(temperature, (list, tuple))
        else [float(temperature)]
    )
    common = dict(
        language=language,
        task=task,
        temperatures=temperatures,
        compression_ratio_threshold=compression_ratio_threshold,
        logprob_threshold=logprob_threshold,
        no_speech_threshold=no_speech_threshold,
        condition_on_previous_text=condition_on_previous_text,
        initial_prompt=initial_prompt,
        suppress_tokens=suppress_tokens,
        sample_len=sample_len,
        seed=seed,
        trust_whisper_timestamps=trust_whisper_timestamps,
        refine_whisper_precision_nframes=refine_whisper_precision_nframes,
        remove_punctuation_from_words=remove_punctuation_from_words,
        compute_word_confidence=compute_word_confidence,
        include_punctuation_in_confidence=include_punctuation_in_confidence,
        detect_disfluencies=detect_disfluencies,
        verbose=live_verbose,
        plot_word_alignment=plot_word_alignment,
    )
    if naive_approach:
        from .engine_naive import transcribe_naive

        transcription, words = transcribe_naive(
            engine, audio, best_of=best_of, beam_size=beam_size, patience=patience,
            length_penalty=length_penalty, use_backend_timestamps=use_backend_timestamps,
            **common,
        )
    else:
        transcription, words = _transcribe_efficient(
            engine, audio, device_alignment=device_alignment,
            device_alignment_explicit=device_alignment_explicit, **common,
        )
    transcription = finalize_transcription(
        transcription,
        words,
        remove_empty_words=remove_empty_words,
        min_word_duration=min_word_duration,
        trust_whisper_timestamps=trust_whisper_timestamps,
        refine_whisper_precision=refine_whisper_precision,
        vad_convert=speech_convert,
        # the two-pass engine prints each word as it is aligned
        print_words_premerge=bool(verbose and not naive_approach and vad is None),
        print_words_postvad=bool(verbose and vad is not None),
    )
    if vad_segments is not None:
        transcription["speech_activity"] = [{"start": s, "end": e} for (s, e) in vad_segments]
    return transcription


def finalize_transcription(
    transcription: dict,
    words: List[dict],
    *,
    remove_empty_words: bool,
    min_word_duration: float,
    trust_whisper_timestamps: bool,
    refine_whisper_precision: float,
    vad_convert=None,
    print_words_premerge: bool = False,
    print_words_postvad: bool = False,
) -> dict:
    """Hallucination pruning, monotonicity repair, the word->segment merge
    (reference ``transcribe.py:313-339``) and the VAD back-conversion of
    word and segment times (``vad_convert``, ``api.py:354-366``). Without
    trusted whisper timestamps the repair keeps no minimal word duration
    (``api.py:331-333``). ``print_words_premerge`` prints each word before
    the merge, ``print_words_postvad`` after its back-conversion."""
    if remove_empty_words:
        transcription, words = remove_last_null_duration_words(
            transcription, words, recompute_text=True
        )
    ensure_increasing_positions(
        words, min_duration=min_word_duration if trust_whisper_timestamps else 0
    )

    whisper_segments = transcription["segments"]
    for word in words:
        if print_words_premerge:
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

    if vad_convert is not None:
        for segment in whisper_segments:
            for word in segment.get("words", []):
                word["start"], word["end"] = vad_convert(word["start"], word["end"])
                if print_words_postvad:
                    print_timestamped(word)
            if refine_whisper_precision and len(segment.get("words", [])):
                segment["start"] = segment["words"][0]["start"]
                segment["end"] = segment["words"][-1]["end"]
            else:
                segment["start"], segment["end"] = vad_convert(segment["start"], segment["end"])
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
    seed,
    refine_whisper_precision_nframes,
    remove_punctuation_from_words,
    compute_word_confidence,
    include_punctuation_in_confidence,
    detect_disfluencies,
    verbose,
    plot_word_alignment=False,
    device_alignment=False,
    device_alignment_explicit=True,
    trust_whisper_timestamps=True,
):
    """The single-pass engine (``api.py:376``). With full on-device
    alignment the attention buffers never leave the device; only tokens,
    log-probs and jumps (and, for disfluencies, the cost rows) do. Otherwise
    each window's attention comes to the host and each segment aligns
    through the per-segment kernels (``device_alignment``) or in numpy.
    ``plot_word_alignment`` keeps the attention on the host route (the
    figure needs the cost matrix) and draws each alignment with the
    window's mel."""
    tok = engine.tokenizer

    def verbose_cb(seg: Segment):
        line = f"[{format_timestamp(seg.start)} --> {format_timestamp(seg.end)}] {seg.text}"
        print(line.encode(sys.getdefaultencoding(), errors="replace").decode())

    full_device = (
        device_alignment
        and not plot_word_alignment
        and trust_whisper_timestamps
        and len(engine.align_heads) <= MAX_K
    )
    if device_alignment and not full_device:
        # an explicit request that cannot be met warns; the auto-resolved
        # default degrades with an info line only
        reasons = [
            r for cond, r in (
                (plot_word_alignment, "plot_word_alignment needs the host cost matrix"),
                (not trust_whisper_timestamps,
                 "trust_whisper_timestamps=False aligns whole windows on the host"),
                (len(engine.align_heads) > MAX_K,
                 f"{len(engine.align_heads)} alignment heads exceed the device aligner's "
                 f"capacity ({MAX_K})"),
            ) if cond
        ]
        (logger.warning if device_alignment_explicit else logger.info)(
            "device_alignment %s but falling back to host alignment: %s",
            "requested" if device_alignment_explicit else "auto-enabled",
            "; ".join(reasons),
        )

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
        rng_seed=seed or 0,
        fetch_alignment=not full_device,
    )
    if verbose and language is None and result.language is not None:
        print(f"Detected language: {LANGUAGE_NAMES.get(result.language, result.language)}")

    use_space = should_use_space(result.language)
    # the figures' mel pane: the whole audio's mel, on the host
    plot_mel = (
        log_mel_spectrogram(audio, n_mels=engine.dims.n_mels, device=engine.device).cpu().numpy()
        if plot_word_alignment else None
    )

    if not trust_whisper_timestamps:
        words, segment_dicts = _align_words_whole_windows(
            result,
            tok,
            use_space=use_space,
            refine_whisper_precision_nframes=refine_whisper_precision_nframes,
            remove_punctuation_from_words=remove_punctuation_from_words,
            compute_word_confidence=compute_word_confidence,
            include_punctuation_in_confidence=include_punctuation_in_confidence,
            detect_disfluencies=detect_disfluencies,
            plot_word_alignment=plot_word_alignment,
            plot_mel=plot_mel,
        )
    else:
        if full_device:
            entries = [(seg, prepare_segment_tokens(seg, tok)) for seg in result.segments]
            with stage_timer("align"):
                all_jumps = device_align_segments(
                    entries, tok, refine_whisper_precision_nframes,
                    fetch_cost=detect_disfluencies,
                )
        else:
            entries = [(seg, None) for seg in result.segments]
            all_jumps = [None] * len(entries)

        words: List[dict] = []
        segment_dicts: List[dict] = []
        for (seg, prep), jumps in zip(entries, all_jumps):
            if full_device and prep is None:
                continue
            cost = None
            if jumps is not None and detect_disfluencies:
                jumps, cost = jumps
            with stage_timer("align"):
                ws, seg_dict = align_and_score_segment(
                    seg,
                    tok,
                    use_space=use_space,
                    refine_whisper_precision_nframes=refine_whisper_precision_nframes,
                    remove_punctuation_from_words=remove_punctuation_from_words,
                    compute_word_confidence=compute_word_confidence,
                    include_punctuation_in_confidence=include_punctuation_in_confidence,
                    detect_disfluencies=detect_disfluencies,
                    plot=plot_word_alignment,
                    plot_mfcc=(plot_mel[:, seg.seek : seg.seek + N_FRAMES]
                               if plot_mel is not None else None),
                    device_alignment=device_alignment,
                    device=engine.device,
                    precomputed_jumps=jumps,
                    precomputed_cost=cost,
                    prepared=prep,
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


def _align_words_whole_windows(
    result,
    tok: Tokenizer,
    *,
    use_space: bool,
    refine_whisper_precision_nframes: int,
    remove_punctuation_from_words: bool,
    compute_word_confidence: bool,
    include_punctuation_in_confidence: bool,
    detect_disfluencies: bool,
    plot_word_alignment=False,
    plot_mel=None,
):
    """``trust_whisper_timestamps=False`` in the single-pass engine
    (``api.py:569``, reference ``transcribe.py:585-707``): each 30-s
    window's full token sequence aligns in one host DTW against the
    attention captured during decode, its first timestamp pinned to
    <|0.00|> and its last to <|30.00|>, and the words go back to whisper's
    segments by walking token counts. Returns ``(words, segment_dicts)``;
    every segment of the stream is emitted, with or without words.
    ``plot_word_alignment`` draws each window's alignment over ``plot_mel``
    (the whole audio's mel)."""
    ts_begin = tok.timestamp_begin
    words: List[dict] = []
    segment_dicts: List[dict] = []

    # group consecutive segments that came out of the same window decode
    groups: List[List[int]] = []
    for i, seg in enumerate(result.segments):
        if groups and result.segments[groups[-1][-1]].window is seg.window:
            groups[-1].append(i)
        else:
            groups.append([i])

    for group in groups:
        segs = [result.segments[i] for i in group]
        window = segs[0].window
        base_idx = len(segment_dicts)
        for seg in segs:
            d = seg.to_dict()
            d["id"] = len(segment_dicts)
            segment_dicts.append(d)

        tokens_w: List[int] = []
        rows_w: List[int] = []
        seg_of: List[int] = []  # output segment index per aligned token
        for gi, seg in enumerate(segs):
            a, b = seg.token_span
            tokens_w.extend(seg.tokens)
            rows_w.extend(range(a, b))
            seg_of.extend([base_idx + gi] * (b - a))
        if not tokens_w:
            continue

        unfinished = False
        if tokens_w[0] >= ts_begin:
            tokens_w[0] = ts_begin  # window starts at <|0.00|>
        else:  # a window that starts mid-text
            tokens_w.insert(0, ts_begin)
            rows_w.insert(0, rows_w[0])
            seg_of.insert(0, seg_of[0])
        if tokens_w[-1] >= ts_begin:
            tokens_w[-1] = ts_begin + N_FRAMES // 2  # window end at <|30.00|>
        elif window.hit_limit:
            unfinished = True  # stuck LM: no final timestamp
        else:
            # early EOT: align <|endoftext|> with the row that predicted it
            tokens_w.append(tok.eot)
            rows_w.append(len(window.tokens))
            seg_of.append(seg_of[-1])

        if len(tokens_w) <= 1:
            continue

        full_attn = window.attn
        if rows_w[-1] >= len(full_attn):
            full_attn = np.concatenate([full_attn, window.eot_attn[None]], axis=0)
        attn = full_attn[rows_w]

        segment_frames = segs[0].segment_frames
        max_duration = segment_frames // 2 if segment_frames < N_FRAMES else None
        with stage_timer("align"):
            ws = perform_word_alignment(
                tokens_w,
                attn,
                tok,
                use_space=use_space,
                max_duration=max_duration,
                refine_whisper_precision_nframes=refine_whisper_precision_nframes,
                remove_punctuation_from_words=remove_punctuation_from_words,
                detect_disfluencies=detect_disfluencies,
                unfinished_decoding=unfinished,
                plot=plot_word_alignment,
                plot_mfcc=(plot_mel[:, segs[0].seek : segs[0].seek + N_FRAMES]
                           if plot_mel is not None else None),
            )
        if not ws:
            continue

        offset = segs[0].seek * HOP_LENGTH / SAMPLE_RATE
        # walk the aligned token sequence to hand each word back to the
        # whisper segment its tokens came from
        i_token = 1  # skip the leading window-start timestamp
        per_seg_words: Dict[int, List[dict]] = {}
        for w in ws:
            w["start"] = round_timestamp(w["start"] + offset)
            w["end"] = round_timestamp(w["end"] + offset)
            idx = seg_of[i_token] if i_token < len(seg_of) else seg_of[-1]
            w["idx_segment"] = idx
            per_seg_words.setdefault(idx, []).append(w)
            i_token += len(w["tokens"])
            while i_token < len(tokens_w) and tokens_w[i_token] >= ts_begin:
                i_token += 1
            words.append(w)

        if compute_word_confidence:
            for gi, seg in enumerate(segs):
                a, b = seg.token_span
                lps = [window.token_logprobs[a + i] for i, t in enumerate(seg.tokens) if t < tok.eot]
                _attach_confidences(per_seg_words.get(base_idx + gi, []),
                                    segment_dicts[base_idx + gi], lps,
                                    include_punctuation_in_confidence)

    return words, segment_dicts


def device_align_segments(
    entries,  # [(Segment, prepare_segment_tokens output or None)]
    tok: Tokenizer,
    refine_whisper_precision_nframes: int,
    max_windows_per_chunk: int = 16,
    fetch: bool = True,
    fetch_cost: bool = False,
):
    """Batched on-device alignment. Returns per-entry jumps (None where the
    entry was not alignable), or (jumps, cost) pairs with ``fetch_cost``
    (disfluency detection reads the cost rows on the host). Chunked so the
    flattened attention buffer stays bounded for long audio.

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
        flat = [b.reshape(-1, *b.shape[2:]) for b in bufs]
        # one buffer (a batch's windows share one): its view, no copy, as the JAX
        # package's api.py:752-753 takes it
        flat = flat[0] if len(flat) == 1 else torch.cat(flat, dim=0)
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
                empty = np.zeros((0,), np.int64)
                jumps_out[ei] = (empty, None) if fetch_cost else empty
                continue
            tasks.append(task)
            idxs.append(ei)
        deferred.append((idxs, compute_jumps_batch(flat, tasks, fetch=False,
                                                   fetch_cost=fetch_cost)))

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
    *,
    use_space: bool,
    refine_whisper_precision_nframes: int,
    remove_punctuation_from_words: bool,
    compute_word_confidence: bool,
    include_punctuation_in_confidence: bool,
    detect_disfluencies: bool,
    plot=False,
    plot_mfcc: Optional[np.ndarray] = None,
    device_alignment: bool = False,
    device=None,
    precomputed_jumps: Optional[np.ndarray] = None,
    precomputed_cost: Optional[np.ndarray] = None,
    prepared=None,
):
    """Words and confidences of one segment (``api.py:918``, reference
    per-segment flush work, ``transcribe.py:490-538, 965-995``). Returns
    (words, segment dict), or (None, None) when nothing aligned.

    ``precomputed_jumps`` (with ``prepared`` from ``prepare_segment_tokens``)
    takes the batched device aligner's output; otherwise the segment aligns
    from the window's host attention, through the per-segment kernels on
    ``device`` with ``device_alignment``, else in numpy; on that route
    ``plot`` draws the alignment (with ``plot_mfcc``, the window's mel)."""
    window = seg.window
    a, _ = seg.token_span
    prep = prepared if prepared is not None else prepare_segment_tokens(seg, tok)
    if prep is None:
        return None, None
    tokens, local_rows, unfinished, max_duration = prep
    kw = dict(
        use_space=use_space,
        max_duration=max_duration,
        refine_whisper_precision_nframes=refine_whisper_precision_nframes,
        remove_punctuation_from_words=remove_punctuation_from_words,
        detect_disfluencies=detect_disfluencies,
        unfinished_decoding=unfinished,
    )
    if len(tokens) <= 1:
        ws = []
    elif precomputed_jumps is not None:
        ws = perform_word_alignment(tokens, None, tok, precomputed_jumps=precomputed_jumps,
                                    precomputed_cost=precomputed_cost, **kw)
    else:
        full_attn = window.attn
        if local_rows and local_rows[-1] >= len(full_attn):
            # the early-EOT row lives past the text rows, in eot_attn
            full_attn = np.concatenate([full_attn, window.eot_attn[None]], axis=0)
        ws = perform_word_alignment(tokens, full_attn[local_rows], tok, plot=plot,
                                    plot_mfcc=plot_mfcc, use_device_kernels=device_alignment,
                                    device=device, **kw)
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
