"""Two-pass ("naive") engine: full decode, then teacher-forced re-alignment.

Port of ``whisper_timestamped_tpu/engine_naive.py`` (the reference's
``_transcribe_timestamped_naive``, reference ``transcribe.py:1004-1338``).
Pass 1 is the long-form decode of ``engine.transcribe_windows`` (beam
search at temperature 0 when ``beam_size`` is set, greedy, or best_of
sampling, with the temperature fallback) without alignment rows.
Pass 2 runs each segment's audio again through a teacher-forced forward:
its log-mel on the model's device (``log10_mel``), the encoder (its
attention through ``flash_attention``) and ``decode_full``, which keeps
only the alignment heads' pre-softmax rows. Words are aligned on the host,
as in the JAX package. ``use_backend_timestamps`` instead times the words
from pass 1's own attention with HuggingFace's algorithm
(``backend_timestamps``); when a window of pass 1 has no attention (a beam
window), it warns and aligns by pass 2, as the JAX package does.

Reference quirks kept, as the goldens pin them:
  * attention rows are taken from position ``i_start-1`` on: the row that
    *predicts* each token (reference ``transcribe.py:1252``);
  * the punctuation-stripping condition in word confidence is inverted
    relative to the single-pass engine (reference ``transcribe.py:1285-1292``).
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import numpy as np
import torch

from .alignment import _punctuation, perform_word_alignment, round_confidence
from .api import LANGUAGE_NAMES, print_timestamped, should_use_space
from .audio import (
    AUDIO_TIME_PER_TOKEN,
    HOP_LENGTH,
    N_FRAMES,
    N_SAMPLES_PER_TOKEN,
    SAMPLE_RATE,
    log_mel_spectrogram,
    pad_or_trim,
)
from .decoding import DecodingOptions
from .engine import DecodeEngine, transcribe_windows
from .languages import normalize_language
from .models.whisper_torch import decode_full, encode
from .utils import add_count, stage_timer

logger = logging.getLogger("whisper_timestamped_tpu_torch")

SEGMENT_DURATION = 30.0


@torch.no_grad()
def _forward(engine: DecodeEngine, mels: torch.Tensor, tokens: torch.Tensor):
    """The teacher-forced forward on the model's device: (logprobs
    (B, S, V) f32, alignment-head rows (B, S, K, T) f32), both fetched to
    the host."""
    module = engine.model.module
    xa = encode(module, mels.to(engine.device, torch.float32))
    logits, rows = decode_full(module, tokens.to(engine.device).long(), xa,
                               align_heads=engine.align_heads)
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    add_count("tf_segments", mels.shape[0])
    return logprobs.cpu().numpy(), rows.transpose(1, 2).cpu().numpy()


def _teacher_forced(engine: DecodeEngine, mel: torch.Tensor, tokens: List[int]):
    """One teacher-forced forward (``engine_naive.py:54``). Returns
    (logprobs (S, V) f32, alignment-head rows (S, K, T))."""
    logprobs, rows = _forward(engine, mel[None], torch.as_tensor([tokens]))
    return logprobs[0], rows[0]


def transcribe_naive(
    engine: DecodeEngine,
    audio: np.ndarray,
    *,
    language: Optional[str],
    task: str,
    temperatures: Sequence[float],
    best_of: Optional[int],
    beam_size: Optional[int],
    patience: Optional[float],
    length_penalty: Optional[float],
    compression_ratio_threshold: Optional[float],
    logprob_threshold: Optional[float],
    no_speech_threshold: Optional[float],
    condition_on_previous_text: bool,
    initial_prompt: Optional[str],
    suppress_tokens,
    sample_len: Optional[int],
    seed: Optional[int],
    trust_whisper_timestamps: bool,
    use_backend_timestamps: bool,
    refine_whisper_precision_nframes: int,
    remove_punctuation_from_words: bool,
    compute_word_confidence: bool,
    include_punctuation_in_confidence: bool,
    detect_disfluencies: bool,
    verbose,
    min_word_duration: float = 0.0,
    plot_word_alignment=False,
):
    """The two-pass engine (``engine_naive.py:73``). Returns
    ``(transcription, words)`` for ``api.finalize_transcription``.
    ``plot_word_alignment`` draws pass 2's alignments."""
    tok = engine.tokenizer
    audio = np.asarray(audio, np.float32)

    opts = DecodingOptions(
        beam_size=beam_size,
        best_of=best_of,
        patience=patience,
        length_penalty=length_penalty,
        suppress_tokens=suppress_tokens,
        sample_len=sample_len,
    )
    if verbose and language is None and tok.is_multilingual:
        # whisper's pre-detection message (reference transcribe.py:1030-1032)
        print(
            "Detecting language using up to the first 30 seconds. "
            "Use `--language` to specify the language"
        )
    with stage_timer("naive_pass1"):
        result = transcribe_windows(
            engine,
            audio,
            language=language,
            task=task,
            temperature=list(temperatures),
            compression_ratio_threshold=compression_ratio_threshold,
            logprob_threshold=logprob_threshold,
            no_speech_threshold=no_speech_threshold,
            condition_on_previous_text=condition_on_previous_text,
            initial_prompt=initial_prompt,
            decode_options=opts,
            return_language_probs=language is None,
            rng_seed=seed or 0,
            # pass 1 keeps alignment rows only when they time the words
            # (backend timestamps); otherwise pass 2 supplies them
            fetch_alignment=use_backend_timestamps,
            capture_attention=use_backend_timestamps,
        )
    if verbose and language is None and result.language is not None:
        # whisper's detection message (reference transcribe.py:1073-1076)
        print(f"Detected language: {LANGUAGE_NAMES.get(result.language, result.language)}")
    language = normalize_language(result.language) if result.language else language
    use_space = should_use_space(language)

    whisper_segments = [seg.to_dict() for seg in result.segments]
    for i, s in enumerate(whisper_segments):
        s["id"] = i

    # beam windows carry no attention (``engine_naive.py:157-167``)
    have_attention = all(
        seg.window is not None and seg.window.attn is not None and seg.window.attn.size
        for seg in result.segments
    )
    if use_backend_timestamps and not have_attention:
        logger.warning(
            "use_backend_timestamps unavailable for beam-decoded windows "
            "(no on-the-fly attention); using teacher-forced alignment"
        )
    if use_backend_timestamps and have_attention:
        # HF generate(return_token_timestamps)'s algorithm over pass 1's own
        # attention (reference transcribe.py:2667-2806), then the naive
        # engine's early return (transcribe.py:1079-1091)
        from .backend_timestamps import backend_words_for_window, hf_token_timestamps

        words: List[dict] = []
        groups: List[List[int]] = []
        for i, seg in enumerate(result.segments):
            if groups and result.segments[groups[-1][-1]].window is seg.window:
                groups[-1].append(i)
            else:
                groups.append([i])
        for group in groups:
            window = result.segments[group[0]].window
            if not len(window.tokens):
                continue
            token_times = hf_token_timestamps(window.attn)
            words.extend(
                backend_words_for_window(
                    window.tokens,
                    token_times,
                    [(i, result.segments[i].token_span) for i in group],
                    tok,
                    use_space=use_space,
                    remove_punctuation_from_words=remove_punctuation_from_words,
                    time_offset=result.segments[group[0]].seek * HOP_LENGTH / SAMPLE_RATE,
                )
            )
        return _make_transcription(whisper_segments, result), words

    gen = naive_word_requests(
        engine, audio, result, whisper_segments,
        language=language, use_space=use_space, task=task,
        trust_whisper_timestamps=trust_whisper_timestamps,
        refine_whisper_precision_nframes=refine_whisper_precision_nframes,
        remove_punctuation_from_words=remove_punctuation_from_words,
        compute_word_confidence=compute_word_confidence,
        include_punctuation_in_confidence=include_punctuation_in_confidence,
        detect_disfluencies=detect_disfluencies,
        verbose=verbose,
        min_word_duration=min_word_duration,
        plot_word_alignment=plot_word_alignment,
    )
    with stage_timer("naive_pass2"):
        words = drive_teacher_forced_serial(gen, engine)
    return _make_transcription(whisper_segments, result), words


def drive_teacher_forced_serial(gen, engine: DecodeEngine) -> List[dict]:
    """Serial driver for ``naive_word_requests`` (``engine_naive.py:223``):
    one teacher-forced forward per request."""
    try:
        req = next(gen)
        while True:
            req = gen.send(_teacher_forced(engine, *req))
    except StopIteration as e:
        return e.value if e.value is not None else []


def drive_teacher_forced_batch(engine: DecodeEngine, gens: dict, batch_size: int = 8) -> dict:
    """Drive many streams' ``naive_word_requests`` generators in lock-step
    (``engine_naive.py:235``). Each stream's requests are serial (a
    segment's window depends on the previous segment's aligned end), but
    streams are independent: every round batches the current request of up
    to ``batch_size`` live streams into one teacher-forced forward, token
    lengths bucketed (``_bucket_len``). Returns name -> words."""
    live = {}
    words: dict = {}
    for name, gen in gens.items():
        try:
            live[name] = (gen, gen.send(None))
        except StopIteration as e:
            words[name] = e.value if e.value is not None else []
    while live:
        names = list(live)[:batch_size]
        outs = _teacher_forced_batch(engine, [live[n][1] for n in names])
        for n, out in zip(names, outs):
            gen = live[n][0]
            try:
                live[n] = (gen, gen.send(out))
            except StopIteration as e:
                del live[n]
                words[n] = e.value if e.value is not None else []
    return words


def _bucket_len(n: int) -> int:
    """Token counts padded to a few sizes (``engine_naive.py:268``)."""
    for b in (32, 64, 128, 256):
        if n <= b:
            return b
    return 448 + 2  # sot_seq(<=4) + ts + tokens never exceeds n_text_ctx


def _teacher_forced_batch(engine: DecodeEngine, reqs):
    """Batched ``_teacher_forced`` (``engine_naive.py:276``): one encoder
    and decoder forward over S segments, tokens right-padded with EOT to
    the bucket (causal self-attention keeps the pad tail out of the valid
    rows). Returns per request (logprobs (S_i, V) f32, rows (S_i, K, T))."""
    lens = [len(t) for _, t in reqs]
    toks = np.full((len(reqs), _bucket_len(max(lens))), engine.tokenizer.eot, np.int64)
    for i, (_, t) in enumerate(reqs):
        toks[i, : len(t)] = t
    mels = torch.stack([torch.as_tensor(m, dtype=torch.float32, device=engine.device)
                        for m, _ in reqs])
    logprobs, rows = _forward(engine, mels, torch.from_numpy(toks))
    return [(logprobs[i, : lens[i]], rows[i, : lens[i]]) for i in range(len(reqs))]


def naive_word_requests(
    engine: DecodeEngine,
    audio: np.ndarray,
    result,
    whisper_segments: List[dict],
    *,
    language: Optional[str],
    use_space: bool,
    trust_whisper_timestamps: bool,
    refine_whisper_precision_nframes: int,
    remove_punctuation_from_words: bool,
    compute_word_confidence: bool,
    include_punctuation_in_confidence: bool,
    detect_disfluencies: bool,
    verbose,
    min_word_duration: float = 0.0,
    task: str = "transcribe",
    plot_word_alignment=False,
):
    """Per-stream word generator, pass 2 (``engine_naive.py:315``).

    Yields ``(mel, tokens_tf)`` teacher-forced requests (the mel on the
    model's device) and receives ``(logprobs, attn_all)`` through ``send``;
    returns the stream's words. Each segment's window depends on the
    previous segment's aligned end (reference ``transcribe.py:1137-1174``),
    so a stream's requests are serial; a driver may batch across streams."""
    tok = engine.tokenizer
    refine_sec = refine_whisper_precision_nframes * AUDIO_TIME_PER_TOKEN
    audio = np.asarray(audio, np.float32)
    audio_duration = audio.shape[-1] / SAMPLE_RATE

    words: List[dict] = []
    previous_end = 0.0
    current_tokens: List[int] = []
    token_to_idx_segment: List[int] = []

    for i_segment, seg in enumerate(result.segments):
        segment = whisper_segments[i_segment]
        start = end = tokens = None

        if trust_whisper_timestamps:
            start = segment["start"]
            end = segment["end"]
            if end < start:
                end = min(audio_duration, start + SEGMENT_DURATION)

            start_margin_min = start - refine_sec
            start_margin_max = start + refine_sec
            if start >= audio_duration - min_word_duration or (
                start_margin_min <= previous_end <= start_margin_max
            ):
                start = previous_end
            else:
                start = start_margin_min

            if start > audio_duration - min_word_duration:
                logger.warning("Skipping segment outside of audio duration")
                continue

            end_margin_min = end - refine_sec
            end_margin_max = end + refine_sec
            if i_segment < len(whisper_segments) - 1:
                end_margin_max2 = (
                    whisper_segments[i_segment + 1]["start"] + refine_sec - min_word_duration
                )
                if end_margin_max2 >= end_margin_min:
                    end_margin_max = min(end_margin_max2, end_margin_max)
            end = min(audio_duration, end_margin_max)

            if end < start + min_word_duration:
                end = min(audio_duration, start + min_word_duration)
                if end <= start:
                    logger.warning("Skipping short segment too close to the end")
                    continue
            tokens = list(segment["tokens"])
        else:
            seek = segment["seek"]
            new_tokens = list(segment["tokens"])
            if not new_tokens:
                continue
            if new_tokens[0] < tok.timestamp_begin:
                rel_start = segment["start"] - seek * HOP_LENGTH / SAMPLE_RATE
                new_tokens = [
                    round(rel_start * SAMPLE_RATE / N_SAMPLES_PER_TOKEN) + tok.timestamp_begin
                ] + new_tokens
            if new_tokens[-1] < tok.timestamp_begin:
                rel_end = segment["end"] - seek * HOP_LENGTH / SAMPLE_RATE
                new_tokens = new_tokens + [
                    round(rel_end * SAMPLE_RATE / N_SAMPLES_PER_TOKEN) + tok.timestamp_begin
                ]
            current_tokens.extend(new_tokens)
            token_to_idx_segment.extend([i_segment] * len(new_tokens))
            next_seek = (
                result.segments[i_segment + 1].seek
                if i_segment < len(result.segments) - 1
                else None
            )
            if seek != next_seek:
                start = float(seek * HOP_LENGTH / SAMPLE_RATE)
                end = min(start + SEGMENT_DURATION, audio_duration)
                tokens = current_tokens

        if tokens is None or not len(tokens):
            continue

        start_sample = min(round(start * SAMPLE_RATE), audio.shape[-1])
        end_sample = min(round(end * SAMPLE_RATE), audio.shape[-1])

        sub_audio = audio[start_sample:end_sample]
        if sub_audio.shape[-1] <= 200:  # minimum padding (reference :1353)
            sub_audio = pad_or_trim(sub_audio, 201)
        mel = log_mel_spectrogram(sub_audio, n_mels=engine.dims.n_mels, device=engine.device)
        n_content_frames = mel.shape[-1]
        mel = pad_or_trim(mel, N_FRAMES, axis=-1)

        segment_tokens_check: List[int] = []
        if tokens[0] >= tok.timestamp_begin:
            segment_tokens_check.append(tokens[0])
        while tokens[0] >= tok.timestamp_begin:
            tokens = tokens[1:]
            assert len(tokens), "Got transcription with only timestamps!"
        last_token_check = None
        while tokens[-1] >= tok.timestamp_begin:
            last_token_check = tokens[-1]
            tokens = tokens[:-1]

        sot_sequence = [tok.sot]
        if tok.is_multilingual:
            sot_sequence += [
                tok.to_language_token(language or "en"),
                tok.translate if task == "translate" else tok.transcribe,
            ]
        tokens_tf = [*sot_sequence, tok.timestamp_begin] + tokens
        i_start = len(sot_sequence)

        logprobs, attn_all = yield (mel, tokens_tf)

        end_token = tok.timestamp_begin + round(
            min(N_FRAMES * HOP_LENGTH, end_sample - start_sample) // N_SAMPLES_PER_TOKEN
        )
        tokens_align = tokens_tf[i_start:] + [end_token]
        # rows from i_start-1: the row PREDICTING each aligned token (:1252)
        attn_rows = attn_all[i_start - 1 :]

        max_duration = n_content_frames // 2 if n_content_frames < N_FRAMES else None
        ws = perform_word_alignment(
            tokens_align,
            attn_rows,
            tok,
            use_space=use_space,
            max_duration=max_duration,
            refine_whisper_precision_nframes=refine_whisper_precision_nframes,
            remove_punctuation_from_words=remove_punctuation_from_words,
            detect_disfluencies=detect_disfluencies,
            # the teacher-forced pass plots too (reference transcribe.py:1251)
            plot=plot_word_alignment,
            plot_mfcc=mel.cpu().numpy() if plot_word_alignment else None,
        )

        segment_logprobs: List[np.ndarray] = []
        i_token = 1
        i_start_conf = i_start
        for word in ws:
            word["start"] = round(word["start"] + start, 2)
            word["end"] = round(word["end"] + start, 2)

            if trust_whisper_timestamps:
                word["idx_segment"] = i_segment
            else:
                assert i_token < len(tokens_align)
                word["idx_segment"] = token_to_idx_segment[i_token]
                i_token += len(word["tokens"])
                while i_token < len(tokens_align) and tokens_align[i_token] >= tok.timestamp_begin:
                    i_token += 1

            tok_indices = word["tokens_indices"]
            segment_tokens_check.extend(tok_indices)

            if compute_word_confidence:
                toks_w = word["tokens"]
                i_end_conf = i_start_conf + len(toks_w)
                if include_punctuation_in_confidence:  # reference quirk (:1285)
                    while (
                        len(toks_w) > 1 and len(toks_w[-1]) and toks_w[-1][-1] in _punctuation
                    ):
                        toks_w = toks_w[:-1]
                        tok_indices = tok_indices[:-1]
                word_logprobs = np.array(
                    [
                        logprobs[step, t]
                        for step, t in zip(
                            range(i_start_conf, i_start_conf + len(tok_indices)), tok_indices
                        )
                    ]
                )
                i_start_conf = i_end_conf
                if len(word_logprobs):
                    segment_logprobs.append(word_logprobs)
                    word_confidence = float(np.exp(word_logprobs.mean()))
                else:
                    word_confidence = 0.0
                word["confidence"] = round_confidence(word_confidence)

            words.append(word)
            if verbose:
                print_timestamped(word)

        if last_token_check is not None:
            segment_tokens_check.append(last_token_check)
        if trust_whisper_timestamps and segment_tokens_check != segment["tokens"]:
            if len(segment_tokens_check) < len(segment["tokens"]) and (
                segment_tokens_check[:-1]
                == segment["tokens"][: len(segment_tokens_check) - 1]
            ):
                segment["tokens"] = segment_tokens_check
                segment["text"] = tok.decode(segment["tokens"])
            else:
                logger.warning("Inconsistent tokens after teacher-forced alignment")

        if len(segment_logprobs):
            segment["confidence"] = round_confidence(
                float(np.exp(np.concatenate(segment_logprobs).mean()))
            )

        if len(ws):
            previous_end = ws[-1]["end"]

        if not trust_whisper_timestamps:
            current_tokens = []
            token_to_idx_segment = []

    return words


def _make_transcription(whisper_segments, result):
    transcription = {
        "text": "".join(s["text"] for s in whisper_segments),
        "segments": whisper_segments,
        "language": result.language,
    }
    if result.language_probs:
        transcription["language_probs"] = result.language_probs
    return transcription
