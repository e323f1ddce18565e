"""Batched multi-stream transcription pipeline and serving loop.

Port of ``whisper_timestamped_tpu/parallel/batch.py``. The reference transcribes one file at a time; here
many audio streams are in flight: every window iteration gathers one
pending 30-s window from each active stream and decodes them as ONE
batched ``decode_window`` call on the model's device, then advances each
stream's seek and prompt. Windows of one stream depend on each other
(through the seek advance and ``condition_on_previous_text``), so the
parallelism comes from the number of streams.

The audio of a batch is uploaded once, as int16 PCM through pinned memory
where that is lossless, and one batched mel runs on the device; every
window is a gather out of that mel stack. By default the window loop is
the device flow (``deviceflow.py``): the next window's seek and prompt are
computed on the device from the previous window's tokens, and the host
drains each window with one read. ``WTT_DEVICE_FLOW=0`` forces the host
loop, and so does anything that needs a host decision between windows: a
temperature schedule (the failing windows of an iteration are gathered on
the device, padded to the batch and decoded again at the next
temperature), sampling, ``best_of`` (each row decoded ``best_of`` times
by row replication, the best ``sequence_score`` kept), or beam search (at
a first temperature of 0 the batch's windows are one
``decode_window_beam_batch``; the words come from a batched teacher-forced
second pass, ``_assemble_naive_batch``). Iteration ``n``
samples with ``rng_seed + 104729 * n`` (``+ c0`` for a best_of chunk,
``+ ti`` for the ``ti``-th fallback temperature), as in the JAX package. With device alignment (at most ``MAX_K`` alignment heads) each
window's alignment is queued after the window (``window_hook``) and read at
assembly time; otherwise each window's attention comes to the host and the
segments align in numpy at assembly, as in the JAX package.
``transcribe_batch_stream`` overlaps the
next batch's upload and mel (a worker thread on its own CUDA stream) and
the previous batch's assembly (a second worker) with the current batch's
decode. ``vad`` cuts each stream's non-speech out on the host before the
batch (silero on the model's device) and maps the word times back.
``tail_batch`` (``WTT_TAIL_BATCH`` for the entry points) decodes the
iterations with at most that many active streams at that smaller batch,
its own captured token loop, on the host loop.

On a mesh (``mesh.get_mesh``; ``mesh=`` of the entry points, or an engine
built with one) the engine holds this rank's heads over ``tp``, and the
streams of each input are split over ``dp``: dp rank r takes the streams
``r::dp`` and runs the one-card pipeline above on them at ``batch_size //
dp`` rows (at least 1), aligning its own windows on its own device; then
the per-stream results, what the host reads, are gathered over ``dp``
(``mesh.gather_streams``), so that every rank returns the same dict in the
caller's order. The serving loop on a mesh with dp > 1 runs each batch
through ``transcribe_batch`` in turn (one gather a batch on every rank, in
the same order), without the prefetch.
"""

from __future__ import annotations

import contextlib
import logging
import os
import queue as queue_mod
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..audio import HOP_LENGTH, N_FRAMES, N_SAMPLES, as_pcm16, load_audio, log_mel_spectrogram
from ..decoding import (
    MAX_NEW_TOKENS,
    PROMPT_REGION,
    PROMPT_REGION_SMALL,
    DecodingOptions,
    decode_window,
    detect_language,
)
from ..device_align import MAX_K, default_device_alignment
from ..engine import (
    TIME_PER_POSITION,
    DecodeEngine,
    Segment,
    WindowDecodeResult,
    extract_window_segments,
    needs_fallback,
    row_options,
    sequence_score,
)
from ..tokenizer import Tokenizer
from ..utils import add_count, host_copy, stage_timer
from ..vad import check_vad_method, remove_non_speech
from .mesh import dp_streams, gather_streams, mesh_size
from .deviceflow import (
    advance_window_state,
    build_prompt_batch,
    initial_state,
    pack_host_outputs,
    split_host_outputs,
)

logger = logging.getLogger("whisper_timestamped_tpu_torch")


@dataclass
class _Stream:
    """Per-file decoding state. The stream's mel is row ``row`` of the
    transcriber's stacked device mel; only token ids and scalars cross to
    the host during the window loop."""

    name: str
    row: int  # index into the stacked device mel
    content_frames: int
    seek: int = 0
    all_tokens: List[int] = field(default_factory=list)
    prompt_reset_since: int = 0
    segments: List[Segment] = field(default_factory=list)
    done: bool = False
    language: Optional[str] = None
    language_probs: Optional[dict] = None


@dataclass
class PreparedAudio:
    """A batch's mel stack on the device plus host metadata, made by
    ``prepare_audio_batch`` and consumed by ``transcribe_streams(prepared=)``
    / ``transcribe_batch(_prepared=)``. ``ready`` is the event recorded on
    the CUDA stream that computed the mel, when that was not the consumer's
    stream."""

    mel_stack: torch.Tensor  # (N, n_mels, T_max + N_FRAMES)
    lengths: List[int]  # per-stream sample counts, in the order of the audios
    names: List[str]
    ready: Optional[Any] = None  # torch.cuda.Event


def prepare_audio_batch(audios: Dict[str, Any], n_mels: int, device,
                        stream=None) -> PreparedAudio:
    """Load the audios on the host, stack them (zero-padded to the longest,
    which is whisper's own window padding), upload the stack once and run
    one batched mel on ``device`` (``batch.py:89``). PCM-grid audio ships as
    int16, lossless and half the bytes, from pinned memory without blocking.
    With ``stream`` (a ``torch.cuda.Stream``) the upload and the mel run on
    that stream and an event recorded behind them is returned in ``ready``;
    the consumer's stream waits on it. Returns without waiting for the
    device."""
    device = torch.device(device)
    with stage_timer("prepare_audio"):
        wavs = [np.asarray(load_audio(a), np.float32) for a in audios.values()]
        lengths = [w.shape[-1] for w in wavs]
        audio_stack = np.zeros((len(wavs), max(lengths)), np.float32)
        for i, w in enumerate(wavs):
            audio_stack[i, : len(w)] = w
        pcm16 = as_pcm16(audio_stack)
        send = torch.from_numpy(pcm16 if pcm16 is not None else audio_stack)
        ready = None
        on_stream = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
        with on_stream:
            if device.type == "cuda":
                send = send.pin_memory()
            mel = log_mel_spectrogram(send.to(device, non_blocking=True), n_mels=n_mels,
                                      padding=N_SAMPLES)
            if stream is not None:
                ready = torch.cuda.Event()
                ready.record(stream)
    return PreparedAudio(mel_stack=mel, lengths=lengths, names=list(audios), ready=ready)


def slice_windows(mel_stack: torch.Tensor, rows: torch.Tensor, seeks: torch.Tensor) -> torch.Tensor:
    """(B, n_mels, N_FRAMES) windows out of the stacked mel: row ``rows[b]``
    from frame ``seeks[b]`` (``_slice_windows_jit``, ``batch.py:142``). As
    ``dynamic_slice`` does, the start is clamped to [0, W - N_FRAMES], so a
    finished stream whose seek ran past its end reads the last frames."""
    n_mels, W = mel_stack.shape[1], mel_stack.shape[2]
    dev = mel_stack.device
    start = seeks.to(device=dev, dtype=torch.long).clamp(0, W - N_FRAMES)
    cols = start[:, None] + torch.arange(N_FRAMES, device=dev)[None, :]
    rows = rows.to(device=dev, dtype=torch.long)
    return mel_stack[rows[:, None, None], torch.arange(n_mels, device=dev)[None, :, None],
                     cols[:, None, :]]


def _engine_on_mesh(model, tokenizer: Tokenizer, engine: Optional[DecodeEngine],
                    mesh) -> DecodeEngine:
    """The entry points' engine (``batch.py:953-955`` of the JAX package):
    a new one on ``mesh``, or the caller's, given ``mesh`` when it has
    none."""
    if engine is None:
        return DecodeEngine(model, tokenizer, mesh=mesh)
    if mesh is not None and engine.mesh is None:
        engine.attach_mesh(mesh)
    return engine


class BatchTranscriber:
    """Fixed-batch window decoder over many audio streams
    (``batch.py:153``): ``batch_size`` windows per decode call, padded with
    repeated windows when fewer are pending, so every call has one shape.
    ``fetch_alignment`` brings each window's attention to the host (host
    alignment); False leaves it on the device for the device aligner.
    ``tail_batch`` (``batch.py:180-186``): once at most that many streams
    are active, the windows decode at B = ``tail_batch`` (a second, smaller
    captured loop: a step's cost grows with the batch); None keeps
    ``batch_size`` throughout. ``mesh`` is attached to the engine when it
    has none (``batch.py:172-175``); with dp > 1 ``transcribe_streams``
    splits the streams over ``dp``."""

    def __init__(self, engine: DecodeEngine, batch_size: int = 8, mesh=None,
                 fetch_alignment: bool = True, tail_batch: Optional[int] = None):
        if mesh is not None and engine.mesh is None:
            engine.attach_mesh(mesh)
        self.mesh = mesh if mesh is not None else engine.mesh
        self.engine = engine
        self.batch_size = batch_size
        self.tail_batch = tail_batch
        self.fetch_alignment = fetch_alignment
        # name -> {"language", "language_probs"} after transcribe_streams
        self.stream_meta: Dict[str, dict] = {}
        self._mel_stack: Optional[torch.Tensor] = None

    # --------------------------------------------------------------
    def _decode_batch(self, mels, prompts: List[Sequence[int]], options: DecodingOptions,
                      temperature: float, rng_seed: int,
                      languages: Optional[List[Optional[str]]] = None) -> List[WindowDecodeResult]:
        """Decode one window batch and unpack its results."""
        out = self._dispatch_batch(mels, prompts, options, temperature, rng_seed, languages)
        with stage_timer("decode_fetch_unpack"):
            return self.engine.unpack_window_outputs(out, temperature,
                                                     fetch_alignment=self.fetch_alignment)

    def _dispatch_batch(self, mels, prompts: List[Sequence[int]], options: DecodingOptions,
                        temperature: float = 0.0, rng_seed: int = 0,
                        languages: Optional[List[Optional[str]]] = None):
        """Decode one window batch from host-built prompts: each row's
        prompt is right-aligned in one shared region with its own length,
        and its sot sequence carries its own language. Returns the
        ``decode_window`` buffers, still on the device."""
        engine = self.engine
        with stage_timer("decode_prompt_build"):
            bufs, lens, sot_from_end = [], [], None
            for i, p in enumerate(prompts):
                buf, plen, sfe = engine.build_prompt(p, row_options(options, languages, i))
                bufs.append(buf)
                lens.append(plen)
                sot_from_end = sfe
            if len({len(b) for b in bufs}) > 1:
                # mixed small and full prompt regions: all rows at full size
                bufs = [engine.build_prompt(p, row_options(options, languages, i),
                                            region=PROMPT_REGION)[0]
                        for i, p in enumerate(prompts)]
        return self._dispatch_arrays(mels, np.stack(bufs), np.asarray(lens, np.int32), options,
                                     sot_index_from_end=sot_from_end, temperature=temperature,
                                     rng_seed=rng_seed)

    def _dispatch_arrays(self, mels, prompt, prompt_len, options: DecodingOptions, *,
                         sot_index_from_end: int, temperature: float = 0.0, rng_seed: int = 0):
        """Decode one window batch on prebuilt prompt buffers (host arrays or
        tensors already on the device, as the device flow passes them)."""
        engine = self.engine
        tok = engine.tokenizer
        dev = engine.device
        sm, bm = engine._masks(options)
        max_init_ts = (
            round(options.max_initial_timestamp / TIME_PER_POSITION)
            if options.max_initial_timestamp is not None
            else None
        )
        with stage_timer("decode_dispatch"):
            return decode_window(
                engine.model.module,
                torch.as_tensor(mels, dtype=torch.float32, device=dev),
                torch.as_tensor(prompt, device=dev),
                torch.as_tensor(prompt_len, device=dev),
                sm, bm,
                align_heads=engine.align_heads,
                eot=tok.eot,
                ts_begin=tok.timestamp_begin,
                no_timestamps=tok.no_timestamps,
                sot_index_from_end=sot_index_from_end,
                max_initial_timestamp_index=max_init_ts,
                max_new=options.sample_len or MAX_NEW_TOKENS,
                suppress_blank=options.suppress_blank,
                without_timestamps=options.without_timestamps,
                temperature=float(temperature),
                rng_seed=rng_seed,
                graphs=engine.graphs,
                **engine.kv_options,
            )

    # --------------------------------------------------------------
    def _gather_windows(self, rows: List[int], seeks: List[int],
                        batch: Optional[int] = None) -> torch.Tensor:
        """(B, n_mels, N_FRAMES) window batch gathered from the device mel
        stack; rows past the list repeat stream 0's first window."""
        B = batch or self.batch_size
        dev = self._mel_stack.device
        rows_t = torch.as_tensor((rows + [0] * B)[:B], device=dev)
        seeks_t = torch.as_tensor((seeks + [0] * B)[:B], device=dev)
        return slice_windows(self._mel_stack, rows_t, seeks_t)

    def _detect_stream_languages(self, streams: List[_Stream]) -> None:
        """Batched language ID over each stream's first 30-s window, in
        chunks padded to ``batch_size``."""
        engine = self.engine
        B = self.batch_size
        for c0 in range(0, len(streams), B):
            chunk = streams[c0 : c0 + B]
            mel = self._gather_windows([s.row for s in chunk], [0] * len(chunk))
            codes, probs = detect_language(engine.model.module, mel, engine.tokenizer)
            for s, code, p in zip(chunk, codes, probs):
                s.language = code
                s.language_probs = p

    def _decode_batch_best_of(self, mels: torch.Tensor, prompts: List[Sequence[int]],
                              options: DecodingOptions, temperature: float, rng_seed: int,
                              languages: Optional[List[Optional[str]]]
                              ) -> List[WindowDecodeResult]:
        """best_of at t > 0 by row replication (``batch.py:357``): each row
        decoded ``best_of`` times, as independent samples, in chunks of the
        batch's size (the last padded with row 0; chunk ``c0`` samples with
        ``rng_seed + c0``); each row keeps its best ``sequence_score``, as
        the serial ``decode_window_best_of`` does."""
        n = options.best_of or 1
        if temperature <= 0 or n <= 1:
            return self._decode_batch(mels, prompts, options, temperature, rng_seed, languages)
        B = len(prompts)
        rep_idx = [i for i in range(B) for _ in range(n)]
        best: List[Optional[WindowDecodeResult]] = [None] * B
        for c0 in range(0, len(rep_idx), B):
            chunk = rep_idx[c0 : c0 + B]
            pad = B - len(chunk)
            idx = torch.as_tensor(chunk + [0] * pad, device=mels.device)
            rs = self._decode_batch(
                mels.index_select(0, idx), [prompts[i] for i in chunk] + [[]] * pad, options,
                temperature, rng_seed + c0,
                [languages[i] for i in chunk] + [None] * pad if languages else None,
            )
            for k, i in enumerate(chunk):
                if best[i] is None or sequence_score(rs[k], options.length_penalty) > \
                        sequence_score(best[i], options.length_penalty):
                    best[i] = rs[k]
        return best

    def _apply_window_results(self, batch: List[_Stream], results: List[WindowDecodeResult],
                              sizes: List[int], no_speech_threshold: Optional[float],
                              logprob_threshold: Optional[float],
                              condition_on_previous_text: bool) -> List[Segment]:
        """Per-stream segment extraction and seek/prompt bookkeeping for one
        decoded window batch (shared by the host loop and the device flow)."""
        tok = self.engine.tokenizer
        new_segments: List[Segment] = []
        for s, result, size in zip(batch, results, sizes):
            segs, new_seek = extract_window_segments(
                result, s.seek, size, tok, no_speech_threshold, logprob_threshold
            )
            s.seek = new_seek
            for seg in segs:
                seg.id = len(s.segments)
                s.segments.append(seg)
                s.all_tokens.extend(seg.tokens)
                new_segments.append(seg)
            if not condition_on_previous_text or result.temperature > 0.5:
                s.prompt_reset_since = len(s.all_tokens)
            if s.seek >= s.content_frames:
                s.done = True
        return new_segments

    # --------------------------------------------------------------
    def _device_flow_ok(self, streams, opts: DecodingOptions, temperature) -> bool:
        """The device flow engages when the host makes no data-dependent
        decision between windows: one temperature of 0 (no fallback
        re-decode), no best_of, no beam search, no prefix, timestamps on, at most
        ``batch_size`` streams, no ``tail_batch`` (``batch.py:453``). The
        no-speech skip is computed on the device. ``WTT_DEVICE_FLOW=0``
        forces the host loop."""
        return (
            os.environ.get("WTT_DEVICE_FLOW", "1") != "0"
            and len(temperature) == 1
            and float(temperature[0]) == 0.0
            and (opts.best_of or 1) <= 1
            and not opts.beam_size
            and not opts.without_timestamps
            and not opts.prefix
            and len(streams) <= self.batch_size
            and self.tail_batch is None
        )

    def _run_device_flow(self, streams: List[_Stream], opts: DecodingOptions, *,
                         no_speech_threshold: Optional[float],
                         logprob_threshold: Optional[float],
                         condition_on_previous_text: bool,
                         window_hook) -> Dict[str, List[Segment]]:
        """Window loop with device-resident advance state
        (``batch.py:456``). Window 0 decodes from host-built prompts; every
        later window is gathered and prompted from the state the previous
        decode's tokens advanced on the device. Each window's small outputs
        and state land in one packed read; the host extracts that window's
        segments one iteration behind and queues its alignment (the hook)
        behind the next decode. Host and device seeks are cross-checked every
        iteration: a divergence raises."""
        engine = self.engine
        tok = engine.tokenizer
        dev = engine.device
        B = self.batch_size
        H = engine.dims.n_text_ctx // 2 - 1
        eot, ts_begin = tok.eot, tok.timestamp_begin
        n_streams = len(streams)

        def active_snapshot():
            act = [s for s in streams if not s.done and s.seek < s.content_frames]
            return act, [min(N_FRAMES, s.content_frames - s.seek) for s in act]

        hook_prepare = getattr(window_hook, "prepare", None)

        def extract(results, act, sizes):
            """Host bookkeeping and the hook's prepare phase (its batched
            end-repair read) for the window that just landed."""
            segs = self._apply_window_results(
                act, [results[s.row] for s in act], sizes,
                no_speech_threshold, logprob_threshold, condition_on_previous_text,
            )
            prep = hook_prepare(segs) if (hook_prepare is not None and segs) else None
            return segs, prep

        def run_hook(segs, prep) -> None:
            if window_hook is not None and segs:
                window_hook(segs, prep) if hook_prepare is not None else window_hook(segs)

        def check_seeks(seeks):
            for s in streams:
                if int(seeks[s.row]) != s.seek:
                    raise RuntimeError(
                        f"device-flow seek divergence for {s.name}: "
                        f"device {int(seeks[s.row])} vs host {s.seek}"
                    )

        def advance_and_pack(out, state):
            state = advance_window_state(
                out["tokens"], state, frames_dev, eot=eot, ts_begin=ts_begin,
                no_speech_prob=out["no_speech_prob"], sum_logprobs=out["sum_logprobs"],
                no_speech_threshold=no_speech_threshold, logprob_threshold=logprob_threshold,
            )
            packed = pack_host_outputs(out["tokens"], out["token_logprobs"],
                                       out["sum_logprobs"], out["no_speech_prob"], state)
            return state, host_copy(packed)

        act0, sizes0 = active_snapshot()
        if not act0:
            return {s.name: s.segments for s in streams}

        # state before window 0 (hist carries any initial_prompt seed; it
        # feeds prompts only when conditioning is on)
        state, frames_dev = initial_state(
            [s.all_tokens[s.prompt_reset_since:] for s in streams],
            [s.seek for s in streams], [s.content_frames for s in streams],
            B, H, eot, device=dev,
        )
        rows_dev = torch.as_tensor([s.row for s in streams] + [0] * (B - n_streams), device=dev)
        S = 3 if tok.is_multilingual else 1
        sot_np = np.full((B, S), tok.sot, np.int32)
        if tok.is_multilingual:
            task_tok = tok.translate if opts.task == "translate" else tok.transcribe
            for i in range(B):
                lang = streams[i].language if i < n_streams else None
                sot_np[i, 1] = tok.to_language_token(lang or opts.language or "en")
                sot_np[i, 2] = task_tok
        sot_dev = torch.as_tensor(sot_np, device=dev)
        if not condition_on_previous_text:
            cbuf = np.full((B, PROMPT_REGION_SMALL), eot, np.int32)
            cbuf[:, PROMPT_REGION_SMALL - S:] = sot_np
            const_prompt = torch.as_tensor(cbuf, device=dev)
            const_plen = torch.full((B,), S, dtype=torch.int32, device=dev)

        # window 0: host-built prompts, device-chained state
        prompts0 = [s.all_tokens[s.prompt_reset_since:] for s in streams] + [[]] * (B - n_streams)
        langs0 = [s.language for s in streams] + [None] * (B - n_streams)
        mels0 = self._gather_windows([s.row for s in streams], [s.seek for s in streams])
        with stage_timer("devflow_dispatch"):
            out = self._dispatch_batch(mels0, prompts0, opts, languages=langs0)
            state, packed = advance_and_pack(out, state)
        M = int(out["tokens"].shape[1])

        pending = (out, act0, sizes0)
        it = 1
        while True:
            # ONE blocking read per window: its outputs, done mask and seeks
            with stage_timer("devflow_done_fetch"):
                p = packed()
            tok_np, lp_np, sum_np, nsp_np, done, seeks = split_host_outputs(p, M)
            p_out, p_act, p_sizes = pending
            with stage_timer("decode_fetch_unpack"):
                p_results = engine.build_window_results(tok_np, lp_np, sum_np, nsp_np, p_out, 0.0,
                                                        fetch_alignment=self.fetch_alignment)
            segs, prep = extract(p_results, p_act, p_sizes)
            check_seeks(seeks)
            if bool(done[:n_streams].all()):
                run_hook(segs, prep)
                break
            p_act, p_sizes = active_snapshot()  # the host mirror of the dispatch state
            mels = slice_windows(self._mel_stack, rows_dev, state.seek)
            if condition_on_previous_text:
                prompt, plen = build_prompt_batch(
                    state.hist, state.count, sot_dev,
                    region=PROMPT_REGION, eot=eot, sot_prev=tok.sot_prev,
                )
            else:
                prompt, plen = const_prompt, const_plen
            with stage_timer("devflow_dispatch"):
                out = self._dispatch_arrays(mels, prompt, plen, opts, sot_index_from_end=S)
                state, packed = advance_and_pack(out, state)
            # the previous window's alignment queues behind this decode
            run_hook(segs, prep)
            pending = (out, p_act, p_sizes)
            it += 1

        logger.debug("device flow: %d window iterations", it)
        return {s.name: s.segments for s in streams}

    # --------------------------------------------------------------
    def transcribe_streams(self, audios: Dict[str, Any], **kw) -> Dict[str, List[Segment]]:
        """Decode all streams; returns name -> alignment-ready segments
        (``batch.py:670``; keywords as ``decode_streams``). On a mesh with
        dp > 1 this rank decodes its streams ``r::dp`` at ``batch_size //
        dp`` rows and the segments are gathered over ``dp`` without their
        windows (the alignment payload stays on the rank that decoded
        it), as is ``stream_meta``: every rank returns the same dict, in
        the caller's order."""
        dp = mesh_size(self.mesh, "dp")
        if dp == 1:
            return self.decode_streams(audios, **kw)
        names = list(audios)
        local = BatchTranscriber(self.engine, batch_size=max(1, self.batch_size // dp),
                                 fetch_alignment=self.fetch_alignment, tail_batch=self.tail_batch)
        mine = {n: audios[n] for n in dp_streams(names, self.mesh)}
        segments = local.decode_streams(mine, **kw)
        part = {n: ([replace(s, window=None) for s in segs], local.stream_meta[n])
                for n, segs in segments.items()}
        merged = gather_streams(part, names, self.mesh)
        self.stream_meta = {n: meta for n, (_, meta) in merged.items()}
        return {n: segs for n, (segs, _) in merged.items()}

    def decode_streams(
        self,
        audios: Dict[str, Any],  # name -> path/array
        *,
        language: Optional[str] = None,
        task: str = "transcribe",
        temperature: Sequence[float] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
        compression_ratio_threshold: Optional[float] = 2.4,
        logprob_threshold: Optional[float] = -1.0,
        no_speech_threshold: Optional[float] = 0.6,
        condition_on_previous_text: bool = True,
        initial_prompt: Optional[str] = None,
        decode_options: Optional[DecodingOptions] = None,
        rng_seed: int = 0,
        window_hook=None,
        prepared: Optional[PreparedAudio] = None,
    ) -> Dict[str, List[Segment]]:
        """Decode all the streams on this rank's model, one card's pipeline
        whatever the mesh; returns name -> alignment-ready segments.
        ``window_hook(segments)`` runs after every window
        iteration with that iteration's new segments (device alignment uses
        it to consume and release each window's attention buffer).
        ``rng_seed`` seeds the sampler: iteration ``n`` (from 1) samples
        with ``rng_seed + 104729 * n``."""
        engine = self.engine
        tok = engine.tokenizer
        if isinstance(temperature, (int, float)):
            temperature = [float(temperature)]
        temperature = [float(t) for t in temperature]
        if language is None and not tok.is_multilingual:
            language = "en"
        opts = DecodingOptions(**{**(decode_options or DecodingOptions()).__dict__,
                                  "task": task, "language": language})
        if not audios:  # a dp rank with no streams of this input
            self.stream_meta = {}
            return {}

        # the mel front end, or a PreparedAudio that a serving loop uploaded
        # while the previous batch decoded
        with stage_timer("batch_mel"):
            if prepared is None:
                prepared = prepare_audio_batch(audios, engine.dims.n_mels, engine.device)
            elif prepared.names != list(audios):
                raise ValueError(
                    "prepared audio batch does not match the streams: "
                    f"{prepared.names} vs {list(audios)}"
                )
            if prepared.ready is not None:
                consumer = torch.cuda.current_stream(prepared.mel_stack.device)
                consumer.wait_event(prepared.ready)
                prepared.mel_stack.record_stream(consumer)
            self._mel_stack = prepared.mel_stack

        streams = [
            # frames of content: the per-stream mel's count minus the 30-s pad
            _Stream(name=name, row=row, content_frames=n_samples // HOP_LENGTH, language=language)
            for row, (name, n_samples) in enumerate(zip(audios, prepared.lengths))
        ]
        if initial_prompt:
            # seeds every stream's history as the serial loop does
            ip_tokens = tok.encode(" " + initial_prompt.strip())
            for s in streams:
                s.all_tokens.extend(ip_tokens)
        if language is None:
            self._detect_stream_languages(streams)
        self.stream_meta = {
            s.name: {"language": s.language, "language_probs": s.language_probs}
            for s in streams
        }

        if self._device_flow_ok(streams, opts, temperature):
            return self._run_device_flow(
                streams, opts,
                no_speech_threshold=no_speech_threshold,
                logprob_threshold=logprob_threshold,
                condition_on_previous_text=condition_on_previous_text,
                window_hook=window_hook,
            )

        B = self.batch_size
        n_iter = 0
        # the hook runs one iteration late, so its device work queues behind
        # the next window's decode; its prepare phase (which reads from the
        # device) runs at extraction time
        hook_prepare = getattr(window_hook, "prepare", None)
        pending_hook: List[Tuple[list, Any]] = []

        def flush_hook():
            for segs, prep in pending_hook:
                window_hook(segs, prep) if hook_prepare is not None else window_hook(segs)
            pending_hook.clear()

        while True:
            active = [s for s in streams if not s.done and s.seek < s.content_frames]
            if not active:
                break
            B_eff = B
            if self.tail_batch and len(active) <= self.tail_batch:
                B_eff = self.tail_batch  # the stragglers: the smaller loop
            batch = active[:B_eff]
            n_real = len(batch)
            # not gated on condition_on_previous_text: with it off,
            # prompt_reset_since moves after every window, so only window 0
            # sees a prompt (the initial_prompt seed)
            prompts = [s.all_tokens[s.prompt_reset_since:] for s in batch] + [[]] * (B_eff - n_real)
            languages = [s.language for s in batch] + [None] * (B_eff - n_real)
            sizes = [min(N_FRAMES, s.content_frames - s.seek) for s in batch]
            mels = self._gather_windows([s.row for s in batch], [s.seek for s in batch], batch=B_eff)
            n_iter += 1
            # a seed per iteration (the serial loop varies it per window):
            # one seed for every iteration would correlate the windows' noise
            it_seed = rng_seed + 104729 * n_iter
            with stage_timer(f"batch_decode_b{B_eff}_a{n_real}"):
                if opts.beam_size and temperature[0] <= 0:
                    # beam search at temperature 0 only; the fallback
                    # temperatures sample (``batch.py:813-825``)
                    if window_hook is not None:
                        flush_hook()
                    results = engine.decode_window_beam_batch(mels, opts, prompts, languages)
                elif temperature[0] <= 0 or (opts.best_of or 1) <= 1:
                    out = self._dispatch_batch(mels, prompts, opts, temperature[0], it_seed,
                                               languages)
                    if window_hook is not None:
                        flush_hook()
                    with stage_timer("decode_fetch_unpack"):
                        results = engine.unpack_window_outputs(
                            out, temperature[0], fetch_alignment=self.fetch_alignment)
                else:
                    if window_hook is not None:
                        flush_hook()
                    results = self._decode_batch_best_of(mels, prompts, opts, temperature[0],
                                                         it_seed, languages)
            # the temperature fallback: the failing rows, gathered on the
            # device and padded to the batch with row 0, decoded again
            for ti, t in enumerate(temperature[1:], start=1):
                failing = [i for i in range(n_real)
                           if needs_fallback(results[i], compression_ratio_threshold,
                                             logprob_threshold, no_speech_threshold)]
                if not failing:
                    break
                n_pad = B_eff - len(failing)
                with stage_timer("batch_fallback"):
                    sub_mels = mels.index_select(
                        0, torch.as_tensor(failing + [0] * n_pad, device=mels.device))
                    retry = self._decode_batch_best_of(
                        sub_mels, [prompts[i] for i in failing] + [[]] * n_pad, opts, t,
                        it_seed + ti, [languages[i] for i in failing] + [None] * n_pad,
                    )
                add_count("fallback_redecodes", len(failing))
                for k, i in enumerate(failing):
                    results[i] = retry[k]
            new_segments = self._apply_window_results(
                batch, results[:n_real], sizes,
                no_speech_threshold, logprob_threshold, condition_on_previous_text,
            )
            if new_segments and window_hook is not None:
                prep = hook_prepare(new_segments) if hook_prepare is not None else None
                pending_hook.append((new_segments, prep))

        if window_hook is not None:
            flush_hook()
        return {s.name: s.segments for s in streams}


def transcribe_batch(
    model,
    audios: Dict[str, Any],
    tokenizer: Tokenizer,
    *,
    language: Optional[str] = None,
    batch_size: int = 8,
    mesh=None,
    compute_word_confidence: bool = True,
    detect_disfluencies: bool = False,
    remove_punctuation_from_words: bool = False,
    refine_whisper_precision: float = 0.5,
    min_word_duration: float = 0.02,
    remove_empty_words: bool = False,
    vad=False,
    device_alignment: Optional[bool] = None,
    engine: Optional[DecodeEngine] = None,
    _prepared: Optional[PreparedAudio] = None,
    _deferred_assembly: bool = False,
    **window_options,
) -> Dict[str, dict]:
    """Batched API (``batch.py:889``): name -> whisper-timestamped result
    dict, the schema of ``transcribe_timestamped``. Runs on the model's
    device and never moves the model. ``device_alignment`` (None: on when
    the model is on CUDA; WTT_DEVICE_ALIGN overrides) with at most
    ``MAX_K`` alignment heads queues each window's alignment on the device
    as the window lands and reads it at assembly time; otherwise the
    attention comes to the host and each segment aligns in numpy at
    assembly. ``engine`` overrides the default ``DecodeEngine``. ``vad``
    cuts each stream's non-speech out first (``vad.remove_non_speech``, as
    ``batch.py:931-949`` does; silero on the engine's device) and maps word
    and segment times back to the original audio, with each result's
    ``speech_activity``. With
    ``decode_options.beam_size`` the windows are beam-decoded and the words
    come from the two-pass engine's teacher-forced pass, batched across the
    streams (``_assemble_naive_batch``), on the host audio; device
    alignment does not apply (asked for explicitly, it warns).
    ``_deferred_assembly`` (used by ``transcribe_batch_stream``) returns a
    zero-argument ``finish()`` that reads the alignment and assembles the
    results, instead of the results, once the decode is done. ``mesh``:
    the engine's (attached when it has none); with dp > 1 this rank
    transcribes its streams ``r::dp`` at ``batch_size // dp`` rows (VAD and
    alignment included) and the result dicts are gathered over ``dp``."""
    from ..api import (
        align_and_score_segment,
        device_align_segments,
        finalize_transcription,
        prefetch_ts_repair_rows,
        prepare_segment_tokens,
        should_use_space,
    )
    engine = _engine_on_mesh(model, tokenizer, engine, mesh)
    names = list(audios)
    dp = mesh_size(engine.mesh, "dp")
    if dp > 1:
        audios = {n: audios[n] for n in dp_streams(names, engine.mesh)}
        batch_size = max(1, batch_size // dp)

    def gathered(results: Dict[str, dict]) -> Dict[str, dict]:
        return results if dp == 1 else gather_streams(results, names, engine.mesh)

    vad = check_vad_method(vad)
    converts: Dict[str, Any] = {}
    speech_activity: Dict[str, Any] = {}
    if vad is not None:
        preprocessed = {}
        for name, audio in audios.items():
            speech, segs, convert = remove_non_speech(
                load_audio(audio), method=vad, avoid_empty_speech=True, device=engine.device
            )
            preprocessed[name] = speech
            converts[name] = convert
            speech_activity[name] = [{"start": s, "end": e} for (s, e) in segs]
        audios = preprocessed
    device_alignment_explicit = device_alignment is not None
    if device_alignment is None:
        device_alignment = default_device_alignment(engine.device)
    decode_opts = window_options.get("decode_options")
    beam_mode = bool(decode_opts is not None and decode_opts.beam_size)
    if beam_mode:
        # beam windows carry no attention: the words come from a batched
        # teacher-forced pass over each stream's host audio (``batch.py:957-975``)
        if device_alignment and device_alignment_explicit:
            logger.warning(
                "beam_size uses teacher-forced (naive-engine) alignment; "
                "device_alignment does not apply to the beam pipeline"
            )
        audios = {name: load_audio(a) for name, a in audios.items()}
    full_device = device_alignment and not beam_mode and len(engine.align_heads) <= MAX_K
    if device_alignment and not full_device and not beam_mode:
        # an explicit request that cannot be met warns; the auto-resolved
        # default degrades with an info line only
        (logger.warning if device_alignment_explicit else logger.info)(
            "device_alignment %s but falling back to host alignment: %d alignment heads "
            "exceed the device aligner's capacity (%d)",
            "requested" if device_alignment_explicit else "auto-enabled",
            len(engine.align_heads), MAX_K,
        )
    tail_batch = os.environ.get("WTT_TAIL_BATCH")
    bt = BatchTranscriber(engine, batch_size=batch_size, fetch_alignment=not full_device,
                          tail_batch=int(tail_batch) if tail_batch else None)
    refine_nframes = round(refine_whisper_precision / 0.02)

    # each window's segments are aligned as soon as the window lands, and its
    # attention buffer is dropped: keeping every window's buffer to the end
    # would grow device memory with the audio's length
    jumps_map: Dict[int, Any] = {}
    preps_map: Dict[int, Any] = {}
    pending_aligns: List[Tuple[list, Any]] = []

    def _prepare_step(new_segments: List[Segment]):
        """Phase 1: token decisions and one batched read of the end-repair
        rows, between a window landing and the next decode."""
        with stage_timer("batch_prepare"):
            ts_rows = prefetch_ts_repair_rows(new_segments, engine.tokenizer)
            return [(seg, prepare_segment_tokens(seg, engine.tokenizer, ts_row=ts_rows.get(id(seg))))
                    for seg in new_segments]

    def _align_step(new_segments: List[Segment], entries=None) -> None:
        """Phase 2: queue the aligner and its copies to the host; the
        resolver runs at assembly time."""
        with stage_timer("batch_align"):
            if entries is None:
                entries = _prepare_step(new_segments)
            resolver = device_align_segments(entries, engine.tokenizer, refine_nframes,
                                             fetch=False, fetch_cost=detect_disfluencies)
            for seg, p in entries:
                preps_map[id(seg)] = p
                # release the big device buffers (attention, timestamp logprobs)
                seg.window.attn_dev = None
                seg.window.ts_logprobs_dev = None
            pending_aligns.append((entries, resolver))

    _align_step.prepare = _prepare_step

    all_segments = bt.decode_streams(
        audios, language=language, prepared=_prepared,
        window_hook=_align_step if full_device else None, **window_options,
    )
    if beam_mode:
        results = _assemble_naive_batch(
            engine, bt, audios, all_segments,
            language=language,
            task=window_options.get("task", "transcribe"),
            batch_size=batch_size,
            refine_nframes=refine_nframes,
            refine_whisper_precision=refine_whisper_precision,
            remove_punctuation_from_words=remove_punctuation_from_words,
            compute_word_confidence=compute_word_confidence,
            detect_disfluencies=detect_disfluencies,
            remove_empty_words=remove_empty_words,
            min_word_duration=min_word_duration,
            converts=converts,
            speech_activity=speech_activity,
        )
        results = gathered(results)
        return (lambda: results) if _deferred_assembly else results

    # everything past here reads the queued alignment and assembles on the
    # host; the fields it needs are captured now (the transcriber's
    # stream_meta is replaced, never mutated, by the next batch)
    stream_meta = bt.stream_meta

    def finish() -> Dict[str, dict]:
        for entries, resolver in pending_aligns:
            for (seg, _p), j in zip(entries, resolver()):
                jumps_map[id(seg)] = j
        with stage_timer("batch_assemble"):
            results = {name: _assemble_stream(name, segments)
                       for name, segments in all_segments.items()}
        return gathered(results)

    def _assemble_stream(name: str, segments: List[Segment]) -> dict:
        meta = stream_meta.get(name, {})
        stream_language = meta.get("language") or language or "en"
        use_space = should_use_space(stream_language)
        words: List[dict] = []
        seg_dicts: List[dict] = []
        for seg in segments:
            if full_device and preps_map.get(id(seg)) is None:
                continue
            jumps = jumps_map.get(id(seg))
            cost = None
            if jumps is not None and detect_disfluencies:
                jumps, cost = jumps
            # the host route aligns in numpy, as the JAX package's batch does
            ws, seg_dict = align_and_score_segment(
                seg, engine.tokenizer,
                use_space=use_space,
                refine_whisper_precision_nframes=refine_nframes,
                remove_punctuation_from_words=remove_punctuation_from_words,
                compute_word_confidence=compute_word_confidence,
                include_punctuation_in_confidence=False,
                detect_disfluencies=detect_disfluencies,
                precomputed_jumps=jumps,
                precomputed_cost=cost,
                prepared=preps_map.get(id(seg)) if full_device else None,
            )
            if ws is None:
                continue
            idx = len(seg_dicts)
            for w in ws:
                w["idx_segment"] = idx
            seg_dict["id"] = idx
            seg_dicts.append(seg_dict)
            words.extend(ws)
        transcription = {
            "text": "".join(s["text"] for s in seg_dicts),
            "segments": seg_dicts,
            "language": stream_language,
        }
        if meta.get("language_probs") is not None:
            transcription["language_probs"] = meta["language_probs"]
        transcription = finalize_transcription(
            transcription, words,
            remove_empty_words=remove_empty_words,
            min_word_duration=min_word_duration,
            trust_whisper_timestamps=True,
            refine_whisper_precision=refine_whisper_precision,
            vad_convert=converts.get(name),
        )
        if name in speech_activity:
            transcription["speech_activity"] = speech_activity[name]
        return transcription

    return finish if _deferred_assembly else finish()


def _assemble_naive_batch(
    engine: DecodeEngine,
    bt: BatchTranscriber,
    audios: Dict[str, np.ndarray],
    all_segments: Dict[str, List[Segment]],
    *,
    language: Optional[str],
    task: str,
    batch_size: int,
    refine_nframes: int,
    refine_whisper_precision: float,
    remove_punctuation_from_words: bool,
    compute_word_confidence: bool,
    detect_disfluencies: bool,
    remove_empty_words: bool,
    min_word_duration: float,
    converts: Dict[str, Any],
    speech_activity: Dict[str, Any],
) -> Dict[str, dict]:
    """The beam pipeline's second pass (``batch.py:1141``): every stream
    gets the two-pass engine's ``naive_word_requests`` generator, and
    ``drive_teacher_forced_batch`` runs their segments' teacher-forced
    forwards in batches across the streams. ``converts`` and
    ``speech_activity`` (by stream name) carry the VAD's back-conversion
    and speech spans."""
    from ..api import finalize_transcription, should_use_space
    from ..engine import TranscribeResult
    from ..engine_naive import drive_teacher_forced_batch, naive_word_requests

    def stream_language(name: str) -> str:
        return bt.stream_meta.get(name, {}).get("language") or language or "en"

    gens = {}
    seg_dicts_map: Dict[str, List[dict]] = {}
    for name, segments in all_segments.items():
        meta = bt.stream_meta.get(name, {})
        whisper_segments = [seg.to_dict() for seg in segments]
        for i, s in enumerate(whisper_segments):
            s["id"] = i
        seg_dicts_map[name] = whisper_segments
        result = TranscribeResult(
            text="".join(s["text"] for s in whisper_segments),
            segments=segments,
            language=stream_language(name),
            language_probs=meta.get("language_probs"),
        )
        gens[name] = naive_word_requests(
            engine, audios[name], result, whisper_segments,
            language=stream_language(name),
            use_space=should_use_space(stream_language(name)),
            task=task,
            trust_whisper_timestamps=True,
            refine_whisper_precision_nframes=refine_nframes,
            remove_punctuation_from_words=remove_punctuation_from_words,
            compute_word_confidence=compute_word_confidence,
            include_punctuation_in_confidence=False,
            detect_disfluencies=detect_disfluencies,
            verbose=False,
            min_word_duration=min_word_duration,
        )

    with stage_timer("batch_naive_align"):
        words_map = drive_teacher_forced_batch(engine, gens, batch_size=batch_size)

    results = {}
    with stage_timer("batch_assemble"):
        for name, whisper_segments in seg_dicts_map.items():
            meta = bt.stream_meta.get(name, {})
            transcription = {
                "text": "".join(s["text"] for s in whisper_segments),
                "segments": whisper_segments,
                "language": stream_language(name),
            }
            if meta.get("language_probs") is not None:
                transcription["language_probs"] = meta["language_probs"]
            transcription = finalize_transcription(
                transcription, words_map.get(name, []),
                remove_empty_words=remove_empty_words,
                min_word_duration=min_word_duration,
                trust_whisper_timestamps=True,
                refine_whisper_precision=refine_whisper_precision,
                vad_convert=converts.get(name),
            )
            if name in speech_activity:
                transcription["speech_activity"] = speech_activity[name]
            results[name] = transcription
    return results


def transcribe_batch_stream(
    model,
    batches,  # iterable of {name: path/array} dicts
    tokenizer: Tokenizer,
    *,
    engine: Optional[DecodeEngine] = None,
    mesh=None,
    **options,
):
    """Serving loop (``batch.py:1230``): transcribe a stream of batches and
    yield one ``{name: result}`` per batch, in order, equal to calling
    ``transcribe_batch`` on each batch alone.

    While batch k decodes on the main thread, a worker thread loads batch
    k+1, uploads it and runs its mel on its own CUDA stream (the consumer's
    stream waits on the event it records), and a one-thread executor
    assembles batch k-1: upload, decode and assembly are in flight at once.
    ``batches`` may block between items (a directory watcher): the prefetch
    thread is a daemon, so an idle source never holds the consumer or the
    process. An exception of the source is raised in the consumer after the
    batches before it are yielded; closing the generator early stops both
    workers. ``vad`` and beam search run each batch through
    ``transcribe_batch`` in turn, without the prefetch
    (``batch.py:1270-1279``): both read each stream's host audio. So does
    a mesh with dp > 1: every rank gathers each batch's results once, in
    the batches' order."""
    engine = _engine_on_mesh(model, tokenizer, engine, mesh)
    decode_opts = options.get("decode_options")
    if (check_vad_method(options.get("vad", False)) is not None
            or (decode_opts is not None and decode_opts.beam_size)
            or mesh_size(engine.mesh, "dp") > 1):
        for audios in batches:
            yield transcribe_batch(model, audios, tokenizer, engine=engine, **options)
        return
    device = engine.device
    n_mels = engine.dims.n_mels
    it = iter(batches)
    done = object()
    q: Any = queue_mod.Queue(maxsize=1)
    stop = threading.Event()

    def worker():
        try:
            side = torch.cuda.Stream(device) if device.type == "cuda" else None
            for audios in it:
                prepared = prepare_audio_batch(audios, n_mels, device, stream=side)
                # maxsize=1: one finished preparation queued, one in flight
                q.put((audios, prepared))
                if stop.is_set():
                    return
            q.put(done)
        except Exception as exc:  # raised again on the consumer's side
            q.put(exc)

    t = threading.Thread(target=worker, daemon=True, name="wtt-prefetch")
    t.start()
    finisher = ThreadPoolExecutor(max_workers=1, thread_name_prefix="wtt-assemble")
    prev_fut = None
    try:
        pending_item = None
        while True:
            item = pending_item if pending_item is not None else q.get()
            pending_item = None
            if item is done or isinstance(item, Exception):
                # the deferred batch decoded before the source ended or failed
                if prev_fut is not None:
                    yield prev_fut.result()
                    prev_fut = None
                if item is done:
                    return
                raise item
            audios, prepared = item
            finish = transcribe_batch(model, audios, tokenizer, engine=engine,
                                      _prepared=prepared, _deferred_assembly=True, **options)
            # defer the assembly only when the next batch is (about to be)
            # queued: with an idle source, a decoded batch is finished now
            try:
                pending_item = q.get(timeout=0.2)
            except queue_mod.Empty:
                pending_item = None
            if pending_item is None:
                if prev_fut is not None:
                    yield prev_fut.result()
                    prev_fut = None
                yield finish()
            else:
                fut = finisher.submit(finish)
                if prev_fut is not None:
                    yield prev_fut.result()
                prev_fut = fut
    finally:
        stop.set()
        finisher.shutdown(wait=False, cancel_futures=True)
        try:  # unblock a worker waiting on the full queue
            q.get_nowait()
        except queue_mod.Empty:
            pass
