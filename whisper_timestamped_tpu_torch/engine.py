"""Long-form transcription engine: the 30-second sliding-window loop.

Port of ``whisper_timestamped_tpu/engine.py``: ``DecodeEngine`` (bf16 or
f32, whatever the model holds) with ``build_prompt``, ``decode_window``
(greedy at temperature 0, sampled above it) and the result unpacking the
batch pipeline shares, ``decode_window_best_of``, ``decode_with_fallback``
(whisper's temperature schedule), ``sequence_score``, ``needs_fallback``,
``transcribe_windows`` (window ``seek`` samples with ``rng_seed + seek``)
and ``extract_window_segments``. The mel and the window slicing and padding
run in torch on the model's device. ``fetch_alignment`` (the default, as in
the JAX package) brings each window's alignment buffers to the host for the
host and per-segment aligners; ``fetch_alignment=False`` leaves them on the
device for the batched device aligner; ``capture_attention=False`` keeps
none (the two-pass engine's first pass). The engine takes the KV-cache
quantization levers (``kv_int8``, ``kv_int4``, ``self_kv_int8``).
``decode_window_beam`` and ``decode_window_beam_batch`` run beam search
(``decoding_beam.py``), and ``decode_with_fallback`` takes it at
temperature 0 when ``beam_size`` is set. The weight levers ``w_int8`` and
``enc_int8`` give the engine int8 copies of the weights
(``models.whisper_torch.QuantizedWhisper``). ``mesh`` (a
``parallel.mesh.get_mesh`` mesh) shards the model over its ``tp`` axis;
the engine's own decodes treat ``dp`` as replicas (every dp rank computes
every row; the batch layer splits the streams). Each engine owns the
captured token loops of its window decodes and their persistent buffers
(``graphs``, a ``decoding.DecodeGraphs``), freed with it.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .audio import HOP_LENGTH, N_FRAMES, N_SAMPLES, SAMPLE_RATE, as_pcm16, log_mel_spectrogram
from .decoding import (
    MAX_NEW_TOKENS,
    PROMPT_REGION,
    PROMPT_REGION_SMALL,
    DecodeGraphs,
    DecodingOptions,
    build_blank_mask,
    build_suppress_mask,
    compression_ratio,
    decode_window,
    detect_language,
)
from .decoding_beam import decode_window_beam, decode_window_beam_batch, rank_beam_results
from .models.load import WhisperModel
from .models.whisper_torch import QuantizedWhisper
from .tokenizer import Tokenizer
from .utils import host_copy, stage_timer

logger = logging.getLogger(__name__)

INPUT_STRIDE = 2  # mel frames per output token position (conv2 stride)
TIME_PER_POSITION = INPUT_STRIDE * HOP_LENGTH / SAMPLE_RATE  # 0.02 s

def _lever(value: Optional[bool], env: str) -> bool:
    """An engine lever: ``value`` when given, else whether ``env`` is "1"
    (``engine.py:150-169`` of the JAX package)."""
    return os.environ.get(env) == "1" if value is None else bool(value)


@dataclass
class WindowDecodeResult:
    """Everything one window decode produced (per batch element). The
    alignment buffers are either on the host (``fetch_alignment=True``:
    ``attn`` (n_tokens, K, T_audio), ``ts_logprobs`` (n_tokens, 1501) and
    ``eot_attn``) or on the device (``attn_dev``, the whole batch's
    (B, max_new, K, T_audio) buffer, and ``ts_logprobs_dev``
    (B, max_new, 1501)); the other pair is None."""

    tokens: List[int]  # sampled tokens, EOT excluded
    text: str
    avg_logprob: float
    no_speech_prob: float
    temperature: float
    compression_ratio: float
    token_logprobs: np.ndarray  # (n_tokens,) logprob of each sampled token
    sum_logprob: float = 0.0  # over the sampled tokens and the final EOT
    hit_limit: bool = False  # decode reached max_new without EOT ("stuck LM")
    attn: Optional[np.ndarray] = None  # alignment-head scores of each sampled token
    ts_logprobs: Optional[np.ndarray] = None
    # the row that predicted the final EOT, when one was sampled (early-EOT
    # segments align <|endoftext|> with it)
    eot_attn: Optional[np.ndarray] = None  # (K, T_audio)
    attn_dev: Optional[Any] = None
    ts_logprobs_dev: Optional[Any] = None
    batch_index: int = 0
    n_text: int = 0  # sampled text tokens (row n_text predicts the final EOT)

    def ts_logprob_row(self, i: int) -> Optional[np.ndarray]:
        """Row i of the timestamp-logprob buffer, read from the device on
        demand when it stayed there (only the rare end<=start repair reads
        it)."""
        if self.ts_logprobs is not None:
            return self.ts_logprobs[i] if i < len(self.ts_logprobs) else None
        if self.ts_logprobs_dev is not None and i < self.ts_logprobs_dev.shape[1]:
            return self.ts_logprobs_dev[self.batch_index, i].cpu().numpy()
        return None


@dataclass
class Segment:
    """One transcription segment plus the alignment payload for its tokens."""

    id: int
    seek: int
    start: float
    end: float
    text: str
    tokens: List[int]
    temperature: float
    avg_logprob: float
    compression_ratio: float
    no_speech_prob: float
    token_span: Tuple[int, int] = (0, 0)  # [a, b) into the window's sampled tokens
    window: Optional[WindowDecodeResult] = None
    segment_frames: int = N_FRAMES  # actual content frames in this window

    def to_dict(self) -> Dict[str, Any]:
        return dict(
            id=self.id, seek=self.seek, start=self.start, end=self.end,
            text=self.text, tokens=list(self.tokens), temperature=self.temperature,
            avg_logprob=self.avg_logprob, compression_ratio=self.compression_ratio,
            no_speech_prob=self.no_speech_prob,
        )


class DecodeEngine:
    """Bound (model, tokenizer) with cached filter masks on the model's
    device.

    The KV-cache levers, each defaulting to its environment variable as in
    the JAX engine: ``kv_int8`` (``WTT_KV_INT8=1``) stores the encoder's
    cross K/V as int8 with per-frame scales, ``kv_int4`` (``WTT_KV_INT4``)
    as nibble-packed int4, winning over ``kv_int8``, and ``self_kv_int8``
    (``WTT_SELF_KV_INT8``) the self-attention cache as int8. The weight
    levers, each also defaulting to its variable: ``w_int8``
    (``WTT_W_INT8``) gives the decode step weight-only int8 copies of the
    decoder's linears and every logits projection an int8 vocabulary
    matrix, ``enc_int8`` (``WTT_ENC_INT8``) runs the encoder's linears
    W8A8. The engine builds the copies beside the caller's model
    (``self.model`` then holds a ``QuantizedWhisper``), whose module is not
    changed.

    ``mesh`` (``engine.py:131-136``, ``:247-272`` of the JAX package): a
    ("dp", "tp") ``DeviceMesh`` of ``parallel.mesh.get_mesh``; the engine
    shards the model (``attach_mesh``) and runs on this rank's heads. With
    a mesh the weight levers are turned off, with a warning, as in JAX. A
    ``mesh`` that is not such a mesh raises ``TypeError``."""

    def __init__(self, model: WhisperModel, tokenizer: Tokenizer, mesh=None,
                 kv_int8: Optional[bool] = None, kv_int4: Optional[bool] = None,
                 self_kv_int8: Optional[bool] = None, w_int8: Optional[bool] = None,
                 enc_int8: Optional[bool] = None):
        self.kv_int8 = _lever(kv_int8, "WTT_KV_INT8")
        self.kv_int4 = _lever(kv_int4, "WTT_KV_INT4")
        self.self_kv_int8 = _lever(self_kv_int8, "WTT_SELF_KV_INT8")
        self.w_int8 = _lever(w_int8, "WTT_W_INT8")
        self.enc_int8 = _lever(enc_int8, "WTT_ENC_INT8")
        self.mesh = None
        self.tp = 1
        if mesh is not None:
            from .parallel.mesh import check_mesh

            check_mesh(mesh)
            self._levers_off_for_mesh()
        if self.w_int8 or self.enc_int8:
            model = WhisperModel(
                module=QuantizedWhisper(model.module, w_int8=self.w_int8, enc_int8=self.enc_int8),
                alignment_heads=model.alignment_heads, model_name=model.model_name,
                tokenizer_ranks=model.tokenizer_ranks,
                tokenizer_multilingual=model.tokenizer_multilingual,
            )
        self.model = model
        self.tokenizer = tokenizer
        self.dims = model.dims
        heads = model.alignment_heads
        if not heads:
            # all heads of the top half of decoder layers (reference default)
            L, H = self.dims.n_text_layer, self.dims.n_text_head
            heads = [(l, h) for l in range(L // 2, L) for h in range(H)]
        self.align_heads: Tuple[Tuple[int, int], ...] = tuple(tuple(h) for h in heads)
        self._mask_cache: Dict[Any, Tuple[torch.Tensor, torch.Tensor]] = {}
        # the captured token loops and their buffers on the card: every
        # window decode of this engine (serial, batch, device flow,
        # fallback re-decode) replays them
        self.graphs = DecodeGraphs()
        if mesh is not None:
            self.attach_mesh(mesh)

    def _levers_off_for_mesh(self) -> None:
        if self.w_int8 or self.enc_int8:
            logger.warning("w_int8/enc_int8 are not supported together with a mesh "
                           "(no sharding rules for the quantized copies); disabling")
            self.w_int8 = False
            self.enc_int8 = False

    def attach_mesh(self, mesh) -> None:
        """Shard the model over ``mesh`` (``parallel.mesh.shard_params``:
        this rank's heads over ``tp``, replicated over ``dp``) and decode
        with it from now on; ``self.mesh`` and ``self.tp`` as in JAX. An
        engine built with the weight levers gives them up, with JAX's
        warning. The captured loops of the old module are dropped."""
        from .parallel.mesh import check_mesh, mesh_size, shard_params

        check_mesh(mesh)
        model = self.model
        if isinstance(model.module, QuantizedWhisper):
            self._levers_off_for_mesh()
            model = WhisperModel(
                module=model.module.source, alignment_heads=model.alignment_heads,
                model_name=model.model_name, tokenizer_ranks=model.tokenizer_ranks,
                tokenizer_multilingual=model.tokenizer_multilingual,
            )
        self.model = shard_params(model, mesh)
        self.mesh = mesh
        self.tp = mesh_size(mesh, "tp")
        self.graphs = DecodeGraphs()

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def kv_options(self) -> Dict[str, bool]:
        """The levers as ``decode_window`` takes them."""
        return dict(kv_int8=self.kv_int8, kv_int4=self.kv_int4, self_kv_int8=self.self_kv_int8)

    def _masks(self, options: DecodingOptions):
        key = (options.suppress_tokens if not isinstance(options.suppress_tokens, list)
               else tuple(options.suppress_tokens), options.suppress_blank)
        if key not in self._mask_cache:
            V = self.dims.n_vocab
            sm = torch.as_tensor(build_suppress_mask(self.tokenizer, options, V), device=self.device)
            bm = torch.as_tensor(build_blank_mask(self.tokenizer, V), device=self.device)
            self._mask_cache[key] = (sm, bm)
        return self._mask_cache[key]

    def build_prompt(
        self, prompt_tokens: Sequence[int], options: DecodingOptions,
        region: Optional[int] = None,
    ) -> Tuple[np.ndarray, int, int]:
        """Right-aligned prompt buffer: (buffer (P,), prompt_len,
        sot_index_from_end). P is the smallest static region that fits;
        ``region`` forces a size (a batch keeps all its rows uniform)."""
        tok = self.tokenizer
        sot_seq = [tok.sot]
        if tok.is_multilingual:
            sot_seq.append(tok.to_language_token(options.language or tok.language or "en"))
            sot_seq.append(tok.translate if options.task == "translate" else tok.transcribe)
        if options.without_timestamps:
            sot_seq.append(tok.no_timestamps)
        prefix = list(options.prefix or [])
        if options.sample_len:
            # whisper trims the prefix to n_ctx//2 - sample_len
            max_prefix = max(0, self.dims.n_text_ctx // 2 - options.sample_len)
            prefix = prefix[-max_prefix:] if max_prefix else []
        max_prefix = PROMPT_REGION - len(sot_seq) - 1
        prefix = prefix[-max_prefix:] if max_prefix > 0 else []
        budget = min(
            self.dims.n_text_ctx // 2 - 1,
            PROMPT_REGION - len(sot_seq) - len(prefix) - 1,
        )
        initial: List[int] = []
        if prompt_tokens:
            initial.append(tok.sot_prev)
            if budget > 0:
                initial.extend(list(prompt_tokens)[-budget:])
        initial.extend(sot_seq)
        initial.extend(prefix)
        if region is None:
            region = PROMPT_REGION_SMALL if len(initial) <= PROMPT_REGION_SMALL else PROMPT_REGION
        assert len(initial) <= region
        buf = np.full((region,), tok.eot, np.int32)
        buf[region - len(initial):] = initial
        sot_index_from_end = len(initial) - initial.index(tok.sot)
        return buf, len(initial), sot_index_from_end

    def decode_window(
        self,
        mel: torch.Tensor,  # (n_mels, 3000) or (B, n_mels, 3000)
        options: DecodingOptions,
        prompt_tokens: Sequence[int] = (),
        temperature: float = 0.0,
        rng_seed: int = 0,
        fetch_alignment: bool = True,
        capture_attention: bool = True,
    ) -> List[WindowDecodeResult]:
        """Decode of a window batch: greedy at temperature 0, else sampled
        with noise seeded by ``rng_seed`` (one (B, V) draw per step, so the
        rows sample independently)."""
        tok = self.tokenizer
        mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        if mel.ndim == 2:
            mel = mel[None]
        B = mel.shape[0]
        buf, plen, sot_from_end = self.build_prompt(prompt_tokens, options)
        prompt = torch.as_tensor(np.tile(buf[None], (B, 1)), device=self.device)
        prompt_len = torch.full((B,), plen, dtype=torch.int32, device=self.device)
        sm, bm = self._masks(options)
        max_init_ts = (
            round(options.max_initial_timestamp / TIME_PER_POSITION)
            if options.max_initial_timestamp is not None
            else None
        )
        out = decode_window(
            self.model.module, mel, prompt, prompt_len, sm, bm,
            align_heads=self.align_heads,
            eot=tok.eot,
            ts_begin=tok.timestamp_begin,
            no_timestamps=tok.no_timestamps,
            sot_index_from_end=sot_from_end,
            max_initial_timestamp_index=max_init_ts,
            max_new=options.sample_len or MAX_NEW_TOKENS,
            suppress_blank=options.suppress_blank,
            without_timestamps=options.without_timestamps,
            temperature=float(temperature),
            rng_seed=rng_seed,
            capture_attention=capture_attention,
            graphs=self.graphs,
            **self.kv_options,
        )
        return self.unpack_window_outputs(out, temperature,
                                          fetch_alignment=fetch_alignment and capture_attention)

    def unpack_window_outputs(self, out, temperature,
                              fetch_alignment: bool = True) -> List[WindowDecodeResult]:
        """Device buffers -> per-row results (``engine.py:407``): the token
        ids, log-probs and scalars cross to the host; the alignment buffers
        too with ``fetch_alignment``, else they stay on the device."""
        small = [out[k].cpu().numpy()
                 for k in ("tokens", "token_logprobs", "sum_logprobs", "no_speech_prob")]
        return self.build_window_results(*small, out, temperature, fetch_alignment=fetch_alignment)

    def build_window_results(
        self,
        tokens_all: np.ndarray,  # (B, M) int32, on the host
        logprobs_all: np.ndarray,  # (B, M) f32
        sum_lp: np.ndarray,  # (B,)
        nsp: np.ndarray,  # (B,)
        out,  # the device output dict (alignment buffers)
        temperature,
        fetch_alignment: bool = True,
    ) -> List[WindowDecodeResult]:
        """Host-array half of ``unpack_window_outputs`` (``engine.py:429``):
        the batch pipeline's device flow lands the small outputs in one
        packed read and builds the results here. ``fetch_alignment`` copies
        the timestamp log-probs and the attention to the host, one pinned
        copy per buffer for the whole batch (stage ``alignment_fetch``)."""
        tok = self.tokenizer
        if fetch_alignment:
            with stage_timer("alignment_fetch"):
                waits = [host_copy(out["ts_logprobs"]), host_copy(out["attn"])]
                ts_lp_all, attn_all = (wait() for wait in waits)
        results = []
        for b in range(tokens_all.shape[0]):
            toks = tokens_all[b]
            eot_pos = np.nonzero(toks == tok.eot)[0]
            hit_limit = len(eot_pos) == 0
            n_text = int(eot_pos[0]) if len(eot_pos) else len(toks)
            text_tokens = toks[:n_text].tolist()
            text = tok.decode(text_tokens)
            results.append(
                WindowDecodeResult(
                    tokens=text_tokens,
                    text=text,
                    # whisper avg_logprob: sum over sampled (incl. final EOT) / (len+1)
                    avg_logprob=float(sum_lp[b]) / (n_text + 1),
                    no_speech_prob=float(nsp[b]),
                    temperature=float(temperature),
                    compression_ratio=compression_ratio(text),
                    token_logprobs=logprobs_all[b, :n_text],
                    sum_logprob=float(sum_lp[b]),
                    hit_limit=hit_limit,
                    attn=attn_all[b, :n_text] if fetch_alignment else None,
                    ts_logprobs=ts_lp_all[b, :n_text] if fetch_alignment else None,
                    eot_attn=attn_all[b, n_text] if fetch_alignment and not hit_limit else None,
                    attn_dev=None if fetch_alignment else out["attn"],
                    ts_logprobs_dev=None if fetch_alignment else out["ts_logprobs"],
                    batch_index=b,
                    n_text=n_text,
                )
            )
        return results

    def _beam_kwargs(self, options: DecodingOptions, sot_from_end: int) -> Dict[str, Any]:
        """The static arguments of a beam decode (``engine.py:497-545``):
        ``max_candidates`` = round(K * patience), at least 1, and the
        cross K/V in int8 only for ``kv_int8`` without ``kv_int4``."""
        tok = self.tokenizer
        K = options.beam_size
        patience = options.patience if options.patience is not None else 1.0
        return dict(
            beam_size=K,
            max_candidates=max(1, round(K * patience)),
            max_new=options.sample_len or MAX_NEW_TOKENS,
            eot=tok.eot,
            ts_begin=tok.timestamp_begin,
            no_timestamps=tok.no_timestamps,
            sot_index_from_end=sot_from_end,
            max_initial_timestamp_index=(
                round(options.max_initial_timestamp / TIME_PER_POSITION)
                if options.max_initial_timestamp is not None else None),
            suppress_blank=options.suppress_blank,
            without_timestamps=options.without_timestamps,
            kv_int8=self.kv_int8 and not self.kv_int4,
            graphs=self.graphs,
        )

    def _beam_result(self, row: Dict[str, np.ndarray], options: DecodingOptions,
                     batch_index: int = 0) -> WindowDecodeResult:
        """One window's ranked beam result: no per-token log-probs and no
        attention (the two-pass engine's second pass aligns), temperature
        0, ``hit_limit`` when the budget ran out with nothing finished."""
        tok = self.tokenizer
        tokens, sum_lp = rank_beam_results(row, tok.eot, options.length_penalty)
        text = tok.decode(tokens)
        return WindowDecodeResult(
            tokens=tokens,
            text=text,
            avg_logprob=float(sum_lp) / (len(tokens) + 1),
            no_speech_prob=float(row["no_speech_prob"]),
            temperature=0.0,
            compression_ratio=compression_ratio(text),
            token_logprobs=np.zeros(len(tokens), np.float32),
            attn=np.zeros((0,)),
            sum_logprob=float(sum_lp),
            hit_limit=int(row["n_steps"]) >= (options.sample_len or MAX_NEW_TOKENS)
            and int(row["n_finished"]) == 0,
            batch_index=batch_index,
            n_text=len(tokens),
        )

    def decode_window_beam(
        self,
        mel: torch.Tensor,  # (n_mels, 3000)
        options: DecodingOptions,
        prompt_tokens: Sequence[int] = (),
    ) -> WindowDecodeResult:
        """Beam-search decode of one window (``engine.py:482``), in the full
        prompt region, with no attention capture."""
        mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        if mel.ndim == 2:
            mel = mel[None]
        assert mel.shape[0] == 1, "beam decode is per-window (B=1)"
        buf, plen, sot_from_end = self.build_prompt(prompt_tokens, options, region=PROMPT_REGION)
        sm, bm = self._masks(options)
        out = decode_window_beam(
            self.model.module, mel, torch.as_tensor(buf, device=self.device),
            torch.tensor(plen, dtype=torch.int32, device=self.device), sm, bm,
            **self._beam_kwargs(options, sot_from_end))
        return self._beam_result({k: v.cpu().numpy() for k, v in out.items()}, options)

    def decode_window_beam_batch(
        self,
        mels: torch.Tensor,  # (B, n_mels, 3000)
        options: DecodingOptions,
        prompts: Sequence[Sequence[int]],
        languages: Optional[Sequence[Optional[str]]] = None,
    ) -> List[WindowDecodeResult]:
        """Beam-search decode of B windows in one loop (``engine.py:555``),
        the batch pipeline's first pass for ``beam_size``. Rows may differ
        in prompt and language; all share the full prompt region."""
        mels = torch.as_tensor(mels, dtype=torch.float32, device=self.device)
        B = mels.shape[0]
        bufs, lens, sot_from_end = [], [], None
        for i in range(B):
            buf, plen, sot_from_end = self.build_prompt(
                list(prompts[i]) if i < len(prompts) else [], row_options(options, languages, i),
                region=PROMPT_REGION)
            bufs.append(buf)
            lens.append(plen)
        sm, bm = self._masks(options)
        out = decode_window_beam_batch(
            self.model.module, mels, torch.as_tensor(np.stack(bufs), device=self.device),
            torch.as_tensor(np.asarray(lens, np.int32), device=self.device), sm, bm,
            **self._beam_kwargs(options, sot_from_end))
        host = {k: v.cpu().numpy() for k, v in out.items()}
        return [self._beam_result({k: v[b] for k, v in host.items()}, options, batch_index=b)
                for b in range(B)]

    def decode_window_best_of(
        self,
        mel: torch.Tensor,
        options: DecodingOptions,
        prompt_tokens: Sequence[int],
        temperature: float,
        rng_seed: int,
        fetch_alignment: bool = True,
        capture_attention: bool = True,
    ) -> WindowDecodeResult:
        """best_of sampling (``engine.py:645``): the window repeated
        ``best_of`` times as one batch, so each row draws its own sample;
        the best ``sequence_score`` wins (whisper's GreedyDecoder and
        MaximumLikelihoodRanker)."""
        n = options.best_of or 1
        mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        if mel.ndim == 2:
            mel = mel[None]
        results = self.decode_window(
            mel.repeat_interleave(n, dim=0), options, prompt_tokens, temperature=temperature,
            rng_seed=rng_seed, fetch_alignment=fetch_alignment,
            capture_attention=capture_attention,
        )
        return max(results, key=lambda r: sequence_score(r, options.length_penalty))

    def decode_with_fallback(
        self,
        mel: torch.Tensor,
        options: DecodingOptions,
        prompt_tokens: Sequence[int],
        temperatures: Sequence[float],
        compression_ratio_threshold: Optional[float],
        logprob_threshold: Optional[float],
        no_speech_threshold: Optional[float],
        rng_seed: int = 0,
        fetch_alignment: bool = True,
        capture_attention: bool = True,
    ) -> WindowDecodeResult:
        """whisper's decode_with_fallback (``engine.py:671``): each
        temperature in turn until the result passes the thresholds; above 0
        with ``best_of`` > 1 the best of that many samples. Every
        temperature samples with the same ``rng_seed``."""
        result = None
        for t in temperatures:
            if t == 0 and options.beam_size:
                result = self.decode_window_beam(mel, options, prompt_tokens)
            elif t > 0 and (options.best_of or 0) > 1:
                result = self.decode_window_best_of(
                    mel, options, prompt_tokens, float(t), rng_seed,
                    fetch_alignment=fetch_alignment, capture_attention=capture_attention,
                )
                result.temperature = float(t)
            else:
                result = self.decode_window(
                    mel, options, prompt_tokens, temperature=float(t), rng_seed=rng_seed,
                    fetch_alignment=fetch_alignment, capture_attention=capture_attention,
                )[0]
            if not needs_fallback(result, compression_ratio_threshold, logprob_threshold,
                                  no_speech_threshold):
                break
        return result


def row_options(options: DecodingOptions, languages: Optional[Sequence[Optional[str]]],
                i: int) -> DecodingOptions:
    """Row ``i``'s options in a batch: its own language where ``languages``
    gives one that differs."""
    lang = languages[i] if languages else None
    if lang is None or lang == options.language:
        return options
    return DecodingOptions(**{**options.__dict__, "language": lang})


def sequence_score(result: WindowDecodeResult, length_penalty: Optional[float]) -> float:
    """whisper's MaximumLikelihoodRanker (``engine.py:714``): the sum
    log-prob over the length, or over the GNMT length penalty when one is
    set. The serial and batched best_of both rank by it."""
    length = len(result.tokens)
    if length_penalty is None:
        return result.sum_logprob / max(length, 1)
    return result.sum_logprob / (((5.0 + length) / 6.0) ** length_penalty)


def needs_fallback(
    result: WindowDecodeResult,
    compression_ratio_threshold: Optional[float],
    logprob_threshold: Optional[float],
    no_speech_threshold: Optional[float],
) -> bool:
    """whisper's retry predicate (``engine.py:724``, shared by the serial
    and batched pipelines): too repetitive or too unsure retries at the
    next temperature, unless the window is silence."""
    nf = False
    if (compression_ratio_threshold is not None
            and result.compression_ratio > compression_ratio_threshold):
        nf = True
    if logprob_threshold is not None and result.avg_logprob < logprob_threshold:
        nf = True
    if no_speech_threshold is not None and result.no_speech_prob > no_speech_threshold:
        nf = False
    return nf


# ---------------------------------------------------------------------------
# The sliding-window loop
# ---------------------------------------------------------------------------


@dataclass
class TranscribeResult:
    text: str
    segments: List[Segment]
    language: Optional[str]
    language_probs: Optional[dict] = None


def transcribe_windows(
    engine: DecodeEngine,
    audio: np.ndarray,  # 16 kHz float32
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
    return_language_probs: bool = False,
    verbose_callback=None,
    rng_seed: int = 0,
    fetch_alignment: bool = True,
    capture_attention: bool = True,
) -> TranscribeResult:
    """whisper-semantics long-form loop, emitting alignment-ready segments."""
    tok = engine.tokenizer
    dims = engine.dims
    if isinstance(temperature, (int, float)):
        temperature = [float(temperature)]

    with stage_timer("mel"):
        # on the model's device; PCM-grid audio ships as int16 (lossless)
        audio_np = np.asarray(audio, np.float32)
        pcm16 = as_pcm16(audio_np)
        mel_full = log_mel_spectrogram(
            pcm16 if pcm16 is not None else audio_np,
            n_mels=dims.n_mels, padding=N_SAMPLES, device=engine.device,
        )
    content_frames = mel_full.shape[-1] - N_FRAMES

    def window(seek: int) -> torch.Tensor:
        w = mel_full[:, seek : seek + N_FRAMES]
        if w.shape[-1] < N_FRAMES:
            w = torch.nn.functional.pad(w, (0, N_FRAMES - w.shape[-1]))
        return w

    language_probs = None
    if language is None:
        if tok.is_multilingual:
            if verbose_callback is not None:
                print(
                    "Detecting language using up to the first 30 seconds. "
                    "Use `--language` to specify the language"
                )
            codes, probs = detect_language(engine.model.module, window(0)[None], tok)
            language, language_probs = codes[0], probs[0]
        else:
            language = "en"
    elif return_language_probs and tok.is_multilingual:
        _, probs = detect_language(engine.model.module, window(0)[None], tok)
        language_probs = probs[0]

    base_opts = decode_options or DecodingOptions()
    base_opts = DecodingOptions(**{**base_opts.__dict__, "task": task, "language": language})

    all_tokens: List[int] = []
    if initial_prompt is not None:
        all_tokens.extend(tok.encode(" " + initial_prompt.strip()))
    prompt_reset_since = 0

    segments: List[Segment] = []
    seek = 0
    while seek < content_frames:
        segment_size = min(N_FRAMES, content_frames - seek)
        with stage_timer("decode"):
            result = engine.decode_with_fallback(
                window(seek), base_opts, all_tokens[prompt_reset_since:], temperature,
                compression_ratio_threshold, logprob_threshold, no_speech_threshold,
                rng_seed=rng_seed + seek, fetch_alignment=fetch_alignment,
                capture_attention=capture_attention,
            )
        window_segments, seek = extract_window_segments(
            result, seek, segment_size, tok, no_speech_threshold, logprob_threshold
        )
        for seg in window_segments:
            seg.id = len(segments)
            segments.append(seg)
            if verbose_callback is not None:
                verbose_callback(seg)
            all_tokens.extend(seg.tokens)
        if not condition_on_previous_text or result.temperature > 0.5:
            prompt_reset_since = len(all_tokens)

    text = "".join(s.text for s in segments)
    return TranscribeResult(text=text, segments=segments, language=language,
                            language_probs=language_probs)


def extract_window_segments(
    result: WindowDecodeResult,
    seek: int,
    segment_size: int,
    tok: Tokenizer,
    no_speech_threshold: Optional[float],
    logprob_threshold: Optional[float],
) -> Tuple[List[Segment], int]:
    """Timestamp-token segmentation + seek advance for one decoded window
    (whisper's transcribe-loop semantics). Returns (segments, new_seek)."""
    time_offset = seek * HOP_LENGTH / SAMPLE_RATE
    segment_duration = segment_size * HOP_LENGTH / SAMPLE_RATE

    if no_speech_threshold is not None:
        should_skip = result.no_speech_prob > no_speech_threshold
        if logprob_threshold is not None and result.avg_logprob > logprob_threshold:
            should_skip = False
        if should_skip:
            return [], seek + segment_size

    tokens = np.array(result.tokens)
    ts_begin = tok.timestamp_begin
    timestamp_mask = tokens >= ts_begin
    single_timestamp_ending = (
        len(tokens) >= 2 and not timestamp_mask[-2] and timestamp_mask[-1]
    )
    consecutive = (
        np.where(timestamp_mask[:-1] & timestamp_mask[1:])[0] + 1
        if len(tokens) >= 2
        else np.array([], int)
    )

    def new_segment(start, end, seg_tokens, span):
        text_tokens = [t for t in seg_tokens if t < tok.eot]
        return Segment(
            id=-1, seek=int(seek), start=float(start), end=float(end),
            text=tok.decode(text_tokens), tokens=seg_tokens,
            temperature=result.temperature, avg_logprob=result.avg_logprob,
            compression_ratio=result.compression_ratio,
            no_speech_prob=result.no_speech_prob, token_span=tuple(span),
            window=result, segment_frames=segment_size,
        )

    window_segments: List[Segment] = []
    if len(consecutive) > 0:
        slices = consecutive.tolist()
        if single_timestamp_ending:
            slices.append(len(tokens))
        last_slice = 0
        for current_slice in slices:
            sliced = tokens[last_slice:current_slice]
            start_pos = int(sliced[0]) - ts_begin
            end_pos = int(sliced[-1]) - ts_begin
            window_segments.append(new_segment(
                time_offset + start_pos * TIME_PER_POSITION,
                time_offset + end_pos * TIME_PER_POSITION,
                sliced.tolist(), (last_slice, current_slice),
            ))
            last_slice = current_slice
        if single_timestamp_ending:
            seek += segment_size
        else:
            last_timestamp_pos = int(tokens[last_slice - 1]) - ts_begin
            seek += last_timestamp_pos * INPUT_STRIDE
    else:
        duration = segment_duration
        timestamps = tokens[timestamp_mask]
        if len(timestamps) > 0 and int(timestamps[-1]) != ts_begin:
            duration = (int(timestamps[-1]) - ts_begin) * TIME_PER_POSITION
        window_segments.append(new_segment(
            time_offset, time_offset + duration, tokens.tolist(), (0, len(tokens)),
        ))
        seek += segment_size
    return window_segments, seek
