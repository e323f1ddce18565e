"""The adapter to the system under test, ``whisper_timestamped_tpu_torch``:
its model built around the benchmark's weights, its tokenizer over the
synthetic vocabulary, its engine with the cell's levers, the options of a
request, and what the benchmark observes of it.

Observed in every run: each decoded window's stream, seek, tokens and
their log-probabilities, as the serving loop's window bookkeeping
(``BatchTranscriber._apply_window_results``) receives them; for the
streams the check samples, the alignment rows and what the device aligner
made of them (``Observer``); and the program's own stage timers and
counters (``utils.profiling``). Observed only with the trace
on: a ``torch.profiler`` range around each program stage, the encoder's
device time by CUDA events around ``encode``, and the shapes of the
``flash_attention`` calls."""

from __future__ import annotations

import collections
import contextlib
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

PKG = "whisper_timestamped_tpu_torch"


def build_model(config: dict, weights: Dict[str, Dict[str, torch.Tensor]]):
    from whisper_timestamped_tpu_torch.models import WhisperDims, WhisperModel
    from whisper_timestamped_tpu_torch.models.whisper_torch import WhisperTorch

    d = config["dims"]
    dims = WhisperDims(**{k: d[k] for k in ("n_mels", "n_audio_ctx", "n_audio_state",
                                            "n_audio_head", "n_audio_layer", "n_vocab",
                                            "n_text_ctx", "n_text_state", "n_text_head",
                                            "n_text_layer")})
    module = WhisperTorch(dims, dtype=torch.bfloat16, device="meta",
                          n_mlp=(d["n_audio_ffn"], d["n_text_ffn"]))
    for part in ("encoder", "decoder"):
        pd, given = getattr(module, part), weights[part]
        if set(pd.keys()) != set(given):
            raise SystemExit(f"portbench: the system's {part} parameters {sorted(pd.keys())} are "
                             f"not the benchmark's {sorted(given)}")
        for name in list(pd.keys()):
            if tuple(pd[name].shape) != tuple(given[name].shape):
                raise SystemExit(f"portbench: {part}.{name}: the system expects "
                                 f"{tuple(pd[name].shape)}, the benchmark made {tuple(given[name].shape)}")
            pd[name] = torch.nn.Parameter(given[name], requires_grad=False)
    module.fixed_pos_emb = True
    return WhisperModel(module=module, alignment_heads=[tuple(h) for h in config["alignment_heads"]])


def build_tokenizer(config: dict):
    """The synthetic full-size vocabulary: 256 bytes and a few merges,
    padding ranks up to the 50257 text tokens, then the special tokens."""
    from whisper_timestamped_tpu_torch.tokenizer import BytePairEncoder, Tokenizer, synthetic_ranks

    voc = config["vocabulary"]
    ranks = synthetic_ranks()
    for i in range(voc["eot"] - len(ranks)):
        ranks[b"\x00" + str(i).encode()] = len(ranks)
    tok = Tokenizer(bpe=BytePairEncoder(ranks), multilingual=True,
                    num_languages=voc["num_languages"], language="en", task="transcribe")
    have = {"eot": tok.eot, "sot": tok.sot, "language_en": tok.to_language_token("en"),
            "translate": tok.translate, "transcribe": tok.transcribe, "sot_lm": tok.sot_lm,
            "sot_prev": tok.sot_prev, "no_speech": tok.no_speech,
            "no_timestamps": tok.no_timestamps, "timestamp_begin": tok.timestamp_begin,
            "blank": list(tok.encode(" "))[0], "n_vocab": tok.n_vocab}
    want = {k: (voc[k] if k != "n_vocab" else config["dims"]["n_vocab"]) for k in have}
    if have != want:
        raise SystemExit(f"portbench: the system's vocabulary {have} is not the configuration's {want}")
    return tok


def engine_levers(levers: dict) -> Dict[str, bool]:
    """Every lever of the engine, off unless the cell turns it on: none is
    left to the environment."""
    unknown = set(levers) - set(LEVERS)
    if unknown:
        raise SystemExit(f"portbench: unknown engine levers {sorted(unknown)}")
    return {k: bool(levers.get(k, False)) for k in LEVERS}


def build_engine(model, tok, levers: dict):
    from whisper_timestamped_tpu_torch.engine import DecodeEngine

    return DecodeEngine(model, tok, **engine_levers(levers))


def request_options(spec: dict, config: dict, sample_len: int) -> dict:
    """What every request asks: greedy at temperature 0, English, EOT and
    the task tokens suppressed (random weights never stop by themselves),
    the quality thresholds off, a fixed number of tokens a window, words
    aligned on the device."""
    from whisper_timestamped_tpu_torch.decoding import DecodingOptions

    suppress = ",".join(str(t) for t in config["request"]["suppress_tokens"])
    return dict(batch_size=spec["batch_size"], temperature=[0.0], language="en",
                no_speech_threshold=None, logprob_threshold=None,
                compression_ratio_threshold=None,
                condition_on_previous_text=spec["condition_on_previous_text"],
                device_alignment=True,
                decode_options=DecodingOptions(
                    language="en", suppress_tokens=suppress, sample_len=sample_len,
                    max_initial_timestamp=config["request"]["max_initial_timestamp_s"]))


def transcribe_stream(model, batches, tok, engine, options: dict):
    from whisper_timestamped_tpu_torch import transcribe_batch_stream

    return transcribe_batch_stream(model, batches, tok, engine=engine, **options)


LEVERS = ("kv_int8", "kv_int4", "self_kv_int8", "w_int8", "enc_int8")


class Observer:
    """What the benchmark reads of the program during a run. The hooks are
    put in once a process and report to the newest observer.

    ``watch`` names the streams whose alignment the check judges: for
    their windows the observer keeps a copy, on the device, of the
    alignment heads' score rows as the decode wrote them, and of every
    segment the device aligner (``device_align._align_jumps``) ran on
    them: its rows, its (tokens, span, max-duration column, start frame),
    the token start frames it found and its cost."""

    current = None

    def __init__(self, watch=()):
        # (stream, seek, tokens, each token's log-probability as the program gives it)
        self.windows: List[Tuple[str, int, List[int], List[float]]] = []
        self.watch = set(watch)
        self.rows: Dict[Tuple[str, int], torch.Tensor] = {}  # (stream, seek) -> (n, K, T)
        self.segments: List[dict] = []
        self._buffers: Dict[Tuple[int, int], Tuple[str, int, int]] = {}
        _install_hooks()
        Observer.current = self

    def on_window(self, streams, results) -> None:
        # a buffer freed since may have left its address to this window's
        fresh = {r.attn_dev.data_ptr() for r in results if r.attn_dev is not None}
        self._buffers = {k: v for k, v in self._buffers.items() if k[0] not in fresh}
        for s, r in zip(streams, results):
            self.windows.append((s.name, int(s.seek), [int(t) for t in r.tokens],
                                 [float(x) for x in r.token_logprobs]))
            buf = r.attn_dev
            if s.name in self.watch and buf is not None:
                max_new = buf.shape[1]
                self.rows[(s.name, int(s.seek))] = buf[r.batch_index,
                                                       : min(len(r.tokens) + 1, max_new)].clone()
                self._buffers[(buf.data_ptr(), r.batch_index)] = (s.name, int(s.seek), max_new)

    def on_align(self, attn_flat, rows, dims, starts, cost) -> None:
        ptr = attn_flat.data_ptr()
        for s in range(rows.shape[0]):
            if rows.shape[1] > 1 and rows[s, 0] == rows[s, 1]:
                continue  # padding: a real segment's token rows differ
            for (p, b), (name, seek, max_new) in self._buffers.items():
                if p != ptr or int(rows[s, 0]) // max_new != b:
                    continue
                n, span = int(dims[s, 0]), int(dims[s, 1])
                self.segments.append(dict(
                    stream=name, seek=seek, rows=np.asarray(rows[s, :n]) - b * max_new,
                    dims=[int(x) for x in dims[s]], starts=starts[s, :n].clone(),
                    cost=cost[s, :n, :span].clone()))

    def to_host(self) -> None:
        """The kept copies to the host, once the window has closed."""
        self.rows = {k: v.cpu() for k, v in self.rows.items()}
        for seg in self.segments:
            seg["starts"] = seg["starts"].cpu().numpy().astype(np.int64)
            seg["cost"] = seg["cost"].cpu()

    @staticmethod
    def reset_counters() -> None:
        from whisper_timestamped_tpu_torch.ops import kernels
        from whisper_timestamped_tpu_torch.utils import reset_stage_timings

        reset_stage_timings()
        kernels.reset_launches()

    @staticmethod
    def counters() -> Tuple[dict, dict, dict]:
        from whisper_timestamped_tpu_torch.ops import kernels
        from whisper_timestamped_tpu_torch.utils import get_counts, get_stage_timings

        return get_stage_timings(), get_counts(), dict(kernels.LAUNCHES)


def _install_hooks() -> None:
    """Wrap the serving loop's window bookkeeping and the device aligner,
    once a process, to report to ``Observer.current``."""
    from whisper_timestamped_tpu_torch import device_align
    from whisper_timestamped_tpu_torch.parallel import batch as batch_mod

    cls = batch_mod.BatchTranscriber
    if getattr(cls._apply_window_results, "portbench", False):
        return
    apply_results, align = cls._apply_window_results, device_align._align_jumps

    def observed(self_, streams, results, *args, **kwargs):
        Observer.current.on_window(streams, results)
        return apply_results(self_, streams, results, *args, **kwargs)

    def observed_align(attn_flat, rows, dims):
        starts, cost = align(attn_flat, rows, dims)
        Observer.current.on_align(attn_flat, rows, dims, starts, cost)
        return starts, cost

    observed.portbench = True
    cls._apply_window_results = observed
    device_align._align_jumps = observed_align


class Spans:
    """With the trace on: profiler ranges around the program's stages, CUDA
    events around the encoder, and the ``flash_attention`` calls by shape,
    recorded while ``active``."""

    def __init__(self):
        import whisper_timestamped_tpu_torch.decoding as dec
        import whisper_timestamped_tpu_torch.models.whisper_torch as wt
        from whisper_timestamped_tpu_torch.utils import profiling

        self.active = False
        self.encoder_events: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self.flash_calls: Dict[tuple, int] = collections.Counter()
        spans = self

        original_timer = profiling.stage_timer

        @contextlib.contextmanager
        def stage_timer(name):
            if not spans.active:
                with original_timer(name):
                    yield
                return
            with torch.profiler.record_function(f"pb:{name}"), original_timer(name):
                yield

        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith(PKG) and \
                    getattr(mod, "stage_timer", None) is original_timer:
                mod.stage_timer = stage_timer

        encode = dec.encode

        def timed_encode(model, mel):
            if not spans.active:
                return encode(model, mel)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            with torch.profiler.record_function("pb:encoder"):
                out = encode(model, mel)
            end.record()
            spans.encoder_events.append((start, end))
            return out

        dec.encode = timed_encode

        flash = wt.flash_attention

        def counted_flash(q, k, v, n_head, *, causal=False, pad_len=None):
            if spans.active:
                spans.flash_calls[(q.shape[0], q.shape[1], k.shape[1], q.shape[2], n_head,
                                   bool(causal))] += 1
            return flash(q, k, v, n_head, causal=causal, pad_len=pad_len)

        wt.flash_attention = counted_flash

    def encoder_ms(self) -> List[float]:
        return [s.elapsed_time(e) for s, e in self.encoder_events]
