"""Voice-activity detection: speech extraction and timestamp back-mapping.

Copy of ``whisper_timestamped_tpu/vad.py`` (numpy only), with the port's
silero module. The detectors:

  * ``"auditok"`` / ``"energy"``: an auditok-style energy splitter in numpy
    (no ``auditok`` package), on the host;
  * ``"silero"`` (and ``"silero:vX.Y"``): the silero VAD network as a torch
    module on ``device`` (``models/silero.py``), from locally cached ``.jit``
    or ``.onnx`` weights (``SILERO_VAD_PATH``, else the torch hub cache;
    nothing is downloaded). ``device`` defaults to the CUDA card and raises
    without one, as ``load_model`` does; only this route reads it;
  * explicit ``[(start, end), ...]`` second pairs, on the host.

Segment dilation and merge and the piecewise timestamp back-conversion are
the JAX package's.
"""

from __future__ import annotations

import ast
import logging
import os
from typing import Callable, List, Optional, Tuple, Union

import numpy as np

from .audio import SAMPLE_RATE

logger = logging.getLogger("whisper_timestamped_tpu_torch")


_VAD_TRUTHY = (True, "True", "true")
_VAD_FALSEY = (None, False, "False", "false", "None", "none")
_VAD_DETECTORS = ("auditok", "energy")


def _silero_version_of(spec: str) -> Optional[str]:
    """``"silero"`` → None; ``"silero:3.1"``/``"silero:v3.1"`` → ``"v3.1"``."""
    name, colon, suffix = spec.partition(":")
    if name != "silero" or (colon and not suffix):
        raise ValueError(f"Got unexpected VAD method {spec}")
    if not colon:
        return None
    tag = suffix if suffix.startswith("v") else "v" + suffix
    try:
        numeric_ok = float(tag[1:]) >= 1
    except ValueError:
        numeric_ok = False
    if not numeric_ok:
        raise ValueError(f"Got unexpected silero version {tag}")
    return tag


def _as_span_pair(item) -> tuple:
    pair = tuple(item)
    assert len(pair) == 2, (
        f"Got unexpected element {item} in the list of VAD segments. "
        "Expect (start, end) pairs"
    )
    return pair


def check_vad_method(method, with_version: bool = False):
    """Normalize the ``vad`` option (True→silero, strings, explicit pairs)."""
    if method in _VAD_TRUTHY:
        method = "silero"
    if method in _VAD_FALSEY:
        return None

    if isinstance(method, str):
        if method in _VAD_DETECTORS:
            return method
        if method.split(":", 1)[0] == "silero":
            version = _silero_version_of(method)
            return ("silero", version) if with_version else method
        # a stringified list of (start, end) pairs, e.g. from the CLI
        try:
            method = ast.literal_eval(method)
        except (ValueError, SyntaxError):
            raise ValueError(f"Got unexpected VAD method {method}")

    if hasattr(method, "__iter__"):
        return [_as_span_pair(span) for span in method]
    raise ValueError(f"Got unexpected VAD method {method}")


def normalize_gain(audio):
    """Volume normalization with gain capped at 10x (the reference applies
    the same expression before silero and auditok, transcribe.py:2016-2029);
    silent audio passes through unscaled."""
    peak = float(np.abs(audio).max()) if getattr(audio, "size", len(audio)) else 0.0
    return audio / max(0.1, peak if peak > 0 else 1.0)


# ---------------------------------------------------------------------------
# Energy VAD (auditok-equivalent)
# ---------------------------------------------------------------------------


def _energy_split(
    audio: np.ndarray,
    sample_rate: int,
    min_speech_duration: float,
    min_silence_duration: float,
    energy_threshold_db: float = 50.0,
    analysis_window: float = 0.05,
) -> List[dict]:
    """auditok-style splitter: frames are speech when their log-energy (dB re
    int16 LSB) exceeds the threshold; bounded silence inside a region.

    Fully vectorized (run-length detection + gap merge) — no per-frame host
    loop, so hour-scale multi-stream VAD stays cheap. Trailing silence is
    dropped (auditok's ``drop_trailing_silence=True``): runs end at the
    frame after the last active one.
    """
    win = max(1, int(analysis_window * sample_rate))
    n = len(audio) // win
    if n == 0:
        return []
    audio = normalize_gain(audio)
    frames = audio[: n * win].reshape(n, win).astype(np.float64) * 32767.0
    energy = 20.0 * np.log10(np.sqrt(np.mean(frames**2, axis=-1)) + 1e-10)
    active = energy >= energy_threshold_db
    if not active.any():
        return []

    audio_duration = len(audio) / sample_rate
    max_silence = min(audio_duration * 0.95, min_silence_duration)
    max_silence_frames = max(1, int(round(max_silence / analysis_window)))
    min_speech_frames = max(1, int(round(min_speech_duration / analysis_window)))

    flips = np.diff(active.astype(np.int8))
    starts = np.flatnonzero(flips == 1) + 1
    ends = np.flatnonzero(flips == -1) + 1  # exclusive
    if active[0]:
        starts = np.r_[0, starts]
    if active[-1]:
        ends = np.r_[ends, n]

    # merge active runs whose silence gap fits within max_silence_frames
    # (a region only closes when the in-region silence EXCEEDS the bound)
    merged: List[Tuple[int, int]] = [(int(starts[0]), int(ends[0]))]
    for s, e in zip(starts[1:].tolist(), ends[1:].tolist()):
        if s - merged[-1][1] <= max_silence_frames:
            merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))

    return [
        {"start": s * win, "end": min(e * win, len(audio))}
        for s, e in merged
        if e - s >= min_speech_frames
    ]


# ---------------------------------------------------------------------------
# Silero VAD (a torch module; weights from the local cache only)
# ---------------------------------------------------------------------------


def _find_local_silero(version: Optional[str]) -> Optional[str]:
    """Locate a locally cached silero-vad jit/onnx model (no downloads).

    With ``version`` (e.g. "v3.1"), a cache directory carrying that version in
    its name (torch.hub layout: ``snakers4_silero-vad_v3.1``) is required —
    silently loading a different version would change segmentation. ``.jit``
    models are preferred over ``.onnx`` (the torchscript adapter is the
    supported path)."""
    env = os.environ.get("SILERO_VAD_PATH")
    if env and os.path.exists(env):
        return env
    candidates = []
    hub = os.path.join(os.path.expanduser("~"), ".cache", "torch", "hub")
    if os.path.isdir(hub):
        for root, _, files in os.walk(hub):
            for f in files:
                if f in ("silero_vad.jit", "silero_vad.onnx") or (
                    f.startswith("silero_vad") and f.endswith((".jit", ".onnx"))
                ):
                    candidates.append(os.path.join(root, f))
    if version is not None:
        candidates = [p for p in candidates if version in os.path.dirname(p)]
    # prefer .jit, then shortest (most canonical) path
    candidates.sort(key=lambda p: (not p.endswith(".jit"), len(p)))
    return candidates[0] if candidates else None


def _silero_speech_segments(audio, sample_rate, min_speech_duration, min_silence_duration,
                            version=None, device=None):
    path = _find_local_silero(version)
    if path is None:
        raise FileNotFoundError(
            "No local silero-vad weights found (set SILERO_VAD_PATH or place "
            "silero_vad.jit / silero_vad.onnx under ~/.cache/torch/hub). This "
            "framework does not download models; use vad='auditok' for the "
            "dependency-free energy VAD."
        )
    from .models.silero import silero_get_speech_timestamps  # lazy import

    # v3.x pinnings chunk at the silero v3 util's default window (1536
    # samples @16 kHz, vs 512 for v4/v5) so the adapter sees the same frame
    # rate the reference's torch.hub util used (transcribe.py:1949-2023)
    window = 1536 if version is not None and version.lstrip("v").startswith("3") else None
    return silero_get_speech_timestamps(
        audio, path,
        sample_rate=sample_rate,
        min_speech_duration=min_speech_duration,
        min_silence_duration=min_silence_duration,
        window_size_samples=window,
        device=device,
    )


# ---------------------------------------------------------------------------
# Public API (mirrors the reference)
# ---------------------------------------------------------------------------


def get_vad_segments(
    audio: np.ndarray,
    sample_rate: int = SAMPLE_RATE,
    output_sample: bool = False,
    min_speech_duration: float = 0.1,
    min_silence_duration: float = 0.1,
    dilatation: float = 0.5,
    method: Union[str, List[Tuple[float, float]]] = "silero",
    device=None,
) -> List[dict]:
    """Speech segments (dicts with start/end) with dilation + overlap merge.
    ``device``: where the silero module runs (None: the CUDA card)."""
    audio = np.asarray(audio)
    if isinstance(method, list):
        segments = [{"start": s * sample_rate, "end": e * sample_rate} for (s, e) in method]
        dilatation = 0
    elif isinstance(method, str) and method.startswith("silero"):
        _, version = check_vad_method(method, with_version=True)
        segments = _silero_speech_segments(
            audio, sample_rate, min_speech_duration, min_silence_duration, version,
            device=device,
        )
    elif method in ("auditok", "energy"):
        segments = _energy_split(
            audio, sample_rate, min_speech_duration, min_silence_duration
        )
    else:
        raise ValueError(f"Got unexpected VAD method {method}")

    if dilatation > 0 and segments:
        # vectorized dilate-then-merge: pad every span, then chain-merge runs
        # whose padded spans touch (detector spans are sorted + disjoint, so a
        # span opens a new run iff its padded start clears the previous
        # padded end)
        pad = round(dilatation * sample_rate)
        lo = np.maximum(np.asarray([s["start"] for s in segments]) - pad, 0)
        hi = np.minimum(np.asarray([s["end"] for s in segments]) + pad, len(audio))
        heads = np.flatnonzero(np.r_[True, lo[1:] > hi[:-1]])
        tails = np.r_[heads[1:], len(lo)] - 1
        segments = [
            {"start": lo[h].item(), "end": hi[t].item()} for h, t in zip(heads, tails)
        ]

    ratio = 1 if output_sample else 1 / sample_rate
    if ratio != 1:
        for seg in segments:
            seg["start"] *= ratio
            seg["end"] *= ratio
    if output_sample:
        for seg in segments:
            seg["start"] = round(seg["start"])
            seg["end"] = round(seg["end"])
    return segments


def remove_non_speech(
    audio: np.ndarray,
    use_sample: bool = False,
    min_speech_duration: float = 0.1,
    min_silence_duration: float = 1,
    dilatation: float = 0.5,
    sample_rate: int = SAMPLE_RATE,
    method: Union[str, List[Tuple[float, float]]] = "silero",
    avoid_empty_speech: bool = False,
    plot=False,
    device=None,
) -> Tuple[np.ndarray, List[Tuple[float, float]], Callable]:
    """Concatenate speech regions; return (speech_audio, segments, convert_fn).
    ``device``: where the silero module runs (None: the CUDA card)."""
    audio = np.asarray(audio)
    segments = get_vad_segments(
        audio,
        sample_rate=sample_rate,
        output_sample=True,
        min_speech_duration=min_speech_duration,
        min_silence_duration=min_silence_duration,
        dilatation=dilatation,
        method=method,
        device=device,
    )
    segments = [(seg["start"], seg["end"]) for seg in segments]
    if len(segments) == 0:
        if avoid_empty_speech:
            segments = [(0, audio.shape[-1])]
        else:
            return (
                np.array([], dtype=audio.dtype),
                [],
                lambda t, t2=None: t if t2 is None else [t, t2],
            )

    audio_speech = np.concatenate([audio[..., s:e] for s, e in segments], axis=-1)

    if plot:
        from .plotting import plot_vad

        plot_vad(audio, segments, sample_rate, plot)

    if not use_sample:
        segments = [(float(s) / sample_rate, float(e) / sample_rate) for s, e in segments]

    return audio_speech, segments, lambda t, t2=None: do_convert_timestamps(segments, t, t2)


def do_convert_timestamps(segments, t, t2=None):
    """Map a timestamp in concatenated-speech time back to original-audio time.

    Behavioral counterpart of the reference's piecewise inverse mapping
    (``transcribe.py:2158-2200``), computed here from the cumulative speech
    spans: segment k of the concatenation covers speech time
    ``[span_starts[k], span_ends[k]]`` and maps affinely back onto
    ``[starts[k], ends[k]]`` in the original audio. When ``t2`` is given, the
    two timestamps should land in one segment; if they straddle several, each
    segment between them yields a clamped candidate pair and the one that
    best preserves the duration ``t2 - t`` wins (first wins on ties).
    """
    assert len(segments)
    starts = np.asarray([s for s, _ in segments], np.float64)
    ends = np.asarray([e for _, e in segments], np.float64)
    span_ends = np.cumsum(ends - starts)  # right edge of each segment, speech time
    span_starts = span_ends - (ends - starts)

    def project(ts, k):  # speech time -> original time, clamped into segment k
        return float(np.clip(starts[k] + (ts - span_starts[k]), starts[k], ends[k]))

    n = len(segments)
    queries = (t,) if t2 is None else (t, t2)
    ks = [int(np.searchsorted(span_ends, q)) for q in queries]
    if min(ks) >= n:
        # beyond the concatenated speech entirely: extrapolate past the last
        # segment, unclamped (matches the reference's fallback)
        base = starts[-1] - span_starts[-1]
        out = [base + q for q in queries]
    else:
        lo, hi = min(ks), min(max(ks), n - 1)
        candidates = [tuple(project(q, k) for q in queries) for k in range(lo, hi + 1)]
        out = min(
            candidates,
            key=lambda c: 0.0 if t2 is None else abs(abs(t2 - t) - abs(c[1] - c[0])),
        )
    if t2 is None:
        return round(out[0], 2)
    return [round(x, 2) for x in out]
