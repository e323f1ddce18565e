"""Audio front-end: loading, resampling, and the log-mel spectrogram.

PyTorch counterpart of ``whisper_timestamped_tpu/audio.py``. The host helpers
(``mel_filters``, ``load_audio``, ``resample``, ``pad_or_trim``, ``as_pcm16``)
are copies of the numpy originals; ``log_mel_spectrogram`` pads the audio
and normalizes the result around ``ops.kernels.log10_mel`` (the fused
front-end kernel on the card, the JAX ``_stft_power`` formulation as its
plain version), on whatever device the audio tensor lives on.
"""

from __future__ import annotations

import functools
import os
import subprocess
import wave
from typing import Optional, Union

import numpy as np
import torch

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000 samples in a 30-second chunk
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000 frames in a mel spectrogram input

N_SAMPLES_PER_TOKEN = HOP_LENGTH * 2  # 320: the initial convolutions downsample 2x
FRAMES_PER_SECOND = SAMPLE_RATE // HOP_LENGTH  # 100 mel frames per second
TOKENS_PER_SECOND = SAMPLE_RATE // N_SAMPLES_PER_TOKEN  # 50 token positions per second
AUDIO_TIME_PER_TOKEN = 1.0 / TOKENS_PER_SECOND  # 0.02 s granularity


# ---------------------------------------------------------------------------
# Mel filterbank (librosa-compatible: Slaney mel scale, Slaney normalization)
# ---------------------------------------------------------------------------


def _hz_to_mel(freq: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa htk=False)."""
    freq = np.asarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = freq >= min_log_hz
    mels = np.where(above, min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = mels >= min_log_mel
    freqs = np.where(above, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
    return freqs


@functools.lru_cache(maxsize=None)
def mel_filters(n_mels: int = 80, sr: int = SAMPLE_RATE, n_fft: int = N_FFT) -> np.ndarray:
    """The (n_mels, 1 + n_fft//2) mel filterbank matrix, float32
    (``librosa.filters.mel(sr=16000, n_fft=400, n_mels=n_mels)``)."""
    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0, sr / 2, n_bins)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))

    fdiff = np.diff(mel_pts)
    ramps = mel_pts.reshape(-1, 1) - fft_freqs.reshape(1, -1)

    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    weights = np.maximum(0, np.minimum(lower, upper))

    # Slaney normalization: each filter integrates to ~constant energy
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm.reshape(-1, 1)
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_bases(n_fft: int = N_FFT) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT cos/sin bases of shape (n_fft, 1 + n_fft//2), with
    the periodic Hann window folded in."""
    n_bins = 1 + n_fft // 2
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    t = np.arange(n_fft).reshape(-1, 1)
    k = np.arange(n_bins).reshape(1, -1)
    angle = 2.0 * np.pi * t * k / n_fft
    cos_b = (np.cos(angle) * window.reshape(-1, 1)).astype(np.float32)
    sin_b = (-np.sin(angle) * window.reshape(-1, 1)).astype(np.float32)
    return cos_b, sin_b


# ---------------------------------------------------------------------------
# Log-mel spectrogram
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _front_end_constants(n_mels: int, n_fft: int, device: torch.device):
    """The DFT bases and the mel filterbank as f32 tensors on ``device``,
    made once per device."""
    cos_b, sin_b = _dft_bases(n_fft)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (cos_b, sin_b, mel_filters(n_mels, n_fft=n_fft)))


def _padded_audio(audio: torch.Tensor, padding: int, pad: int) -> torch.Tensor:
    """(B, n) audio -> (B, pad + n + padding + pad) f32, the input of
    ``log10_mel``: the audio (int16 dequantized as x / 32768), ``padding``
    zeros, then ``pad`` samples reflected at each end. A signal no longer
    than ``pad`` is reflected again at its far end, as ``np.pad`` and
    ``jnp.pad`` do (``F.pad`` refuses it)."""
    if audio.dtype == torch.int16:
        audio = audio.to(torch.float32) / 32768.0
    x = torch.nn.functional.pad(audio.to(torch.float32), (0, padding))
    if x.shape[-1] > pad:
        return torch.nn.functional.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    idx = np.pad(np.arange(x.shape[-1]), pad, mode="reflect")
    return x[:, torch.as_tensor(idx, device=x.device)]


def log_mel_spectrogram(
    audio,
    n_mels: int = 80,
    padding: int = 0,
    n_fft: int = N_FFT,
    hop: int = HOP_LENGTH,
    device=None,
) -> torch.Tensor:
    """Whisper-compatible log-mel spectrogram.

    audio: (n_samples,) or (batch, n_samples) float in [-1, 1], or int16 PCM
    (dequantized as ``x / 32768``); numpy or torch. ``device`` places the
    input before the transform; None keeps a torch tensor where it is and
    puts anything else on the CUDA card (``models.load.default_device``,
    which raises without one). Returns (..., n_mels, n_frames) float32:
    power mel -> log10 -> clamp to max-8 -> (x+4)/4.

    The padding and the normalization run here; the framing, DFT, power, mel
    projection and log10 are ``ops.kernels.log10_mel``: its CUDA kernel for
    audio on the card, its plain version (f32 matmuls at full precision
    unless the caller enabled TF32) on the CPU.
    """
    from .ops.kernels import log10_mel

    if device is None and not isinstance(audio, torch.Tensor):
        from .models.load import default_device

        device = default_device()
    audio = torch.as_tensor(audio, device=device)
    lead = audio.shape[:-1]
    x = _padded_audio(audio.reshape(lead.numel(), audio.shape[-1]), padding, n_fft // 2)
    log_spec = log10_mel(x, *_front_end_constants(n_mels, n_fft, x.device), hop)
    del x
    max_val = log_spec.amax(dim=(-2, -1), keepdim=True)
    torch.maximum(log_spec, max_val - 8.0, out=log_spec)
    log_spec.add_(4.0).div_(4.0)
    return log_spec.reshape(*lead, *log_spec.shape[-2:])


def as_pcm16(audio: np.ndarray) -> Optional[np.ndarray]:
    """int16 view of float audio when the conversion is lossless, else None."""
    if audio.dtype != np.float32 and audio.dtype != np.float64:
        return audio.astype(np.int16) if audio.dtype == np.int16 else None
    if audio.size == 0:
        return audio.astype(np.int16)
    scaled = audio * 32768.0
    a16 = np.rint(scaled)
    if (
        a16.min() >= -32768
        and a16.max() <= 32767
        and np.array_equal(scaled, a16)
    ):
        return a16.astype(np.int16)
    return None


def pad_or_trim(array, length: int = N_SAMPLES, axis: int = -1):
    """Pad (zeros) or trim a numpy array or tensor along ``axis`` to ``length``."""
    n = array.shape[axis]
    if n > length:
        sl = [slice(None)] * array.ndim
        sl[axis] = slice(0, length)
        return array[tuple(sl)]
    if n < length:
        if isinstance(array, torch.Tensor):
            widths = [0, 0] * array.ndim
            widths[2 * (array.ndim - 1 - axis % array.ndim) + 1] = length - n
            return torch.nn.functional.pad(array, widths)
        widths = [(0, 0)] * array.ndim
        widths[axis] = (0, length - n)
        return np.pad(array, widths)
    return array


# ---------------------------------------------------------------------------
# Host-side audio loading
# ---------------------------------------------------------------------------


def _read_wav(path: str) -> tuple[np.ndarray, int]:
    with wave.open(path, "rb") as w:
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        framerate = w.getframerate()
        n_frames = w.getnframes()
        raw = w.readframes(n_frames)
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        data = vals.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"Unsupported WAV sample width: {sampwidth}")
    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return data, framerate


def _ffmpeg_available() -> bool:
    from shutil import which

    return which("ffmpeg") is not None


def _read_via_ffmpeg(path: str, sr: int) -> np.ndarray:
    cmd = [
        "ffmpeg", "-nostdin", "-threads", "0", "-i", path,
        "-f", "s16le", "-ac", "1", "-acodec", "pcm_s16le", "-ar", str(sr), "-",
    ]
    try:
        out = subprocess.run(cmd, capture_output=True, check=True).stdout
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"Failed to load audio via ffmpeg: {e.stderr.decode(errors='replace')}") from e
    return np.frombuffer(out, np.int16).astype(np.float32) / 32768.0


def resample(audio: np.ndarray, orig_sr: int, target_sr: int = SAMPLE_RATE) -> np.ndarray:
    """Polyphase resampling on the host (scipy), exact rational ratio."""
    if orig_sr == target_sr:
        return audio
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(int(orig_sr), int(target_sr))
    return resample_poly(audio, target_sr // g, orig_sr // g).astype(np.float32)


def load_audio(
    audio: Union[str, os.PathLike, np.ndarray, torch.Tensor, list],
    sr: int = SAMPLE_RATE,
) -> np.ndarray:
    """Load audio from a path / array into mono float32 numpy at ``sr`` Hz.
    WAV files are decoded natively; other containers go through ffmpeg when
    available."""
    if isinstance(audio, (list, tuple)):
        audio = np.asarray(audio, dtype=np.float32)
    if not isinstance(audio, (str, os.PathLike)):
        if isinstance(audio, torch.Tensor):
            audio = audio.detach().cpu()
        arr = np.asarray(audio, dtype=np.float32)
        if arr.ndim == 2:  # (channels, n) or (n, channels)
            arr = arr.mean(axis=0 if arr.shape[0] < arr.shape[1] else 1)
        return arr
    path = os.fspath(audio)
    if path.lower().endswith(".wav"):
        try:
            data, orig_sr = _read_wav(path)
            return resample(data, orig_sr, sr)
        except (wave.Error, EOFError, ValueError):
            pass  # not a plain PCM wav: ffmpeg may decode it
    if _ffmpeg_available():
        return _read_via_ffmpeg(path, sr)
    raise RuntimeError(
        f"Cannot decode {path!r}: not a PCM WAV file and ffmpeg is not installed."
    )
