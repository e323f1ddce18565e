"""Whisper's log-mel front end in float64: a Hann-windowed STFT (400-point,
hop 160, reflected at both ends), the power of every frame but the last,
the Slaney mel filterbank of librosa
(``librosa.filters.mel(sr=16000, n_fft=400, n_mels=n)``), log10 clamped at
1e-10, the floor at the row's max - 8, and (x + 4) / 4."""

from __future__ import annotations

import math

import numpy as np
import torch

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_FRAMES = 3000  # one 30-s window of mel frames
PAD_SAMPLES = SAMPLE_RATE * 30  # whisper pads every audio with 30 s of zeros

_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = math.log(6.4) / 27.0


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, np.float64)
    lin = f / _F_SP
    log = _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP
    return np.where(f >= _MIN_LOG_HZ, log, lin)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    lin = _F_SP * m
    log = _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL))
    return np.where(m >= _MIN_LOG_MEL, log, lin)


def mel_filters(n_mels: int, sr: int = SAMPLE_RATE, n_fft: int = N_FFT) -> np.ndarray:
    """(n_mels, 1 + n_fft // 2) float64 Slaney-normalised triangles."""
    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(pts)
    ramps = pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return weights * (2.0 / (pts[2:] - pts[:-2]))[:, None]


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(n,) float audio -> (n_mels, n // 160 + 3000) float64 log-mel of the
    audio followed by 30 s of zeros, on the audio's device."""
    x = torch.nn.functional.pad(audio.to(torch.float64), (0, PAD_SAMPLES))
    window = torch.hann_window(N_FFT, dtype=torch.float64, device=x.device)
    spec = torch.stft(x, N_FFT, HOP, window=window, center=True, pad_mode="reflect",
                      return_complex=True)
    power = spec[..., :-1].abs() ** 2
    filters = torch.as_tensor(mel_filters(n_mels), device=x.device)
    logs = torch.clamp(filters @ power, min=1e-10).log10()
    logs = torch.maximum(logs, logs.max() - 8.0)
    return (logs + 4.0) / 4.0
