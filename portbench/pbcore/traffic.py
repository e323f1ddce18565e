"""The one traffic generator: it reads a mix's parameters
(``traffic/<name>.json``) and the seed.

Every seed gets the same set of sizes and arrival gaps, in another order,
so that seeds change what the audio says and in which order it comes, not
how much work there is: lengths are the ``count`` evenly spaced quantiles
of the mix's distribution, arrival gaps the quantiles of an exponential
of the offered rate, each shuffled by the seed.

Audio is int16 PCM: one pool of a tone gliding between two frequencies
plus Gaussian noise, made on the card from the seed in one draw, and each
stream is a slice of it at an offset drawn from the seed. Streams are
handed to the system as float32 ``x / 32768``, which it ships as int16."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List

import numpy as np
import torch

SAMPLE_RATE = 16000


def quantiles(dist: dict, count: int) -> np.ndarray:
    u = (np.arange(count) + 0.5) / count
    lo, hi = float(dist["low"]), float(dist["high"])
    if dist["kind"] == "log_uniform":
        return np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    if dist["kind"] == "uniform":
        return lo + u * (hi - lo)
    raise ValueError(f"unknown distribution {dist['kind']!r}")


def make_pool(audio: dict, seed: int, device) -> np.ndarray:
    """(n,) float32 samples on the int16 grid."""
    n = int(audio["pool_seconds"] * SAMPLE_RATE)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    t = torch.arange(n, device=device, dtype=torch.float64) / SAMPLE_RATE
    f0, f1 = audio["tone_hz"]
    glide = (f0 + f1) / 2 + (f1 - f0) / 2 * torch.sin(2 * math.pi * t / audio["glide_s"])
    phase = 2 * math.pi * torch.cumsum(glide, 0) / SAMPLE_RATE
    x = audio["tone_amp"] * torch.sin(phase) + audio["noise_amp"] * torch.randn(
        n, generator=gen, device=device, dtype=torch.float64)
    pcm = torch.clamp(torch.round(x * 32768.0), -32768, 32767).to(torch.int16)
    return pcm.cpu().numpy().astype(np.float32) / np.float32(32768.0)


@dataclass(frozen=True)
class Item:
    name: str
    offset: int  # into the pool, samples
    samples: int
    due_s: float = 0.0  # arrival, seconds after the window opens (open loop)

    @property
    def seconds(self) -> float:
        return self.samples / SAMPLE_RATE


def _lengths(traffic: dict) -> np.ndarray:
    secs = quantiles(traffic["seconds"], traffic["count"])
    return np.round(secs * SAMPLE_RATE).astype(np.int64)


def _items(lengths: np.ndarray, pool_n: int, rng, prefix: str, start: int) -> List[Item]:
    order = rng.permutation(len(lengths))
    offsets = rng.integers(0, pool_n - int(lengths.max()), len(lengths))
    return [Item(f"{prefix}{start + i:06d}", int(offsets[i]), int(lengths[k]))
            for i, k in enumerate(order)]


def batches(traffic: dict, seed: int, pool_n: int) -> Iterator[List[Item]]:
    """Closed batches of ``count`` streams each, without end; every batch
    holds the same lengths in another order."""
    lengths = _lengths(traffic)
    b = 0
    while True:
        rng = np.random.default_rng([int(seed), b])
        yield _items(lengths, pool_n, rng, f"b{b:04d}s", 0)
        b += 1


def arrivals(traffic: dict, seed: int, pool_n: int, rate_per_s: float, seconds: float) -> List[Item]:
    """Open-loop arrivals in [0, seconds): cycles of ``count`` clips with
    gaps of mean 1 / rate, each cycle shuffled anew."""
    lengths = _lengths(traffic)
    gaps = -np.log(1.0 - (np.arange(len(lengths)) + 0.5) / len(lengths)) / rate_per_s
    out: List[Item] = []
    t, c = 0.0, 0
    while True:
        rng = np.random.default_rng([int(seed), c])
        clips = _items(lengths, pool_n, rng, f"c{c:04d}f", 0)
        for item, gap in zip(clips, rng.permutation(gaps)):
            t += float(gap)
            if t >= seconds:
                return out
            out.append(Item(item.name, item.offset, item.samples, t))
        c += 1


def audio_of(pool: np.ndarray, item: Item) -> np.ndarray:
    return pool[item.offset: item.offset + item.samples]
