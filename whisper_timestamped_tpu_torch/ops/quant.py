"""Symmetric per-row int8 and int4 quantization of K/V rows, in plain tensor
code (``models/whisper_jax.py:530-633`` of the JAX package, bit for bit on
the same f32 input: the divide is ``x / max(s, 1e-8)`` in f32 and
``torch.round`` rounds half to even, as ``jnp.round`` does).

int4 packs two frames per int8 byte along T: frame 2i in the low nibble,
2i+1 in the high nibble, values in [-7, 7]. Its per-frame scales are
PARITY-MAJOR: the even frames' scales, then the odd frames'.

``tp``: under tensor parallelism a rank holds only its heads' columns of a
row, so each quantizer takes the max|x| of the whole row: the local max,
then MAX over the tp ranks (``parallel.mesh.TensorParallel.max_``), which
is exact, so the codes and scales equal the unsharded quantizer's bit for
bit (the JAX package quantizes in XLA, where GSPMD takes the max over the
whole row).
"""

from __future__ import annotations

import torch


def row_scales(x: torch.Tensor, levels: float, tp=None) -> torch.Tensor:
    """max|x| over the last axis (over every tp rank's columns with ``tp``)
    divided by ``levels``, as an IEEE quotient: the divisor is a tensor
    because PyTorch's CUDA divide by a Python scalar multiplies by the
    scalar's reciprocal, which differs in the last bit from the quotient
    that the JAX package and the CUDA kernels compute."""
    amax = x.float().abs().amax(dim=-1)
    if tp is not None:
        tp.max_(amax)
    return amax / torch.full((), levels, device=x.device)


def quantize_rows(x: torch.Tensor, tp=None):
    """Per-row (last-axis) int8 codes and f32 scales: x (..., D) ->
    ((..., D) int8, (...) f32) with scale max|x| / 127."""
    xf = x.float()
    s = row_scales(xf, 127.0, tp)
    return int8_codes(xf, s), s


def int8_codes(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Rows x (..., D) as int8 codes with the scales s (...):
    round(x / max(s, 1e-8)) in f32, half to even."""
    return torch.round(x.float() / s.clamp_min(1e-8)[..., None]).to(torch.int8)


def quantize_rows_int4(x: torch.Tensor, tp=None):
    """x (..., T, D), T even -> (packed (..., T//2, D) int8, parity-major
    scales (..., T) f32) with scale max|x| / 7 and codes clipped to [-7, 7]."""
    T = x.shape[-2]
    if T % 2:
        raise ValueError(f"int4 K/V needs an even frame count, got {T}")
    xf = x.float()
    s = row_scales(xf, 7.0, tp)
    q = torch.clamp(torch.round(xf / s.clamp_min(1e-8)[..., None]), -7, 7).to(torch.int32)
    lo, hi = q[..., 0::2, :], q[..., 1::2, :]
    packed = ((lo & 0xF) | (hi << 4)).to(torch.int8)
    return packed, torch.cat([s[..., 0::2], s[..., 1::2]], dim=-1)


def int4_scales_frame_order(s: torch.Tensor) -> torch.Tensor:
    """Parity-major int4 scales (..., T) -> frame order."""
    Tp = s.shape[-1] // 2
    return torch.stack([s[..., :Tp], s[..., Tp:]], dim=-1).reshape(*s.shape[:-1], -1)


def unpack_int4_rows(packed: torch.Tensor) -> torch.Tensor:
    """(..., T//2, D) nibble-packed int8 -> (..., T, D) int8 codes in frame
    order (each nibble sign-extended)."""
    p32 = packed.to(torch.int32)
    lo = (p32 << 28) >> 28
    hi = (p32 << 24) >> 28
    *lead, Tp, D = packed.shape
    return torch.stack([lo, hi], dim=-2).reshape(*lead, 2 * Tp, D).to(torch.int8)
