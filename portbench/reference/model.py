"""Whisper's forward pass (Radford et al. 2022, openai/whisper ``model.py``)
in float32 with TF32 off: the encoder (two GELU convolutions, sinusoidal
positions, pre-norm blocks, final norm) and the decoder's teacher-forced
causal forward with cross-attention and the tied vocabulary projection.
No cache, no kernels, no batching of prompts.

Weights are a dict of layer-stacked tensors named as ``param_shapes``
lists them (linears (L, out, in)); they may be held in any float type and
are read layer by layer in float32.

``lowp`` computes the same in a lower precision: it rounds both inputs of
every product (convolutions, linears, attention scores and weighted sums,
the vocabulary projection), as ``fp8`` rounds them to float8 e4m3."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-5


def _block(L: int, d: int, ffn: int, cross: bool) -> Dict[str, tuple]:
    shapes = {}
    for p in ("attn", "cross") if cross else ("attn",):
        shapes.update({
            f"{p}_ln_g": (L, d), f"{p}_ln_b": (L, d),
            f"{p}_q_w": (L, d, d), f"{p}_q_b": (L, d), f"{p}_k_w": (L, d, d),
            f"{p}_v_w": (L, d, d), f"{p}_v_b": (L, d),
            f"{p}_o_w": (L, d, d), f"{p}_o_b": (L, d),
        })
    shapes.update({"mlp_ln_g": (L, d), "mlp_ln_b": (L, d), "fc1_w": (L, ffn, d),
                   "fc1_b": (L, ffn), "fc2_w": (L, d, ffn), "fc2_b": (L, d)})
    return shapes


def param_shapes(dims: dict) -> Dict[str, Dict[str, tuple]]:
    """{"encoder": {name: shape}, "decoder": {name: shape}} of the published
    architecture at ``dims`` (the configuration file's ``dims``)."""
    da, dt = dims["n_audio_state"], dims["n_text_state"]
    enc = {"conv1_w": (da, dims["n_mels"], 3), "conv1_b": (da,),
           "conv2_w": (da, da, 3), "conv2_b": (da,), "pos_emb": (dims["n_audio_ctx"], da),
           **_block(dims["n_audio_layer"], da, dims["n_audio_ffn"], False),
           "ln_post_g": (da,), "ln_post_b": (da,)}
    dec = {"tok_emb": (dims["n_vocab"], dt), "pos_emb": (dims["n_text_ctx"], dt),
           **_block(dims["n_text_layer"], dt, dims["n_text_ffn"], True),
           "ln_g": (dt,), "ln_b": (dt,)}
    return {"encoder": enc, "decoder": dec}


def sinusoids(length: int, channels: int) -> np.ndarray:
    """The encoder's fixed positions (whisper ``model.py``: max_timescale
    10000, sin then cos halves)."""
    inc = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a scale per row of its last axis,
    back in float32."""
    scale = x.abs().amax(-1, keepdim=True).clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def _f(w: Dict[str, torch.Tensor], name: str, l=None) -> torch.Tensor:
    t = w[name] if l is None else w[name][l]
    return t.to(torch.float32)


def _ln(x, w, p: str, l=None):
    return F.layer_norm(x, x.shape[-1:], _f(w, f"{p}_g", l), _f(w, f"{p}_b", l), LN_EPS)


def _attention(q, k, v, n_head: int, causal: bool, r=_same, keep=()):
    """(B, Sq, D), (B, Sk, D) -> (B, Sq, D) softmax(q k^T / sqrt(dh)) v,
    and the pre-softmax scores (len(keep), Sq, Sk) of the heads ``keep``
    of the first row of the batch."""
    B, Sq, D = q.shape
    Sk = k.shape[1]
    dh = D // n_head
    q = q.view(B, Sq, n_head, dh).transpose(1, 2)
    k = k.view(B, Sk, n_head, dh).transpose(1, 2)
    v = v.view(B, Sk, n_head, dh).transpose(1, 2)
    s = (r(q) @ r(k).transpose(-1, -2)) / math.sqrt(dh)
    if causal:
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(Sk - Sq)
        s = s.masked_fill(~mask, float("-inf"))
    out = (r(s.softmax(-1)) @ r(v.transpose(-1, -2)).transpose(-1, -2)).transpose(1, 2).reshape(
        B, Sq, D)
    return out, s[0, list(keep)]


def _linear(x, w, p: str, l, r, bias: bool = True):
    b = _f(w, f"{p}_b", l) if bias else None
    return F.linear(r(x), r(_f(w, f"{p}_w", l)), b)


def _mha(x, kv, w, p: str, l: int, n_head: int, causal: bool, r=_same, keep=()):
    q = _linear(x, w, f"{p}_q", l, r)
    k = _linear(kv, w, f"{p}_k", l, r, bias=False)
    v = _linear(kv, w, f"{p}_v", l, r)
    a, scores = _attention(q, k, v, n_head, causal, r, keep)
    return _linear(a, w, f"{p}_o", l, r), scores


def _mlp(x, w, l: int, r=_same):
    h = F.gelu(_linear(_ln(x, w, "mlp_ln", l), w, "fc1", l, r))
    return _linear(h, w, "fc2", l, r)


class ReferenceModel:
    """The forward of ``dims`` over the weights ``weights`` ({"encoder":
    {...}, "decoder": {...}}), in float32 on the weights' device. Call it
    with TF32 off (``no_tf32``)."""

    def __init__(self, dims: dict, weights: Dict[str, Dict[str, torch.Tensor]], lowp=None):
        self.dims = dims
        self.r = lowp or _same
        self.enc = weights["encoder"]
        self.dec = weights["decoder"]

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """(N, n_mels, 3000) -> (N, 1500, D) float32."""
        w, d, r = self.enc, self.dims, self.r
        # a convolution sums over channels and taps: inputs rounded per frame,
        # weights per output channel
        rx = lambda t: r(t.transpose(-1, -2)).transpose(-1, -2)  # noqa: E731
        rw = lambda t: r(t.reshape(t.shape[0], -1)).reshape(t.shape)  # noqa: E731
        x = F.gelu(F.conv1d(rx(mel.to(torch.float32)), rw(_f(w, "conv1_w")), _f(w, "conv1_b"),
                            padding=1))
        x = F.gelu(F.conv1d(rx(x), rw(_f(w, "conv2_w")), _f(w, "conv2_b"), stride=2, padding=1))
        x = x.transpose(1, 2) + _f(w, "pos_emb")[: x.shape[2]]
        for l in range(d["n_audio_layer"]):
            xn = _ln(x, w, "attn_ln", l)
            x = x + _mha(xn, xn, w, "attn", l, d["n_audio_head"], False, r)[0]
            x = x + _mlp(x, w, l, r)
        return _ln(x, w, "ln_post")

    def logits(self, xa: torch.Tensor, tokens: torch.Tensor, heads=()):
        """Teacher-forced logits: xa (1, 1500, D), tokens (T,) int64 ->
        (T, V) float32, row t predicting token t + 1. With ``heads``, a list
        of (layer, head), also the cross-attention's pre-softmax scores
        q.k / sqrt(dh) of those heads, in that order: (len(heads), T, 1500)."""
        w, d, r = self.dec, self.dims, self.r
        T = tokens.shape[0]
        x = (_f(w, "tok_emb")[tokens] + _f(w, "pos_emb")[:T])[None]
        scores = [None] * len(heads)
        for l in range(d["n_text_layer"]):
            xn = _ln(x, w, "attn_ln", l)
            x = x + _mha(xn, xn, w, "attn", l, d["n_text_head"], True, r)[0]
            mine = [(i, h) for i, (hl, h) in enumerate(heads) if hl == l]
            c, s = _mha(_ln(x, w, "cross_ln", l), xa, w, "cross", l, d["n_text_head"], False, r,
                        [h for _, h in mine])
            for j, (i, _) in enumerate(mine):
                scores[i] = s[j]
            x = x + c
            x = x + _mlp(x, w, l, r)
        out = F.linear(r(_ln(x, w, "ln")[0]), r(_f(w, "tok_emb")))
        return (out, torch.stack(scores)) if heads else out


class no_tf32:
    """Full float32 matrix products and convolutions inside the block."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
