"""Whisper encoder/decoder in PyTorch.

Port of ``whisper_timestamped_tpu/models/whisper_jax.py``. The parameters
stay layer-stacked, as in the JAX tree, but in PyTorch's layouts: a linear
weight is ``(out, in)`` (applied with ``F.linear``) and a conv weight is
``(out, in, k)``. A layer's weight is a view (``w[l]``, or one of
``unbind(0)``'s), so the Python loop over layers reads each one in place.

The single-token decode step sends its two attentions through the
hand-written kernels of ``ops.kernels`` (the plain PyTorch versions run for
CPU tensors), and so do the encoder's self-attention and the prompt
prefill's attentions (``flash_attention``), gated as the JAX package gates
its flash kernel. Everything else is plain PyTorch; ``_attention`` is the
JAX package's non-kernel math. Pre-softmax attention scores follow
whisper's convention, ``q·k·dh^-0.5`` in float32.

The KV cache may hold the cross-attention K/V as int8 or int4 and the
self-attention cache as int8 (``init_cache``), each read by its own
decode kernel; the quantizers are ``ops.quant``'s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels import (
    flash_attention,
    self_attn_decode,
    self_attn_decode_int8,
    xattn_decode,
    xattn_decode_int4,
    xattn_decode_int8,
)
from ..ops.quant import quantize_rows, quantize_rows_int4

ENCODER_FLASH_MIN_LEN = 128  # shorter encoder inputs keep the plain math (whisper_jax.py:261)


@dataclass(frozen=True)
class WhisperDims:
    """Model geometry (mirrors the ``ModelDimensions`` stored in OpenAI .pt files)."""

    n_mels: int = 80
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4

    @property
    def is_multilingual(self) -> bool:
        return self.n_vocab >= 51865

    @property
    def num_languages(self) -> int:
        return self.n_vocab - 51765 - int(self.is_multilingual)


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    """Sinusoidal position embeddings (whisper's encoder positions)."""
    assert channels % 2 == 0
    log_inc = np.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_inc * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def _block_shapes(L: int, d: int, n_mlp: int, cross: bool) -> dict:
    """Layer-stacked block parameter shapes; linears are (L, out, in)."""
    shapes = {}
    for p in ("attn", "cross") if cross else ("attn",):
        shapes.update({
            f"{p}_ln_g": (L, d), f"{p}_ln_b": (L, d),
            f"{p}_q_w": (L, d, d), f"{p}_q_b": (L, d),
            f"{p}_k_w": (L, d, d),
            f"{p}_v_w": (L, d, d), f"{p}_v_b": (L, d),
            f"{p}_o_w": (L, d, d), f"{p}_o_b": (L, d),
        })
    shapes.update({
        "mlp_ln_g": (L, d), "mlp_ln_b": (L, d),
        "fc1_w": (L, n_mlp, d), "fc1_b": (L, n_mlp),
        "fc2_w": (L, d, n_mlp), "fc2_b": (L, d),
    })
    return shapes


def param_shapes(dims: WhisperDims, untied_proj: bool = False,
                 n_mlp: Optional[Tuple[int, int]] = None) -> Tuple[dict, dict]:
    """(encoder, decoder) parameter name -> shape. ``n_mlp`` is the (encoder,
    decoder) MLP width, 4x the model width unless given."""
    da, dt = dims.n_audio_state, dims.n_text_state
    mlp_a, mlp_t = n_mlp or (4 * da, 4 * dt)
    enc = {
        "conv1_w": (da, dims.n_mels, 3), "conv1_b": (da,),
        "conv2_w": (da, da, 3), "conv2_b": (da,),
        "pos_emb": (dims.n_audio_ctx, da),
        **_block_shapes(dims.n_audio_layer, da, mlp_a, cross=False),
        "ln_post_g": (da,), "ln_post_b": (da,),
    }
    dec = {
        "tok_emb": (dims.n_vocab, dt), "pos_emb": (dims.n_text_ctx, dt),
        **_block_shapes(dims.n_text_layer, dt, mlp_t, cross=True),
        "ln_g": (dt,), "ln_b": (dt,),
    }
    if untied_proj:
        dec["proj_w"] = (dims.n_vocab, dt)
    return enc, dec


class WhisperTorch(nn.Module):
    """Parameter container: ``encoder`` and ``decoder`` are ParameterDicts of
    layer-stacked tensors (names from ``param_shapes``). The forward math is
    the module-level functions below (``encode``, ``decode_step``, ...).

    ``fixed_pos_emb``: the encoder's ``pos_emb`` holds the fixed sinusoids
    (the JAX tree has no such leaf and ``encode`` adds sinusoids), so
    training leaves it alone; a checkpoint's positions are trained."""

    def __init__(self, dims: WhisperDims, dtype=torch.float32, device=None,
                 untied_proj: bool = False, n_mlp: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.dims = dims
        enc, dec = param_shapes(dims, untied_proj, n_mlp)

        def make(shapes):
            return nn.ParameterDict({
                k: nn.Parameter(torch.zeros(s, dtype=dtype, device=device), requires_grad=False)
                for k, s in shapes.items()
            })

        self.encoder = make(enc)
        self.decoder = make(dec)
        self.fixed_pos_emb = False

    @property
    def device(self) -> torch.device:
        return self.decoder["tok_emb"].device



def init_params(dims: WhisperDims, seed: int = 0, dtype=torch.float32, device=None,
                untied_proj: bool = False) -> WhisperTorch:
    """Random-weight model with the JAX ``init_params`` scales, drawn from an
    explicit ``torch.Generator`` on ``device`` (weights differ from the JAX
    package's, which draws from ``jax.random``). Encoder positions are the
    fixed sinusoids. ``device`` None means the CUDA card
    (``models.load.default_device``), which raises without one."""
    from .load import default_device

    device = default_device(device)
    model = WhisperTorch(dims, dtype=dtype, device=device, untied_proj=untied_proj)
    gen = torch.Generator(device=device).manual_seed(seed)
    ones = ("_ln_g", "ln_post_g")

    def fill(pd: nn.ParameterDict):
        for name, p in pd.items():
            if name.endswith(ones) or name == "ln_g":
                p.fill_(1.0)
            elif name.endswith("_b") or name == "ln_b":
                p.zero_()
            else:
                if name.endswith("_w") and name.startswith("conv"):
                    scale = (p.shape[1] * p.shape[2]) ** -0.5
                elif name == "tok_emb" or name == "proj_w":
                    scale = p.shape[-1] ** -0.5
                elif name == "pos_emb":
                    scale = 0.01
                else:  # (L, out, in) linear: d_in ** -0.5
                    scale = p.shape[-1] ** -0.5
                r = torch.randn(p.shape, generator=gen, device=device, dtype=torch.float32)
                p.copy_(r.mul_(scale))

    with torch.no_grad():
        fill(model.encoder)
        fill(model.decoder)
        model.encoder["pos_emb"].copy_(
            torch.from_numpy(sinusoids(dims.n_audio_ctx, dims.n_audio_state))
        )
    model.fixed_pos_emb = True
    return model


# ---------------------------------------------------------------------------
# Primitive ops
# ---------------------------------------------------------------------------


def _ln(x, g, b, eps: float = 1e-5):
    return F.layer_norm(x, (x.shape[-1],), g, b, eps)


def _linear(x, w, b=None):
    return F.linear(x, w, b)


def _split_heads(x, n_head):  # (B, S, D) -> (B, H, S, dh)
    B, S, D = x.shape
    return x.reshape(B, S, n_head, D // n_head).transpose(1, 2)


def _merge_heads(x):  # (B, H, S, dh) -> (B, S, D)
    B, H, S, dh = x.shape
    return x.transpose(1, 2).reshape(B, S, H * dh)


def _attention(q, k, v, n_head, mask=None, return_scores=False):
    """Multi-head attention over (B, S, D) projections, the JAX ``_attention``
    math: q and k each scaled by dh**-0.25 in the input dtype, softmax in
    f32. With ``return_scores`` the pre-softmax scores come back in f32."""
    dh = q.shape[-1] // n_head
    qh = _split_heads(q, n_head) * dh**-0.25
    kh = _split_heads(k, n_head) * dh**-0.25
    vh = _split_heads(v, n_head)
    scores = qh @ kh.transpose(-1, -2)
    if mask is not None:
        scores = scores + mask
    w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = _merge_heads(w @ vh)
    return (out, scores.float()) if return_scores else (out, None)


def _int8_attention(q, k8, ks, v8, vs, n_head):
    """Attention over int8 K/V (B, T, D) with per-frame f32 scales (B, T),
    the JAX ``cross_attention`` int8 math (``whisper_jax.py:705-714``): q
    and the codes in bf16 (the codes exactly), the raw q·k product rounded
    to bf16, scores times ks·dh^-0.5 in f32, the softmax weights times vs
    rounded to bf16 for the V product. Returns (out (B, S, D) in q's dtype,
    scores (B, H, S, T) f32)."""
    dh = q.shape[-1] // n_head
    qh = _split_heads(q.bfloat16(), n_head)
    kh = _split_heads(k8.bfloat16(), n_head)
    scores = (qh @ kh.transpose(-1, -2)).float() * (ks[:, None, None, :] * dh**-0.5)
    wv = (torch.softmax(scores, dim=-1) * vs[:, None, None, :]).bfloat16()
    out = _merge_heads(wv @ _split_heads(v8.bfloat16(), n_head)).to(q.dtype)
    return out, scores


def _encoder_attention(q, k, v, n_head):
    """Encoder self-attention, no mask (``whisper_jax.py:246``): through the
    ``flash_attention`` kernel for inputs of at least 128 frames, else the
    plain ``_attention`` math."""
    if q.shape[1] >= ENCODER_FLASH_MIN_LEN:
        return flash_attention(q, k, v, n_head)
    return _attention(q, k, v, n_head)[0]


def _prefill_flash_attention(q, k, v, n_head, pad_len=None, causal=False):
    """Prompt-prefill attention through the ``flash_attention`` kernel
    (``whisper_jax.py:299``): q (B, P, D) over k/v (B, S, D). The self-
    attention passes ``pad_len`` and ``causal``; the cross-attention neither
    (every key live). Rows of left-padding slots attend their own slot."""
    return flash_attention(q, k, v, n_head, causal=causal, pad_len=pad_len)


_LAYER_PREFIXES = ("attn_", "cross_", "mlp_", "fc1_", "fc2_")  # the layer-stacked names


def _layers(pd: nn.ParameterDict, n_layer: int):
    """Each layer's parameters, name -> that layer's view, from one
    ``unbind(0)`` of every stack. Under autograd the backward of ``w[l]``
    writes a zero tensor the size of the whole stack for each layer and adds
    them; ``unbind``'s stacks the layers' gradients once."""
    views = {n: t.unbind(0) for n, t in pd.items() if n.startswith(_LAYER_PREFIXES)}
    return [{n: v[l] for n, v in views.items()} for l in range(n_layer)]


def _conv1d(x, w, b, stride):
    """(B, C_in, T) conv, kernel 3, padding 1."""
    return F.conv1d(x, w, b, stride=stride, padding=1)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encode(model: WhisperTorch, mel: torch.Tensor) -> torch.Tensor:
    """Audio encoder: mel (B, n_mels, T) -> features (B, T//2, D)."""
    enc = model.encoder
    dims = model.dims
    x = mel.to(enc["conv1_w"].dtype)
    x = F.gelu(_conv1d(x, enc["conv1_w"], enc["conv1_b"], 1))
    x = F.gelu(_conv1d(x, enc["conv2_w"], enc["conv2_b"], 2))
    x = x.transpose(1, 2)  # (B, T//2, D)
    x = x + enc["pos_emb"][: x.shape[1]].to(x.dtype)
    H = dims.n_audio_head
    for p in _layers(enc, dims.n_audio_layer):
        xn = _ln(x, p["attn_ln_g"], p["attn_ln_b"])
        a = _encoder_attention(
            _linear(xn, p["attn_q_w"], p["attn_q_b"]),
            _linear(xn, p["attn_k_w"]),
            _linear(xn, p["attn_v_w"], p["attn_v_b"]),
            H,
        )
        x = x + _linear(a, p["attn_o_w"], p["attn_o_b"])
        x = _mlp(x, p)
    return _ln(x, enc["ln_post_g"], enc["ln_post_b"])


# ---------------------------------------------------------------------------
# Decoder — teacher-forced full forward (language detection)
# ---------------------------------------------------------------------------


def _logits(x, dec):
    w = dec["proj_w"] if "proj_w" in dec else dec["tok_emb"]
    return F.linear(x, w)


def _mlp(x, p):
    """The residual MLP of one layer; ``p`` maps the parameter names to that
    layer's tensors (``_layers``, or ``_mlp_params``)."""
    h = F.gelu(_linear(_ln(x, p["mlp_ln_g"], p["mlp_ln_b"]), p["fc1_w"], p["fc1_b"]))
    return x + _linear(h, p["fc2_w"], p["fc2_b"])


def _mlp_params(pd: nn.ParameterDict, l: int) -> dict:
    """Layer ``l``'s MLP parameters, as ``w[l]`` views."""
    return {n: pd[n][l] for n in ("mlp_ln_g", "mlp_ln_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")}


def decode_full(
    model: WhisperTorch,
    tokens: torch.Tensor,
    xa: torch.Tensor,
    pos_offset: int = 0,
    return_cross_attn: bool = False,
    align_heads: Optional[Sequence[Tuple[int, int]]] = None,
):
    """Teacher-forced decoder forward. tokens (B, S) int; xa (B, T, D).
    Returns (logits (B, S, V), cross-attention scores or None): with
    ``return_cross_attn`` every layer's and head's pre-softmax scores,
    (L, B, H, S, T) f32; with ``align_heads`` a list of (layer, head) only
    those heads' rows, kept layer by layer as each layer runs,
    (B, K, S, T) f32 (the same rows, without the whole stack)."""
    dec = model.decoder
    dims = model.dims
    H = dims.n_text_head
    B, S = tokens.shape
    x = dec["tok_emb"][tokens] + dec["pos_emb"][pos_offset : pos_offset + S]
    causal = torch.triu(torch.full((S, S), float("-inf"), device=x.device, dtype=x.dtype), 1)
    ws = []
    rows = None
    if align_heads:
        rows = torch.empty((B, len(align_heads), S, xa.shape[1]), dtype=torch.float32,
                           device=x.device)
    for l, p in enumerate(_layers(dec, dims.n_text_layer)):
        xn = _ln(x, p["attn_ln_g"], p["attn_ln_b"])
        a, _ = _attention(
            _linear(xn, p["attn_q_w"], p["attn_q_b"]),
            _linear(xn, p["attn_k_w"]),
            _linear(xn, p["attn_v_w"], p["attn_v_b"]),
            H, mask=causal,
        )
        x = x + _linear(a, p["attn_o_w"], p["attn_o_b"])
        xc = _ln(x, p["cross_ln_g"], p["cross_ln_b"])
        hits = [k for k, (hl, _) in enumerate(align_heads or ()) if hl == l]
        c, w = _attention(
            _linear(xc, p["cross_q_w"], p["cross_q_b"]),
            _linear(xa, p["cross_k_w"]),
            _linear(xa, p["cross_v_w"], p["cross_v_b"]),
            H, return_scores=return_cross_attn or bool(hits),
        )
        x = x + _linear(c, p["cross_o_w"], p["cross_o_b"])
        x = _mlp(x, p)
        if return_cross_attn:
            ws.append(w)
        for k in hits:
            rows[:, k] = w[:, align_heads[k][1]]
    logits = _logits(_ln(x, dec["ln_g"], dec["ln_b"]), dec)
    if rows is not None:
        return logits, rows
    return logits, (torch.stack(ws) if return_cross_attn else None)


# ---------------------------------------------------------------------------
# Decoder — incremental step with KV cache (the hot decode loop)
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Self-attention cache k/v (L, B, ctx_len, D) and the encoder's
    cross-attention K/V xk/xv (L, B, T_audio, D). The decode step writes its
    new self-attention row into k/v in place (the JAX package returns an
    updated copy; in place saves a cache-sized copy per step).

    Quantized (``init_cache``'s ``quantize_cross`` / ``quantize_self``):
    int8 xk/xv with per-frame f32 scales xk_scale/xv_scale (L, B, T_audio);
    for int4, xk/xv are (L, B, T_audio/2, D) int8 with two frames
    nibble-packed per byte and parity-major scales, so the scales are twice
    as long as the packed rows; int8 k/v with per-slot scales
    k_scale/v_scale (L, B, ctx_len). An unquantized stream's scales are
    None (the JAX package carries ones)."""

    k: torch.Tensor
    v: torch.Tensor
    xk: torch.Tensor
    xv: torch.Tensor
    xk_scale: Optional[torch.Tensor] = None
    xv_scale: Optional[torch.Tensor] = None
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def cross_int4(self) -> bool:
        return self.xk_scale is not None and self.xk_scale.shape[2] == 2 * self.xk.shape[2]

    @property
    def n_frames(self) -> int:
        """Encoder frames: the packed int4 K/V has half as many rows."""
        return self.xk_scale.shape[2] if self.xk_scale is not None else self.xk.shape[2]


def init_cache(model: WhisperTorch, xa: torch.Tensor, ctx_len: Optional[int] = None,
               dtype=None, quantize_cross=False, quantize_self: bool = False) -> KVCache:
    """Project the encoder output into every layer's cross-attention K/V and
    allocate a zeroed self-attention cache of ``ctx_len`` slots.

    ``quantize_cross`` (False, True or "int8", "int4") stores the cross K/V
    quantized, one layer at a time, so the full-precision transient is one
    layer's (a whole bf16 cross-KV is 9.8 GB at large-v3 B=40);
    ``quantize_self`` makes the self cache int8 (its rows are quantized as
    they are written)."""
    dec = model.decoder
    dims = model.dims
    dtype = dtype or xa.dtype
    B, T, _ = xa.shape
    L, D = dims.n_text_layer, dims.n_text_state
    ctx_len = ctx_len or dims.n_text_ctx
    dev = xa.device
    scales = {}
    if quantize_cross:
        qfn = quantize_rows_int4 if quantize_cross == "int4" else quantize_rows
        rows = T // 2 if quantize_cross == "int4" else T
        xk = torch.empty((L, B, rows, D), dtype=torch.int8, device=dev)
        xv = torch.empty_like(xk)
        xk_s = torch.empty((L, B, T), dtype=torch.float32, device=dev)
        xv_s = torch.empty_like(xk_s)
        for l in range(L):
            xk[l], xk_s[l] = qfn(_linear(xa, dec["cross_k_w"][l]))
            xv[l], xv_s[l] = qfn(_linear(xa, dec["cross_v_w"][l], dec["cross_v_b"][l]))
        scales.update(xk_scale=xk_s, xv_scale=xv_s)
    else:
        xk = torch.empty((L, B, T, D), dtype=dtype, device=dev)
        xv = torch.empty_like(xk)
        for l in range(L):
            xk[l] = _linear(xa, dec["cross_k_w"][l])
            xv[l] = _linear(xa, dec["cross_v_w"][l], dec["cross_v_b"][l])
    self_dtype = torch.int8 if quantize_self else dtype
    k = torch.zeros((L, B, ctx_len, D), dtype=self_dtype, device=dev)
    if quantize_self:
        s = torch.zeros((L, B, ctx_len), dtype=torch.float32, device=dev)
        scales.update(k_scale=s, v_scale=torch.zeros_like(s))
    return KVCache(k=k, v=torch.zeros_like(k), xk=xk, xv=xv, **scales)


def cross_attention_rows(q, cache: KVCache, layer: int, n_head: int, emit_scores: bool,
                         beam_group: int = 1):
    """Single-query cross-attention over layer ``layer`` of the cache's
    cross K/V through the kernel for its storage: ``xattn_decode_int4`` for
    nibble-packed K/V, ``xattn_decode_int8`` for int8, else
    ``xattn_decode``."""
    if cache.cross_int4:
        return xattn_decode_int4(q, cache.xk, cache.xk_scale, cache.xv, cache.xv_scale, layer,
                                 n_head, emit_scores=emit_scores, beam_group=beam_group)
    if cache.xk.dtype == torch.int8:
        return xattn_decode_int8(q, cache.xk, cache.xk_scale, cache.xv, cache.xv_scale, layer,
                                 n_head, emit_scores=emit_scores, beam_group=beam_group)
    return xattn_decode(q, cache.xk, cache.xv, layer, n_head, emit_scores=emit_scores,
                        beam_group=beam_group)


def decode_step(
    model: WhisperTorch,
    tokens: torch.Tensor,
    cache: KVCache,
    pos: int,
    pos_offset: Optional[torch.Tensor] = None,
    kv_valid_from: Optional[torch.Tensor] = None,
    align_heads: Optional[Sequence[Tuple[int, int]]] = None,
    beam_group: int = 1,
):
    """One decode step for a single new token per row.

    tokens (B, 1); pos: the cache slot written (Python int); pos_offset (B,)
    is subtracted from ``pos`` for the positional index; kv_valid_from (B,)
    masks cache slots below it (the query's own slot stays live). Returns
    (logits (B, 1, V), rows): with ``align_heads`` a list of (layer, head),
    rows is (B, K, 1, T) f32, the pre-softmax cross-attention scores of
    those heads, else None. Scores are requested from the cross-attention
    kernel only for layers that hold an alignment head.

    The self-attention kernel writes the step's new K/V row into slot
    ``pos`` of the cache in the same launch: ``self_attn_decode`` for a bf16
    cache, ``self_attn_decode_int8`` (the row quantized) for an int8 one.
    The cross K/V take the kernel of ``cross_attention_rows``.
    """
    dec = model.decoder
    dims = model.dims
    B, S = tokens.shape
    if S != 1:
        raise ValueError(f"decode_step takes one token per row, got {S}")
    H = dims.n_text_head
    if pos_offset is None:
        x = dec["tok_emb"][tokens] + dec["pos_emb"][pos]
    else:
        pos_ids = torch.clamp(pos - pos_offset, 0, dims.n_text_ctx - 1)
        x = dec["tok_emb"][tokens] + dec["pos_emb"][pos_ids][:, None]
    self_int8 = cache.k.dtype == torch.int8
    x = x.to(dec["tok_emb"].dtype if self_int8 else cache.k.dtype)
    pad = (
        kv_valid_from.to(torch.int32)
        if kv_valid_from is not None
        else torch.zeros((B,), dtype=torch.int32, device=x.device)
    )
    rows = None
    if align_heads:
        rows = torch.zeros((B, len(align_heads), 1, cache.n_frames),
                           dtype=torch.float32, device=x.device)
    for l in range(dims.n_text_layer):
        xn = _ln(x, dec["attn_ln_g"][l], dec["attn_ln_b"][l])
        k_new = _linear(xn, dec["attn_k_w"][l])
        v_new = _linear(xn, dec["attn_v_w"][l], dec["attn_v_b"][l])
        q = _linear(xn, dec["attn_q_w"][l], dec["attn_q_b"][l])
        if self_int8:
            a = self_attn_decode_int8(q, k_new, v_new, cache.k, cache.k_scale, cache.v,
                                      cache.v_scale, l, pos, pad, H)
        else:
            a = self_attn_decode(q, cache.k, cache.v, l, pos, pad, H, k_new=k_new, v_new=v_new)
        x = x + _linear(a, dec["attn_o_w"][l], dec["attn_o_b"][l])
        xc = _ln(x, dec["cross_ln_g"][l], dec["cross_ln_b"][l])
        qc = _linear(xc, dec["cross_q_w"][l], dec["cross_q_b"][l])
        hits = [k for k, (hl, _) in enumerate(align_heads or ()) if hl == l]
        c, w = cross_attention_rows(qc, cache, l, H, bool(hits), beam_group)
        x = x + _linear(c, dec["cross_o_w"][l], dec["cross_o_b"][l])
        x = _mlp(x, _mlp_params(dec, l))
        for k in hits:
            rows[:, k] = w[:, align_heads[k][1]]
    logits = _logits(_ln(x, dec["ln_g"], dec["ln_b"]), dec)
    return logits, rows
