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

Tensor parallelism (``parallel.mesh.shard_params``): a sharded module holds
a rank's whole heads, ``n_head // tp`` of each stack, and its
``tensor_parallel``; the forward functions run on the local heads, sum the
o and fc2 products over ``tp`` and add their replicated biases after the
sum (``_out_linear``). The alignment rows of a head are filled by the rank
that holds it and summed over ``tp`` (the others hold zeros: exact in
f32), so every rank returns the same rows, and, with the same residual on
every rank, the same logits. An unsharded module's ``tensor_parallel`` is
None. Under autograd (training on a mesh) the sum has the identity
backward, and the input of every column-parallel linear (q/k/v, the cross
q, fc1, and once ``xa`` for every layer's cross K/V) sums its gradient
over ``tp`` (``_copy_to``): Megatron's conjugate pair.

The weight levers (``QuantizedWhisper``, built by the engine beside the
module, which stays as it is): ``w_int8`` gives the decode step an int8
copy of the decoder's linears (``decoder["blocks_w8"]``, weight-only:
``(x @ w8) * s + b``) and every logits projection an int8 copy of the
vocabulary matrix (``decoder["logits_w8"]``); ``enc_int8`` replaces the
encoder's linears with int8 copies whose products also quantize the
activations per token (W8A8, an s8 x s8 -> s32 ``torch._int_mm``). Each copy
is an ``Int8Weight``: codes ``(..., out, in)`` with per-output-channel f32
scales, the JAX package's ``quantize_linear_tree`` transposed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels import (
    flash_attention,
    self_attn_decode,
    self_attn_decode_int8,
    step_slot,
    xattn_decode,
    xattn_decode_int4,
    xattn_decode_int8,
)
from ..ops.quant import quantize_rows, quantize_rows_int4, row_scales

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
        self.tensor_parallel = None  # parallel.mesh.TensorParallel of a sharded module

    @property
    def device(self) -> torch.device:
        return self.decoder["tok_emb"].device



class QuantizedWhisper:
    """A ``WhisperTorch``'s parameters with an engine's int8 copies beside
    them (``engine.py:194-230`` of the JAX package). ``encoder`` and
    ``decoder`` are dicts over the module's own tensors, which are not
    copied and not changed: ``enc_int8`` replaces the encoder's layer-stacked
    linears by W8A8 copies (read by every ``encode``), ``w_int8`` adds the
    decode step's weight-only copies (``decoder["blocks_w8"]``; the prefill,
    ``decode_full`` and ``init_cache`` keep the originals) and the logits'
    (``decoder["logits_w8"]``, read by every ``_logits``). The forward
    functions take it in place of the module."""

    def __init__(self, module: WhisperTorch, w_int8: bool = False, enc_int8: bool = False):
        self.source = module  # the module the copies were made from
        self.dims = module.dims
        self.fixed_pos_emb = module.fixed_pos_emb
        self.encoder = dict(module.encoder.items())
        self.decoder = dict(module.decoder.items())
        linears = lambda pd: [n for n in pd if n.startswith(_LAYER_PREFIXES) and n.endswith("_w")]  # noqa: E731
        with torch.no_grad():
            if enc_int8:
                for n in linears(module.encoder):
                    self.encoder[n] = quantize_linear(module.encoder[n], act_int8=True)
            if w_int8:
                self.decoder["blocks_w8"] = {n: quantize_linear(module.decoder[n])
                                             for n in linears(module.decoder)}
                dec = module.decoder
                self.decoder["logits_w8"] = quantize_linear(
                    dec["proj_w"] if "proj_w" in dec else dec["tok_emb"])

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


@dataclass(frozen=True)
class Int8Weight:
    """An int8 copy of a linear weight: codes ``w8`` (..., out, in) and
    per-output-channel f32 scales ``s`` (..., out, 1), w ~ w8 * s.
    ``act_int8``: the product also quantizes its input per token (W8A8,
    ``_linear_w8a8``), else it is weight-only (``_linear_w8``). Indexing and
    ``unbind(0)`` give a layer's copy, as a layer-stacked tensor does."""

    w8: torch.Tensor
    s: torch.Tensor
    act_int8: bool = False

    def __getitem__(self, l) -> "Int8Weight":
        return Int8Weight(self.w8[l], self.s[l], self.act_int8)

    def unbind(self, dim: int = 0):
        assert dim == 0
        return [Int8Weight(q, s, self.act_int8) for q, s in zip(self.w8.unbind(0), self.s.unbind(0))]


def _per_127(amax: torch.Tensor) -> torch.Tensor:
    """max|x| / 127 as the JAX package's jitted quantizers compute it: XLA
    turns the divide by the constant into a product with its f32
    reciprocal. A tensor factor gives that product on the CPU and the card
    alike (PyTorch's CPU divides a tensor by a Python scalar exactly, its
    CUDA multiplies by the reciprocal)."""
    return amax * torch.full((), 1.0 / 127.0, dtype=torch.float32, device=amax.device)


def quantize_linear(w: torch.Tensor, act_int8: bool = False) -> Int8Weight:
    """Per-output-channel int8 quantization of a (..., out, in) weight
    (``quantize_linear_tree``, ``whisper_jax.py:207``, on the transposed
    layout): scale max|w| / 127 over ``in`` in f32 (``_per_127``), codes
    ``round(w / max(s, 1e-8))`` (an IEEE quotient by a tensor; half to
    even, as ``jnp.round``)."""
    wf = w.float()
    s = _per_127(wf.abs().amax(dim=-1, keepdim=True))
    w8 = torch.round(wf / s.clamp_min(1e-8)).to(torch.int8)
    return Int8Weight(w8, s, act_int8)


def _linear_w8(x, w: Int8Weight, b=None):
    """Weight-only int8 (``_linear``'s ``w8`` branch, ``whisper_jax.py:170-181``):
    ``(x @ w8) * s`` with the codes and the scales in ``x``'s dtype, then
    the bias."""
    y = F.linear(x, w.w8.to(x.dtype)) * w.s[..., 0].to(x.dtype)
    return y if b is None else y + b


def _linear_w8a8(x, w: Int8Weight, b=None):
    """W8A8 (``_linear_w8a8``, ``whisper_jax.py:184``): per-token scales
    max|x| / 127, int8 codes, an exact s8 x s8 -> s32 product
    (``torch._int_mm``: 2-D, more than 16 rows, ``in`` and ``out`` multiples
    of 8 on the card; other shapes raise), then ``y * xs * s + b`` in f32,
    cast to ``x``'s dtype."""
    xf = x.float()
    xs = _per_127(xf.abs().amax(dim=-1, keepdim=True))
    x8 = torch.round(xf / xs.clamp_min(1e-8)).to(torch.int8)
    y = torch._int_mm(x8.reshape(-1, x8.shape[-1]), w.w8.t())
    y = y.reshape(*x.shape[:-1], -1).float() * xs * w.s[..., 0]
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def _linear(x, w: Union[torch.Tensor, Int8Weight], b=None):
    if isinstance(w, Int8Weight):
        return _linear_w8a8(x, w, b) if w.act_int8 else _linear_w8(x, w, b)
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


def _tp(model):
    """The module's ``TensorParallel``, None when it is not sharded."""
    return getattr(model, "tensor_parallel", None)


def _local_heads(model, n_head: int) -> int:
    """The heads of a stack of ``n_head`` that this rank holds."""
    tp = _tp(model)
    return n_head if tp is None else n_head // tp.size


def _out_linear(x, w, b, tp):
    """The o and fc2 projections: under tensor parallelism ``x`` holds this
    rank's columns, so the partial product is summed over ``tp``
    (``reduce_from``) and the replicated bias added once, after the sum."""
    if tp is None:
        return _linear(x, w, b)
    return tp.reduce_from(_linear(x, w)) + b


def _copy_to(x, tp):
    """``x`` as the input of a rank's column-parallel linears (q/k/v, fc1):
    itself; under autograd on a sharded module its gradient is summed over
    ``tp`` in the backward (``TensorParallel.copy_to``)."""
    return x if tp is None else tp.copy_to(x)


def _align_hits(model, align_heads, layer: int, n_local: int):
    """(k, local head) of the alignment heads (layer, h) of ``layer`` that
    this rank holds among its ``n_local`` heads."""
    tp = _tp(model)
    first = 0 if tp is None else tp.rank * n_local
    return [(k, h - first) for k, (hl, h) in enumerate(align_heads or ())
            if hl == layer and first <= h < first + n_local]


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
    H = _local_heads(model, dims.n_audio_head)
    tp = _tp(model)
    for p in _layers(enc, dims.n_audio_layer):
        xn = _copy_to(_ln(x, p["attn_ln_g"], p["attn_ln_b"]), tp)
        a = _encoder_attention(
            _linear(xn, p["attn_q_w"], p["attn_q_b"]),
            _linear(xn, p["attn_k_w"]),
            _linear(xn, p["attn_v_w"], p["attn_v_b"]),
            H,
        )
        x = x + _out_linear(a, p["attn_o_w"], p["attn_o_b"], tp)
        x = _mlp(x, p, tp)
    return _ln(x, enc["ln_post_g"], enc["ln_post_b"])


# ---------------------------------------------------------------------------
# Decoder — teacher-forced full forward (language detection)
# ---------------------------------------------------------------------------


def _logits(x, dec):
    """The vocabulary projection; through the int8 copy ``logits_w8``
    (per-vocabulary-row scales, ``whisper_jax.py:437-446``) when the
    engine built one."""
    q = dec.get("logits_w8")
    if q is not None:
        return _linear_w8(x, q)
    w = dec["proj_w"] if "proj_w" in dec else dec["tok_emb"]
    return F.linear(x, w)


def _mlp(x, p, tp=None):
    """The residual MLP of one layer; ``p`` maps the parameter names to that
    layer's tensors (``_layers``, or ``_mlp_params``); ``tp`` the sharded
    module's ``TensorParallel``."""
    xn = _copy_to(_ln(x, p["mlp_ln_g"], p["mlp_ln_b"]), tp)
    h = F.gelu(_linear(xn, p["fc1_w"], p["fc1_b"]))
    return x + _out_linear(h, p["fc2_w"], p["fc2_b"], tp)


def _mlp_params(pd, l: int, w8: Optional[dict] = None) -> dict:
    """Layer ``l``'s MLP parameters, as ``w[l]`` views; a weight that ``w8``
    holds (the decode step's int8 copies) comes from there."""
    w8 = w8 or {}
    return {n: (w8[n] if n in w8 else pd[n])[l]
            for n in ("mlp_ln_g", "mlp_ln_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")}


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
    H = _local_heads(model, dims.n_text_head)
    tp = _tp(model)
    B, S = tokens.shape
    x = dec["tok_emb"][tokens] + dec["pos_emb"][pos_offset : pos_offset + S]
    causal = torch.triu(torch.full((S, S), float("-inf"), device=x.device, dtype=x.dtype), 1)
    ws = []
    rows = None
    if align_heads:
        rows = torch.zeros((B, len(align_heads), S, xa.shape[1]), dtype=torch.float32,
                           device=x.device)
    xa = _copy_to(xa, tp)  # once: every layer's cross K/V gradient summed by one backward sum
    for l, p in enumerate(_layers(dec, dims.n_text_layer)):
        xn = _copy_to(_ln(x, p["attn_ln_g"], p["attn_ln_b"]), tp)
        a, _ = _attention(
            _linear(xn, p["attn_q_w"], p["attn_q_b"]),
            _linear(xn, p["attn_k_w"]),
            _linear(xn, p["attn_v_w"], p["attn_v_b"]),
            H, mask=causal,
        )
        x = x + _out_linear(a, p["attn_o_w"], p["attn_o_b"], tp)
        xc = _copy_to(_ln(x, p["cross_ln_g"], p["cross_ln_b"]), tp)
        hits = _align_hits(model, align_heads, l, H)
        c, w = _attention(
            _linear(xc, p["cross_q_w"], p["cross_q_b"]),
            _linear(xa, p["cross_k_w"]),
            _linear(xa, p["cross_v_w"], p["cross_v_b"]),
            H, return_scores=return_cross_attn or bool(hits),
        )
        x = x + _out_linear(c, p["cross_o_w"], p["cross_o_b"], tp)
        x = _mlp(x, p, tp)
        if return_cross_attn:
            ws.append(w)
        for k, j in hits:
            rows[:, k] = w[:, j]
    logits = _logits(_ln(x, dec["ln_g"], dec["ln_b"]), dec)
    if rows is not None:
        return logits, (rows if tp is None else tp.sum_(rows))
    if not return_cross_attn:
        return logits, None
    scores = torch.stack(ws)
    if tp is not None:  # every head's scores: each rank's heads, the others zero
        full = scores.new_zeros((*scores.shape[:2], H * tp.size, *scores.shape[3:]))
        full[:, :, tp.rank * H:(tp.rank + 1) * H] = scores
        scores = tp.sum_(full)
    return logits, scores


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


def alloc_cache(model: WhisperTorch, B: int, T: int, ctx_len: int, dtype, device,
                quantize_cross=False, quantize_self: bool = False,
                self_rows: Optional[int] = None) -> KVCache:
    """A cache of ``init_cache``'s layout for B rows of T encoder frames and
    ``ctx_len`` self-attention slots: the cross K/V uninitialized, the self
    cache (and its scales) zeroed. ``self_rows``: the self cache's rows
    when they are not B (beam search: B·K beam rows over B cross-KV rows)."""
    dims = model.dims
    L = dims.n_text_layer
    D = dims.n_text_state // (1 if _tp(model) is None else _tp(model).size)
    scales = {}
    if quantize_cross:
        rows = T // 2 if quantize_cross == "int4" else T
        xk = torch.empty((L, B, rows, D), dtype=torch.int8, device=device)
        s = torch.empty((L, B, T), dtype=torch.float32, device=device)
        scales.update(xk_scale=s, xv_scale=torch.empty_like(s))
    else:
        xk = torch.empty((L, B, T, D), dtype=dtype, device=device)
    R = B if self_rows is None else self_rows
    k = torch.zeros((L, R, ctx_len, D), dtype=torch.int8 if quantize_self else dtype,
                    device=device)
    if quantize_self:
        s = torch.zeros((L, R, ctx_len), dtype=torch.float32, device=device)
        scales.update(k_scale=s, v_scale=torch.zeros_like(s))
    return KVCache(k=k, v=torch.zeros_like(k), xk=xk, xv=torch.empty_like(xk), **scales)


def init_cache(model: WhisperTorch, xa: torch.Tensor, ctx_len: Optional[int] = None,
               dtype=None, quantize_cross=False, quantize_self: bool = False,
               out: Optional[KVCache] = None) -> KVCache:
    """Project the encoder output into every layer's cross-attention K/V and
    allocate a zeroed self-attention cache of ``ctx_len`` slots
    (``alloc_cache``).

    ``quantize_cross`` (False, True or "int8", "int4") stores the cross K/V
    quantized, one layer at a time, so the full-precision transient is one
    layer's (a whole bf16 cross-KV is 9.8 GB at large-v3 B=40);
    ``quantize_self`` makes the self cache int8 (its rows are quantized as
    they are written). On a tensor-parallel module the cache holds the
    rank's heads' columns, and the scales are those of the whole rows
    (``ops.quant``'s ``tp``).

    ``out``: a cache of the same layout to fill in place instead (the
    captured token loop's persistent buffers, whose addresses its CUDA
    graphs hold): its cross K/V are overwritten and its self cache is left
    as it is, since the decode writes each slot before it reads it."""
    dec = model.decoder
    B, T, _ = xa.shape
    if out is None:
        out = alloc_cache(model, B, T, ctx_len or model.dims.n_text_ctx, dtype or xa.dtype,
                          xa.device, quantize_cross, quantize_self)
    qfn = quantize_rows_int4 if quantize_cross == "int4" else quantize_rows
    tp = _tp(model)
    for l in range(model.dims.n_text_layer):
        if quantize_cross:
            out.xk[l], out.xk_scale[l] = qfn(_linear(xa, dec["cross_k_w"][l]), tp)
            out.xv[l], out.xv_scale[l] = qfn(_linear(xa, dec["cross_v_w"][l], dec["cross_v_b"][l]),
                                             tp)
        else:
            out.xk[l] = _linear(xa, dec["cross_k_w"][l])
            out.xv[l] = _linear(xa, dec["cross_v_w"][l], dec["cross_v_b"][l])
    return out


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
    pos,
    pos_offset: Optional[torch.Tensor] = None,
    kv_valid_from: Optional[torch.Tensor] = None,
    align_heads: Optional[Sequence[Tuple[int, int]]] = None,
    beam_group: int = 1,
    extent: Optional[int] = None,
    src_row: Optional[torch.Tensor] = None,
):
    """One decode step for a single new token per row.

    tokens (B, 1); pos: the cache slot written, an int or an int32 scalar
    on the device (the captured token loop computes it there, so that the
    step makes no host read); pos_offset (B,) is subtracted from ``pos`` for
    the positional index; kv_valid_from (B,) masks cache slots below it (the
    query's own slot stays live); ``extent``: the cache slots the
    self-attention spans (``ops.kernels.self_attn_decode``; default pos + 1
    for an int ``pos``, the whole cache for a device one). Returns (logits
    (B, 1, V), rows): with ``align_heads`` a list of (layer, head), rows is
    (B, K, 1, T) f32, the pre-softmax cross-attention scores of those
    heads, else None. Scores are requested from the cross-attention kernel
    only for layers that hold an alignment head.

    The self-attention kernel writes the step's new K/V row into slot
    ``pos`` of the cache in the same launch: ``self_attn_decode`` for a bf16
    cache, ``self_attn_decode_int8`` (the row quantized) for an int8 one.
    ``src_row`` (B, ctx) int32, beam search's row table: the bf16 self
    attention reads slot s of row b from row src_row[b, s] of the cache
    (``ops.kernels.self_attn_decode``); an int8 self cache takes none.
    The cross K/V take the kernel of ``cross_attention_rows``. The step's
    linears read the int8 copies of ``decoder["blocks_w8"]`` when the
    engine built them (``w_int8``; ``whisper_jax.py:1114-1117``).

    On a tensor-parallel module the attentions run on the rank's heads; an
    int8 self cache takes the new rows' scales of the whole rows (local
    max|x|, MAX over ``tp``, / 127), which the kernel's scales-given
    instance writes with; the alignment rows are summed over ``tp`` once a
    step.
    """
    dec = model.decoder
    w8 = dec.get("blocks_w8") or {}

    def w(name: str, l: int):
        return (w8[name] if name in w8 else dec[name])[l]

    dims = model.dims
    B, S = tokens.shape
    if S != 1:
        raise ValueError(f"decode_step takes one token per row, got {S}")
    H = _local_heads(model, dims.n_text_head)
    tp = _tp(model)
    if not isinstance(pos, torch.Tensor):
        extent = int(pos) + 1 if extent is None else extent
    slot = step_slot(pos, tokens.device)
    pos_ids = slot.long().expand(B)
    if pos_offset is not None:
        pos_ids = torch.clamp(pos_ids - pos_offset.long(), 0, dims.n_text_ctx - 1)
    x = dec["tok_emb"][tokens] + dec["pos_emb"][pos_ids][:, None]
    self_int8 = cache.k.dtype == torch.int8
    if self_int8 and src_row is not None:
        raise ValueError("decode_step: an int8 self cache takes no row table")
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
        k_new = _linear(xn, w("attn_k_w", l))
        v_new = _linear(xn, w("attn_v_w", l), dec["attn_v_b"][l])
        q = _linear(xn, w("attn_q_w", l), dec["attn_q_b"][l])
        if self_int8:
            given = None
            if tp is not None:  # the whole rows' scales, (2, B) for K and V
                given = row_scales(torch.stack([k_new[:, 0], v_new[:, 0]]), 127.0, tp)
            a = self_attn_decode_int8(q, k_new, v_new, cache.k, cache.k_scale, cache.v,
                                      cache.v_scale, l, slot, pad, H, extent, row_scales=given)
        else:
            a = self_attn_decode(q, cache.k, cache.v, l, slot, pad, H, k_new=k_new, v_new=v_new,
                                 extent=extent, src_row=src_row)
        x = x + _out_linear(a, w("attn_o_w", l), dec["attn_o_b"][l], tp)
        xc = _ln(x, dec["cross_ln_g"][l], dec["cross_ln_b"][l])
        qc = _linear(xc, w("cross_q_w", l), dec["cross_q_b"][l])
        hits = _align_hits(model, align_heads, l, H)
        c, scores = cross_attention_rows(qc, cache, l, H, bool(hits), beam_group)
        x = x + _out_linear(c, w("cross_o_w", l), dec["cross_o_b"][l], tp)
        x = _mlp(x, _mlp_params(dec, l, w8), tp)
        for k, j in hits:
            rows[:, k] = scores[:, j]
    logits = _logits(_ln(x, dec["ln_g"], dec["ln_b"]), dec)
    if rows is not None and tp is not None:
        tp.sum_(rows)
    return logits, rows
