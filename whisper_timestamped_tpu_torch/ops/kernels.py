"""The hand-written Hopper kernels of the transcription path, each beside
its plain PyTorch version.

======================  ==========================================================
wrapper                 replaces (``whisper_timestamped_tpu/ops/pallas_kernels.py``
                        unless noted)
======================  ==========================================================
``xattn_decode``        ``cross_attention_stacked_pallas_v2`` (:854)
``self_attn_decode``    ``self_attention_stacked_pallas`` (:2088)
``align_cost``          ``attention_to_cost_batched`` (:395); ``align_cost_gather``
                        with the device aligner's gather and window slice
                        (``device_align.py:145-152``)
``attention_to_cost``   ``attention_to_cost_pallas`` (:165), one segment
``median9``             ``median9_pallas`` (:114)
``dtw_codes``           ``dtw_codes_batched`` (:477); ``dtw_starts`` with the
                        device aligner's backtrace (``device_align.py:100``);
                        ``dtw_path`` ``dtw_pallas`` (:259) and
                        ``dtw_path_pallas`` (:291) with its backtrace
``flash_attention``     the library Pallas ``flash_attention`` at
                        ``models/whisper_jax.py:246`` (encoder) and ``:299``
                        (prompt prefill); under autograd ``FlashAttentionFn``
``flash_attention_fwd``  the library's ``_flash_attention_fwd``
                        (``jax/experimental/pallas/ops/tpu/flash_attention.py:234``):
                        the forward that keeps its residual, here the lse
                        (bf16: ``flash_attention``'s kernel; f32: 3xTF32)
``flash_attention_bwd``  the library's ``_flash_attention_bwd_dkv`` (:941) and
                        ``_flash_attention_bwd_dq`` (:1287): two launches
``xattn_decode_int8``   ``cross_attention_stacked_int8_pallas`` v1 (:687), v2
                        (:1051), v3 (:1249), v4 (:1471);
                        ``cross_attention_int8_pallas`` (:2572) and
                        ``cross_attention_int8_rowmajor`` (:2531), the same
                        function unstacked
``xattn_decode_int4``   ``cross_attention_stacked_int4_pallas`` (:1876)
``self_attn_decode_int8``  ``self_attention_stacked_int8_pallas`` (:2205) and
                        its ``_mxu`` variant (:2333); with ``row_scales``
                        (a tensor-parallel rank's rows) the instance that
                        writes with given scales, counted as
                        ``self_attn_decode_int8_scaled``
``log10_mel``           ``log10_mel_pallas`` (:528), framing the audio itself
``stacked_matmul``      ``stacked_matmul_pallas`` (:2427), on no path
======================  ==========================================================

Dispatch is by device: for CPU tensors a wrapper runs the plain version (the
counterpart of Pallas interpret mode, what the CPU tests exercise); for CUDA
tensors it checks device, dtype, shape and contiguity, allocates its outputs
with ``torch.empty``, launches the CUDA kernel from ``csrc/`` on the current
stream (built on first use by ``ops._build``), raises if the launch failed,
and adds one to ``LAUNCHES[name]``. There is no fallback from the kernel to
the plain version. The plain versions take either device, which is how a
run on the card compares the two.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from .quant import int4_scales_frame_order, int8_codes, quantize_rows, unpack_int4_rows

# launches of each kernel since the last reset_launches(); the wrappers add
# one per kernel call (align_cost's and align_cost_gather's one call is two
# launches on one stream, rows then columns, as is attention_to_cost's;
# dtw_starts and dtw_path launch dtw_codes.cu's kernel and count under
# dtw_codes; flash_attention_bwd's one call is two launches, counted under
# flash_attention_bwd_dq and flash_attention_bwd_dkv)
LAUNCHES = {"xattn_decode": 0, "self_attn_decode": 0, "align_cost": 0, "dtw_codes": 0,
            "flash_attention": 0, "xattn_decode_int8": 0, "xattn_decode_int4": 0,
            "self_attn_decode_int8": 0, "attention_to_cost": 0, "median9": 0, "log10_mel": 0,
            "stacked_matmul": 0, "flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0,
            "flash_attention_bwd_dq": 0, "self_attn_decode_int8_scaled": 0}

DIAG, LEFT, UP = 0, 1, 2  # DTW step codes
DTW_INF = 3e38  # the DP's "unreachable" cost, as in the TPU kernel
HEAD_DIM = 64  # the only head width the attention kernels take
MAX_T = 8192  # the longest attention (frames, or cache slots) the decode wrappers take


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# A thread that captures a CUDA graph counts its launches into its own
# record (``counting_into``), since they run only when the graph is
# replayed; each replay adds the record to LAUNCHES (``add_launches``).
_capturing = threading.local()


@contextlib.contextmanager
def counting_into(record: dict):
    """Within the block, the launches this thread makes count into
    ``record`` instead of ``LAUNCHES`` (other threads count as before)."""
    saved = getattr(_capturing, "record", None)
    _capturing.record = record
    try:
        yield record
    finally:
        _capturing.record = saved


def add_launches(record: dict, times: int = 1) -> None:
    """Add a captured graph's launches, ``times`` replays of it."""
    for name, n in record.items():
        LAUNCHES[name] += n * times


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def xattn_decode_plain(q, xk_all, xv_all, layer: int, n_head: int,
                       emit_scores: bool = False, beam_group: int = 1):
    """Single-query cross-attention over layer ``layer`` of the stacked K/V.

    q (B, 1, D); xk_all/xv_all (L, B_kv, T, D) with B == B_kv * beam_group
    (row b reads K/V row b // beam_group). Returns (out (B, 1, D) in q's
    dtype, scores (B, H, 1, T) f32 pre-softmax q·k·dh^-0.5, or None). All
    arithmetic in f32."""
    B, _, D = q.shape
    dh = D // n_head
    k, v = xk_all[layer], xv_all[layer]
    if beam_group > 1:
        rows = torch.arange(B, device=q.device) // beam_group
        k, v = k.index_select(0, rows), v.index_select(0, rows)
    T = k.shape[1]
    qh = q.float().reshape(B, n_head, dh)
    kh = k.float().reshape(B, T, n_head, dh).transpose(1, 2)
    vh = v.float().reshape(B, T, n_head, dh).transpose(1, 2)
    s = torch.einsum("bhd,bhtd->bht", qh, kh) * dh**-0.5
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bht,bhtd->bhd", p, vh).reshape(B, 1, D).to(q.dtype)
    return out, (s[:, :, None] if emit_scores else None)


def step_slot(pos, device) -> torch.Tensor:
    """The step's cache slot as the self-attention kernels read it: an int32
    scalar in device memory. A tensor is taken as it is (a captured decode
    loop computes it on the device); an int is filled into a new one."""
    if isinstance(pos, torch.Tensor):
        return pos
    return torch.full((), int(pos), dtype=torch.int32, device=device)


def _extent(pos, extent: Optional[int], ctx: int) -> int:
    """The cache slots a self-attention call spans: ``extent`` when given,
    else pos + 1 for an int ``pos`` and the whole cache for a device one."""
    if extent is not None:
        return int(extent)
    return ctx if isinstance(pos, torch.Tensor) else int(pos) + 1


def self_attn_decode_plain(q, k_all, v_all, layer: int, pos, pad_len, n_head: int,
                           extent: Optional[int] = None, src_row=None):
    """Single-query self-attention over layer ``layer`` of the stacked cache.

    q (B, 1, D); k_all/v_all (L, B, ctx, D); ``pos`` the step's slot, an
    int or an int32 scalar on q's device. The first ``extent`` slots are
    read (``_extent``) and masked as JAX's static-shape attention masks its
    cache: slot s of row b is live when pad_len[b] <= s <= pos, or s == pos
    (a padding-slot query keeps its own slot, so no row is fully masked).
    ``src_row`` (B, ctx) int32, the row table: slot s of row b is read from
    row src_row[b, s] of the cache (the layer's rows gathered slot by slot
    first), so that beam search never reorders the cache itself.
    Returns (B, 1, D) in q's dtype."""
    B, _, D = q.shape
    dh = D // n_head
    T = _extent(pos, extent, k_all.shape[2])
    if src_row is None:
        k = k_all[layer, :, :T].float()
        v = v_all[layer, :, :T].float()
    else:
        rows, slots = src_row[:, :T].long(), torch.arange(T, device=q.device)[None, :]
        k = k_all[layer][rows, slots].float()
        v = v_all[layer][rows, slots].float()
    slot = step_slot(pos, q.device).long()
    lo = torch.minimum(pad_len.to(q.device).long(), slot)
    ids = torch.arange(T, device=q.device)[None, :]
    live = (ids >= lo[:, None]) & (ids <= slot)  # (B, T)
    qh = q.float().reshape(B, n_head, dh)
    kh = k.reshape(B, T, n_head, dh).transpose(1, 2)
    vh = v.reshape(B, T, n_head, dh).transpose(1, 2)
    s = torch.einsum("bhd,bhtd->bht", qh, kh) * dh**-0.5
    s = s.masked_fill(~live[:, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bht,bhtd->bhd", p, vh).reshape(B, 1, D).to(q.dtype)


def int8_attention(q, k8, ks, v8, vs, n_head: int):
    """Attention of q (B, S, D) over int8 K/V (B, T, D) with per-frame f32
    scales ks/vs (B, T), the function of the int8 TPU kernels: q rounded to
    bf16, codes widened exactly, scores (q·k)·ks·dh^-0.5 in f32, softmax
    weights times vs rounded to bf16 before the V product, which sums in
    f32. The dequantized K/V never exist. Returns (out (B, S, D) in q's
    dtype, scores (B, H, S, T) f32).

    The JAX package's XLA math (``cross_attention``) rounds the raw dot
    product to bf16 as well; the TPU kernels do not, and neither does this."""
    B, S, D = q.shape
    T = k8.shape[1]
    dh = D // n_head
    qh = q.bfloat16().float().reshape(B, S, n_head, dh).transpose(1, 2)
    kh = k8.float().reshape(B, T, n_head, dh).transpose(1, 2)
    vh = v8.float().reshape(B, T, n_head, dh).transpose(1, 2)
    s = (qh @ kh.transpose(-1, -2)) * ks.float()[:, None, None, :] * dh**-0.5
    w = (torch.softmax(s, dim=-1) * vs.float()[:, None, None, :]).bfloat16().float()
    return (w @ vh).transpose(1, 2).reshape(B, S, D).to(q.dtype), s


def xattn_decode_int8_plain(q, xk_all, xk_scale, xv_all, xv_scale, layer: int, n_head: int,
                            emit_scores: bool = False, beam_group: int = 1):
    """``xattn_decode_plain``'s contract over int8 K/V (L, B_kv, T, D) with
    per-frame f32 scales (L, B_kv, T) (see ``int8_attention``)."""
    k, ks, v, vs = xk_all[layer], xk_scale[layer], xv_all[layer], xv_scale[layer]
    if beam_group > 1:
        rows = torch.arange(q.shape[0], device=q.device) // beam_group
        k, ks, v, vs = (t.index_select(0, rows) for t in (k, ks, v, vs))
    out, s = int8_attention(q, k, ks, v, vs, n_head)
    return out, (s if emit_scores else None)


def xattn_decode_int4_plain(q, xk_all, xk_scale, xv_all, xv_scale, layer: int, n_head: int,
                            emit_scores: bool = False, beam_group: int = 1):
    """The same over nibble-packed int4 K/V (L, B_kv, T/2, D) with
    parity-major scales (L, B_kv, T): unpacks layer ``layer``, puts its
    scales in frame order and runs ``xattn_decode_int8_plain``. Scores come
    out in frame order, (B, H, 1, T)."""
    sl = slice(layer, layer + 1)
    return xattn_decode_int8_plain(
        q, unpack_int4_rows(xk_all[sl]), int4_scales_frame_order(xk_scale[sl]),
        unpack_int4_rows(xv_all[sl]), int4_scales_frame_order(xv_scale[sl]),
        0, n_head, emit_scores, beam_group)


def self_attn_decode_int8_plain(q, k_all, k_scale, v_all, v_scale, layer: int, pos,
                                pad_len, n_head: int, extent: Optional[int] = None):
    """``self_attn_decode_plain`` over an int8 cache (L, B, ctx, D) with
    per-slot f32 scales (L, B, ctx): dequantizes the layer's first
    ``extent`` slots to q's dtype (the JAX package's fallback,
    ``whisper_jax.py:982-992``)."""
    T = _extent(pos, extent, k_all.shape[2])
    sl = (slice(layer, layer + 1), slice(None), slice(0, T))
    k = k_all[sl].to(q.dtype) * k_scale[sl][..., None].to(q.dtype)
    v = v_all[sl].to(q.dtype) * v_scale[sl][..., None].to(q.dtype)
    return self_attn_decode_plain(q, k, v, 0, pos, pad_len, n_head, T)


def write_row(new, cache, layer: int, pos) -> None:
    """Write rows ``new`` (B, 1, ...) into slot ``pos`` (an int or an int32
    device scalar) of layer ``layer`` of ``cache`` (L, B, ctx, ...), in
    place, with no host read of ``pos``."""
    idx = step_slot(pos, cache.device).long().reshape(1)
    cache[layer].index_copy_(1, idx, new.to(cache.dtype))


def write_quantized_row(k_new, v_new, k_all, k_scale, v_all, v_scale, layer: int, pos,
                        row_scales=None) -> None:
    """Quantize a step's new self-attention rows k_new/v_new (B, 1, D) with
    ``quantize_rows`` into slot ``pos`` (an int or an int32 device scalar)
    of layer ``layer`` of the int8 cache and its scales, in place; with
    ``row_scales`` (2, B) f32, K's then V's, the codes take those scales
    (``quant.int8_codes``) and they are written as the slot's."""
    if row_scales is None:
        kq, ks = quantize_rows(k_new[:, 0])
        vq, vs = quantize_rows(v_new[:, 0])
    else:
        ks, vs = row_scales[0], row_scales[1]
        kq, vq = int8_codes(k_new[:, 0], ks), int8_codes(v_new[:, 0], vs)
    write_row(kq[:, None], k_all, layer, pos)
    write_row(ks[:, None], k_scale, layer, pos)
    write_row(vq[:, None], v_all, layer, pos)
    write_row(vs[:, None], v_scale, layer, pos)


def median9_plain(x):
    """Width-9 sliding median along the last axis of x (..., M), edges
    reflected as numpy's "symmetric" padding does (column -1 reads column 0,
    repeated for rows shorter than 4). Returns f32 of x's shape."""
    M = x.shape[-1]
    q = torch.remainder(torch.arange(-4, M + 4, device=x.device), 2 * M)
    src = torch.where(q < M, q, 2 * M - 1 - q)
    return x.float()[..., src].unfold(-1, 9, 1).median(dim=-1).values


def _cost_plain(scores, n_tok, span):
    """The cost math of ``align_cost_plain`` before its weight edits.
    scores (S, K, N, M); n_tok, span (S,) long. Returns (cost (S, N, M),
    valid (S, N, M) bool)."""
    S, K, N, M = scores.shape
    dev = scores.device
    span = span.clamp(max=M)
    # source column of each padded position (S, M + 8)
    p = torch.arange(M + 8, device=dev)
    src = torch.where(p < 4, 3 - p, p - 4)[None].expand(S, -1)
    k_edge = p[None] - 4 - span[:, None]
    src = torch.where((k_edge >= 0) & (k_edge < 4),
                      torch.clamp(span[:, None] - 1 - k_edge, min=0), src)
    src = src.clamp(0, M - 1)
    xp = torch.gather(scores.float(), 3, src[:, None, None, :].expand(S, K, N, M + 8))
    med = xp.unfold(3, 9, 1).median(dim=-1).values  # (S, K, N, M)
    col = torch.arange(M, device=dev)
    row = torch.arange(N, device=dev)
    valid = (col[None, None] < span[:, None, None]) & (row[None, :, None] < n_tok[:, None, None])
    med = med.masked_fill(~valid[:, None], float("-inf"))
    mx = med.amax(dim=-1, keepdim=True)
    e = torch.where(valid[:, None], torch.exp(med - mx), 0.0)
    contrib = torch.where(valid[:, None], e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30), 0.0)
    acc = torch.zeros((S, N, M), dtype=torch.float32, device=dev)
    for k in range(K):
        acc = acc + contrib[:, k]
    mean = acc * (1.0 / K)
    norm = torch.sqrt((mean * mean).sum(dim=1, keepdim=True))
    return torch.where(valid, -(mean / norm.clamp_min(1e-30)), 0.0), valid


def align_cost_plain(scores, dims):
    """Batched DTW cost. scores (S, K, N, M) f32, the alignment heads' scores
    of each segment's token rows from its start frame on; dims (S, 4) int32
    rows (n_tokens, span, maxdur_col, start). Returns (S, N, M) f32:

    width-9 median over frames (symmetric reflection at column 0 and at the
    true span edge) -> softmax over frames < span -> mean over heads (summed
    in head order) -> L2 norm of each frame column over the token rows ->
    negate; then 0 at (row < n_tokens - 1, col >= maxdur_col), and
    cost[0, 0] = min(cost). Cells outside (n_tokens, span) are 0."""
    N, M = scores.shape[2], scores.shape[3]
    dims = dims.to(scores.device).long()
    n_tok, maxdur = dims[:, 0], dims[:, 2]
    cost, valid = _cost_plain(scores, n_tok, dims[:, 1])
    row = torch.arange(N, device=scores.device)
    col = torch.arange(M, device=scores.device)
    masked = (row[None, :, None] < n_tok[:, None, None] - 1) & (col[None, None] >= maxdur[:, None, None])
    cost = torch.where(masked & valid, 0.0, cost)
    cost[:, 0, 0] = cost.amin(dim=(1, 2))
    return cost


def gather_window(attn, rows, dims, M: int):
    """Each segment's scores as the device aligner slices them
    (``device_align.py:145-152``): attn (R, K, T) attention rows, rows (S,
    N) row indices, dims (S, 4) with the start frame in column 3. Returns
    (S, K, N, M) f32: token row i of segment s is attn[rows[s, i]], frames
    [start, start + M), 0 past T (the start clamped to [0, T], as
    ``lax.dynamic_slice`` clamps it)."""
    S, N = rows.shape
    K, T = attn.shape[1], attn.shape[2]
    dev = attn.device
    start = dims.to(dev)[:, 3].long().clamp(0, T)
    col = start[:, None] + torch.arange(M, device=dev)  # (S, M)
    x = attn.float()[rows.to(dev).long()]  # (S, N, K, T)
    x = torch.gather(x, 3, col.clamp(max=T - 1)[:, None, None, :].expand(S, N, K, M))
    x = torch.where((col < T)[:, None, None, :], x, 0.0)
    return x.transpose(1, 2).contiguous()


def align_cost_gather_plain(attn, rows, dims, M: int):
    """``align_cost_plain`` of each segment's window of the attention rows
    (``gather_window``): index, slice, then the cost."""
    return align_cost_plain(gather_window(attn, rows, dims, M), dims)


def attention_to_cost_plain(scores, span: int, n_tokens: int):
    """One segment's DTW cost. scores (K, N, M) f32 with the true extent
    (n_tokens, span); returns (N, M) f32: ``align_cost_plain``'s math without
    its weight edits (no max-duration mask, no cost[0, 0] = min; the caller
    makes both on the host). Cells outside (n_tokens, span) are 0."""
    ext = torch.tensor([n_tokens, span], dtype=torch.long, device=scores.device)
    return _cost_plain(scores[None], ext[:1], ext[1:])[0][0]


def dtw_codes_plain(cost, dims):
    """Batched anti-diagonal DTW. cost (S, N, M) f32, dims (S, 4) int32 with
    the true extent (n, m) in columns 0-1. Returns (S, N+M-1, N) int32 step
    codes, diagonal-major: codes[s, i+j, i] is the step into cell (i, j).
    Ties: strict <, DIAG before LEFT before UP; unreachable cost 3e38. Rows
    d >= n+m-1 of a segment are 0."""
    S, N, M = cost.shape
    dev = cost.device
    dims = dims.to(dev).long()
    n, m = dims[:, 0].clamp(max=N), dims[:, 1].clamp(max=M)
    n_diag = n + m - 1
    steps = int(n_diag.max()) if S else 0
    codes = torch.zeros((S, N + M - 1, N), dtype=torch.int32, device=dev)
    i = torch.arange(N, device=dev)
    inf = torch.tensor(DTW_INF, dtype=torch.float32, device=dev)
    inf_col = torch.full((S, 1), DTW_INF, dtype=torch.float32, device=dev)
    g1 = torch.full((S, N), DTW_INF, dtype=torch.float32, device=dev)
    g2 = g1.clone()
    cost = cost.float()
    for d in range(steps):
        j = d - i
        valid = (j >= 0)[None] & (j[None] < m[:, None]) & (i[None] < n[:, None])
        x_d = torch.where(valid, cost[:, i, j.clamp(0, M - 1)], inf)
        g1_up = torch.cat([inf_col, g1[:, :-1]], dim=1)
        g2_diag = torch.cat([inf_col, g2[:, :-1]], dim=1)
        cand_diag = torch.where(((i >= 1) & (j >= 1))[None], g2_diag, inf)
        cand_left = torch.where((j >= 1)[None], g1, inf)
        cand_up = torch.where((i >= 1)[None], g1_up, inf)
        best = cand_diag
        code = torch.full((S, N), DIAG, dtype=torch.int32, device=dev)
        code = torch.where(cand_left < best, LEFT, code)
        best = torch.minimum(best, cand_left)
        code = torch.where(cand_up < best, UP, code)
        best = torch.minimum(best, cand_up)
        origin = ((i == 0) & (j == 0))[None]
        g_new = torch.where(valid, torch.where(origin, x_d, x_d + best), inf)
        codes[:, d] = torch.where((d < n_diag)[:, None], code, 0)
        g2, g1 = g1, g_new
    return codes


def _heads(x, n_head: int):  # (B, S, D) -> f32 (B, H, S, dh)
    B, S, D = x.shape
    return x.float().reshape(B, S, n_head, D // n_head).transpose(1, 2)


def _flash_heads(q, k, v, n_head: int):
    """f32 heads of q, k, v and the scores q·kᵀ·dh^-0.5 (B, H, Sq, Sk)."""
    qh, kh, vh = _heads(q, n_head), _heads(k, n_head), _heads(v, n_head)
    return qh, kh, vh, (qh @ kh.transpose(-1, -2)) * (q.shape[-1] // n_head) ** -0.5


def _merge(x, dtype):  # f32 (B, H, S, dh) -> (B, S, D) in ``dtype``
    B, H, S, dh = x.shape
    return x.transpose(1, 2).reshape(B, S, H * dh).to(dtype)


def flash_attention_plain(q, k, v, n_head: int, *, causal: bool = False, pad_len=None):
    """Multi-head attention over (B, S, D) projections, head h in columns
    h*dh .. h*dh+dh-1: softmax(q·kᵀ·dh^-0.5 + mask)·v, all in f32.

    q (B, Sq, D); k/v (B, Sk, D). With ``causal`` (Sq == Sk), key k is live
    for query q when pad_len[b] <= k <= q, or k == q (a left-padding query
    keeps its own slot, so no row is empty); ``pad_len`` (B,) defaults to
    0 and needs ``causal``. Without it every key is live. Returns
    (B, Sq, D) in q's dtype."""
    _check_flash_masks(q, k, causal, pad_len)
    B, Sq, _ = q.shape
    Sk = k.shape[1]
    _, _, vh, s = _flash_heads(q, k, v, n_head)
    if causal:
        q_ids = torch.arange(Sq, device=q.device)[:, None]
        k_ids = torch.arange(Sk, device=q.device)[None, :]
        lo = (pad_len.to(q.device).long() if pad_len is not None
              else torch.zeros((B,), dtype=torch.long, device=q.device))
        live = ((k_ids[None] >= lo[:, None, None]) & (k_ids <= q_ids)[None]) | (k_ids == q_ids)[None]
        s = s.masked_fill(~live[:, None], float("-inf"))
    return _merge(torch.softmax(s, dim=-1) @ vh, q.dtype)


def flash_attention_fwd_plain(q, k, v, n_head: int):
    """The training forward: ``flash_attention_plain`` without a mask (the
    encoder's case) and the log-sum-exp of each row's scores, lse =
    m + log(l) of the library kernel's residuals (``flash_attention.py:
    234-252``). q (B, Sq, D), k/v (B, Sk, D), f32 or bf16, worked in f32.
    Returns (out (B, Sq, D) in q's dtype, lse (B, H, Sq) f32)."""
    _, _, vh, s = _flash_heads(q, k, v, n_head)
    return _merge(torch.softmax(s, dim=-1) @ vh, q.dtype), torch.logsumexp(s, dim=-1)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, n_head: int):
    """The gradient of ``flash_attention_fwd_plain``'s out, from the saved
    lse: P = exp(S·dh^-0.5 - lse), dV = Pᵀ·dO, dP = dO·Vᵀ, D = rowsum(dO∘O)
    (the library's ``di``, ``flash_attention.py:273-275``), dS = P∘(dP - D),
    dQ = dS·K·dh^-0.5, dK = dSᵀ·Q·dh^-0.5. Inputs of either dtype, worked
    in f32. Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    dh = q.shape[-1] // n_head
    qh, kh, vh, s = _flash_heads(q, k, v, n_head)
    oh, doh = _heads(out, n_head), _heads(dout, n_head)
    p = torch.exp(s - lse[..., None])
    dv = p.transpose(-1, -2) @ doh
    ds = p * (doh @ vh.transpose(-1, -2) - (doh * oh).sum(-1, keepdim=True))
    dq = (ds @ kh) * dh**-0.5
    dk = (ds.transpose(-1, -2) @ qh) * dh**-0.5
    return _merge(dq, q.dtype), _merge(dk, k.dtype), _merge(dv, v.dtype)


def log10_mel_plain(x, cos_b, sin_b, mel_w, hop: int):
    """log10 mel spectrogram of reflect-padded audio x (B, L) f32: frames
    x[b, f*hop : f*hop + n_fft] for f < (L - n_fft) // hop, their windowed
    real DFT against the bases cos_b / sin_b (n_fft, n_bins) as two f32
    matmuls, the power spectrum, the projection on mel_w (n_mels, n_bins) and
    log10(max(mel, 1e-10)). Returns (B, n_mels, n_frames) f32, a transposed
    view. The JAX package's ``_stft_power`` formulation; f32 matmuls run at
    full precision unless the caller enabled TF32."""
    n_fft = cos_b.shape[0]
    n_frames = (x.shape[-1] - n_fft) // hop
    frames = x.unfold(-1, n_fft, hop)[..., :n_frames, :]  # (B, n_frames, n_fft)
    real = frames @ cos_b
    imag = frames @ sin_b
    mel = (real * real + imag * imag) @ mel_w.T
    return torch.log10(torch.clamp(mel, min=1e-10)).transpose(-1, -2)


def stacked_matmul_plain(x, w_all, layer: int):
    """x (B, K) @ w_all[layer]^T with w_all (L, N, K) (the port's (out, in)
    linear layout), summed in f32; returns (B, N) in x's dtype."""
    return (x.float() @ w_all[layer].float().T).to(x.dtype)


def backtrace_batch(codes, n, m, steps: int):
    """Walk the step codes backward from (n-1, m-1), all segments at once
    (``device_align._backtrace_batch`` of the JAX package, a Python loop of
    small tensor ops here). codes (S, D, N) diagonal-major; returns starts
    (S, N) int32 with starts[s, i] = first frame of token row i on the
    optimal path (the host path's jumps[i]); rows >= n stay 0. ``steps`` >=
    max(n + m - 1)."""
    S, D, N = codes.shape
    rng = torch.arange(S, device=codes.device)
    n, m = torch.as_tensor(n, device=codes.device), torch.as_tensor(m, device=codes.device)
    i, j = (n - 1).long(), (m - 1).long()
    starts = torch.zeros((S, N), dtype=torch.int32, device=codes.device)
    for _ in range(steps):
        starts[rng, i] = j.to(torch.int32)  # backward walk: last write = min j
        c = codes[rng, (i + j).clamp(max=D - 1), i]
        at_origin = (i == 0) & (j == 0)
        # host backtrace rules: at i==0 step left, at j==0 step up, else follow the code
        left = c == LEFT
        diag = c == DIAG
        ni = torch.where(i == 0, 0, torch.where(j == 0, i - 1, torch.where(left, i, i - 1)))
        nj = torch.where(i == 0, j - 1, torch.where(j == 0, j, torch.where(left | diag, j - 1, j)))
        i = torch.where(at_origin, 0, ni)
        j = torch.clamp(torch.where(at_origin, 0, nj), min=0)
    return starts


def dtw_starts_plain(cost, dims):
    """Per-token start frames of each segment's DTW path: ``backtrace_batch``
    of ``dtw_codes_plain``. cost (S, N, M) f32, dims (S, 4) int32 with the
    true extent (n, m) in columns 0-1. Returns (S, N) int32."""
    dims = dims.to(cost.device)
    n, m = dims[:, 0].clamp(max=cost.shape[1]), dims[:, 1].clamp(max=cost.shape[2])
    steps = int((n + m - 1).max()) if cost.shape[0] else 0
    return backtrace_batch(dtw_codes_plain(cost, dims), n, m, steps)


def _walk_path(codes, n: int, m: int) -> Tuple[np.ndarray, np.ndarray]:
    """The path from (0, 0) to (n-1, m-1) through diagonal-major codes, walked
    back from the end with the host rules (``dtw_path_pallas``'s loop)."""
    i, j = n - 1, m - 1
    path = [(i, j)]
    while i > 0 or j > 0:
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            s = codes[i + j, i]
            if s == DIAG:
                i, j = i - 1, j - 1
            elif s == LEFT:
                j -= 1
            else:
                i -= 1
        path.append((i, j))
    path.reverse()
    arr = np.array(path, np.int64)
    return arr[:, 0], arr[:, 1]


def dtw_path_plain(cost) -> Tuple[np.ndarray, np.ndarray]:
    """DTW path of one (n, m) cost: ``dtw_codes_plain`` at S=1, then the
    backtrace on the host, as ``dtw_path_pallas`` does. Returns (index1s,
    index2s) int64."""
    n, m = cost.shape
    dims = torch.tensor([[n, m, 0, 0]], dtype=torch.int32, device=cost.device)
    return _walk_path(dtw_codes_plain(cost[None], dims)[0].cpu().numpy(), n, m)


def _check_flash_masks(q, k, causal: bool, pad_len) -> None:
    if pad_len is not None and not causal:
        raise ValueError("flash_attention: pad_len needs causal=True")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"flash_attention: causal needs Sq == Sk, got {q.shape[1]} and {k.shape[1]}")


# ---------------------------------------------------------------------------
# Wrappers: CPU -> plain version, CUDA -> kernel
# ---------------------------------------------------------------------------


def _on_cuda(name: str, *tensors) -> bool:
    """True for CUDA tensors on one device, False for CPU tensors; raises on
    anything else (mixed devices, other backends)."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return True


def _expect(name: str, cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


CUDA_ERROR_INVALID_VALUE = 1  # cudaErrorInvalidValue


def _launch(name: str, fn_name: str, *args, refused: Optional[str] = None) -> None:
    """Call the C entry point ``fn_name``; with ``refused``, its
    cudaErrorInvalidValue (what it returns, launching nothing, for
    arguments it does not take) raises ``ValueError`` with that text."""
    from ._build import library

    rc = getattr(library(), fn_name)(*args)
    if rc == CUDA_ERROR_INVALID_VALUE and refused is not None:
        raise ValueError(f"{name}: {refused}")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    record = getattr(_capturing, "record", None)
    counts = LAUNCHES if record is None else record
    counts[name] = counts.get(name, 0) + 1


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


XATTN_TILE = 64  # rows a split is cut into whole multiples of
XATTN_MAX_SPLITS = 8  # the splits of a (row, head) merge in one (portable) block cluster
# The grid of the decode-attention pipeline (csrc/decode_attn.cuh), chosen
# from tools/torch_kernel_sweeps.py's measurements of its kernels:
# the warps a multiprocessor that the split rule aims at. PIPELINE_WARPS
# (2 or 4) overrides the warps a block (``pipeline_warps``), for the
# sweeps.
XATTN_WARPS_PER_SM = 12
PIPELINE_WARPS: Optional[int] = None


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def pipeline_warps(B: int, H: int, n_sm: int, frames_per_row: int = 1) -> int:
    """Warps a block of the pipeline's kernels: 4 while the B * H (row,
    head) pairs are fewer than the multiprocessors, else 2, so that a large
    batch's blocks are resident at once; 4 at every batch for rows of two
    frames (int4), whose tiles carry twice the frames a byte, so that more
    warps an SM hide their work (or PIPELINE_WARPS)."""
    if PIPELINE_WARPS is not None:
        return PIPELINE_WARPS
    return 4 if frames_per_row == 2 or B * H < n_sm else 2


def xattn_split(B: int, H: int, T: int, n_sm: int, frames_per_row: int = 1) -> Tuple[int, int]:
    """(n_split, rows per split) of the grid of the decode-attention
    pipeline's kernels (``xattn_decode``, ``xattn_decode_int8`` over T
    frames, ``xattn_decode_int4`` over T = frames / 2 packed rows,
    ``self_attn_decode`` and ``self_attn_decode_int8`` over T = the
    call's extent of slots): about
    XATTN_WARPS_PER_SM warps a multiprocessor over the B * H (row, head)
    pairs in blocks of ``pipeline_warps`` warps (for rows of
    ``frames_per_row`` frames), at most one split per 64 rows and
    XATTN_MAX_SPLITS in all, each split whole 64-row pieces."""
    tiles = -(-T // XATTN_TILE)
    per_block = B * H * pipeline_warps(B, H, n_sm, frames_per_row)
    want = min(max(-(-XATTN_WARPS_PER_SM * n_sm // per_block), 1), tiles, XATTN_MAX_SPLITS)
    per = -(-tiles // want) * XATTN_TILE
    return -(-T // per), per


def _grid(q, B: int, H: int, T: int, frames_per_row: int = 1) -> Tuple[int, int, int]:
    """(n_split, rows per split, warps a block) of a pipeline launch over T
    rows of ``frames_per_row`` frames on q's device."""
    n_sm = _sm_count(q.device)
    return (*xattn_split(B, H, T, n_sm, frames_per_row),
            pipeline_warps(B, H, n_sm, frames_per_row))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def xattn_decode(q, xk_all, xv_all, layer: int, n_head: int,
                 emit_scores: bool = False, beam_group: int = 1
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Cross-attention of one decode step over layer ``layer`` of the stacked
    encoder K/V (see ``xattn_decode_plain``). On CUDA: bf16 q/K/V, head
    width 64, contiguous; scores are written only when ``emit_scores``. The
    kernel splits T across blocks (``xattn_split``) and merges the splits'
    partial softmaxes in the launch."""
    name = "xattn_decode"
    if not _on_cuda(name, q, xk_all, xv_all):
        return xattn_decode_plain(q, xk_all, xv_all, layer, n_head, emit_scores, beam_group)
    B, S, D = q.shape
    L, B_kv, T, Dk = xk_all.shape
    _expect(name, S == 1 and Dk == D and xv_all.shape == xk_all.shape, "shape mismatch")
    _expect(name, D == n_head * HEAD_DIM, f"head width must be {HEAD_DIM}, got D={D} H={n_head}")
    _expect(name, all(t.dtype == torch.bfloat16 for t in (q, xk_all, xv_all)), "q/K/V must be bf16")
    _expect(name, all(t.is_contiguous() for t in (q, xk_all, xv_all)), "inputs must be contiguous")
    _expect(name, _aligned(q, xk_all, xv_all), "inputs must be 16-byte aligned")
    _expect(name, B == B_kv * beam_group, f"B={B} != B_kv={B_kv} * beam_group={beam_group}")
    _expect(name, 0 <= layer < L and 0 < T <= MAX_T, f"layer {layer} / T {T} out of range")
    _expect(name, B <= 65535 and n_head <= 65535, f"unsupported B={B} H={n_head}")
    out = torch.empty_like(q)
    scores = (
        torch.empty((B, n_head, 1, T), dtype=torch.float32, device=q.device)
        if emit_scores else None
    )
    _launch(name, "wtt_xattn_decode", q.data_ptr(), xk_all.data_ptr(), xv_all.data_ptr(),
            out.data_ptr(), _ptr(scores), layer, B, B_kv, T, D, n_head, beam_group,
            *_grid(q, B, n_head, T), HEAD_DIM**-0.5, _stream(q))
    return out, scores


def self_attn_decode(q, k_all, v_all, layer: int, pos, pad_len, n_head: int,
                     k_new=None, v_new=None, extent: Optional[int] = None, src_row=None):
    """Self-attention of one decode step over layer ``layer`` of the stacked
    cache, live slots [min(pad_len[b], pos), pos] of its first ``extent``
    (see ``self_attn_decode_plain``). ``pos`` is an int32 scalar on the
    device (``step_slot``; an int is filled into one), which the kernel
    reads, so that one launch serves every step of a captured loop; the
    grid is sized from ``extent`` (default: pos + 1 for an int ``pos``, the
    whole cache for a device one). With ``k_new``/``v_new`` (B, 1, D), the
    step's new rows, it first writes them into slot ``pos`` of layer
    ``layer`` of k_all/v_all, in place, and attends over the written cache.
    On CUDA one launch does both: bf16 q/K/V and new rows, head width 64,
    contiguous, int32 ``pad_len`` on the same device. For CPU tensors the
    rows are written by ``write_row`` and the plain version attends.

    ``src_row`` (B, ctx) int32 on the device, the row table of beam search
    (``self_attn_decode_plain``): slot s of row b is read from physical row
    src_row[b, s]; the step's rows are still written to row b, and the
    caller keeps src_row[b, pos] = b. None reads row b's own slots."""
    name = "self_attn_decode"
    _expect(name, (k_new is None) == (v_new is None), "give both k_new and v_new, or neither")
    new = () if k_new is None else (k_new, v_new)
    table = () if src_row is None else (src_row,)
    slot = step_slot(pos, q.device)
    T = _extent(pos, extent, k_all.shape[2])
    if not _on_cuda(name, q, k_all, v_all, pad_len, slot, *new, *table):
        if new:
            write_row(k_new, k_all, layer, slot)
            write_row(v_new, v_all, layer, slot)
        return self_attn_decode_plain(q, k_all, v_all, layer, slot, pad_len, n_head, T, src_row)
    B, S, D = q.shape
    L, Bk, ctx, Dk = k_all.shape
    _expect(name, S == 1 and Bk == B and Dk == D and v_all.shape == k_all.shape
            and all(t.shape == q.shape for t in new), "shape mismatch")
    _expect(name, D == n_head * HEAD_DIM, f"head width must be {HEAD_DIM}, got D={D} H={n_head}")
    _expect(name, all(t.dtype == torch.bfloat16 for t in (q, k_all, v_all, *new)),
            "q/K/V and the new rows must be bf16")
    _expect(name, pad_len.dtype == torch.int32 and pad_len.shape == (B,), "pad_len must be int32 (B,)")
    _check_slot(name, pos, slot, T)
    _expect(name, src_row is None or (src_row.dtype == torch.int32 and src_row.shape == (B, ctx)),
            f"src_row must be int32 ({B}, {ctx})")
    _expect(name, all(t.is_contiguous() for t in (q, k_all, v_all, pad_len, *new, *table)),
            "inputs must be contiguous")
    _expect(name, _aligned(q, k_all, v_all, *new), "inputs must be 16-byte aligned")
    _expect(name, 0 <= layer < L and 0 < T <= min(ctx, MAX_T), f"layer {layer} / extent {T} out of range")
    _expect(name, B <= 65535 and n_head <= 65535, f"unsupported B={B} H={n_head}")
    out = torch.empty_like(q)
    _launch(name, "wtt_self_attn_decode", q.data_ptr(), _ptr(k_new), _ptr(v_new),
            k_all.data_ptr(), v_all.data_ptr(), out.data_ptr(), pad_len.data_ptr(),
            slot.data_ptr(), _ptr(src_row), layer, B, ctx, D, n_head, *_grid(q, B, n_head, T),
            HEAD_DIM**-0.5, _stream(q))
    return out


def _check_slot(name: str, pos, slot: torch.Tensor, extent: int) -> None:
    """The slot a kernel reads is an int32 scalar; an int one is also
    checked against the extent (a device one is the caller's to keep in
    range: the decode loop clamps it)."""
    _expect(name, slot.dtype == torch.int32 and slot.numel() == 1, "pos must be an int32 scalar")
    if not isinstance(pos, torch.Tensor):
        _expect(name, 0 <= int(pos) < extent, f"pos {pos} outside the extent {extent}")


MAX_COST_FRAMES = 1536  # the frames (M) the cost kernel takes (a lane's registers hold 7 tiles of 8)
COST_HEADS_A_GROUP = 16  # heads a row block of the cost kernel takes, about (up to 8 groups)


def cost_head_groups(K: int) -> int:
    """Head groups of the cost kernel's rows launch: K / 16 of them, 1 to 8,
    each its own row block, so that a segment of many heads (120) still
    fills the card; the columns launch adds their partials in order."""
    return max(1, min(8, K // COST_HEADS_A_GROUP))


def _cost_partial(S: int, N: int, M: int, G: int, device) -> Optional[torch.Tensor]:
    """The head groups' partial sums after the first group's (None at G=1)."""
    return torch.empty((G - 1, S, N, M), dtype=torch.float32, device=device) if G > 1 else None


def _cost_tickets(S: int, M: int, device) -> torch.Tensor:
    """The columns launch's per-segment tickets, then its 32-frame tiles' minima."""
    return torch.empty(S + S * -(-M // 32), dtype=torch.int32, device=device)


def _by_4_frames(x):
    """x, or a copy of it padded with zero frames to a multiple of 4 on its
    last axis where that is not one or where x is not 16-byte aligned: the
    cost kernel stages its rows in 16-byte pieces."""
    if x.shape[-1] % 4 == 0 and _aligned(x):
        return x
    return torch.nn.functional.pad(x, (0, -x.shape[-1] % 4))


def align_cost(scores, dims):
    """Batched DTW cost matrices (see ``align_cost_plain``). On CUDA: f32
    scores (S, K, N, M) with M <= 1536, int32 dims (S, 4), contiguous; M
    not a multiple of 4 (or scores not 16-byte aligned) is padded."""
    name = "align_cost"
    if not _on_cuda(name, scores, dims):
        return align_cost_plain(scores, dims)
    S, K, N, M = scores.shape
    _expect(name, scores.dtype == torch.float32 and dims.dtype == torch.int32, "scores f32, dims int32")
    _expect(name, dims.shape == (S, 4), "dims must be (S, 4)")
    _expect(name, scores.is_contiguous() and dims.is_contiguous(), "inputs must be contiguous")
    _expect(name, 0 < M <= MAX_COST_FRAMES and 0 < N <= 65535 and 0 < S <= 65535 and K > 0,
            f"unsupported N={N} M={M} K={K}")
    scores = _by_4_frames(scores)
    Mp = scores.shape[3]
    if Mp != M:  # the span stays within the M frames given (padded frames cost 0)
        dims = torch.cat([dims[:, :1], dims[:, 1:2].clamp(max=M), dims[:, 2:]], 1)
    cost = torch.empty((S, N, Mp), dtype=torch.float32, device=scores.device)
    G = cost_head_groups(K)
    # the scratch stays referenced until the launch is queued (a freed block may be handed out again)
    tickets, partial = _cost_tickets(S, Mp, scores.device), _cost_partial(S, N, Mp, G, scores.device)
    _launch(name, "wtt_align_cost", scores.data_ptr(), None, dims.data_ptr(), cost.data_ptr(),
            tickets.data_ptr(), _ptr(partial), S, K, N, Mp, Mp, G, _stream(scores))
    return cost if Mp == M else cost[..., :M].contiguous()


def align_cost_gather(attn, rows, dims, M: int):
    """``align_cost`` of each segment's window of the attention rows, read
    in place (see ``align_cost_gather_plain``): attn (R, K, T), rows (S, N)
    row indices in [0, R), dims (S, 4). Returns (S, N, M) f32. On CUDA: f32
    attn, int32 rows and dims, contiguous, M <= 1536; the kernel reads
    token row i of segment s at attn[rows[s, i]] without a copy (T not a
    multiple of 4, or attn not 16-byte aligned, takes a padded copy)."""
    name = "align_cost"
    if not _on_cuda(name, attn, rows, dims):
        return align_cost_gather_plain(attn, rows, dims, M)
    S, N = rows.shape
    _expect(name, attn.ndim == 3 and attn.dtype == torch.float32, "attn must be (R, K, T) f32")
    _expect(name, rows.dtype == torch.int32 and dims.dtype == torch.int32, "rows, dims int32")
    _expect(name, dims.shape == (S, 4), "dims must be (S, 4)")
    _expect(name, attn.is_contiguous() and rows.is_contiguous() and dims.is_contiguous(),
            "inputs must be contiguous")
    K, T = attn.shape[1], attn.shape[2]
    _expect(name, 0 < M <= MAX_COST_FRAMES and 0 < N <= 65535 and 0 < S <= 65535 and K > 0 and T > 0,
            f"unsupported N={N} M={M} K={K} T={T}")
    # zero frames past T read as the slice's zeros; a start past T reads only zeros either way
    attn = _by_4_frames(attn)
    cost = torch.empty((S, N, M), dtype=torch.float32, device=attn.device)
    G = cost_head_groups(K)
    tickets, partial = _cost_tickets(S, M, attn.device), _cost_partial(S, N, M, G, attn.device)
    _launch(name, "wtt_align_cost", attn.data_ptr(), rows.data_ptr(), dims.data_ptr(),
            cost.data_ptr(), tickets.data_ptr(), _ptr(partial), S, K, N, M, attn.shape[2], G,
            _stream(attn))
    return cost


def attention_to_cost(scores, span: int, n_tokens: Optional[int] = None):
    """One segment's DTW cost from (K, N, M) scores with the true extent
    (n_tokens, span), n_tokens defaulting to N (see
    ``attention_to_cost_plain``). On CUDA: f32, contiguous, M <= 1536; M
    not a multiple of 4 (or scores not 16-byte aligned) is padded."""
    name = "attention_to_cost"
    K, N, M = scores.shape
    n_tokens = N if n_tokens is None else int(n_tokens)
    span = int(span)
    if not _on_cuda(name, scores):
        return attention_to_cost_plain(scores, span, n_tokens)
    _expect(name, scores.dtype == torch.float32, "scores must be f32")
    _expect(name, scores.is_contiguous(), "scores must be contiguous")
    _expect(name, 0 < M <= MAX_COST_FRAMES and 0 < N <= 65535 and K > 0,
            f"unsupported N={N} M={M} K={K}")
    _expect(name, 0 < span <= M and 0 < n_tokens <= N,
            f"extent (n_tokens={n_tokens}, span={span}) outside ({N}, {M})")
    scores = _by_4_frames(scores)
    Mp = scores.shape[2]
    cost = torch.empty((N, Mp), dtype=torch.float32, device=scores.device)
    partial = _cost_partial(1, N, Mp, cost_head_groups(K), scores.device)
    _launch(name, "wtt_attention_to_cost", scores.data_ptr(), cost.data_ptr(), _ptr(partial), K,
            N, Mp, n_tokens, span, cost_head_groups(K), _stream(scores))
    return cost if Mp == M else cost[:, :M].contiguous()


def median9(x):
    """Width-9 sliding median along the last axis, symmetric edges (see
    ``median9_plain``). On CUDA: f32, contiguous, non-empty."""
    name = "median9"
    if not _on_cuda(name, x):
        return median9_plain(x)
    _expect(name, x.dtype == torch.float32, "x must be f32")
    _expect(name, x.is_contiguous(), "x must be contiguous")
    _expect(name, x.ndim >= 1 and x.numel() > 0, f"unsupported shape {tuple(x.shape)}")
    M = x.shape[-1]
    out = torch.empty_like(x)
    _launch(name, "wtt_median9", x.data_ptr(), out.data_ptr(), x.numel() // M, M, _stream(x))
    return out


DTW_MAX_N = 1024  # rows the DTW kernel takes (8 warps of 4 rows a lane)
DTW_ROWS_A_WARP = 64  # the warp count's rule: one warp per 64 rows, up to 8


def dtw_warps(N: int) -> int:
    """Warps of the DTW kernel's block for N <= 1024 token rows: one per 64
    rows, up to 8 (so at most 4 rows a lane)."""
    return min(8, -(-N // DTW_ROWS_A_WARP))


def _dtw(name: str, cost, dims, codes=None, starts=None, path=None) -> None:
    """Launch dtw_codes.cu's kernel on (S, N, M) cost for the outputs given
    (codes of (S, N + M' - 1, N), M' = M rounded up to a multiple of 4,
    zeroed). Where the walk's packed codes do not fit in the block's shared
    memory they go to a device-memory scratch of the size the C side
    reports (``wtt_dtw_scratch_bytes``), which it checks again at launch."""
    from ._build import library

    S, N, M = cost.shape
    _expect(name, cost.dtype == torch.float32 and dims.dtype == torch.int32, "cost f32, dims int32")
    _expect(name, dims.shape == (S, 4), "dims must be (S, 4)")
    _expect(name, cost.is_contiguous() and dims.is_contiguous(), "inputs must be contiguous")
    _expect(name, 0 < N <= DTW_MAX_N and M > 0 and 0 < S <= 2**31 - 1, f"unsupported N={N} M={M}")
    if M % 4 or not _aligned(cost):  # the kernel reads 16-byte pieces of each row
        cost = torch.nn.functional.pad(cost, (0, -M % 4))
        M = cost.shape[2]
    warps, walks = dtw_warps(N), starts is not None or path is not None
    n_bytes = library().wtt_dtw_scratch_bytes(S, N, M, warps, int(walks))
    packed = torch.empty(n_bytes, dtype=torch.uint8, device=cost.device) if n_bytes > 0 else None
    _launch("dtw_codes", "wtt_dtw", cost.data_ptr(), dims.data_ptr(), _ptr(codes), _ptr(starts),
            _ptr(path), _ptr(packed), n_bytes, S, N, M, warps, _stream(cost),
            refused=f"{name} does not take N={N} M={M}")


def dtw_codes(cost, dims):
    """Batched DTW step codes (see ``dtw_codes_plain``). On CUDA: f32 cost
    (S, N, M) with N up to 1024, int32 dims (S, 4)."""
    name = "dtw_codes"
    if not _on_cuda(name, cost, dims):
        return dtw_codes_plain(cost, dims)
    S, N, M = cost.shape
    codes = torch.zeros((S, N + M + (-M % 4) - 1, N), dtype=torch.int32, device=cost.device)
    _dtw(name, cost, dims, codes=codes)
    return codes[:, : N + M - 1]


def dtw_starts(cost, dims):
    """Per-token start frames of each segment's DTW path (see
    ``dtw_starts_plain``): the DP and the walk back in one launch, the
    codes never leaving the block (or the L2). On CUDA: as ``dtw_codes``.
    Returns (S, N) int32."""
    name = "dtw_starts"
    if not _on_cuda(name, cost, dims):
        return dtw_starts_plain(cost, dims)
    S, N, M = cost.shape
    starts = torch.empty((S, N), dtype=torch.int32, device=cost.device)
    _dtw(name, cost, dims, starts=starts)
    return starts


def dtw_path(cost) -> Tuple[np.ndarray, np.ndarray]:
    """DTW path of one (n, m) cost (see ``dtw_path_plain``). On CUDA (f32,
    contiguous, n <= 1024) the kernel walks the path itself and only the
    path (at most n+m-1 pairs) is copied to the host. Returns (index1s,
    index2s) int64."""
    name = "dtw_path"
    if not _on_cuda(name, cost):
        return dtw_path_plain(cost)
    n, m = cost.shape
    D = n + m - 1
    dims = torch.tensor([[n, m, 0, 0]], dtype=torch.int32, device=cost.device)
    out = torch.empty(1 + 2 * D, dtype=torch.int32, device=cost.device)
    _dtw(name, cost[None], dims, path=out)
    host = out.cpu().numpy()
    first = int(host[0])
    return (host[1 + first : 1 + D].astype(np.int64), host[1 + D + first :].astype(np.int64))


def flash_attention(q, k, v, n_head: int, *, causal: bool = False, pad_len=None):
    """Multi-head attention that never materialises the scores (see
    ``flash_attention_plain`` for the function and its masks). On CUDA:
    bf16 q/k/v, head width 64, contiguous, 16-byte aligned; ``pad_len``
    int32 (B,) on the same device. Returns (B, Sq, D) bf16.

    Where autograd will need its gradient (grad mode on and an input that
    requires grad) it runs ``FlashAttentionFn`` instead: the training
    forward and backward kernels, f32 or bf16, no mask (a causal or padded
    call raises ``ValueError``: the prefill is never differentiated)."""
    name = "flash_attention"
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if causal or pad_len is not None:
            raise ValueError(f"{name}: no backward for causal or pad_len (the encoder's case only)")
        return FlashAttentionFn.apply(q, k, v, n_head)
    tensors = (q, k, v) if pad_len is None else (q, k, v, pad_len)
    if not _on_cuda(name, *tensors):
        return flash_attention_plain(q, k, v, n_head, causal=causal, pad_len=pad_len)
    _check_flash_masks(q, k, causal, pad_len)
    B, Sq, D = q.shape
    Bk, Sk, Dk = k.shape
    _expect(name, Bk == B and Dk == D and v.shape == k.shape, "shape mismatch")
    _expect(name, D == n_head * HEAD_DIM, f"head width must be {HEAD_DIM}, got D={D} H={n_head}")
    _expect(name, all(t.dtype == torch.bfloat16 for t in (q, k, v)), "q/K/V must be bf16")
    _expect(name, all(t.is_contiguous() for t in tensors), "inputs must be contiguous")
    _expect(name, _aligned(q, k, v), "inputs must be 16-byte aligned")
    _expect(name, Sq > 0 and Sk > 0 and B <= 65535 and n_head <= 65535, f"unsupported B={B} Sq={Sq} Sk={Sk}")
    if pad_len is not None:
        _expect(name, pad_len.dtype == torch.int32 and pad_len.shape == (B,), "pad_len must be int32 (B,)")
    out = torch.empty_like(q)
    _launch(name, "wtt_flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None, pad_len.data_ptr() if pad_len is not None else None,
            B, Sq, Sk, D, n_head, int(causal), HEAD_DIM**-0.5, _stream(q))
    return out


def _check_train_flash(name: str, q, k, v, n_head: int, *more) -> None:
    """What the training kernels take: (B, Sq, D) q and (B, Sk, D) k/v (and
    ``more`` of q's shape), all f32 or all bf16, head width 64, contiguous."""
    B, Sq, D = q.shape
    Bk, Sk, Dk = k.shape
    _expect(name, Bk == B and Dk == D and v.shape == k.shape
            and all(t.shape == q.shape for t in more), "shape mismatch")
    _expect(name, D == n_head * HEAD_DIM, f"head width must be {HEAD_DIM}, got D={D} H={n_head}")
    _expect(name, q.dtype in (torch.float32, torch.bfloat16)
            and all(t.dtype == q.dtype for t in (k, v, *more)), "inputs must be all f32 or all bf16")
    _expect(name, all(t.is_contiguous() for t in (q, k, v, *more)), "inputs must be contiguous")
    _expect(name, Sq > 0 and Sk > 0 and B <= 65535 and n_head <= 65535,
            f"unsupported B={B} Sq={Sq} Sk={Sk}")


def flash_attention_fwd(q, k, v, n_head: int):
    """The training forward (see ``flash_attention_fwd_plain``): out and the
    rows' log-sum-exp, which the backward reads. On CUDA: f32 or bf16
    q/k/v, head width 64, contiguous, 16-byte aligned (TMA reads them): one
    launch of ``flash_attention``'s kernel with its lse output for bf16, or
    for f32 a split pass and the 3xTF32 kernel (``csrc/flash_attn_fwd_lse.cu``).
    Returns (out (B, Sq, D) in q's dtype, lse (B, H, Sq) f32)."""
    name = "flash_attention_fwd"
    if not _on_cuda(name, q, k, v):
        return flash_attention_fwd_plain(q, k, v, n_head)
    _check_train_flash(name, q, k, v, n_head)
    return _flash_fwd(q, k, v, n_head)


def _flash_fwd(q, k, v, n_head: int):
    """One launch of the training forward on checked inputs (q, k and v,
    which it reads by TMA, 16-byte aligned: checked here): bf16 through
    ``flash_attention``'s entry point with an lse pointer and no mask; f32
    through ``wtt_flash_attention_fwd``, with the split pass's scratch (the
    tf32 hi and lo of K (B, Sk, D) and of V's transpose (B, D, Sk rounded up
    to 8))."""
    name = "flash_attention_fwd"
    _expect(name, _aligned(q, k, v), "inputs must be 16-byte aligned")
    B, Sq, D = q.shape
    Sk = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((B, n_head, Sq), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr())
    if q.dtype == torch.bfloat16:
        _launch(name, "wtt_flash_attention", *args, None, B, Sq, Sk, D, n_head, 0,
                HEAD_DIM**-0.5, _stream(q))
    else:
        Skp = -(-Sk // 8) * 8  # V's transpose's keys, padded as the C entry pads them
        split = torch.empty(2 * B * D * (Sk + Skp), dtype=torch.float32, device=q.device)
        _launch(name, "wtt_flash_attention_fwd", *args, split.data_ptr(), B, Sq, Sk, D, n_head,
                HEAD_DIM**-0.5, _stream(q))
    return out, lse


def _flash_bwd_dq(q, k, v, out, dout, lse, n_head: int):
    """dQ, and D = rowsum(dO∘O) (B, H, Sq) f32 for ``_flash_bwd_dkv``: one
    launch of ``csrc/flash_attn_bwd.cu``'s dQ kernel on checked inputs
    (q, dout, k and v, which it reads by TMA, 16-byte aligned: checked here)."""
    _expect("flash_attention_bwd_dq", _aligned(q, dout, k, v), "inputs must be 16-byte aligned")
    B, Sq, D = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty((B, n_head, Sq), dtype=torch.float32, device=q.device)
    _launch("flash_attention_bwd_dq", "wtt_flash_attention_bwd_dq", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), B, Sq, k.shape[1], D, n_head, int(q.dtype == torch.bfloat16),
            HEAD_DIM**-0.5, _stream(q))
    return dq, delta


def _flash_bwd_dkv(q, k, v, dout, lse, delta, n_head: int):
    """dK and dV: one launch of ``csrc/flash_attn_bwd.cu``'s dK/dV kernel
    on checked inputs (k, v, q and dout, which it reads by TMA, 16-byte
    aligned: checked here), reading the dQ launch's D."""
    _expect("flash_attention_bwd_dkv", _aligned(k, v, q, dout), "inputs must be 16-byte aligned")
    B, Sq, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_attention_bwd_dkv", "wtt_flash_attention_bwd_dkv", q.data_ptr(),
            k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Sq, k.shape[1], D, n_head,
            int(q.dtype == torch.bfloat16), HEAD_DIM**-0.5, _stream(q))
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, n_head: int):
    """The training backward (see ``flash_attention_bwd_plain``) from the
    forward's out and lse. On CUDA (inputs as ``flash_attention_fwd``'s, out
    and dout of q's shape and dtype, lse f32 (B, H, Sq); q, k, v and dout
    16-byte aligned, as TMA needs): two launches, dQ (which also writes
    D = rowsum(dO∘O)) then dK/dV, each walking the other side's tiles on
    wgmma (bf16 products for bf16 inputs, 3xTF32 for f32); no atomics, so
    the result is the same run to run.
    Returns (dq, dk, dv) in the inputs' dtype."""
    name = "flash_attention_bwd"
    if not _on_cuda(name, q, k, v, out, lse, dout):
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, n_head)
    _check_train_flash(name, q, k, v, n_head, out, dout)
    B, Sq, _ = q.shape
    _expect(name, lse.dtype == torch.float32 and lse.shape == (B, n_head, Sq)
            and lse.is_contiguous(), "lse must be contiguous f32 (B, H, Sq)")
    dq, delta = _flash_bwd_dq(q, k, v, out, dout, lse, n_head)
    return (dq, *_flash_bwd_dkv(q, k, v, dout, lse, delta, n_head))


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` without a mask, with its gradient: the forward
    saves q, k, v, out and lse (``flash_attention_fwd``), the backward is
    ``flash_attention_bwd``; the library kernel's ``custom_vjp``
    (``flash_attention.py:204``, ``:318``). For CPU tensors both directions
    take the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, n_head: int):
        out, lse = flash_attention_fwd(q, k, v, n_head)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.n_head = n_head
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, lse, dout.contiguous(), ctx.n_head), None)


def _quantized_xattn(name, fn_name, frames_per_row, q, xk_all, xk_scale, xv_all, xv_scale,
                     layer, n_head, emit_scores, beam_group):
    """Check the int8 (1 frame a row) or int4 (2 frames a row) cross-attention
    inputs and launch the kernel, split over its rows as ``xattn_decode``
    is split over T (the int4 kernel over the T/2 packed rows)."""
    B, S, D = q.shape
    L, B_kv, R, Dk = xk_all.shape
    T = xk_scale.shape[-1]
    _expect(name, S == 1 and Dk == D and xv_all.shape == xk_all.shape, "shape mismatch")
    _expect(name, xk_scale.shape == (L, B_kv, T) and xv_scale.shape == xk_scale.shape,
            f"scales must be (L, B_kv, T), got {tuple(xk_scale.shape)} and {tuple(xv_scale.shape)}")
    _expect(name, T == frames_per_row * R,
            f"T={T} scales for {R} rows: int4 needs an even frame count, twice the packed rows"
            if frames_per_row == 2 else f"T={T} scales for {R} rows")
    _expect(name, D == n_head * HEAD_DIM, f"head width must be {HEAD_DIM}, got D={D} H={n_head}")
    _expect(name, q.dtype == torch.bfloat16, "q must be bf16")
    _expect(name, xk_all.dtype == torch.int8 and xv_all.dtype == torch.int8, "K/V must be int8")
    _expect(name, xk_scale.dtype == torch.float32 and xv_scale.dtype == torch.float32,
            "scales must be f32")
    tensors = (q, xk_all, xk_scale, xv_all, xv_scale)
    _expect(name, all(t.is_contiguous() for t in tensors), "inputs must be contiguous")
    _expect(name, _aligned(*tensors), "inputs must be 16-byte aligned")
    _expect(name, B == B_kv * beam_group, f"B={B} != B_kv={B_kv} * beam_group={beam_group}")
    _expect(name, 0 <= layer < L and 0 < T <= MAX_T, f"layer {layer} / T {T} out of range")
    _expect(name, B <= 65535 and n_head <= 65535, f"unsupported B={B} H={n_head}")
    out = torch.empty_like(q)
    scores = (
        torch.empty((B, n_head, 1, T), dtype=torch.float32, device=q.device)
        if emit_scores else None
    )
    _launch(name, fn_name, q.data_ptr(), xk_all.data_ptr(), xk_scale.data_ptr(),
            xv_all.data_ptr(), xv_scale.data_ptr(), out.data_ptr(), _ptr(scores), layer, B, B_kv,
            T, D, n_head, beam_group, *_grid(q, B, n_head, R, frames_per_row), HEAD_DIM**-0.5,
            _stream(q))
    return out, scores


def xattn_decode_int8(q, xk_all, xk_scale, xv_all, xv_scale, layer: int, n_head: int,
                      emit_scores: bool = False, beam_group: int = 1
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Cross-attention of one decode step over layer ``layer`` of the
    stacked int8 encoder K/V with per-frame scales (see
    ``xattn_decode_int8_plain``). On CUDA: bf16 q, int8 K/V, f32 scales,
    head width 64, contiguous; scores are written only when
    ``emit_scores``. The kernel splits T across blocks as ``xattn_decode``
    does."""
    name = "xattn_decode_int8"
    if not _on_cuda(name, q, xk_all, xk_scale, xv_all, xv_scale):
        return xattn_decode_int8_plain(q, xk_all, xk_scale, xv_all, xv_scale, layer, n_head,
                                       emit_scores, beam_group)
    return _quantized_xattn(name, "wtt_xattn_decode_int8", 1, q, xk_all, xk_scale, xv_all,
                            xv_scale, layer, n_head, emit_scores, beam_group)


def xattn_decode_int4(q, xk_all, xk_scale, xv_all, xv_scale, layer: int, n_head: int,
                      emit_scores: bool = False, beam_group: int = 1
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The same over nibble-packed int4 K/V (L, B_kv, T/2, D) int8 with
    parity-major scales (L, B_kv, T) (see ``xattn_decode_int4_plain``);
    scores (B, H, 1, T) in frame order. The kernel splits the T/2 packed
    rows across blocks as ``xattn_decode`` splits T."""
    name = "xattn_decode_int4"
    if not _on_cuda(name, q, xk_all, xk_scale, xv_all, xv_scale):
        return xattn_decode_int4_plain(q, xk_all, xk_scale, xv_all, xv_scale, layer, n_head,
                                       emit_scores, beam_group)
    return _quantized_xattn(name, "wtt_xattn_decode_int4", 2, q, xk_all, xk_scale, xv_all,
                            xv_scale, layer, n_head, emit_scores, beam_group)


def self_attn_decode_int8(q, k_new, v_new, k_all, k_scale, v_all, v_scale, layer: int,
                          pos, pad_len, n_head: int, extent: Optional[int] = None,
                          row_scales: Optional[torch.Tensor] = None):
    """Write this step's new self-attention rows k_new/v_new (B, 1, D) into
    slot ``pos`` of layer ``layer`` of the int8 cache, quantized as
    ``quantize_rows`` does (codes and scales, in place), then attend over
    the live slots [min(pad_len[b], pos), pos] of the first ``extent`` (see
    ``self_attn_decode_int8_plain``; ``pos`` and ``extent`` as
    ``self_attn_decode`` takes them). On CUDA one launch does both: bf16
    q/k_new/v_new, int8 cache (L, B, ctx, D), f32 scales (L, B, ctx), int32
    ``pad_len``, head width 64, contiguous; the kernel splits the extent's
    slots across blocks as ``self_attn_decode`` does. For CPU tensors the
    plain quantizer writes the rows and the plain version attends.

    ``row_scales`` (2, B) f32, K's then V's: the rows' scales, given (a
    tensor-parallel rank holds D/tp columns of a row whose scale is the
    whole row's, ``quant.row_scales``); the codes are written with them.
    On CUDA that is the kernel's scales-given instance, counted as
    ``self_attn_decode_int8_scaled``."""
    name = "self_attn_decode_int8" if row_scales is None else "self_attn_decode_int8_scaled"
    slot = step_slot(pos, q.device)
    T = _extent(pos, extent, k_all.shape[2])
    tensors = (q, k_new, v_new, k_all, k_scale, v_all, v_scale, pad_len)
    given = () if row_scales is None else (row_scales,)
    if not _on_cuda(name, *tensors, *given, slot):
        write_quantized_row(k_new, v_new, k_all, k_scale, v_all, v_scale, layer, slot, row_scales)
        return self_attn_decode_int8_plain(q, k_all, k_scale, v_all, v_scale, layer, slot,
                                           pad_len, n_head, T)
    B, S, D = q.shape
    L, Bk, ctx, Dk = k_all.shape
    _expect(name, S == 1 and Bk == B and Dk == D and v_all.shape == k_all.shape
            and k_new.shape == q.shape and v_new.shape == q.shape, "shape mismatch")
    _expect(name, k_scale.shape == (L, B, ctx) and v_scale.shape == k_scale.shape,
            "scales must be (L, B, ctx)")
    _expect(name, D == n_head * HEAD_DIM, f"head width must be {HEAD_DIM}, got D={D} H={n_head}")
    _expect(name, all(t.dtype == torch.bfloat16 for t in (q, k_new, v_new)),
            "q/k_new/v_new must be bf16")
    _expect(name, k_all.dtype == torch.int8 and v_all.dtype == torch.int8, "K/V cache must be int8")
    _expect(name, k_scale.dtype == torch.float32 and v_scale.dtype == torch.float32,
            "scales must be f32")
    _expect(name, pad_len.dtype == torch.int32 and pad_len.shape == (B,), "pad_len must be int32 (B,)")
    _check_slot(name, pos, slot, T)
    _expect(name, all(t.is_contiguous() for t in tensors), "inputs must be contiguous")
    _expect(name, _aligned(q, k_new, v_new, k_all, k_scale, v_all, v_scale),
            "inputs must be 16-byte aligned")
    _expect(name, 0 <= layer < L and 0 < T <= min(ctx, MAX_T), f"layer {layer} / extent {T} out of range")
    _expect(name, B <= 65535 and n_head <= 65535, f"unsupported B={B} H={n_head}")
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_all.data_ptr(), k_scale.data_ptr(),
            v_all.data_ptr(), v_scale.data_ptr(), out.data_ptr(), pad_len.data_ptr(),
            slot.data_ptr())
    tail = (layer, B, ctx, D, n_head, *_grid(q, B, n_head, T), HEAD_DIM**-0.5, _stream(q))
    if row_scales is None:
        _launch(name, "wtt_self_attn_decode_int8", *ptrs, *tail)
    else:
        _expect(name, row_scales.shape == (2, B) and row_scales.dtype == torch.float32
                and row_scales.is_contiguous(), "row_scales must be contiguous f32 (2, B)")
        _launch(name, "wtt_self_attn_decode_int8_scaled", *ptrs, row_scales.data_ptr(), *tail)
    return out


# the FFT's passes, taken greedily in this order: an odd first pass reads
# the staged samples itself (csrc/log10_mel.cu), so 5 and 3 come first
MEL_RADICES = (5, 3, 8, 4, 2)
# a bin whose FFT power is below this share of its frame's largest is
# recomputed by the plain version's sums (csrc/log10_mel.cu, "Refinement")
MEL_REFINE_BELOW = 1e-6


@functools.lru_cache(maxsize=None)
def mel_fft_plan(n_fft: int) -> Tuple[Tuple[int, ...], np.ndarray, np.ndarray]:
    """(radices, twiddles, window) of ``log10_mel``'s real FFT of n_fft
    samples, taken as an N = n_fft / 2-point complex FFT of the frame's
    (even, odd) sample pairs: the radices of its Stockham passes (each 5,
    3, 8, 4 or 2, greedily in that order; their product N), whose output is
    in natural bin order; the twiddles exp(-2 pi i m / n_fft) for m < n_fft,
    (n_fft, 2) as (cos, -sin); the periodic Hann window (n_fft). Both are
    computed in float64 and rounded to float32 (the window equals column 0
    of ``audio._dft_bases``' cos basis). Pass s (after passes whose
    radices multiply to ns) twiddles element r of butterfly j by
    twiddles[(j mod ns) r n_fft / (ns R)]; the split into the real signal's
    bins uses twiddles[k]. Raises ``ValueError`` unless n_fft is an even
    2^a 3^b 5^c of at least 4."""
    if n_fft < 4 or n_fft % 2:
        raise ValueError(f"log10_mel: no FFT plan for n_fft={n_fft} (an even 2^a 3^b 5^c)")
    radices, rest = [], n_fft // 2
    for r in MEL_RADICES:
        while rest % r == 0:
            radices.append(r)
            rest //= r
    if rest != 1:
        raise ValueError(f"log10_mel: no FFT plan for n_fft={n_fft} (an even 2^a 3^b 5^c)")
    angle = 2.0 * np.pi * np.arange(n_fft) / n_fft
    twiddles = np.stack([np.cos(angle), -np.sin(angle)], -1).astype(np.float32)
    return tuple(radices), twiddles, (0.5 * (1.0 - np.cos(angle))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _mel_plan_tensors(n_fft: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    _, twiddles, window = mel_fft_plan(n_fft)
    return torch.as_tensor(twiddles, device=device), torch.as_tensor(window, device=device)


def log10_mel(x, cos_b, sin_b, mel_w, hop: int):
    """log10 mel spectrogram of reflect-padded audio (see
    ``log10_mel_plain``), framed by the kernel itself. On CUDA the kernel
    takes the frames' real FFT (``mel_fft_plan``: its twiddles and window)
    in place of the DFT product, and recomputes the bins below
    MEL_REFINE_BELOW of their frame's largest power from cos_b and sin_b
    as the plain version sums them. f32, contiguous, n_fft an even
    2^a 3^b 5^c whose tables and buffers fit in a block's shared memory,
    hop a multiple of 4, at least one frame;
    anything else raises ``ValueError`` (the kernel's entry point refuses
    what does not fit). Returns (B, n_mels, n_frames) f32, contiguous."""
    name = "log10_mel"
    if not _on_cuda(name, x, cos_b, sin_b, mel_w):
        return log10_mel_plain(x, cos_b, sin_b, mel_w, hop)
    tensors = (x, cos_b, sin_b, mel_w)
    _expect(name, all(t.dtype == torch.float32 for t in tensors), "inputs must be f32")
    _expect(name, all(t.is_contiguous() for t in tensors), "inputs must be contiguous")
    _expect(name, x.ndim == 2 and cos_b.shape == sin_b.shape and mel_w.shape[1] == cos_b.shape[1],
            f"shape mismatch: x {tuple(x.shape)}, bases {tuple(cos_b.shape)}, "
            f"mel_w {tuple(mel_w.shape)}")
    B, L = x.shape
    n_fft, n_bins = cos_b.shape
    n_mels = mel_w.shape[0]
    _expect(name, n_bins == n_fft // 2 + 1, f"bases of {n_bins} bins for n_fft={n_fft}")
    radices = mel_fft_plan(n_fft)[0]
    n_frames = (L - n_fft) // hop if L >= n_fft and hop > 0 else 0
    _expect(name, n_frames > 0 and B > 0 and n_mels > 0,
            f"unsupported B={B} L={L} n_mels={n_mels} hop={hop}")
    out = torch.empty((B, n_mels, n_frames), dtype=torch.float32, device=x.device)
    twiddles, window = _mel_plan_tensors(n_fft, x.device)
    bases_t = torch.stack((cos_b.T, sin_b.T))  # (2, n_bins, n_fft): a bin's basis contiguous
    _launch(name, "wtt_log10_mel", x.data_ptr(), twiddles.data_ptr(), window.data_ptr(),
            cos_b.data_ptr(), sin_b.data_ptr(), bases_t.data_ptr(), mel_w.data_ptr(), out.data_ptr(),
            (ctypes.c_int * len(radices))(*radices), len(radices), B, L, n_fft, n_bins, n_mels,
            hop, MEL_REFINE_BELOW, _stream(x),
            refused=f"unsupported n_fft={n_fft} hop={hop} n_mels={n_mels} (hop a multiple of 4, "
                    "the tables and buffers within a block's shared memory)")
    return out


MATMUL_TILE = 64  # output features a block, and k a tile
MATMUL_COLS = (8, 16, 32, 64, 128, 256)  # the batch widths a block is built for (wgmma's N)
MATMUL_MAX_SPLITS = 8  # the k-splits of a tile merge in one (portable) block cluster
MATMUL_MAX_ROWS = 256 * 65535  # the rows of x one launch takes (65535 column groups)


def matmul_split(B: int, N: int, K: int, n_sm: int) -> Tuple[int, int, int]:
    """(n_split, cols, groups) of ``stacked_matmul``'s grid: B is cut into
    ``groups`` column groups of at most 256, each run by blocks built for
    ``cols`` batch columns (the group rounded up to one of MATMUL_COLS); a
    block owns 64 output features and one of ``n_split`` ranges of the
    whole 64-wide k-tiles, split s taking tiles [s T / n_split, (s + 1) T /
    n_split) of T. K is split only while the ceil(N / 64) * groups blocks
    leave multiprocessors idle, into the fewest splits that give every one
    a block (at most MATMUL_MAX_SPLITS and T): more splits only add merge
    work (tools/torch_kernel_sweeps.py ``matmul``)."""
    groups = -(-B // 256)
    per = -(-B // groups)
    cols = next(c for c in MATMUL_COLS if c >= per)
    blocks = -(-N // MATMUL_TILE) * groups
    k_tiles = -(-K // MATMUL_TILE)
    return max(1, min(-(-n_sm // blocks), k_tiles, MATMUL_MAX_SPLITS)), cols, groups


def stacked_matmul(x, w_all, layer: int):
    """x (B, K) @ w_all[layer]^T without a copy of the layer's slice (see
    ``stacked_matmul_plain``). On CUDA: bf16, contiguous, 16-byte aligned,
    K a multiple of 8; any B >= 1 (a launch for each MATMUL_MAX_ROWS rows)
    and N up to 16 * 65535. Returns (B, N) bf16."""
    name = "stacked_matmul"
    if not _on_cuda(name, x, w_all):
        return stacked_matmul_plain(x, w_all, layer)
    _expect(name, x.dtype == torch.bfloat16 and w_all.dtype == torch.bfloat16, "x/w_all must be bf16")
    _expect(name, x.is_contiguous() and w_all.is_contiguous(), "inputs must be contiguous")
    _expect(name, _aligned(x, w_all), "inputs must be 16-byte aligned")
    B, K = x.shape
    L, N, Kw = w_all.shape
    _expect(name, Kw == K, f"x (B, {K}) against w_all (L, N, {Kw})")
    _expect(name, K % 8 == 0 and 0 < K and 0 < B and 0 < N <= 16 * 65535,
            f"unsupported B={B} N={N} K={K}")
    _expect(name, 0 <= layer < L, f"layer {layer} out of range")
    out = torch.empty((B, N), dtype=torch.bfloat16, device=x.device)
    for b0 in range(0, B, MATMUL_MAX_ROWS):  # the grid's column groups stop at 65535
        rows = min(B - b0, MATMUL_MAX_ROWS)
        n_split, cols, groups = matmul_split(rows, N, K, _sm_count(x.device))
        _launch(name, "wtt_stacked_matmul", x[b0:].data_ptr(), w_all.data_ptr(),
                out[b0:].data_ptr(), layer, L, rows, N, K, cols, groups, n_split, _stream(x))
    return out
