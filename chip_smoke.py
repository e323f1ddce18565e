#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing a line; any failure exits non-zero (at once, or, for
``log10_mel``'s agreement with its plain version in (c), after the later
phases have run, so their lines are printed too):

  (a) device check: fails without CUDA; prints ``nvidia-smi``'s name and
      power limit of the card;
  (b) builds the CUDA kernels of ``whisper_timestamped_tpu_torch/csrc``
      with nvcc (into ``build/``) and prints the build seconds;
  (c) runs each kernel against its plain PyTorch version on the card at the
      shapes of the large-v3 main path, with the stated tolerances, and
      times both, and the one PyTorch call that computes the same function
      where there is one, with CUDA events; computes each kernel's bound
      (the least time the H100's published rates allow for its inputs);
  (d) answers three requests (7 s, 12 s and 35 s of seeded noise-plus-tone
      audio) through ``transcribe_timestamped`` with a large-v3-geometry
      model of seeded random bf16 weights, checks the results' schema, and
      checks that the serial path launched every kernel (launch counters
      reset just before, read just after);
  (e) checks one decode step and one encode of that model against the same
      with the plain versions in place of the kernels (the encode layer by
      layer, and as a whole norm-wise), and times the encoder at B=1 and B=8
      through the kernel and through the plain attention math (with the
      peak memory of each);
  (f) batched serving: ``transcribe_batch_stream`` over two batches of 8
      streams (5-35 s of seeded audio, one 35 s stream in each) at B=8,
      checks each result's schema, checks that the stream's results equal
      ``transcribe_batch`` on each batch alone (segment tokens), and checks
      that the batched path launched every kernel, ``flash_attention`` at
      least 32 times per window iteration (counters reset just before the
      stream, read just after);
  (g) the production configuration: ``transcribe_batch_stream`` over two
      batches of 40 streams (5-35 s, five 35 s streams each) at B=40 with a
      ``kv_int8`` engine, then with a bf16 engine on the same streams: wall
      time, audio-s per s, ms/step, peak memory and words of each; fails
      unless every stream of the int8 run has words, ``xattn_decode_int8``
      launched at least 32 times per decode step and ``xattn_decode`` never;
  (h) one batch of 8 streams with a ``kv_int4`` + ``self_kv_int8`` engine
      (with its ms/step), and one serial 35 s request with
      ``WTT_KV_INT8=1``: the schema, the levers' kernels launched (the
      engine's at least 32 times a step), the bf16 kernels they replace
      never;
  (i) alignment outside the batched device aligner, on the large-v3 model
      with no known alignment heads (120): three serial requests with
      ``detect_disfluencies`` through the per-segment kernels
      (``attention_to_cost`` and ``dtw_codes`` once per aligned segment,
      ``align_cost`` never), the 12 s one again through the numpy route
      (``device_alignment=False``, the same words within 0.02 s) and with
      ``trust_whisper_timestamps=False``, the 10-head model with
      disfluencies (the batched aligner fetching its cost rows), and a
      ``transcribe_batch`` of 8 streams with 120 heads (host route);
  (j) the command line on the card: a large-v3-geometry OpenAI checkpoint
      of the seeded weights (with its ``.tiktoken`` vocabulary) written to a
      directory under ``build/``, then ``cli.main`` in-process on three WAVs
      (7, 12 and 35 s, the 12 s one at 44.1 kHz so the resampler runs),
      ``--batch_size 8`` on eight more (5-35 s), one run in a subprocess
      with JAX made unimportable, and the subtitle tool on a words JSON:
      six formats per input, the schema, the serial run's kernels
      (``log10_mel`` and the bf16 path's five), the batched run's tokens
      equal to ``transcribe_batch`` on the same files;
  (k) sampling, the temperature fallback and the two-pass engine: the
      sampler's frequencies on a (40, 51866) logits batch against the
      softmax at T = 0.2 and 1.0, and its time a step at B = 1, 8, 40; a
      serial 30 s request through the schedule (0.0, 0.2, 0.4) with
      quality thresholds that random weights fail (every bf16-path kernel
      launched; the same seed repeats its tokens, another does not); a
      ``transcribe_batch`` of 8 streams at B=8 with the fallback re-decode
      and with ``best_of=2`` (``align_cost``/``dtw_codes`` launched); the
      two-pass engine with ``best_of=2`` on a 35 s request (``log10_mel``
      and ``flash_attention`` launched in its second pass);
  (l) beam search: a serial 30 s request with the ``--accurate`` options
      (beam 5) and no thresholds, then ``transcribe_batch`` with beam 5 on
      eight 5-30 s streams at B=8 (40 beam rows over 8 cross-KV rows) with
      a bf16 and a ``kv_int8`` engine: the launches (the cross-attention
      kernel 32 times a decode step), the cross K/V untiled (seen at every
      decode step), s/request, s/batch, ms/step, peak memory; the self-KV
      reorder timed alone; a ``beam_size=1`` decode equal to greedy;
  (m) fine-tuning at large-v3 width: ``training.make_train_step`` (AdamW,
      optax's ``adamw(1e-5)``) on seeded f32 weights and one fixed batch
      (two 30 s windows, 224 tokens a row): one step's loss and gradients
      through the training flash kernels against the plain versions, then
      a warm step and five timed steps: the losses finite and falling, each
      training kernel launched once a layer a step and the inference flash
      kernel never; ms/step and peak memory; one step traced by
      torch.profiler (device busy as the union of the kernels' intervals,
      the flash kernels' share); and the step
      with each layer read as ``w[l]`` instead of ``unbind``.

(c) holds ``self_attn_decode`` at B=1, 8 and 40 over slots 0-455 and pad
lengths 0, 5, 224 and 300, its fused row write bit for bit, and times it
with the row write at pos 232 and 455 beside SDPA over the live slots; it
times ``xattn_decode_int8`` at B=1, 8 and 40 beside the bf16 kernel,
``xattn_decode_int4`` at the same batches beside the int8 kernel, and
``self_attn_decode_int8`` with its quantized row write at B=1, 8 and 40
and pos 232 and 455 beside ``self_attn_decode`` with its write, each with
its grid and bound. It covers the per-segment route's ``attention_to_cost``,
``median9`` and ``dtw_path`` (``dtw_codes.cu``'s DP and walk at S=1), the
whole batched aligner at (g)'s flush shape against the old path (window
copies, codes, a Python backtrace) with the DTW's chain floor,
``log10_mel`` on (g)'s stack of 40 streams and on a 10-minute stream
against its plain version and a float64 FFT of the same frames (the
witness), beside the same function as several library calls (cuFFT's
STFT, power, mel product, log10), with the peak memory of the front end
through the kernel and through its plain version, and ``stacked_matmul``
at decode shapes beside ``F.linear``, ``xattn_decode`` and
``xattn_decode_int8`` as beam search runs them (B=40 over 8 K/V rows,
``beam_group=5``, no scores) beside the same kernel over 40 rows, with the
shared-read bound, the training flash kernels (the forward with lse, dQ
and dK/dV) in f32 and bf16 at the encoder's shape (B=2, T=1500) and at
ragged T, beside their plain versions and SDPA's forward and backward (the
backward and its plain version also against a float64 backward), and
(e) the decode step
with the int8 and int4 cross K/V and the int8 self cache. The kernels' JSON
record takes each kernel's launches from the phase that runs it: the bf16
path's from (f), ``xattn_decode_int8`` from (g), the int4 and int8-self
kernels from (h), ``attention_to_cost`` from (i), ``log10_mel`` from (j),
the training kernels from (m)'s timed steps; ``median9`` and
``stacked_matmul``, which no path runs, from their checks in (c).

``--profile`` adds a torch.profiler trace of one window decoded to 64 tokens,
at B=1, at B=8 and at B=40 (bf16 and ``kv_int8``), and prints the device's
busy share and the kernels that fill it.
``--compare`` adds (d) with the plain attention math of the encoder and the
prefill (the path before the flash kernel) in turns with the kernel path:
plain, kernel, kernel, plain.
``--turns`` runs (g)'s engines in turns (kv_int8, bf16, bf16, kv_int8);
``--kernels-only`` stops after (c) (a first check of changed kernels; it
prints no result line).

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX, and makes any
import of it (or of optax and orbax, its optimizer and checkpoint
libraries) fail.
"""

import contextlib
import importlib.abc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time


class _RefuseJax(importlib.abc.MetaPathFinder):
    """The port must never reach for JAX: importing it raises. (A finder,
    not ``sys.modules["jax"] = None``, which scipy's resampler trips on.)"""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "optax", "orbax"):
            raise ImportError(f"chip_smoke: the port imported {name}")
        return None


sys.meta_path.insert(0, _RefuseJax())

# large-v3 geometry (whisper's published ModelDimensions)
LARGE_V3 = dict(n_mels=128, n_audio_ctx=1500, n_audio_state=1280, n_audio_head=20,
                n_audio_layer=32, n_vocab=51866, n_text_ctx=448, n_text_state=1280,
                n_text_head=20, n_text_layer=32)
SOURCES = {
    "xattn_decode": ("whisper_timestamped_tpu_torch/csrc/xattn_decode.cu",
                     "whisper_timestamped_tpu/ops/pallas_kernels.py:854"),
    "self_attn_decode": ("whisper_timestamped_tpu_torch/csrc/self_attn_decode.cu",
                         "whisper_timestamped_tpu/ops/pallas_kernels.py:2088"),
    "align_cost": ("whisper_timestamped_tpu_torch/csrc/align_cost.cu",
                   "whisper_timestamped_tpu/ops/pallas_kernels.py:395"),
    "dtw_codes": ("whisper_timestamped_tpu_torch/csrc/dtw_codes.cu",
                  "whisper_timestamped_tpu/ops/pallas_kernels.py:477"),
    "flash_attention": ("whisper_timestamped_tpu_torch/csrc/flash_attn.cu",
                        "whisper_timestamped_tpu/models/whisper_jax.py:246"),
    "xattn_decode_int8": ("whisper_timestamped_tpu_torch/csrc/xattn_decode_int8.cu",
                          "whisper_timestamped_tpu/ops/pallas_kernels.py:1051"),
    "xattn_decode_int4": ("whisper_timestamped_tpu_torch/csrc/xattn_decode_int4.cu",
                          "whisper_timestamped_tpu/ops/pallas_kernels.py:1876"),
    "self_attn_decode_int8": ("whisper_timestamped_tpu_torch/csrc/self_attn_decode_int8.cu",
                              "whisper_timestamped_tpu/ops/pallas_kernels.py:2205"),
    "attention_to_cost": ("whisper_timestamped_tpu_torch/csrc/align_cost.cu",
                          "whisper_timestamped_tpu/ops/pallas_kernels.py:165"),
    "median9": ("whisper_timestamped_tpu_torch/csrc/median9.cu",
                "whisper_timestamped_tpu/ops/pallas_kernels.py:114"),
    "log10_mel": ("whisper_timestamped_tpu_torch/csrc/log10_mel.cu",
                  "whisper_timestamped_tpu/ops/pallas_kernels.py:528"),
    "stacked_matmul": ("whisper_timestamped_tpu_torch/csrc/stacked_matmul.cu",
                       "whisper_timestamped_tpu/ops/pallas_kernels.py:2427"),
    # the library flash kernel's training path (training.py:52 differentiates
    # encode through it): the forward with residuals and the two backward kernels
    "flash_attention_fwd": ("whisper_timestamped_tpu_torch/csrc/flash_attn_fwd_lse.cu",
                            "jax/experimental/pallas/ops/tpu/flash_attention.py:234"),
    "flash_attention_bwd_dkv": ("whisper_timestamped_tpu_torch/csrc/flash_attn_bwd.cu",
                                "jax/experimental/pallas/ops/tpu/flash_attention.py:941"),
    "flash_attention_bwd_dq": ("whisper_timestamped_tpu_torch/csrc/flash_attn_bwd.cu",
                               "jax/experimental/pallas/ops/tpu/flash_attention.py:1287"),
}
# the training path's kernels ([m])
TRAIN_PATH = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
# the kernels of the bf16 path ([d], [f]); the other three read quantized caches
BF16_PATH = ("xattn_decode", "self_attn_decode", "align_cost", "dtw_codes", "flash_attention")
QUANT_PATH = ("xattn_decode_int8", "xattn_decode_int4", "self_attn_decode_int8")
# the self-attention checks' pad_len values: 224 leaves the splits below it
# empty, 300 lies past most positions (only the query's own slot is live)
SELF_PADS = (0, 5, 224, 300)
# the H100 SXM's published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12


def bound(bytes_moved: float, flops: float, peak_flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / peak_flops
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_time_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after a warm-up. The
    timed calls queue behind a ~30 ms device sleep, so a kernel shorter than
    the host's ~20 us a call is timed back to back, not at the host's pace."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    e0.record()
    for it in range(iters):
        fn(it)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def ptxas_usage(log: str):
    """(kernel, "registers ...; spills ...") for each entry function in the
    ``-Xptxas -v`` report of the build log."""
    out, entry, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and entry:
            out.append((entry, ln.split(":", 1)[1].strip() + "; " + spill))
            entry, spill = None, ""
    return out


def heads_view(x, H):
    """(B, S, H*64) -> (B, H, S, 64) view, the layout of
    ``scaled_dot_product_attention``."""
    return x.view(x.shape[0], x.shape[1], H, 64).transpose(1, 2)


def flash_bwd_float64(torch, q, k, v, dout, H):
    """(dq, dk, dv) (B, S, H*64) float64 of attention without a mask, worked
    by its formulas in float64 from the same inputs: the judge of both the
    backward kernels and their plain version (which works in f32)."""
    B, _, D = q.shape
    qh, kh, vh, doh = (heads_view(x, H).double() for x in (q, k, v, dout))
    p = torch.softmax(qh @ kh.transpose(-1, -2) * 64**-0.5, dim=-1)
    dv = p.transpose(-1, -2) @ doh
    ds = p * (doh @ vh.transpose(-1, -2) - (doh * (p @ vh)).sum(-1, keepdim=True))
    merge = lambda x: x.transpose(1, 2).reshape(B, -1, D)  # noqa: E731
    return merge(ds @ kh * 64**-0.5), merge(ds.transpose(-1, -2) @ qh * 64**-0.5), merge(dv)


def phase_kernels(torch, K, device):
    """(c): every kernel against its plain version at main-path shapes.
    Returns the kernels' records and the bf16 decode attentions' times, to
    print beside the quantized kernels': ``xattn_decode``'s by batch (without,
    with scores) under "xattn", ``self_attn_decode``'s with the row write by
    (batch, pos) under "self"."""
    from whisper_timestamped_tpu_torch.device_align import M_PAD

    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=device).manual_seed(0)
    rec = {}
    L, T, D, H = 32, 1500, 1280, 20

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)

    # --- xattn_decode: B in {1, 4}, with/without scores, beam_group 2 ---
    err_out = err_sc = 0.0
    for B, beam_group, emit in ((1, 1, True), (1, 1, False), (4, 1, True), (4, 2, True)):
        q = randn(B, 1, D)
        xk, xv = randn(L, B // beam_group, T, D), randn(L, B // beam_group, T, D)
        for layer in (0, 31):
            o_k, s_k = K.xattn_decode(q, xk, xv, layer, H, emit_scores=emit, beam_group=beam_group)
            torch.cuda.synchronize()
            o_p, s_p = K.xattn_decode_plain(q, xk, xv, layer, H, emit_scores=emit, beam_group=beam_group)
            err_out = max(err_out, (o_k.float() - o_p.float()).abs().max().item())
            if emit:
                err_sc = max(err_sc, (s_k - s_p).abs().max().item())
            elif s_k is not None:
                fail("xattn_decode wrote scores it was not asked for")
        del xk, xv
    # the main path's batches: serial (B=1), [f] (B=8), [g]'s bf16 engine
    # (B=40); the layer cycles over all 32 (it % L), so K/V come from HBM
    bf16_ms = {}  # B -> (ms without, with scores), for the int8 kernel's line
    for B in (1, 8, 40):
        q = randn(B, 1, D)
        xk, xv = randn(L, B, T, D), randn(L, B, T, D)
        for layer, emit in ((0, True), (31, False)):
            o_k, s_k = K.xattn_decode(q, xk, xv, layer, H, emit_scores=emit)
            torch.cuda.synchronize()
            o_p, s_p = K.xattn_decode_plain(q, xk, xv, layer, H, emit_scores=emit)
            err_out = max(err_out, (o_k.float() - o_p.float()).abs().max().item())
            if emit:
                err_sc = max(err_sc, (s_k - s_p).abs().max().item())
            del o_k, s_k, o_p, s_p
        if not (err_out <= 2e-2 and err_sc <= 1e-3):
            fail(f"xattn_decode disagrees: out {err_out:.3g} (atol 2e-2), scores {err_sc:.3g} "
                 f"(atol 1e-3)")
        ms = cuda_time_ms(lambda it=0: K.xattn_decode(q, xk, xv, it % L, H, emit_scores=True))
        ms_ns = cuda_time_ms(lambda it=0: K.xattn_decode(q, xk, xv, it % L, H))
        plain_ms = cuda_time_ms(lambda it=0: K.xattn_decode_plain(q, xk, xv, it % L, H), iters=10)
        # the library call computes the output only (no scores): beside ms_ns
        lib_ms = cuda_time_ms(lambda it=0: sdpa(heads_view(q, H), heads_view(xk[it % L], H),
                                                heads_view(xv[it % L], H)))
        kv_bytes = 2 * B * T * D * 2 + 2 * B * D * 2
        b_ms, b_by = bound(kv_bytes, 4 * B * T * D, F32_FLOPS)
        bs_ms, _ = bound(kv_bytes + B * H * T * 4, 4 * B * T * D, F32_FLOPS)
        print(f"[c] xattn_decode B={B} L=32 T=1500 D=1280 H=20: {ms_ns:.4f} ms without scores "
              f"(bound {b_ms:.4f} ms, {b_by}), sdpa (output only) {lib_ms:.4f} ms; {ms:.4f} ms "
              f"with scores (bound {bs_ms:.4f} ms); plain {plain_ms:.4f} ms")
        bf16_ms[B] = (ms_ns, ms)
        if B == 1:  # the serial path's shape; most layers emit no scores
            rec["xattn_decode"] = dict(ms=ms_ns, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                       library_ms=lib_ms, ms_with_scores=ms,
                                       bound_ms_with_scores=bs_ms)
        del q, xk, xv
        torch.cuda.empty_cache()
    rec["xattn_decode"]["max_abs_err"] = max(err_out, err_sc)
    print(f"[c] xattn_decode: out err {err_out:.3g} (atol 2e-2), scores err {err_sc:.3g} (atol 1e-3)")

    # --- self_attn_decode: ctx 456, B 1/8/40, pads 0/5/224/300, six slots ---
    ctx = 456
    err = 0.0
    self_ms = {}  # (B, pos) -> ms with the row write
    for B in (1, 8, 40):
        q, k_new, v_new = randn(B, 1, D), randn(B, 1, D), randn(B, 1, D)
        k_all, v_all = randn(L, B, ctx, D), randn(L, B, ctx, D)
        # each row's pad_len one of SELF_PADS (at B=1 each in turn): 224 empties
        # the splits below it, 300 lies past pos
        pads = ([torch.tensor([SELF_PADS[b % 4] for b in range(B)], dtype=torch.int32,
                              device=device)] if B > 1 else
                [torch.tensor([p], dtype=torch.int32, device=device) for p in SELF_PADS])
        for pos in (0, 63, 64, 65, 232, 455):
            for pad in pads:
                layer = pos % L
                o_k = K.self_attn_decode(q, k_all, v_all, layer, pos, pad, H)
                torch.cuda.synchronize()
                o_p = K.self_attn_decode_plain(q, k_all, v_all, layer, pos, pad, H)
                if not torch.isfinite(o_k.float()).all():
                    fail(f"self_attn_decode: non-finite output at B={B} pos={pos}")
                err = max(err, (o_k.float() - o_p.float()).abs().max().item())
                # the fused row write: the cache after the call equals the plain
                # write bit for bit (every other slot untouched), the output the
                # kernel's on the cache written beforehand
                if pos in (0, 64, 455):
                    k_p, v_p = k_all.clone(), v_all.clone()
                    k_p[layer, :, pos] = k_new[:, 0]
                    v_p[layer, :, pos] = v_new[:, 0]
                    k_f, v_f = k_all.clone(), v_all.clone()
                    o_f = K.self_attn_decode(q, k_f, v_f, layer, pos, pad, H, k_new=k_new,
                                             v_new=v_new)
                    torch.cuda.synchronize()
                    if not (torch.equal(k_f, k_p) and torch.equal(v_f, v_p)):
                        fail(f"self_attn_decode's row write differs from the plain write at "
                             f"B={B} pos={pos}")
                    if not torch.equal(o_f, K.self_attn_decode(q, k_p, v_p, layer, pos, pad, H)):
                        fail(f"self_attn_decode with the row write differs from the kernel on "
                             f"the written cache at B={B} pos={pos}")
                    del k_p, v_p, k_f, v_f
        if not err <= 2e-2:
            fail(f"self_attn_decode disagrees: {err:.3g} (atol 2e-2)")
        # timed with the row write, as decode_step calls it; the library call
        # attends over the live slots with pad 0 (K/V sliced to pos + 1)
        pad0 = torch.zeros((B,), dtype=torch.int32, device=device)
        for pos in (232, 455):
            def plain_self(it=0):
                k_all[it % L, :, pos] = k_new[:, 0]
                v_all[it % L, :, pos] = v_new[:, 0]
                return K.self_attn_decode_plain(q, k_all, v_all, it % L, pos, pad0, H)

            ms = cuda_time_ms(lambda it=0: K.self_attn_decode(q, k_all, v_all, it % L, pos, pad0, H,
                                                              k_new=k_new, v_new=v_new))
            plain_ms = cuda_time_ms(plain_self, iters=10)
            lib_ms = cuda_time_ms(lambda it=0: sdpa(heads_view(q, H),
                                                    heads_view(k_all[it % L, :, :pos + 1], H),
                                                    heads_view(v_all[it % L, :, :pos + 1], H)))
            # the live slots of K and V, q, the output and the row written
            moved = 2 * B * (pos + 1) * D * 2 + 2 * B * D * 2 + 2 * B * D * 2
            b_ms, b_by = bound(moved, 4 * B * (pos + 1) * D, F32_FLOPS)
            self_ms[(B, pos)] = ms
            n_split = K.xattn_split(B, H, pos + 1, K._sm_count(device))[0]
            warps = K.pipeline_warps(B, H, K._sm_count(device))
            print(f"[c] self_attn_decode B={B} ctx=456 pos={pos} D=1280 H=20 ({n_split} splits, "
                  f"{warps} warps a block), "
                  f"with the row write: {ms:.4f} ms vs plain (write + attention) {plain_ms:.4f} "
                  f"ms, sdpa (live slots, pad 0) {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                  f"{moved / 1e6:.2f} MB)")
            if (B, pos) == (1, 232):  # the serial path's shape
                rec["self_attn_decode"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                               bound_by=b_by, library_ms=lib_ms)
        del q, k_new, v_new, k_all, v_all
        torch.cuda.empty_cache()
    rec["self_attn_decode"]["max_abs_err"] = err
    print(f"[c] self_attn_decode (B=1, 8, 40; pos 0, 63, 64, 65, 232, 455; pads "
          f"{'/'.join(map(str, SELF_PADS))}): err {err:.3g} (atol 2e-2); the fused row write equal "
          f"to the plain write bit for bit")

    # --- align_cost and dtw_codes: S=8, N in {64, 256}, K=10, M=1536 ---
    S, Kh, M = 8, 10, M_PAD
    err_c = 0.0
    for N in (64, 256):
        gen = torch.Generator().manual_seed(N)
        n_tok = torch.randint(2, N + 1, (S,), generator=gen)
        n_tok[0] = N
        span = torch.maximum(n_tok + torch.randint(0, 1400, (S,), generator=gen), n_tok)
        span = span.clamp(max=1500)
        span[1] = max(int(n_tok[1]), 3)  # a short span: reflection edges meet
        maxdur = torch.where(torch.arange(S) % 2 == 0, M, torch.clamp(span // 2, min=1))
        dims = torch.stack([n_tok, span, maxdur, torch.zeros(S, dtype=torch.long)], 1)
        dims = dims.to(torch.int32).to(device)
        scores = randn(S, Kh, N, M, dtype=torch.float32, scale=3.0)
        c_k = K.align_cost(scores, dims)
        again = K.align_cost(scores, dims)
        torch.cuda.synchronize()
        c_p = K.align_cost_plain(scores, dims)
        if not torch.allclose(c_k, c_p, rtol=1e-5, atol=1e-6):
            fail(f"align_cost disagrees at N={N}: max abs {(c_k - c_p).abs().max().item():.3g}")
        if not torch.equal(c_k, again):
            fail(f"align_cost differs from run to run at N={N}")
        err_c = max(err_c, (c_k - c_p).abs().max().item())
        # DTW on the same cost: codes equal where written, start frames equal
        d_k = K.dtw_codes(c_p, dims)
        st_k = K.dtw_starts(c_p, dims)
        torch.cuda.synchronize()
        d_p = K.dtw_codes_plain(c_p, dims)
        dh = dims.cpu()
        for s in range(S):
            nd = int(dh[s, 0] + dh[s, 1] - 1)
            if not torch.equal(d_k[s, :nd], d_p[s, :nd]):
                fail(f"dtw_codes differs at N={N} segment {s}")
        if not torch.equal(st_k, K.dtw_starts_plain(c_p, dims)):
            fail(f"dtw_starts (the DP with its walk) differs from its plain version at N={N}")
        if N == 256:
            timed = (scores, dims, c_p, dh)
        print(f"[c] align_cost N={N}: max abs err {err_c:.3g} (rtol 1e-5, atol 1e-6), equal from run "
              f"to run; dtw_codes N={N}: codes equal, the walk's start frames equal")
    scores, dims, cost, dh = timed
    # the work this data needs: the valid (token, frame) cells of each segment
    cells = int((dh[:, 0].long() * dh[:, 1].long()).sum())
    ms = cuda_time_ms(lambda it=0: K.align_cost(scores, dims), iters=10)
    plain_ms = cuda_time_ms(lambda it=0: K.align_cost_plain(scores, dims), iters=3)
    # reads each valid score once, writes the whole (S, N, M) cost; about 48
    # f32 operations per score (a 19-exchange median-of-9 network, softmax,
    # head mean, norm)
    b_ms, b_by = bound(Kh * cells * 4 + S * 256 * M * 4, 48 * Kh * cells, F32_FLOPS)
    rec["align_cost"] = dict(max_abs_err=err_c, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=None)
    ms_d = cuda_time_ms(lambda it=0: K.dtw_starts(cost, dims), iters=10)
    plain_d = cuda_time_ms(lambda it=0: K.dtw_starts_plain(cost, dims), iters=2)
    codes_ms = cuda_time_ms(lambda it=0: K.dtw_codes(cost, dims), iters=10)
    # reads each valid cost cell once, writes the start frames; ~6 ops a cell
    bd_ms, bd_by = bound(cells * 4 + S * 256 * 4, 6 * cells, F32_FLOPS)
    steps = int((dh[:, 0] + dh[:, 1] - 1).max())
    floor_ms = steps * dtw_step_ns(torch, device) * 1e-6
    # the record times the DP with its walk (dtw_starts), what the main path
    # runs; codes_ms is the same kernel writing the int32 codes (dtw_codes)
    rec["dtw_codes"] = dict(max_abs_err=0.0, ms=ms_d, plain_ms=plain_d,
                            bound_ms=bd_ms, bound_by=bd_by, library_ms=None,
                            function="dtw_starts", codes_ms=codes_ms)
    print(f"[c] S=8 K=10 N=256 M=1536 ({cells} valid cells): align_cost {ms:.4f} ms vs plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); the DTW with its walk (dtw_starts) "
          f"{ms_d:.4f} ms vs plain (codes + the Python backtrace) {plain_d:.4f} ms, bound "
          f"{bd_ms:.4f} ms ({bd_by}), chain floor {floor_ms:.4f} ms ({steps} dependent steps); "
          f"the same kernel writing the int32 codes instead {codes_ms:.4f} ms; no single PyTorch "
          f"call computes either")
    del scores, cost
    phase_aligner(torch, K, device)

    # --- flash_attention: the encoder at B=1 and B=8, the 232-slot prefill ---
    P = 232
    pads = torch.tensor([0, 5, 63, 64, 100, 224, 231, 232], dtype=torch.int32, device=device)
    err_f = 0.0
    for label, Bf, Sq, Sk, causal in (("encoder B=1", 1, T, T, False),
                                      ("encoder B=8", 8, T, T, False),
                                      ("prefill self B=8", 8, P, P, True),
                                      ("prefill cross B=8", 8, P, T, False)):
        qf, kf, vf = randn(Bf, Sq, D), randn(Bf, Sk, D), randn(Bf, Sk, D)
        pad = pads if causal else None
        o_k = K.flash_attention(qf, kf, vf, H, causal=causal, pad_len=pad)
        torch.cuda.synchronize()
        o_p = K.flash_attention_plain(qf, kf, vf, H, causal=causal, pad_len=pad)
        if not torch.isfinite(o_k.float()).all():
            fail(f"flash_attention {label}: non-finite output")
        e = (o_k.float() - o_p.float()).abs().max().item()
        if not e <= 2e-2:
            fail(f"flash_attention {label} disagrees: {e:.3g} (atol 2e-2)")
        err_f = max(err_f, e)
        del o_k, o_p
        mask = None
        live_pairs = Bf * Sq * Sk
        if causal:  # the same mask as a boolean for the library call
            qi, ki = torch.arange(Sq, device=device)[:, None], torch.arange(Sk, device=device)[None]
            live = ((ki[None] >= pad[:, None, None]) & (ki <= qi)[None]) | (ki == qi)[None]
            live_pairs = int(live.sum())
            mask = live[:, None]
        ms_f = cuda_time_ms(lambda it=0: K.flash_attention(qf, kf, vf, H, causal=causal, pad_len=pad),
                            iters=10)
        plain_f = cuda_time_ms(lambda it=0: K.flash_attention_plain(qf, kf, vf, H, causal=causal,
                                                                    pad_len=pad), iters=3)
        lib_f = cuda_time_ms(lambda it=0: sdpa(heads_view(qf, H), heads_view(kf, H),
                                               heads_view(vf, H), attn_mask=mask), iters=10)
        fb_ms, fb_by = bound(Bf * (2 * Sq + 2 * Sk) * D * 2, 4 * H * live_pairs * 64, BF16_FLOPS)
        print(f"[c] flash_attention {label} (Sq={Sq} Sk={Sk} D=1280 H=20): err {e:.3g} (atol 2e-2); "
              f"{ms_f:.4f} ms vs plain {plain_f:.4f} ms, sdpa {lib_f:.4f} ms, "
              f"bound {fb_ms:.4f} ms ({fb_by})")
        if label == "encoder B=8":  # the shape the batched main path gives it
            rec["flash_attention"] = dict(ms=ms_f, plain_ms=plain_f, bound_ms=fb_ms,
                                          bound_by=fb_by, library_ms=lib_f)
        del qf, kf, vf, mask
        torch.cuda.empty_cache()
    rec["flash_attention"]["max_abs_err"] = err_f
    return rec, dict(xattn=bf16_ms, self=self_ms)


def dtw_step_ns(torch, device, steps: int = 1 << 20) -> float:
    """The DP's chain floor a step: one warp's dependent shuffle + min + add
    steps (``wtt_dtw_chain``), ns a step from CUDA events over one launch."""
    import ctypes

    from whisper_timestamped_tpu_torch.ops import _build

    out = torch.empty(32, dtype=torch.float32, device=device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    lib = _build.library()
    if lib.wtt_dtw_chain(out.data_ptr(), 1024, stream) != 0:
        fail("the DTW chain probe did not launch")
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    lib.wtt_dtw_chain(out.data_ptr(), steps, stream)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) * 1e6 / steps


def old_align_jumps(torch, K, attn_flat, rows, dims):
    """The aligner as the parent tree ran it: a Python loop of S window
    copies into a zeroed (S, K, N, 1536) tensor, the pre-sliced cost, the
    int32 codes, and the backtrace as a Python loop of small tensor ops."""
    from whisper_timestamped_tpu_torch.device_align import M_PAD

    S, N = rows.shape
    K_, T = attn_flat.shape[1], attn_flat.shape[2]
    rows_t = torch.as_tensor(rows, dtype=torch.long, device=attn_flat.device)
    sliced = torch.zeros((S, K_, N, M_PAD), dtype=torch.float32, device=attn_flat.device)
    for s in range(S):
        st = int(dims[s, 3])
        w = min(M_PAD, T - st)
        sliced[s, :, :, :w] = attn_flat[rows_t[s], :, st : st + w].transpose(0, 1)
    dims_t = torch.as_tensor(dims, dtype=torch.int32, device=attn_flat.device)
    cost = K.align_cost(sliced, dims_t)
    codes = K.dtw_codes(cost, dims_t)
    steps = int((dims[:, 0] + dims[:, 1] - 1).max())
    return K.backtrace_batch(codes, dims_t[:, 0], dims_t[:, 1], steps), cost


def phase_aligner(torch, K, device):
    """(c): the whole batched aligner (``device_align._align_jumps``: the
    gather-form cost and the DTW with its walk, two kernel calls) at (g)'s
    flush shape: 32 segments (S_pad) of up to 256 token rows (n_pad), K=10,
    read from a (40 * 224, 10, 1500) attention buffer. The cost against its
    plain version (rtol 1e-5 / atol 1e-6), the start frames against the
    plain version's and the old path's (``old_align_jumps``), equal; both
    paths timed on the host clock (each ending in a synchronize) and the
    gather-form cost alone by CUDA events, beside its bound."""
    import numpy as np

    from whisper_timestamped_tpu_torch.device_align import M_PAD, _align_jumps

    rng = np.random.default_rng(32)
    R, Kh, T, S, N = 40 * 224, 10, 1500, 32, 256
    attn = torch.randn((R, Kh, T), generator=torch.Generator(device=device).manual_seed(32),
                       device=device) * 3.0
    n_tok = rng.integers(2, N + 1, S)
    span = np.minimum(n_tok + rng.integers(0, 1400, S), 1500)
    start = rng.integers(0, T - span + 1)
    maxdur = np.where(np.arange(S) % 2 == 0, M_PAD, span // 2)
    dims = np.stack([n_tok, span, maxdur, start], 1).astype(np.int32)
    rows = rng.integers(0, R, (S, N))
    K.reset_launches()
    starts, cost = _align_jumps(attn, rows, dims)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    if launches["align_cost"] != 1 or launches["dtw_codes"] != 1:
        fail(f"the aligner is not one align_cost and one dtw_codes call: {launches}")
    rows_t = torch.as_tensor(rows, dtype=torch.int32, device=device)
    dims_t = torch.as_tensor(dims, device=device)
    c_p = K.align_cost_gather_plain(attn, rows_t, dims_t, M_PAD)
    err = (cost - c_p).abs().max().item()
    if not torch.allclose(cost, c_p, rtol=1e-5, atol=1e-6):
        fail(f"align_cost_gather disagrees at (g)'s flush shape: max abs {err:.3g}")
    del c_p
    if not torch.equal(starts, K.dtw_starts_plain(cost, dims_t)):
        fail("the aligner's start frames differ from the plain walk's")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t_old = []
    for _ in range(2):
        t0 = time.perf_counter()
        old_starts, _ = old_align_jumps(torch, K, attn, rows, dims)
        torch.cuda.synchronize()
        t_old.append(time.perf_counter() - t0)
    old_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    # the old path's cost (pre-sliced windows) rounds its softmax sums in
    # another order, so a near tie may fall the other way: counted, not held
    differ = int((old_starts != starts).any(dim=1).sum())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_new = []
    for _ in range(5):
        t0 = time.perf_counter()
        _align_jumps(attn, rows, dims)
        torch.cuda.synchronize()
        t_new.append(time.perf_counter() - t0)
    new_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    ms = cuda_time_ms(lambda it=0: K.align_cost_gather(attn, rows_t, dims_t, M_PAD), iters=10)
    cells = int((dims[:, 0].astype(np.int64) * dims[:, 1]).sum())
    b_ms, b_by = bound(Kh * cells * 4 + S * N * M_PAD * 4, 48 * Kh * cells, F32_FLOPS)
    ms_d = cuda_time_ms(lambda it=0: K.dtw_starts(cost, dims_t), iters=10)
    steps = int((dims[:, 0] + dims[:, 1] - 1).max())
    floor_ms = steps * dtw_step_ns(torch, device) * 1e-6
    print(f"[c] the aligner at (g)'s flush shape (S=32, n_pad 256, K=10, a (8960, 10, 1500) "
          f"buffer, {cells} valid cells): {1e3 * min(t_new):.3f} ms host clock "
          f"({', '.join(f'{1e3 * t:.3f}' for t in t_new)}), transient peak +{new_peak:.3f} GB; the "
          f"old path (S window copies, codes, Python backtrace) {1e3 * min(t_old):.1f} ms "
          f"({', '.join(f'{1e3 * t:.1f}' for t in t_old)}), +{old_peak:.3f} GB; start frames equal to "
          f"the plain walk's; {differ} of {S} segments' start frames differ from the old path's; "
          f"cost vs plain max abs {err:.3g}; align_cost_gather {ms:.4f} ms (bound {b_ms:.4f} ms, "
          f"{b_by}), dtw_starts {ms_d:.4f} ms (chain floor {floor_ms:.4f} ms, {steps} steps)")
    del attn, cost, starts, old_starts
    torch.cuda.empty_cache()


# The quantized kernels' output limits. The cross kernels against their
# plain version (which rounds the V-weighted softmax weights to bf16, the
# kernels do not): 4e-3, four bf16 steps at the outputs' largest magnitude
# (~0.2 with N(0, 1) q and K/V; the measured error is one step, 9.8e-4).
# The self kernel sums in f32 and rounds its output once, so against the
# plain version in f32 (the cache dequantized to f32) it is held to that
# rounding: half a bf16 step, 2^-8 of the reference, plus 1e-4 for f32
# sums in another order.
XATTN_Q_ATOL = 4e-3
SELF_Q_RTOL, SELF_Q_ATOL = 2.0**-8, 1e-4


def phase_quant_kernels(torch, K, device, bf16_ms):
    """(c): the three quantized-cache kernels against their plain versions
    (limits above; scores atol 1e-3; the written cache rows bit for bit),
    at small batches and at the batches of the phases that run them (B=1,
    8 and 40), where they are also timed beside the kernel of the same
    batch that reads wider rows: int8 and int4 cross-attention with and
    without scores (the int4 line with int8's time beside it; the int8
    line with the bf16 kernel's, ``bf16_ms["xattn"][B]``), the int8 self
    cache with its quantized write at pos 232 and 455 (beside bf16
    ``self_attn_decode`` with its write, ``bf16_ms["self"][(B, pos)]``).
    The record keeps [g]'s B=40 (scores on) for int8 and [h]'s B=8 for the
    int4 kernel (scores on) and the int8 self cache (pos 232). No single
    PyTorch call takes int8/int4 K/V with per-row scales: library none."""
    from whisper_timestamped_tpu_torch.ops.quant import quantize_rows, quantize_rows_int4

    g = torch.Generator(device=device).manual_seed(1)
    rec = {}
    L, T, D, H = 32, 1500, 1280, 20
    n_sm = K._sm_count(device)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    def stacked(B_kv, fn):
        """(L, B_kv, ...) codes and scales, quantized one layer at a time."""
        codes, scales = zip(*(fn(randn(B_kv, T, D)) for _ in range(L)))
        return torch.stack(codes), torch.stack(scales)

    int8_ms = {}  # B -> (ms without, with scores), printed beside int4's
    for name, fn, fpr, rec_b in (("xattn_decode_int8", quantize_rows, 1, 40),
                                 ("xattn_decode_int4", quantize_rows_int4, 2, 8)):
        kernel, plain = getattr(K, name), getattr(K, name + "_plain")
        err_out = err_sc = 0.0

        def compare(q, kv, beam_group, emit):
            nonlocal err_out, err_sc
            for layer in (0, 31):
                o_k, s_k = kernel(q, *kv, layer, H, emit_scores=emit, beam_group=beam_group)
                torch.cuda.synchronize()
                o_p, s_p = plain(q, *kv, layer, H, emit_scores=emit, beam_group=beam_group)
                err_out = max(err_out, (o_k.float() - o_p.float()).abs().max().item())
                if emit:
                    err_sc = max(err_sc, (s_k - s_p).abs().max().item())
                elif s_k is not None:
                    fail(f"{name} wrote scores it was not asked for")

        for B, beam_group, emit in ((1, 1, True), (1, 1, False), (4, 1, True), (4, 2, True)):
            compare(randn(B, 1, D).bfloat16(),
                    (*stacked(B // beam_group, fn), *stacked(B // beam_group, fn)), beam_group, emit)
        # the main path's batches, scores on and off, each timed
        for Bt in (1, 8, 40):
            q = randn(Bt, 1, D).bfloat16()
            kv = (*stacked(Bt, fn), *stacked(Bt, fn))
            compare(q, kv, 1, True)
            compare(q, kv, 1, False)
            if not (err_out <= XATTN_Q_ATOL and err_sc <= 1e-3):
                fail(f"{name} disagrees: out {err_out:.3g} (atol {XATTN_Q_ATOL}), scores "
                     f"{err_sc:.3g} (atol 1e-3)")
            ms = cuda_time_ms(lambda it=0: kernel(q, *kv, it % L, H, emit_scores=True))
            ms_ns = cuda_time_ms(lambda it=0: kernel(q, *kv, it % L, H))
            plain_ms = cuda_time_ms(lambda it=0: plain(q, *kv, it % L, H, emit_scores=True), iters=5)
            # each input read once: q, one layer's codes of K and V, their scales;
            # the output and the scores written once; 4 f32 flops per code pair
            moved = 2 * Bt * D * 2 + 2 * kv[0][0].numel() + 2 * Bt * T * 4 + Bt * H * T * 4
            b_ms, b_by = bound(moved, 4 * Bt * T * D, F32_FLOPS)
            if Bt == rec_b:
                rec[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                 library_ms=None)
            # the kernel of the same B that reads wider rows, a reference point
            if name == "xattn_decode_int8":
                int8_ms[Bt] = (ms_ns, ms)
                wider = (f"bf16 xattn_decode {bf16_ms['xattn'][Bt][1]:.4f} ms with scores, "
                         f"{bf16_ms['xattn'][Bt][0]:.4f} ms without")
            else:
                wider = (f"xattn_decode_int8 {int8_ms[Bt][1]:.4f} ms with scores, "
                         f"{int8_ms[Bt][0]:.4f} ms without")
            n_split, per = K.xattn_split(Bt, H, T // fpr, n_sm, fpr)
            print(f"[c] {name} B={Bt} L=32 T=1500 D=1280 H=20 ({n_split} splits of {per} rows, "
                  f"{K.pipeline_warps(Bt, H, n_sm, fpr)} warps a block): {ms:.4f} ms with scores, "
                  f"{ms_ns:.4f} ms without, vs plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}, {moved / 1e6:.1f} MB); {wider}")
            del q, kv
            torch.cuda.empty_cache()
        rec[name]["max_abs_err"] = max(err_out, err_sc)
        print(f"[c] {name} (B=1, 4, 8 and 40): out err {err_out:.3g} (atol {XATTN_Q_ATOL}), "
              f"scores err {err_sc:.3g} (atol 1e-3); no single PyTorch call computes it")

    # --- self_attn_decode_int8: the fused row write, then the attention ---
    ctx = 456
    err = 0.0

    def compare_self(B, pad, pos, layers):
        """Kernel against the plain quantizer's rows and the plain version in
        f32 on one cache; returns the cache."""
        nonlocal err
        q, k_new, v_new = (randn(B, 1, D).bfloat16() for _ in range(3))
        cache = (*quantize_rows(randn(L, B, ctx, D)), *quantize_rows(randn(L, B, ctx, D)))
        for layer in layers:
            ck = [t.clone() for t in cache]
            o_k = K.self_attn_decode_int8(q, k_new, v_new, *ck, layer, pos, pad, H)
            torch.cuda.synchronize()
            cp = [t.clone() for t in cache]
            K.write_quantized_row(k_new, v_new, *cp, layer, pos)
            ref = K.self_attn_decode_int8_plain(q.float(), *cp, layer, pos, pad, H)
            if not all(torch.equal(a, b) for a, b in zip(ck, cp)):
                fail(f"self_attn_decode_int8 wrote other cache rows than the plain quantizer "
                     f"(B={B}, layer {layer}, pos {pos})")
            if not torch.isfinite(o_k.float()).all():
                fail(f"self_attn_decode_int8: non-finite output at B={B} pos={pos}")
            diff = (o_k.float() - ref).abs()
            if not bool((diff <= SELF_Q_ATOL + SELF_Q_RTOL * ref.abs()).all()):
                fail(f"self_attn_decode_int8 disagrees at B={B} layer {layer} pos {pos}: max abs "
                     f"{diff.max().item():.3g} (limit 2^-8 of the f32 plain version + {SELF_Q_ATOL})")
            err = max(err, diff.max().item())
            del ck, cp
        return q, k_new, v_new, cache

    pad4 = torch.tensor([0, 5, 224, 300], dtype=torch.int32, device=device)
    for pos in (0, 63, 64, 65):  # the edges of a 64-slot split
        compare_self(4, pad4, pos, (pos % L,))
    for pos in (232, 455):
        compare_self(4, pad4, pos, (0, 17, 31))
    # each row's pad_len one of SELF_PADS (at B=1 each in turn), then timed at
    # the batches that run it, with pad 0; [h]'s B=8 varied, one row past pos
    pad8 = torch.tensor([0, 3, 17, 100, 224, 231, 232, 300], dtype=torch.int32, device=device)
    compare_self(8, pad8, 232, (0, 31))
    for pad in SELF_PADS:
        compare_self(1, torch.tensor([pad], dtype=torch.int32, device=device), 232, (5,))
    for Bt in (1, 8, 40):
        pads = torch.tensor([SELF_PADS[b % 4] for b in range(Bt)], dtype=torch.int32, device=device)
        pad0 = torch.zeros((Bt,), dtype=torch.int32, device=device)
        for pos in (232, 455):
            q, k_new, v_new, cache = compare_self(Bt, pads, pos, (pos % L,))

            def plain_self(it=0):
                K.write_quantized_row(k_new, v_new, *cache, it % L, pos)
                return K.self_attn_decode_int8_plain(q, *cache, it % L, pos, pad0, H)

            ms = cuda_time_ms(lambda it=0: K.self_attn_decode_int8(q, k_new, v_new, *cache, it % L,
                                                                   pos, pad0, H))
            plain_ms = cuda_time_ms(plain_self, iters=5)
            # q, k_new, v_new and the output; the live slots' codes and scales of
            # K and V; the written row's codes and scales; 4 f32 flops per code pair
            live = pos + 1
            moved = Bt * (4 * D * 2 + 2 * live * (D + 4) + 2 * (D + 4))
            b_ms, b_by = bound(moved, 4 * Bt * live * D, F32_FLOPS)
            if (Bt, pos) == (8, 232):
                rec["self_attn_decode_int8"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                                    bound_by=b_by, library_ms=None)
            n_split = K.xattn_split(Bt, H, live, n_sm)[0]
            print(f"[c] self_attn_decode_int8 B={Bt} ctx=456 pos={pos} D=1280 H=20 ({n_split} "
                  f"splits, {K.pipeline_warps(Bt, H, n_sm)} warps a block), with its quantized "
                  f"write: {ms:.4f} ms vs plain (write + attention) {plain_ms:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}, {moved / 1e6:.2f} MB); bf16 self_attn_decode with its "
                  f"write {bf16_ms['self'][(Bt, pos)]:.4f} ms")
            del cache
            torch.cuda.empty_cache()
    rec["self_attn_decode_int8"]["max_abs_err"] = err
    print(f"[c] self_attn_decode_int8 (B=1, 4, 8 and 40; pos 0, 63, 64, 65, 232, 455; pads "
          f"{'/'.join(map(str, SELF_PADS))}): max abs err {err:.3g} against the plain version in "
          f"f32 (limit 2^-8 of it + {SELF_Q_ATOL}), written rows equal the plain quantizer's; no "
          f"single PyTorch call computes it")
    return rec


def phase_beam_kernels(torch, K, device):
    """(c): the cross-attention kernels as beam search runs them, B=40
    query rows over B_kv=8 K/V rows (``beam_group=5``: the K=5 beams of 8
    windows), without scores, against their plain versions at the limits
    above, and timed beside the same kernel at B=40 over 40 rows
    (``beam_group=1``). The shared-read bound reads one layer of the 8
    rows' K and V once (the queries and outputs besides), the unshared one
    40 rows'. Returns extra fields for the kernels' records."""
    from whisper_timestamped_tpu_torch.ops.quant import quantize_rows

    g = torch.Generator(device=device).manual_seed(5)
    L, T, D, H, B, G = 32, 1500, 1280, 20, 40, 5
    out = {}
    for name, tol in (("xattn_decode", 2e-2), ("xattn_decode_int8", XATTN_Q_ATOL)):
        kernel, plain = getattr(K, name), getattr(K, name + "_plain")

        def kv(rows):
            if name == "xattn_decode":
                return tuple(torch.randn((L, rows, T, D), generator=g, device=device).bfloat16()
                             for _ in range(2))
            k8, ks = zip(*(quantize_rows(torch.randn((rows, T, D), generator=g, device=device))
                           for _ in range(L)))
            v8, vs = zip(*(quantize_rows(torch.randn((rows, T, D), generator=g, device=device))
                           for _ in range(L)))
            return torch.stack(k8), torch.stack(ks), torch.stack(v8), torch.stack(vs)

        q = torch.randn((B, 1, D), generator=g, device=device).bfloat16()
        shared, full = kv(B // G), kv(B)
        err = 0.0
        for layer in (0, L // 2, L - 1):
            o_k, s_k = kernel(q, *shared, layer, H, beam_group=G)
            torch.cuda.synchronize()
            o_p, _ = plain(q, *shared, layer, H, beam_group=G)
            if s_k is not None:
                fail(f"{name} at beam_group={G} wrote scores it was not asked for")
            err = max(err, (o_k.float() - o_p.float()).abs().max().item())
        if not err <= tol:
            fail(f"{name} at B={B} beam_group={G} disagrees: out {err:.3g} (atol {tol})")
        ms = cuda_time_ms(lambda it=0: kernel(q, *shared, it % L, H, beam_group=G))
        ms_full = cuda_time_ms(lambda it=0: kernel(q, *full, it % L, H))
        plain_ms = cuda_time_ms(lambda it=0: plain(q, *shared, it % L, H, beam_group=G), iters=5)
        per_row = sum(t[0, 0].numel() * t.element_size() for t in shared)  # K, V (+ scales)
        io = 2 * B * D * 2  # q read, the output written
        b_ms, b_by = bound(io + (B // G) * per_row, 4 * B * T * D, F32_FLOPS)
        bf_ms, _ = bound(io + B * per_row, 4 * B * T * D, F32_FLOPS)
        print(f"[c] {name} B={B} over B_kv={B // G} (beam_group={G}), no scores: {ms:.4f} ms "
              f"(shared-read bound {b_ms:.4f} ms, {b_by}, {(io + (B // G) * per_row) / 1e6:.1f} "
              f"MB), plain {plain_ms:.4f} ms; the same kernel over {B} rows (beam_group=1) "
              f"{ms_full:.4f} ms (bound {bf_ms:.4f} ms); out err {err:.3g} (atol {tol})")
        out[name] = dict(ms_beam_group5=ms, bound_ms_beam_group5=b_ms,
                         ms_b40_beam_group1=ms_full, max_abs_err_beam_group5=err)
        del q, shared, full
        torch.cuda.empty_cache()
    return out


# the training kernels against their plain versions, a share of each
# output's max abs: f32 1e-4 (f32 FMAs in another order; the backward's
# products 3xTF32, whose f32 sums the tensor cores round toward zero at
# every k-step: ~3e-5 at T = 1500, emulated by tools/torch_kernel_sweeps.py
# flash-bwd-accuracy), bf16 1e-2 (both round the f32 result to bf16, 2^-8
# of a value; the backward also rounds P and dS to bf16 for their products,
# as the library does); the bf16 forward's output at the inference kernel's
# atol 2e-2
TRAIN_TOL = {"f32": 1e-4, "bf16": 1e-2}


def phase_train_kernels(torch, K, device):
    """(c): the training flash kernels (forward with lse, dQ, dK/dV) against
    their plain versions at the large-v3 encoder's shape (B=2, T=1500,
    D=1280, H=20; the backward's 11 128-row blocks and a 92-row tail) and
    at ragged T = 1, 65, 128, 129, 200, in f32 (the training path's dtype)
    and bf16; each timed beside its plain version and SDPA (forward;
    backward alone), with its bound (the f32 backward's at 3xTF32's rate on
    the tensor cores, three tf32 products a product at 495 TFLOP/s, with
    the CUDA cores' 67 beside it); at T = 1500 the backward and its plain
    version also against a float64 backward. Returns the f32 records."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=device).manual_seed(13)
    B, D, H = 2, 1280, 20
    rec, errs, t_phase = {}, {}, time.perf_counter()
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        tol, e_fwd, e_bwd, a_bwd = TRAIN_TOL[label], 0.0, 0.0, 0.0
        for T in (1, 65, 128, 129, 200, 1500):
            q, k, v, dout = (torch.randn((B, T, D), generator=g, device=device).to(dtype)
                             for _ in range(4))
            out, lse = K.flash_attention_fwd(q, k, v, H)
            torch.cuda.synchronize()
            out_p, lse_p = K.flash_attention_fwd_plain(q, k, v, H)
            e_out = (out.float() - out_p.float()).abs().max().item()
            e_lse = ((lse - lse_p).abs().max() / lse_p.abs().max()).item()
            if not (e_out <= (2e-2 if label == "bf16" else tol * out_p.float().abs().max().item())
                    and e_lse <= 1e-4):
                fail(f"flash_attention_fwd {label} T={T} disagrees: out {e_out:.3g}, lse "
                     f"{e_lse:.3g} of its max")
            e_fwd = max(e_fwd, e_out)
            grads = K.flash_attention_bwd(q, k, v, out_p, lse_p, dout, H)
            torch.cuda.synchronize()
            want = K.flash_attention_bwd_plain(q, k, v, out_p, lse_p, dout, H)
            # at one key dq and dk are zero in exact arithmetic: dv's scale
            scales = [w.float().abs().max().item() for w in want]
            for name, a, w, sc in zip(("dq", "dk", "dv"), grads, want,
                                      [scales[2]] * 3 if T == 1 else scales):
                e = (a.float() - w.float()).abs().max().item()
                if not (torch.isfinite(a.float()).all() and e <= tol * sc):
                    fail(f"flash_attention_bwd {label} T={T} {name} disagrees: {e:.3g} "
                         f"(limit {tol} of {sc:.3g})")
                e_bwd, a_bwd = max(e_bwd, e / sc), max(a_bwd, e)
            if T != 1500:
                continue
            # the witness: the kernels and the plain version against float64
            exact = flash_bwd_float64(torch, q, k, v, dout, H)
            e64 = [max(((a.double() - w).abs().max() / w.abs().max()).item()
                       for a, w in zip(got, exact)) for got in (grads, want)]
            print(f"[c] flash_attention_bwd {label} T={T} against a float64 backward: kernels "
                  f"{e64[0]:.3g}, plain version {e64[1]:.3g} of a gradient's max abs")
            del exact
            elt = q.element_size()
            pairs = B * H * T * T * 64  # one T x T x 64 product, all heads
            io, rows = B * T * D * elt, B * H * T * 4
            # the forward's f32 products run on the CUDA cores; the backward's on
            # the tensor cores, f32 as 3xTF32: three tf32 products a product
            f_peak = F32_FLOPS if label == "f32" else BF16_FLOPS
            f_ms, f_by = bound(4 * io + rows, 4 * pairs, f_peak)
            n_tc, tc_peak = (3, TF32_FLOPS) if label == "f32" else (1, BF16_FLOPS)
            dq_b, dq_by = bound(6 * io + 2 * rows, n_tc * 6 * pairs, tc_peak)  # 3 products
            dkv_b, dkv_by = bound(6 * io + 2 * rows, n_tc * 8 * pairs, tc_peak)  # 4 products
            all_b, _ = bound(8 * io + rows, n_tc * 10 * pairs, tc_peak)  # the 5 products at least
            # the same f32 work on the CUDA cores (PR 13's design)
            cc_dq, cc_dkv, cc_all = (bound(by, n * pairs, F32_FLOPS)[0] for by, n in (
                (6 * io + 2 * rows, 6), (6 * io + 2 * rows, 8), (8 * io + rows, 10)))
            ms_f = cuda_time_ms(lambda it=0: K.flash_attention_fwd(q, k, v, H), iters=10)
            plain_f = cuda_time_ms(lambda it=0: K.flash_attention_fwd_plain(q, k, v, H), iters=5)
            _, delta = K._flash_bwd_dq(q, k, v, out_p, dout, lse_p, H)
            ms_dq = cuda_time_ms(lambda it=0: K._flash_bwd_dq(q, k, v, out_p, dout, lse_p, H),
                                 iters=10)
            ms_dkv = cuda_time_ms(lambda it=0: K._flash_bwd_dkv(q, k, v, dout, lse_p, delta, H),
                                  iters=10)
            plain_b = cuda_time_ms(lambda it=0: K.flash_attention_bwd_plain(
                q, k, v, out_p, lse_p, dout, H), iters=5)
            qh, kh, vh = (heads_view(x, H).detach().requires_grad_() for x in (q, k, v))
            lib_f = cuda_time_ms(lambda it=0: sdpa(qh.detach(), kh.detach(), vh.detach()), iters=10)
            o_lib = sdpa(qh, kh, vh)
            lib_b = cuda_time_ms(lambda it=0: torch.autograd.grad(
                o_lib, (qh, kh, vh), heads_view(dout, H), retain_graph=True), iters=10)
            print(f"[c] flash_attention_fwd {label} B={B} T={T} D={D} H={H}: {ms_f:.4f} ms vs "
                  f"plain {plain_f:.4f} ms, sdpa {lib_f:.4f} ms, bound {f_ms:.4f} ms ({f_by})")
            print(f"[c] flash_attention_bwd {label} B={B} T={T}: dq {ms_dq:.4f} ms (bound "
                  f"{dq_b:.4f}, 3 products), dkv {ms_dkv:.4f} ms (bound {dkv_b:.4f}, 4 products), "
                  f"together {ms_dq + ms_dkv:.4f} ms against the backward's bound {all_b:.4f} ms "
                  f"(5 products); plain {plain_b:.4f} ms, sdpa backward alone {lib_b:.4f} ms")
            if label == "f32":  # the training path's dtype
                print(f"[c] flash_attention_bwd f32: the bounds above are 3xTF32's (3 tf32 "
                      f"products a product at {TF32_FLOPS / 1e12:.0f} TFLOP/s); on the CUDA cores "
                      f"at {F32_FLOPS / 1e12:.0f}: dq {cc_dq:.4f} ms, dkv {cc_dkv:.4f} ms, the 5 "
                      f"products {cc_all:.4f} ms")
                rec["flash_attention_fwd"] = dict(ms=ms_f, plain_ms=plain_f, bound_ms=f_ms,
                                                  bound_by=f_by, library_ms=lib_f)
                common = dict(plain_ms=plain_b, library_ms=lib_b, bwd_bound_ms=all_b,
                              bwd_bound_cuda_core_ms=cc_all,
                              bound_rate="3xTF32: 3 tf32 products a product at 495 TFLOP/s",
                              max_err_float64=e64[0], plain_max_err_float64=e64[1],
                              plain_function="flash_attention_bwd_plain (dq, dk, dv)",
                              library_function="sdpa backward (dq, dk, dv)")
                rec["flash_attention_bwd_dq"] = dict(ms=ms_dq, bound_ms=dq_b, bound_by=dq_by,
                                                     bound_cuda_core_ms=cc_dq, **common)
                rec["flash_attention_bwd_dkv"] = dict(ms=ms_dkv, bound_ms=dkv_b, bound_by=dkv_by,
                                                      bound_cuda_core_ms=cc_dkv, **common)
            else:
                for name, ms in (("flash_attention_fwd", ms_f), ("flash_attention_bwd_dq", ms_dq),
                                 ("flash_attention_bwd_dkv", ms_dkv)):
                    rec[name]["ms_bf16"] = ms
            del qh, kh, vh, o_lib, delta
        errs[label] = (e_fwd, a_bwd)
        print(f"[c] flash training kernels {label} (T = 1, 65, 128, 129, 200, 1500): forward out err "
              f"{e_fwd:.3g}, lse within 1e-4 of its max; backward err {a_bwd:.3g}, at most "
              f"{e_bwd:.3g} of a gradient's max abs (limit {tol})")
        del q, k, v, dout, out, lse, out_p, lse_p, grads, want
        torch.cuda.empty_cache()
    rec["flash_attention_fwd"]["max_abs_err"] = errs["f32"][0]
    rec["flash_attention_bwd_dq"]["max_abs_err"] = rec["flash_attention_bwd_dkv"]["max_abs_err"] = \
        errs["f32"][1]
    for name in TRAIN_PATH:
        rec[name]["max_abs_err_bf16"] = errs["bf16"][0 if name == "flash_attention_fwd" else 1]
    print(f"[c] the training kernels' checks and times: {time.perf_counter() - t_phase:.1f} s")
    return rec


def phase_segment_kernels(torch, K, device):
    """(c): the per-segment alignment route's kernels at the shape of one
    120-head segment of (i): K=120 scores of N=224 token rows (200 real) by
    M=1536 frames (1500 real), padded as the aligner pads them.
    ``attention_to_cost`` at rtol 1e-5 / atol 1e-6 (f32 sums in another
    order), ``median9`` on the same array equal (a selection), the
    one-launch DP and walk of ``dtw_path`` (S=1) on that cost
    with the host's origin edit: the same path as the plain version's. No
    single PyTorch call computes any of them: library none. Returns the
    records of ``attention_to_cost`` and ``median9`` (with ``median9``'s
    launches: no path runs it) and prints ``dtw_path``'s times."""
    g = torch.Generator(device=device).manual_seed(2)
    Kh, N, M, span, n_tok = 120, 224, 1536, 1500, 200
    scores = torch.zeros((Kh, N, M), dtype=torch.float32, device=device)
    scores[:, :n_tok, :span] = torch.randn((Kh, n_tok, span), generator=g, device=device) * 3.0
    rows = scores.view(Kh * N, M)
    K.reset_launches()
    c_k = K.attention_to_cost(scores, span, n_tokens=n_tok)
    m_k = K.median9(rows)
    torch.cuda.synchronize()
    c_p = K.attention_to_cost_plain(scores, span, n_tok)
    err_c = (c_k - c_p).abs().max().item()
    if not torch.allclose(c_k, c_p, rtol=1e-5, atol=1e-6):
        fail(f"attention_to_cost disagrees: max abs {err_c:.3g} (rtol 1e-5, atol 1e-6)")
    if not torch.equal(m_k, K.median9_plain(rows)):
        fail("median9 differs from its plain version")
    del m_k
    weights = c_p[:n_tok, :span].clone()
    weights[0, 0] = weights.min()  # the host's origin edit (no max-duration mask here)
    before = K.LAUNCHES["dtw_codes"]
    path_k = K.dtw_path(weights)
    if K.LAUNCHES["dtw_codes"] != before + 1:
        fail("dtw_path did not launch the DTW kernel once")
    path_p = K.dtw_path_plain(weights)
    if not all((a == b).all() for a, b in zip(path_k, path_p)):
        fail("dtw_path (the kernel's own walk) differs from its plain version")
    rec = {}
    valid = Kh * n_tok * span
    ms = cuda_time_ms(lambda it=0: K.attention_to_cost(scores, span, n_tokens=n_tok), iters=10)
    plain_ms = cuda_time_ms(lambda it=0: K.attention_to_cost_plain(scores, span, n_tok), iters=3)
    # reads each valid score once, writes the (N, M) cost; ~48 f32
    # operations per score, as align_cost
    b_ms, b_by = bound(valid * 4 + N * M * 4, 48 * valid, F32_FLOPS)
    rec["attention_to_cost"] = dict(max_abs_err=err_c, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=b_by, library_ms=None)
    print(f"[c] attention_to_cost K=120 N=224 M=1536 (n_tokens 200, span 1500): max abs err "
          f"{err_c:.3g} (rtol 1e-5, atol 1e-6); {ms:.4f} ms vs plain {plain_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}, {(valid * 4 + N * M * 4) / 1e6:.1f} MB)")
    ms = cuda_time_ms(lambda it=0: K.median9(rows), iters=10)
    plain_ms = cuda_time_ms(lambda it=0: K.median9_plain(rows), iters=3)
    # reads and writes every element once; 19 compare-exchanges (38 min/max)
    b_ms, b_by = bound(2 * rows.numel() * 4, 38 * rows.numel(), F32_FLOPS)
    rec["median9"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          library_ms=None)
    print(f"[c] median9 (26880, 1536): equal to the plain version; {ms:.4f} ms vs plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    # dtw_path: the DP and the walk in one launch (timed alone), then the whole call
    dims = torch.tensor([[n_tok, span, 0, 0]], dtype=torch.int32, device=device)
    out = torch.empty(1 + 2 * (n_tok + span - 1), dtype=torch.int32, device=device)
    ms_d = cuda_time_ms(lambda it=0: K._dtw("dtw_path", weights[None], dims, path=out), iters=10)
    plain_d = cuda_time_ms(lambda it=0: K.dtw_codes_plain(weights[None], dims), iters=2)
    cells = n_tok * span
    bd_ms, bd_by = bound(cells * 4 + 2 * (n_tok + span) * 4, 6 * cells, F32_FLOPS)
    floor_ms = (n_tok + span - 1) * dtw_step_ns(torch, device) * 1e-6
    t_call = []
    for _ in range(5):
        t0 = time.perf_counter()
        K.dtw_path(weights)
        t_call.append((time.perf_counter() - t0) * 1e3)
    print(f"[c] dtw_path (n=200, m=1500): path equal to the plain version's ({len(path_k[0])} "
          f"steps); the kernel (DP and walk) {ms_d:.4f} ms vs plain codes {plain_d:.4f} ms, bound "
          f"{bd_ms:.4f} ms ({bd_by}), chain floor {floor_ms:.4f} ms; whole call with the path's "
          f"copy {min(t_call):.3f} ms (host clock, {', '.join(f'{t:.3f}' for t in t_call)})")
    rec["median9"]["launches"] = K.LAUNCHES["median9"]
    del scores, rows, c_k, c_p, out
    torch.cuda.empty_cache()
    return rec


# The front-end kernel's limits. The judge is a float64 FFT of the same
# frames (the witness, computed here with torch.fft.rfft, never by the
# port): the kernel within 2e-4 of it on the cells within 6 decades of
# their row's loudest and 1e-3 on every cell above the row's max - 8 floor,
# the limits the plain version meets on the CPU. Against the plain version:
# the raw log10 at atol 2e-4 above the floor (JAX's own bound for its
# kernel; the floor clamps the cells below away) and the normalized log-mel
# at atol 1e-4. The kernel takes an FFT and the plain version the DFT
# product, so they round differently where the FFT cannot resolve a bin
# (far below its frame's peak), and there the plain version's own rounding
# is as large: the kernel takes such bins again by the plain version's
# sums. The float64 answer's own distance from the plain version is
# printed beside the kernel's. The matmul
# against its plain version (f32 sums of bf16 products, each rounded once
# to bf16): 1e-2 of the output's largest magnitude.
MEL_ATOL, MEL_NORM_ATOL = 2e-4, 1e-4
MEL_LOUD_ATOL, MEL_ABOVE_ATOL = 2e-4, 1e-3
MATMUL_RTOL = 1e-2


def front_end_through(torch, K, audio, plain: bool):
    """``log_mel_spectrogram`` of ``audio`` (on the card) with 30 s of
    padding, through the kernel or through its plain version; returns the
    result and the peak memory the call added above what was allocated."""
    from whisper_timestamped_tpu_torch.audio import N_SAMPLES, log_mel_spectrogram

    saved = K.log10_mel
    if plain:
        K.log10_mel = K.log10_mel_plain
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = log_mel_spectrogram(audio, n_mels=128, padding=N_SAMPLES)
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base
    finally:
        K.log10_mel = saved


def mel_witness(torch, x, mel_w, n_frames):
    """The float64 log10 mel of the padded rows x (B, L): the frames times
    the periodic Hann window, ``torch.fft.rfft`` in float64, the power, the
    filterbank. The front-end kernel's witness, computed here only."""
    from whisper_timestamped_tpu_torch.audio import HOP_LENGTH, N_FFT

    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64, device=x.device)
    out = torch.empty((x.shape[0], mel_w.shape[0], n_frames), dtype=torch.float64, device=x.device)
    for b in range(x.shape[0]):  # a row at a time: a row's spectra are 21 MB a minute
        spec = torch.fft.rfft(x[b].double().unfold(-1, N_FFT, HOP_LENGTH)[:n_frames] * window)
        mel = (spec.real**2 + spec.imag**2) @ mel_w.double().T
        out[b] = torch.log10(torch.clamp(mel, min=1e-10)).T
    return out


def mel_library(torch, x, mel_w, n_frames):
    """The front-end kernel's function as several PyTorch calls, the
    yardstick ``library_ms`` times (the port never calls it): cuFFT's STFT
    of the frames with the window, the power, the mel product, the clamp
    and log10."""
    from whisper_timestamped_tpu_torch.audio import HOP_LENGTH, N_FFT

    window = torch.hann_window(N_FFT, periodic=True, device=x.device)
    spec = torch.stft(x, N_FFT, HOP_LENGTH, window=window, center=False, return_complex=True)
    return torch.log10(torch.clamp(mel_w @ spec[..., :n_frames].abs().square(), min=1e-10))


def phase_frontend_kernels(torch, K, device):
    """(c): ``log10_mel`` on (g)'s first stack (40 streams of 5-35 s, zero-
    padded to 35 s, plus 30 s) and on one 10-minute stream plus 30 s, the
    inputs ``log_mel_spectrogram`` gives it there, against its plain version
    and the float64 witness, beside the library calls; ``stacked_matmul`` at the
    decode step's shapes (fc1, fc2 and a D x D projection of large-v3, L=32)
    at B = 1, 8 and 40, cycling the layers so the weights come from memory,
    beside ``F.linear`` on the layer's slice (cuBLAS). Limits above.
    Returns both records, ``stacked_matmul``'s with its launches (no path
    runs it)."""
    import numpy as np

    from whisper_timestamped_tpu_torch.audio import (
        HOP_LENGTH, N_FFT, N_SAMPLES, _front_end_constants, _padded_audio)

    rec = {}
    rng = np.random.default_rng(40)
    secs = rng.integers(5, 36, 40)
    secs[::8] = 35
    stack = np.zeros((40, 35 * 16000), np.float32)
    for j, sec in enumerate(secs):
        stack[j, : int(sec) * 16000] = make_audio(1000 + j, int(sec))
    consts = _front_end_constants(128, N_FFT, device)
    n_bins, mel_nonzero = consts[0].shape[1], int((consts[2] != 0).sum())
    for label, host in (("[g] stack, B=40 x (35 s + 30 s)", stack),
                        ("one 10-minute stream + 30 s", make_audio(7, 600)[None])):
        audio = torch.from_numpy(host).to(device)
        x = _padded_audio(audio, N_SAMPLES, N_FFT // 2)
        raw_k = K.log10_mel(x, *consts, HOP_LENGTH)
        torch.cuda.synchronize()
        raw_p = K.log10_mel_plain(x, *consts, HOP_LENGTH)
        diff = (raw_k - raw_p).abs()
        above = raw_p >= raw_p.amax(dim=(-2, -1), keepdim=True) - 8.0
        err_raw, n_diff = diff[above].max().item(), int((diff > 0).sum())
        del diff, above
        exact = mel_witness(torch, x, consts[2], raw_k.shape[-1])
        above_p = raw_p >= raw_p.amax(dim=(-2, -1), keepdim=True) - 8.0
        exact_raw = (exact.float() - raw_p).abs()[above_p].max().item()
        top = exact.amax(dim=(-2, -1), keepdim=True)
        loud, above = exact >= top - 6.0, exact >= top - 8.0
        wit = {}
        for who, raw in (("kernel", raw_k), ("plain", raw_p)):
            d = (raw.double() - exact).abs()
            wit[who] = (d[loud].max().item(), d[above].max().item())
        # the float64 answer through the caller's clamp and normalization
        exact_norm = exact.float()
        exact_norm = torch.maximum(exact_norm, exact_norm.amax(dim=(-2, -1), keepdim=True) - 8.0)
        exact_norm = (exact_norm + 4.0) / 4.0
        del raw_p, exact, loud, above, above_p, d
        if not (wit["kernel"][0] <= MEL_LOUD_ATOL and wit["kernel"][1] <= MEL_ABOVE_ATOL):
            fail(f"log10_mel strays from the float64 FFT on the {label}: {wit['kernel'][0]:.3g} on "
                 f"the loud cells (atol {MEL_LOUD_ATOL}), {wit['kernel'][1]:.3g} above the floor "
                 f"(atol {MEL_ABOVE_ATOL})")
        norm_k, peak_k = front_end_through(torch, K, audio, plain=False)
        norm_p, peak_p = front_end_through(torch, K, audio, plain=True)
        err_norm = (norm_k - norm_p).abs().max().item()
        exact_norm = (exact_norm.reshape(norm_p.shape) - norm_p).abs().max().item()
        del norm_p
        if not (err_raw <= MEL_ATOL and err_norm <= MEL_NORM_ATOL):
            fail(f"log10_mel disagrees with its plain version on the {label}: raw "
                 f"{err_raw:.3g} above the max - 8 floor (atol {MEL_ATOL}), normalized "
                 f"{err_norm:.3g} (atol {MEL_NORM_ATOL}); the float64 answer's own "
                 f"distance from the plain version: {exact_raw:.3g} raw, "
                 f"{exact_norm:.3g} normalized")
        B, n_frames, n_cells = raw_k.shape[0], raw_k.shape[-1], raw_k.numel()
        out_bytes = norm_k.numel() * 4
        del raw_k, norm_k
        ms = cuda_time_ms(lambda it=0: K.log10_mel(x, *consts, HOP_LENGTH), iters=10)
        plain_ms = cuda_time_ms(lambda it=0: K.log10_mel_plain(x, *consts, HOP_LENGTH), iters=5)
        lib_ms = cuda_time_ms(lambda it=0: mel_library(torch, x, consts[2], n_frames), iters=10)
        # the least f32 work a frame: the window, a real FFT (2.5 n log2 n,
        # FFTW's count for a real transform), the power, the mel filters'
        # nonzero weights and the log10; the padded audio read once and the
        # mel written once
        flops = B * n_frames * (N_FFT + 2.5 * N_FFT * math.log2(N_FFT) + 3 * n_bins
                                + 2 * mel_nonzero + 128)
        b_ms, b_by = bound(x.numel() * 4 + out_bytes, flops, F32_FLOPS)
        frames = B * n_frames
        print(f"[c] log10_mel, {label} ({B} x {n_frames} frames, 128 mels): against the "
              f"plain version raw err {err_raw:.3g} above max - 8 ({n_diff} of {n_cells} cells "
              f"differ at all), normalized {err_norm:.3g}; the float64 answer's own distance "
              f"from it {exact_raw:.3g} raw, {exact_norm:.3g} normalized (limits "
              f"{MEL_ATOL} / {MEL_NORM_ATOL}); against the "
              f"float64 FFT, loud / above the floor: kernel {wit['kernel'][0]:.3g} / "
              f"{wit['kernel'][1]:.3g} (atol {MEL_LOUD_ATOL} / {MEL_ABOVE_ATOL}), plain "
              f"{wit['plain'][0]:.3g} / {wit['plain'][1]:.3g}; "
              f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, library calls (torch.stft + power + mel "
              f"product + log10, several launches) {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
              f"{flops / 1e9:.2f} GFLOP, {100 * b_ms / ms:.1f}% of it); log_mel_spectrogram's peak "
              f"memory above its input: kernel {peak_k / 1e6:.1f} MB ({peak_k / frames:.0f} B a "
              f"frame, {(peak_k - out_bytes) / frames:.0f} B without the output), plain "
              f"{peak_p / 1e6:.1f} MB ({peak_p / frames:.0f} B a frame, "
              f"{(peak_p - out_bytes) / frames:.0f} B without the output)")
        if "log10_mel" not in rec:
            rec["log10_mel"] = dict(max_abs_err=err_raw, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=b_by, library_ms=lib_ms)
        del x, audio
        torch.cuda.empty_cache()

    g = torch.Generator(device=device).manual_seed(3)
    L = 32
    K.reset_launches()
    worst = 0.0  # largest absolute error over every shape
    for k_in, n_out in ((1280, 5120), (5120, 1280), (1280, 1280)):
        w = (torch.randn((L, n_out, k_in), generator=g, device=device) * k_in**-0.5).bfloat16()
        for B in (1, 8, 40):
            x = torch.randn((B, k_in), generator=g, device=device).bfloat16()
            err = 0.0
            for layer in (0, 17, 31):
                o_k = K.stacked_matmul(x, w, layer)
                torch.cuda.synchronize()
                o_p = K.stacked_matmul_plain(x, w, layer).float()
                d = (o_k.float() - o_p).abs().max().item()
                worst = max(worst, d)
                err = max(err, d / o_p.abs().max().item())
            if not err <= MATMUL_RTOL:
                fail(f"stacked_matmul disagrees at B={B} K={k_in} N={n_out}: {err:.3g} of the "
                     f"output's largest magnitude (limit {MATMUL_RTOL})")
            ms = cuda_time_ms(lambda it=0: K.stacked_matmul(x, w, it % L))
            plain_ms = cuda_time_ms(lambda it=0: K.stacked_matmul_plain(x, w, it % L))
            lib_ms = cuda_time_ms(lambda it=0: torch.nn.functional.linear(x, w[it % L]))
            b_ms, b_by = bound(2 * (n_out * k_in + B * k_in + B * n_out), 2 * B * n_out * k_in,
                               BF16_FLOPS)
            print(f"[c] stacked_matmul B={B:2d} K={k_in} N={n_out} L=32: err {err:.3g} of the output "
                  f"scale (limit {MATMUL_RTOL}); {ms:.4f} ms vs plain {plain_ms:.4f} ms, F.linear "
                  f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {100 * b_ms / ms:.1f}% of it)")
            if (B, k_in, n_out) == (40, 1280, 5120):
                rec["stacked_matmul"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                             library_ms=lib_ms)
        del w
        torch.cuda.empty_cache()
    rec["stacked_matmul"].update(max_abs_err=worst, launches=K.LAUNCHES["stacked_matmul"])
    return rec


def make_audio(seed: int, seconds: int, rate: int = 16000):
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(rate * seconds) / rate
    tone = 0.2 * np.sin(2 * np.pi * (220.0 + 40 * seed) * t)
    return (tone + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


def large_v3_model(torch, device):
    """large-v3-geometry model (seeded random bf16 weights) and the
    synthetic full-vocabulary tokenizer, built as bench.py builds them."""
    from whisper_timestamped_tpu_torch.models import ALIGNMENT_HEADS, WhisperDims, WhisperModel, init_params
    from whisper_timestamped_tpu_torch.tokenizer import BytePairEncoder, Tokenizer, synthetic_ranks

    dims = WhisperDims(**LARGE_V3)
    module = init_params(dims, seed=0, dtype=torch.bfloat16, device=device)
    ranks = synthetic_ranks()
    pad_base = dims.n_vocab - 1509 - 100 - len(ranks)
    for i in range(pad_base):
        ranks[b"\x00" + str(i).encode()] = len(ranks)
    tok = Tokenizer(bpe=BytePairEncoder(ranks), multilingual=True, num_languages=100,
                    language="en", task="transcribe")
    assert tok.n_vocab == dims.n_vocab, (tok.n_vocab, dims.n_vocab)
    return WhisperModel(module=module, alignment_heads=ALIGNMENT_HEADS["large-v3"]), tok


def check_result(res: dict) -> int:
    """Schema of one transcription; returns its word count."""
    if not isinstance(res.get("text"), str) or not isinstance(res.get("segments"), list):
        fail("result lacks text/segments")
    n = 0
    for seg in res["segments"]:
        for w in seg.get("words", []):
            ok = (isinstance(w["text"], str) and w["start"] <= w["end"]
                  and 0.0 <= w["confidence"] <= 1.0)
            if not ok:
                fail(f"bad word {w}")
            n += 1
    return n


# Random weights never stop on their own terms the way a trained model does:
# the requests suppress EOT (as in the stuck_lm golden), so every window
# decodes its full token budget, and turn off the quality thresholds that
# would skip such windows.
SMOKE_OPTIONS = dict(language="en", no_speech_threshold=None, logprob_threshold=None,
                     compression_ratio_threshold=None)


@contextlib.contextmanager
def plain_encoder_and_prefill():
    """The encoder and prefill attention as before the flash kernel: the
    plain ``_attention`` math (bf16 scores, f32 softmax) in both places."""
    import whisper_timestamped_tpu_torch.decoding as dec
    import whisper_timestamped_tpu_torch.models.whisper_torch as wt

    saved = wt._encoder_attention, dec.PREFILL_FLASH_MIN_SLOTS
    wt._encoder_attention = lambda q, k, v, n: wt._attention(q, k, v, n)[0]
    dec.PREFILL_FLASH_MIN_SLOTS = 1 << 30
    try:
        yield
    finally:
        wt._encoder_attention, dec.PREFILL_FLASH_MIN_SLOTS = saved


def phase_end_to_end(torch, K, model, tok, label: str = "", expect_launches: bool = True):
    """(d): three requests through transcribe_timestamped. Returns the
    launch counts and the seconds per request."""
    from whisper_timestamped_tpu_torch import transcribe_timestamped
    from whisper_timestamped_tpu_torch.utils import get_counts, get_stage_timings, reset_stage_timings

    kw = dict(tokenizer=tok, suppress_tokens=f"-1,{tok.eot}", **SMOKE_OPTIONS)
    transcribe_timestamped(model, make_audio(0, 3), sample_len=4, **kw)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_stage_timings()
    K.reset_launches()
    words, secs = [], []
    for seed, seconds in ((1, 7), (2, 12), (3, 35)):
        t0 = time.perf_counter()
        res = transcribe_timestamped(model, make_audio(seed, seconds), **kw)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        words.append(check_result(res))
        print(f"[d]{label} request {seconds:2d} s audio: {secs[-1]:.2f} s, "
              f"{len(res['segments'])} segments, {words[-1]} words")
    launches = dict(K.LAUNCHES)
    timings, counts = get_stage_timings(), get_counts()
    if not any(words):
        fail("no request produced words")
    if expect_launches and not all(launches[k] for k in BF16_PATH):
        fail(f"a kernel was not launched on the serial path: {launches}")
    if launches["align_cost"] != launches["dtw_codes"]:
        fail(f"the aligner is not one align_cost and one dtw_codes launch a batch: {launches}")
    if any(launches[k] for k in QUANT_PATH):
        fail(f"a quantized-cache kernel ran on the bf16 path: {launches}")
    steps = counts.get("decode_steps", 0)
    if launches["self_attn_decode"] < model.dims.n_text_layer * steps:
        fail(f"self_attn_decode launched {launches['self_attn_decode']} times for {steps} decode "
             f"steps (expected >= {model.dims.n_text_layer} per step)")
    ms_step = 1e3 * timings["decode_loop"]["total_s"] / max(steps, 1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[d]{label} launches on the serial path: {launches}")
    print(f"[d]{label} seconds per request: {[round(s, 3) for s in secs]}; decode loop "
          f"{ms_step:.2f} ms/step over {steps} steps; stages "
          + ", ".join(f"{k} {v['total_s']:.2f}s" for k, v in sorted(timings.items()))
          + f"; peak memory {peak_gb:.2f} GB")
    return launches, secs


def phase_reference_step(torch, K, model, label: str = "bf16", **quantize):
    """(e): one decode step through the kernels against the plain versions,
    with the cache ``init_cache(**quantize)`` makes (bf16, or the int8 /
    int4 cross K/V, or the int8 self cache)."""
    import whisper_timestamped_tpu_torch.models.whisper_torch as wt

    def plain_self_int8(q, k_new, v_new, *cache_and_args):
        k_all, k_scale, v_all, v_scale, layer, pos, pad, H = cache_and_args
        K.write_quantized_row(k_new, v_new, k_all, k_scale, v_all, v_scale, layer, pos)
        return K.self_attn_decode_int8_plain(q, k_all, k_scale, v_all, v_scale, layer, pos, pad, H)

    def plain_self(q, k_all, v_all, layer, pos, pad, H, k_new, v_new):
        k_all[layer, :, pos] = k_new[:, 0]
        v_all[layer, :, pos] = v_new[:, 0]
        return K.self_attn_decode_plain(q, k_all, v_all, layer, pos, pad, H)

    plain = dict(self_attn_decode=plain_self, xattn_decode=K.xattn_decode_plain,
                 xattn_decode_int8=K.xattn_decode_int8_plain,
                 xattn_decode_int4=K.xattn_decode_int4_plain,
                 self_attn_decode_int8=plain_self_int8)
    module = model.module
    dev = module.device
    g = torch.Generator(device=dev).manual_seed(5)
    mel = torch.randn((1, 128, 3000), generator=g, device=dev)
    with torch.no_grad():
        xa = wt.encode(module, mel)
        cache = wt.init_cache(module, xa, ctx_len=240, **quantize)
        filled = (cache.k.shape[0], 1, 16, cache.k.shape[3])
        for t in (cache.k, cache.v):  # 16 slots already written, as by a prefill
            if t.dtype == torch.int8:
                t[:, :, :16].copy_(torch.randint(-127, 128, filled, generator=g, device=dev))
            else:
                t[:, :, :16].copy_(torch.randn(filled, generator=g, device=dev))
        for s in (cache.k_scale, cache.v_scale):
            if s is not None:
                s[:, :, :16].copy_(0.01 + 0.02 * torch.rand(filled[:3], generator=g, device=dev))
        tokens = torch.tensor([[1234]], device=dev)
        pad = torch.tensor([3], dtype=torch.int32, device=dev)
        heads = [(l, h) for l, h in model.alignment_heads]
        out = {}
        for name, swap in (("kernel", {}), ("plain", plain)):
            saved = {n: getattr(wt, n) for n in swap}
            for n, fn in swap.items():
                setattr(wt, n, fn)
            try:
                c = wt.KVCache(*(None if t is None else t.clone() for t in cache))
                out[name] = wt.decode_step(module, tokens, c, 16, pos_offset=pad,
                                           kv_valid_from=pad, align_heads=heads)
            finally:
                for n, fn in saved.items():
                    setattr(wt, n, fn)
    (lk, rk), (lp, rp) = out["kernel"], out["plain"]
    if not (torch.isfinite(lk).all() and torch.isfinite(rk).all()):
        fail(f"non-finite logits or scores ({label} cache)")
    rel_l = ((lk.float() - lp.float()).abs().max() / lp.float().abs().max()).item()
    rel_r = ((rk - rp).abs().max() / rp.abs().max()).item()
    if not (rel_l <= 2e-2 and rel_r <= 2e-2):
        fail(f"decode step ({label} cache) disagrees with its plain version: logits {rel_l:.3g}, "
             f"rows {rel_r:.3g}")
    print(f"[e] large-v3 decode step, {label} cache, kernels vs plain versions: logits max rel "
          f"err {rel_l:.3g}, alignment rows {rel_r:.3g} (limit 2e-2)")


def phase_reference_encode(torch, K, model):
    """(e): one large-v3 encode through the flash kernel against the plain
    version; the encoder at B=1 and B=8, through the kernel and through the
    plain attention math of before, with the peak memory of each.

    The check holds each layer's attention output, kernel against plain
    version on the same inputs, to a max relative error (largest difference
    over the largest value) of 2e-2, and the whole encode to a norm-wise
    relative error of 2e-2. The whole encode's max relative error is printed
    beside that of PyTorch's scaled_dot_product_attention and beside the
    change that 1e-3 added to one mel cell makes, not held: 32 bf16 layers
    of random weights carry any perturbation to a few percent of the
    largest output."""
    import whisper_timestamped_tpu_torch.models.whisper_torch as wt

    module = model.module
    dev = module.device
    g = torch.Generator(device=dev).manual_seed(6)
    mel = torch.randn((8, 128, 3000), generator=g, device=dev)

    def rel(a, b):
        a, b = a.float(), b.float()
        return ((a - b).abs().max() / b.abs().max()).item(), ((a - b).norm() / b.norm()).item()

    def encode_with(attention, x=mel[:1]):
        saved = wt.flash_attention
        wt.flash_attention = attention
        try:
            return wt.encode(module, x)
        finally:
            wt.flash_attention = saved

    per_layer = []

    def kernel_beside_plain(q, k, v, n_head, **kw):
        out = K.flash_attention(q, k, v, n_head, **kw)
        per_layer.append(rel(out, K.flash_attention_plain(q, k, v, n_head, **kw))[0])
        return out

    def library(q, k, v, n_head, **kw):
        o = torch.nn.functional.scaled_dot_product_attention(
            heads_view(q, n_head), heads_view(k, n_head), heads_view(v, n_head))
        return o.transpose(1, 2).reshape(q.shape)

    with torch.no_grad():
        xa_k = encode_with(kernel_beside_plain)
        xa_p = encode_with(K.flash_attention_plain)
        xa_s = encode_with(library)
        if not torch.isfinite(xa_k.float()).all():
            fail("non-finite encoder output")
        layer_rel = max(per_layer)
        max_rel, norm_rel = rel(xa_k, xa_p)
        lib_max_rel, lib_norm_rel = rel(xa_s, xa_p)
        if not (layer_rel <= 2e-2 and norm_rel <= 2e-2):
            fail(f"encode through flash_attention disagrees with its plain version: per layer "
                 f"{layer_rel:.3g}, whole encode norm-wise {norm_rel:.3g} (limits 2e-2)")
        print(f"[e] large-v3 encode, flash_attention vs its plain version: attention per layer "
              f"max rel err {layer_rel:.3g} (limit 2e-2); whole encode norm-wise rel err "
              f"{norm_rel:.3g} (limit 2e-2), max rel err {max_rel:.3g} (sdpa vs the plain "
              f"version: {lib_max_rel:.3g} max, {lib_norm_rel:.3g} norm-wise)")
        # the network's own sensitivity: the same path twice, and with 1e-3
        # added to one mel cell
        nudged = mel[:1].clone()
        nudged.view(-1)[12345] += 1e-3
        again = rel(encode_with(K.flash_attention), xa_k)[0]
        moved = rel(encode_with(K.flash_attention, nudged), xa_k)
        print(f"[e] large-v3 encode through the kernel, run twice: max rel difference {again:.3g}; "
              f"with 1e-3 added to one mel cell: {moved[0]:.3g} max, {moved[1]:.3g} norm-wise")
        del xa_k, xa_p, xa_s
        base = torch.cuda.memory_allocated()
        for B in (1, 8):
            line = []
            for name in ("kernel", "plain math", "kernel", "plain math"):
                ctx = plain_encoder_and_prefill() if name == "plain math" else contextlib.nullcontext()
                with ctx:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    ms = cuda_time_ms(lambda it=0: wt.encode(module, mel[:B]), iters=3)
                    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
                line.append(f"{name} {ms:.2f} ms (peak +{peak:.2f} GB)")
            print(f"[e] encoder stage, large-v3, B={B}, 32 layers: " + "; ".join(line))


def stage_line(timings: dict, name: str) -> str:
    """A stage's total seconds and calls, as the stage timer kept them."""
    t = timings.get(name)
    return f"{t['total_s']:.3f} s over {t['count']} calls" if t else "not run"


def phase_batch(torch, K, model, tok):
    """(f): the batched serving path at B=8, two batches of 8 streams."""
    from whisper_timestamped_tpu_torch import transcribe_batch, transcribe_batch_stream
    from whisper_timestamped_tpu_torch.decoding import DecodingOptions
    from whisper_timestamped_tpu_torch.engine import DecodeEngine
    from whisper_timestamped_tpu_torch.utils import get_counts, get_stage_timings, reset_stage_timings

    kw = dict(batch_size=8, temperature=[0.0], **SMOKE_OPTIONS,
              decode_options=DecodingOptions(suppress_tokens=f"-1,{tok.eot}"))
    lengths = ([35, 5, 12, 20, 8, 27, 15, 30], [10, 35, 6, 18, 25, 9, 33, 14])
    batches = [{f"b{i}s{j}": make_audio(10 * i + j, sec) for j, sec in enumerate(secs)}
               for i, secs in enumerate(lengths)]
    audio_s = sum(sum(secs) for secs in lengths)
    engine = DecodeEngine(model, tok)
    warm = {f"w{j}": make_audio(90 + j, 3) for j in range(8)}
    transcribe_batch(model, warm, tok, engine=engine,
                     **{**kw, "decode_options": DecodingOptions(suppress_tokens=f"-1,{tok.eot}",
                                                                sample_len=4)})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_stage_timings()
    K.reset_launches()
    t0 = time.perf_counter()
    got, at = [], []
    for res in transcribe_batch_stream(model, iter(batches), tok, engine=engine, **kw):
        got.append(res)
        at.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    timings, counts = get_stage_timings(), get_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    iterations = counts.get("decode_dispatch", 0)
    steps = counts.get("decode_steps", 0)
    words = [check_result(r) for res in got for r in res.values()]
    if len(got) != len(batches) or [list(r) for r in got] != [list(b) for b in batches]:
        fail("the stream's results are not the batches' streams, in order")
    if not any(words):
        fail("no stream produced words")
    if not all(launches[k] for k in BF16_PATH):
        fail(f"a kernel was not launched on the batched path: {launches}")
    if any(launches[k] for k in QUANT_PATH):
        fail(f"a quantized-cache kernel ran on the bf16 path: {launches}")
    if launches["flash_attention"] < 32 * iterations:
        fail(f"flash_attention launched {launches['flash_attention']} times for "
             f"{iterations} window iterations (expected >= 32 per iteration)")
    if launches["self_attn_decode"] < 32 * steps:
        fail(f"self_attn_decode launched {launches['self_attn_decode']} times for {steps} decode "
             f"steps (expected >= 32 per step)")
    if launches["align_cost"] != launches["dtw_codes"]:
        fail(f"the batched aligner is not one align_cost and one dtw_codes launch a batch: {launches}")
    print(f"[f] launches on the batched path: {launches}; {iterations} window iterations, "
          f"{steps} decode steps")
    print(f"[f] batch_align: {stage_line(timings, 'batch_align')}; aligner batches (align_cost "
          f"+ dtw_codes calls): {launches['align_cost']}")
    print(f"[f] transcribe_batch_stream, 2 batches x 8 streams ({audio_s} s of audio), B=8: "
          f"{wall:.2f} s wall, batches yielded at {[round(a, 2) for a in at]} s, "
          f"{wall / len(batches):.2f} s per batch, {audio_s / wall:.2f} audio-s per s, "
          f"decode loop {1e3 * timings['decode_loop']['total_s'] / max(steps, 1):.2f} ms/step, "
          f"peak memory {peak_gb:.2f} GB, {sum(words)} words")
    print("[f] stages: " + ", ".join(f"{k} {v['total_s']:.2f}s/{v['count']}"
                                     for k, v in sorted(timings.items())))
    for i, b in enumerate(batches):
        want = transcribe_batch(model, b, tok, engine=engine, **kw)
        for name in b:
            if [s["tokens"] for s in got[i][name]["segments"]] != \
                    [s["tokens"] for s in want[name]["segments"]]:
                fail(f"stream result for {name} differs from transcribe_batch on its batch")
    print("[f] the stream's results equal transcribe_batch on each batch alone (segment tokens)")
    return launches


def phase_production(torch, K, model, tok, turns: bool = False):
    """(g): the JAX package's production serving configuration
    (``README.md:91-93``): ``transcribe_batch_stream`` over two batches of
    40 streams at B=40 with a ``kv_int8`` engine, then the same streams with
    a bf16 engine (``turns``: kv_int8, bf16, bf16, kv_int8). Returns the
    first int8 run's launch counts."""
    import numpy as np

    from whisper_timestamped_tpu_torch import transcribe_batch, transcribe_batch_stream
    from whisper_timestamped_tpu_torch.decoding import DecodingOptions
    from whisper_timestamped_tpu_torch.engine import DecodeEngine
    from whisper_timestamped_tpu_torch.utils import get_counts, get_stage_timings, reset_stage_timings

    B, n_layer = 40, model.dims.n_text_layer
    kw = dict(batch_size=B, temperature=[0.0], **SMOKE_OPTIONS,
              decode_options=DecodingOptions(suppress_tokens=f"-1,{tok.eot}"))
    rng = np.random.default_rng(40)
    lengths = [rng.integers(5, 36, B) for _ in range(2)]
    for secs in lengths:
        secs[::8] = 35  # five 35 s streams a batch: a 232-slot prompt in the device flow
    batches = [{f"g{i}s{j}": make_audio(1000 + B * i + j, int(sec)) for j, sec in enumerate(secs)}
               for i, secs in enumerate(lengths)]
    audio_s = int(sum(s.sum() for s in lengths))
    runs = (("kv_int8", True), ("bf16", False))
    if turns:
        runs = runs + runs[::-1]
    int8_launches = None
    for label, kv_int8 in runs:
        engine = DecodeEngine(model, tok, kv_int8=kv_int8)
        warm = {f"w{j}": make_audio(90 + j, 3) for j in range(B)}
        transcribe_batch(model, warm, tok, engine=engine,
                         **{**kw, "decode_options": DecodingOptions(suppress_tokens=f"-1,{tok.eot}",
                                                                    sample_len=4)})
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_stage_timings()
        K.reset_launches()
        t0 = time.perf_counter()
        got = list(transcribe_batch_stream(model, iter(batches), tok, engine=engine, **kw))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        timings, counts = get_stage_timings(), get_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps = counts.get("decode_steps", 0)
        if [list(r) for r in got] != [list(b) for b in batches]:
            fail(f"[g] {label}: the stream's results are not the batches' streams, in order")
        words = {name: check_result(r) for res in got for name, r in res.items()}
        silent = [name for name, n in words.items() if n == 0]
        if label == "kv_int8":
            if silent:
                fail(f"[g] kv_int8: {len(silent)} of {len(words)} streams have no words: {silent}")
            if launches["xattn_decode_int8"] < n_layer * steps or launches["xattn_decode"]:
                fail(f"[g] kv_int8: xattn_decode_int8 launched {launches['xattn_decode_int8']} times "
                     f"for {steps} steps (expected >= {n_layer} per step), xattn_decode "
                     f"{launches['xattn_decode']} (expected 0)")
            int8_launches = int8_launches or launches
        elif launches["xattn_decode"] < n_layer * steps or launches["xattn_decode_int8"]:
            fail(f"[g] bf16: xattn_decode launched {launches['xattn_decode']} times for {steps} "
                 f"steps, xattn_decode_int8 {launches['xattn_decode_int8']} (expected 0)")
        print(f"[g] {label} engine, transcribe_batch_stream, 2 batches x {B} streams "
              f"({audio_s} s of audio), B={B}: {wall:.2f} s wall, {wall / len(batches):.2f} s per "
              f"batch, {audio_s / wall:.2f} audio-s per s, decode loop "
              f"{1e3 * timings['decode_loop']['total_s'] / max(steps, 1):.2f} ms/step over {steps} "
              f"steps, {counts.get('decode_dispatch', 0)} window iterations, peak memory "
              f"{peak_gb:.2f} GB, {sum(words.values())} words "
              f"({len(words) - len(silent)} of {len(words)} streams with words)")
        if not launches["align_cost"] or launches["align_cost"] != launches["dtw_codes"]:
            fail(f"[g] {label}: the batched aligner is not one align_cost and one dtw_codes "
                 f"launch a batch: {launches}")
        print(f"[g] {label} batch_align: {stage_line(timings, 'batch_align')}; aligner batches "
              f"{launches['align_cost']}")
        print(f"[g] {label} launches: {launches}; stages: "
              + ", ".join(f"{k} {v['total_s']:.2f}s/{v['count']}" for k, v in sorted(timings.items())))
        del got, engine
        torch.cuda.empty_cache()
    return int8_launches


def phase_levers(torch, K, model, tok):
    """(h): one batch of 8 streams with a ``kv_int4`` + ``self_kv_int8``
    engine, and one serial 35 s request with ``WTT_KV_INT8=1`` set around
    ``transcribe_timestamped``: each checked for its schema, for launches of
    its levers' kernels and for none of the bf16 kernels they replace.
    Returns the batch's launch counts."""
    from whisper_timestamped_tpu_torch import transcribe_batch, transcribe_timestamped
    from whisper_timestamped_tpu_torch.decoding import DecodingOptions
    from whisper_timestamped_tpu_torch.engine import DecodeEngine
    from whisper_timestamped_tpu_torch.utils import get_counts, get_stage_timings, reset_stage_timings

    engine = DecodeEngine(model, tok, kv_int4=True, self_kv_int8=True)
    n_layer = model.dims.n_text_layer
    batch = {f"h{j}": make_audio(2000 + j, sec) for j, sec in enumerate([35, 7, 12, 20, 28, 9, 16, 31])}
    reset_stage_timings()
    K.reset_launches()
    t0 = time.perf_counter()
    res = transcribe_batch(model, batch, tok, engine=engine, batch_size=8, temperature=[0.0],
                           decode_options=DecodingOptions(suppress_tokens=f"-1,{tok.eot}"),
                           **SMOKE_OPTIONS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    steps = get_counts().get("decode_steps", 0)
    ms_step = 1e3 * get_stage_timings()["decode_loop"]["total_s"] / max(steps, 1)
    words = sum(check_result(r) for r in res.values())
    if not words:
        fail("[h] kv_int4 + self_kv_int8: no stream produced words")
    if (launches["xattn_decode_int4"] < n_layer * steps
            or launches["self_attn_decode_int8"] < n_layer * steps
            or launches["xattn_decode"] or launches["self_attn_decode"] or launches["xattn_decode_int8"]):
        fail(f"[h] kv_int4 + self_kv_int8 launches for {steps} steps: {launches}")
    print(f"[h] kv_int4 + self_kv_int8 engine, transcribe_batch, 8 streams (158 s of audio): "
          f"{wall:.2f} s, {steps} steps, decode loop {ms_step:.2f} ms/step, {words} words; "
          f"launches {launches}")

    os.environ["WTT_KV_INT8"] = "1"
    try:
        K.reset_launches()
        t0 = time.perf_counter()
        out = transcribe_timestamped(model, make_audio(3, 35), tokenizer=tok,
                                     suppress_tokens=f"-1,{tok.eot}", **SMOKE_OPTIONS)
        torch.cuda.synchronize()
    finally:
        del os.environ["WTT_KV_INT8"]
    serial = dict(K.LAUNCHES)
    n = check_result(out)
    if not n or not serial["xattn_decode_int8"] or serial["xattn_decode"]:
        fail(f"[h] WTT_KV_INT8=1 transcribe_timestamped: {n} words, launches {serial}")
    print(f"[h] WTT_KV_INT8=1 transcribe_timestamped, 35 s: {time.perf_counter() - t0:.2f} s, "
          f"{len(out['segments'])} segments, {n} words; launches {serial}")
    return launches


def phase_host_alignment(torch, K, model, tok):
    """(i): alignment outside the batched device aligner, on the large-v3
    model with no known alignment heads (the top 6 layers' 120 heads, more
    than the device aligner's ``MAX_K``):

    - three serial requests (7, 12, 35 s) with ``detect_disfluencies``: the
      per-segment kernels; fails unless every request has words,
      ``attention_to_cost`` and ``dtw_codes`` launched once per aligned
      segment and ``align_cost`` never;
    - the 12 s request with ``device_alignment=False`` (numpy, no alignment
      kernel): the same words, start/end within 0.02 s of the kernel route;
    - the 12 s request with ``trust_whisper_timestamps=False`` (whole-window
      alignment on the host);
    - the 12 s request on the 10-head model with ``detect_disfluencies``:
      the batched aligner with its cost rows fetched;
    - ``transcribe_batch`` of 8 streams (5-35 s) with the 120 heads and
      ``detect_disfluencies``: the host route at assembly.

    Prints each run's stages and the phase's peak memory; returns the
    serial kernel route's launches."""
    import whisper_timestamped_tpu_torch.alignment as TA
    import whisper_timestamped_tpu_torch.api as api
    from whisper_timestamped_tpu_torch import transcribe_batch, transcribe_timestamped
    from whisper_timestamped_tpu_torch.decoding import DecodingOptions
    from whisper_timestamped_tpu_torch.models import WhisperModel
    from whisper_timestamped_tpu_torch.utils import get_stage_timings, reset_stage_timings

    L, H = model.dims.n_text_layer, model.dims.n_text_head
    unknown = WhisperModel(module=model.module, alignment_heads=None)
    kw = dict(tokenizer=tok, suppress_tokens=f"-1,{tok.eot}", **SMOKE_OPTIONS)
    aligned = []  # segments whose alignment plan is not empty
    wrapped = api.perform_word_alignment

    def counting(tokens, attention_scores, tokenizer, **akw):
        if attention_scores is not None and akw.get("precomputed_jumps") is None:
            plan = TA.plan_alignment(tokens, tokenizer,
                                     akw.get("refine_whisper_precision_nframes", 0),
                                     akw.get("unfinished_decoding", False))
            aligned.append(not plan.empty)
        return wrapped(tokens, attention_scores, tokenizer, **akw)

    def run(fn):
        reset_stage_timings()
        K.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        stages = ", ".join(f"{k} {v['total_s']:.2f}s" for k, v in sorted(get_stage_timings().items())
                           if k in ("align", "align_upload", "alignment_fetch", "batch_align",
                                    "batch_assemble", "decode"))
        return out, secs, dict(K.LAUNCHES), stages

    torch.cuda.reset_peak_memory_stats()
    api.perform_word_alignment = counting
    try:
        serial = []
        for seed, seconds in ((1, 7), (2, 12), (3, 35)):
            aligned.clear()
            res, secs, launches, stages = run(
                lambda: transcribe_timestamped(unknown, make_audio(seed, seconds),
                                               detect_disfluencies=True, **kw))
            n_words, n_aligned = check_result(res), sum(aligned)
            marks = sum(w["text"] == TA.DISFLUENCY_MARK for s in res["segments"]
                        for w in s.get("words", []))
            print(f"[i] 120 heads, per-segment kernels, {seconds:2d} s request, disfluencies: "
                  f"{secs:.2f} s, {len(res['segments'])} segments ({n_aligned} aligned), "
                  f"{n_words} words ({marks} disfluency marks); launches attention_to_cost "
                  f"{launches['attention_to_cost']}, dtw_codes {launches['dtw_codes']}, align_cost "
                  f"{launches['align_cost']}; stages {stages}")
            if not n_words:
                fail(f"[i] the {seconds} s request through the per-segment kernels has no words")
            if not (launches["attention_to_cost"] == launches["dtw_codes"] == n_aligned
                    and launches["align_cost"] == 0):
                fail(f"[i] {seconds} s: expected attention_to_cost and dtw_codes once per aligned "
                     f"segment ({n_aligned}) and no align_cost: {launches}")
            serial.append((res, launches))
        path_launches = {k: sum(l[k] for _, l in serial) for k in serial[0][1]}
    finally:
        api.perform_word_alignment = wrapped

    def words(res):
        return [w for s in res["segments"] for w in s.get("words", [])]

    host, secs, launches, stages = run(
        lambda: transcribe_timestamped(unknown, make_audio(2, 12), detect_disfluencies=True,
                                       device_alignment=False, **kw))
    if launches["attention_to_cost"] or launches["dtw_codes"] or launches["align_cost"]:
        fail(f"[i] device_alignment=False launched an alignment kernel: {launches}")
    w_host, w_kern = words(host), words(serial[1][0])
    if [w["text"] for w in w_host] != [w["text"] for w in w_kern]:
        fail(f"[i] the host route's words differ from the kernel route's "
             f"({len(w_host)} against {len(w_kern)} words)")
    moved = [max(abs(a["start"] - b["start"]), abs(a["end"] - b["end"]))
             for a, b in zip(w_host, w_kern)]
    n_moved = sum(d > 0 for d in moved)
    print(f"[i] 120 heads, device_alignment=False (numpy), 12 s: {secs:.2f} s, {len(w_host)} words, "
          f"texts equal to the kernel route's, {n_moved} with another start/end (largest "
          f"difference {max(moved, default=0.0):.3f} s, limit 0.02 s); stages {stages}")
    if max(moved, default=0.0) > 0.02 + 1e-9:
        fail(f"[i] the host and kernel routes' times differ by {max(moved):.3f} s (limit 0.02 s)")

    whole, secs, launches, stages = run(
        lambda: transcribe_timestamped(unknown, make_audio(2, 12),
                                       trust_whisper_timestamps=False, **kw))
    print(f"[i] 120 heads, trust_whisper_timestamps=False, 12 s: {secs:.2f} s, "
          f"{len(whole['segments'])} segments, {check_result(whole)} words; stages {stages}")

    fetched, secs, launches, stages = run(
        lambda: transcribe_timestamped(model, make_audio(2, 12), detect_disfluencies=True, **kw))
    n = check_result(fetched)
    if not n or not launches["align_cost"] or launches["attention_to_cost"]:
        fail(f"[i] 10 heads with disfluencies: {n} words, launches {launches} (expected the batched "
             f"aligner)")
    print(f"[i] 10 heads, batched aligner with fetch_cost, 12 s, disfluencies: {secs:.2f} s, {n} "
          f"words; launches align_cost {launches['align_cost']}, dtw_codes {launches['dtw_codes']}; "
          f"stages {stages}")

    top6 = WhisperModel(module=model.module,
                        alignment_heads=[(l, h) for l in range(max(0, L - 6), L) for h in range(H)])
    batch = {f"i{j}": make_audio(3000 + j, sec) for j, sec in enumerate([35, 5, 12, 20, 8, 27, 15, 30])}
    res, secs, launches, stages = run(
        lambda: transcribe_batch(top6, batch, tok, batch_size=8, temperature=[0.0],
                                 detect_disfluencies=True, **SMOKE_OPTIONS,
                                 decode_options=DecodingOptions(suppress_tokens=f"-1,{tok.eot}")))
    n = sum(check_result(r) for r in res.values())
    if not n or launches["align_cost"] or launches["attention_to_cost"]:
        fail(f"[i] batch with 120 heads: {n} words, launches {launches} (expected the host route)")
    print(f"[i] 120 heads, transcribe_batch of 8 streams (152 s of audio), disfluencies, host route: "
          f"{secs:.2f} s, {n} words; stages {stages}")
    print(f"[i] peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return path_launches


def write_wav(path: str, audio, rate: int) -> str:
    """16-bit mono WAV of float audio in [-1, 1]."""
    import wave

    import numpy as np

    pcm = np.clip(np.round(audio * 32767), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return path


def write_checkpoint(torch, model, tok, directory: str) -> str:
    """``model``'s weights as an OpenAI-format ``large-v3.pt`` (bf16; each
    stacked parameter copied to the host once, its layers saved as views)
    and the tokenizer's ranks as ``multilingual.tiktoken`` beside it, as
    ``load_model`` and the CLI find them. Returns the checkpoint's path."""
    import base64
    import dataclasses

    lin = {"q": "query", "k": "key", "v": "value", "o": "out"}
    block = {"attn": "attn", "cross": "cross_attn", "attn_ln": "attn_ln",
             "cross_ln": "cross_attn_ln", "mlp_ln": "mlp_ln", "fc1": "mlp.0", "fc2": "mlp.2"}
    single = {"conv1": "conv1", "conv2": "conv2", "ln_post": "ln_post", "ln": "ln"}
    kinds = {"w": "weight", "b": "bias", "g": "weight"}
    sd = {}
    for side, params in (("encoder", model.module.encoder), ("decoder", model.module.decoder)):
        for key, p in params.items():
            t = p.detach().cpu()
            if key == "pos_emb":
                sd[f"{side}.positional_embedding"] = t
                continue
            if key == "tok_emb":
                sd["decoder.token_embedding.weight"] = t
                continue
            stem, kind = key.rsplit("_", 1)
            if stem in single:
                sd[f"{side}.{single[stem]}.{kinds[kind]}"] = t
                continue
            if stem in block:
                name = block[stem]
            else:
                attn, proj = stem.split("_")
                name = f"{block[attn]}.{lin[proj]}"
            for i in range(t.shape[0]):
                sd[f"{side}.blocks.{i}.{name}.{kinds[kind]}"] = t[i]
    path = os.path.join(directory, "large-v3.pt")
    torch.save({"dims": dataclasses.asdict(model.dims), "model_state_dict": sd}, path)
    with open(os.path.join(directory, "multilingual.tiktoken"), "wb") as f:
        for token, rank in tok.bpe.ranks.items():
            f.write(base64.b64encode(token) + b" " + str(rank).encode() + b"\n")
    return path


# the six formats of each input, with the word-level variants
CLI_OUTPUTS = (".words.json", ".txt", ".vtt", ".srt", ".csv", ".tsv", ".words.vtt",
               ".words.srt", ".words.csv", ".words.tsv")


def check_cli_outputs(out_dir: str, wavs) -> list:
    """Every format of every input written; returns the word counts."""
    words = []
    for wav in wavs:
        base = os.path.join(out_dir, os.path.basename(wav))
        missing = [ext for ext in CLI_OUTPUTS if not os.path.isfile(base + ext)]
        if missing:
            fail(f"[j] {os.path.basename(wav)}: no {missing} in {out_dir}")
        with open(base + ".words.json", encoding="utf-8") as f:
            words.append(check_result(json.load(f)))
    return words


def phase_cli(torch, K, model, tok, here: str):
    """(j): the command line on the card, on a checkpoint of ``model``
    written to a directory under ``build/`` (deleted at the end):

    1. serial: ``cli.main`` in-process on three WAVs (7, 12 and 35 s; the
       12 s one at 44.1 kHz) with ``-f all``, EOT suppressed and the three
       thresholds off: every format of every input, the schema, and
       ``log10_mel`` with the bf16 path's five kernels launched (counts
       reset just before, read just after);
    2. batched: ``--batch_size 8`` on eight WAVs of 5-35 s: every format,
       words in every file, the segment tokens of each equal to
       ``transcribe_batch`` on the same files with ``model``;
    3. one CLI run in a subprocess with ``sys.modules['jax'] = None`` (a
       16 kHz file: scipy's resampler trips on that entry) must exit 0;
    4. ``make_subtitles.main`` on a words JSON of (1).

    Prints each run's wall time (the checkpoint's load included), seconds a
    file, the front-end stage (``mel``; ``prepare_audio`` in the batched
    loop) and peak memory. Returns the launches of (1) and (2) together."""
    from whisper_timestamped_tpu_torch import cli, make_subtitles, transcribe_batch
    from whisper_timestamped_tpu_torch.decoding import DecodingOptions
    from whisper_timestamped_tpu_torch.utils import get_stage_timings, reset_stage_timings

    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="cli_", dir=os.path.join(here, "build"))
    try:
        t0 = time.perf_counter()
        ckpt = write_checkpoint(torch, model, tok, work)
        print(f"[j] large-v3 checkpoint ({os.path.getsize(ckpt) / 1e9:.2f} GB) and vocabulary "
              f"written in {time.perf_counter() - t0:.1f} s")
        common = ["--model", ckpt, "--language", "en", f"--suppress_tokens=-1,{tok.eot}",
                  "--no_speech_threshold", "None", "--logprob_threshold", "None",
                  "--compression_ratio_threshold", "None"]

        def wav(name, seed, seconds, rate=16000):
            return write_wav(os.path.join(work, name), make_audio(seed, seconds, rate), rate)

        def run(label, wavs, out, *extra):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_stage_timings()
            K.reset_launches()
            t0 = time.perf_counter()
            cli.main([*wavs, "-o", out, "-f", "all", *common, *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, stages = dict(K.LAUNCHES), get_stage_timings()
            words = check_cli_outputs(out, wavs)
            front = ", ".join(f"{k} {v['total_s']:.3f} s/{v['count']}" for k, v in sorted(stages.items())
                              if k in ("mel", "prepare_audio"))
            print(f"[j] {label}: {wall:.2f} s wall ({wall / len(wavs):.2f} s a file, the load "
                  f"included), front end {front}, peak memory "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, words {words}; launches "
                  f"{launches}")
            print(f"[j] {label} stages: " + ", ".join(f"{k} {v['total_s']:.2f}s/{v['count']}"
                                                       for k, v in sorted(stages.items())))
            return launches, words

        serial = [wav("s7.wav", 1, 7), wav("s12.wav", 2, 12, rate=44100), wav("s35.wav", 3, 35)]
        launches, words = run("serial, 3 files (7, 12 s at 44.1 kHz, 35 s)", serial,
                              os.path.join(work, "serial"))
        if not any(words):
            fail("[j] the serial CLI run produced no words")
        missing = [k for k in ("log10_mel", *BF16_PATH) if not launches[k]]
        if missing:
            fail(f"[j] the serial CLI run did not launch {missing}: {launches}")
        total = dict(launches)

        lengths = [35, 5, 12, 20, 8, 27, 15, 30]
        batch = [wav(f"b{j}.wav", 4000 + j, sec) for j, sec in enumerate(lengths)]
        out = os.path.join(work, "batched")
        launches, words = run(f"--batch_size 8, 8 files ({sum(lengths)} s)", batch, out,
                              "--batch_size", "8")
        if not all(words):
            fail(f"[j] a file of the batched CLI run has no words: {words}")
        if not launches["log10_mel"]:
            fail(f"[j] the batched CLI run did not launch log10_mel: {launches}")
        total = {k: total[k] + launches[k] for k in total}
        want = transcribe_batch(model, {p: p for p in batch}, tok, batch_size=8, temperature=[0.0],
                                decode_options=DecodingOptions(suppress_tokens=f"-1,{tok.eot}"),
                                **SMOKE_OPTIONS)
        for p in batch:
            with open(os.path.join(out, os.path.basename(p) + ".words.json"), encoding="utf-8") as f:
                got = json.load(f)
            if [s["tokens"] for s in got["segments"]] != [s["tokens"] for s in want[p]["segments"]]:
                fail(f"[j] the batched CLI's {os.path.basename(p)} differs from transcribe_batch")
        print("[j] the batched CLI's files equal transcribe_batch on the same files (segment tokens)")

        torch.cuda.empty_cache()
        out = os.path.join(work, "subprocess")
        code = ("import sys; sys.modules['jax'] = None; "
                "from whisper_timestamped_tpu_torch.cli import main; main()")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code, serial[0], "-o", out, *common],
                              cwd=here, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"[j] the CLI in a subprocess without JAX exited {proc.returncode}: "
                 f"{proc.stderr[-3000:]}")
        words = check_cli_outputs(out, serial[:1])
        print(f"[j] subprocess without JAX, 7 s file: exit 0 in {time.perf_counter() - t0:.2f} s "
              f"(the start and the load included), {words[0]} words")

        subs = os.path.join(work, "subtitles")
        make_subtitles.main([os.path.join(work, "serial", "s35.wav.words.json"), subs,
                             "--max_length", "42"])
        if sorted(os.listdir(subs)) != ["s35.wav.srt", "s35.wav.vtt"]:
            fail(f"[j] make_subtitles wrote {os.listdir(subs)}")
        with open(os.path.join(subs, "s35.wav.srt"), encoding="utf-8") as f:
            cues = f.read().count(" --> ")
        print(f"[j] make_subtitles --max_length 42 on the 35 s words JSON: {cues} srt cues")
        return total
    finally:
        shutil.rmtree(work, ignore_errors=True)


# [k]'s quality thresholds: random weights fail them at every temperature
# (their log-probs sit far below -0.5), as in the temperature_fallback
# golden, so every window is decoded again at each step of the schedule
FALLBACK_OPTIONS = dict(language="en", compression_ratio_threshold=None, logprob_threshold=-0.5,
                        no_speech_threshold=0.99)


def phase_sampler(torch, device):
    """(k): the sampler alone. One fixed (40, 51866) f32 logits batch with
    -inf columns, drawn 4096 times through ``make_gumbel_source`` and
    ``sample_tokens`` at T = 0.2 and 1.0: each row's frequencies of its 16
    likeliest tokens within 5 standard errors of softmax(logits / T), and no
    -inf column drawn. Each row's 16 likeliest logits lie within 0.3 of each
    other and the rest about 8 below, so each of the 16 has an expected
    count of tens at both temperatures (a normal approximation of a count
    near 0 would fail a right sampler). Times one draw (and one draw plus
    its argmax) at B = 1, 8 and 40."""
    from whisper_timestamped_tpu_torch.decoding import (
        make_gumbel_source,
        sample_tokens,
        temperature_divisor,
    )

    B, V, n = 40, LARGE_V3["n_vocab"], 4096
    g = torch.Generator(device=device).manual_seed(77)
    logits = torch.randn((B, V), generator=g, device=device) - 8.0
    logits[:, 50000:50400] = float("-inf")
    logits[torch.rand((B, V), generator=g, device=device) < 0.1] = float("-inf")
    rows = torch.arange(B, device=device)
    # 16 finite columns a row (the first 16 of a random order of the
    # finite ones) take logits 0 to 0.3
    order = torch.rand((B, V), generator=g, device=device).masked_fill(torch.isinf(logits), 2.0)
    logits.scatter_(1, order.argsort(dim=1)[:, :16],
                    torch.linspace(0.0, 0.3, 16, device=device).expand(B, 16).contiguous())
    worst = 0.0
    for T in (0.2, 1.0):
        draw = make_gumbel_source(123, device)
        t_div = temperature_divisor(T, device)
        counts = torch.zeros((B, V), dtype=torch.float64, device=device)
        for _ in range(n):
            counts[rows, sample_tokens(logits, t_div, draw)] += 1
        if counts[torch.isinf(logits)].sum().item() != 0:
            fail(f"[k] the sampler drew a -inf column at T={T}")
        p = torch.softmax(logits.double() / T, dim=-1)
        top = p.topk(16, dim=-1).indices
        pt, ft = p.gather(1, top), counts.gather(1, top) / n
        se = (pt * (1 - pt) / n).sqrt()
        z = ((ft - pt).abs() / se.clamp_min(1e-30)).max().item()
        worst = max(worst, z)
        if not bool(((ft - pt).abs() <= 5 * se).all()):
            fail(f"[k] sampler frequencies at T={T} off the softmax by {z:.2f} standard errors "
                 "(limit 5)")
        print(f"[k] sampler, (40, {V}) logits, {n} draws, T={T}: the 16 likeliest tokens of each "
              f"row within {z:.2f} standard errors of softmax(logits/T) (limit 5); no -inf "
              f"column drawn; top-token probability {pt[:, 0].mean().item():.3f} on average")
    times = []
    for b in (1, 8, 40):
        draw = make_gumbel_source(5, device)
        t_div = temperature_divisor(0.7, device)
        x = logits[:b].contiguous()
        times.append((b, cuda_time_ms(lambda it=0: draw(b, V), iters=50),
                      cuda_time_ms(lambda it=0: sample_tokens(x, t_div, draw), iters=50)))
    print("[k] sampler per step: " + "; ".join(
        f"B={b}: draw {d:.4f} ms, draw + argmax {s:.4f} ms" for b, d, s in times))


def phase_sampling(torch, K, model, tok):
    """(k): sampling, the temperature fallback and the two-pass engine at
    large-v3 width, EOT suppressed (every window decodes its 224 tokens):

    1. serial: ``transcribe_timestamped`` on one 30 s request with the
       schedule (0.0, 0.2, 0.4) and ``FALLBACK_OPTIONS``; every kernel of
       the bf16 path launched (counts reset just before, read just after);
       the same ``seed`` twice gives the same tokens, another seed others
       (24-token windows at T=0.7);
    2. batched: ``transcribe_batch`` at B=8 on eight 5-35 s streams, once
       with the schedule (0.0, 0.2) and ``FALLBACK_OPTIONS`` (windows
       re-decoded, ``align_cost``/``dtw_codes`` launched), once at
       ``temperature=[0.7]`` with ``best_of=2``;
    3. two-pass: ``naive_approach`` with ``best_of=2`` at T=0.7 on a 35 s
       request: ``log10_mel`` and ``flash_attention`` launched in pass 2.

    Prints seconds, ms/step, re-decoded windows, teacher-forced segments
    and peak memory."""
    import whisper_timestamped_tpu_torch.engine_naive as naive
    from whisper_timestamped_tpu_torch import transcribe_batch, transcribe_timestamped
    from whisper_timestamped_tpu_torch.decoding import DecodingOptions
    from whisper_timestamped_tpu_torch.utils import get_counts, get_stage_timings, reset_stage_timings

    eot_off = f"-1,{tok.eot}"

    def begin():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_stage_timings()
        K.reset_launches()
        return time.perf_counter()

    def end(t0):
        torch.cuda.synchronize()
        steps = get_counts().get("decode_steps", 0)
        loop = get_stage_timings().get("decode_loop", {}).get("total_s", 0.0)
        return (time.perf_counter() - t0, 1e3 * loop / max(steps, 1), steps,
                torch.cuda.max_memory_allocated() / 1e9, dict(K.LAUNCHES), get_counts())

    # 1. serial, with the fallback schedule
    t0 = begin()
    res = transcribe_timestamped(model, make_audio(50, 30), tokenizer=tok, suppress_tokens=eot_off,
                                 temperature=(0.0, 0.2, 0.4), **FALLBACK_OPTIONS)
    secs, ms_step, steps, peak, launches, _ = end(t0)
    words = check_result(res)
    temps = sorted({s["temperature"] for s in res["segments"]})
    windows = len({s["seek"] for s in res["segments"]})
    if not all(launches[k] for k in BF16_PATH):
        fail(f"[k] serial fallback: a bf16-path kernel was not launched: {launches}")
    if temps != [0.4] or not words:
        fail(f"[k] serial fallback: windows ended at temperatures {temps} (expected [0.4]), "
             f"{words} words")
    print(f"[k] serial transcribe_timestamped, 30 s, schedule (0.0, 0.2, 0.4), logprob "
          f"threshold -0.5: {secs:.2f} s, {windows} window(s) ended at temperature {temps}, "
          f"{steps} decode steps, {ms_step:.2f} ms/step, {words} words, peak memory {peak:.2f} GB; "
          f"bf16-path launches {({k: launches[k] for k in BF16_PATH})}")
    seeded = [transcribe_timestamped(model, make_audio(51, 7), tokenizer=tok, suppress_tokens=eot_off,
                                     temperature=0.7, sample_len=24, seed=seed, **SMOKE_OPTIONS)
              for seed in (1, 1, 2)]
    toks = [[s["tokens"] for s in r["segments"]] for r in seeded]
    if toks[0] != toks[1] or toks[0] == toks[2]:
        fail("[k] sampling on the card: the same seed did not repeat its tokens, or another "
             "seed gave the same")
    print("[k] sampling on the card, T=0.7, 24-token windows: seed 1 twice gives the same tokens, "
          "seed 2 others")

    # 2. batched, B=8
    streams = {f"k{j}": make_audio(3000 + j, sec) for j, sec in enumerate([35, 5, 12, 20, 8, 27, 15, 30])}
    audio_s = 152
    for label, kw in (
        ("schedule (0.0, 0.2)", dict(temperature=[0.0, 0.2], **FALLBACK_OPTIONS,
                                     decode_options=DecodingOptions(suppress_tokens=eot_off))),
        ("temperature [0.7], best_of=2", dict(temperature=[0.7], **SMOKE_OPTIONS,
                                              decode_options=DecodingOptions(
                                                  suppress_tokens=eot_off, best_of=2))),
    ):
        t0 = begin()
        res = transcribe_batch(model, streams, tok, batch_size=8, **kw)
        secs, ms_step, steps, peak, launches, counts = end(t0)
        words = sum(check_result(r) for r in res.values())
        redecoded = counts.get("fallback_redecodes", 0)
        temps = sorted({s["temperature"] for r in res.values() for s in r["segments"]})
        if not launches["align_cost"] or launches["align_cost"] != launches["dtw_codes"]:
            fail(f"[k] batched {label}: align_cost/dtw_codes not launched one each a batch: "
                 f"{launches}")
        if label.startswith("schedule") and (not redecoded or temps != [0.2]):
            fail(f"[k] batched {label}: {redecoded} windows re-decoded, temperatures {temps}")
        if not label.startswith("schedule") and temps != [0.7]:
            fail(f"[k] batched {label}: temperatures {temps}")
        if not words:
            fail(f"[k] batched {label}: no words")
        print(f"[k] transcribe_batch, B=8, 8 streams ({audio_s} s of audio), {label}: "
              f"{secs:.2f} s, {counts.get('decode_dispatch', 0)} decode calls, {redecoded} windows "
              f"re-decoded, {steps} decode steps, {ms_step:.2f} ms/step, {words} words, peak "
              f"memory {peak:.2f} GB; launches {launches}")

    # 3. the two-pass engine; the launches of pass 2 alone
    pass2 = {}
    serial_driver = naive.drive_teacher_forced_serial

    def counted_driver(gen, engine):
        torch.cuda.synchronize()
        before = dict(K.LAUNCHES)
        try:
            return serial_driver(gen, engine)
        finally:
            torch.cuda.synchronize()
            pass2.update({k: K.LAUNCHES[k] - before[k] for k in before})

    naive.drive_teacher_forced_serial = counted_driver
    try:
        t0 = begin()
        res = transcribe_timestamped(model, make_audio(52, 35), tokenizer=tok,
                                     suppress_tokens=eot_off, naive_approach=True, best_of=2,
                                     temperature=0.7, **SMOKE_OPTIONS)
        secs, ms_step, steps, peak, launches, counts = end(t0)
    finally:
        naive.drive_teacher_forced_serial = serial_driver
    timings = get_stage_timings()
    words = check_result(res)
    if not (pass2.get("log10_mel") and pass2.get("flash_attention")) or not words:
        fail(f"[k] two-pass: pass 2 launches {pass2}, {words} words")
    print(f"[k] two-pass transcribe_timestamped, 35 s, best_of=2, T=0.7: {secs:.2f} s (pass 1 "
          f"{stage_line(timings, 'naive_pass1')}, pass 2 {stage_line(timings, 'naive_pass2')}), "
          f"{counts.get('tf_segments', 0)} teacher-forced segments, {steps} decode steps at "
          f"{ms_step:.2f} ms/step, {words} words, peak memory {peak:.2f} GB; pass 2 launches "
          f"{ {k: v for k, v in pass2.items() if v} }")


def phase_beam(torch, K, model, tok):
    """(l): beam search at large-v3 width, EOT suppressed (no beam finishes;
    every window runs its 224 steps, or to the text context's end):

    1. serial: ``transcribe_timestamped`` on a 30 s request with the
       ``--accurate`` options (beam 5, best_of 5, the schedule 0.0-1.0 by
       0.2) and no thresholds, so each window is one beam decode, then the
       two-pass engine's pass 2;
    2. batched: ``transcribe_batch`` with beam 5 on eight 5-30 s streams
       at B=8 (40 beam rows), with a bf16 engine and with ``kv_int8``;
       the self-KV reorder timed alone at that shape (CUDA events);
    3. a ``beam_size=1`` decode equals the greedy decode of the same window
       (a 20-token prompt, so both prefill the 232-slot region, and no
       alignment rows).

    Fails unless every result is well formed, ``log10_mel``,
    ``flash_attention`` and ``self_attn_decode`` launch, the cross-attention
    kernel of the cache's type launches 32 times a decode step (the other
    never), every decode step's cross K/V has B rows while its queries have
    B·K (the cross-KV is not tiled), and the K=1 tokens equal greedy's.
    Prints s/request, s/batch, decode steps, ms/step, peak memory and the
    launches."""
    import whisper_timestamped_tpu_torch.decoding_beam as beam
    from whisper_timestamped_tpu_torch import transcribe_batch, transcribe_timestamped
    from whisper_timestamped_tpu_torch.audio import log_mel_spectrogram
    from whisper_timestamped_tpu_torch.decoding import DecodingOptions
    from whisper_timestamped_tpu_torch.engine import DecodeEngine
    from whisper_timestamped_tpu_torch.utils import get_counts, get_stage_timings, reset_stage_timings

    eot_off = f"-1,{tok.eot}"
    L = model.dims.n_text_layer
    rows_seen = set()  # (query rows, cross-KV rows) of every beam decode step
    step = beam.decode_step

    def spy_step(mod, tokens, cache, *a, **kw):
        rows_seen.add((tokens.shape[0], cache.xk.shape[1], kw.get("beam_group")))
        return step(mod, tokens, cache, *a, **kw)

    def begin():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_stage_timings()
        K.reset_launches()
        rows_seen.clear()
        return time.perf_counter()

    def end(t0, label, cross, other):
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts, timings, launches = get_counts(), get_stage_timings(), dict(K.LAUNCHES)
        steps = counts.get("decode_steps", 0)
        ms_step = 1e3 * timings.get("decode_loop", {}).get("total_s", 0.0) / max(steps, 1)
        peak = torch.cuda.max_memory_allocated() / 1e9
        for k in ("log10_mel", "flash_attention", "self_attn_decode"):
            if not launches[k]:
                fail(f"[l] {label}: {k} was not launched: {launches}")
        if launches[cross] != L * steps or launches[other]:
            fail(f"[l] {label}: {cross} launched {launches[cross]} times for {steps} decode steps "
                 f"(expected {L} a step), {other} {launches[other]} (expected 0)")
        return secs, steps, ms_step, peak, launches, timings

    beam.decode_step = spy_step
    try:
        # 1. serial, the --accurate options
        t0 = begin()
        res = transcribe_timestamped(model, make_audio(60, 30), tokenizer=tok,
                                     suppress_tokens=eot_off, beam_size=5, best_of=5,
                                     temperature=(0.0, 0.2, 0.4, 0.6, 0.8, 1.0), **SMOKE_OPTIONS)
        secs, steps, ms_step, peak, launches, timings = end(t0, "serial", "xattn_decode",
                                                            "xattn_decode_int8")
        words = check_result(res)
        if rows_seen != {(5, 1, 5)} or not words or {s["temperature"] for s in res["segments"]} != {0.0}:
            fail(f"[l] serial: step rows {rows_seen} (expected 5 beam rows over 1 cross-KV row), "
                 f"{words} words, temperatures {({s['temperature'] for s in res['segments']})}")
        print(f"[l] serial transcribe_timestamped, 30 s, beam 5 best_of 5 (--accurate), no "
              f"thresholds: {secs:.2f} s a request ({len({s['seek'] for s in res['segments']})} "
              f"window(s); pass 1 {stage_line(timings, 'naive_pass1')}, pass 2 "
              f"{stage_line(timings, 'naive_pass2')}), {steps} decode steps at {ms_step:.2f} ms/step, "
              f"beam_reorder (host) {stage_line(timings, 'beam_reorder')}, {words} words, peak "
              f"memory {peak:.2f} GB; launches {launches}")

        # 2. batched, B=8 x K=5, bf16 and kv_int8
        streams = {f"l{j}": make_audio(4000 + j, sec)
                   for j, sec in enumerate([30, 5, 12, 20, 8, 27, 15, 25])}
        for label, engine, cross, other in (
                ("bf16", DecodeEngine(model, tok), "xattn_decode", "xattn_decode_int8"),
                ("kv_int8", DecodeEngine(model, tok, kv_int8=True), "xattn_decode_int8",
                 "xattn_decode")):
            t0 = begin()
            res = transcribe_batch(model, streams, tok, batch_size=8, engine=engine,
                                   temperature=[0.0], **SMOKE_OPTIONS,
                                   decode_options=DecodingOptions(beam_size=5,
                                                                  suppress_tokens=eot_off))
            secs, steps, ms_step, peak, launches, timings = end(t0, f"batched {label}", cross,
                                                                other)
            words = sum(check_result(r) for r in res.values())
            if rows_seen != {(40, 8, 5)} or not words:
                fail(f"[l] batched {label}: step rows {rows_seen} (expected 40 beam rows over 8 "
                     f"cross-KV rows), {words} words")
            iters = sum(v for k, v in get_counts().items() if k.startswith("batch_decode_b"))
            print(f"[l] transcribe_batch, beam 5, B=8 x 5 = 40 rows over 8 cross-KV rows, {label}, "
                  f"8 streams (142 s of audio): {secs:.2f} s, {iters} window iteration(s), "
                  f"{steps} decode steps at {ms_step:.2f} ms/step, pass 2 "
                  f"{stage_line(timings, 'batch_naive_align')}, beam_reorder (host) "
                  f"{stage_line(timings, 'beam_reorder')}, {words} words, peak memory {peak:.2f} GB; "
                  f"launches {launches}")
    finally:
        beam.decode_step = step

    # the self-KV reorder alone at B=8 x K=5, the slots written so far
    ctx, R, D = 456, 40, model.dims.n_text_state
    cur = torch.randn((L, R, ctx, D), device=model.device).bfloat16()
    spare = torch.empty_like(cur)
    rows = (torch.arange(8, device=model.device)[:, None] * 5
            + torch.randint(0, 5, (8, 5), device=model.device)).reshape(-1)
    parts = []
    for n_slots in (233, 344, 455):
        ms = cuda_time_ms(lambda it=0: beam.reorder_rows(cur, spare, rows, n_slots))
        b_ms, _ = bound(2 * L * R * n_slots * D * 2, 0, BF16_FLOPS)
        parts.append(f"{n_slots} slots {2 * ms:.4f} ms (bound {2 * b_ms:.4f})")
    if not torch.equal(beam.reorder_rows(cur, spare, rows, 300)[:, :, :300], cur[:, rows, :300]):
        fail("[l] reorder_rows on the card differs from the plain gather")
    print(f"[l] self-KV reorder a step, K and V (L=32, 40 rows, D=1280, bf16, read + write of "
          f"the written slots): " + "; ".join(parts))
    del cur, spare
    torch.cuda.empty_cache()

    # 3. beam_size=1 against greedy on one window
    engine = DecodeEngine(model, tok)
    mel = log_mel_spectrogram(make_audio(61, 30), n_mels=model.dims.n_mels, device=model.device)
    mel = mel[:, :3000]
    prompt = list(range(1000, 1020))
    opts = dict(language="en", sample_len=64, suppress_tokens=eot_off)
    greedy = engine.decode_window(mel, DecodingOptions(**opts), prompt, capture_attention=False)[0]
    one = engine.decode_window_beam(mel, DecodingOptions(beam_size=1, **opts), prompt)
    if one.tokens != greedy.tokens:
        fail(f"[l] beam_size=1 differs from greedy: {one.tokens[:12]} vs {greedy.tokens[:12]}")
    print(f"[l] beam_size=1 equals greedy on the card: {len(one.tokens)} tokens, sum log-prob "
          f"{one.sum_logprob:.4f} vs {greedy.sum_logprob:.4f}")


def phase_train(torch, K, device):
    """(m): fine-tuning at large-v3 width: ``make_train_step``'s AdamW steps
    (optax's ``adamw(1e-5)``) on f32 seeded weights, one fixed batch of two
    30 s windows of seeded audio (mel through ``log10_mel``) and 224 seeded
    tokens a row. First the loss and gradients through the kernels against
    the same with the plain versions in ``FlashAttentionFn`` (one step's
    worth, on the initial weights), then a warm step and five timed steps:
    fails unless the losses are finite, the last is below the first, and
    every step launched the three training kernels once a layer and the
    inference kernel never. Prints ms/step, peak memory and the launches,
    and two steps with each layer read as ``w[l]`` (not ``unbind``) for
    the step time of that form. Returns the launches of the timed steps."""
    import whisper_timestamped_tpu_torch.models.whisper_torch as wt
    from whisper_timestamped_tpu_torch.audio import log_mel_spectrogram
    from whisper_timestamped_tpu_torch.models import WhisperDims, init_params
    from whisper_timestamped_tpu_torch.training import (make_train_step, teacher_forced_loss,
                                                        trainable_parameters)

    dims = WhisperDims(**LARGE_V3)
    t0 = t_phase = time.perf_counter()
    model = init_params(dims, seed=0, dtype=torch.float32, device=device)
    audio = torch.stack([torch.from_numpy(make_audio(70 + i, 30)) for i in range(2)])
    mel = log_mel_spectrogram(audio, n_mels=dims.n_mels, device=device)[:, :, :3000].contiguous()
    g = torch.Generator(device=device).manual_seed(11)
    tokens = torch.randint(0, dims.n_vocab, (2, 224), generator=g, device=device)
    mask = torch.ones((2, 224), device=device)
    mask[1, 200:] = 0.0
    init_state, train_step = make_train_step(dims)
    state = init_state(model)
    params = trainable_parameters(model)
    print(f"[m] large-v3 geometry, seeded f32 weights ({sum(p.numel() for p in params) / 1e9:.3f} "
          f"B trainable; encoder pos_emb fixed), mel {tuple(mel.shape)}, tokens "
          f"{tuple(tokens.shape)}: {time.perf_counter() - t0:.1f} s")

    # the kernels against the plain versions: one loss and its gradients
    def loss_and_grads():
        for p in params:
            p.grad = None
        loss = teacher_forced_loss(model, mel, tokens, mask)
        loss.backward()
        return loss.item(), [p.grad for p in params]

    saved = K.flash_attention_fwd, K.flash_attention_bwd
    K.flash_attention_fwd, K.flash_attention_bwd = K.flash_attention_fwd_plain, K.flash_attention_bwd_plain
    try:
        loss_p, grads_p = loss_and_grads()
    finally:
        K.flash_attention_fwd, K.flash_attention_bwd = saved
    loss_k, grads_k = loss_and_grads()
    rel = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
              for a, b in zip(grads_k, grads_p))
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-5 * abs(loss_p) and rel <= 1e-3):
        fail(f"[m] the train step's loss/gradients through the kernels disagree with the plain "
             f"versions: loss {loss_k} vs {loss_p}, gradients {rel:.3g} of a leaf's max (limit 1e-3)")
    print(f"[m] one step's loss through the kernels {loss_k:.6f} vs the plain versions "
          f"{loss_p:.6f} (rtol 1e-5); gradients at most {rel:.3g} of a leaf's max abs (limit 1e-3)")
    del grads_k, grads_p
    for p in params:
        p.grad = None
    torch.cuda.empty_cache()

    def steps(n):
        nonlocal state
        out = []
        for _ in range(n):
            state, loss = train_step(state, mel, tokens, mask)
            out.append(loss)
        return out

    losses = steps(1)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    losses += steps(5)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 5
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [x.item() for x in losses]
    L = dims.n_audio_layer
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"[m] the losses are not finite and falling: {losses}")
    if any(launches[k] != 5 * L for k in TRAIN_PATH) or launches["flash_attention"]:
        fail(f"[m] expected {L} launches a step of each training kernel and none of "
             f"flash_attention: {launches}")
    print(f"[m] train steps (B=2, 224 tokens, AdamW lr 1e-5, f32): losses "
          f"{[round(x, 5) for x in losses]}; {ms:.1f} ms/step over 5 steps after a warm one; "
          f"peak memory {peak:.2f} GB; launches a step: "
          + ", ".join(f"{k} {launches[k] // 5}" for k in (*TRAIN_PATH, "flash_attention")))

    trace_step(torch, lambda: steps(1))

    def stacked_layers(pd, n_layer):  # each layer as w[l], the form before unbind
        return [{n: t[l] for n, t in pd.items() if n.startswith(wt._LAYER_PREFIXES)}
                for l in range(n_layer)]

    layers = wt._layers
    wt._layers = stacked_layers
    try:
        steps(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        steps(2)
        torch.cuda.synchronize()
    finally:
        wt._layers = layers
    print(f"[m] the same step with each layer read as w[l]: "
          f"{1e3 * (time.perf_counter() - t0) / 2:.1f} ms/step, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del state, model, params
    torch.cuda.empty_cache()
    print(f"[m] phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def device_rows(torch, fn):
    """``fn()`` once under torch.profiler. Returns (wall ms on the host clock,
    ending in a synchronize; the device's busy ms; rows (name, ms, count) of
    the device's activities, largest first). Activities are the kernels,
    copies and sets: a user annotation's device span (the optimizer's step)
    covers activities counted on their own, so it is left out, and busy is
    the union of the activities' intervals, so work that overlaps counts
    once and busy cannot exceed the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    host = {e.name for e in events if e.device_type != DeviceType.CUDA}
    acts = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in host
            and not getattr(e, "is_user_annotation", False)]
    by_name, busy_us, end = {}, 0.0, float("-inf")
    for e in acts:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in acts):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    rows = sorted(((k, ms, n) for k, (ms, n) in by_name.items()), key=lambda r: -r[1])
    return wall_ms, busy_us / 1e3, rows


def trace_step(torch, step):
    """(m): one train step under torch.profiler: its wall and device busy
    time and the training flash kernels' device time within it (the
    backward's two kernels by name: the dQ kernel is the template's
    ``true`` case)."""
    wall_ms, busy_ms, rows = device_rows(torch, step)
    if busy_ms <= 0:
        print(f"[m] traced step: wall {wall_ms:.1f} ms; the profiler saw no device time (not measured)")
        return

    def kernel_ms(*words):
        return sum(ms for key, ms, _ in rows if all(w in key for w in words))

    dq, dkv = kernel_ms("flash_bwd_kernel", "true>"), kernel_ms("flash_bwd_kernel", "false>")
    bwd, fwd = kernel_ms("flash_bwd_kernel"), kernel_ms("flash_fwd_lse_kernel")
    print(f"[m] one traced step: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%; the activities' own times sum to "
          f"{sum(r[1] for r in rows):.1f} ms); flash backward {bwd:.2f} ms "
          f"({100 * bwd / busy_ms:.1f}% of device busy; dQ {dq:.2f}, dK/dV {dkv:.2f}), "
          f"flash forward {fwd:.2f} ms "
          f"({100 * fwd / busy_ms:.1f}%)")
    for key, ms, n in rows[:8]:
        print(f"[m]   {ms:9.3f} ms {n:6d}x  {key[:90]}")


def phase_profile(torch, model, tok, B: int, **levers):
    """(--profile): device time against wall time for one decoded window of
    B rows, with the engine's ``levers``."""
    from whisper_timestamped_tpu_torch.audio import log_mel_spectrogram
    from whisper_timestamped_tpu_torch.decoding import DecodingOptions
    from whisper_timestamped_tpu_torch.engine import DecodeEngine

    engine = DecodeEngine(model, tok, **levers)
    opts = DecodingOptions(language="en", sample_len=64, suppress_tokens=f"-1,{tok.eot}")
    mel = log_mel_spectrogram(make_audio(4, 30), n_mels=128, device=model.device)
    mel = mel[None].expand(B, -1, -1).contiguous()
    engine.decode_window(mel, opts)
    wall_ms, dev_ms, rows = device_rows(torch, lambda: engine.decode_window(mel, opts))
    label = "+".join(k for k, v in levers.items() if v) or "bf16"
    print(f"[p] one window, B={B}, {label} cache, 64 tokens: wall {wall_ms:.1f} ms, device busy {dev_ms:.1f} ms "
          f"({100 * dev_ms / wall_ms:.1f}%)")
    for key, ms, n in rows[:12]:
        print(f"[p]   {ms:9.3f} ms {n:6d}x  {key[:90]}")


def main() -> int:
    t_start = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "whisper_timestamped_tpu_torch")):
        fail("whisper_timestamped_tpu_torch/ is not beside chip_smoke.py: run it from a checkout")
    import torch

    # (a) the card
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"[a] {kind} x{count}; torch {torch.__version__} CUDA {torch.version.cuda}; {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sys.path.insert(0, here)
    from whisper_timestamped_tpu_torch.ops import _build
    from whisper_timestamped_tpu_torch.ops import kernels as K

    # (b) build
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    log = (_build.build_dir() / "build.log").read_text()
    print(f"[b] kernels {'built' if _build.BUILD_INFO['built'] else 'loaded'} in "
          f"{build_s:.1f} s: {_build.BUILD_INFO['path']}")
    for entry, usage in ptxas_usage(log):
        print(f"[b]   {entry}: {usage}")

    device = torch.device("cuda", 0)
    rec, bf16_ms = phase_kernels(torch, K, device)
    torch.cuda.empty_cache()
    rec.update(phase_quant_kernels(torch, K, device, bf16_ms))
    rec.update(phase_segment_kernels(torch, K, device))
    rec.update(phase_frontend_kernels(torch, K, device))
    for name, fields in phase_beam_kernels(torch, K, device).items():
        rec[name].update(fields)
    rec.update(phase_train_kernels(torch, K, device))
    if "--kernels-only" in sys.argv[1:]:
        print("[c] --kernels-only: stopping after the kernel checks")
        return 0

    t0 = time.perf_counter()
    model, tok = large_v3_model(torch, device)
    print(f"[d] large-v3 geometry, seeded bf16 weights on {device}: {time.perf_counter() - t0:.1f} s")
    phase_end_to_end(torch, K, model, tok)
    if "--compare" in sys.argv[1:]:
        for label in (" plain", " kernel", " plain"):
            ctx = plain_encoder_and_prefill() if label == " plain" else contextlib.nullcontext()
            with ctx:
                phase_end_to_end(torch, K, model, tok, label=label,
                                 expect_launches=label == " kernel")
    phase_reference_step(torch, K, model)
    for label, quantize in (("kv_int8", dict(quantize_cross="int8")),
                            ("kv_int4", dict(quantize_cross="int4")),
                            ("self_kv_int8", dict(quantize_self=True))):
        phase_reference_step(torch, K, model, label, **quantize)
    phase_reference_encode(torch, K, model)
    torch.cuda.empty_cache()
    launches = phase_batch(torch, K, model, tok)
    torch.cuda.empty_cache()
    launches["xattn_decode_int8"] = phase_production(
        torch, K, model, tok, turns="--turns" in sys.argv[1:])["xattn_decode_int8"]
    lever_launches = phase_levers(torch, K, model, tok)
    for name in ("xattn_decode_int4", "self_attn_decode_int8"):
        launches[name] = lever_launches[name]
    torch.cuda.empty_cache()
    launches["attention_to_cost"] = phase_host_alignment(torch, K, model, tok)["attention_to_cost"]
    launches["median9"] = rec["median9"].pop("launches")
    torch.cuda.empty_cache()
    launches["log10_mel"] = phase_cli(torch, K, model, tok, here)["log10_mel"]
    launches["stacked_matmul"] = rec["stacked_matmul"].pop("launches")
    torch.cuda.empty_cache()
    phase_sampler(torch, device)
    phase_sampling(torch, K, model, tok)
    torch.cuda.empty_cache()
    phase_beam(torch, K, model, tok)
    torch.cuda.empty_cache()
    train_launches = phase_train(torch, K, device)
    for name in TRAIN_PATH:
        launches[name] = train_launches[name]
    if "--profile" in sys.argv[1:]:
        for B, levers in ((1, {}), (8, {}), (40, {}), (40, dict(kv_int8=True))):
            phase_profile(torch, model, tok, B, **levers)

    kernels = [
        dict(name=name, route="cuda", source=SOURCES[name][0], replaces=SOURCES[name][1],
             launches=launches[name], **rec[name])
        for name in SOURCES
    ]
    print(f"[z] {time.perf_counter() - t_start:.0f} s from start to here, the build included")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
