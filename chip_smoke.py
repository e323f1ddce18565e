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
      then one window of each engine (B=40, 64 tokens) traced by
      torch.profiler: the device's busy share;
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
  (l) beam search, its token loop replayed from captured graphs and the
      self-attention reading each beam's slots through a row table: a
      serial 30 s request with the ``--accurate`` options (beam 5) and no
      thresholds, then ``transcribe_batch`` with beam 5 on eight 5-30 s
      streams at B=8 (40 beam rows over 8 cross-KV rows) with a bf16 and a
      ``kv_int8`` engine: the launches (both attention kernels 32 times a
      replayed or warm-up step), the cross K/V untiled (seen at the
      capture), one capture a distinct key, s/request, s/batch, ms/step,
      replays, peak memory; one B=8 x 5 window batch captured against
      ``uncaptured=True``, every buffer bit for bit, ms/step and peak both
      ways, replays and steps past the stop; a ``beam_size=1`` decode equal
      to greedy;
  (m) fine-tuning at large-v3 width: ``training.make_train_step`` (AdamW,
      optax's ``adamw(1e-5)``) on seeded f32 weights and one fixed batch
      (two 30 s windows, 224 tokens a row): one step's loss and gradients
      through the training flash kernels against the plain versions (and
      written for (r)), four backward passes of that step compared bit for
      bit with cuDNN's default and its deterministic algorithms (the
      latter must agree on every leaf), then
      a warm step and five timed steps: the losses finite and falling, each
      training kernel launched once a layer a step and the inference flash
      kernel never; ms/step and peak memory; one step traced by
      torch.profiler (device busy as the union of the kernels' intervals,
      the flash kernels' share, the forward's split pass and kernel
      apart); and the step
      with each layer read as ``w[l]`` instead of ``unbind``;
  (n) voice activity detection: a seeded silero v5 ``.jit`` written to a
      temporary directory and named by ``SILERO_VAD_PATH``; the silero
      module on the card (its tensors there) against the torchscript model
      on the CPU on 2,000 seeded chunks with TF32 allowed in cuBLAS and
      cuDNN around the call (1e-4), and its time on one hour of audio;
      ``transcribe_timestamped`` on 60 s of speech blocks and silences with
      explicit pairs, ``auditok`` and ``silero``, ``transcribe_batch`` of 8
      such streams and ``transcribe_batch_stream`` over two batches of 4
      with ``silero``: ``speech_activity``, every word inside a span or past
      the last one, the kernels launched, the batch's spans and words equal
      to each stream's alone, the stream's equal to the batch's;
  (o) the weight levers on one B=8 batch of (f)'s streams: bf16,
      ``w_int8``, ``enc_int8``, and both with ``kv_int8``: words, the decode
      kernels launched, ms/step, the encoder's ms at B=8, peak memory; the
      engines' int8 codes equal to a CPU quantization of the same weights,
      ``model.module`` unchanged; one linear of each kind timed alone;
  (p) the captured token loop (each window's steps replayed from CUDA
      graphs of ``decoding.STOP_CHECK_STEPS`` steps, the engine's): a
      window of 96 tokens through ``decode_window`` captured and uncaptured
      on the same inputs at B=1 (prompt regions of 8 and 232 slots), B=8,
      B=40 ``kv_int8`` and bf16, ``kv_int4`` + ``self_kv_int8``,
      ``w_int8``, and sampled at T=0.5 then 0.3 (one graph for both): the
      buffers bit for bit, the steps equal, ms/step both ways, replays
      (host syncs) a window, steps past the stop, captures equal to the
      distinct keys; a B=40 ``kv_int8`` stream with ``WTT_TAIL_BATCH=8``
      against the same without it (the words decoded at B=40 in both
      equal; 8 windows at B=8 and as rows of B=40 as the control of the
      tail's own); the host C++ core built and in use by ``dtw_path`` and
      the tokenizer;
  (q) the mesh: first ``self_attn_decode_int8``'s instance that writes with
      given scales (a tensor-parallel rank's rows, whose scale is the whole
      row's) against its plain version at a tp=2 rank's shape (B=8, ctx
      456, pos 232, 10 heads, D=640): codes and scales bit for bit, the
      output at the int8 self gate, timed beside the instance that reduces
      the row itself at the same shape; then two ranks spawned
      (``torch.multiprocessing``, a ``file://`` store under ``build/``), one
      a card on NCCL with two cards or more, else both on ``cuda:0`` on
      gloo (NCCL refuses two ranks on one device; gloo reduces CUDA tensors
      through the host), each building the seeded large-v3 model at full
      width and depth and sharding it at tp=2 (``parallel.mesh``): one
      ``encode`` and one ``decode_step`` at B=8 against the one-card model's
      (max relative difference, limit ``MESH_REL_LIMIT``), ``init_cache``'s
      int8 cross K/V scales bit-equal to ``quantize_rows`` of the rows
      gathered over tp (and the rank's K/V against the one-card slice),
      ``transcribe_batch`` of (f)'s first 8 streams at tp=2 with a bf16 and a
      ``kv_int8`` + ``self_kv_int8`` engine (the schema; both ranks' results
      equal bit for bit; every decode kernel launched at least 32 times a
      decode step and ``flash_attention`` 32 times a window iteration, all
      at 10 heads; the token loop run eagerly, ``tp_eager_chunks``;
      s/batch, ms/step, each rank's peak memory and resident weight bytes),
      then the same streams at dp=2 (4 a rank, captured loops), each rank's
      streams' results bit-equal to a one-card ``transcribe_batch`` of them
      at ``batch_size=4`` and both ranks' merged dicts equal. Two ranks on
      one card share its SMs: (q)'s times describe that layout only;
  (r) training on the mesh: first the three training flash kernels at a
      tp=2 rank's shape (B=2, T=1500, H=10, f32) against their plain
      versions, timed beside them and SDPA's forward and backward, with
      their bounds; then two ranks spawned as in (q), each building (m)'s
      seeded f32 large-v3 weights, keeping only its tp=2 shard
      (``parallel.shard_params``) and training it through
      ``training.make_train_step(mesh=)`` on (m)'s batch: the first step's
      loss and its gradients' slices against (m)'s first step (which (m)
      writes under ``build/``), a timed run of steps and one more with each
      all-reduce timed (their count, bytes and time), the losses bit-equal
      on both ranks, finite and falling, the replicated parameters
      bit-equal on both ranks, each training kernel launched 32 times a
      step at 10 heads and ``flash_attention`` never; ms/step and peak
      memory a rank; then dp=2 at full width and 8 + 8 layers, a row a
      rank, three steps whose losses (equal on both ranks) are the one-card
      step's on both rows.

Every decode path above ([d], [f], [g], [h], [k], [l], [n], [o]) runs its
token loops through the engine's captured graphs; the launch counts add each
graph's captured launches at each replay, so "at least 32 launches a
decode step" keeps its meaning.

(c) holds ``self_attn_decode`` at B=1, 8 and 40 over slots 0-455 (read
from the device, the grid over the 456-slot extent, as the captured loop
launches it) and pad lengths 0, 5, 224 and 300, its fused row write bit
for bit, and times it with the row write at pos 232 and 455, over the
extent and over pos + 1 slots, beside SDPA over the live slots; it
times ``xattn_decode_int8`` at B=1, 8 and 40 beside the bf16 kernel,
``xattn_decode_int4`` at the same batches beside the int8 kernel, and
``self_attn_decode_int8`` with its quantized row write at B=1, 8 and 40
and pos 232 and 455 (both grids) beside ``self_attn_decode`` with its
write, each with
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
shared-read bound, ``self_attn_decode`` through beam search's row table
at 40 rows, pos 232 and 344 (bit for bit against the launch without a
table over the gathered cache, atol 2e-2 against the plain version),
beside the launch without a table, the training flash kernels (the forward with lse, run
twice for equal bits, dQ and dK/dV) in f32 and bf16 at the encoder's shape
(B=2, T=1500) and at ragged T, beside their plain versions and SDPA's
forward and backward (the forward, the backward and their plain versions
also against a float64 forward and backward), ``median9`` also at widths
1, 5, 9 and 1537 and on a base 4 bytes off 16, and
(e) the decode step
with the int8 and int4 cross K/V and the int8 self cache. The kernels' JSON
record takes each kernel's launches from the phase that runs it: the bf16
path's from (f), ``xattn_decode_int8`` from (g), the int4 and int8-self
kernels from (h), ``attention_to_cost`` from (i), ``log10_mel`` from (j),
the training kernels from (m)'s timed steps (their records also carry
(r)'s times at a rank's shape and rank 0's launches a tp=2 step), the
scales-given int8 self instance from (q)'s rank 0 (its ``kv_int8`` +
``self_kv_int8`` batch at tp=2); ``median9`` and ``stacked_matmul``, which
no path runs, from their checks in (c).

``--profile`` adds a torch.profiler trace of one window decoded to 64 tokens,
at B=1, at B=8 and at B=40 (bf16 and ``kv_int8``), and prints the device's
busy share and the kernels that fill it (lines ``[profile]``).
``--compare`` adds (d) with the plain attention math of the encoder and the
prefill (the path before the flash kernel) in turns with the kernel path:
plain, kernel, kernel, plain.
``--turns`` runs (g)'s engines in turns (kv_int8, bf16, bf16, kv_int8);
``--kernels-only`` stops after (c) (a first check of changed kernels; it
prints no result line); ``--train-only`` runs (m) and (r) alone after the
build (no result line either).

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
    # the same kernel's instance for a tensor-parallel rank ([q]): the row
    # scales given (the JAX step quantizes in XLA, whisper_jax.py:930-932)
    "self_attn_decode_int8_scaled": ("whisper_timestamped_tpu_torch/csrc/self_attn_decode_int8.cu",
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


def flash_fwd_float64(torch, q, k, v, H):
    """(out (B, S, H*64), lse (B, H, S)) float64 of attention without a
    mask, from the same inputs: the judge of the forward kernels and their
    plain version (which works in f32)."""
    B, _, D = q.shape
    qh, kh, vh = (heads_view(x, H).double() for x in (q, k, v))
    s = qh @ kh.transpose(-1, -2) * 64**-0.5
    lse = torch.logsumexp(s, dim=-1)
    out = torch.exp(s - lse[..., None]) @ vh
    return out.transpose(1, 2).reshape(B, -1, D), lse


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
    slot = torch.zeros((), dtype=torch.int32, device=device)  # the step's slot, on the card
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
            slot.fill_(pos)
            for pad in pads:
                layer = pos % L
                # the step's slot read from the device, the grid over the
                # window's extent (456 slots), as the captured loop launches it
                o_k = K.self_attn_decode(q, k_all, v_all, layer, slot, pad, H, extent=ctx)
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
                    o_f = K.self_attn_decode(q, k_f, v_f, layer, slot, pad, H, k_new=k_new,
                                             v_new=v_new, extent=ctx)
                    torch.cuda.synchronize()
                    if not (torch.equal(k_f, k_p) and torch.equal(v_f, v_p)):
                        fail(f"self_attn_decode's row write differs from the plain write at "
                             f"B={B} pos={pos}")
                    if not torch.equal(o_f, K.self_attn_decode(q, k_p, v_p, layer, slot, pad, H,
                                                               extent=ctx)):
                        fail(f"self_attn_decode with the row write differs from the kernel on "
                             f"the written cache at B={B} pos={pos}")
                    del k_p, v_p, k_f, v_f
        if not err <= 2e-2:
            fail(f"self_attn_decode disagrees: {err:.3g} (atol 2e-2)")
        # timed with the row write, as decode_step calls it: the slot on the
        # device and the grid over the extent (the captured loop's launch),
        # and over pos + 1 slots (the grid an int slot gets); the
        # library call attends over the live slots with pad 0 (K/V sliced to
        # pos + 1)
        pad0 = torch.zeros((B,), dtype=torch.int32, device=device)
        for pos in (232, 455):
            slot.fill_(pos)

            def plain_self(it=0):
                k_all[it % L, :, pos] = k_new[:, 0]
                v_all[it % L, :, pos] = v_new[:, 0]
                return K.self_attn_decode_plain(q, k_all, v_all, it % L, pos, pad0, H)

            ms = cuda_time_ms(lambda it=0: K.self_attn_decode(q, k_all, v_all, it % L, slot, pad0,
                                                              H, k_new=k_new, v_new=v_new,
                                                              extent=ctx))
            ms_live = cuda_time_ms(lambda it=0: K.self_attn_decode(
                q, k_all, v_all, it % L, slot, pad0, H, k_new=k_new, v_new=v_new, extent=pos + 1))
            plain_ms = cuda_time_ms(plain_self, iters=10)
            lib_ms = cuda_time_ms(lambda it=0: sdpa(heads_view(q, H),
                                                    heads_view(k_all[it % L, :, :pos + 1], H),
                                                    heads_view(v_all[it % L, :, :pos + 1], H)))
            # the live slots of K and V, q, the output and the row written
            moved = 2 * B * (pos + 1) * D * 2 + 2 * B * D * 2 + 2 * B * D * 2
            b_ms, b_by = bound(moved, 4 * B * (pos + 1) * D, F32_FLOPS)
            self_ms[(B, pos)] = ms
            n_split = K.xattn_split(B, H, ctx, K._sm_count(device))[0]
            n_live = K.xattn_split(B, H, pos + 1, K._sm_count(device))[0]
            warps = K.pipeline_warps(B, H, K._sm_count(device))
            print(f"[c] self_attn_decode B={B} ctx=456 pos={pos} D=1280 H=20 ({warps} warps a "
                  f"block), with the row write, the slot on the device: {ms:.4f} ms over the "
                  f"extent ({n_split} splits), {ms_live:.4f} ms over pos + 1 ({n_live} splits) vs "
                  f"plain (write + attention) {plain_ms:.4f} "
                  f"ms, sdpa (live slots, pad 0) {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                  f"{moved / 1e6:.2f} MB)")
            if (B, pos) == (1, 232):  # the serial path's shape
                rec["self_attn_decode"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                               bound_by=b_by, library_ms=lib_ms)
        del q, k_new, v_new, k_all, v_all
        torch.cuda.empty_cache()
    rec["self_attn_decode"]["max_abs_err"] = err
    print(f"[c] self_attn_decode (B=1, 8, 40; pos 0, 63, 64, 65, 232, 455 read from the device "
          f"over a 456-slot grid; pads {'/'.join(map(str, SELF_PADS))}): err {err:.3g} (atol "
          f"2e-2); the fused row write equal to the plain write bit for bit")

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
    slot = torch.zeros((), dtype=torch.int32, device=device)

    def compare_self(B, pad, pos, layers):
        """Kernel against the plain quantizer's rows and the plain version in
        f32 on one cache; returns the cache."""
        nonlocal err
        q, k_new, v_new = (randn(B, 1, D).bfloat16() for _ in range(3))
        cache = (*quantize_rows(randn(L, B, ctx, D)), *quantize_rows(randn(L, B, ctx, D)))
        slot.fill_(pos)
        for layer in layers:
            ck = [t.clone() for t in cache]
            # the slot on the device, the grid over the 456-slot extent
            o_k = K.self_attn_decode_int8(q, k_new, v_new, *ck, layer, slot, pad, H, extent=ctx)
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

            slot.fill_(pos)
            ms = cuda_time_ms(lambda it=0: K.self_attn_decode_int8(q, k_new, v_new, *cache, it % L,
                                                                   slot, pad0, H, extent=ctx))
            ms_live = cuda_time_ms(lambda it=0: K.self_attn_decode_int8(
                q, k_new, v_new, *cache, it % L, slot, pad0, H, extent=pos + 1))
            plain_ms = cuda_time_ms(plain_self, iters=5)
            # q, k_new, v_new and the output; the live slots' codes and scales of
            # K and V; the written row's codes and scales; 4 f32 flops per code pair
            live = pos + 1
            moved = Bt * (4 * D * 2 + 2 * live * (D + 4) + 2 * (D + 4))
            b_ms, b_by = bound(moved, 4 * Bt * live * D, F32_FLOPS)
            if (Bt, pos) == (8, 232):
                rec["self_attn_decode_int8"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                                    bound_by=b_by, library_ms=None)
            n_split = K.xattn_split(Bt, H, ctx, n_sm)[0]
            n_live = K.xattn_split(Bt, H, live, n_sm)[0]
            print(f"[c] self_attn_decode_int8 B={Bt} ctx=456 pos={pos} D=1280 H=20 "
                  f"({K.pipeline_warps(Bt, H, n_sm)} warps a block), with its quantized write, "
                  f"the slot on the device: {ms:.4f} ms over the extent ({n_split} splits), "
                  f"{ms_live:.4f} ms over pos + 1 ({n_live} splits) vs plain (write + attention) "
                  f"{plain_ms:.4f} ms, bound "
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
    out["self_attn_decode"] = phase_beam_table(torch, K, device)
    return out


def beam_table(torch, g, B: int, Kb: int, ctx: int, P: int, steps: int, device):
    """Beam search's row table (B·Kb, ctx) int32 after ``steps`` random
    steps of ``decoding_beam._beam_step``'s update: the prompt columns at
    each window's row b*Kb, then each step the rows gathered by random
    source beams and column P + i set to each row's own index."""
    R = B * Kb
    row = torch.arange(R, device=device)
    table = torch.where(torch.arange(ctx, device=device)[None] < P, (row // Kb * Kb)[:, None],
                        row[:, None]).to(torch.int32)
    for i in range(steps):
        src = torch.randint(0, Kb, (B, Kb), generator=g, device=device)
        table = table[(torch.arange(B, device=device)[:, None] * Kb + src).reshape(-1)]
        table[:, P + i] = row.to(torch.int32)
    return table.contiguous()


def phase_beam_table(torch, K, device):
    """(c): ``self_attn_decode`` through beam search's row table at B=8 x
    K=5 (40 rows), ctx 456, the prompt region 232, pos 232 and 344, the
    step's rows written in the launch, the table built by pos - 231 random
    beam steps: bit for bit against the launch without a table over the
    cache gathered by the table (JAX's route: the rows reordered in
    memory), so that any difference from the plain version is the
    untabled kernel's own; against the plain version through the same
    table at the self-attention gate of the untabled kernel (atol 2e-2);
    the written cache against the plain write bit for bit; with an
    identity table bit-equal to the launch without one. Timed with the
    write beside the same launch without a
    table, SDPA over the gathered live slots (pad 0; the gather not
    timed) and the bound: the distinct (row, slot) pairs of K and V that
    the table names among the live slots read once (a window's beams share
    the prompt and their common history), q, the output, the row written,
    and the table's 4 bytes a row's live slot. Returns the fields for
    ``self_attn_decode``'s record."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=device).manual_seed(18)
    L, ctx, D, H, Bw, Kb, P = 32, 456, 1280, 20, 8, 5, 232
    R = Bw * Kb

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device).bfloat16()

    q, k_new, v_new = randn(R, 1, D), randn(R, 1, D), randn(R, 1, D)
    k_all, v_all = randn(L, R, ctx, D), randn(L, R, ctx, D)
    pads = torch.tensor([(0, 5, 224)[b % 3] for b in range(Bw)], dtype=torch.int32,
                        device=device).repeat_interleave(Kb)
    pad0 = torch.zeros((R,), dtype=torch.int32, device=device)
    slot = torch.zeros((), dtype=torch.int32, device=device)
    ident = torch.arange(R, dtype=torch.int32, device=device)[:, None].expand(R, ctx).contiguous()
    err, fields = 0.0, {}
    for pos in (232, 344):
        slot.fill_(pos)
        table = beam_table(torch, g, Bw, Kb, ctx, P, pos - P + 1, device)
        for layer in (0, 13, L - 1):
            k_f, v_f = k_all.clone(), v_all.clone()
            o_k = K.self_attn_decode(q, k_f, v_f, layer, slot, pads, H, k_new=k_new, v_new=v_new,
                                     extent=ctx, src_row=table)
            torch.cuda.synchronize()
            k_p, v_p = k_all.clone(), v_all.clone()
            K.write_row(k_new, k_p, layer, pos)
            K.write_row(v_new, v_p, layer, pos)
            if not (torch.equal(k_f, k_p) and torch.equal(v_f, v_p)):
                fail(f"self_attn_decode through the table: its row write differs from the plain "
                     f"write at pos={pos}")
            o_p = K.self_attn_decode_plain(q, k_p, v_p, layer, slot, pads, H, ctx, src_row=table)
            if not torch.isfinite(o_k.float()).all():
                fail(f"self_attn_decode through the table: non-finite output at pos={pos}")
            err = max(err, (o_k.float() - o_p.float()).abs().max().item())
            # JAX's route: the rows gathered in memory, read without a table
            cols = torch.arange(ctx, device=device)
            k_g = k_p[layer:layer + 1, table.long(), cols].contiguous()
            v_g = v_p[layer:layer + 1, table.long(), cols].contiguous()
            if not torch.equal(o_k, K.self_attn_decode(q, k_g, v_g, 0, slot, pads, H,
                                                       extent=ctx)):
                fail(f"self_attn_decode through the table differs from the launch without one "
                     f"over the gathered cache at pos={pos} layer={layer}")
            del k_g, v_g
            same = K.self_attn_decode(q, k_p, v_p, layer, slot, pads, H, extent=ctx,
                                      src_row=ident)
            if not torch.equal(same, K.self_attn_decode(q, k_p, v_p, layer, slot, pads, H,
                                                        extent=ctx)):
                fail(f"self_attn_decode with an identity table differs from the launch without "
                     f"one at pos={pos} layer={layer}")
            del k_f, v_f, k_p, v_p
        if not err <= 2e-2:
            fail(f"self_attn_decode through the table disagrees with its plain version: "
                 f"{err:.3g} (atol 2e-2)")
        ms = cuda_time_ms(lambda it=0: K.self_attn_decode(
            q, k_all, v_all, it % L, slot, pad0, H, k_new=k_new, v_new=v_new, extent=ctx,
            src_row=table))
        untabled = cuda_time_ms(lambda it=0: K.self_attn_decode(
            q, k_all, v_all, it % L, slot, pad0, H, k_new=k_new, v_new=v_new, extent=ctx))
        live = torch.arange(pos + 1, device=device)
        rows = table[:, :pos + 1].long()
        gk, gv = k_all[:, rows, live], v_all[:, rows, live]  # (L, R, pos + 1, D)
        lib_ms = cuda_time_ms(lambda it=0: sdpa(heads_view(q, H), heads_view(gk[it % L], H),
                                                heads_view(gv[it % L], H)))
        del gk, gv
        plain_ms = cuda_time_ms(lambda it=0: K.self_attn_decode_plain(
            q, k_all, v_all, it % L, slot, pad0, H, ctx, src_row=table), iters=5)
        distinct = torch.unique(rows * ctx + live).numel()  # (row, slot) pairs named
        io = 3 * 2 * R * D * 2 + R * (pos + 1) * 4  # q, out, the new rows; the table
        moved = 2 * distinct * D * 2 + io
        b_ms, b_by = bound(moved, 4 * R * (pos + 1) * D, F32_FLOPS)
        b_all_ms, _ = bound(2 * R * (pos + 1) * D * 2 + io, 4 * R * (pos + 1) * D, F32_FLOPS)
        print(f"[c] self_attn_decode through the row table, B=8 x K=5 = 40 rows, ctx=456 "
              f"pos={pos} (the table after {pos - P + 1} random beam step(s)), with the row "
              f"write: "
              f"{ms:.4f} ms, without a table {untabled:.4f} ms; plain (gather + attention) "
              f"{plain_ms:.4f} ms, sdpa over the gathered live slots {lib_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}, {moved / 1e6:.2f} MB with the table: {distinct} distinct "
              f"(row, slot) pairs of {R * (pos + 1)} live; {b_all_ms:.4f} ms reading every "
              f"row's own)")
        fields.update({f"ms_table_b40_pos{pos}": ms, f"ms_untabled_b40_pos{pos}": untabled,
                       f"plain_ms_table_b40_pos{pos}": plain_ms,
                       f"library_ms_table_b40_pos{pos}": lib_ms,
                       f"bound_ms_table_b40_pos{pos}": b_ms,
                       f"bound_ms_every_row_b40_pos{pos}": b_all_ms})
    print(f"[c] self_attn_decode through the row table (pads 0/5/224 by window, layers 0, 13, "
          f"31): err {err:.3g} against the plain version (atol 2e-2); equal to the launch "
          f"without a table over the gathered cache, the row write equal to the plain write, an "
          f"identity table equal to no table, bit for bit")
    fields["max_abs_err_table"] = err
    del q, k_new, v_new, k_all, v_all
    torch.cuda.empty_cache()
    return fields


# the training kernels against their plain versions, a share of each
# output's max abs: f32 1e-4 (f32 FMAs in another order; the backward's
# products 3xTF32, whose f32 sums the tensor cores round toward zero at
# every k-step: ~3e-5 at T = 1500, emulated by tools/torch_kernel_sweeps.py
# flash-bwd-accuracy), bf16 1e-2 (both round the f32 result to bf16, 2^-8
# of a value; the backward also rounds P and dS to bf16 for their products,
# as the library does); the bf16 forward's output at 1e-2 of its max abs
# and at most the inference kernel's atol 2e-2 (one bf16 step of out's
# largest value is 2^-8 to 2^-7 of it; dropping the first 64 keys moves out
# by far more: [c] prints that control beside the largest error)
TRAIN_TOL = {"f32": 1e-4, "bf16": 1e-2}


def phase_train_kernels(torch, K, device):
    """(c): the training flash kernels (forward with lse, dQ, dK/dV) against
    their plain versions at the large-v3 encoder's shape (B=2, T=1500,
    D=1280, H=20; the backward's 11 128-row blocks and a 92-row tail) and
    at ragged T = 1, 65, 128, 129, 200, in f32 (the training path's dtype)
    and bf16; each timed beside its plain version and SDPA (forward;
    backward alone), with its bound (f32 at 3xTF32's rate on the tensor
    cores, three tf32 products a product at 495 TFLOP/s, with the CUDA
    cores' 67 beside it); at T = 1500 the forward and the backward, and
    their plain versions, also against a float64 forward and backward.
    Returns the f32 records."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=device).manual_seed(13)
    B, D, H = 2, 1280, 20
    rec, errs, t_phase = {}, {}, time.perf_counter()
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        tol, e_fwd, e_bwd, a_bwd = TRAIN_TOL[label], 0.0, 0.0, 0.0
        r_fwd, r_cut = 0.0, math.inf  # out's error, and the control's, over out's max abs
        for T in (1, 65, 128, 129, 200, 1500):
            q, k, v, dout = (torch.randn((B, T, D), generator=g, device=device).to(dtype)
                             for _ in range(4))
            out, lse = K.flash_attention_fwd(q, k, v, H)
            again = K.flash_attention_fwd(q, k, v, H)
            torch.cuda.synchronize()
            if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
                fail(f"flash_attention_fwd {label} T={T} differs from run to run")
            del again
            out_p, lse_p = K.flash_attention_fwd_plain(q, k, v, H)
            e_out = (out.float() - out_p.float()).abs().max().item()
            e_lse = ((lse - lse_p).abs().max() / lse_p.abs().max()).item()
            top = out_p.float().abs().max().item()
            limit = tol * top if label == "f32" else min(2e-2, tol * top)
            if not (e_out <= limit and e_lse <= 1e-4):
                fail(f"flash_attention_fwd {label} T={T} disagrees: out {e_out:.3g} (limit "
                     f"{limit:.3g}), lse {e_lse:.3g} of its max")
            e_fwd, r_fwd = max(e_fwd, e_out), max(r_fwd, e_out / top)
            if T > 64:  # the control: the plain version without the first key tile
                cut = K.flash_attention_fwd_plain(q, k[:, 64:].contiguous(),
                                                  v[:, 64:].contiguous(), H)[0]
                r_cut = min(r_cut, (cut.float() - out_p.float()).abs().max().item() / top)
                del cut
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
            # the witnesses: the kernels and the plain versions against float64
            out64, lse64 = flash_fwd_float64(torch, q, k, v, H)
            f64 = [((o.double() - out64).abs().max() / out64.abs().max()).item()
                   for o in (out, out_p)]
            l64 = [((x.double() - lse64).abs().max() / lse64.abs().max()).item()
                   for x in (lse, lse_p)]
            print(f"[c] flash_attention_fwd {label} T={T} against a float64 forward: out kernel "
                  f"{f64[0]:.3g}, plain version {f64[1]:.3g} of its max abs; lse kernel "
                  f"{l64[0]:.3g}, plain version {l64[1]:.3g} of its max abs (a witness, not a gate)")
            del out64, lse64
            exact = flash_bwd_float64(torch, q, k, v, dout, H)
            e64 = [max(((a.double() - w).abs().max() / w.abs().max()).item()
                       for a, w in zip(got, exact)) for got in (grads, want)]
            print(f"[c] flash_attention_bwd {label} T={T} against a float64 backward: kernels "
                  f"{e64[0]:.3g}, plain version {e64[1]:.3g} of a gradient's max abs")
            del exact
            elt = q.element_size()
            pairs = B * H * T * T * 64  # one T x T x 64 product, all heads
            io, rows = B * T * D * elt, B * H * T * 4
            # the products run on the tensor cores, f32 as 3xTF32: three tf32
            # products a product (the CUDA cores' f32 rate beside it)
            n_tc, tc_peak = (3, TF32_FLOPS) if label == "f32" else (1, BF16_FLOPS)
            f_ms, f_by = bound(4 * io + rows, n_tc * 4 * pairs, tc_peak)  # 2 products
            cc_f = bound(4 * io + rows, 4 * pairs, F32_FLOPS)[0]
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
                  f"plain {plain_f:.4f} ms, sdpa {lib_f:.4f} ms, bound {f_ms:.4f} ms ({f_by}"
                  + (f"; 3xTF32, the CUDA cores' {cc_f:.4f})" if label == "f32" else ")"))
            print(f"[c] flash_attention_bwd {label} B={B} T={T}: dq {ms_dq:.4f} ms (bound "
                  f"{dq_b:.4f}, 3 products), dkv {ms_dkv:.4f} ms (bound {dkv_b:.4f}, 4 products), "
                  f"together {ms_dq + ms_dkv:.4f} ms against the backward's bound {all_b:.4f} ms "
                  f"(5 products); plain {plain_b:.4f} ms, sdpa backward alone {lib_b:.4f} ms")
            if label == "f32":  # the training path's dtype
                print(f"[c] flash_attention_bwd f32: the bounds above are 3xTF32's (3 tf32 "
                      f"products a product at {TF32_FLOPS / 1e12:.0f} TFLOP/s); on the CUDA cores "
                      f"at {F32_FLOPS / 1e12:.0f}: dq {cc_dq:.4f} ms, dkv {cc_dkv:.4f} ms, the 5 "
                      f"products {cc_all:.4f} ms")
                rec["flash_attention_fwd"] = dict(
                    ms=ms_f, plain_ms=plain_f, bound_ms=f_ms, bound_by=f_by, library_ms=lib_f,
                    bound_cuda_core_ms=cc_f,
                    bound_rate="3xTF32: 3 tf32 products a product at 495 TFLOP/s",
                    max_err_float64=f64[0], plain_max_err_float64=f64[1],
                    lse_err_float64=l64[0], library_function="sdpa forward")
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
                rec["flash_attention_fwd"].update(library_ms_bf16=lib_f, bound_ms_bf16=f_ms,
                                                  max_err_float64_bf16=f64[0])
            del qh, kh, vh, o_lib, delta
        errs[label] = (e_fwd, a_bwd)
        print(f"[c] flash_attention_fwd {label}: out err at most {r_fwd:.3g} of its max abs over "
              f"T = 1 .. 1500 (limit {tol}" + (", at most 2e-2)" if label == "bf16" else ")")
              + f"; the control, the first 64 keys dropped (plain version), moves out by at "
              f"least {r_cut:.3g} of its max abs over T = 65 .. 1500")
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
    # other widths: rows shorter than the window, widths that are not a
    # multiple of 4 (scalar reads through the reflection), one past 1536;
    # and a base 4 bytes off 16 (no 16-byte reads)
    others = [torch.randn((7, m), generator=g, device=device) * 3.0 for m in (1, 5, 9, 1537)]
    others.append((torch.randn(4 * M + 1, generator=g, device=device) * 3.0)[1:].view(4, M))
    for x in others:
        if not torch.equal(K.median9(x), K.median9_plain(x)):
            fail(f"median9 differs from its plain version at {tuple(x.shape)} "
                 f"(base {x.data_ptr() % 16} bytes off 16)")
    print("[c] median9 at M = 1, 5, 9, 1537 and on a base 4 bytes off 16: equal to the plain "
          "version")
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

    def plain_self_int8(q, k_new, v_new, *cache_and_args, row_scales=None):
        k_all, k_scale, v_all, v_scale, layer, pos, pad, H, extent = cache_and_args
        K.write_quantized_row(k_new, v_new, k_all, k_scale, v_all, v_scale, layer, pos,
                              row_scales)
        return K.self_attn_decode_int8_plain(q, k_all, k_scale, v_all, v_scale, layer, pos, pad, H,
                                             extent)

    def plain_self(q, k_all, v_all, layer, pos, pad, H, k_new, v_new, extent, src_row=None):
        K.write_row(k_new, k_all, layer, pos)
        K.write_row(v_new, v_all, layer, pos)
        return K.self_attn_decode_plain(q, k_all, v_all, layer, pos, pad, H, extent, src_row)

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
        trace_window(torch, engine, tok, B, f"[g] {label}")
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


BEAM_MAX_NEW = 100  # tokens a window in (l)'s captured-against-uncaptured run


def phase_beam(torch, K, model, tok):
    """(l): beam search at large-v3 width, EOT suppressed (no beam finishes;
    every window runs its 224 steps, or to the text context's end), the
    token loop replayed from the engine's captured graphs
    (``decoding.STOP_CHECK_STEPS`` steps each), the self-attention reading
    the beams' slots through the row table:

    1. serial: ``transcribe_timestamped`` on a 30 s request with the
       ``--accurate`` options (beam 5, best_of 5, the schedule 0.0-1.0 by
       0.2) and no thresholds, so each window is one beam decode, then the
       two-pass engine's pass 2;
    2. batched: ``transcribe_batch`` with beam 5 on eight 5-30 s streams
       at B=8 (40 beam rows), with a bf16 engine and with ``kv_int8``;
    3. captured against ``uncaptured=True``: one window batch at B=8 x K=5
       (``BEAM_MAX_NEW`` tokens) through ``decode_window_beam_batch`` with
       an engine's graphs, again (the timed replay), and uncaptured on the
       same inputs: every returned buffer bit for bit, ms/step both ways,
       the replays (host syncs) a window and the steps past the stop;
    4. a ``beam_size=1`` decode equals the greedy decode of the same window
       (a 20-token prompt, so both prefill the 232-slot region, and no
       alignment rows).

    Fails unless every result is well formed, ``log10_mel``,
    ``flash_attention`` and ``self_attn_decode`` launch, the cross-attention
    kernel of the cache's type launches 32 times a replayed or warm-up step
    (the other never), the self-attention kernel as often, every decode
    step's cross K/V has B rows while its queries have B·K (the cross-KV is
    not tiled; the spy on ``decode_step`` sees the warm-up and the capture),
    each engine captured once a distinct key, and the K=1 tokens equal
    greedy's. Prints s/request, s/batch, decode steps, replays, ms/step,
    peak memory and the launches. Returns the self-attention kernel's
    launches in the runs of 1. and 2."""
    import whisper_timestamped_tpu_torch.decoding_beam as beam
    from whisper_timestamped_tpu_torch import transcribe_batch, transcribe_timestamped
    from whisper_timestamped_tpu_torch.audio import log_mel_spectrogram
    from whisper_timestamped_tpu_torch.decoding import (PROMPT_REGION, STOP_CHECK_STEPS,
                                                        DecodingOptions)
    from whisper_timestamped_tpu_torch.engine import DecodeEngine
    from whisper_timestamped_tpu_torch.utils import get_counts, get_stage_timings, reset_stage_timings

    eot_off = f"-1,{tok.eot}"
    L = model.dims.n_text_layer
    k = STOP_CHECK_STEPS
    rows_seen = set()  # (query rows, cross-KV rows) of every beam decode step
    step = beam.decode_step
    self_launches = 0

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
        nonlocal self_launches
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts, timings, launches = get_counts(), get_stage_timings(), dict(K.LAUNCHES)
        steps, chunks = counts.get("decode_steps", 0), counts.get("beam_chunks", 0)
        captures = timings.get("decode_capture", {}).get("count", 0)
        ms_step = 1e3 * timings.get("decode_loop", {}).get("total_s", 0.0) / max(steps, 1)
        peak = torch.cuda.max_memory_allocated() / 1e9
        for name in ("log10_mel", "flash_attention", "self_attn_decode"):
            if not launches[name]:
                fail(f"[l] {label}: {name} was not launched: {launches}")
        # a replay launches its chunk's k steps, those past the stop too; a
        # capture's warm-up is one eager step
        run = k * chunks + captures
        if (launches[cross] != L * run or launches["self_attn_decode"] != L * run
                or launches[other] or steps > k * chunks):
            fail(f"[l] {label}: {cross} launched {launches[cross]} times, self_attn_decode "
                 f"{launches['self_attn_decode']}, for {chunks} replays of {k} steps and "
                 f"{captures} warm-up steps (expected {L} a step), {other} {launches[other]} "
                 f"(expected 0); {steps} true steps")
        self_launches += launches["self_attn_decode"]
        return secs, steps, chunks, captures, ms_step, peak, launches, timings

    beam.decode_step = spy_step
    try:
        # 1. serial, the --accurate options
        t0 = begin()
        res = transcribe_timestamped(model, make_audio(60, 30), tokenizer=tok,
                                     suppress_tokens=eot_off, beam_size=5, best_of=5,
                                     temperature=(0.0, 0.2, 0.4, 0.6, 0.8, 1.0), **SMOKE_OPTIONS)
        secs, steps, chunks, captures, ms_step, peak, launches, timings = end(
            t0, "serial", "xattn_decode", "xattn_decode_int8")
        words = check_result(res)
        windows = len({s["seek"] for s in res["segments"]})
        if rows_seen != {(5, 1, 5)} or not words or {s["temperature"] for s in res["segments"]} != {0.0}:
            fail(f"[l] serial: step rows {rows_seen} (expected 5 beam rows over 1 cross-KV row), "
                 f"{words} words, temperatures {({s['temperature'] for s in res['segments']})}")
        print(f"[l] serial transcribe_timestamped, 30 s, beam 5 best_of 5 (--accurate), no "
              f"thresholds: {secs:.2f} s a request ({windows} window(s); pass 1 "
              f"{stage_line(timings, 'naive_pass1')}, pass 2 {stage_line(timings, 'naive_pass2')}), "
              f"{steps} decode steps at {ms_step:.2f} ms/step (captured), {chunks} replays = host "
              f"syncs ({k} steps each, {k * chunks - steps} past the stop), {captures} capture(s) "
              f"({stage_line(timings, 'decode_capture')}), {words} words, peak memory "
              f"{peak:.2f} GB; launches {launches}")

        # 2. batched, B=8 x K=5, bf16 and kv_int8
        streams = {f"l{j}": make_audio(4000 + j, sec)
                   for j, sec in enumerate([30, 5, 12, 20, 8, 27, 15, 25])}
        for label, levers, cross, other in (
                ("bf16", {}, "xattn_decode", "xattn_decode_int8"),
                ("kv_int8", dict(kv_int8=True), "xattn_decode_int8", "xattn_decode")):
            engine = DecodeEngine(model, tok, **levers)  # the previous one's cache is freed
            t0 = begin()
            res = transcribe_batch(model, streams, tok, batch_size=8, engine=engine,
                                   temperature=[0.0], **SMOKE_OPTIONS,
                                   decode_options=DecodingOptions(beam_size=5,
                                                                  suppress_tokens=eot_off))
            secs, steps, chunks, captures, ms_step, peak, launches, timings = end(
                t0, f"batched {label}", cross, other)
            words = sum(check_result(r) for r in res.values())
            if rows_seen != {(40, 8, 5)} or not words:
                fail(f"[l] batched {label}: step rows {rows_seen} (expected 40 beam rows over 8 "
                     f"cross-KV rows), {words} words")
            if engine.graphs.captures != len(engine.graphs.graphs):
                fail(f"[l] batched {label}: {engine.graphs.captures} captures for "
                     f"{len(engine.graphs.graphs)} distinct keys")
            iters = sum(v for n, v in get_counts().items() if n.startswith("batch_decode_b"))
            print(f"[l] transcribe_batch, beam 5, B=8 x 5 = 40 rows over 8 cross-KV rows, {label}, "
                  f"8 streams (142 s of audio): {secs:.2f} s, {iters} window iteration(s), "
                  f"{steps} decode steps at {ms_step:.2f} ms/step (captured), {chunks} replays "
                  f"({k * chunks - steps} steps past the stop), {engine.graphs.captures} "
                  f"capture(s) = {len(engine.graphs.graphs)} distinct key(s), pass 2 "
                  f"{stage_line(timings, 'batch_naive_align')}, {words} words, peak memory "
                  f"{peak:.2f} GB; launches {launches}")
            del engine
    finally:
        beam.decode_step = step
    torch.cuda.empty_cache()

    # 3. captured against uncaptured, one window batch at B=8 x K=5
    engine = DecodeEngine(model, tok)
    mels = torch.stack([log_mel_spectrogram(make_audio(700 + j, 30), n_mels=model.dims.n_mels,
                                            device=model.device)[:, :3000] for j in range(8)])
    opts = DecodingOptions(language="en", beam_size=5, sample_len=BEAM_MAX_NEW,
                           suppress_tokens=eot_off)
    bufs, lens, sot_from_end = [], [], None
    for j in range(8):
        buf, plen, sot_from_end = engine.build_prompt(list(range(300, 300 + 6 * j)), opts,
                                                      region=PROMPT_REGION)
        bufs.append(buf)
        lens.append(plen)
    prompts = torch.stack([torch.as_tensor(b) for b in bufs]).to(model.device)
    lens = torch.tensor(lens, dtype=torch.int32, device=model.device)
    sm, bm = engine._masks(opts)
    kw = engine._beam_kwargs(opts, sot_from_end)

    def run(**extra):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_stage_timings()
        out = beam.decode_window_beam_batch(model.module, mels, prompts, lens, sm, bm,
                                            **{**kw, **extra})
        torch.cuda.synchronize()
        counts, timings = get_counts(), get_stage_timings()
        steps = counts["decode_steps"]
        return (out, steps, counts["beam_chunks"], 1e3 * timings["decode_loop"]["total_s"] / steps,
                torch.cuda.max_memory_allocated() / 1e9)

    # uncaptured first, while the engine holds no persistent buffers
    eager, e_steps, _, eager_ms, eager_peak = run(graphs=None, uncaptured=True)
    first = run()
    cap, steps, chunks, cap_ms, cap_peak = run()
    for name, t in cap.items():
        if not (torch.equal(t, eager[name]) and torch.equal(t, first[0][name])):
            fail(f"[l] the captured beam loop's {name} differs from the uncaptured loop's")
    if steps != e_steps or chunks != -(-steps // k) or engine.graphs.captures != 1:
        fail(f"[l] captured {steps} steps in {chunks} replays, uncaptured {e_steps}; "
             f"{engine.graphs.captures} captures (expected 1)")
    print(f"[l] decode_window_beam_batch, B=8 x K=5, {BEAM_MAX_NEW} tokens (prompts of 0-42 "
          f"tokens): captured {cap_ms:.2f} ms/step (peak {cap_peak:.2f} GB) vs uncaptured "
          f"{eager_ms:.2f} ({eager_ms / cap_ms:.1f}x; peak {eager_peak:.2f} GB); {steps} steps, "
          f"{chunks} replays = host syncs a window ({k} steps each), {chunks * k - steps} steps "
          f"past the stop; every returned buffer equal bit for bit; 1 capture")
    del engine, first, cap, eager, mels
    torch.cuda.empty_cache()

    # 4. beam_size=1 against greedy on one window
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
    return self_launches


def phase_train(torch, K, device):
    """(m): fine-tuning at large-v3 width: ``make_train_step``'s AdamW steps
    (optax's ``adamw(1e-5)``) on f32 seeded weights, one fixed batch of two
    30 s windows of seeded audio (mel through ``log10_mel``) and 224 seeded
    tokens a row. First the loss and gradients through the kernels against
    the same with the plain versions in ``FlashAttentionFn`` (one step's
    worth, on the initial weights), then a warm step and five timed steps:
    fails unless the losses are finite, the last is below the first, and
    every step launched the three training kernels once a layer and the
    inference kernel never (the first step's batch, loss and named
    gradients also go to ``TRAIN_REF`` for (r), and ``TRAIN_REPEATS``
    backward passes of it with cuDNN's default and then its deterministic
    algorithms are compared bit for bit). Prints ms/step, peak memory and
    the launches,
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
    names = [n for n, p in model.named_parameters()
             if not (model.fixed_pos_emb and n == "encoder.pos_emb")]
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
    write_train_reference(torch, loss_k, dict(zip(names, grads_k)), mel, tokens, mask)
    del grads_k, grads_p

    # run to run, with cuDNN's default and deterministic algorithms: (r)'s
    # tp ranks compute the replicated gradients each, so they stay equal
    # only if those are the same run to run (the mesh's step takes the
    # deterministic ones)
    differ = {}
    saved_flag = torch.backends.cudnn.deterministic
    for label, flag in (("default", False), ("deterministic", True)):
        torch.backends.cudnn.deterministic = flag
        try:
            first, seen = loss_and_grads()[1], set()
            for _ in range(TRAIN_REPEATS - 1):
                seen.update(n for n, a, b in zip(names, first, loss_and_grads()[1])
                            if not torch.equal(a, b))
        finally:
            torch.backends.cudnn.deterministic = saved_flag
        differ[label] = sorted(seen)
        del first
    if differ["deterministic"]:
        fail(f"[m] with cuDNN's deterministic algorithms these gradients differ run to run: "
             f"{differ['deterministic']}")
    print(f"[m] {TRAIN_REPEATS} backward passes of the same step: gradients that differ bit for "
          f"bit with cuDNN's default algorithms {differ['default']}, with its deterministic ones "
          f"none")
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


TRAIN_REPEATS = 4  # (m)'s backward passes of one step, compared bit for bit

# what (m) leaves for (r): its batch, its first step's loss through the
# kernels and these gradients of it, layers 0 and 31 of each stacked leaf
# (a layer norm whole, tok_emb whole)
TRAIN_REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "train_reference.pt")
TRAIN_REF_LAYERS = ("encoder.attn_q_w", "encoder.attn_o_w", "encoder.fc1_w", "encoder.fc2_w",
                    "decoder.attn_q_w", "decoder.attn_o_w", "decoder.fc1_w", "decoder.fc2_w")
TRAIN_REF_WHOLE = ("encoder.attn_ln_g", "decoder.tok_emb")


def write_train_reference(torch, loss: float, grads: dict, mel, tokens, mask) -> None:
    """(m)'s first step for (r): the batch, the loss and the named gradients
    (``TRAIN_REF_LAYERS``' first and last layer, ``TRAIN_REF_WHOLE``), on
    the host, in ``TRAIN_REF``."""
    leaves = {n: grads[n].cpu() for n in TRAIN_REF_WHOLE}
    for n in TRAIN_REF_LAYERS:
        for layer in (0, grads[n].shape[0] - 1):
            leaves[f"{n}[{layer}]"] = grads[n][layer].cpu()
    os.makedirs(os.path.dirname(TRAIN_REF), exist_ok=True)
    torch.save(dict(loss=loss, grads=leaves, mel=mel.cpu(), tokens=tokens.cpu(), mask=mask.cpu()),
               TRAIN_REF)


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
    # the f32 forward: its split pass and its kernel
    split, fwd_k = kernel_ms("split_kv_kernel"), kernel_ms("flash_fwd_tf32_kernel")
    bwd, fwd = kernel_ms("flash_bwd_kernel"), split + fwd_k
    print(f"[m] one traced step: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%; the activities' own times sum to "
          f"{sum(r[1] for r in rows):.1f} ms); flash backward {bwd:.2f} ms "
          f"({100 * bwd / busy_ms:.1f}% of device busy; dQ {dq:.2f}, dK/dV {dkv:.2f}), "
          f"flash forward {fwd:.2f} ms ({100 * fwd / busy_ms:.1f}%; the split pass "
          f"{split:.2f}, the kernel {fwd_k:.2f})")
    for key, ms, n in rows[:8]:
        print(f"[m]   {ms:9.3f} ms {n:6d}x  {key[:90]}")


def trace_window(torch, engine, tok, B: int, tag: str):
    """One window of B rows (the same 30 s clip), 64 tokens, EOT
    suppressed, decoded once untraced (capturing its graph) and once under
    torch.profiler: wall, the device's busy share, the kernels that fill
    it."""
    from whisper_timestamped_tpu_torch.audio import log_mel_spectrogram
    from whisper_timestamped_tpu_torch.decoding import DecodingOptions

    opts = DecodingOptions(language="en", sample_len=64, suppress_tokens=f"-1,{tok.eot}")
    mel = log_mel_spectrogram(make_audio(4, 30), n_mels=128, device=engine.device)
    mel = mel[None].expand(B, -1, -1).contiguous()
    engine.decode_window(mel, opts)
    wall_ms, dev_ms, rows = device_rows(torch, lambda: engine.decode_window(mel, opts))
    label = "+".join(k for k, v in engine.kv_options.items() if v) or "bf16"
    if dev_ms <= 0:
        print(f"{tag} one window, B={B}, {label} cache, 64 tokens: wall {wall_ms:.1f} ms; the "
              f"profiler saw no device time (not measured)")
        return
    print(f"{tag} one window, B={B}, {label} cache, 64 tokens, traced: wall {wall_ms:.1f} ms, "
          f"device busy {dev_ms:.1f} ms ({100 * dev_ms / wall_ms:.1f}%)")
    for key, ms, n in rows[:12]:
        print(f"{tag}   {ms:9.3f} ms {n:6d}x  {key[:90]}")


def phase_profile(torch, model, tok, B: int, **levers):
    """(--profile): device time against wall time for one decoded window of
    B rows, with the engine's ``levers``."""
    from whisper_timestamped_tpu_torch.engine import DecodeEngine

    trace_window(torch, DecodeEngine(model, tok, **levers), tok, B, "[profile]")


# ---------------------------------------------------------------------------
# (p) the captured token loop, tail_batch, the host C++ core
# ---------------------------------------------------------------------------

# (label, B, prompt tokens, engine levers, temperatures); one engine a case
GRAPH_CASES = (
    ("B=1, regions of 8 and 232 slots", 1, (0, 120), {}, (0.0,)),
    ("B=8", 8, (0,), {}, (0.0,)),
    ("B=40 kv_int8", 40, (0,), dict(kv_int8=True), (0.0,)),
    ("B=40 bf16", 40, (0,), {}, (0.0,)),
    ("B=8 kv_int4 + self_kv_int8", 8, (0,), dict(kv_int4=True, self_kv_int8=True), (0.0,)),
    ("B=8 w_int8", 8, (0,), dict(w_int8=True), (0.0,)),
    ("B=8 sampled, T=0.5 then 0.3", 8, (0,), {}, (0.5, 0.3)),
)
GRAPH_MAX_NEW = 96  # tokens a window in (p); EOT allowed
TAIL_STREAMS, TAIL_BATCH = 40, 8  # (p)'s tail_batch stream


def decode_both_ways(torch, engine, mel, prompt_tokens, temperature):
    """One window through ``decoding.decode_window`` with the engine's
    graphs (capturing, unless a graph of its key exists), again (the timed
    replay), and uncaptured on the same inputs: the three runs' buffers
    must be equal bit for bit. Returns (the timed captured run's out, its
    ms/step, the uncaptured run's ms/step), ms/step being the stage
    ``decode_loop`` over the steps."""
    from whisper_timestamped_tpu_torch import decoding as dec
    from whisper_timestamped_tpu_torch.decoding import DecodingOptions
    from whisper_timestamped_tpu_torch.engine import TIME_PER_POSITION

    tok = engine.tokenizer
    opts = DecodingOptions(language="en", sample_len=GRAPH_MAX_NEW)
    buf, plen, sot_from_end = engine.build_prompt(prompt_tokens, opts)
    B = mel.shape[0]
    sm, bm = engine._masks(opts)
    kw = dict(align_heads=engine.align_heads, eot=tok.eot, ts_begin=tok.timestamp_begin,
              no_timestamps=tok.no_timestamps, sot_index_from_end=sot_from_end,
              max_initial_timestamp_index=round(1.0 / TIME_PER_POSITION), max_new=GRAPH_MAX_NEW,
              temperature=temperature, rng_seed=7, **engine.kv_options)
    prompt = torch.as_tensor(buf, device=mel.device)[None].expand(B, -1).contiguous()
    plen = torch.full((B,), plen, dtype=torch.int32, device=mel.device)

    def run(**extra):
        t0 = get_loop_s()
        out = dec.decode_window(engine.model.module, mel, prompt, plen, sm, bm, **kw, **extra)
        torch.cuda.synchronize()
        return out, 1e3 * (get_loop_s() - t0) / max(out["n_steps"], 1)

    first, _ = run(graphs=engine.graphs)
    cap, cap_ms = run(graphs=engine.graphs)
    eager, eager_ms = run(uncaptured=True)
    for name in ("tokens", "n_sampled", "sum_logprobs", "token_logprobs", "ts_logprobs", "attn",
                 "no_speech_prob"):
        if not (torch.equal(cap[name], eager[name]) and torch.equal(cap[name], first[name])):
            fail(f"[p] the captured loop's {name} differs from the uncaptured loop's "
                 f"(B={B}, {len(prompt_tokens)} prompt tokens, T={temperature})")
    if not cap["n_steps"] == first["n_steps"] == eager["n_steps"]:
        fail(f"[p] captured {cap['n_steps']} steps, uncaptured {eager['n_steps']}")
    return cap, cap_ms, eager_ms


def get_loop_s() -> float:
    from whisper_timestamped_tpu_torch.utils import get_stage_timings

    return get_stage_timings().get("decode_loop", {}).get("total_s", 0.0)


def phase_graphs(torch, K, model, tok):
    """(p): the captured token loop on the large-v3 model. Each case of
    GRAPH_CASES decodes a window of 30 s of audio (a distinct clip a row)
    through ``decode_window`` with a new engine's graphs and uncaptured, on
    the same inputs: the buffers must be equal bit for bit and the steps
    equal; printed: ms/step both ways, the replays (each one host sync) a
    window, the steps run past the stop, and the captures, which must
    equal the engine's distinct keys (the second temperature of the
    sampled case replays the first one's graph). Then a B=40 ``kv_int8``
    ``transcribe_batch_stream`` with ``WTT_TAIL_BATCH=8`` against the same
    without it (words), and the host C++ core: built into ``build/`` and
    the one the tokenizer and ``alignment.dtw_path`` use. The memory the
    cases' engines held must be returned when they are freed (at most 0.01
    GB a capture may stay)."""
    from whisper_timestamped_tpu_torch import alignment, decoding, native
    from whisper_timestamped_tpu_torch.audio import log_mel_spectrogram
    from whisper_timestamped_tpu_torch.engine import DecodeEngine

    k = decoding.STOP_CHECK_STEPS
    mels = torch.stack([log_mel_spectrogram(make_audio(500 + j, 30), n_mels=128,
                                            device=model.device)[:, :3000] for j in range(40)])
    torch.cuda.synchronize()
    held, captures = torch.cuda.memory_allocated(), 0
    for label, B, prompts, levers, temps in GRAPH_CASES:
        engine = DecodeEngine(model, tok, **levers)
        before = dict(K.LAUNCHES)
        keys = 0
        for n_prompt in prompts:
            for T in temps:
                cap, cap_ms, eager_ms = decode_both_ways(
                    torch, engine, mels[:B], list(range(300, 300 + n_prompt)), T)
                keys = len(engine.graphs.graphs)
                n, chunks = cap["n_steps"], cap["chunks"]
                print(f"[p] {label}, {n_prompt} prompt tokens, T={T}: {n} steps, captured "
                      f"{cap_ms:.2f} ms/step vs uncaptured {eager_ms:.2f} ({eager_ms / cap_ms:.1f}x); "
                      f"{chunks} replays = host syncs a window ({k} steps each), {chunks * k - n} "
                      f"steps past the stop; buffers equal bit for bit")
        launched = {name: K.LAUNCHES[name] - before[name] for name in K.LAUNCHES}
        if engine.graphs.captures != keys:
            fail(f"[p] {label}: {engine.graphs.captures} captures for {keys} distinct keys")
        print(f"[p] {label}: {engine.graphs.captures} captures = {keys} distinct keys; launches "
              f"{ {n: c for n, c in launched.items() if c} }")
        captures += engine.graphs.captures
        del engine
        torch.cuda.empty_cache()
    # a capture must keep nothing once its engine is freed (a warm-up on a
    # stream of its own kept a cuBLAS workspace, ~35 MB, a capture)
    torch.cuda.synchronize()
    kept = (torch.cuda.memory_allocated() - held) / 1e9
    if kept > 0.01 * captures:
        fail(f"[p] {kept:.3f} GB still allocated after the engines of {captures} captures were "
             f"freed (limit 0.01 GB a capture)")
    print(f"[p] after the {len(GRAPH_CASES)} engines ({captures} captures) were freed: "
          f"{kept:+.3f} GB allocated (limit {0.01 * captures:.2f}: 0.01 a capture)")

    # tail_batch: a B=40 stream whose last windows have at most 8 streams left
    from whisper_timestamped_tpu_torch import transcribe_batch_stream
    from whisper_timestamped_tpu_torch.decoding import DecodingOptions
    from whisper_timestamped_tpu_torch.utils import get_stage_timings, reset_stage_timings

    secs = [5 + (j * 7) % 20 for j in range(TAIL_STREAMS)]
    for j in range(0, TAIL_STREAMS, 8):
        secs[j] = 75  # one stream in 8 runs to three windows or more
    batch = {f"t{j}": make_audio(3000 + j, s) for j, s in enumerate(secs)}
    kw = dict(batch_size=TAIL_STREAMS, temperature=[0.0], **SMOKE_OPTIONS,
              decode_options=DecodingOptions(suppress_tokens=f"-1,{tok.eot}"))
    words, first_window = {}, {}
    for tail in (str(TAIL_BATCH), None):
        engine = DecodeEngine(model, tok, kv_int8=True)
        if tail:
            os.environ["WTT_TAIL_BATCH"] = tail
        try:
            reset_stage_timings()
            t0 = time.perf_counter()
            res = next(iter(transcribe_batch_stream(model, iter([batch]), tok, engine=engine, **kw)))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            os.environ.pop("WTT_TAIL_BATCH", None)
        stages = sorted(k for k in get_stage_timings() if k.startswith("batch_decode_b"))
        words[tail] = {n: [(w["text"], w["start"], w["end"]) for sg in r["segments"]
                           for w in sg.get("words", [])] for n, r in res.items()}
        first_window[tail] = {n: [(w["text"], w["start"], w["end"]) for sg in r["segments"]
                                  if sg.get("seek") == 0 for w in sg.get("words", [])]
                              for n, r in res.items()}
        print(f"[p] B={TAIL_STREAMS} kv_int8 stream, tail_batch={tail}: {wall:.2f} s, windows "
              f"by batch {stages}, {len(engine.graphs.graphs)} graphs, "
              f"{engine.graphs.captures} captures")
        if tail and not any(st.startswith(f"batch_decode_b{tail}_") for st in stages):
            fail(f"[p] tail_batch={tail} decoded no window at B={tail}")
        del engine
        torch.cuda.empty_cache()
    # the streams done before the tail, and the tail streams' first
    # windows, were decoded at B=40 in both runs: their words must be equal.
    # The tail's own windows decode at B=8, whose bf16 products round
    # otherwise than B=40's; the control below decodes 8 windows both ways.
    tail_streams = [n for n, sec in zip(batch, secs) if sec == 75]
    differ = [n for n in batch if n not in tail_streams
              and words[str(TAIL_BATCH)][n] != words[None][n]]
    differ += [n for n in tail_streams
               if first_window[str(TAIL_BATCH)][n] != first_window[None][n]]
    if differ:
        fail(f"[p] tail_batch={TAIL_BATCH} changed words decoded at B={TAIL_STREAMS}: {differ[:5]}")
    same_tail = sum(words[str(TAIL_BATCH)][n] == words[None][n] for n in tail_streams)
    print(f"[p] tail_batch={TAIL_BATCH}: the words of the {TAIL_STREAMS - len(tail_streams)} "
          f"streams done before the tail and the {len(tail_streams)} tail streams' first windows "
          f"equal those without it; the tail streams' later windows (B={TAIL_BATCH} against "
          f"B={TAIL_STREAMS}) equal in {same_tail} of {len(tail_streams)}")
    engine = DecodeEngine(model, tok, kv_int8=True)
    opts = DecodingOptions(language="en", suppress_tokens=f"-1,{tok.eot}")
    small = engine.decode_window(mels[:TAIL_BATCH], opts, fetch_alignment=False)
    large = engine.decode_window(mels[:TAIL_STREAMS], opts, fetch_alignment=False)
    parted = [next((i for i, (a, b) in enumerate(zip(r.tokens, w.tokens)) if a != b), None)
              for r, w in zip(small, large)]
    print(f"[p] control: {TAIL_BATCH} windows decoded at B={TAIL_BATCH} and as rows of "
          f"B={TAIL_STREAMS} ({opts.sample_len or 224} tokens, captured both): tokens equal in "
          f"{parted.count(None)} of {TAIL_BATCH} rows; the others part at tokens "
          f"{[i for i in parted if i is not None]}")
    del engine, small, large
    torch.cuda.empty_cache()

    # the host C++ core
    if not native.available():
        fail("[p] the host C++ core did not build")
    calls = []
    real = native.dtw_path_native
    native.dtw_path_native = lambda *a: calls.append(1) or real(*a)
    try:
        alignment.dtw_path(-torch.rand((20, 300)).numpy())
    finally:
        native.dtw_path_native = real
    bpe = tok.bpe._native_core()
    if calls != [1] or not isinstance(bpe, native.NativeBPE):
        fail(f"[p] the host C++ core is not in use: dtw_path calls {calls}, tokenizer core {bpe}")
    print(f"[p] host C++ core built at {native.library_path()}; alignment.dtw_path and the "
          f"tokenizer's BPE go through it")


# ---------------------------------------------------------------------------
# (n) voice activity detection, (o) the weight levers
# ---------------------------------------------------------------------------


def write_silero_jit(torch, path: str, seed: int = 5) -> str:
    """A seeded torchscript model with the published silero-vad v5 ``.jit``'s
    state_dict schema and forward (a 576-sample frame with the previous
    chunk's last 64 samples, the STFT as a (258, 1, 256) conv at stride 128,
    four reparam convs, an ``LSTMCell(128, 128)`` carried across calls, a
    (1, 128, 1) conv head and a sigmoid), its weights set so that it answers
    loudness: the STFT basis random, the encoder convs non-negative without
    biases (features proportional to the amplitude), the LSTM's cell gate
    reading the features' mean (input and output gates open, forget gate
    shut, small random recurrent weights), the head's bias -4. Silence then
    scores ~0.02 and the speech blocks of ``speech_blocks`` near 1."""
    import numpy as np
    import torch.nn as nn

    class Stft(nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("forward_basis_buffer", torch.zeros(258, 1, 256))

        def forward(self, x):
            out = nn.functional.conv1d(x[:, None, :], self.forward_basis_buffer, stride=128)
            return torch.sqrt(out[:, :129] ** 2 + out[:, 129:] ** 2 + 1e-12)

    class EncBlock(nn.Module):
        def __init__(self, cin: int, cout: int, stride: int):
            super().__init__()
            self.reparam_conv = nn.Conv1d(cin, cout, 3, stride=stride, padding=1)

        def forward(self, x):
            return torch.relu(self.reparam_conv(x))

    class Decoder(nn.Module):
        def __init__(self):
            super().__init__()
            self.rnn = nn.LSTMCell(128, 128)
            self.decoder = nn.Sequential(nn.Identity(), nn.ReLU(), nn.Conv1d(128, 1, 1),
                                         nn.Sigmoid())

    class Inner(nn.Module):
        def __init__(self):
            super().__init__()
            self.stft = Stft()
            self.encoder = nn.Sequential(EncBlock(129, 128, 1), EncBlock(128, 64, 2),
                                         EncBlock(64, 64, 2), EncBlock(64, 128, 1))
            self.decoder = Decoder()

    class SileroV5(nn.Module):
        def __init__(self):
            super().__init__()
            self._model = Inner()
            self.register_buffer("_h", torch.zeros(1, 128))
            self.register_buffer("_c", torch.zeros(1, 128))
            self.register_buffer("_ctx", torch.zeros(64))

        @torch.jit.export
        def reset_states(self):
            self._h.zero_()
            self._c.zero_()
            self._ctx.zero_()

        def forward(self, x, sr: int):
            frame = torch.cat([self._ctx, x])[None]
            feat = self._model.encoder(self._model.stft(frame)).mean(dim=-1)
            h, c = self._model.decoder.rnn(feat, (self._h, self._c))
            self._h.copy_(h)
            self._c.copy_(c)
            self._ctx.copy_(x[-64:])
            return self._model.decoder.decoder(h[:, :, None]).reshape(())

    g = torch.Generator().manual_seed(seed)
    model = SileroV5().eval()
    inner, H = model._model, 128
    with torch.no_grad():
        inner.stft.forward_basis_buffer.copy_(torch.randn(258, 1, 256, generator=g) * 0.1)
        for block in inner.encoder:
            block.reparam_conv.weight.copy_(
                torch.randn(block.reparam_conv.weight.shape, generator=g).abs()
                * block.reparam_conv.weight.shape[1] ** -0.5)
            block.reparam_conv.bias.zero_()
        # the mean feature of one normalized speech block calibrates the cell gate
        audio, spans = speech_blocks(seed)
        start = int(spans[0][0] * 16000)
        a = audio[start: start + 64 * 512] / np.abs(audio).max()
        x = torch.cat([torch.zeros(64), torch.from_numpy(a)])
        mean = inner.encoder(inner.stft(x.unfold(0, 576, 512))).mean()
        rnn = inner.decoder.rnn
        rnn.weight_ih.zero_()
        rnn.weight_ih[2 * H:3 * H] = 3.0 / (H * float(mean))
        rnn.weight_hh.copy_(torch.randn(4 * H, H, generator=g) * 0.02)
        rnn.bias_ih.zero_()
        rnn.bias_ih[:H], rnn.bias_ih[H:2 * H], rnn.bias_ih[3 * H:] = 8.0, -8.0, 8.0
        rnn.bias_hh.zero_()
        inner.decoder.decoder[2].weight.fill_(10.0 / H)
        inner.decoder.decoder[2].bias.fill_(-4.0)
    torch.jit.script(model).save(path)
    return path


def speech_blocks(seed: int, seconds: int = 60, rate: int = 16000):
    """``seconds`` of seeded audio: speech-like blocks (``make_audio``'s
    tone and noise) of 4-9 s with silences of 1.5-3.5 s between them (a
    1e-3 noise floor). Returns (audio, [(start, end) seconds of each
    block])."""
    import numpy as np

    rng = np.random.default_rng(seed)
    audio = (1e-3 * rng.standard_normal(rate * seconds)).astype(np.float32)
    spans, t = [], float(rng.uniform(0.5, 2.0))
    while t < seconds - 2:
        dur = min(float(rng.uniform(4, 9)), seconds - t)
        block = make_audio(seed * 7 + len(spans), int(np.ceil(dur)))[: int(dur * rate)]
        audio[int(t * rate): int(t * rate) + len(block)] = block
        spans.append((round(t, 3), round(t + len(block) / rate, 3)))
        t += dur + float(rng.uniform(1.5, 3.5))
    return audio, spans


def words_in_speech(res: dict):
    """(words inside a ``speech_activity`` span, words past the last span,
    words elsewhere). A time past the speech audio's end maps past the last
    span, unclamped, as the reference maps it (``vad.do_convert_timestamps``):
    random weights put timestamps anywhere in a window."""
    spans = res["speech_activity"]
    inside = past = other = 0
    for seg in res["segments"]:
        for w in seg.get("words", []):
            if any(sp["start"] - 0.01 <= w["start"] <= w["end"] <= sp["end"] + 0.01 for sp in spans):
                inside += 1
            elif w["start"] >= spans[-1]["end"] - 0.01:
                past += 1
            else:
                other += 1
    return inside, past, other


VAD_KERNELS = ("log10_mel", "flash_attention", "xattn_decode", "self_attn_decode")


def phase_vad(torch, K, model, tok):
    """(n): voice activity detection on the large-v3 model. A seeded silero
    v5 ``.jit`` (``write_silero_jit``) under ``SILERO_VAD_PATH``, 60 s
    streams of speech blocks and silences (``speech_blocks``), 64-token
    windows. ``transcribe_timestamped`` with explicit pairs (the blocks),
    ``"auditok"`` and ``"silero"``; ``transcribe_batch`` of 8 streams with
    ``"silero"`` against each stream alone through ``transcribe_batch`` (the
    same speech spans, which are ``remove_non_speech``'s, and words) and
    against ``transcribe_timestamped`` (the same speech spans; the tokens,
    decoded at B=1 where the batch decodes at B=8, are compared and
    printed, not held: bf16 products of the two batch sizes round
    differently, so random weights' tokens and word times part ways,
    without VAD too, which the phase prints for one stream);
    ``transcribe_batch_stream`` over two batches of 4 against
    ``transcribe_batch``. Each run: ``speech_activity`` present, every word
    inside a span or past the last one, ``log10_mel``, ``flash_attention``,
    ``xattn_decode`` and ``self_attn_decode`` launched (counters reset just
    before, read just after). The silero module: its parameters on the card,
    its probabilities on 2,000 seeded chunks within 1e-4 of the torchscript
    model's on the CPU with TF32 allowed in cuBLAS and cuDNN around the call,
    and its time on one hour of audio (112,500 chunks)."""
    import numpy as np

    from whisper_timestamped_tpu_torch import transcribe_batch, transcribe_batch_stream, transcribe_timestamped
    from whisper_timestamped_tpu_torch.decoding import DecodingOptions
    from whisper_timestamped_tpu_torch.engine import DecodeEngine
    from whisper_timestamped_tpu_torch.models import silero as S
    from whisper_timestamped_tpu_torch.vad import remove_non_speech

    device = model.device
    work = tempfile.mkdtemp(prefix="wtt_vad_")
    saved_env = os.environ.get("SILERO_VAD_PATH")
    try:
        path = write_silero_jit(torch, os.path.join(work, "silero_vad.jit"))
        os.environ["SILERO_VAD_PATH"] = path
        t0 = time.perf_counter()
        fn = S._cached_prob_model(path, device)
        load_s = time.perf_counter() - t0
        if not getattr(fn, "is_module", False):
            fail("[n] the silero .jit did not load into the module")
        module = fn.module
        places = {t.device.type for t in list(module.parameters()) + list(module.buffers())}
        if places != {"cuda"}:
            fail(f"[n] the silero module's tensors are on {places}, not the card")

        # the f32 guard: TF32 allowed globally around the module's call
        rng = np.random.default_rng(21)
        chunks = (rng.standard_normal((2000, 512))
                  * np.exp(rng.uniform(-7, 0, (2000, 1)))).astype(np.float32)
        want = S.load_torchscript_prob_model(path)(chunks, 16000)
        cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        try:
            got = fn(chunks, 16000)
            flags_after = (cudnn.allow_tf32, matmul.allow_tf32)
        finally:
            cudnn.allow_tf32 = matmul.allow_tf32 = False
        err = float(np.abs(got - want).max())
        spread = np.histogram(want, bins=4, range=(0, 1))[0].tolist()
        if not err <= 1e-4 or flags_after != (True, True):
            fail(f"[n] silero module on the card vs torchscript on the CPU, TF32 allowed: max abs "
                 f"err {err:.3g} (limit 1e-4), flags after the call {flags_after}")
        print(f"[n] silero module loaded and checked against torchscript in {load_s:.2f} s; on "
              f"the card with TF32 allowed around it, 2000 chunks: max abs err {err:.3g} vs the "
              f"torchscript model on the CPU (limit 1e-4; probabilities by quarter {spread})")

        # one hour of audio
        hour = torch.randn((112_500, 512), generator=torch.Generator(device=device).manual_seed(3),
                           device=device) * 0.1
        module(hour[:1000])
        torch.cuda.synchronize()
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        with torch.no_grad(), S._strict_f32():
            module.features(hour)
        e[1].record()
        probs = module(hour)
        e[2].record()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(probs).all()):
            fail("[n] silero probabilities over an hour are not finite")
        print(f"[n] silero on one hour of audio (112500 chunks of 512 samples) on the card: "
              f"{e[1].elapsed_time(e[2]):.1f} ms (its STFT and encoder alone "
              f"{e[0].elapsed_time(e[1]):.1f} ms; the rest is the LSTM's 112500 steps)")
        del hour, probs

        kw = dict(tokenizer=tok, suppress_tokens=f"-1,{tok.eot}", sample_len=64, **SMOKE_OPTIONS)
        audio, blocks = speech_blocks(0)

        def checked(label, res, launches, wall=None):
            """Checks one result; prints its line when given its wall time,
            else returns (words, inside a span, past the last)."""
            if "speech_activity" not in res or not res["speech_activity"]:
                fail(f"[n] {label}: no speech_activity")
            n = check_result(res)
            inside, past, other = words_in_speech(res)
            if not n or other:
                fail(f"[n] {label}: {n} words, {other} outside the speech spans "
                     f"(spans {res['speech_activity']})")
            missing = [k for k in VAD_KERNELS if not launches[k]]
            if missing:
                fail(f"[n] {label}: {missing} not launched: {launches}")
            if wall is None:
                return n, inside, past
            print(f"[n] {label}: {wall:.2f} s, {len(res['speech_activity'])} speech spans, {n} "
                  f"words ({inside} inside a span, {past} past the last); launches "
                  + ", ".join(f"{k} {launches[k]}" for k in VAD_KERNELS))

        transcribe_timestamped(model, make_audio(0, 3), vad="silero", **{**kw, "sample_len": 4})
        serial = {}
        for label, vad in (("explicit pairs", blocks), ("auditok", "auditok"), ("silero", "silero")):
            torch.cuda.synchronize()
            K.reset_launches()
            t0 = time.perf_counter()
            res = transcribe_timestamped(model, audio, vad=vad, **kw)
            torch.cuda.synchronize()
            checked(f"transcribe_timestamped, 60 s, vad={label}", res, dict(K.LAUNCHES),
                    time.perf_counter() - t0)
            serial[label] = res
        if len(serial["explicit pairs"]["speech_activity"]) != len(blocks):
            fail(f"[n] explicit pairs: speech_activity {serial['explicit pairs']['speech_activity']} "
                 f"for the blocks {blocks}")

        streams = {f"n{j}": speech_blocks(j)[0] for j in range(8)}
        bkw = dict(batch_size=8, temperature=[0.0], vad="silero", **SMOKE_OPTIONS,
                   decode_options=DecodingOptions(suppress_tokens=f"-1,{tok.eot}", sample_len=64))
        engine = DecodeEngine(model, tok)
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        batch = transcribe_batch(model, streams, tok, engine=engine, **bkw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        tally = [checked(f"transcribe_batch stream {name}", batch[name], launches)
                 for name in streams]

        def words(res):
            return [(w["text"], w["start"], w["end"]) for s in res["segments"]
                    for w in s.get("words", [])]

        # each stream alone through transcribe_batch (the same B=8 products):
        # the same speech spans and words; the spans also equal
        # remove_non_speech's on the stream
        t0 = time.perf_counter()
        for name, a in streams.items():
            alone = transcribe_batch(model, {name: a}, tok, engine=engine, **bkw)[name]
            spans = remove_non_speech(a, method="silero", avoid_empty_speech=True,
                                      device=device)[1]
            if (alone["speech_activity"] != batch[name]["speech_activity"]
                    or [(sp["start"], sp["end"]) for sp in alone["speech_activity"]] != spans):
                fail(f"[n] {name}: speech_activity differs between the batch, the stream alone "
                     f"and remove_non_speech")
            if words(alone) != words(batch[name]):
                fail(f"[n] {name}: the batch's words differ from the stream's alone")
        alone_s = time.perf_counter() - t0
        # transcribe_timestamped decodes at B=1: its bf16 products round
        # otherwise than B=8's, so random weights' tokens and word times part
        # ways (as they do without VAD); its speech spans must be the batch's
        one = serial["silero"]
        if one["speech_activity"] != batch["n0"]["speech_activity"]:
            fail("[n] n0: the batch's speech_activity differs from transcribe_timestamped's")

        def tokens(res):
            return [t for s in res["segments"] for t in s["tokens"]]

        def agree(x, y):
            return (next((i for i, (p, q) in enumerate(zip(x, y)) if p != q), min(len(x), len(y))),
                    len(x), len(y))

        # the same comparison without VAD: B=1 against B=8 alone
        a0 = streams["n0"]
        plain = agree(tokens(transcribe_timestamped(model, a0, **kw)),
                      tokens(transcribe_batch(model, {"n0": a0}, tok, engine=engine,
                                              **{**bkw, "vad": False})["n0"]))
        with_vad = agree(tokens(one), tokens(batch["n0"]))
        print(f"[n] transcribe_batch, 8 streams of 60 s, vad=silero, B=8: {wall:.2f} s, "
              f"{sum(t[0] for t in tally)} words ({sum(t[1] for t in tally)} inside a span, "
              f"{sum(t[2] for t in tally)} past the last); launches "
              + ", ".join(f"{k} {launches[k]}" for k in VAD_KERNELS)
              + f"; each stream alone through transcribe_batch gives the same speech spans "
              f"and words, the spans remove_non_speech's ({alone_s:.2f} s); n0 against "
              f"transcribe_timestamped (B=1): the same speech spans, the first {with_vad[0]} "
              f"of {with_vad[1]} / {with_vad[2]} tokens equal (without VAD: {plain[0]} of "
              f"{plain[1]} / {plain[2]})")

        halves = [dict(list(streams.items())[:4]), dict(list(streams.items())[4:])]
        K.reset_launches()
        t0 = time.perf_counter()
        got = list(transcribe_batch_stream(model, iter(halves), tok, engine=engine, **bkw))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        if [list(r) for r in got] != [list(h) for h in halves]:
            fail("[n] the stream's results are not the batches' streams, in order")
        for res in got:
            for name, r in res.items():
                checked(f"transcribe_batch_stream {name}", r, launches)
                if words(r) != words(batch[name]):
                    fail(f"[n] {name}: the stream's words differ from transcribe_batch's")
        print(f"[n] transcribe_batch_stream, 2 batches x 4 streams, vad=silero: {wall:.2f} s; "
              f"launches " + ", ".join(f"{k} {launches[k]}" for k in VAD_KERNELS)
              + "; the words equal transcribe_batch's")
    finally:
        if saved_env is None:
            os.environ.pop("SILERO_VAD_PATH", None)
        else:
            os.environ["SILERO_VAD_PATH"] = saved_env
        shutil.rmtree(work, ignore_errors=True)


def int8_bytes(view) -> int:
    """Bytes of the int8 copies (codes and scales) an engine built."""
    from whisper_timestamped_tpu_torch.models.whisper_torch import Int8Weight

    qs = [v for v in view.encoder.values() if isinstance(v, Int8Weight)]
    qs += list(view.decoder.get("blocks_w8", {}).values())
    qs += [view.decoder["logits_w8"]] if "logits_w8" in view.decoder else []
    return sum(q.w8.numel() + 4 * q.s.numel() for q in qs)


def phase_weight_levers(torch, K, model, tok):
    """(o): the weight levers on one B=8 batch of (f)'s first streams (5-35
    s, EOT suppressed): a bf16 engine, ``w_int8``, ``enc_int8``, and both
    with ``kv_int8``. Each run: words, the decode kernels launched at least
    32 times a step (``xattn_decode_int8`` in place of ``xattn_decode``
    under ``kv_int8``), ``flash_attention`` in the encoder; its ms/step, the
    encoder's ms at B=8 (CUDA events, the engine's parameters), the peak
    memory with the engine's copies and the copies' bytes. The engines' int8
    codes and scales equal a CPU quantization of the same weights, bit for
    bit, and ``model.module``'s tensors are unchanged after all runs."""
    from whisper_timestamped_tpu_torch import transcribe_batch
    from whisper_timestamped_tpu_torch.audio import log_mel_spectrogram
    from whisper_timestamped_tpu_torch.decoding import DecodingOptions
    from whisper_timestamped_tpu_torch.engine import DecodeEngine
    from whisper_timestamped_tpu_torch.models.whisper_torch import encode, quantize_linear
    from whisper_timestamped_tpu_torch.utils import get_counts, get_stage_timings, reset_stage_timings

    module, n_layer = model.module, model.dims.n_text_layer
    before = {(side, k): v.clone() for side, pd in (("enc", module.encoder), ("dec", module.decoder))
              for k, v in pd.items()}
    secs = [35, 5, 12, 20, 8, 27, 15, 30]
    batch = {f"o{j}": make_audio(j, sec) for j, sec in enumerate(secs)}
    kw = dict(batch_size=8, temperature=[0.0], **SMOKE_OPTIONS,
              decode_options=DecodingOptions(suppress_tokens=f"-1,{tok.eot}"))
    mels = torch.stack([log_mel_spectrogram(torch.from_numpy(make_audio(50 + j, 30)),
                                            n_mels=model.dims.n_mels, device=model.device)[:, :3000]
                        for j in range(8)])
    runs = (("bf16", {}), ("w_int8", dict(w_int8=True)), ("enc_int8", dict(enc_int8=True)),
            ("w_int8+enc_int8+kv_int8", dict(w_int8=True, enc_int8=True, kv_int8=True)))
    tokens = {}
    for label, levers in runs:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = DecodeEngine(model, tok, **levers)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        view = engine.model.module
        copies_gb = int8_bytes(view) / 1e9 if levers else 0.0
        if levers.get("w_int8") or levers.get("enc_int8"):
            checks = []
            if levers.get("w_int8"):
                checks += [(view.decoder["blocks_w8"][n][l], module.decoder[n][l])
                           for n, l in (("fc1_w", 0), ("attn_q_w", n_layer - 1),
                                        ("cross_o_w", n_layer // 2))]
                checks.append((view.decoder["logits_w8"], module.decoder["tok_emb"]))
            if levers.get("enc_int8"):
                checks += [(view.encoder[n][l], module.encoder[n][l])
                           for n, l in (("fc2_w", 0), ("attn_k_w", model.dims.n_audio_layer - 1))]
            for q, w in checks:
                ref = quantize_linear(w.cpu())
                if not (torch.equal(q.w8.cpu(), ref.w8) and torch.equal(q.s.cpu(), ref.s)):
                    fail(f"[o] {label}: the engine's int8 codes or scales differ from a CPU "
                         f"quantization of the same weights")
        enc_ms = cuda_time_ms(lambda it=0: encode(view, mels), iters=5)
        transcribe_batch(model, {f"w{j}": make_audio(90 + j, 3) for j in range(8)}, tok,
                         engine=engine, **{**kw, "decode_options": DecodingOptions(
                             suppress_tokens=f"-1,{tok.eot}", sample_len=4)})
        torch.cuda.synchronize()
        reset_stage_timings()
        K.reset_launches()
        t0 = time.perf_counter()
        res = transcribe_batch(model, batch, tok, engine=engine, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        steps = get_counts().get("decode_steps", 0)
        ms_step = 1e3 * get_stage_timings()["decode_loop"]["total_s"] / max(steps, 1)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n_words = sum(check_result(r) for r in res.values())
        cross = "xattn_decode_int8" if levers.get("kv_int8") else "xattn_decode"
        other = "xattn_decode" if levers.get("kv_int8") else "xattn_decode_int8"
        if not n_words:
            fail(f"[o] {label}: no words")
        if (launches[cross] < n_layer * steps or launches["self_attn_decode"] < n_layer * steps
                or launches[other] or not launches["flash_attention"]):
            fail(f"[o] {label}: launches for {steps} steps: {launches}")
        tokens[label] = [s["tokens"] for r in res.values() for s in r["segments"]]
        same = "" if label == "bf16" else (
            f"; tokens {'equal to' if tokens[label] == tokens['bf16'] else 'differ from'} bf16's")
        print(f"[o] {label}: engine built in {build_s:.2f} s (int8 copies {copies_gb:.3f} GB), "
              f"transcribe_batch of 8 streams ({sum(secs)} s), B=8: {wall:.2f} s, {steps} steps, "
              f"decode loop {ms_step:.2f} ms/step, encoder at B=8 {enc_ms:.2f} ms, peak memory "
              f"{peak_gb:.2f} GB, {n_words} words{same}; launches {cross} {launches[cross]}, "
              f"self_attn_decode {launches['self_attn_decode']}, flash_attention "
              f"{launches['flash_attention']}")
        del engine, view, res
    # one linear of each kind alone: the encoder's fc1 at B=8 (12000 tokens),
    # the decode step's fc1 at B=8 (8 rows)
    import whisper_timestamped_tpu_torch.models.whisper_torch as wt

    g = torch.Generator(device=model.device).manual_seed(8)
    w, bias = module.encoder["fc1_w"][0], module.encoder["fc1_b"][0]
    q = quantize_linear(w, act_int8=True)
    x = torch.randn((8 * 1500, w.shape[1]), generator=g, device=model.device).to(w.dtype)
    x8 = torch.round(x.float() * 10).clamp(-127, 127).to(torch.int8)
    t_enc = (cuda_time_ms(lambda it=0: torch.nn.functional.linear(x, w, bias)),
             cuda_time_ms(lambda it=0: wt._linear_w8a8(x, q, bias)),
             cuda_time_ms(lambda it=0: torch._int_mm(x8, q.w8.t())))
    wd, bd = module.decoder["fc1_w"][0], module.decoder["fc1_b"][0]
    qd = quantize_linear(wd)
    xd = torch.randn((8, 1, wd.shape[1]), generator=g, device=model.device).to(wd.dtype)
    t_dec = (cuda_time_ms(lambda it=0: torch.nn.functional.linear(xd, wd, bd)),
             cuda_time_ms(lambda it=0: wt._linear_w8(xd, qd, bd)))
    print(f"[o] one linear alone (CUDA events): the encoder's fc1 on 12000 x {w.shape[1]} -> "
          f"{w.shape[0]}: bf16 F.linear {t_enc[0]:.4f} ms, W8A8 {t_enc[1]:.4f} ms (its "
          f"torch._int_mm alone {t_enc[2]:.4f} ms); the decode step's fc1 on 8 rows: bf16 "
          f"{t_dec[0]:.4f} ms, weight-only int8 {t_dec[1]:.4f} ms")
    del x, x8, xd, q, qd

    after = {(side, k): v for side, pd in (("enc", module.encoder), ("dec", module.decoder))
             for k, v in pd.items()}
    if list(after) != list(before) or not all(
            after[k].dtype == before[k].dtype and torch.equal(after[k], before[k]) for k in before):
        fail("[o] model.module's tensors changed")
    print(f"[o] model.module unchanged ({len(before)} tensors equal to their copies from before "
          f"the runs); the int8 codes and scales equal a CPU quantization of the same weights")
    del before, after, mels


# ---------------------------------------------------------------------------
# (q) the mesh
# ---------------------------------------------------------------------------

# [q]'s limit on the tp=2 model against the one-card model: [e]'s limits
# for the kernels against their plain versions, the same kind of
# difference (bf16 products summed in another order): the encoder output
# norm-wise (|a - b| / |b|; its max difference over its max is printed,
# not held: 32 bf16 layers of random weights carry any perturbation to a
# few percent of the largest output, [e]), the decode step's logits by
# their max difference over their max
MESH_REL_LIMIT = 2e-2
MESH_LENGTHS = (35, 5, 12, 20, 8, 27, 15, 30)  # (f)'s first batch
# tokens a window in (q)'s batches: its tp=2 steps with two ranks on one
# H100 cost 0.2-0.6 s each over gloo, so (q) decodes 64 steps a batch, 2
# windows of 32 tokens
MESH_MAX_NEW = 32
MESH_DIR = os.path.join("build", "mesh_smoke")


def phase_mesh_kernel(torch, K, device):
    """(q): ``self_attn_decode_int8``'s scales-given instance at a tp=2
    rank's shape (B=8, ctx 456, pos 232, L=32, 10 heads, D=640; each row's
    scales those of a 1280-wide row whose first 640 columns the rank holds)
    against ``write_quantized_row(row_scales=)`` and the plain version in
    f32, then timed beside the instance that reduces the row itself, at the
    same shape. Returns the kernel's record."""
    from whisper_timestamped_tpu_torch.ops.quant import quantize_rows, row_scales

    g = torch.Generator(device=device).manual_seed(17)
    L, B, ctx, D, H, pos = 32, 8, 456, 640, 10, 232

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    q = randn(B, 1, D).bfloat16()
    k_row, v_row = randn(B, 1, 2 * D).bfloat16(), randn(B, 1, 2 * D).bfloat16()
    k_new, v_new = k_row[..., :D].contiguous(), v_row[..., :D].contiguous()
    given = row_scales(torch.cat([k_row, v_row], dim=1).transpose(0, 1), 127.0).contiguous()
    cache = (*quantize_rows(randn(L, B, ctx, D)), *quantize_rows(randn(L, B, ctx, D)))
    pads = torch.tensor([SELF_PADS[b % 4] for b in range(B)], dtype=torch.int32, device=device)
    slot = torch.full((), pos, dtype=torch.int32, device=device)
    err = 0.0
    for layer in (0, 17, 31):
        ck = [t.clone() for t in cache]
        o_k = K.self_attn_decode_int8(q, k_new, v_new, *ck, layer, slot, pads, H, extent=ctx,
                                      row_scales=given)
        torch.cuda.synchronize()
        cp = [t.clone() for t in cache]
        K.write_quantized_row(k_new, v_new, *cp, layer, pos, given)
        if not all(torch.equal(a, b) for a, b in zip(ck, cp)):
            fail(f"[q] the scales-given int8 self instance wrote other codes or scales than "
                 f"write_quantized_row(row_scales=) (layer {layer})")
        ref = K.self_attn_decode_int8_plain(q.float(), *cp, layer, pos, pads, H)
        diff = (o_k.float() - ref).abs()
        if not (torch.isfinite(o_k.float()).all()
                and bool((diff <= SELF_Q_ATOL + SELF_Q_RTOL * ref.abs()).all())):
            fail(f"[q] the scales-given int8 self instance disagrees at layer {layer}: max abs "
                 f"{diff.max().item():.3g} (limit 2^-8 of the f32 plain version + {SELF_Q_ATOL})")
        err = max(err, diff.max().item())
    pad0 = torch.zeros((B,), dtype=torch.int32, device=device)

    def given_scales(it=0):
        return K.self_attn_decode_int8(q, k_new, v_new, *cache, it % L, slot, pad0, H,
                                       extent=ctx, row_scales=given)

    def own_scales(it=0):
        return K.self_attn_decode_int8(q, k_new, v_new, *cache, it % L, slot, pad0, H, extent=ctx)

    def plain(it=0):
        K.write_quantized_row(k_new, v_new, *cache, it % L, pos, given)
        return K.self_attn_decode_int8_plain(q, *cache, it % L, pos, pad0, H)

    before = dict(K.LAUNCHES)
    times = {}
    for turn, fn in (("own", own_scales), ("given", given_scales), ("given2", given_scales),
                     ("own2", own_scales)):
        times[turn] = cuda_time_ms(fn)
    if K.LAUNCHES["self_attn_decode_int8_scaled"] == before["self_attn_decode_int8_scaled"]:
        fail("[q] row_scales did not launch the scales-given instance")
    ms = (times["given"] + times["given2"]) / 2
    own_ms = (times["own"] + times["own2"]) / 2
    plain_ms = cuda_time_ms(plain, iters=5)
    live = pos + 1  # as [c]'s int8 self record, plus the given scales read
    moved = B * (4 * D * 2 + 2 * live * (D + 4) + 2 * (D + 4) + 2 * 4)
    b_ms, b_by = bound(moved, 4 * B * live * D, F32_FLOPS)
    n_sm = K._sm_count(device)
    print(f"[q] self_attn_decode_int8 with given row scales, B=8 ctx=456 pos=232 D=640 H=10 "
          f"({K.xattn_split(B, H, ctx, n_sm)[0]} splits, {K.pipeline_warps(B, H, n_sm)} warps a "
          f"block): codes and scales equal write_quantized_row(row_scales=) bit for bit, max abs "
          f"err {err:.3g} against the plain version in f32 (limit 2^-8 of it + {SELF_Q_ATOL}); "
          f"{ms:.4f} ms (turns {times['given']:.4f}, {times['given2']:.4f}) vs the instance that "
          f"reduces the row itself {own_ms:.4f} ms (turns {times['own']:.4f}, "
          f"{times['own2']:.4f}), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
          f"{moved / 1e6:.2f} MB); no single PyTorch call computes it")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                max_abs_err=err, own_scales_ms=own_ms)


def rel_err(a, b, norm: bool = False) -> float:
    """max |a - b| over max |b| (with ``norm``: |a - b| / |b|), in f32."""
    a, b = a.float(), b.float()
    if norm:
        return ((a - b).norm() / b.norm()).item()
    return ((a - b).abs().max() / b.abs().max()).item()


@contextlib.contextmanager
def heads_seen(seen: set):
    """Record the head count each attention kernel is called with (its q's
    width over 64) while the model's forward calls it."""
    import whisper_timestamped_tpu_torch.models.whisper_torch as wt

    names = ("flash_attention", "xattn_decode", "xattn_decode_int8", "self_attn_decode",
             "self_attn_decode_int8")
    saved = {n: getattr(wt, n) for n in names}

    def wrap(n, fn):
        def call(q, *a, **kw):
            seen.add((n, q.shape[-1] // 64))
            return fn(q, *a, **kw)
        return call

    for n, fn in saved.items():
        setattr(wt, n, wrap(n, fn))
    try:
        yield seen
    finally:
        for n, fn in saved.items():
            setattr(wt, n, fn)


def weight_bytes(module) -> int:
    """Bytes of the module's parameter storages, each counted once."""
    seen, total = set(), 0
    for pd in (module.encoder, module.decoder):
        for t in pd.values():
            key = t.untyped_storage().data_ptr()
            if key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
    return total


def mesh_rank(rank: int, world: int, backend: str, out_dir: str) -> None:
    """One rank of (q): its device, the process group, the checks; the
    results go to ``out_dir/rank<r>.json``. An exception fails the spawn."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ["LOCAL_RANK"] = str(rank)
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="file://" + os.path.abspath(
        os.path.join(out_dir, "store")), world_size=world, rank=rank)
    try:
        out = mesh_checks(torch, rank, device)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def mesh_checks(torch, rank: int, device):
    """A rank's work in (q); returns what the parent prints and compares."""
    import torch.distributed as dist

    from whisper_timestamped_tpu_torch import transcribe_batch
    from whisper_timestamped_tpu_torch.decoding import DecodingOptions
    from whisper_timestamped_tpu_torch.engine import DecodeEngine
    from whisper_timestamped_tpu_torch.models import whisper_torch as wt
    from whisper_timestamped_tpu_torch.ops import _build
    from whisper_timestamped_tpu_torch.ops import kernels as K
    from whisper_timestamped_tpu_torch.ops.quant import quantize_rows
    from whisper_timestamped_tpu_torch.parallel.mesh import get_mesh, shard_params
    from whisper_timestamped_tpu_torch.utils import get_counts, get_stage_timings, reset_stage_timings

    t0 = time.perf_counter()
    _build.library()
    model, tok = large_v3_model(torch, device)
    tp_mesh, dp_mesh = get_mesh(dp=1, tp=2), get_mesh(dp=2, tp=1)
    sharded = shard_params(model, tp_mesh)
    one, mine = model.module, sharded.module
    tp = mine.tensor_parallel
    D = one.dims.n_text_state // tp.size
    cols = slice(tp.rank * D, (tp.rank + 1) * D)
    sections = {"build": time.perf_counter() - t0}
    t0 = time.perf_counter()
    out = dict(backend=dist.get_backend(), via_host=tp.via_host, device=str(device),
               weight_bytes=weight_bytes(mine),
               full_weight_bytes=weight_bytes(one),
               block_bytes=sum(t.nbytes for pd in (one.encoder, one.decoder)
                               for n, t in pd.items() if n.startswith(wt._LAYER_PREFIXES)),
               sharded_block_bytes=sum(t.nbytes for pd in (mine.encoder, mine.decoder)
                                       for n, t in pd.items()
                                       if n.startswith(wt._LAYER_PREFIXES)))

    # 1. one encode and one decode step at B=8 against the one-card model
    g = torch.Generator(device=device).manual_seed(7)
    heads = [tuple(h) for h in model.alignment_heads]
    with torch.no_grad():
        mel = torch.randn((8, 128, 3000), generator=g, device=device)
        xa1, xa2 = wt.encode(one, mel), wt.encode(mine, mel)
        c1, c2 = wt.init_cache(one, xa1, ctx_len=240), wt.init_cache(mine, xa2, ctx_len=240)
        for full, part in ((c1.k, c2.k), (c1.v, c2.v)):  # 16 slots written, as by a prefill
            full[:, :, :16].copy_(torch.randn(full[:, :, :16].shape, generator=g, device=device))
            part[:, :, :16].copy_(full[:, :, :16, cols])
        tokens = torch.randint(0, 50000, (8, 1), generator=g, device=device)
        pad = torch.full((8,), 3, dtype=torch.int32, device=device)
        l1, r1 = wt.decode_step(one, tokens, c1, 16, pos_offset=pad, kv_valid_from=pad,
                                align_heads=heads)
        l2, r2 = wt.decode_step(mine, tokens, c2, 16, pos_offset=pad, kv_valid_from=pad,
                                align_heads=heads)
        out.update(encode_norm_rel=rel_err(xa2, xa1, norm=True), encode_rel=rel_err(xa2, xa1),
                   logits_rel=rel_err(l2, l1), rows_rel=rel_err(r2, r1))
        del c1, c2

        # 2. the int8 cross K/V of one given xa: the scales of the whole rows
        q8 = wt.init_cache(mine, xa1, ctx_len=16, quantize_cross=True)
        scales_equal = codes_equal = True
        kv_rel = 0.0
        for l in (0, one.dims.n_text_layer - 1):
            dec, dec1 = mine.decoder, one.decoder
            for name, local, full in (
                    ("k", wt._linear(xa1, dec["cross_k_w"][l]), wt._linear(xa1, dec1["cross_k_w"][l])),
                    ("v", wt._linear(xa1, dec["cross_v_w"][l], dec["cross_v_b"][l]),
                     wt._linear(xa1, dec1["cross_v_w"][l], dec1["cross_v_b"][l]))):
                codes, scales = (q8.xk, q8.xk_scale) if name == "k" else (q8.xv, q8.xv_scale)
                q_g, s_g = quantize_rows(tp.gather(local, dim=-1))
                scales_equal &= torch.equal(scales[l], s_g)
                codes_equal &= torch.equal(codes[l], q_g[..., cols])
                kv_rel = max(kv_rel, rel_err(local, full[..., cols]))
        out.update(cross_scales_equal=bool(scales_equal), cross_codes_equal=bool(codes_equal),
                   cross_kv_rel=kv_rel)
        del q8, xa1, xa2, mel

        # the cost of one sum over tp of a decode step's (B, 1, D) bf16 rows
        x = torch.randn((8, 1, one.dims.n_text_state), generator=g, device=device).bfloat16()
        tp.sum_(x)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        for _ in range(100):
            tp.sum_(x)
        torch.cuda.synchronize()
        out["sum_ms"] = 10 * (time.perf_counter() - ts)
    torch.cuda.empty_cache()

    # 4. transcribe_batch at tp=2, bf16 then kv_int8 + self_kv_int8
    sections["checks"] = time.perf_counter() - t0
    kw = dict(batch_size=8, temperature=[0.0], **SMOKE_OPTIONS,
              decode_options=DecodingOptions(suppress_tokens=f"-1,{tok.eot}",
                                             sample_len=MESH_MAX_NEW))
    streams = {f"s{j}": make_audio(j, sec) for j, sec in enumerate(MESH_LENGTHS)}
    warm = {f"w{j}": make_audio(90 + j, 3) for j in range(8)}
    warm_kw = {**kw, "decode_options": DecodingOptions(suppress_tokens=f"-1,{tok.eot}",
                                                       sample_len=4)}
    for label, levers in (("bf16", {}), ("int8", dict(kv_int8=True, self_kv_int8=True))):
        ts = time.perf_counter()
        engine = DecodeEngine(model, tok, mesh=tp_mesh, **levers)
        if label == "bf16":  # the first calls' set-up (cuBLAS, the first collectives)
            transcribe_batch(model, warm, tok, engine=engine, **warm_kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_stage_timings()
        K.reset_launches()
        counts0 = dict(get_counts())
        seen: set = set()
        t0 = time.perf_counter()
        with heads_seen(seen):
            res = transcribe_batch(model, streams, tok, engine=engine, **kw)
        torch.cuda.synchronize()
        counts = {k: v - counts0.get(k, 0) for k, v in get_counts().items()}
        timings = get_stage_timings()
        out[label] = dict(
            wall_s=time.perf_counter() - t0, results=res, launches=dict(K.LAUNCHES),
            steps=counts.get("decode_steps", 0), iterations=counts.get("decode_dispatch", 0),
            eager_chunks=counts.get("tp_eager_chunks", 0), graphs=len(engine.graphs.graphs),
            loop_s=timings.get("decode_loop", {}).get("total_s", 0.0),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9, heads=sorted(seen),
            engine_weight_bytes=weight_bytes(engine.model.module), tp=engine.tp)
        del engine
        torch.cuda.empty_cache()
        sections[label] = time.perf_counter() - ts

    # 5. dp=2: this rank's streams r::2 at batch_size 4, against one card's
    t1 = time.perf_counter()
    engine = DecodeEngine(model, tok, mesh=dp_mesh)
    reset_stage_timings()
    counts0 = dict(get_counts())
    t0 = time.perf_counter()
    merged = transcribe_batch(model, streams, tok, engine=engine, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v - counts0.get(k, 0) for k, v in get_counts().items()}
    own = list(streams)[rank::2]
    alone = transcribe_batch(model, {n: streams[n] for n in own}, tok,
                             engine=DecodeEngine(model, tok), **{**kw, "batch_size": 4})
    out["dp"] = dict(wall_s=wall, results=merged, own=own,
                     own_equal=all(merged[n] == alone[n] for n in own),
                     eager_chunks=counts.get("tp_eager_chunks", 0),
                     graphs=len(engine.graphs.graphs), steps=counts.get("decode_steps", 0),
                     loop_s=get_stage_timings().get("decode_loop", {}).get("total_s", 0.0))
    sections["dp"] = time.perf_counter() - t1
    out["sections_s"] = sections
    return out


def phase_mesh(torch, here: str) -> int:
    """(q): two ranks through ``parallel.mesh`` (see the module docstring);
    returns rank 0's launches of the scales-given int8 self instance in
    its tp=2 ``kv_int8`` + ``self_kv_int8`` batch."""
    import torch.multiprocessing as mp

    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= 2 else "gloo"
    why = ("one rank a card" if n_cards >= 2 else
           "one card: NCCL refuses two ranks on one device, gloo reduces through the host")
    out_dir = os.path.join(here, MESH_DIR)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    mp.spawn(mesh_rank, args=(2, backend, out_dir), nprocs=2, join=True)
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    print(f"[q] 2 ranks on {[r['device'] for r in ranks]}, backend {r0['backend']} ({why}); "
          f"{wall:.1f} s for the phase, the ranks' start and model builds included (rank 0's "
          f"sections: { {k: round(v, 1) for k, v in r0['sections_s'].items()} } s); two ranks on "
          f"one card share its SMs, so (q)'s times describe that layout only")
    for r, res in enumerate(ranks):
        rels = (res["encode_norm_rel"], res["logits_rel"])
        if not all(x <= MESH_REL_LIMIT for x in rels):
            fail(f"[q] rank {r}: the tp=2 model disagrees with the one-card model: encoder "
                 f"norm-wise {rels[0]:.3g}, logits {rels[1]:.3g} (limit {MESH_REL_LIMIT})")
        if not (res["cross_scales_equal"] and res["cross_codes_equal"]):
            fail(f"[q] rank {r}: init_cache's int8 scales or codes are not quantize_rows' of the "
                 f"rows gathered over tp")
        print(f"[q] rank {r}, tp=2, B=8, against the one-card model: encoder output norm-wise rel "
              f"diff {res['encode_norm_rel']:.3g} (max {res['encode_rel']:.3g}), decode-step "
              f"logits max rel diff {res['logits_rel']:.3g} (limits {MESH_REL_LIMIT}, [e]'s), "
              f"alignment rows {res['rows_rel']:.3g}; one sum over tp of a step's (8, 1, 1280) "
              f"bf16 rows {res['sum_ms']:.3f} ms (host clock, 100 in a row); int8 cross "
              f"K/V (first and last layer): scales and codes equal quantize_rows of the rows gathered "
              f"over tp, the rank's K/V {res['cross_kv_rel']:.3g} from the one-card slice")
    for label in ("bf16", "int8"):
        a, b = ranks[0][label], ranks[1][label]
        if a["results"] != b["results"]:
            fail(f"[q] tp=2 {label}: the two ranks' results differ")
        words = [check_result(v) for v in a["results"].values()]
        if list(a["results"]) != [f"s{j}" for j in range(len(MESH_LENGTHS))] or not any(words):
            fail(f"[q] tp=2 {label}: the results lack streams or words")
        kernels = (("xattn_decode", "self_attn_decode") if label == "bf16" else
                   ("xattn_decode_int8", "self_attn_decode_int8_scaled"))
        for r, res in enumerate((a, b)):
            n = res["launches"]
            if res["tp"] != 2 or res["eager_chunks"] == 0 or res["graphs"]:
                fail(f"[q] rank {r} {label}: the tp=2 loop was captured or not run eagerly: {res}")
            L = LARGE_V3["n_text_layer"]
            short = [k for k in kernels if n[k] < L * res["steps"]]
            if short or n["flash_attention"] < L * res["iterations"]:
                fail(f"[q] rank {r} {label}: launches {n} for {res['steps']} steps and "
                     f"{res['iterations']} window iterations (expected >= {L} a step and a "
                     f"window)")
            if label == "int8" and (n["self_attn_decode_int8"] or n["xattn_decode"]):
                fail(f"[q] rank {r} int8: a kernel of another cache ran: {n}")
            if {h for _, h in res["heads"]} != {LARGE_V3["n_text_head"] // 2}:
                fail(f"[q] rank {r} {label}: the kernels ran at heads {res['heads']}, not "
                     f"{LARGE_V3['n_text_head'] // 2}")
        ms_step = [1e3 * res["loop_s"] / max(res["steps"], 1) for res in (a, b)]
        print(f"[q] tp=2 transcribe_batch, {label if label == 'bf16' else 'kv_int8 + self_kv_int8'}"
              f", 8 streams ({sum(MESH_LENGTHS)} s of audio) at B=8: both ranks' results equal bit "
              f"for bit, {sum(words)} words; s/batch {[round(r['wall_s'], 2) for r in (a, b)]}, "
              f"ms/step {[round(x, 2) for x in ms_step]} over {a['steps']} steps, token loop "
              f"uncaptured ({a['eager_chunks']} eager chunks, 0 graphs), peak memory "
              f"{[round(r['peak_gb'], 2) for r in (a, b)]} GB; launches (rank 0) "
              f"{ {k: v for k, v in a['launches'].items() if v} }, every kernel at "
              f"{sorted({h for _, h in a['heads']})} heads")
    full = r0["full_weight_bytes"]
    print(f"[q] resident weight bytes a rank at tp=2: "
          f"{[round(r['int8']['engine_weight_bytes'] / 1e9, 3) for r in ranks]} GB "
          f"(the blocks' {r0['sharded_block_bytes'] / 1e9:.3f} GB of {r0['block_bytes'] / 1e9:.3f} + "
          f"the replicated rest {(full - r0['block_bytes']) / 1e9:.3f}); one card "
          f"{full / 1e9:.3f} GB")
    a, b = ranks[0]["dp"], ranks[1]["dp"]
    if a["results"] != b["results"] or list(a["results"]) != [f"s{j}" for j in range(len(MESH_LENGTHS))]:
        fail("[q] dp=2: the ranks' merged dicts differ or are not in the streams' order")
    for r, res in enumerate((a, b)):
        if not res["own_equal"]:
            fail(f"[q] dp=2 rank {r}: its streams' results differ from one card's "
                 f"transcribe_batch of them at batch_size=4")
        if res["eager_chunks"] or not res["graphs"]:
            fail(f"[q] dp=2 rank {r}: the token loop was not captured: {res['graphs']} graphs")
    print(f"[q] dp=2 transcribe_batch, 4 streams a rank at B=4: each rank's streams' results "
          f"equal one card's transcribe_batch of them at batch_size=4 bit for bit, the merged dicts "
          f"equal; loops captured ({a['graphs']} graphs a rank); s/batch "
          f"{[round(r['wall_s'], 2) for r in (a, b)]}, ms/step "
          f"{[round(1e3 * r['loop_s'] / max(r['steps'], 1), 2) for r in (a, b)]}")
    return r0["int8"]["launches"]["self_attn_decode_int8_scaled"]


# (r)'s limits, set before its first run: the tp=2 step against (m)'s
# one-card step (both through the kernels; f32 sums in another order) at
# (m)'s gate for the kernels against the plain versions; dp=2 against one
# card at the same depth, the loss at the same rtol
MESH_TRAIN_LOSS_RTOL = 1e-5
MESH_TRAIN_GRAD_LIMIT = 1e-3  # of a leaf's max abs
MESH_TRAIN_STEPS = 3  # timed tp=2 steps, after the compared one
MESH_TRAIN_DP_LAYERS = 8  # (r)'s dp=2 depth, each stack
MESH_TRAIN_DIR = os.path.join("build", "mesh_train_smoke")


def phase_mesh_train_kernels(torch, K, device):
    """(r): the three training flash kernels at a tp=2 rank's shape (B=2,
    T=1500, H=10, D=640, f32), against their plain versions (the f32 gate
    of (c)), timed beside the plain versions and SDPA's forward and
    backward, with their bounds (3xTF32 on the tensor cores). Returns the
    fields the kernels' records take."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=device).manual_seed(23)
    B, T, H = 2, LARGE_V3["n_audio_ctx"], LARGE_V3["n_audio_head"] // 2
    D = 64 * H
    q, k, v, dout = (torch.randn((B, T, D), generator=g, device=device) for _ in range(4))
    out, lse = K.flash_attention_fwd(q, k, v, H)
    out_p, lse_p = K.flash_attention_fwd_plain(q, k, v, H)
    grads = K.flash_attention_bwd(q, k, v, out_p, lse_p, dout, H)
    want = K.flash_attention_bwd_plain(q, k, v, out_p, lse_p, dout, H)
    torch.cuda.synchronize()
    tol = TRAIN_TOL["f32"]
    e_fwd = ((out - out_p).abs().max() / out_p.abs().max()).item()
    e_bwd = max(((a - w).abs().max() / w.abs().max()).item() for a, w in zip(grads, want))
    if not (e_fwd <= tol and e_bwd <= tol):
        fail(f"[r] the training kernels at a tp=2 rank's shape disagree with the plain versions: "
             f"forward {e_fwd:.3g}, backward {e_bwd:.3g} of a max (limit {tol})")
    io, rows, pairs = B * T * D * 4, B * H * T * 4, B * H * T * T * 64
    bounds = {"flash_attention_fwd": bound(4 * io + rows, 3 * 4 * pairs, TF32_FLOPS),
              "flash_attention_bwd_dq": bound(6 * io + 2 * rows, 3 * 6 * pairs, TF32_FLOPS),
              "flash_attention_bwd_dkv": bound(6 * io + 2 * rows, 3 * 8 * pairs, TF32_FLOPS)}
    _, delta = K._flash_bwd_dq(q, k, v, out_p, dout, lse_p, H)
    ms = {"flash_attention_fwd": cuda_time_ms(lambda it=0: K.flash_attention_fwd(q, k, v, H),
                                              iters=10),
          "flash_attention_bwd_dq": cuda_time_ms(
              lambda it=0: K._flash_bwd_dq(q, k, v, out_p, dout, lse_p, H), iters=10),
          "flash_attention_bwd_dkv": cuda_time_ms(
              lambda it=0: K._flash_bwd_dkv(q, k, v, dout, lse_p, delta, H), iters=10)}
    plain_f = cuda_time_ms(lambda it=0: K.flash_attention_fwd_plain(q, k, v, H), iters=5)
    plain_b = cuda_time_ms(lambda it=0: K.flash_attention_bwd_plain(q, k, v, out_p, lse_p, dout, H),
                           iters=5)
    qh, kh, vh = (heads_view(x, H).detach().requires_grad_() for x in (q, k, v))
    lib_f = cuda_time_ms(lambda it=0: sdpa(qh.detach(), kh.detach(), vh.detach()), iters=10)
    o_lib = sdpa(qh, kh, vh)
    lib_b = cuda_time_ms(lambda it=0: torch.autograd.grad(
        o_lib, (qh, kh, vh), heads_view(dout, H), retain_graph=True), iters=10)
    print(f"[r] training kernels at a tp=2 rank's shape, f32 B={B} T={T} D={D} H={H}: forward "
          f"{ms['flash_attention_fwd']:.4f} ms (bound {bounds['flash_attention_fwd'][0]:.4f}, "
          f"plain {plain_f:.4f}, sdpa forward {lib_f:.4f}), dq "
          f"{ms['flash_attention_bwd_dq']:.4f} ms (bound {bounds['flash_attention_bwd_dq'][0]:.4f}),"
          f" dkv {ms['flash_attention_bwd_dkv']:.4f} ms (bound "
          f"{bounds['flash_attention_bwd_dkv'][0]:.4f}); plain backward {plain_b:.4f} ms, sdpa "
          f"backward alone {lib_b:.4f} ms; against the plain versions forward {e_fwd:.3g}, "
          f"backward {e_bwd:.3g} of a max (limit {tol})")
    rec = {}
    for name in TRAIN_PATH:
        fwd = name == "flash_attention_fwd"
        rec[name] = dict(rank_tp2_ms=ms[name], rank_tp2_bound_ms=bounds[name][0],
                         rank_tp2_bound_by=bounds[name][1],
                         rank_tp2_plain_ms=plain_f if fwd else plain_b,
                         rank_tp2_library_ms=lib_f if fwd else lib_b,
                         rank_tp2_max_err=e_fwd if fwd else e_bwd)
    del q, k, v, dout, out, lse, out_p, lse_p, grads, want, qh, kh, vh, o_lib, delta
    torch.cuda.empty_cache()
    return rec


def mesh_train_rank(rank: int, world: int, backend: str, out_dir: str) -> None:
    """One rank of (r): as ``mesh_rank``, with ``mesh_train_checks``."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ["LOCAL_RANK"] = str(rank)
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="file://" + os.path.abspath(
        os.path.join(out_dir, "store")), world_size=world, rank=rank)
    try:
        out = mesh_train_checks(torch, rank, device)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def collectives_timed(torch, calls: list):
    """Each all-reduce of ``parallel.mesh`` (the tp sums, the dp gradient
    buckets) appended to ``calls`` as (ms, bytes), timed on the host clock
    between two synchronizes (the queued work finished first)."""
    from whisper_timestamped_tpu_torch.parallel import mesh

    reduce = mesh._all_reduce_

    def timed(t, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reduce(t, *a, **kw)
        torch.cuda.synchronize()
        calls.append((1e3 * (time.perf_counter() - t0), t.nbytes))
        return out

    mesh._all_reduce_ = timed
    try:
        yield calls
    finally:
        mesh._all_reduce_ = reduce


@contextlib.contextmanager
def train_heads_seen(K, seen: set):
    """Record the head count each training flash kernel is called with."""
    saved = K.flash_attention_fwd, K.flash_attention_bwd

    def fwd(q, k, v, n_head):
        seen.add(("fwd", n_head))
        return saved[0](q, k, v, n_head)

    def bwd(*a):
        seen.add(("bwd", a[-1]))
        return saved[1](*a)

    K.flash_attention_fwd, K.flash_attention_bwd = fwd, bwd
    try:
        yield seen
    finally:
        K.flash_attention_fwd, K.flash_attention_bwd = saved


def mesh_train_checks(torch, rank: int, device):
    """A rank's work in (r); returns what the parent prints and compares."""
    import torch.distributed as dist

    from whisper_timestamped_tpu_torch import training as T
    from whisper_timestamped_tpu_torch.models import WhisperDims, init_params
    from whisper_timestamped_tpu_torch.ops import _build
    from whisper_timestamped_tpu_torch.ops import kernels as K
    from whisper_timestamped_tpu_torch.parallel import mesh as mesh_module
    from whisper_timestamped_tpu_torch.parallel.mesh import (get_mesh, param_shard_dims,
                                                              shard_batch, shard_params)

    t0 = time.perf_counter()
    _build.library()
    ref = torch.load(TRAIN_REF, map_location=device, weights_only=True)
    batch = (ref["mel"], ref["tokens"], ref["mask"])
    dims = WhisperDims(**LARGE_V3)
    mesh = get_mesh(dp=1, tp=2)
    full = init_params(dims, seed=0, dtype=torch.float32, device=device)  # (m)'s weights
    init_state, train_step = T.make_train_step(dims, mesh=mesh)
    state = init_state(shard_params(full, mesh))
    del full  # the rank keeps its shard only
    torch.cuda.empty_cache()
    tp = state.params.tensor_parallel
    dims_of = param_shard_dims(state.params)
    sections = {"build": time.perf_counter() - t0}
    out = dict(backend=dist.get_backend(), via_host=tp.via_host, device=str(device),
               params=sum(p.numel() for p in state.params.parameters()))

    # 1. the first step against (m)'s, its gradients' slices against (m)'s leaves
    t0 = time.perf_counter()
    K.reset_launches()
    seen: set = set()
    with train_heads_seen(K, seen):
        state, loss = train_step(state, *batch)
    torch.cuda.synchronize()
    named = dict(state.params.named_parameters())
    grad_rel = {}
    for key, want in ref["grads"].items():
        name, layer = (key.split("[")[0], int(key.split("[")[1][:-1])) if "[" in key else (key, None)
        got, d = named[name].grad, dims_of[name]
        if layer is not None:
            got, d = got[layer], (None if d is None else d - 1)
        if d is not None:
            m = want.shape[d] // tp.size
            want = want.narrow(d, tp.rank * m, m)
        grad_rel[key] = ((got - want).abs().max() / want.abs().max()).item()
    out.update(first_loss=loss.item(), ref_loss=ref["loss"], grad_rel=grad_rel,
               first_launches=dict(K.LAUNCHES), heads=sorted(seen))
    del ref
    sections["first_step"] = time.perf_counter() - t0

    # 2. timed steps, then one with its collectives timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    losses = [loss]
    for _ in range(MESH_TRAIN_STEPS):
        state, loss = train_step(state, *batch)
        losses.append(loss)
    torch.cuda.synchronize()
    out.update(ms_step=1e3 * (time.perf_counter() - t0) / MESH_TRAIN_STEPS,
               launches=dict(K.LAUNCHES), peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    calls: list = []
    t0 = time.perf_counter()
    with collectives_timed(torch, calls):
        state, loss = train_step(state, *batch)
        losses.append(loss)
        torch.cuda.synchronize()
    out.update(timed_step_ms=1e3 * (time.perf_counter() - t0), collectives=len(calls),
               collective_ms=sum(c[0] for c in calls), collective_gb=sum(c[1] for c in calls) / 1e9,
               losses=[x.item() for x in losses])

    # 3. the replicated parameters bit-equal on both ranks: the max and the min
    # over tp of their bits are this rank's bits
    replicated = [n for n in named if dims_of[n] is None]
    bits = torch.cat([named[n].detach().reshape(-1).view(torch.int32) for n in replicated])
    hi, lo = bits.clone(), bits.clone()
    for t, op in ((hi, dist.ReduceOp.MAX), (lo, dist.ReduceOp.MIN)):
        mesh_module._all_reduce_(t, tp.group, tp.via_host, op)
    sizes = [named[n].numel() for n in replicated]
    out["replicated_differ"] = [n for n, a, b, c in zip(replicated, bits.split(sizes),
                                                         hi.split(sizes), lo.split(sizes))
                                if not (torch.equal(a, b) and torch.equal(a, c))]
    out["replicated_params"] = bits.numel()
    sections["tp_steps"] = time.perf_counter() - t0
    del state, bits, hi, lo, named, losses, loss
    torch.cuda.empty_cache()

    # 4. dp=2 at full width, 8 + 8 layers: a row a rank, against one card on both rows
    t0 = time.perf_counter()
    dims8 = WhisperDims(**{**LARGE_V3, "n_audio_layer": MESH_TRAIN_DP_LAYERS,
                           "n_text_layer": MESH_TRAIN_DP_LAYERS})
    mesh_dp = get_mesh(dp=2, tp=1)
    init_dp, step_dp = T.make_train_step(dims8, mesh=mesh_dp)
    state = init_dp(shard_params(init_params(dims8, seed=0, dtype=torch.float32, device=device),
                                 mesh_dp))
    mine = shard_batch(batch, mesh_dp)
    dp_losses, dp_ms = [], []
    for _ in range(3):
        t1 = time.perf_counter()
        state, loss = step_dp(state, *mine)
        dp_losses.append(loss.item())
        dp_ms.append(1e3 * (time.perf_counter() - t1))
    out["dp"] = dict(losses=dp_losses, ms=dp_ms, rows=int(mine[1].shape[0]))
    del state
    torch.cuda.empty_cache()
    if rank == 0:
        init_one, step_one = T.make_train_step(dims8)
        state = init_one(init_params(dims8, seed=0, dtype=torch.float32, device=device))
        one = []
        for _ in range(3):
            state, loss = step_one(state, *batch)
            one.append(loss.item())
        out["dp"]["one_card"] = one
        del state
    sections["dp"] = time.perf_counter() - t0
    out["sections_s"] = sections
    return out


def phase_mesh_train(torch, here: str):
    """(r): two ranks training through ``make_train_step(mesh=)`` (see the
    module docstring); returns rank 0's launches a step of the training
    kernels at tp=2."""
    import torch.multiprocessing as mp

    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= 2 else "gloo"
    out_dir = os.path.join(here, MESH_TRAIN_DIR)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    mp.spawn(mesh_train_rank, args=(2, backend, out_dir), nprocs=2, join=True)
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0, L, H = ranks[0], LARGE_V3["n_audio_layer"], LARGE_V3["n_audio_head"] // 2
    print(f"[r] 2 ranks on {[r['device'] for r in ranks]}, backend {r0['backend']}; {wall:.1f} s "
          f"for the phase (rank 0's sections: "
          f"{ {k: round(v, 1) for k, v in r0['sections_s'].items()} } s); {r0['params'] / 1e9:.3f} "
          f"B parameters a rank at tp=2")
    if ranks[0]["losses"] != ranks[1]["losses"]:
        fail(f"[r] tp=2: the ranks' losses differ: {[r['losses'] for r in ranks]}")
    for r, res in enumerate(ranks):
        loss, want = res["first_loss"], res["ref_loss"]
        worst = max(res["grad_rel"].values())
        if not (math.isfinite(loss) and abs(loss - want) <= MESH_TRAIN_LOSS_RTOL * abs(want)
                and worst <= MESH_TRAIN_GRAD_LIMIT):
            fail(f"[r] rank {r} tp=2: the first step disagrees with (m)'s one-card step: loss "
                 f"{loss} vs {want} (rtol {MESH_TRAIN_LOSS_RTOL}), gradients {res['grad_rel']} "
                 f"(limit {MESH_TRAIN_GRAD_LIMIT} of a leaf's max)")
        losses = res["losses"]
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            fail(f"[r] rank {r} tp=2: the losses are not finite and falling: {losses}")
        if res["replicated_differ"]:
            fail(f"[r] rank {r} tp=2: replicated parameters differ between the ranks: "
                 f"{res['replicated_differ']}")
        for label, n, steps in (("first", res["first_launches"], 1),
                                ("timed", res["launches"], MESH_TRAIN_STEPS)):
            if any(n[k] != steps * L for k in TRAIN_PATH) or n["flash_attention"]:
                fail(f"[r] rank {r} tp=2 {label} steps: expected {L} launches a step of each "
                     f"training kernel and none of flash_attention: {n}")
        if {tuple(h) for h in res["heads"]} != {("fwd", H), ("bwd", H)}:
            fail(f"[r] rank {r} tp=2: the training kernels ran at heads {res['heads']}, not {H}")
        print(f"[r] rank {r}, tp=2, large-v3 f32, B=2, 224 tokens: first loss {loss:.6f} against "
              f"(m)'s {want:.6f} (rtol {MESH_TRAIN_LOSS_RTOL}); gradients at most {worst:.3g} of a "
              f"leaf's max abs against (m)'s (limit {MESH_TRAIN_GRAD_LIMIT}; "
              f"{ {k: float(f'{v:.3g}') for k, v in res['grad_rel'].items()} }); losses "
              f"{[round(x, 5) for x in losses]}; {res['ms_step']:.1f} ms/step over "
              f"{MESH_TRAIN_STEPS} steps; peak memory {res['peak_gb']:.2f} GB; launches a step: "
              + ", ".join(f"{k} {res['launches'][k] // MESH_TRAIN_STEPS}"
                          for k in (*TRAIN_PATH, "flash_attention"))
              + f" at {H} heads; replicated parameters ({res['replicated_params'] / 1e6:.1f} M) "
              f"bit-equal on both ranks")
        print(f"[r] rank {r}, tp=2, one step with its collectives timed (a synchronize before and "
              f"after each): {res['timed_step_ms']:.1f} ms, {res['collectives']} all-reduces of "
              f"{res['collective_gb']:.3f} GB in all, {res['collective_ms']:.1f} ms inside them")
    a, b = ranks[0]["dp"], ranks[1]["dp"]
    one = a["one_card"]
    if a["losses"] != b["losses"] or a["rows"] != 1:
        fail(f"[r] dp=2: the ranks' losses differ or a rank has {a['rows']} rows: {a} {b}")
    if not all(abs(x - y) <= MESH_TRAIN_LOSS_RTOL * abs(y) for x, y in zip(a["losses"], one)):
        fail(f"[r] dp=2: the losses {a['losses']} are not the one-card step's {one} on both rows "
             f"(rtol {MESH_TRAIN_LOSS_RTOL})")
    print(f"[r] dp=2, {MESH_TRAIN_DP_LAYERS} + {MESH_TRAIN_DP_LAYERS} layers at full width, a row "
          f"a rank: losses {a['losses']} equal on both ranks; one card on both rows {one} (rtol "
          f"{MESH_TRAIN_LOSS_RTOL}: the whole batch's masked mean); ms a step (the first warm) "
          f"{[round(x, 1) for x in a['ms']]} / {[round(x, 1) for x in b['ms']]}")
    return {k: r0["launches"][k] // MESH_TRAIN_STEPS for k in TRAIN_PATH}


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
    if "--train-only" in sys.argv[1:]:
        phase_train(torch, K, device)
        torch.cuda.empty_cache()
        phase_mesh_train_kernels(torch, K, device)
        phase_mesh_train(torch, here)
        print("[r] --train-only: stopping after (m) and (r)")
        return 0
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
    rec["self_attn_decode"]["launches_table_l"] = phase_beam(torch, K, model, tok)
    torch.cuda.empty_cache()
    train_launches = phase_train(torch, K, device)
    for name in TRAIN_PATH:
        launches[name] = train_launches[name]
    torch.cuda.empty_cache()
    phase_vad(torch, K, model, tok)
    torch.cuda.empty_cache()
    phase_weight_levers(torch, K, model, tok)
    torch.cuda.empty_cache()
    phase_graphs(torch, K, model, tok)
    torch.cuda.empty_cache()
    rec["self_attn_decode_int8_scaled"] = phase_mesh_kernel(torch, K, device)
    launches["self_attn_decode_int8_scaled"] = phase_mesh(torch, here)
    torch.cuda.empty_cache()
    for name, fields in phase_mesh_train_kernels(torch, K, device).items():
        rec[name].update(fields)
    for name, n in phase_mesh_train(torch, here).items():
        rec[name]["launches_tp2_rank_step"] = n
    torch.cuda.empty_cache()
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
