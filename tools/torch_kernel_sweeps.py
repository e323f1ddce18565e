#!/usr/bin/env python3
"""Design sweeps of the port's kernels on one NVIDIA GPU.

    python3 tools/torch_kernel_sweeps.py [xattn] [pipeline] [flash] [matmul-variants]
                                         [matmul-splits] [mel-variants] [mel-refine]
                                         [mel-refine-variants] [align-variants]
                                         [dtw-variants] [flash-bwd-variants]
                                         [flash-fwd-variants]
                                         [decode|step|matmul|mel|encoder|align|
                                          align-launches|flash-bwd|flash-fwd|
                                          median9 [DIR ...]]
    python3 tools/torch_kernel_sweeps.py mel-accuracy [ROW ...]
    python3 tools/torch_kernel_sweeps.py flash-bwd-accuracy [T ...]

``xattn``: the five kernels of the decode-attention pipeline
(``csrc/decode_attn.cuh``) at each grid setting of ``XATTN_SETTINGS`` (the
warps a block, ``PIPELINE_WARPS``, and the warps a multiprocessor the split
rule aims at, ``XATTN_WARPS_PER_SM``), timed as ``decode`` times a checkout.

``pipeline``: the pipeline's sources with one design choice changed at a
time (``PIPELINE_VARIANTS``, built as ``flash`` builds its variants), each
timed as ``xattn`` times it, at ``PIPELINE_SETTINGS``.

``decode``: the decode attentions of the checkout at each DIR (default:
this one), each in its own process, in the order given (so
``decode OLD . . OLD`` times two trees in turns on one card), with their
kernels' registers (large-v3: T=1500, ctx=456, D=1280, H=20, the layer
cycling over 32): ``xattn_decode`` (beside SDPA), ``xattn_decode_int8`` and
``xattn_decode_int4`` at B = 1, 8 and 40 with and without scores,
``self_attn_decode`` at B = 1, 8 and 40 and pos 232 and 455, alone and with
the step's row write (on a tree whose wrapper does not take the new rows,
two indexing copies and the launch, as its decode step made them), beside
SDPA over the live slots, and ``self_attn_decode_int8`` with its quantized
row write at the same B and pos.

``step``: the same in turns for ``decode_step`` of a large-v3-geometry model
of seeded random bf16 weights, with a bf16 and an int8 cross K/V at B = 1,
8 and 40: host-clock ms a step over 64 steps, each ending in a
synchronize, as the token loop's steps do.

``matmul``: ``stacked_matmul`` of the checkout at each DIR, in turns as
``decode`` times them, at the nine shapes ``chip_smoke.py`` [c] times
(K x N in 1280 x 5120, 5120 x 1280 and 1280 x 1280, B = 1, 8 and 40, L =
32, the layer cycling so the weights come from memory) beside
``F.linear`` on the layer's slice, with its error against the plain
version, the bound and, on a tree with ``matmul_split``, its grid.

``encoder``: ``flash_attention`` of the checkout at each DIR, in turns, at
the encoder's shape (B = 1 and 8, T = 1500, D = 1280, H = 20), timed as
``flash`` times its variants.

``matmul-splits``: ``stacked_matmul`` of this checkout at the same shapes
at every split count it can take, beside ``F.linear``.

``matmul-variants``: ``csrc/stacked_matmul.cu`` with one design choice
changed at a time (``MATMUL_VARIANTS``, built as ``flash`` builds its
variants), each timed as ``matmul`` times the tree.

``mel-variants``: ``log10_mel`` with one design choice changed or one
stage of its work removed at a time (``MEL_VARIANTS``), each timed as
``mel`` times the tree.

``mel``: ``log10_mel`` of the checkout at each DIR, in turns, on
``chip_smoke.py`` [c]'s inputs ((g)'s stack of 40 streams of 5-35 s,
zero-padded to 35 s, plus 30 s: 40 x 6500 frames, 128 mels; one 10-minute
stream plus 30 s), beside its plain version and the same function as
several library calls (``torch.stft`` with the window, the power, the mel
product, the clamp and ``log10``: cuFFT, timed only), with its error
against the plain version and against a float64 FFT of the same frames
(``torch.fft.rfft``), and the float64 FFT's own distance to the plain
version (what any exact kernel would show against it).

``mel-refine-variants``: ``log10_mel`` with the parts of its refinement
removed one after another (``MEL_REFINE_VARIANTS``), each timed as ``mel``
times the tree.

``mel-refine``: ``mel`` on this checkout alone, once for each refinement
threshold (``K.MEL_REFINE_BELOW``: 0, none refined, then 1e-7, 1e-6, 1e-5).
``mel`` and ``mel-refine`` also take speech-like rows (40 tilted harmonic
series, 35 s each plus 30 s), whose bins mostly lie below the threshold.

``mel-accuracy``: on the CPU, no card: where the FFT loses accuracy on
rows of [c]'s stack (default all 40), the kernel's arithmetic emulated
with its passes and its split each in float32 or float64, beside
``torch.fft.rfft`` in float32 and the plain DFT product, each against the
float64 FFT (see ``mel_accuracy``).

``align``: the alignment kernels of the checkout at each DIR, in turns
(``align build/parent . . build/parent``): ``align_cost`` and the DTW at
``chip_smoke.py`` [c]'s S=8 shape (the DTW with its walk; a tree
without the walk, its codes then the Python backtrace), ``attention_to_cost`` at the 120-head segment, ``dtw_path``'s
whole call and the whole batched aligner at (g)'s flush shape (host
clock). ``align-launches``: each CUDA launch of those kernels alone
(torch.profiler's device time by kernel). ``align-variants`` and
``dtw-variants``: the cost kernel's and the DTW kernel's sources with one
design choice changed or one part of the work removed at a time
(``ALIGN_VARIANTS``, ``DTW_VARIANTS``), each timed as ``align`` times the
tree.

``flash-bwd``: the training backward's two kernels (``_flash_bwd_dq``,
``_flash_bwd_dkv``) of the checkout at each DIR, in turns (``flash-bwd
build/parent . . build/parent``), at the encoder's shape (B=2, T=1500,
D=1280, H=20) in f32 and bf16, beside SDPA's backward alone (dq, dk, dv),
with each gradient's error against the plain backward and the kernels'
ptxas registers. ``flash-bwd-variants``: ``csrc/flash_attn_bwd.cu`` with one
design choice changed or one part of the work removed at a time
(``FLASH_BWD_VARIANTS``: no exp2, no column-tile loads, no f32 split
copies, no S and dP products, no register-A products, the products
alone), each timed as ``flash-bwd`` times a tree.
``ncu`` does not run on the card's machine: these say what holds the
design back.

``flash-fwd``: the training forward (``flash_attention_fwd``: bf16 through
``flash_attention``'s kernel with its lse, f32 through the split pass and
the 3xTF32 kernel) of the checkout at each DIR, in turns (``flash-fwd
build/parent . . build/parent``), at the encoder's shape (B=2, T=1500,
D=1280, H=20) in f32 and bf16 beside SDPA's forward, with out's and lse's
errors against the plain version and the forward kernels' ptxas registers;
then ``flash_attention`` (inference, bf16) at ``chip_smoke.py`` [c]'s four
shapes (the encoder at B=1 and 8, the 232-slot prefill's self and cross
attention at B=8), which the bf16 forward's lse output must not slow. ``flash-fwd-variants``:
``csrc/flash_attn_fwd_lse.cu`` with one design choice changed or one part
of the work removed at a time (``FLASH_FWD_VARIANTS``: 32-key tiles; no
exp2; no K or V loads),
each timed as ``flash-fwd`` times a tree.

``median9``: ``median9`` of the checkout at each DIR, in turns, on the
120-head segment's (26880, 1536) f32 scores, beside its bytes bound, and
whether it equals the plain version.

``flash-bwd-accuracy``: on the CPU, no card: the backward kernels'
arithmetic emulated at B=1, H=2 and each T (default 200 and 1500) in the
kernels' order of products and k-steps, with each k-step's sum rounded to
f32 to nearest or toward zero (what the tensor cores do), beside the plain
version, each gradient's error over its max abs against a float64
backward and against the plain version (see ``flash_bwd_accuracy``).

``flash``: ``csrc/flash_attn.cu`` as it is and with one design choice
changed at a time (each variant a text edit of the source, built into its
own directory under ``build/kernel_sweeps/``): the encoder shape at B=1 and
B=8 and its error against the plain version. Variants whose edit removes
work (no exp2, no softmax) give wrong outputs on purpose: they time what
is left. Times are CUDA-event means over back-to-back launches queued
behind a device sleep, as ``chip_smoke.py`` takes them. Prints the card's
name and power limit first. Imports nothing of JAX.
"""

import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(HERE, "whisper_timestamped_tpu_torch")
SRC = os.path.join("csrc", "flash_attn.cu")
HOPPER = os.path.join("csrc", "hopper.cuh")  # ex2 lives here, for every flash kernel
EX2 = 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));'
MASK = "    if (causal || k0 + kBN > Sk) {"
# name -> (what it changes, [(source, old text, new text), ...])
FLASH_VARIANTS = {
    "as built": ("the source as it is", []),
    "3 stages": ("a three-stage K/V ring", [(SRC, "constexpr int kStages = 2;",
                                             "constexpr int kStages = 3;")]),
    "no exp2": ("exp2 replaced by a multiply (wrong output)", [(HOPPER, EX2, "y = x * 0.5f;")]),
    "no softmax": ("no mask, max or exp2: P = bf16(S) (wrong output)",
                   [(SRC, MASK, "    al0 = al1 = 1.f;\n    return;\n" + MASK)]),
}
BWD = os.path.join("csrc", "flash_attn_bwd.cu")
BWD_LOADS = ("        mbar_expect_tx(&sm.full[st], 2 * kBN * kHead * sizeof(T));\n"
             "        tma_load(sm.b1[st], &tb1, &sm.full[st], h * kHead, c0, b);\n"
             "        tma_load(sm.b2[st], &tb2, &sm.full[st], h * kHead, c0, b);\n")
# each edit puts ``if (<a loop index> < 0)`` before a call: the call is gone
BWD_NO_LOADS = [(BWD, BWD_LOADS, "        mbar_arrive(&sm.full[st]);\n")]
BWD_NO_EXP2 = [(HOPPER, EX2, "y = x * 0.5f;")]
BWD_NO_SPLIT = [(BWD, f"{call}(s.{dst}", f"if (st < 0) {call}(s.{dst}")
                for call, dst in (("split_rows<kBN>", "b1hi"), ("split_rows<kBN>", "b2hi"),
                                  ("split_cols", "b1thi"), ("split_cols", "b2thi"))]
BWD_NO_XY = ([(BWD, f"wgmma_ss({acc},", f"if (kk < 0) wgmma_ss({acc},") for acc in ("x", "y")]
             + [(BWD, f"issue_ss3<kBN>({acc},", f"if (wg < 0) issue_ss3<kBN>({acc},")
                for acc in ("x", "y")])
BWD_NO_RS = [(BWD, "wgmma_rs(acc,", "if (kk < 0) wgmma_rs(acc,"),
             (BWD, "issue_rs3<kBN>(acc,", "if (thi == nullptr) issue_rs3<kBN>(acc,")]
# name -> (what it changes, [(source, old text, new text), ...]); each
# variant removes work to time what is left (wrong outputs on purpose)
FLASH_BWD_VARIANTS = {
    "as built": ("the source as it is", []),
    "no exp2": ("exp2 replaced by a multiply", BWD_NO_EXP2),
    "no loads": ("no column-tile loads: the producer only arrives", BWD_NO_LOADS),
    "no split": ("f32: no split copies of the column tiles", BWD_NO_SPLIT),
    "no X/Y": ("no S or dP products (X, Y)", BWD_NO_XY),
    "no register-A products": ("no dV, dK or dQ products", BWD_NO_RS),
    "products alone": ("no loads, no exp2, no split copies",
                       BWD_NO_LOADS + BWD_NO_EXP2 + BWD_NO_SPLIT),
}
FWD = os.path.join("csrc", "flash_attn_fwd_lse.cu")
FWD_NO_LOADS = [(FWD, "mbar_expect_tx(&sm.k_full[st], kTileBytes);", "mbar_arrive(&sm.k_full[st]);"),
                (FWD, "mbar_expect_tx(&sm.v_full[st], kTileBytes);", "mbar_arrive(&sm.v_full[st]);"),
                (FWD, "        tma_load(sl.", "        if (half < 0) tma_load(sl.")]
# name -> (what it changes, [(source, old text, new text), ...]); the f32
# forward's design choices, then work removed to time what is left (wrong
# outputs on purpose)
FLASH_FWD_VARIANTS = {
    "as built": ("the source as it is", []),
    "32-key tiles": ("f32: tiles of 32 keys in a three-stage ring",
                     [(FWD, "constexpr int kBN = 64;", "constexpr int kBN = 32;"),
                      (FWD, "constexpr int kStages = 2;", "constexpr int kStages = 3;")]),
    "no exp2": ("exp2 replaced by a multiply", [(HOPPER, EX2, "y = x * 0.5f;")]),
    "no loads": ("f32: no K or V tile loads, the producer only arrives", FWD_NO_LOADS),
}
PIPE = os.path.join("csrc", "decode_attn.cuh")
STAGES = "constexpr int kStages = 2;"
SCORES = "    // scores of the warp's rows: kL lanes a row, kGroups rows a read"
MERGE = "  // the splits of (b, h) are one cluster: rank 0 merges their (m, l, o)"
PAD = "  const int lo = max(first, max(0, min(pad_len[b], pos)));"
# name -> (what it changes, [(source, old text, new text), ...]); the last
# three remove work to time what is left (wrong outputs on purpose)
PIPELINE_VARIANTS = {
    **{f"{n} stages": (f"a {n}-stage ring in the pipeline's five kernels",
                       [(PIPE, STAGES, STAGES.replace("2", str(n)))]) for n in (3, 4)},
    **{f"int4 {n} blocks": (f"xattn_decode_int4 built for {n} blocks of 4 warps an SM "
                            f"({65536 // (128 * n) // 8 * 8} registers)",
                            [(os.path.join("csrc", "xattn_decode_int4.cu"),
                              "__launch_bounds__(32 * kWarps)",
                              f"__launch_bounds__(32 * kWarps, {4 * n} / kWarps)")])
       for n in (7, 8)},
    "no pad read": ("the self kernels' live range not waiting for pad_len (wrong output)",
                    [(os.path.join("csrc", f), PAD, "  const int lo = first;")
                     for f in ("self_attn_decode.cu", "self_attn_decode_int8.cu")]),
    "no split merge": ("the splits' partials not merged (wrong output)",
                       [(PIPE, MERGE, "  return;\n" + MERGE)]),
    "no compute": ("the ring alone: no scores, softmax or p·V (wrong output)",
                   [(PIPE, SCORES, "    __syncwarp();\n    issue(i + kStages);\n    continue;\n"
                     + SCORES)]),
}
MM = os.path.join("csrc", "stacked_matmul.cu")
MM_RING = "  const int n = 65536 / (kWBytes + kCols * kTileK * 2);"
MM_PUSH = "    for (int h = 0; h < 2; ++h) {\n      const int n = warp * 16 + (lane >> 2) + 8 * h;"
MM_SUM = "  // this rank's rows of the live columns, each summed over the splits in"
MM_ENTRY = "  extern __shared__ uint8_t smem_raw[];"
MM_MMA = "      for (int kk = 0; kk < kTileK / 16; ++kk) wgmma_ss(acc, dw + 2 * kk, dx + 2 * kk, 1);"
# name -> (what it changes, [(source, old text, new text), ...]); the last
# four remove work to time what is left (wrong outputs on purpose)
MATMUL_VARIANTS = {
    "as built": ("the source as it is", []),
    **{f"{kb} KB rings": (f"rings of about {kb} KB a block",
                         [(MM, MM_RING, MM_RING.replace("65536", str(kb * 1024)))])
       for kb in (128,)},
    "no push": ("no sums sent to the owning ranks (wrong output)",
                [(MM, MM_PUSH, MM_PUSH.replace("h < 2", "h < 0"))]),
    "no sum": ("no sums over the splits, no output stores (wrong output)",
               [(MM, MM_SUM, "  return;\n" + MM_SUM)]),
    "no mma": ("the ring alone: no wgmma (wrong output)", [(MM, MM_MMA, "")]),
    "no work": ("the launch alone: every block returns at once (wrong output)",
                [(MM, MM_ENTRY, "  return;\n" + MM_ENTRY)]),
}
MEL = os.path.join("csrc", "log10_mel.cu")
MEL_LOAD = "        cp_async4(buf + i, src + i);"
MEL_PASS = "      switch (R) {"
MEL_FRAME = "      case 5: first_pass<5>(sbuf, win2, z, N, fs, hop, tid); s0 = 1; break;"
MEL_POST = "    for (int k = warp; k <= N / 2; k += kMelWarps) {"
MEL_PROJ = "      for (; k + 3 <= r.y; k += 4) {"
# name -> (what it changes, [(source, old text, new text), ...]); the
# variants from "no load" on remove work to time what is left (wrong
# outputs on purpose)
MEL_VARIANTS = {
    "as built": ("the source as it is", []),
    "radix 8 first": ("the passes 8, 5, 5 at n_fft = 400 (the plan's radix 8 first: a framing copy)",
                      [(os.path.join("ops", "kernels.py"), "MEL_RADICES = (5, 3, 8, 4, 2)",
                        "MEL_RADICES = (8, 4, 2, 5, 3)")]),
    "8 warps": ("blocks of 8 warps (256 threads)",
                [(MEL, "constexpr int kMelThreads = 512;", "constexpr int kMelThreads = 256;")]),
    "one block an SM": ("a grid of one block an SM",
                        [(MEL, "std::max(per_sm, 1) * n_sm", "n_sm")]),
    "no load": ("no samples loaded (wrong output)", [(MEL, MEL_LOAD, "")]),
    "no barriers": ("no barriers inside the tile loop (wrong output)",
                    [(MEL, "    __syncthreads();", "")]),
    "no first pass": ("no framing, window or first pass (wrong output)",
                      [(MEL, MEL_FRAME, "      case 5: s0 = 1; break;")]),
    "no split": ("no split into the real signal's bins (wrong output)",
                 [(MEL, MEL_POST, "    if (N < 0)\n" + MEL_POST)]),
    "no passes": ("no FFT passes (wrong output)", [(MEL, MEL_PASS, "      if (R < 0) switch (R) {")]),
    "no mel": ("no mel sums (wrong output)", [(MEL, MEL_PROJ, "      r.y = -1;\n" + MEL_PROJ)]),
}
MEL_NREF = "    const int n_ref = n_refine, span4"
MEL_SCAN = "    if (live) {\n      const float at"
# name -> (what it changes, [(source, old text, new text), ...]): the
# refinement's parts removed one after another, to time what each costs
# (wrong outputs wherever a bin needs refining)
MEL_REFINE_VARIANTS = {
    "as built": ("the source as it is", []),
    "no refinement": ("neither refinement path (the scan still runs)",
                      [(MEL, MEL_NREF, MEL_NREF.replace("n_refine,", "0 * n_refine,"))]),
    "no scan": ("no refinement and no scan (the peaks still taken)",
                [(MEL, MEL_NREF, MEL_NREF.replace("n_refine,", "0 * n_refine,")),
                 (MEL, MEL_SCAN, MEL_SCAN.replace("live", "false"))]),
    "no peaks": ("no refinement, scan or peaks: the FFT alone",
                 [(MEL, MEL_NREF, MEL_NREF.replace("n_refine,", "0 * n_refine,")),
                  (MEL, MEL_SCAN, MEL_SCAN.replace("live", "false")),
                  (MEL, "    atomicMax(peak + lane, top);", "")]),
}
PIPELINE_SETTINGS = ()  # grid settings to time each variant at; none: the tree's own rule

# the decode-attention pipeline's grid settings timed by ``xattn``: warps a
# block, then the warps a multiprocessor the split rule aims at (0: no split)
XATTN_SETTINGS = ("4:12", "2:12", "4:24", "2:24", "4:0", "2:0")

TIMER = r'''
import sys, torch
sys.path.insert(0, sys.argv[1])
from whisper_timestamped_tpu_torch.ops import kernels as K, _build
_build.library()
g = torch.Generator(device="cuda").manual_seed(0)
def randn(*s): return torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
def timed(fn, iters=10):
    for _ in range(3): fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000); e0.record()
    for _ in range(iters): fn()
    e1.record(); torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters
out = []
for B in (1, 8):
    q, k, v = randn(B, 1500, 1280), randn(B, 1500, 1280), randn(B, 1500, 1280)
    o = K.flash_attention(q, k, v, 20); torch.cuda.synchronize()
    err = (o.float() - K.flash_attention_plain(q, k, v, 20).float()).abs().max().item()
    out.append(f"B={B} {timed(lambda: K.flash_attention(q, k, v, 20)):.4f} ms (err {err:.3g})")
print(" | ".join(out))
'''

# ``flash-bwd``: the training backward's kernels at the encoder's shape
FLASH_BWD_TIMER = r'''
import sys, torch
sys.path.insert(0, sys.argv[1])
from whisper_timestamped_tpu_torch.ops import kernels as K, _build
_build.library()
entry, spill = None, ""
for ln in (_build.build_dir() / "build.log").read_text().splitlines():
    if "Compiling entry function" in ln:
        entry = ln.split("'")[1]
    elif "spill" in ln and entry and "flash_bwd" in entry:
        spill = ln.strip()
    elif "Used" in ln and "registers" in ln and entry:
        if "flash_bwd" in entry:
            print(f"ptxas {entry[entry.find('flash_bwd'):][:40]}: {ln.split(':', 1)[1].strip()}; "
                  f"{spill}")
        entry = None
g = torch.Generator(device="cuda").manual_seed(14)
B, T, D, H = 2, 1500, 1280, 20
def timed(fn, iters=20):
    for _ in range(3): fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000); e0.record()
    for _ in range(iters): fn()
    e1.record(); torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters
def heads(x): return x.view(B, T, H, 64).transpose(1, 2)
for dtype in (torch.float32, torch.bfloat16):
    q, k, v, dout = (torch.randn((B, T, D), generator=g, device="cuda").to(dtype) for _ in range(4))
    out, lse = K.flash_attention_fwd_plain(q, k, v, H)
    dq, delta = K._flash_bwd_dq(q, k, v, out, dout, lse, H)
    dk, dv = K._flash_bwd_dkv(q, k, v, dout, lse, delta, H)
    want = K.flash_attention_bwd_plain(q, k, v, out, lse, dout, H)
    err = max(((a.float() - w.float()).abs().max() / w.float().abs().max()).item()
              for a, w in zip((dq, dk, dv), want))
    ms_dq = timed(lambda: K._flash_bwd_dq(q, k, v, out, dout, lse, H))
    ms_dkv = timed(lambda: K._flash_bwd_dkv(q, k, v, dout, lse, delta, H))
    qh, kh, vh = (heads(x).detach().requires_grad_() for x in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh)
    lib = timed(lambda: torch.autograd.grad(o, (qh, kh, vh), heads(dout), retain_graph=True))
    print(f"{str(dtype)[6:]} B={B} T={T}: dq {ms_dq:.4f} ms, dkv {ms_dkv:.4f} ms, together "
          f"{ms_dq + ms_dkv:.4f} ms; sdpa backward {lib:.4f} ms; err {err:.3g} of a gradient's "
          f"max", flush=True)
    del q, k, v, dout, out, lse, dq, dk, dv, delta, want, qh, kh, vh, o
    torch.cuda.empty_cache()
'''

# ``flash-fwd``: the training forward at the encoder's shape, and the
# inference kernel it shares (bf16) at B=8
FLASH_FWD_TIMER = r'''
import sys, torch
sys.path.insert(0, sys.argv[1])
from whisper_timestamped_tpu_torch.ops import kernels as K, _build
_build.library()
entry, spill = None, ""
for ln in (_build.build_dir() / "build.log").read_text().splitlines():
    if "Compiling entry function" in ln:
        entry = ln.split("'")[1]
    elif "spill" in ln and entry:
        spill = ln.strip()
    elif "Used" in ln and "registers" in ln and entry:
        if "flash_fwd" in entry or "flash_attention_kernel" in entry or "split_kv" in entry:
            print(f"ptxas {entry[:90]}: {ln.split(':', 1)[1].strip()}; {spill}")
        entry, spill = None, ""
g = torch.Generator(device="cuda").manual_seed(15)
T, D, H = 1500, 1280, 20
sdpa = torch.nn.functional.scaled_dot_product_attention
def timed(fn, iters=20):
    for _ in range(3): fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000); e0.record()
    for _ in range(iters): fn()
    e1.record(); torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters
def heads(x): return x.view(x.shape[0], T, H, 64).transpose(1, 2)
for dtype in (torch.float32, torch.bfloat16):
    q, k, v = (torch.randn((2, T, D), generator=g, device="cuda").to(dtype) for _ in range(3))
    out, lse = K.flash_attention_fwd(q, k, v, H)
    out_p, lse_p = K.flash_attention_fwd_plain(q, k, v, H)
    err = ((out.float() - out_p.float()).abs().max() / out_p.float().abs().max()).item()
    lerr = ((lse - lse_p).abs().max() / lse_p.abs().max()).item()
    ms = timed(lambda: K.flash_attention_fwd(q, k, v, H))
    lib = timed(lambda: sdpa(heads(q), heads(k), heads(v)))
    print(f"flash_attention_fwd {str(dtype)[6:]} B=2 T={T}: {ms:.4f} ms; sdpa forward {lib:.4f} ms; "
          f"err out {err:.3g}, lse {lerr:.3g} of their max", flush=True)
    del q, k, v, out, lse, out_p, lse_p
# the inference kernel at chip_smoke.py [c]'s four shapes (its prefill pads)
pads = torch.tensor([0, 5, 63, 64, 100, 224, 231, 232], dtype=torch.int32, device="cuda")
for label, Bf, Sq, Sk, causal in (("encoder B=1", 1, T, T, False), ("encoder B=8", 8, T, T, False),
                                  ("prefill self B=8", 8, 232, 232, True),
                                  ("prefill cross B=8", 8, 232, T, False)):
    q = torch.randn((Bf, Sq, D), generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((Bf, Sk, D), generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
    pad = pads if causal else None
    ms = timed(lambda: K.flash_attention(q, k, v, H, causal=causal, pad_len=pad))
    print(f"flash_attention (inference) {label} (Sq={Sq} Sk={Sk}): {ms:.4f} ms", flush=True)
'''

# ``median9``: the 120-head segment's (26880, 1536) scores
MEDIAN_TIMER = r'''
import sys, torch
sys.path.insert(0, sys.argv[1])
from whisper_timestamped_tpu_torch.ops import kernels as K, _build
_build.library()
g = torch.Generator(device="cuda").manual_seed(4)
def timed(fn, iters=20):
    for _ in range(3): fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000); e0.record()
    for _ in range(iters): fn()
    e1.record(); torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters
x = torch.randn((26880, 1536), generator=g, device="cuda") * 3.0
equal = torch.equal(K.median9(x), K.median9_plain(x))
ms = timed(lambda: K.median9(x))
bound = 2 * x.numel() * 4 / 3.35e12 * 1e3
print(f"median9 (26880, 1536): {ms:.4f} ms, bound {bound:.4f} ms (bytes; {100 * bound / ms:.1f} % of "
      f"it), equal to the plain version: {equal}", flush=True)
'''


def timed(torch, fn, iters=20):
    for it in range(3):
        fn(it)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    e0.record()
    for it in range(iters):
        fn(it)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


DECODE_TIMER = r'''
import inspect, sys, time, torch
sys.path.insert(0, sys.argv[1])
from whisper_timestamped_tpu_torch.ops import kernels as K, _build
from whisper_timestamped_tpu_torch.ops.quant import quantize_rows, quantize_rows_int4
_build.library()
entry = None
for ln in (_build.build_dir() / "build.log").read_text().splitlines():
    if "Compiling entry function" in ln:
        entry = ln.split("'")[1]
    elif "Used" in ln and "registers" in ln and entry:
        for name in ("self_attn_decode_kernel", "xattn_decode_kernel", "xattn_decode_int8_kernel",
                     "xattn_decode_int4_kernel", "self_attn_decode_int8_kernel"):
            if name in entry:
                print(f"ptxas {name}: {ln.split(':', 1)[1].strip()}")
        entry = None
sdpa = torch.nn.functional.scaled_dot_product_attention
g = torch.Generator(device="cuda").manual_seed(0)
L, T, ctx, D, H = 32, 1500, 456, 1280, 20
def randn(*s): return torch.randn(s, generator=g, device="cuda")
def heads(x): return x.view(x.shape[0], x.shape[1], H, 64).transpose(1, 2)
HOST = {}  # the host's microseconds a call in the last timing, by label
def timed(fn, iters=20, label=None):
    for it in range(3): fn(it)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000); e0.record()
    t0 = time.perf_counter()
    for it in range(iters): fn(it)
    if label:
        HOST[label] = (time.perf_counter() - t0) * 1e6 / iters
    e1.record(); torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters
def settings():
    # the grid settings "warps a block:warps an SM" given after the tree, or the tree's own rule
    for arg in sys.argv[2:] or [None]:
        if arg:
            warps, per_sm = map(int, arg.split(":"))
            K.PIPELINE_WARPS, K.XATTN_WARPS_PER_SM = warps, per_sm
        yield f"[{warps} warps a block, {per_sm} an SM] " if arg else ""
fused = "k_new" in inspect.signature(K.self_attn_decode).parameters
for B in (1, 8, 40):
    q = randn(B, 1, D).bfloat16()
    xk, xv = randn(L, B, T, D).bfloat16(), randn(L, B, T, D).bfloat16()
    lib = timed(lambda it: sdpa(heads(q), heads(xk[it % L]), heads(xv[it % L])))
    bf = {tag: [timed(lambda it: K.xattn_decode(q, xk, xv, it % L, H, emit_scores=e),
                      label=tag + "bf16" if not e else None)
                for e in (False, True)] for tag in settings()}
    del xk, xv
    def stacked(fn):  # (codes K, scales K, codes V, scales V), one layer quantized at a time
        codes = [fn(randn(B, T, D)) for _ in range(2 * L)]
        return (torch.stack([c for c, _ in codes[:L]]), torch.stack([s for _, s in codes[:L]]),
                torch.stack([c for c, _ in codes[L:]]), torch.stack([s for _, s in codes[L:]]))
    kv8, kv4 = stacked(quantize_rows), stacked(quantize_rows_int4)
    for tag in settings():
        i8 = [timed(lambda it: K.xattn_decode_int8(q, *kv8, it % L, H, emit_scores=e),
                    label="int8" if not e else None) for e in (False, True)]
        i4 = [timed(lambda it: K.xattn_decode_int4(q, *kv4, it % L, H, emit_scores=e),
                    label="int4" if not e else None) for e in (False, True)]
        print(f"{tag}xattn B={B}: bf16 {bf[tag][0]:.4f} / {bf[tag][1]:.4f} ms (no scores / scores), "
              f"sdpa {lib:.4f}; int8 {i8[0]:.4f} / {i8[1]:.4f} ms; int4 {i4[0]:.4f} / {i4[1]:.4f} "
              f"ms; host {HOST[tag + 'bf16']:.1f} / {HOST['int8']:.1f} / {HOST['int4']:.1f} us a "
              f"call (bf16 / int8 / int4, no scores)", flush=True)
    del kv8, kv4
    k_new, v_new = randn(B, 1, D).bfloat16(), randn(B, 1, D).bfloat16()
    k_all, v_all = randn(L, B, ctx, D).bfloat16(), randn(L, B, ctx, D).bfloat16()
    pad = torch.zeros((B,), dtype=torch.int32, device="cuda")
    cache8 = (*quantize_rows(k_all.float()), *quantize_rows(v_all.float()))
    for pos in (232, 455):
        lib = timed(lambda it: sdpa(heads(q), heads(k_all[it % L, :, :pos + 1]),
                                    heads(v_all[it % L, :, :pos + 1])))
        def step(it):
            if fused:
                return K.self_attn_decode(q, k_all, v_all, it % L, pos, pad, H, k_new=k_new, v_new=v_new)
            k_all[it % L, :, pos] = k_new[:, 0]
            v_all[it % L, :, pos] = v_new[:, 0]
            return K.self_attn_decode(q, k_all, v_all, it % L, pos, pad, H)
        for tag in settings():
            alone = timed(lambda it: K.self_attn_decode(q, k_all, v_all, it % L, pos, pad, H))
            written = timed(step, label="self")
            int8 = timed(lambda it: K.self_attn_decode_int8(q, k_new, v_new, *cache8, it % L, pos,
                                                            pad, H), label="self8")
            print(f"{tag}self B={B} pos={pos}: {alone:.4f} ms alone, {written:.4f} ms with the row "
                  f"write ({'fused' if fused else 'two copies + launch'}), sdpa {lib:.4f}; int8 "
                  f"with its quantized write {int8:.4f} ms; host {HOST['self']:.1f} / "
                  f"{HOST['self8']:.1f} us a call with the write (bf16 / int8)", flush=True)
    del k_all, v_all, cache8
    torch.cuda.empty_cache()
'''


STEP_TIMER = r'''
import sys, time, torch
sys.path.insert(0, sys.argv[1])
from whisper_timestamped_tpu_torch.models import WhisperDims, init_params
from whisper_timestamped_tpu_torch.models import whisper_torch as wt
from whisper_timestamped_tpu_torch.ops import _build
_build.library()
dims = WhisperDims(n_mels=128, n_audio_ctx=1500, n_audio_state=1280, n_audio_head=20,
                   n_audio_layer=32, n_vocab=51866, n_text_ctx=448, n_text_state=1280,
                   n_text_head=20, n_text_layer=32)
module = init_params(dims, seed=0, dtype=torch.bfloat16, device="cuda")
g = torch.Generator(device="cuda").manual_seed(0)
heads = [(l, h) for l in range(24, 32) for h in (0, 7)][:10]
with torch.no_grad():
    for B in (1, 8, 40):
        xa = wt.encode(module, torch.randn((B, 128, 3000), generator=g, device="cuda"))
        for cross in (False, "int8"):
            cache = wt.init_cache(module, xa, ctx_len=448, quantize_cross=cross)
            tok = torch.randint(0, 50000, (B, 1), generator=g, device="cuda")
            pad = torch.full((B,), 200, dtype=torch.int32, device="cuda")
            for pos in range(232, 240):  # warm-up
                wt.decode_step(module, tok, cache, pos, pos_offset=pad, kv_valid_from=pad,
                               align_heads=heads)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for pos in range(240, 304):  # a sync a step, as the token loop makes
                logits, _ = wt.decode_step(module, tok, cache, pos, pos_offset=pad,
                                           kv_valid_from=pad, align_heads=heads)
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / 64
            print(f"decode_step B={B} {'int8' if cross else 'bf16'} cross K/V: {ms:.3f} ms a step "
                  f"(host clock, 64 steps from slot 240, 10 alignment heads)", flush=True)
            del cache
        del xa
        torch.cuda.empty_cache()
'''


MATMUL_TIMER = r'''
import sys, torch
sys.path.insert(0, sys.argv[1])
from whisper_timestamped_tpu_torch.ops import kernels as K, _build
_build.library()
entry = None
for ln in (_build.build_dir() / "build.log").read_text().splitlines():
    if "Compiling entry function" in ln:
        entry = ln.split("'")[1]
    elif "Used" in ln and "registers" in ln and entry:
        if "stacked_matmul" in entry:
            print(f"ptxas {entry}: {ln.split(':', 1)[1].strip()}")
        entry = None
g = torch.Generator(device="cuda").manual_seed(3)
n_sm = torch.cuda.get_device_properties(0).multi_processor_count
def timed(fn, iters=50):
    for it in range(3): fn(it)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000); e0.record()
    for it in range(iters): fn(it)
    e1.record(); torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters
L = 32
for k_in, n_out in ((1280, 5120), (5120, 1280), (1280, 1280)):
    w = (torch.randn((L, n_out, k_in), generator=g, device="cuda") * k_in**-0.5).bfloat16()
    for B in (1, 8, 40):
        x = torch.randn((B, k_in), generator=g, device="cuda").bfloat16()
        o = K.stacked_matmul(x, w, 5).float()
        ref = K.stacked_matmul_plain(x, w, 5).float()
        err = ((o - ref).abs().max() / ref.abs().max()).item()
        ms = timed(lambda it: K.stacked_matmul(x, w, it % L))
        lib = timed(lambda it: torch.nn.functional.linear(x, w[it % L]))
        bound = 2 * (n_out * k_in + B * k_in + B * n_out) / 3.35e12 * 1e3
        grid = (f"grid {K.matmul_split(B, n_out, k_in, n_sm)} (n_split, cols, groups)"
                if hasattr(K, "matmul_split") else "")
        print(f"stacked_matmul B={B:2d} K={k_in} N={n_out}: {ms:.4f} ms, F.linear "
              f"{lib:.4f} ms, bound {bound:.4f} ms ({100 * bound / ms:.1f}% of it), err "
              f"{err:.3g} of the output scale; {grid}", flush=True)
    del w
    torch.cuda.empty_cache()
'''

# ``matmul-splits``: the matmul timer's shapes at every split count (the
# rule's own choice marked), the grid otherwise as ``matmul_split`` gives it
MATMUL_SPLITS_TIMER = r'''
import sys, torch
sys.path.insert(0, sys.argv[1])
from whisper_timestamped_tpu_torch.ops import kernels as K, _build
_build.library()
g = torch.Generator(device="cuda").manual_seed(3)
n_sm = torch.cuda.get_device_properties(0).multi_processor_count
def timed(fn, iters=50):
    for it in range(3): fn(it)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000); e0.record()
    for it in range(iters): fn(it)
    e1.record(); torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters
rule, L = K.matmul_split, 32
for k_in, n_out in ((1280, 5120), (5120, 1280), (1280, 1280)):
    w = (torch.randn((L, n_out, k_in), generator=g, device="cuda") * k_in**-0.5).bfloat16()
    for B in (1, 8, 40):
        x = torch.randn((B, k_in), generator=g, device="cuda").bfloat16()
        lib = timed(lambda it: torch.nn.functional.linear(x, w[it % L]))
        row = []
        for s in range(1, 1 + min(K.MATMUL_MAX_SPLITS, -(-k_in // K.MATMUL_TILE))):
            K.matmul_split = lambda *a, s=s: (s, *rule(*a)[1:])
            row.append(f"{s}: {timed(lambda it: K.stacked_matmul(x, w, it % L)):.4f}")
        K.matmul_split = rule
        print(f"B={B:2d} K={k_in} N={n_out} (rule: {rule(B, n_out, k_in, n_sm)[0]} splits; "
              f"F.linear {lib:.4f} ms) ms by splits: " + ", ".join(row), flush=True)
    del w
    torch.cuda.empty_cache()
'''

MEL_TIMER = r'''
import importlib.util, sys, torch
sys.path.insert(0, sys.argv[1])
import numpy as np
# this checkout's chip_smoke.py (its inputs, witness and library yardstick), whatever the tree timed
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[2])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
make_audio, mel_library, mel_witness = smoke.make_audio, smoke.mel_library, smoke.mel_witness
from whisper_timestamped_tpu_torch.ops import kernels as K, _build
from whisper_timestamped_tpu_torch.audio import (HOP_LENGTH, N_FFT, N_SAMPLES,
                                                 _front_end_constants, _padded_audio)
_build.library()
if _build.BUILD_INFO.get("built"):  # the kernel's registers and spills, from ptxas
    import os
    log = open(os.path.join(os.path.dirname(_build.BUILD_INFO["path"]), "build.log")).read()
    ptxas = log[log.index("log10_mel.cu"):].split("Compile time")[0].splitlines()
    print("ptxas log10_mel: " + "; ".join(ln.strip() for ln in ptxas
                                          if "spill" in ln or "registers" in ln))
def timed(fn, iters=10):
    for it in range(2): fn(it)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000); e0.record()
    for it in range(iters): fn(it)
    e1.record(); torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters
cos_b, sin_b, mel_w = _front_end_constants(128, N_FFT, torch.device("cuda"))
# chip_smoke.py [c]'s inputs: (g)'s first stack and a 10-minute stream
rng = np.random.default_rng(40)
secs = rng.integers(5, 36, 40)
secs[::8] = 35
stack = np.zeros((40, 35 * 16000), np.float32)
for j, sec in enumerate(secs):
    stack[j, : int(sec) * 16000] = make_audio(1000 + j, int(sec))
# speech-like rows: 100-180 Hz harmonic series falling 1.5 decades of
# power a harmonic, plus 1e-6 noise (most bins many decades below the
# frame's peak: the kernel's dense refinement)
t = np.arange(35 * 16000) / 16000.0
tilted = np.zeros((40, t.size))
for r in range(40):
    f0 = 100.0 + 2.0 * r
    for h in range(1, int(7900 // f0) + 1):
        tilted[r] += 0.3 * 10.0 ** (-0.75 * (h - 1)) * np.sin(2 * np.pi * f0 * h * t + h)
tilted = (tilted + 1e-6 * np.random.default_rng(41).standard_normal(tilted.shape)).astype(np.float32)
# with thresholds after the checkout and chip_smoke.py: each in turn as
# K.MEL_REFINE_BELOW, the kernel's refinement threshold
cases = [(label, host, refine) for refine in (sys.argv[3:] or [None])
         for label, host in (("[g] stack 40 x (35 s + 30 s)", stack),
                             ("10-minute stream + 30 s", make_audio(7, 600)[None]),
                             ("tilted harmonics 40 x (35 s + 30 s)", tilted))]
for label, host, refine in cases:
    if refine is not None:
        K.MEL_REFINE_BELOW = float(refine)
        label = f"{label}, refined below {refine} of the frame's peak"
    x = _padded_audio(torch.from_numpy(host).cuda(), N_SAMPLES, N_FFT // 2)
    raw_k = K.log10_mel(x, cos_b, sin_b, mel_w, HOP_LENGTH)
    raw_p = K.log10_mel_plain(x, cos_b, sin_b, mel_w, HOP_LENGTH)
    n_frames = raw_k.shape[-1]
    exact = mel_witness(torch, x, mel_w, n_frames)
    top = exact.amax(dim=(-2, -1), keepdim=True)
    above, loud = exact >= top - 8.0, exact >= top - 6.0
    above_p = raw_p >= raw_p.amax(dim=(-2, -1), keepdim=True) - 8.0
    err_p = (raw_k - raw_p).abs()[above_p].max().item()
    floor_p = (exact.float() - raw_p).abs()[above_p].max().item()
    wk, wp = (raw_k.double() - exact).abs(), (raw_p.double() - exact).abs()
    wl = (mel_library(torch, x, mel_w, n_frames).double() - exact).abs()
    lib_err = f"{wl[loud].max().item():.3g} / {wl[above].max().item():.3g}"
    del wl
    del raw_k, raw_p, exact
    ms = timed(lambda it: K.log10_mel(x, cos_b, sin_b, mel_w, HOP_LENGTH))
    plain = timed(lambda it: K.log10_mel_plain(x, cos_b, sin_b, mel_w, HOP_LENGTH), iters=3)
    lib = timed(lambda it: mel_library(torch, x, mel_w, n_frames))
    bound = (x.numel() + x.shape[0] * 128 * n_frames) * 4 / 3.35e12 * 1e3
    print(f"log10_mel {label} ({x.shape[0]} x {n_frames} frames): {ms:.4f} ms, plain {plain:.4f} ms, "
          f"library calls {lib:.4f} ms, bytes bound {bound:.4f} ms ({100 * bound / ms:.1f}% of it); "
          f"err vs plain {err_p:.3g} above max - 8 (the float64 witness rounded to f32 vs plain: "
          f"{floor_p:.3g}); vs float64 loud / above: kernel "
          f"{wk[loud].max().item():.3g} / {wk[above].max().item():.3g}, plain {wp[loud].max().item():.3g} / "
          f"{wp[above].max().item():.3g}, library (cuFFT in f32) {lib_err}", flush=True)
    del x, wk, wp
    torch.cuda.empty_cache()
'''


# ``align-launches``: each CUDA launch of the alignment kernels of the
# checkout at each DIR alone (torch.profiler's device time by kernel name),
# at chip_smoke.py [c]'s two cost shapes and the DTW beside them
ALIGN_LAUNCHES_TIMER = r"""
import sys, torch
sys.path.insert(0, sys.argv[1])
from whisper_timestamped_tpu_torch.ops import kernels as K, _build
_build.library()
from torch.profiler import ProfilerActivity, profile
g = torch.Generator(device="cuda").manual_seed(0)
def profiled(label, fn, iters=20):
    for _ in range(3): fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters): fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time, e.count // iters) for e in prof.key_averages()
            if e.device_time > 0 and e.count >= iters and "Memset" not in e.key
            and "Memcpy" not in e.key]
    print(f"{label}: " + "; ".join(f"{k[:48]} {t / 1e3:.4f} ms x{c}" for k, t, c in rows),
          flush=True)
S, Kh, N, M = 8, 10, 256, 1536
gen = torch.Generator().manual_seed(N)
n_tok = torch.randint(2, N + 1, (S,), generator=gen)
n_tok[0] = N
span = torch.maximum(n_tok + torch.randint(0, 1400, (S,), generator=gen), n_tok).clamp(max=1500)
span[1] = max(int(n_tok[1]), 3)
maxdur = torch.where(torch.arange(S) % 2 == 0, M, torch.clamp(span // 2, min=1))
dims = torch.stack([n_tok, span, maxdur, torch.zeros(S, dtype=torch.long)], 1).to(torch.int32).cuda()
scores = torch.randn((S, Kh, N, M), generator=g, device="cuda") * 3.0
profiled("align_cost S=8 K=10 N=256 M=1536", lambda: K.align_cost(scores, dims))
cost = K.align_cost(scores, dims)
profiled("dtw_codes S=8 N=256 M=1536", lambda: K.dtw_codes(cost, dims))
if hasattr(K, "dtw_starts"):
    profiled("dtw_starts S=8 N=256 M=1536", lambda: K.dtw_starts(cost, dims))
del scores, cost
Kh, N, span1, n1 = 120, 224, 1500, 200
scores = torch.zeros((Kh, N, M), device="cuda")
scores[:, :n1, :span1] = torch.randn((Kh, n1, span1), generator=g, device="cuda") * 3.0
profiled("attention_to_cost K=120 N=224 M=1536", lambda: K.attention_to_cost(scores, span1, n_tokens=n1))
"""


# ``align``: the alignment kernels of the checkout at each DIR, in turns
# (the parent's from ``git archive`` against this one's): align_cost and the
# DTW at chip_smoke.py [c]'s S=8 shape, attention_to_cost at its 120-head
# segment, dtw_path's whole call, and the whole batched aligner
# (``device_align._align_jumps``) at (g)'s flush shape on the host clock.
# A tree without the DTW's walk (``dtw_starts``) is timed as it ran: the
# codes, then ``_backtrace_batch``'s Python loop.
ALIGN_TIMER = r"""
import sys, time, torch
import numpy as np
sys.path.insert(0, sys.argv[1])
from whisper_timestamped_tpu_torch.ops import kernels as K, _build
from whisper_timestamped_tpu_torch import device_align as DA
_build.library()
g = torch.Generator(device="cuda").manual_seed(0)
def timed(fn, iters=10):
    for _ in range(3): fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000); e0.record()
    for _ in range(iters): fn()
    e1.record(); torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters
def host(fn, iters=5):
    out = []
    for _ in range(iters):
        torch.cuda.synchronize(); t0 = time.perf_counter(); fn(); torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return min(out)
S, Kh, N, M = 8, 10, 256, 1536
gen = torch.Generator().manual_seed(N)
n_tok = torch.randint(2, N + 1, (S,), generator=gen)
n_tok[0] = N
span = torch.maximum(n_tok + torch.randint(0, 1400, (S,), generator=gen), n_tok).clamp(max=1500)
span[1] = max(int(n_tok[1]), 3)
maxdur = torch.where(torch.arange(S) % 2 == 0, M, torch.clamp(span // 2, min=1))
dims = torch.stack([n_tok, span, maxdur, torch.zeros(S, dtype=torch.long)], 1).to(torch.int32).cuda()
scores = torch.randn((S, Kh, N, M), generator=g, device="cuda") * 3.0
cost = K.align_cost(scores, dims)
line = [f"align_cost S=8 {timed(lambda: K.align_cost(scores, dims)):.4f}"]
walk = hasattr(K, "dtw_starts")
if walk:
    line.append(f"dtw_starts S=8 {timed(lambda: K.dtw_starts(cost, dims)):.4f}")
else:
    codes = K.dtw_codes(cost, dims)
    line.append(f"dtw_codes S=8 {timed(lambda: K.dtw_codes(cost, dims)):.4f}, then the backtrace "
                f"{host(lambda: DA._backtrace_batch(codes, dims[:, 0], dims[:, 1], int((dims[:, 0] + dims[:, 1] - 1).max()))):.2f} (host)")
del scores
Kh, N, span1, n1 = 120, 224, 1500, 200
scores = torch.zeros((Kh, N, M), device="cuda")
scores[:, :n1, :span1] = torch.randn((Kh, n1, span1), generator=g, device="cuda") * 3.0
line.append(f"attention_to_cost K=120 {timed(lambda: K.attention_to_cost(scores, span1, n_tokens=n1)):.4f}")
weights = K.attention_to_cost(scores, span1, n_tokens=n1)[:n1, :span1].contiguous()
line.append(f"dtw_path whole call {host(lambda: K.dtw_path(weights)):.3f} (host)")
del scores
rng = np.random.default_rng(32)
R, Kh, T, S, N = 40 * 224, 10, 1500, 32, 256
attn = torch.randn((R, Kh, T), generator=g, device="cuda") * 3.0
n_tok = rng.integers(2, N + 1, S)
span = np.minimum(n_tok + rng.integers(0, 1400, S), 1500)
dims = np.stack([n_tok, span, np.where(np.arange(S) % 2 == 0, 1536, span // 2),
                 rng.integers(0, T - span + 1)], 1).astype(np.int32)
rows = rng.integers(0, R, (S, N))
line.append(f"aligner at (g)'s flush shape {host(lambda: DA._align_jumps(attn, rows, dims), 3):.3f} (host)")
print("ms: " + "; ".join(line), flush=True)
"""
# ``align-variants``: the alignment kernels with one design choice changed
# at a time, each timed as ``align`` times the tree; the last two remove
# work to time what is left (wrong outputs on purpose)
AC = os.path.join("csrc", "align_cost.cu")
DT = os.path.join("csrc", "dtw_codes.cu")
ALIGN_VARIANTS = {
    "as built": ("the sources as they are", []),
    "2 row warps": ("cost rows blocks of 2 warps",
                    [(AC, "constexpr int kRowWarps = 4;", "constexpr int kRowWarps = 2;")]),
    "8 row warps": ("cost rows blocks of 8 warps",
                    [(AC, "constexpr int kRowWarps = 4;", "constexpr int kRowWarps = 8;"),
                     (AC, "__launch_bounds__(32 * kRowWarps, 3)", "__launch_bounds__(32 * kRowWarps, 1)")]),
    "64-frame column tiles": ("cost column blocks of 64 frames and 4 (or 16) row groups",
                              [(AC, "constexpr int kColTile = 32;", "constexpr int kColTile = 64;"),
                               (AC, "constexpr int kColGroups = 8;", "constexpr int kColGroups = 4;"),
                               (AC, "constexpr int kMaxColGroups = 32;", "constexpr int kMaxColGroups = 16;")]),
    "accurate exp": ("expf, not __expf, in the softmax",
                     [(AC, "__expf(med[t][o] - mx)", "expf(med[t][o] - mx)")]),
    "one head group": ("the cost's rows launch with one head group at every K",
                       [(os.path.join("ops", "kernels.py"), "    return max(1, min(8, K // COST_HEADS_A_GROUP))",
                         "    return 1")]),
    "no median": ("the median replaced by the window's centre (wrong output)",
                  [(AC, "median_pair(v + o, med[t][o], med[t][o + 1]);",
                    "(med[t][o] = v[o + 4], med[t][o + 1] = v[o + 5]);")]),
}
# ``dtw-variants``: the DTW kernel with another warp count, another barrier
# spacing, or one part of its work removed (wrong outputs on purpose), one
# at a time, each timed as ``align`` times the tree
DTW_VARIANTS = {
    "as built": ("the sources as they are", []),
    **{f"{w} warps": (f"DTW blocks of {w} warps (the rule: one per 64 rows, 4 at N=256)", [
        (os.path.join("ops", "kernels.py"), "    return min(8, -(-N // DTW_ROWS_A_WARP))",
         f"    return max(-(-N // 128), {w})")]) for w in (2, 8)},
    "no packing": ("no packed code stores", [(DT, "      if (packed != nullptr)\n", "      if (false)\n")]),
    "no walk": ("no walk", [(DT, "  if (threadIdx.x < 32) walk<kShared>(sg, starts, path);", "")]),
    "no barrier": ("no barrier between the working warps", [
        (DT, "      if (step % kSync == kSync - 1 || step == steps - 1) working_warps_sync(W);", "")]),
    **{f"barriers every {n} steps": (f"the working warps {n} steps apart, meeting every {n} steps", [
        (DT, "constexpr int kSync = 8;", f"constexpr int kSync = {n};"),
        (DT, "constexpr int kMaxSmem = 227 * 1024 - 9 * 1024;",
         f"constexpr int kMaxSmem = 227 * 1024 - {max(9, 1 + 8 * 4 * n * 8 * 4 // 1024)} * 1024;")])
       for n in (4, 16)},
    "no prefetch": ("the tile's cost loaded at its step, not the step before", [
        (DT, "    load_tile<R>(sg, i0, k + 1, xn);  // the next tile, in flight during this one",
         "    load_tile<R>(sg, i0, k, x);"),
        (DT, "      x[r][0] = xn[r][0];\n      x[r][1] = xn[r][1];", "")]),
}


def mel_accuracy(rows) -> None:
    """Where ``log10_mel``'s FFT loses accuracy (on the CPU, no card): on
    rows of ``chip_smoke.py`` [c]'s stack, the kernel's arithmetic emulated
    from its plan (the passes, then the split into the real signal's bins
    and the power, then the mel sums) with the passes and the split each in
    float32 or float64, beside ``torch.fft.rfft`` in float32 and the plain
    DFT product in float32, each against the float64 FFT: the largest
    error on the cells within 6 decades of the row's loudest and on those
    above the max - 8 floor."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    from chip_smoke import make_audio
    from whisper_timestamped_tpu_torch.audio import (HOP_LENGTH, N_FFT, N_SAMPLES, _dft_bases,
                                                     _padded_audio, mel_filters)
    from whisper_timestamped_tpu_torch.ops.kernels import mel_fft_plan

    radices, tw, window = mel_fft_plan(N_FFT)
    N, mel_w = N_FFT // 2, mel_filters(128, n_fft=N_FFT).astype(np.float64)
    w64 = np.exp(-2j * np.pi * np.arange(N_FFT) / N_FFT)

    def emulated(xw, passes64, split64):
        ct = np.complex128 if passes64 else np.complex64
        W = w64 if passes64 else (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
        z, ns = (xw[:, 0::2] + 1j * xw[:, 1::2]).astype(ct), 1
        for R in radices:
            j = np.arange(N // R)
            k = j % ns
            v = np.stack([z[:, j + r * (N // R)] for r in range(R)], -1)
            v = v * W[k[:, None] * np.arange(R) * (N_FFT // (ns * R))]
            v = v @ np.exp(-2j * np.pi * np.outer(np.arange(R), np.arange(R)) / R).astype(ct).T
            z = np.empty_like(z)
            for r in range(R):
                z[:, (j - k) * R + k + r * ns] = v[..., r]
            ns *= R
        st = np.complex128 if split64 else np.complex64
        W = (w64 if split64 else (tw[:, 0] + 1j * tw[:, 1])).astype(st)
        k = np.arange(N // 2 + 1)
        a, c = z[:, k].astype(st), z[:, (N - k) % N].astype(st)
        fe, u = (a + np.conj(c)) * st(0.5), W[k] * ((a - np.conj(c)) * st(-0.5j))
        power = np.empty((len(xw), N + 1), np.float64 if split64 else np.float32)
        power[:, N - k] = (fe - u).real ** 2 + (fe - u).imag ** 2
        power[:, k] = (fe + u).real ** 2 + (fe + u).imag ** 2
        return power

    rng = np.random.default_rng(40)  # chip_smoke.py [c]'s stack
    secs = rng.integers(5, 36, 40)
    secs[::8] = 35
    cos_b, sin_b = _dft_bases(N_FFT)
    mel32 = mel_w.astype(np.float32)
    for j in rows:
        audio = np.zeros((1, 35 * 16000), np.float32)
        audio[0, : int(secs[j]) * 16000] = make_audio(1000 + j, int(secs[j]))
        x = _padded_audio(torch.from_numpy(audio), N_SAMPLES, N)[0].numpy()
        n_frames = (len(x) - N_FFT) // HOP_LENGTH
        frames = x[np.arange(n_frames)[:, None] * HOP_LENGTH + np.arange(N_FFT)[None, :]]
        spec = np.fft.rfft(frames.astype(np.float64) * (0.5 - 0.5 * np.cos(
            2 * np.pi * np.arange(N_FFT) / N_FFT)), axis=-1)
        exact = np.log10(np.maximum((spec.real**2 + spec.imag**2) @ mel_w.T, 1e-10))
        loud, above = exact >= exact.max() - 6.0, exact >= exact.max() - 8.0
        xw = frames * window
        spec32 = torch.fft.rfft(torch.from_numpy(xw)).numpy()
        re, im = frames @ cos_b, frames @ sin_b
        powers = {f"passes f{64 if p else 32}, split f{64 if q else 32}": emulated(xw, p, q)
                  for p in (False, True) for q in (False, True)}
        powers["torch.fft.rfft f32"] = (spec32.real**2 + spec32.imag**2).astype(np.float32)
        powers["plain DFT product f32"] = re * re + im * im
        out = []
        for label, power in powers.items():
            mel = power.astype(np.float64 if power.dtype == np.float64 else np.float32)
            mel = mel @ (mel_w.T if power.dtype == np.float64 else mel32.T)
            d = np.abs(np.log10(np.maximum(mel, 1e-10)) - exact)
            out.append(f"{label} {d[loud].max():.3g} / {d[above].max():.3g}")
        tone = (220.0 + 40 * (1000 + j)) % 16000
        print(f"mel-accuracy row {j} ({secs[j]} s, tone {min(tone, 16000 - tone):.0f} Hz after "
              f"aliasing), against float64, loud / above: " + "; ".join(out), flush=True)


def flash_bwd_accuracy(ts) -> None:
    """How ``csrc/flash_attn_bwd.cu``'s arithmetic rounds (on the CPU, no
    card). f32: 3xTF32, hi = x with its low 13 mantissa bits cleared, lo =
    the rest read the same way; a warpgroup's product walks the K dimension
    tile by tile (the head width's 64 for S and dP, 32 column rows for dQ,
    dK and dV) and in each tile issues hi·hi, then hi·lo, then lo·hi, one
    k-step (8 of K) a ``wgmma``: the k-step's products are exact and added
    to the f32 accumulator, rounded to nearest or toward zero (k-steps of 8,
    or of 4 if the hardware adds half a k-step at a time). bf16: P and dS
    rounded to bf16, k-steps of 16, the gradients rounded to bf16. Prints
    the largest of the three gradients' errors over their max abs against a
    float64 backward and against the plain version."""
    import torch

    sys.path.insert(0, HERE)
    from whisper_timestamped_tpu_torch.ops.kernels import (flash_attention_bwd_plain,
                                                           flash_attention_fwd_plain)

    H, log2e = 2, 1.4426950408889634
    tf32 = lambda x: (x.contiguous().view(torch.int32) & -8192).view(torch.float32)  # noqa: E731

    def nearest(s):
        return s.float().double()

    def toward_zero(s):
        f = s.float()
        return torch.where(f.double().abs() > s.abs(), torch.nextafter(f, torch.zeros_like(f)),
                           f).double()

    def mm(a, b, tile, rnd, step, split):  # a (M, K) @ b (K, N), the kernel's order
        parts = [(a, b)]
        if split:
            ah, bh = tf32(a), tf32(b)
            parts = [(ah, bh), (ah, tf32(b - bh)), (tf32(a - ah), bh)]
        acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float64)
        for t0 in range(0, a.shape[1], tile):
            for x, y in parts:
                for k0 in range(t0, min(t0 + tile, a.shape[1]), step):
                    acc = rnd(acc + x[:, k0:k0 + step].double() @ y[k0:k0 + step].double())
        return acc.float()

    def emulated(q, k, v, out, lse, dout, rnd, step):
        f32 = q.dtype == torch.float32
        rb = (lambda x: x) if f32 else (lambda x: x.bfloat16().float())  # noqa: E731
        tile = 32 if f32 else 64
        heads = lambda x: x.float().view(x.shape[0], -1, H, 64).transpose(1, 2)  # noqa: E731
        qh, kh, vh, oh, doh = (heads(x) for x in (q, k, v, out, dout))
        grads = [torch.zeros_like(qh) for _ in range(3)]
        for b in range(q.shape[0]):
            for h in range(H):
                qi, ki, vi, oi, di = (x[b, h].contiguous() for x in (qh, kh, vh, oh, doh))
                s = mm(qi, ki.T.contiguous(), 64, rnd, step, f32)
                p = torch.exp2(s * (64**-0.5 * log2e) - lse[b, h][:, None] * log2e)
                ds = p * (mm(di, vi.T.contiguous(), 64, rnd, step, f32)
                          - (di * oi).sum(-1, keepdim=True))
                p, ds = rb(p), rb(ds)
                grads[0][b, h] = mm(ds, ki, tile, rnd, step, f32) * 64**-0.5
                grads[1][b, h] = mm(ds.T.contiguous(), qi, tile, rnd, step, f32) * 64**-0.5
                grads[2][b, h] = mm(p.T.contiguous(), di, tile, rnd, step, f32)
        return [rb(g.transpose(1, 2).reshape(q.shape)) for g in grads]

    def float64(q, k, v, dout):
        qh, kh, vh, doh = (x.double().view(x.shape[0], -1, H, 64).transpose(1, 2)
                           for x in (q, k, v, dout))
        p = torch.softmax(qh @ kh.transpose(-1, -2) * 64**-0.5, dim=-1)
        ds = p * (doh @ vh.transpose(-1, -2) - (doh * (p @ vh)).sum(-1, keepdim=True))
        grads = (ds @ kh * 64**-0.5, ds.transpose(-1, -2) @ qh * 64**-0.5,
                 p.transpose(-1, -2) @ doh)
        return [g.transpose(1, 2).reshape(q.shape) for g in grads]

    def err(gots, wants):
        return max(((g.double() - w.double()).abs().max() / w.double().abs().max()).item()
                   for g, w in zip(gots, wants))

    for T in ts:
        for dtype, step in ((torch.float32, 8), (torch.bfloat16, 16)):
            g = torch.Generator().manual_seed(13)
            q, k, v, dout = (torch.randn((1, T, 64 * H), generator=g).to(dtype) for _ in range(4))
            out, lse = flash_attention_fwd_plain(q, k, v, H)
            exact = float64(q, k, v, dout)
            plain = flash_attention_bwd_plain(q, k, v, out, lse, dout, H)
            cases = {"plain version": plain}
            for name, rnd in (("nearest", nearest), ("toward zero", toward_zero)):
                for st in (step, step // 2) if dtype == torch.float32 else (step,):
                    cases[f"k-steps of {st} rounded {name}"] = emulated(q, k, v, out, lse, dout,
                                                                        rnd, st)
            print(f"flash-bwd-accuracy T={T} {'f32 (3xTF32)' if dtype == torch.float32 else 'bf16'}"
                  ", of a gradient's max abs against float64 / the plain version: " + "; ".join(
                      f"{n} {err(c, exact):.3g} / {err(c, plain):.3g}" for n, c in cases.items()),
                  flush=True)


def run_tree(timer, tree, *args):
    """The timer's output on the checkout at ``tree``, in a process of its
    own with its own build directory."""
    env = dict(os.environ, WTT_TORCH_BUILD_DIR=os.path.join(tree, "build", "wtt_torch_kernels"))
    r = subprocess.run([sys.executable, "-c", timer, tree, *args], env=env, capture_output=True,
                       text=True, timeout=900)
    return r.stdout.strip() if r.returncode == 0 else "FAILED " + r.stderr.strip()[-1500:]


def time_trees(tag, timer, trees, *args):
    for tree in trees or [HERE]:
        label = os.path.relpath(os.path.abspath(tree), HERE)
        for ln in run_tree(timer, os.path.abspath(tree), *args).splitlines():
            print(f"{tag} [{label}] {ln}", flush=True)


def sweep_variants(tag, variants, timer, *args):
    """Each variant (text edits of the package's sources) built into its own
    copy under build/kernel_sweeps/ and timed by ``timer`` (given ``args``)."""
    root = os.path.join(HERE, "build", "kernel_sweeps")
    for i, (name, (what, edits)) in enumerate(variants.items()):
        d = os.path.join(root, f"v{i}")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(PKG, os.path.join(d, "whisper_timestamped_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        for rel, old, new in edits:
            path = os.path.join(d, "whisper_timestamped_tpu_torch", rel)
            src = open(path).read()
            if old not in src:
                raise SystemExit(f"torch_kernel_sweeps: variant {name!r} no longer applies")
            with open(path, "w") as f:
                f.write(src.replace(old, new))
        for ln in run_tree(timer, d, *args).splitlines():
            print(f"{tag} [{name}] ({what}): {ln}", flush=True)
    shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    import torch

    if sys.argv[1:2] == ["mel-accuracy"]:
        mel_accuracy([int(a) for a in sys.argv[2:]] or range(40))
        return 0
    if sys.argv[1:2] == ["flash-bwd-accuracy"]:
        flash_bwd_accuracy([int(a) for a in sys.argv[2:]] or (200, 1500))
        return 0
    if not torch.cuda.is_available():
        print("torch_kernel_sweeps: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    what = sys.argv[1:] or ["xattn", "flash"]
    mode = next((m for m in ("decode", "step", "matmul", "mel", "encoder", "align-launches", "align",
                             "flash-bwd", "flash-fwd", "median9") if m in what), None)
    trees = what[what.index(mode) + 1:] if mode else []
    if "xattn" in what[:len(what) - len(trees)]:
        for ln in run_tree(DECODE_TIMER, HERE, *XATTN_SETTINGS).splitlines():
            print(f"xattn {ln}", flush=True)
    if "flash" in what[:len(what) - len(trees)]:
        sweep_variants("flash", FLASH_VARIANTS, TIMER)
    if "pipeline" in what[:len(what) - len(trees)]:
        sweep_variants("pipeline", PIPELINE_VARIANTS, DECODE_TIMER, *PIPELINE_SETTINGS)
    if "matmul-variants" in what[:len(what) - len(trees)]:
        sweep_variants("matmul", MATMUL_VARIANTS, MATMUL_TIMER)
    if "matmul-splits" in what[:len(what) - len(trees)]:
        for ln in run_tree(MATMUL_SPLITS_TIMER, HERE).splitlines():
            print(f"matmul-splits {ln}", flush=True)
    if "mel-refine" in what[:len(what) - len(trees)]:
        for ln in run_tree(MEL_TIMER, HERE, os.path.join(HERE, "chip_smoke.py"),
                           "0", "1e-7", "1e-6", "1e-5").splitlines():
            print(f"mel-refine {ln}", flush=True)
    if "mel-refine-variants" in what[:len(what) - len(trees)]:
        sweep_variants("mel", MEL_REFINE_VARIANTS, MEL_TIMER, os.path.join(HERE, "chip_smoke.py"))
    if "align-variants" in what[:len(what) - len(trees)]:
        sweep_variants("align", ALIGN_VARIANTS, ALIGN_TIMER)
    if "dtw-variants" in what[:len(what) - len(trees)]:
        sweep_variants("dtw", DTW_VARIANTS, ALIGN_TIMER)
    if "flash-bwd-variants" in what[:len(what) - len(trees)]:
        sweep_variants("flash-bwd", FLASH_BWD_VARIANTS, FLASH_BWD_TIMER)
    if "flash-fwd-variants" in what[:len(what) - len(trees)]:
        sweep_variants("flash-fwd", FLASH_FWD_VARIANTS, FLASH_FWD_TIMER)
    if "mel-variants" in what[:len(what) - len(trees)]:
        sweep_variants("mel", MEL_VARIANTS, MEL_TIMER, os.path.join(HERE, "chip_smoke.py"))
    if mode == "decode":
        time_trees("decode", DECODE_TIMER, trees)
    elif mode == "step":
        time_trees("step", STEP_TIMER, trees)
    elif mode == "matmul":
        time_trees("matmul", MATMUL_TIMER, trees)
    elif mode == "mel":
        time_trees("mel", MEL_TIMER, trees, os.path.join(HERE, "chip_smoke.py"))
    elif mode == "encoder":
        time_trees("encoder", TIMER, trees)
    elif mode == "align-launches":
        time_trees("align-launches", ALIGN_LAUNCHES_TIMER, trees)
    elif mode == "align":
        time_trees("align", ALIGN_TIMER, trees)
    elif mode == "flash-bwd":
        time_trees("flash-bwd", FLASH_BWD_TIMER, trees)
    elif mode == "flash-fwd":
        time_trees("flash-fwd", FLASH_FWD_TIMER, trees)
    elif mode == "median9":
        time_trees("median9", MEDIAN_TIMER, trees)
    return 0


if __name__ == "__main__":
    sys.exit(main())
