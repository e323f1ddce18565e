#!/usr/bin/env python3
"""Design sweeps of the port's attention kernels on one NVIDIA GPU.

    python3 tools/torch_kernel_sweeps.py [xattn] [pipeline] [flash] [decode|step [DIR ...]]

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
EX2 = 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));'
MASK = "    if (causal || k0 + kBN > Sk) {"
# name -> (what it changes, [(source, old text, new text), ...])
FLASH_VARIANTS = {
    "as built": ("the source as it is", []),
    "3 stages": ("a three-stage K/V ring", [(SRC, "constexpr int kStages = 2;",
                                             "constexpr int kStages = 3;")]),
    "no exp2": ("exp2 replaced by a multiply (wrong output)", [(SRC, EX2, "y = x * 0.5f;")]),
    "no softmax": ("no mask, max or exp2: P = bf16(S) (wrong output)",
                   [(SRC, MASK, "    al0 = al1 = 1.f;\n    return;\n" + MASK)]),
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


def run_tree(timer, tree, *args):
    """The timer's output on the checkout at ``tree``, in a process of its
    own with its own build directory."""
    env = dict(os.environ, WTT_TORCH_BUILD_DIR=os.path.join(tree, "build", "wtt_torch_kernels"))
    r = subprocess.run([sys.executable, "-c", timer, tree, *args], env=env, capture_output=True,
                       text=True, timeout=900)
    return r.stdout.strip() if r.returncode == 0 else "FAILED " + r.stderr.strip()[-1500:]


def time_trees(tag, timer, trees):
    for tree in trees or [HERE]:
        label = os.path.relpath(os.path.abspath(tree), HERE)
        for ln in run_tree(timer, os.path.abspath(tree)).splitlines():
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

    if not torch.cuda.is_available():
        print("torch_kernel_sweeps: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    what = sys.argv[1:] or ["xattn", "flash"]
    mode = next((m for m in ("decode", "step") if m in what), None)
    trees = what[what.index(mode) + 1:] if mode else []
    if "xattn" in what[:len(what) - len(trees)]:
        for ln in run_tree(DECODE_TIMER, HERE, *XATTN_SETTINGS).splitlines():
            print(f"xattn {ln}", flush=True)
    if "flash" in what[:len(what) - len(trees)]:
        sweep_variants("flash", FLASH_VARIANTS, TIMER)
    if "pipeline" in what[:len(what) - len(trees)]:
        sweep_variants("pipeline", PIPELINE_VARIANTS, DECODE_TIMER, *PIPELINE_SETTINGS)
    if mode == "decode":
        time_trees("decode", DECODE_TIMER, trees)
    elif mode == "step":
        time_trees("step", STEP_TIMER, trees)
    return 0


if __name__ == "__main__":
    sys.exit(main())
