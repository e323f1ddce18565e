#!/usr/bin/env python3
"""Design sweeps of the port's two attention kernels on one NVIDIA GPU.

    python3 tools/torch_kernel_sweeps.py [xattn] [flash]

``xattn``: ``xattn_decode`` at B = 1, 8 and 40 (large-v3: T=1500, D=1280,
H=20, the layer cycling over 32) for each ``XATTN_BLOCKS_PER_SM`` of its
split rule, with and without scores, beside ``scaled_dot_product_attention``.

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
# name -> (what it changes, [(old text, new text), ...])
FLASH_VARIANTS = {
    "as built": ("the source as it is", []),
    "3 stages": ("a three-stage K/V ring", [("constexpr int kStages = 2;",
                                             "constexpr int kStages = 3;")]),
    "no exp2": ("exp2 replaced by a multiply (wrong output)", [(EX2, "y = x * 0.5f;")]),
    "no softmax": ("no mask, max or exp2: P = bf16(S) (wrong output)",
                   [(MASK, "    al0 = al1 = 1.f;\n    return;\n" + MASK)]),
}

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


def sweep_xattn():
    import torch

    sys.path.insert(0, HERE)
    from whisper_timestamped_tpu_torch.ops import kernels as K

    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device="cuda").manual_seed(0)
    L, T, D, H = 32, 1500, 1280, 20
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, 64).transpose(1, 2)

    default = K.XATTN_BLOCKS_PER_SM
    for B in (1, 8, 40):
        q = torch.randn((B, 1, D), generator=g, device="cuda").bfloat16()
        xk = torch.randn((L, B, T, D), generator=g, device="cuda").bfloat16()
        xv = torch.randn((L, B, T, D), generator=g, device="cuda").bfloat16()
        lib = timed(torch, lambda it: sdpa(heads(q), heads(xk[it % L]), heads(xv[it % L])))
        for per_sm in (1, 2, 3, 4, 8, 16):
            K.XATTN_BLOCKS_PER_SM = per_sm
            ns = timed(torch, lambda it: K.xattn_decode(q, xk, xv, it % L, H))
            sc = timed(torch, lambda it: K.xattn_decode(q, xk, xv, it % L, H, emit_scores=True))
            split = K.xattn_split(B, H, T, n_sm)
            print(f"xattn B={B} blocks/SM={per_sm} (n_split, frames)={split}: {ns:.4f} ms, "
                  f"with scores {sc:.4f} ms; sdpa {lib:.4f} ms", flush=True)
        K.XATTN_BLOCKS_PER_SM = default
        del xk, xv
        torch.cuda.empty_cache()


def sweep_flash():
    root = os.path.join(HERE, "build", "kernel_sweeps")
    source = open(os.path.join(PKG, SRC)).read()
    for i, (name, (what, edits)) in enumerate(FLASH_VARIANTS.items()):
        d = os.path.join(root, f"v{i}")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(PKG, os.path.join(d, "whisper_timestamped_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        src = source
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"torch_kernel_sweeps: variant {name!r} no longer applies")
            src = src.replace(old, new)
        with open(os.path.join(d, "whisper_timestamped_tpu_torch", SRC), "w") as f:
            f.write(src)
        env = dict(os.environ, WTT_TORCH_BUILD_DIR=os.path.join(d, "build"))
        r = subprocess.run([sys.executable, "-c", TIMER, d], env=env, capture_output=True,
                           text=True, timeout=600)
        result = r.stdout.strip() if r.returncode == 0 else "FAILED " + r.stderr.strip()[-800:]
        print(f"flash [{name}] ({what}): {result}", flush=True)
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
    if "xattn" in what:
        sweep_xattn()
    if "flash" in what:
        sweep_flash()
    return 0


if __name__ == "__main__":
    sys.exit(main())
