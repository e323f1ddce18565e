"""Build and load the CUDA kernels of ``csrc/`` (nvcc, ctypes).

All ``csrc/*.cu`` files compile into one shared library with a plain C
interface, for Hopper only (``sm_90a``), at first use: one nvcc process per
source, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o <source>.o csrc/<source>.cu   # each source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o libwtt_kernels.so *.o

into ``build/wtt_torch_kernels/<hash of the sources and flags>/`` beside the
package (``WTT_TORCH_BUILD_DIR`` overrides the root), so a changed source
rebuilds and an unchanged one is loaded as it is. Nothing here runs when the
package is imported; the CPU tests never build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C entry points: each returns cudaGetLastError() after its launches, but
# those of RETURNS
SIGNATURES = {
    # q, xk, xv, out, scores, layer, B, B_kv, T, D, H, beam_group, n_split,
    # frames_per_split, warps, scale, stream
    "wtt_xattn_decode": [_P] * 5 + [_I] * 10 + [_F, _P],
    # q, k_new, v_new, k, v, out, pad_len, layer, pos, B, ctx, D, H, n_split,
    # slots_per_split, warps, scale, stream
    "wtt_self_attn_decode": [_P] * 7 + [_I] * 9 + [_F, _P],
    # scores, rows (null: pre-sliced), dims, cost, scratch, partial, S, K, N, M, T, G, stream
    "wtt_align_cost": [_P] * 6 + [_I] * 6 + [_P],
    # scores, cost, partial, K, N, M, n_tokens, span, G, stream
    "wtt_attention_to_cost": [_P] * 3 + [_I] * 6 + [_P],
    # x, out, R, M, stream
    "wtt_median9": [_P, _P, _I, _I, _P],
    # cost, dims, codes, starts, path, packed, packed bytes, S, N, M, warps, stream
    "wtt_dtw": [_P] * 6 + [_L] + [_I] * 4 + [_P],
    # S, N, M, warps, walks: the bytes of wtt_dtw's device-memory scratch
    "wtt_dtw_scratch_bytes": [_I] * 5,
    # out, steps, stream (the DP's chain floor, timed by chip_smoke.py)
    "wtt_dtw_chain": [_P, _I, _P],
    # q, k, v, out, pad_len, B, Sq, Sk, D, H, causal, scale, stream
    "wtt_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    # q, xk, xk_scale, xv, xv_scale, out, scores, layer, B, B_kv, T, D, H, beam_group,
    # n_split, frames_per_split, warps, scale, stream
    "wtt_xattn_decode_int8": [_P] * 7 + [_I] * 10 + [_F, _P],
    # q, xk, xk_scale, xv, xv_scale, out, scores, layer, B, B_kv, T, D, H, beam_group,
    # n_split, rows_per_split, warps, scale, stream
    "wtt_xattn_decode_int4": [_P] * 7 + [_I] * 10 + [_F, _P],
    # q, k_new, v_new, k, k_scale, v, v_scale, out, pad_len, layer, pos, B, ctx, D, H,
    # n_split, slots_per_split, warps, scale, stream
    "wtt_self_attn_decode_int8": [_P] * 9 + [_I] * 9 + [_F, _P],
    # x, twiddles, window, cos_b, sin_b, bases_t, mel_w, out, radices (host int array),
    # n_stages, B, L, n_fft, n_bins, n_mels, hop, refine_below, stream
    "wtt_log10_mel": [_P] * 9 + [_I] * 7 + [_F, _P],
    # x, w_all, out, layer, L, B, N, K, cols, groups, n_split, stream
    "wtt_stacked_matmul": [_P, _P, _P] + [_I] * 8 + [_P],
    # q, k, v, out, lse, B, Sq, Sk, D, H, bf16, scale, stream
    "wtt_flash_attention_fwd": [_P] * 5 + [_I] * 6 + [_F, _P],
    # q, k, v, out, dout, lse, delta (written), dq, B, Sq, Sk, D, H, bf16, scale, stream
    "wtt_flash_attention_bwd_dq": [_P] * 8 + [_I] * 6 + [_F, _P],
    # q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, D, H, bf16, scale, stream
    "wtt_flash_attention_bwd_dkv": [_P] * 8 + [_I] * 6 + [_F, _P],
}
RETURNS = {"wtt_dtw_scratch_bytes": _L}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: dict = {}  # path, seconds, whether it was built in this process


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (CUDA_HOME)")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    root = os.environ.get("WTT_TORCH_BUILD_DIR") or (_CSRC.parent.parent / "build" / "wtt_torch_kernels")
    return Path(root) / h.hexdigest()[:16]


def _compile_and_link(out_dir: Path, so: Path) -> None:
    """One nvcc per source, all running at once, then the link. Each
    command and its output (ptxas's register and spill report) goes to
    ``build.log``; a failure raises with the failing command's errors."""
    nvcc, tag = _nvcc(), os.getpid()
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    tmp = out_dir / f"libwtt_kernels.{tag}.so"
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp)] + [str(obj) for _, obj, _ in jobs]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout)
        if proc.returncode != 0:
            failed.append(proc.stdout)
    (out_dir / "build.log").write_text("\n".join(log))
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed, see {out_dir / 'build.log'}:\n" + failed[0][-4000:])
    os.replace(tmp, so)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has none."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = build_dir()
        so = out_dir / "libwtt_kernels.so"
        t0 = time.perf_counter()
        built = False
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            _compile_and_link(out_dir, so)
            built = True
        lib = ctypes.CDLL(str(so))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = RETURNS.get(name, _I)
        BUILD_INFO.update(path=str(so), seconds=time.perf_counter() - t0, built=built)
        _lib = lib
        return lib
