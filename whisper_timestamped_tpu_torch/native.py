"""ctypes bindings for the host C++ core: byte-pair encoding and the DTW.

Port of ``whisper_timestamped_tpu/native.py``, over the package's own copy
of ``native/wtt_native.cpp`` (``csrc/wtt_native.cpp``). g++ builds it at
first use into ``build/wtt_native/<hash of the source>/libwtt_native.so``
beside the package (``WTT_TORCH_BUILD_DIR`` moves the root, as for the
CUDA kernels), never into the source tree; the ABI is plain C through
ctypes. Every consumer keeps its pure-Python route for a host without g++,
the JAX package's own behaviour: ``available()`` gates the use.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import struct
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger("whisper_timestamped_tpu_torch")

_SRC = Path(__file__).resolve().parent / "csrc" / "wtt_native.cpp"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    """Where the library of this source is (or will be) built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    root = os.environ.get("WTT_TORCH_BUILD_DIR") or (_SRC.parent.parent.parent / "build")
    return Path(root) / "wtt_native" / h / "libwtt_native.so"


def _build(path: Path) -> bool:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"libwtt_native.{os.getpid()}.so")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, path)
        return True
    except Exception as e:  # a host without the toolchain
        logger.warning("native build failed (%s); using pure-Python fallbacks", e)
        tmp.unlink(missing_ok=True)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if this source has none; None when
    it cannot be built."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = library_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(path))
        lib.wtt_bpe_new.restype = ctypes.c_void_p
        lib.wtt_bpe_new.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.wtt_bpe_free.argtypes = [ctypes.c_void_p]
        lib.wtt_bpe_encode_piece.restype = ctypes.c_int32
        lib.wtt_bpe_encode_piece.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_uint32,
        ]
        lib.wtt_dtw_path.restype = ctypes.c_int32
        lib.wtt_dtw_path.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# BPE
# ---------------------------------------------------------------------------


class NativeBPE:
    """C++ rank-based BPE core (the semantics of ``BytePairEncoder``)."""

    def __init__(self, ranks: dict):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        blob = b"".join(struct.pack("<I", len(k)) + k + struct.pack("<i", v)
                        for k, v in ranks.items())
        self._lib = lib
        self._handle = lib.wtt_bpe_new(blob, len(blob))

    def encode_piece(self, piece: bytes) -> List[int]:
        # a buffer a call: reentrant under threads, and sized to the piece
        # (at most one id per input byte), so no length overflows
        buf = (ctypes.c_int32 * max(16, len(piece)))()
        n = self._lib.wtt_bpe_encode_piece(self._handle, piece, len(piece), buf, len(buf))
        if n == -1:
            raise KeyError(f"byte sequence not in vocabulary: {piece!r}")
        if n == -2:  # the buffer is large enough by construction
            raise RuntimeError("native BPE output buffer too small")
        return list(buf[:n])

    def __del__(self):
        try:
            self._lib.wtt_bpe_free(self._handle)
        except Exception:
            pass


# ---------------------------------------------------------------------------
# DTW
# ---------------------------------------------------------------------------


def dtw_path_native(x: np.ndarray, allow_vertical: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """The DTW path of cost ``x`` (N, M), float64, as ``dtw_path_numpy``
    gives it (tie order diagonal, left, up)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    x = np.ascontiguousarray(x, np.float64)
    n, m = x.shape
    cap = n + m
    pi = (ctypes.c_int32 * cap)()
    pj = (ctypes.c_int32 * cap)()
    length = lib.wtt_dtw_path(x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                              n, m, int(allow_vertical), pi, pj, cap)
    if length < 0:
        raise RuntimeError("native DTW path buffer too small")
    return np.array(pi[:length], np.int64), np.array(pj[:length], np.int64)
