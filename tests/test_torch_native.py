"""The port's host C++ core (``whisper_timestamped_tpu_torch/native.py``,
its own copy of ``native/wtt_native.cpp``) against the JAX package's
``native.py`` and the numpy oracle: BPE ids over the test tokenizer's
vocabulary, DTW paths with and without vertical moves, and the wiring into
the tokenizer and ``alignment.dtw_path``. The library builds into
``build/``, never into the source tree."""

import os

import numpy as np
import pytest

from whisper_timestamped_tpu import native as jax_native
from whisper_timestamped_tpu.ops.dtw import dtw_path_numpy
from whisper_timestamped_tpu.tokenizer import _SPLIT_PATTERN
from whisper_timestamped_tpu_torch import alignment, native
from whisper_timestamped_tpu_torch.tokenizer import BytePairEncoder, get_tokenizer, synthetic_ranks

TEXTS = ["the theatre is on", " you and he said yes", "hello", "日本語", "a  b",
         " bonjour, vous allez bien ? 日本語", "x" * 300, "  \n\t mixed 123 ,.;"]


@pytest.fixture(scope="module")
def libs():
    if not (native.available() and jax_native.available()):
        pytest.skip("g++ unavailable: both packages keep their Python routes")
    return native.get_lib(), jax_native.get_lib()


def test_builds_from_its_own_copy_into_build(libs):
    path = native.library_path()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    build = os.environ.get("WTT_TORCH_BUILD_DIR") or os.path.join(root, "build")
    assert path.exists() and path.parent.parent == type(path)(build) / "wtt_native"
    src = os.path.join(root, "whisper_timestamped_tpu_torch", "csrc", "wtt_native.cpp")
    with open(src, encoding="utf-8") as f, open(os.path.join(root, "native", "wtt_native.cpp"),
                                                 encoding="utf-8") as g:
        assert g.read() in f.read()  # the copy, behind its header
    assert os.path.realpath(libs[0]._name) == os.path.realpath(str(path))


def test_bpe_ids_match_jax_native(libs):
    import regex

    ranks = synthetic_ranks()
    port, ref = native.NativeBPE(ranks), jax_native.NativeBPE(ranks)
    py = BytePairEncoder(ranks)
    pieces = [p.encode("utf-8") for t in TEXTS for p in regex.findall(_SPLIT_PATTERN, t)]
    pieces += list(ranks)[:: max(1, len(ranks) // 500)]  # vocabulary entries, whole
    for b in pieces:
        assert port.encode_piece(b) == ref.encode_piece(b) == py._bpe_merge(b), b


def test_tokenizer_uses_the_native_core(libs):
    tok = get_tokenizer(ranks=synthetic_ranks())
    assert isinstance(tok.bpe._native_core(), native.NativeBPE)
    plain = get_tokenizer(ranks=synthetic_ranks())
    plain.bpe._native = False
    for text in TEXTS:
        ids = tok.encode(text)
        assert ids == plain.encode(text) and tok.decode(ids) == text


@pytest.mark.parametrize("allow_vertical", [True, False])
def test_dtw_path_matches_jax_native_and_oracle(libs, allow_vertical):
    for shape in [(4, 7), (17, 99), (23, 151), (1, 5), (30, 30)]:
        x = -np.random.default_rng(sum(shape)).random(shape)
        want = dtw_path_numpy(x, allow_vertical)
        ref = jax_native.dtw_path_native(x, allow_vertical)
        got = native.dtw_path_native(x, allow_vertical)
        via = alignment.dtw_path(x, allow_vertical)
        for a in (ref, got, via):
            np.testing.assert_array_equal(a[0], want[0])
            np.testing.assert_array_equal(a[1], want[1])


def test_dtw_path_routes_through_the_library(libs, monkeypatch):
    calls = []
    real = native.dtw_path_native
    monkeypatch.setattr(native, "dtw_path_native", lambda *a: calls.append(1) or real(*a))
    alignment.dtw_path(-np.random.default_rng(0).random((5, 9)))
    assert calls == [1]
