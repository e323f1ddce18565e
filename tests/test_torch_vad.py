"""The port's voice-activity detection against the JAX package's, on the CPU.

Every case of test_vad.py runs through both packages' functions and must
give equal results (the energy splitter, the dilation, the back-conversion
and the hysteresis are numpy copies: exact equality). The silero network is
a torch module in the port (``models/silero.py``): on the fake v5 ``.jit``
of test_vad.py it is held to JAX's ``make_jax_prob_fn`` within 1e-5 and to
the torchscript model within 1e-4 (the loaders' own limit); its ONNX route
gives the ``.jit`` route's probabilities exactly. End to end, the port's
``transcribe_timestamped`` reproduces the VAD goldens of test_golden.py
(words.json under ``loose``, verbose stdout byte for byte), and its
``transcribe_batch`` equals JAX's in words and ``speech_activity``.
"""

import contextlib
import io
import json
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from model_utils import N_LANGS, hf_model_to_jax, make_hf_model, make_tokenizer  # noqa: E402
from test_golden import EXPECTED_DIR, _audio, loose  # noqa: E402
from test_torch_golden import _check_golden  # noqa: E402
from test_vad import _jit_state_arrays, _make_fake_silero_jit, _speech_like, _write_fake_onnx  # noqa: E402
from test_writers_cli import REF_DATA  # noqa: E402
from whisper_timestamped_tpu import vad as JV  # noqa: E402
from whisper_timestamped_tpu.api import transcribe_timestamped as jax_transcribe  # noqa: E402
from whisper_timestamped_tpu.models import onnx_weights as JO  # noqa: E402
from whisper_timestamped_tpu.models import silero_jax as JS  # noqa: E402
from whisper_timestamped_tpu.models.load import WhisperModel as JaxModel  # noqa: E402
from whisper_timestamped_tpu.parallel import batch as JB  # noqa: E402
from whisper_timestamped_tpu_torch import transcribe_timestamped  # noqa: E402
from whisper_timestamped_tpu_torch import vad as TV  # noqa: E402
from whisper_timestamped_tpu_torch.models import WhisperDims, WhisperModel, params_from_jax_tree  # noqa: E402
from whisper_timestamped_tpu_torch.models import onnx_weights as TO  # noqa: E402
from whisper_timestamped_tpu_torch.models import silero as TS  # noqa: E402
from whisper_timestamped_tpu_torch.parallel import batch as B  # noqa: E402
from whisper_timestamped_tpu_torch.tokenizer import get_tokenizer, synthetic_ranks  # noqa: E402

HEADS = [(0, 1), (1, 0), (1, 2)]
QUIET = dict(no_speech_threshold=None, logprob_threshold=None, compression_ratio_threshold=None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    params, dims = hf_model_to_jax(make_hf_model(seed=0))
    jax_model = JaxModel(params=jax.tree.map(jnp.asarray, params), dims=dims,
                         alignment_heads=HEADS)
    module = params_from_jax_tree(params, WhisperDims(**dims.__dict__), device="cpu")
    return jax_model, WhisperModel(module=module, alignment_heads=HEADS)


@pytest.fixture(scope="module")
def silero_jit(tmp_path_factory):
    return _make_fake_silero_jit(tmp_path_factory.mktemp("silero"))


@pytest.fixture(scope="module")
def speech_silero_jit(tmp_path_factory):
    """test_vad.py's fake v5 ``.jit`` with weights set to answer loudness:
    non-negative encoder convs without biases (features proportional to
    the amplitude), an LSTM whose cell gate reads the features' mean (input
    gate open, forget gate shut, small random recurrent weights) and a head
    with a negative bias, so silence scores ~0.02 and noise at 0.3 near 1."""
    d = tmp_path_factory.mktemp("speech_silero")
    model = torch.jit.load(_make_fake_silero_jit(d), map_location="cpu")
    sd = model.state_dict()
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for i in range(4):
            sd[f"_model.encoder.{i}.reparam_conv.weight"].abs_()
            sd[f"_model.encoder.{i}.reparam_conv.bias"].zero_()
        loud = torch.from_numpy(_chunks(9, 64))
        feat = torch.cat([torch.zeros(1, 64), loud.reshape(1, -1)], 1)
        feat = model._model.stft(feat.unfold(1, 576, 512)[0]).float()
        feat = model._model.encoder(feat).mean(dim=-1).mean()
        H = 128
        wi = torch.zeros(4 * H, H)
        wi[2 * H:3 * H] = 3.0 / (H * float(feat))  # cell gate: 3x the mean feature of noise
        sd["_model.decoder.rnn.weight_ih"].copy_(wi)
        sd["_model.decoder.rnn.weight_hh"].copy_(torch.randn(4 * H, H, generator=g) * 0.02)
        bias = torch.zeros(4 * H)
        bias[:H], bias[H:2 * H], bias[3 * H:] = 8.0, -8.0, 8.0  # i open, f shut, o open
        sd["_model.decoder.rnn.bias_ih"].copy_(bias)
        sd["_model.decoder.rnn.bias_hh"].zero_()
        sd["_model.decoder.decoder.2.weight"].fill_(10.0 / H)
        sd["_model.decoder.decoder.2.bias"].fill_(-4.0)
    path = str(d / "speech_silero_vad.jit")
    model.save(path)
    return path


def _tok(language="en"):
    return get_tokenizer(ranks=synthetic_ranks(), multilingual=True, num_languages=N_LANGS,
                         language=language, task="transcribe" if language else None)


def _chunks(seed, n):
    return (np.random.default_rng(seed).standard_normal((n, 512)) * 0.3).astype(np.float32)


# ---------------------------------------------------------------------------
# The numpy copies: equal to the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method,kw", [
    (True, {}), (False, {}), (None, {}), ("True", {}), ("none", {}), ("auditok", {}),
    ("energy", {}), ("silero", {}), ("silero:3.1", dict(with_version=True)),
    ("silero:v4.0", dict(with_version=True)), ([(0, 1), (2, 3)], {}), ("[(0, 1)]", {}),
])
def test_check_vad_method_matches_jax(method, kw):
    assert TV.check_vad_method(method, **kw) == JV.check_vad_method(method, **kw)


@pytest.mark.parametrize("method", ["nonsense_method", "silero:", "silero:vx", "silero:0.5",
                                    "[(0, 1, 2)]"])
def test_check_vad_method_refusals_match_jax(method):
    errors = []
    for mod in (TV, JV):
        with pytest.raises((ValueError, AssertionError)) as e:
            mod.check_vad_method(method)
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("dilatation", [0.0, 0.25, 1.5])
@pytest.mark.parametrize("method", ["energy", "auditok"])
def test_energy_segments_match_jax(method, dilatation):
    a = _speech_like()
    for output_sample in (False, True):
        kw = dict(method=method, dilatation=dilatation, output_sample=output_sample)
        got = TV.get_vad_segments(a, **kw)
        assert got == JV.get_vad_segments(a, **kw)
    n = len(TV.get_vad_segments(a, method=method, dilatation=dilatation))
    assert n == (1 if dilatation == 1.5 else 2)  # the dilation bridges the 2 s gap


def test_energy_split_edges_match_jax():
    """Speech at both ends, a sub-minimum blip, and too little audio for a
    frame."""
    rng = np.random.default_rng(4)
    a = np.zeros(16000 * 5, np.float32)
    a[:8000] = rng.standard_normal(8000) * 0.3
    a[40000:40400] = 0.5  # 25 ms: below min_speech_duration
    a[-16000:] = rng.standard_normal(16000) * 0.3
    for audio in (a, a[:100], np.zeros(0, np.float32)):
        args = (audio, 16000, 0.1, 0.5)
        assert TV._energy_split(*args) == JV._energy_split(*args)


@pytest.mark.parametrize("method", ["energy", [(0.5, 1.5), (3.9, 5.2)]])
def test_remove_non_speech_and_convert_match_jax(method):
    a = _speech_like()
    st, segs_t, conv_t = TV.remove_non_speech(a, method=method, dilatation=0.25)
    sj, segs_j, conv_j = JV.remove_non_speech(a, method=method, dilatation=0.25)
    np.testing.assert_array_equal(st, sj)
    assert segs_t == segs_j and len(segs_t) == 2
    dur0 = segs_t[0][1] - segs_t[0][0]
    for t in (0.0, 0.5, dur0, dur0 + 0.5, 1e3):
        assert conv_t(t) == conv_j(t)
    for t, t2 in ((0.2, 0.8), (dur0 - 0.1, dur0 + 0.3), (dur0 + 0.2, dur0 + 0.8)):
        assert conv_t(t, t2) == conv_j(t, t2)
    assert TV.remove_non_speech(a, method=method, use_sample=True)[1] == \
        JV.remove_non_speech(a, method=method, use_sample=True)[1]


def test_convert_timestamps_match_jax():
    segs = [(0.0, 10.0)]
    assert TV.do_convert_timestamps(segs, 3.217) == JV.do_convert_timestamps(segs, 3.217) == 3.22
    segs = [(1.0, 2.5), (4.0, 4.5), (7.0, 9.0)]
    for q in ((0.3,), (1.7,), (1.5, 1.9), (0.2, 3.9), (5.0,), (4.0, 6.0)):
        assert TV.do_convert_timestamps(segs, *q) == JV.do_convert_timestamps(segs, *q)


@pytest.mark.parametrize("avoid_empty_speech", [False, True])
def test_no_speech_matches_jax(avoid_empty_speech):
    a = np.zeros(16000 * 2, np.float32)
    st, segs_t, conv_t = TV.remove_non_speech(a, method="energy",
                                              avoid_empty_speech=avoid_empty_speech)
    sj, segs_j, conv_j = JV.remove_non_speech(a, method="energy",
                                              avoid_empty_speech=avoid_empty_speech)
    np.testing.assert_array_equal(st, sj)
    assert segs_t == segs_j
    assert len(st) == (len(a) if avoid_empty_speech else 0)
    assert conv_t(1.0) == conv_j(1.0) and conv_t(1.0, 1.5) == conv_j(1.0, 1.5)


@pytest.mark.parametrize("case", ["two_blocks", "blip", "brief_dip", "tail", "pads_merge"])
def test_hysteresis_matches_jax(case):
    probs = np.zeros(100)
    kw = {}
    if case == "two_blocks":
        probs[10:30] = probs[60:80] = 0.9
        kw = dict(min_silence_duration_ms=100)
    elif case == "blip":
        probs[50] = 0.9  # 32 ms < 250 ms min_speech
    elif case == "brief_dip":
        probs[10:50] = 0.9
        probs[30] = 0.1
    elif case == "tail":
        probs[90:] = 0.8
    else:
        probs[10:30] = probs[33:60] = 0.7
        kw = dict(threshold=0.6, speech_pad_ms=60)
    got = TS.speech_probs_to_timestamps(probs, 100 * 512, **kw)
    assert got == JS.speech_probs_to_timestamps(probs, 100 * 512, **kw)
    assert (got == []) == (case == "blip")


def test_window_override_and_fake_probs_match_jax(caplog):
    """The chunking window (512, or 1536 for v3 pinnings) reaches the
    probability callable as in JAX; the module ignores an override with a
    warning, as JAX's ``is_jax`` route does."""
    seen = []

    def spy(chunks, sr):
        seen.append(chunks.shape)
        return (np.abs(chunks).mean(axis=-1) > 0.05).astype(float)

    rng = np.random.default_rng(0)
    audio = np.zeros(16000 * 4, np.float32)
    audio[16000:32000] = rng.standard_normal(16000) * 0.5
    for window in (None, 1536):
        got = TS.silero_get_speech_timestamps(audio, "unused", probs_fn=spy,
                                              window_size_samples=window)
        want = JS.silero_get_speech_timestamps(audio, "unused", probs_fn=spy,
                                               window_size_samples=window)
        assert got == want and len(got) == 1
    assert [s[1] for s in seen] == [512, 512, 1536, 1536]

    spy.is_module = True
    with caplog.at_level(logging.WARNING, logger="whisper_timestamped_tpu_torch"):
        TS.silero_get_speech_timestamps(audio, "unused", probs_fn=spy, window_size_samples=1536)
    assert seen[-1][1] == 512
    assert any("512-sample windows" in r.getMessage() for r in caplog.records)


def test_find_local_silero_matches_jax(tmp_path, monkeypatch):
    """``SILERO_VAD_PATH`` first, then the torch hub cache under the home
    directory (.jit before .onnx, a pinned version by directory name);
    nothing found gives None, and ``vad="silero"`` then raises."""
    monkeypatch.delenv("SILERO_VAD_PATH", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    for version in (None, "v3.1"):
        assert TV._find_local_silero(version) is None is JV._find_local_silero(version)
    with pytest.raises(FileNotFoundError):
        TV.get_vad_segments(_speech_like(), method="silero", device="cpu")
    hub = tmp_path / ".cache" / "torch" / "hub"
    for d, f in (("snakers4_silero-vad_master/files", "silero_vad.onnx"),
                 ("snakers4_silero-vad_master/files", "silero_vad.jit"),
                 ("snakers4_silero-vad_v3.1/files", "silero_vad.jit")):
        os.makedirs(hub / d, exist_ok=True)
        (hub / d / f).write_bytes(b"")
    for version in (None, "v3.1", "v4.0"):
        assert TV._find_local_silero(version) == JV._find_local_silero(version)
    assert TV._find_local_silero(None).endswith("v3.1/files/silero_vad.jit")  # .jit, shortest
    assert TV._find_local_silero("v3.1").endswith("v3.1/files/silero_vad.jit")
    monkeypatch.setenv("SILERO_VAD_PATH", str(hub))
    assert TV._find_local_silero("v4.0") == JV._find_local_silero("v4.0") == str(hub)


def test_silero_needs_a_card_by_default(silero_jit, monkeypatch):
    """The silero route defaults to the CUDA card and raises without one,
    as ``load_model`` does; the energy route and explicit pairs run on the
    host whatever the device."""
    monkeypatch.setenv("SILERO_VAD_PATH", silero_jit)
    a = _speech_like()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TV.get_vad_segments(a, method="silero")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TV.remove_non_speech(a, method="silero", device="cuda")
    assert TV.get_vad_segments(a, method="energy") == JV.get_vad_segments(a, method="energy")
    assert TV.remove_non_speech(a, method=[(0, 1)])[1] == [(0.0, 1.0)]


# ---------------------------------------------------------------------------
# The silero module
# ---------------------------------------------------------------------------


def test_silero_module_matches_jax_and_torchscript(silero_jit):
    fn = TS.load_module_prob_model(silero_jit, "cpu")
    assert fn is not None and fn.is_module and isinstance(fn.module, TS.SileroVAD)
    assert {p.device.type for p in fn.module.parameters()} == {"cpu"}
    jax_fn = JS.make_jax_prob_fn(TS.parse_silero_state_dict(
        dict(torch.jit.load(silero_jit, map_location="cpu").state_dict())))
    ts_fn = TS.load_torchscript_prob_model(silero_jit)
    for n in (1, 7, 300):
        chunks = _chunks(n, n)
        got = fn(chunks, 16000)
        assert got.shape == (n,) and got.dtype == np.float32
        np.testing.assert_allclose(got, jax_fn(chunks, 16000), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got, ts_fn(chunks, 16000), atol=1e-4, rtol=0)
    assert fn(np.zeros((0, 512), np.float32), 16000).shape == (0,)


@pytest.mark.parametrize("blocks", [dict(FEATURE_BLOCK=7), dict(LSTM_BLOCK=9),
                                    dict(FEATURE_BLOCK=16, LSTM_BLOCK=5)])
def test_silero_module_blocks_carry_context_and_state(silero_jit, monkeypatch, blocks):
    """Features computed in blocks (``FEATURE_BLOCK``) and the LSTM run in
    blocks of steps (``LSTM_BLOCK``) equal one block each: the 64-sample
    context crosses a block edge, the LSTM state is carried."""
    fn = TS.load_module_prob_model(silero_jit, "cpu")
    chunks = _chunks(3, 50)
    whole = fn(chunks, 16000)
    for name, value in blocks.items():
        monkeypatch.setattr(TS, name, value)
    np.testing.assert_allclose(fn(chunks, 16000), whole, atol=1e-6, rtol=0)


def test_silero_module_keeps_f32_and_restores_flags(silero_jit):
    """The forward turns TF32 off for its convolutions and LSTM and puts the
    caller's flags back."""
    fn = TS.load_module_prob_model(silero_jit, "cpu")
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    seen = []
    lstm_forward = fn.module.lstm.forward

    def spy(*args, **kwargs):
        seen.append((cudnn.allow_tf32, matmul.allow_tf32))
        return lstm_forward(*args, **kwargs)

    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        fn.module.lstm.forward = spy
        fn(_chunks(0, 4), 16000)
        assert seen == [(False, False)]
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def test_silero_end_to_end_matches_jax(silero_jit, monkeypatch):
    """``vad="silero"`` resolves the weights from ``SILERO_VAD_PATH``; the
    segments equal JAX's and the torchscript adapter's."""
    monkeypatch.setenv("SILERO_VAD_PATH", silero_jit)
    a = _speech_like()
    got = TV.get_vad_segments(a, method="silero", dilatation=0.0, device="cpu")
    assert TS._PROB_MODEL_CACHE[(silero_jit, "cpu")].is_module
    assert got == JV.get_vad_segments(a, method="silero", dilatation=0.0)
    ts = TS.silero_get_speech_timestamps(a, silero_jit, probs_fn=TS.load_torchscript_prob_model(
        silero_jit), min_speech_duration=0.1, min_silence_duration=0.1)
    assert TS.silero_get_speech_timestamps(a, silero_jit, device="cpu") == ts
    speech_t, segs_t, _ = TV.remove_non_speech(a, method="silero", device="cpu")
    speech_j, segs_j, _ = JV.remove_non_speech(a, method="silero")
    assert segs_t == segs_j
    np.testing.assert_array_equal(speech_t, speech_j)


def test_silero_unknown_architecture_falls_back(tmp_path, caplog):
    """A .jit outside the v5 schema runs through torchscript with a loud
    revision warning, as in JAX."""
    import torch.nn as nn

    class Odd(nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = nn.Linear(512, 1)

        @torch.jit.export
        def reset_states(self):
            pass

        def forward(self, x, sr: int):
            return torch.sigmoid(self.lin(x)).reshape(())

    torch.manual_seed(0)
    path = str(tmp_path / "odd.jit")
    torch.jit.script(Odd().eval()).save(path)
    assert TS.load_module_prob_model(path, "cpu") is None
    with caplog.at_level(logging.WARNING, logger="whisper_timestamped_tpu_torch"):
        fn = TS._cached_prob_model(path, "cpu")
    assert any("v5 weight schema" in r.getMessage() and "torchscript" in r.getMessage()
               for r in caplog.records), [r.getMessage() for r in caplog.records]
    assert not getattr(fn, "is_module", False)
    chunks = _chunks(2, 3)
    np.testing.assert_array_equal(fn(chunks, 16000),
                                  JS.load_torchscript_prob_model(path)(chunks, 16000))


# ---------------------------------------------------------------------------
# ONNX weights
# ---------------------------------------------------------------------------


def _arrays_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


def test_onnx_initializers_match_jax(silero_jit, tmp_path):
    """Half the tensors buried in an If-style subgraph; ``float_data``
    tensors beside ``raw_data`` ones; a non-float tensor skipped."""
    arrays = _jit_state_arrays(silero_jit)
    names = sorted(arrays)
    path = str(tmp_path / "silero_vad.onnx")
    _write_fake_onnx(path, {n: arrays[n] for n in names[::2]},
                     subgraph_initializers={n: arrays[n] for n in names[1::2]})
    got = TO.parse_onnx_initializers(path)
    _arrays_equal(got, JO.parse_onnx_initializers(path))
    assert set(got) == set(names)
    for n in names:
        np.testing.assert_array_equal(got[n], arrays[n])


def test_onnx_route_equals_jit_route(silero_jit, tmp_path):
    arrays = _jit_state_arrays(silero_jit)
    names = sorted(arrays)
    path = str(tmp_path / "silero_vad.onnx")
    _write_fake_onnx(path, {n: arrays[n] for n in names[::2]},
                     subgraph_initializers={n: arrays[n] for n in names[1::2]})
    onnx_fn = TS.load_onnx_prob_model(path, "cpu")
    assert onnx_fn is not None and onnx_fn.is_module
    chunks = _chunks(5, 16)
    np.testing.assert_array_equal(onnx_fn(chunks, 16000),
                                  TS.load_module_prob_model(silero_jit, "cpu")(chunks, 16000))


def test_onnx_shape_fallback(silero_jit, tmp_path):
    """Mangled module paths: the conv stack matched by shape chaining, the
    LSTM by its name fragments, as in JAX."""
    arrays = _jit_state_arrays(silero_jit)
    renamed = {}
    for i, (name, arr) in enumerate(sorted(arrays.items())):
        for frag in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            if frag in name:
                renamed[f"onnx::LSTM_{i}.{frag}"] = arr
                break
        else:
            renamed[f"onnx::Conv_{i}"] = arr
    path = str(tmp_path / "mangled.onnx")
    _write_fake_onnx(path, renamed)
    inits = TO.parse_onnx_initializers(path)
    sd_t, sd_j = TS.match_onnx_silero_weights(inits), JS.match_onnx_silero_weights(inits)
    _arrays_equal(sd_t, sd_j)
    chunks = _chunks(6, 8)
    np.testing.assert_array_equal(TS.load_onnx_prob_model(path, "cpu")(chunks, 16000),
                                  TS.load_module_prob_model(silero_jit, "cpu")(chunks, 16000))


def test_onnx_schema_mismatch_raises(tmp_path, monkeypatch):
    path = str(tmp_path / "weird.onnx")
    _write_fake_onnx(path, {"w": np.zeros((3, 3), np.float32)})
    with pytest.raises(RuntimeError, match="v5 weight schema"):
        TS._cached_prob_model(path, "cpu")
    monkeypatch.setenv("SILERO_VAD_PATH", path)
    with pytest.raises(RuntimeError, match="v5 weight schema"):
        TV.get_vad_segments(_speech_like(), method="silero", device="cpu")


def test_onnx_end_to_end_via_vad(silero_jit, tmp_path, monkeypatch):
    path = str(tmp_path / "silero_vad.onnx")
    _write_fake_onnx(path, _jit_state_arrays(silero_jit))
    a = _speech_like()
    monkeypatch.setenv("SILERO_VAD_PATH", silero_jit)
    want = TV.get_vad_segments(a, method="silero", dilatation=0.0, device="cpu")
    monkeypatch.setenv("SILERO_VAD_PATH", path)
    assert TV.get_vad_segments(a, method="silero", dilatation=0.0, device="cpu") == want
    assert TS._PROB_MODEL_CACHE[(path, "cpu")].is_module


# ---------------------------------------------------------------------------
# End to end: goldens and the batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["vad_explicit", "vad_auditok"])
@pytest.mark.parametrize("route", ["device", "host"])
def test_vad_goldens(models, name, route):
    """test_golden.py's VAD configurations reproduce their goldens, through
    the device aligner's plain versions and through the host route."""
    _, model = models
    _check_golden(model, name, **({"device_alignment": True} if route == "device" else {}))


def test_vad_explicit_verbose_stdout_golden(models, capsys):
    """The verbose word lines of a VAD run are printed after the
    back-conversion: byte for byte the stored stdout golden."""
    _, model = models
    transcribe_timestamped(model, _audio(7, 7), language="en", tokenizer=_tok(),
                           vad=[(0.0, 3.0), (4.0, 6.0)], verbose=True, **QUIET)
    with open(os.path.join(EXPECTED_DIR, "verbose", "vad_explicit.stdout"), encoding="utf-8") as f:
        assert capsys.readouterr().out == f.read()


def _silero_audio():
    """7 s of noise with two silences cut in (the fake silero's input)."""
    a = _audio(7, 7)
    a[16000:40000] = 0.0
    a[72000:88000] = 0.0
    return a


def test_vad_silero_matches_jax_and_golden(models, speech_silero_jit, monkeypatch):
    """``vad="silero"`` with fake v5 weights that answer loudness
    (``speech_silero_jit``): the port's stdout and
    result equal JAX's (result under ``loose``), with ``speech_activity``
    and every word inside a speech span or past the last one. On test_golden.py's ``words.wav``,
    where that fixture exists, also the ``vad_silero`` stdout and
    ``words_vad_silero`` goldens."""
    jax_model, model = models
    monkeypatch.setenv("SILERO_VAD_PATH", speech_silero_jit)
    wav = os.path.join(REF_DATA, "words.wav")
    runs = [(_silero_audio(), None, None)]
    if os.path.exists(wav):
        from whisper_timestamped_tpu_torch.audio import load_audio

        runs.append((load_audio(wav), "vad_silero.stdout", "words_vad_silero.words.json"))
    for audio, stdout_golden, words_golden in runs:
        outs = []
        for fn, m, tok, kw in ((transcribe_timestamped, model, _tok(), dict(device_alignment=True)),
                               (jax_transcribe, jax_model, make_tokenizer(),
                                dict(device_alignment=True))):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res = fn(m, audio, language="en", tokenizer=tok, vad="silero", verbose=True,
                         **kw, **QUIET)
            outs.append((buf.getvalue(), res))
        (out_t, res_t), (out_j, res_j) = outs
        assert out_t == out_j
        assert loose(res_t) == loose(res_j)
        spans = res_t["speech_activity"]
        assert spans and spans == res_j["speech_activity"]
        words = [w for s in res_t["segments"] for w in s.get("words", [])]
        assert words
        inside = [w for w in words
                  if any(sp["start"] - 0.01 <= w["start"] <= w["end"] <= sp["end"] + 0.01
                         for sp in spans)]
        # random weights place timestamps anywhere in the 30-s window; a time
        # past the speech audio's end maps past the last span, unclamped
        # (do_convert_timestamps, as the reference does)
        assert all(w in inside or w["start"] >= spans[-1]["end"] - 0.01 for w in words)
        if stdout_golden:
            with open(os.path.join(EXPECTED_DIR, "verbose", stdout_golden), encoding="utf-8") as f:
                assert out_t == f.read()
            with open(os.path.join(EXPECTED_DIR, words_golden), encoding="utf-8") as f:
                assert loose(res_t) == loose(json.load(f))


BATCH_VAD = {"auditok": "auditok", "explicit": [(0.5, 3.0), (4.0, 7.5)]}


@pytest.mark.parametrize("vad", sorted(BATCH_VAD))
def test_transcribe_batch_vad_matches_jax(models, vad):
    jax_model, model = models
    audios = {"a": _audio(0, 8), "b": _speech_like(), "c": _audio(2, 12)}
    kw = dict(language="en", batch_size=4, temperature=[0.0], vad=BATCH_VAD[vad],
              device_alignment=True, **QUIET)
    got = B.transcribe_batch(model, audios, _tok(), **kw)
    want = JB.transcribe_batch(jax_model, audios, make_tokenizer(language="en", task="transcribe"),
                               **kw)
    assert list(got) == list(want)
    for name in audios:
        assert got[name]["speech_activity"] == want[name]["speech_activity"], name
        assert [s["tokens"] for s in got[name]["segments"]] == \
            [s["tokens"] for s in want[name]["segments"]], name
        assert loose(got[name]) == loose(want[name]), name
    assert sum(len(s.get("words", [])) for r in got.values() for s in r["segments"]) > 0


def test_transcribe_batch_stream_vad_equals_batch(models):
    """The serving loop under ``vad`` runs each batch through
    ``transcribe_batch`` (no prefetch): the same results."""
    _, model = models
    batches = [{"a": _audio(0, 8), "b": _speech_like()}, {"c": _audio(2, 6)}]
    kw = dict(language="en", batch_size=2, temperature=[0.0], vad="auditok", **QUIET)
    got = list(B.transcribe_batch_stream(model, iter(batches), _tok(), **kw))
    want = [B.transcribe_batch(model, b, _tok(), **kw) for b in batches]
    assert got == want
    assert all("speech_activity" in r for batch in got for r in batch.values())


def test_remove_non_speech_plot_matches_jax(tmp_path):
    """``plot`` with a path prefix writes the VAD overlay, as JAX's does."""
    a = _speech_like()
    TV.remove_non_speech(a, method="energy", plot=str(tmp_path / "ours"))
    JV.remove_non_speech(a, method="energy", plot=str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path)) == ["jax.VAD.jpg", "ours.VAD.jpg"]
