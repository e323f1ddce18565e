"""The port's ``transcribe_timestamped`` against the JAX package's, end to end.

Same synthetic model (the golden model of test_golden.py, its weights
converted by ``params_from_jax_tree``), same audio, f32 on the CPU. Both
packages run each alignment route: the batched device aligner
(``device_alignment=True``; the port through the kernels' plain versions,
the JAX package through its Pallas kernels in interpret mode), the
per-segment kernels (more alignment heads than ``MAX_K``), the host
(``device_alignment=False``) and whole-window alignment
(``trust_whisper_timestamps=False``). Tokens must be identical, and the
result equal to JAX's (and, where one is stored, the golden) under
test_golden.py's ``loose`` rounding.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from model_utils import N_LANGS, hf_model_to_jax, make_hf_model, make_tokenizer  # noqa: E402
from test_golden import CONFIGS, EXPECTED_DIR, _audio, loose  # noqa: E402
from whisper_timestamped_tpu.api import transcribe_timestamped as jax_transcribe  # noqa: E402
from whisper_timestamped_tpu.decoding import DecodingOptions as JaxOptions  # noqa: E402
from whisper_timestamped_tpu.engine import DecodeEngine as JaxEngine  # noqa: E402
from whisper_timestamped_tpu.models.load import WhisperModel as JaxModel  # noqa: E402
from whisper_timestamped_tpu_torch import transcribe_timestamped  # noqa: E402
from whisper_timestamped_tpu_torch.decoding import DecodingOptions  # noqa: E402
from whisper_timestamped_tpu_torch.engine import DecodeEngine  # noqa: E402
from whisper_timestamped_tpu_torch.models import WhisperDims, WhisperModel, params_from_jax_tree  # noqa: E402
from whisper_timestamped_tpu_torch.tokenizer import get_tokenizer, synthetic_ranks  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HEADS = [(0, 1), (1, 0), (1, 2)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def models():
    params, dims = hf_model_to_jax(make_hf_model(seed=0))
    jax_model = JaxModel(params=jax.tree.map(jnp.asarray, params), dims=dims,
                         alignment_heads=HEADS)
    module = params_from_jax_tree(params, WhisperDims(**dims.__dict__), device="cpu")
    return jax_model, WhisperModel(module=module, alignment_heads=HEADS)


def _tok():
    return get_tokenizer(ranks=synthetic_ranks(), multilingual=True, num_languages=N_LANGS)


def _kwargs(name):
    opts = dict(CONFIGS[name])
    seed, seconds = opts.pop("_audio", (7, 7))
    kw = dict(no_speech_threshold=None, logprob_threshold=None,
              compression_ratio_threshold=None)
    kw.update(opts)
    return _audio(seed, seconds), kw


def _norm(res):
    if "language_probs" in res:
        res = {**res, "language_probs": loose(res["language_probs"])}
    return res


@pytest.mark.parametrize("name", ["efficient_greedy", "autodetect_language", "long_conditioned",
                                  "disfluencies"])
def test_slice_matches_jax_and_golden(models, name):
    jax_model, model = models
    audio, kw = _kwargs(name)
    port = _norm(transcribe_timestamped(model, audio, tokenizer=_tok(), device_alignment=True, **kw))
    ref = _norm(jax_transcribe(jax_model, audio, tokenizer=make_tokenizer(),
                               device_alignment=True, **kw))
    assert [s["tokens"] for s in port["segments"]] == [s["tokens"] for s in ref["segments"]]
    assert loose(port) == loose(ref)
    with open(os.path.join(EXPECTED_DIR, name + ".words.json"), encoding="utf-8") as f:
        assert loose(port) == loose(json.load(f))
    assert sum(len(s.get("words", [])) for s in port["segments"]) > 0


def test_decode_window_buffers_match_jax(models):
    """One window with a carried prompt (232-slot region): tokens equal,
    log-probs, timestamp log-probs and alignment rows allclose (both fetched
    to the host, the default); with ``fetch_alignment=False`` the port's
    buffers stay on the device and hold the same rows."""
    jax_model, model = models
    mel = np.random.default_rng(4).standard_normal((80, 3000)).astype(np.float32) * 0.5
    prompt = list(range(300, 330))
    rj = JaxEngine(jax_model, make_tokenizer()).decode_window(
        mel, JaxOptions(language="en", sample_len=40), prompt_tokens=prompt)[0]
    rt = DecodeEngine(model, _tok()).decode_window(
        torch.from_numpy(mel), DecodingOptions(language="en", sample_len=40), prompt_tokens=prompt)[0]
    assert rt.tokens == rj.tokens and len(rt.tokens) > 2
    assert rt.hit_limit == rj.hit_limit
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rt.token_logprobs, rj.token_logprobs, **tol)
    assert rt.no_speech_prob == pytest.approx(rj.no_speech_prob, rel=1e-4, abs=1e-6)
    n = len(rt.tokens)
    assert rt.attn_dev is None and rt.ts_logprobs_dev is None
    np.testing.assert_allclose(rt.attn, rj.attn, **tol)
    np.testing.assert_allclose(rt.ts_logprobs, rj.ts_logprobs, rtol=1e-4, atol=1e-4)
    assert (rt.eot_attn is None) == (rj.eot_attn is None)
    if rj.eot_attn is not None:
        np.testing.assert_allclose(rt.eot_attn, rj.eot_attn, **tol)
    rd = DecodeEngine(model, _tok()).decode_window(
        torch.from_numpy(mel), DecodingOptions(language="en", sample_len=40), prompt_tokens=prompt,
        fetch_alignment=False)[0]
    assert rd.attn is None and rd.tokens == rt.tokens
    np.testing.assert_array_equal(rd.attn_dev[0, :n].numpy(), rt.attn)


def _words(res):
    return [w for s in res["segments"] for w in s.get("words", [])]


# the alignment routes outside the batched device aligner, each against the
# JAX package's same route: (options of both calls, golden or None)
ROUTES = {
    "host": (dict(device_alignment=False), "efficient_greedy"),
    "host_disfluencies": (dict(device_alignment=False, detect_disfluencies=True), "disfluencies"),
    "whole_windows": (dict(trust_whisper_timestamps=False), "recompute_all_efficient"),
    "whole_windows_disfluencies": (dict(trust_whisper_timestamps=False, detect_disfluencies=True),
                                   None),
    "per_segment_kernels": (dict(device_alignment=True), None),
    "per_segment_kernels_disfluencies": (dict(device_alignment=True, detect_disfluencies=True),
                                         None),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_alignment_routes_match_jax(models, monkeypatch, route):
    """Each route, port against JAX: tokens identical, ``loose`` equal. The
    per-segment kernel route is what more alignment heads than ``MAX_K``
    take: both packages' ``MAX_K`` go to 2 here (JAX reads it at call time),
    below the model's 3 heads; the port must then call its per-segment cost
    kernel once per aligned segment (a segment whose words all drop is
    aligned but not returned)."""
    import whisper_timestamped_tpu.device_align as jax_device_align
    import whisper_timestamped_tpu_torch.alignment as port_alignment
    import whisper_timestamped_tpu_torch.api as port_api

    jax_model, model = models
    opts, golden = ROUTES[route]
    audio, kw = _kwargs("efficient_greedy")
    calls = []
    if route.startswith("per_segment"):
        monkeypatch.setattr(jax_device_align, "MAX_K", 2)
        monkeypatch.setattr(port_api, "MAX_K", 2)
        cost_fn = port_alignment._attention_to_cost_device
        monkeypatch.setattr(port_alignment, "_attention_to_cost_device",
                            lambda *a: calls.append(1) or cost_fn(*a))
    port = transcribe_timestamped(model, audio, tokenizer=_tok(), **opts, **kw)
    ref = jax_transcribe(jax_model, audio, tokenizer=make_tokenizer(), **opts, **kw)
    assert [s["tokens"] for s in port["segments"]] == [s["tokens"] for s in ref["segments"]]
    assert loose(port) == loose(ref)
    if golden is not None:
        with open(os.path.join(EXPECTED_DIR, golden + ".words.json"), encoding="utf-8") as f:
            assert loose(port) == loose(json.load(f))
    if route.startswith("per_segment"):
        assert len(calls) >= len(port["segments"]) > 0
    if route.startswith(("host", "per_segment")):
        assert _words(port)


@pytest.mark.parametrize("detect_disfluencies", [False, True])
def test_align_words_whole_windows_matches_jax(detect_disfluencies):
    """``trust_whisper_timestamps=False``'s whole-window alignment, port
    against JAX on the fabricated two-segment window of
    ``test_api.py::test_align_words_whole_windows_mechanism`` (the e2e
    goldens of this option pin 0 words): one DTW over the window, words back
    on their segments, equal words, times and confidences."""
    import types

    from whisper_timestamped_tpu.api import _align_words_whole_windows as jax_whole
    from whisper_timestamped_tpu.engine import Segment as JaxSegment
    from whisper_timestamped_tpu.engine import WindowDecodeResult as JaxWindow
    from whisper_timestamped_tpu_torch.api import _align_words_whole_windows
    from whisper_timestamped_tpu_torch.engine import Segment, WindowDecodeResult

    tok_t, tok_j = _tok(), make_tokenizer()
    ts = tok_t.timestamp_begin
    tokens = [ts] + tok_t.encode(" hello") + [ts + 50, ts + 50] + tok_t.encode(" world") + [ts + 100]
    assert tok_j.encode(" hello world") == tok_t.encode(" hello world")
    n = len(tokens)
    rng = np.random.default_rng(0)
    attn = (rng.standard_normal((n + 1, 3, 1500)) * 2).astype(np.float32)
    for i in range(n):
        attn[i, :, i * 10: i * 10 + 12] += 6.0
    attn[3, :, 60:66] += 6.0  # a second peak: a disfluency candidate
    b1 = 1 + len(tok_t.encode(" hello")) + 1
    out = []
    for Window, Seg, tok, kw in ((WindowDecodeResult, Segment, tok_t, {}),
                                 (JaxWindow, JaxSegment, tok_j, dict(eot_attn=attn[n]))):
        window = Window(tokens=tokens, text=tok.decode(tokens), avg_logprob=-0.3,
                        no_speech_prob=0.1, temperature=0.0, compression_ratio=1.0,
                        token_logprobs=np.full(n, -0.2, np.float32), attn=attn[:n],
                        hit_limit=False, n_text=n, **kw)
        if Window is WindowDecodeResult:
            window.eot_attn = attn[n]
        segs = [Seg(id=0, seek=100, start=1.0, end=2.0, text=" hello", tokens=tokens[:b1],
                    temperature=0.0, avg_logprob=-0.3, compression_ratio=1.0, no_speech_prob=0.1,
                    token_span=(0, b1), window=window),
                Seg(id=1, seek=100, start=2.0, end=3.0, text=" world", tokens=tokens[b1:],
                    temperature=0.0, avg_logprob=-0.3, compression_ratio=1.0, no_speech_prob=0.1,
                    token_span=(b1, n), window=window)]
        fn = _align_words_whole_windows if Window is WindowDecodeResult else jax_whole
        out.append(fn(types.SimpleNamespace(segments=segs), tok, use_space=True,
                      refine_whisper_precision_nframes=0, remove_punctuation_from_words=False,
                      compute_word_confidence=True, include_punctuation_in_confidence=False,
                      detect_disfluencies=detect_disfluencies))
    (words_t, segs_t), (words_j, segs_j) = out
    assert words_t == words_j and segs_t == segs_j
    assert [w["idx_segment"] for w in words_t if w["text"] != "[*]"] == [0, 1]


NOT_PORTED = {
    "vad": dict(vad="auditok"),
    "plot_word_alignment": dict(plot_word_alignment=True),
}


@pytest.mark.parametrize("option", sorted(NOT_PORTED))
def test_unported_options_raise(models, option):
    _, model = models
    with pytest.raises(NotImplementedError, match="not yet ported"):
        transcribe_timestamped(model, np.zeros(16000, np.float32), language="en",
                               tokenizer=_tok(), **NOT_PORTED[option])


@pytest.mark.parametrize("lever", ["kv_int8", "kv_int4", "self_kv_int8", "w_int8", "enc_int8", "mesh"])
def test_unported_engine_levers_raise(models, lever):
    """The engine options not yet ported raise. The KV-cache levers are
    ported now: the engine takes them (their decode is held to the JAX
    package in test_torch_quant.py)."""
    _, model = models
    if lever in ("kv_int8", "kv_int4", "self_kv_int8"):
        assert getattr(DecodeEngine(model, _tok(), **{lever: True}), lever)
        return
    with pytest.raises(NotImplementedError, match=lever):
        DecodeEngine(model, _tok(), **{lever: True if lever != "mesh" else object()})


def test_port_imports_without_jax():
    """A GPU host may have no JAX: the port must not import it, nor
    the JAX package (whose __init__ imports JAX), nor optax or orbax."""
    code = (
        "import sys; sys.modules['jax'] = sys.modules['optax'] = sys.modules['orbax'] = None\n"
        "import whisper_timestamped_tpu_torch.api, whisper_timestamped_tpu_torch.ops.kernels\n"
        "import whisper_timestamped_tpu_torch.training\n"
        "import whisper_timestamped_tpu_torch.engine_naive, whisper_timestamped_tpu_torch.backend_timestamps\n"
        "import whisper_timestamped_tpu_torch.ops.peaks, whisper_timestamped_tpu_torch.decoding_beam\n"
        "import whisper_timestamped_tpu_torch.normalizers, whisper_timestamped_tpu_torch as wtt\n"
        "wtt.decode, wtt.model, wtt.utils.get_writer, wtt.normalizers, wtt._download\n"
        "import whisper_timestamped_tpu_torch.parallel.batch, whisper_timestamped_tpu_torch.parallel.deviceflow\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and ("
        "m == 'whisper_timestamped_tpu' or m.startswith(('whisper_timestamped_tpu.', 'jax')))]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
