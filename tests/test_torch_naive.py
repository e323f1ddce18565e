"""The port's two-pass engine (``engine_naive.py``, ``backend_timestamps.py``)
against the JAX package's, in f32 on the CPU.

The model is the golden model of test_golden.py, its weights converted by
``params_from_jax_tree``; sampled configurations draw JAX's noise
(test_torch_sampling.py's ``jax_noise``). End to end: the goldens
``naive``, ``best_of2``, ``recompute_all`` and ``beam3`` and ``use_backend_timestamps``,
each also against the JAX package's same call. Below that: the
teacher-forced forward, its batched driver, ``decode_full``'s
alignment-head rows and the backend-timestamp functions.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from model_utils import N_LANGS, hf_model_to_jax, make_hf_model, make_tokenizer  # noqa: E402
from test_golden import CONFIGS, EXPECTED_DIR, _audio, loose  # noqa: E402
from test_torch_sampling import jax_noise  # noqa: E402,F401
from whisper_timestamped_tpu import backend_timestamps as JBT  # noqa: E402
from whisper_timestamped_tpu import engine_naive as JN  # noqa: E402
from whisper_timestamped_tpu.api import transcribe_timestamped as jax_transcribe  # noqa: E402
from whisper_timestamped_tpu.engine import DecodeEngine as JaxEngine  # noqa: E402
from whisper_timestamped_tpu.models.load import WhisperModel as JaxModel  # noqa: E402
from whisper_timestamped_tpu_torch import backend_timestamps as BT  # noqa: E402
from whisper_timestamped_tpu_torch import engine_naive as N  # noqa: E402
from whisper_timestamped_tpu_torch import transcribe_timestamped  # noqa: E402
from whisper_timestamped_tpu_torch.engine import DecodeEngine, transcribe_windows  # noqa: E402
from whisper_timestamped_tpu_torch.models import WhisperDims, WhisperModel, params_from_jax_tree  # noqa: E402
from whisper_timestamped_tpu_torch.models.whisper_torch import decode_full, encode  # noqa: E402
from whisper_timestamped_tpu_torch.tokenizer import get_tokenizer, synthetic_ranks  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HEADS = [(0, 1), (1, 0), (1, 2)]


@pytest.fixture(scope="module")
def models():
    params, dims = hf_model_to_jax(make_hf_model(seed=0))
    jax_model = JaxModel(params=jax.tree.map(jnp.asarray, params), dims=dims,
                         alignment_heads=HEADS)
    module = params_from_jax_tree(params, WhisperDims(**dims.__dict__), device="cpu")
    return jax_model, WhisperModel(module=module, alignment_heads=HEADS)


def _tok():
    return get_tokenizer(ranks=synthetic_ranks(), multilingual=True, num_languages=N_LANGS,
                         language="en", task="transcribe")


def _kwargs(name):
    opts = dict(CONFIGS[name])
    seed, seconds = opts.pop("_audio", (7, 7))
    kw = dict(no_speech_threshold=None, logprob_threshold=None,
              compression_ratio_threshold=None)
    kw.update(opts)
    return _audio(seed, seconds), kw


def _words(res):
    return [w for s in res["segments"] for w in s.get("words", [])]


@pytest.mark.parametrize("name", ["naive", "best_of2", "recompute_all", "beam3"])
@pytest.mark.parametrize("route", ["device", "host"])
def test_two_pass_goldens_match_jax(models, jax_noise, name, route):  # noqa: F811
    """The golden under ``loose``, and the JAX package's same call: segment
    tokens identical, results equal under ``loose``. ``device_alignment``
    is passed to both packages on the device route; the two-pass engine
    aligns on the host either way, as in JAX. (``recompute_all`` pins 0
    words: the synthetic tokenizer's random decode has no word to give.)
    ``beam3`` is beam search (K=3), which takes the two-pass engine."""
    jax_model, model = models
    audio, kw = _kwargs(name)
    if route == "device":
        kw["device_alignment"] = True
    port = transcribe_timestamped(model, audio, tokenizer=_tok(), **kw)
    ref = jax_transcribe(jax_model, audio, tokenizer=make_tokenizer(), **kw)
    assert [s["tokens"] for s in port["segments"]] == [s["tokens"] for s in ref["segments"]]
    assert loose(port) == loose(ref)
    with open(os.path.join(EXPECTED_DIR, name + ".words.json"), encoding="utf-8") as f:
        assert loose(port) == loose(json.load(f))
    if name != "recompute_all":
        assert _words(port)


@pytest.mark.parametrize("option", ["naive_approach", "best_of", "use_backend_timestamps",
                                    "beam_size"])
def test_two_pass_options_match_jax(models, jax_noise, option, capsys):  # noqa: F811
    """What ``test_unported_options_raise`` refused before, on a 35-s
    stream (two windows) with ``verbose``: each option's result equal to
    the JAX package's (tokens exactly, the rest under ``loose``), and the
    same stdout (the two-pass engine prints each word as it aligns it).
    ``use_backend_timestamps`` (``tests/test_api.py:291``) gives words
    without confidence. ``beam_size`` runs beam search in the first pass."""
    jax_model, model = models
    kw = dict(language=None, no_speech_threshold=None, logprob_threshold=None,
              compression_ratio_threshold=None, verbose=True, seed=5,
              **{"naive_approach": dict(naive_approach=True),
                 "best_of": dict(best_of=2, temperature=0.5),
                 "use_backend_timestamps": dict(use_backend_timestamps=True),
                 "beam_size": dict(beam_size=2, sample_len=32)}[option])
    audio = _audio(8, 35)
    port = transcribe_timestamped(model, audio, tokenizer=get_tokenizer(
        ranks=synthetic_ranks(), multilingual=True, num_languages=N_LANGS), **kw)
    out_port = capsys.readouterr().out
    ref = jax_transcribe(jax_model, audio, tokenizer=make_tokenizer(), **kw)
    out_ref = capsys.readouterr().out
    assert [s["tokens"] for s in port["segments"]] == [s["tokens"] for s in ref["segments"]]
    assert len({s["seek"] for s in port["segments"]}) == 2
    assert loose(port) == loose(ref)
    assert out_port == out_ref and "Detected language" in out_port
    words = _words(port)
    assert words
    if option == "use_backend_timestamps":
        assert all("confidence" not in w for w in words)


def _requests(dims, lens, seed=3):
    rng = np.random.default_rng(seed)
    tok = _tok()
    reqs = []
    for n in lens:
        mel = (rng.standard_normal((dims.n_mels, 3000)) * 0.5).astype(np.float32)
        toks = [tok.sot, tok.to_language_token("en"), tok.transcribe, tok.timestamp_begin]
        toks += rng.integers(300, 1000, n - len(toks)).tolist()
        reqs.append((mel, toks))
    return reqs


@pytest.mark.parametrize("lens", [(10, 21, 32), (33, 12, 64)], ids=["bucket32", "bucket64"])
def test_teacher_forced_batch_matches_jax(models, lens):
    """The batched teacher-forced forward against
    ``_teacher_forced_batch_jit`` (through JAX's ``_teacher_forced_batch``):
    log-probs and alignment rows within 1e-4, each request cut to its own
    length; the serial ``_teacher_forced`` gives each request the same."""
    jax_model, model = models
    reqs = _requests(model.dims, lens)
    want = JN._teacher_forced_batch(JaxEngine(jax_model, make_tokenizer()), reqs)
    engine = DecodeEngine(model, _tok())
    got = N._teacher_forced_batch(engine, [(torch.from_numpy(m), t) for m, t in reqs])
    for (lp, rows), (lp_j, rows_j), n, (m, t) in zip(got, want, lens, reqs):
        assert lp.shape == (n, model.dims.n_vocab) and rows.shape == (n, len(HEADS), 1500)
        np.testing.assert_allclose(lp, lp_j, rtol=0, atol=1e-4)
        np.testing.assert_allclose(rows, rows_j, rtol=0, atol=1e-4)
        lp_s, rows_s = N._teacher_forced(engine, torch.from_numpy(m), t)
        np.testing.assert_allclose(lp_s, lp, rtol=0, atol=1e-4)
        np.testing.assert_allclose(rows_s, rows, rtol=0, atol=1e-4)


def test_drive_teacher_forced_batch_equals_serial(models):
    """Three streams' pass-2 generators driven in lock-step in batches of 2
    give each stream the serial driver's words."""
    _, model = models
    engine = DecodeEngine(model, _tok())
    audios = {"a": _audio(0, 8), "b": _audio(1, 35), "c": _audio(2, 5)}
    kw = dict(language="en", use_space=True, trust_whisper_timestamps=True,
              refine_whisper_precision_nframes=25, remove_punctuation_from_words=False,
              compute_word_confidence=True, include_punctuation_in_confidence=False,
              detect_disfluencies=False, verbose=False)

    def gens():
        out = {}
        for name, audio in audios.items():
            res = transcribe_windows(engine, audio, language="en", temperature=[0.0],
                                     compression_ratio_threshold=None, logprob_threshold=None,
                                     no_speech_threshold=None, fetch_alignment=False,
                                     capture_attention=False)
            segs = [s.to_dict() for s in res.segments]
            out[name] = N.naive_word_requests(engine, audio, res, segs, **kw)
        return out

    serial = {name: N.drive_teacher_forced_serial(g, engine) for name, g in gens().items()}
    batched = N.drive_teacher_forced_batch(engine, gens(), batch_size=2)
    assert set(batched) == set(audios)
    for name in audios:
        assert serial[name]
        assert [w["text"] for w in batched[name]] == [w["text"] for w in serial[name]]
        assert loose(batched[name]) == loose(serial[name])


def test_first_pass_keeps_no_attention(models):
    """Without backend timestamps pass 1 keeps no alignment rows: the
    windows carry neither host nor device attention."""
    _, model = models
    res = transcribe_windows(DecodeEngine(model, _tok()), _audio(0, 8), language="en",
                             temperature=[0.0], compression_ratio_threshold=None,
                             logprob_threshold=None, no_speech_threshold=None,
                             fetch_alignment=False, capture_attention=False)
    assert res.segments
    for seg in res.segments:
        w = seg.window
        assert w.attn is None and w.attn_dev is None and w.ts_logprobs_dev is None


def test_decode_full_align_heads_select_the_stack(models):
    """``decode_full(align_heads=...)`` returns the rows that the full
    (L, B, H, S, T) stack holds at those heads, and the same logits."""
    _, model = models
    module = model.module
    rng = np.random.default_rng(4)
    mel = torch.from_numpy((rng.standard_normal((2, 80, 3000)) * 0.5).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, model.dims.n_vocab, (2, 9)))
    heads = [(1, 2), (0, 1), (1, 0), (0, 1)]
    with torch.no_grad():
        xa = encode(module, mel)
        lf, ws = decode_full(module, tokens, xa, return_cross_attn=True)
        la, rows = decode_full(module, tokens, xa, align_heads=heads)
    assert rows.shape == (2, len(heads), 9, xa.shape[1])
    torch.testing.assert_close(la, lf, rtol=0, atol=0)
    want = torch.stack([ws[l, :, h] for l, h in heads], dim=1)
    torch.testing.assert_close(rows, want, rtol=0, atol=0)


def test_backend_timestamp_functions_match_jax():
    """The copied backend-timestamp functions against the JAX package's on
    seeded matrices: equal to 1e-6."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 17, 40))
    for width in (7, 9):
        np.testing.assert_allclose(BT._median_filter_reflect(x, width),
                                   JBT._median_filter_reflect(x, width), rtol=0, atol=1e-6)
    for n, m in ((12, 60), (1, 5), (30, 30)):
        cost = rng.standard_normal((n, m))
        for a, b in zip(BT._dtw_hf(cost), JBT._dtw_hf(cost)):
            np.testing.assert_array_equal(a, b)
    scores = (rng.standard_normal((14, 3, 1500)) * 2).astype(np.float32)
    for i in range(14):
        scores[i, :, 40 * i: 40 * i + 30] += 5.0
    for frames in (None, 1200):
        np.testing.assert_allclose(BT.hf_token_timestamps(scores, frames),
                                   JBT.hf_token_timestamps(scores, frames), rtol=0, atol=1e-6)
    tok_t, tok_j = _tok(), make_tokenizer()
    ts = tok_t.timestamp_begin
    tokens = [ts] + tok_t.encode(" hello there") + [ts + 60, ts + 60] + tok_t.encode(" world") \
        + [ts + 120]
    times = BT.hf_token_timestamps(scores[: len(tokens)])
    b1 = 1 + len(tok_t.encode(" hello there")) + 1
    spans = [(0, (0, b1)), (1, (b1, len(tokens)))]
    for use_space in (True, False):
        kw = dict(use_space=use_space, remove_punctuation_from_words=False, time_offset=12.0)
        got = BT.backend_words_for_window(tokens, times, spans, tok_t, **kw)
        want = JBT.backend_words_for_window(tokens, times, spans, tok_j, **kw)
        assert got == want and got
