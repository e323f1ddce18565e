"""The port's sampler and temperature fallback against the JAX package's.

The port draws its Gumbel noise from ``decoding.make_gumbel_source``; the
tests put ``jax_gumbel_source`` in its place, which replays the draws that
``jax.random.categorical`` adds inside the JAX decode loop (``key =
PRNGKey(seed)``, then at each executed step ``key, sub = split(key)`` and
``gumbel(sub, (B, V), float32)``). With the same noise the two packages
must pick the same tokens: the sampling rule (``sample_tokens``), one
window's decode, the fallback schedule, and the goldens
``temperature_sampling`` and ``temperature_fallback`` end to end (f32 on
the CPU, the golden model of test_golden.py). Other test files import
``jax_gumbel_source`` and the ``jax_noise`` fixture from here.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from model_utils import N_LANGS, N_VOCAB, hf_model_to_jax, make_hf_model, make_tokenizer  # noqa: E402
from test_golden import CONFIGS, EXPECTED_DIR, _audio, loose  # noqa: E402
from whisper_timestamped_tpu.api import transcribe_timestamped as jax_transcribe  # noqa: E402
from whisper_timestamped_tpu.decoding import DecodingOptions as JaxOptions  # noqa: E402
from whisper_timestamped_tpu.engine import DecodeEngine as JaxEngine  # noqa: E402
from whisper_timestamped_tpu.models.load import WhisperModel as JaxModel  # noqa: E402
from whisper_timestamped_tpu_torch import decoding  # noqa: E402
from whisper_timestamped_tpu_torch import transcribe_timestamped  # noqa: E402
from whisper_timestamped_tpu_torch.decoding import (  # noqa: E402
    DecodingOptions,
    make_gumbel_source,
    sample_tokens,
    temperature_divisor,
)
from whisper_timestamped_tpu_torch.engine import DecodeEngine  # noqa: E402
from whisper_timestamped_tpu_torch.models import WhisperDims, WhisperModel, params_from_jax_tree  # noqa: E402
from whisper_timestamped_tpu_torch.tokenizer import get_tokenizer, synthetic_ranks  # noqa: E402


def jax_gumbel_source(seed, device):
    """``make_gumbel_source``'s contract, fed with the JAX decode loop's
    draws for ``PRNGKey(seed)``: one split a call."""
    key = [jax.random.PRNGKey(int(seed))]

    def draw(B, V):
        key[0], sub = jax.random.split(key[0])
        return torch.from_numpy(np.array(jax.random.gumbel(sub, (B, V), jnp.float32))).to(device)

    return draw


@pytest.fixture
def jax_noise(monkeypatch):
    """The port samples with the JAX package's noise for this test."""
    monkeypatch.setattr(decoding, "make_gumbel_source", jax_gumbel_source)


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
    return get_tokenizer(ranks=synthetic_ranks(), multilingual=True, num_languages=N_LANGS)


def _masked_logits(seed, B, V):
    """Seeded logits with -inf columns: a shared block and a per-row set."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 3.0).astype(np.float32)
    logits[:, 50:400] = -np.inf
    logits[rng.random((B, V)) < 0.3] = -np.inf
    return logits


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("T", [0.2, 0.7, 1.0, 1e-7])
def test_sample_tokens_matches_jax_categorical(B, T):
    """The port's rule with JAX's draws picks ``jax.random.categorical``'s
    token on ``logits / max(T, 1e-6)``, step after step, and never a
    -inf column."""
    draw = jax_gumbel_source(5, "cpu")
    key = jax.random.PRNGKey(5)
    t_div = temperature_divisor(T, "cpu")
    for step in range(4):
        logits = _masked_logits(100 * step + B, B, N_VOCAB)
        got = sample_tokens(torch.from_numpy(logits), t_div, draw).numpy()
        key, sub = jax.random.split(key)
        want = np.asarray(jax.random.categorical(
            sub, jnp.asarray(logits) / jnp.maximum(jnp.float32(T), 1e-6), axis=-1))
        np.testing.assert_array_equal(got, want)
        assert np.isfinite(logits[np.arange(B), got]).all()


def test_torch_source_is_seeded():
    """Same seed, same draws; another seed, other draws; each draw is a
    new step."""
    a, b, c = (make_gumbel_source(s, "cpu") for s in (3, 3, 4))
    a1, b1, c1 = a(4, 1000), b(4, 1000), c(4, 1000)
    torch.testing.assert_close(a1, b1, rtol=0, atol=0)
    assert not torch.equal(a1, c1)
    assert not torch.equal(a(4, 1000), a1)
    assert a1.dtype == torch.float32 and torch.isfinite(a1).all()


@pytest.mark.parametrize("T", [0.2, 1.0])
def test_torch_source_samples_the_softmax(T):
    """Drawn 20000 times from a fixed seed, each row's token frequencies lie
    within 5 standard errors of softmax(logits / T) on its 16 likeliest
    tokens, and no -inf column is drawn. The 16 likeliest logits lie within
    0.3 of each other and the rest far below, so each of the 16 is drawn
    often enough at both temperatures for the normal approximation."""
    n, V = 20000, 200
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((3, V)) - 4.0).astype(np.float32)
    logits[rng.random((3, V)) < 0.2] = -np.inf
    for r in range(3):
        top = rng.choice(np.flatnonzero(np.isfinite(logits[r])), 16, replace=False)
        logits[r, top] = np.linspace(0.0, 0.3, 16)
    draw = make_gumbel_source(11, "cpu")
    t_div = temperature_divisor(T, "cpu")
    x = torch.from_numpy(logits)
    counts = np.zeros(logits.shape)
    for _ in range(n // 500):
        tok = sample_tokens(x.repeat(500, 1), t_div, draw).numpy().reshape(500, 3)
        for r in range(3):
            counts[r] += np.bincount(tok[:, r], minlength=V)
    p = torch.softmax(x / T, dim=-1).double().numpy()
    assert counts[~np.isfinite(logits)].sum() == 0
    for r in range(3):
        top = np.argsort(-p[r])[:16]
        se = np.sqrt(p[r, top] * (1 - p[r, top]) / n)
        assert (np.abs(counts[r, top] / n - p[r, top]) <= 5 * se).all()


def test_decode_window_sampled_matches_jax(models, jax_noise):
    """One window at temperature 0.8, rng_seed 1 (``tests/test_decoding.py:67``):
    tokens equal, token log-probs and the no-speech probability within
    1e-5."""
    jax_model, model = models
    mel = (np.random.default_rng(0).standard_normal((80, 3000)) * 0.4).astype(np.float32)
    rj = JaxEngine(jax_model, make_tokenizer()).decode_window(
        mel, JaxOptions(language="en"), temperature=0.8, rng_seed=1)[0]
    rt = DecodeEngine(model, _tok()).decode_window(
        torch.from_numpy(mel), DecodingOptions(language="en"), temperature=0.8, rng_seed=1)[0]
    assert rt.tokens == rj.tokens and len(rt.tokens) > 2
    np.testing.assert_allclose(rt.token_logprobs, rj.token_logprobs, rtol=0, atol=1e-5)
    assert rt.no_speech_prob == pytest.approx(rj.no_speech_prob, abs=1e-5)
    greedy = DecodeEngine(model, _tok()).decode_window(
        torch.from_numpy(mel), DecodingOptions(language="en"))[0]
    assert greedy.tokens != rt.tokens


def test_decode_with_fallback_stops_where_jax_does(models, jax_noise):
    """Greedy output of the random model is too repetitive (compression
    ratio 4.8 > 2.4) and its sample at 0.2 is not: both packages stop at
    0.2 with the same tokens; the best_of form (3 samples) too."""
    jax_model, model = models
    mel = (np.random.default_rng(0).standard_normal((80, 3000)) * 0.4).astype(np.float32)
    thresholds = (2.4, None, None)
    out = []
    for best_of in (None, 3):
        rj = JaxEngine(jax_model, make_tokenizer()).decode_with_fallback(
            mel, JaxOptions(language="en", best_of=best_of), [], (0.0, 0.2, 0.4), *thresholds,
            rng_seed=9)
        rt = DecodeEngine(model, _tok()).decode_with_fallback(
            torch.from_numpy(mel), DecodingOptions(language="en", best_of=best_of), [],
            (0.0, 0.2, 0.4), *thresholds, rng_seed=9)
        assert rt.temperature == rj.temperature == 0.2
        assert rt.tokens == rj.tokens
        assert rt.compression_ratio <= 2.4
        out.append(rt.tokens)
    assert out[0] != out[1]


def _golden(model, name, **route):
    opts = dict(CONFIGS[name])
    seed, seconds = opts.pop("_audio", (7, 7))
    kwargs = dict(tokenizer=_tok(), no_speech_threshold=None, logprob_threshold=None,
                  compression_ratio_threshold=None)
    kwargs.update(opts)
    result = transcribe_timestamped(model, _audio(seed, seconds), **route, **kwargs)
    with open(os.path.join(EXPECTED_DIR, name + ".words.json"), encoding="utf-8") as f:
        assert loose(result) == loose(json.load(f))
    return result


@pytest.mark.parametrize("name", ["temperature_sampling", "temperature_fallback"])
@pytest.mark.parametrize("route", ["device", "host"])
def test_sampling_goldens(models, jax_noise, name, route):
    """The goldens under ``loose``: through the device aligner's plain
    versions and through the host route, as test_torch_golden.py runs the
    greedy ones. ``temperature_fallback``'s windows all end at 0.2."""
    _, model = models
    result = _golden(model, name, **(dict(device_alignment=True) if route == "device" else {}))
    temps = {s["temperature"] for s in result["segments"]}
    assert temps == ({0.7} if name == "temperature_sampling" else {0.2})
    assert sum(len(s.get("words", [])) for s in result["segments"]) > 0


@pytest.mark.parametrize("option", ["temperature", "fallback"])
def test_sampling_options_match_jax(models, jax_noise, option):
    """What ``test_unported_options_raise`` refused before: a temperature
    and a fallback schedule, each equal to the JAX package's result (the
    segment tokens exactly, the rest under ``loose``)."""
    jax_model, model = models
    kw = dict(language="en", no_speech_threshold=None, logprob_threshold=None,
              compression_ratio_threshold=2.4, seed=3)
    kw.update(dict(temperature=0.7) if option == "temperature" else dict(temperature=[0.0, 0.2]))
    audio = _audio(8, 12)
    port = transcribe_timestamped(model, audio, tokenizer=_tok(), **kw)
    ref = jax_transcribe(jax_model, audio, tokenizer=make_tokenizer(), **kw)
    assert [s["tokens"] for s in port["segments"]] == [s["tokens"] for s in ref["segments"]]
    assert loose(port) == loose(ref)
    assert all(s["temperature"] > 0 for s in port["segments"])
