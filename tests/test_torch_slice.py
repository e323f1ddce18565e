"""The port's ``transcribe_timestamped`` against the JAX package's, end to end.

Same synthetic model (the golden model of test_golden.py, its weights
converted by ``params_from_jax_tree``), same audio, f32 on the CPU. The port
runs its device-alignment path with the kernels' plain versions; the JAX
package runs ``device_alignment=True`` (its Pallas kernels in interpret
mode). Tokens must be identical, and the result equal to both JAX's and the
stored golden under test_golden.py's ``loose`` rounding.
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
    module = params_from_jax_tree(params, WhisperDims(**dims.__dict__))
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


@pytest.mark.parametrize("name", ["efficient_greedy", "autodetect_language", "long_conditioned"])
def test_slice_matches_jax_and_golden(models, name):
    jax_model, model = models
    audio, kw = _kwargs(name)
    port = _norm(transcribe_timestamped(model, audio, tokenizer=_tok(), **kw))
    ref = _norm(jax_transcribe(jax_model, audio, tokenizer=make_tokenizer(),
                               device_alignment=True, **kw))
    assert [s["tokens"] for s in port["segments"]] == [s["tokens"] for s in ref["segments"]]
    assert loose(port) == loose(ref)
    with open(os.path.join(EXPECTED_DIR, name + ".words.json"), encoding="utf-8") as f:
        assert loose(port) == loose(json.load(f))
    assert sum(len(s.get("words", [])) for s in port["segments"]) > 0


def test_decode_window_buffers_match_jax(models):
    """One window with a carried prompt (232-slot region): tokens equal,
    log-probs, timestamp log-probs and alignment rows allclose."""
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
    np.testing.assert_allclose(rt.attn_dev[0, :n].numpy(), rj.attn, **tol)
    np.testing.assert_allclose(rt.ts_logprobs_dev[0, :n].numpy(), rj.ts_logprobs, rtol=1e-4, atol=1e-4)


NOT_PORTED = {
    "temperature": dict(temperature=0.7),
    "fallback": dict(temperature=[0.0, 0.2]),
    "best_of": dict(best_of=2),
    "beam_size": dict(beam_size=3),
    "naive_approach": dict(naive_approach=True),
    "vad": dict(vad="auditok"),
    "detect_disfluencies": dict(detect_disfluencies=True),
    "trust_whisper_timestamps": dict(trust_whisper_timestamps=False),
    "plot_word_alignment": dict(plot_word_alignment=True),
    "use_backend_timestamps": dict(use_backend_timestamps=True),
    "host_alignment": dict(device_alignment=False),
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
    the JAX package (whose __init__ imports JAX)."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import whisper_timestamped_tpu_torch.api, whisper_timestamped_tpu_torch.ops.kernels\n"
        "import whisper_timestamped_tpu_torch.parallel.batch, whisper_timestamped_tpu_torch.parallel.deviceflow\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and ("
        "m == 'whisper_timestamped_tpu' or m.startswith(('whisper_timestamped_tpu.', 'jax')))]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
