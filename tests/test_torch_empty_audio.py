"""Empty and very short audio: the port against the JAX package on the CPU.

The reference accepts empty input (its ``tests/data/empty.mp3``), and the
JAX package returns ``{'text': '', 'segments': [], 'language': ...}`` for
it, with the detected language and its probabilities when ``language`` is
None. A signal of at most 200 samples (half the 400-sample window) is
reflected again at its far end by ``jnp.pad``, which gives one frame.
Same synthetic model and seeded inputs for both packages; results equal
under test_golden.py's ``loose`` rounding, the mel within 1e-4 (f32 sums
in another order, as ``test_torch_frontend.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from model_utils import N_LANGS, hf_model_to_jax, make_hf_model, make_tokenizer  # noqa: E402
from test_golden import loose  # noqa: E402
import whisper_timestamped_tpu.parallel.batch as JB  # noqa: E402
from whisper_timestamped_tpu.api import transcribe_timestamped as jax_transcribe  # noqa: E402
from whisper_timestamped_tpu.audio import log_mel_spectrogram as jax_log_mel  # noqa: E402
from whisper_timestamped_tpu.models.load import WhisperModel as JaxModel  # noqa: E402
import whisper_timestamped_tpu_torch.parallel.batch as B  # noqa: E402
from whisper_timestamped_tpu_torch import transcribe_timestamped  # noqa: E402
from whisper_timestamped_tpu_torch.audio import log_mel_spectrogram  # noqa: E402
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
OPTS = dict(no_speech_threshold=None, logprob_threshold=None, compression_ratio_threshold=None)
EMPTY = np.zeros(0, np.float32)


@pytest.fixture(scope="module")
def models():
    params, dims = hf_model_to_jax(make_hf_model(seed=0))
    jax_model = JaxModel(params=jax.tree.map(jnp.asarray, params), dims=dims,
                         alignment_heads=HEADS)
    module = params_from_jax_tree(params, WhisperDims(**dims.__dict__), device="cpu")
    return jax_model, WhisperModel(module=module, alignment_heads=HEADS)


def _tok(language="en"):
    return get_tokenizer(ranks=synthetic_ranks(), multilingual=True, num_languages=N_LANGS,
                         language=language, task="transcribe" if language else None)


def _speech(seed, seconds):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(16000 * seconds)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("language", ["en", None])
def test_transcribe_empty_matches_jax(models, language):
    jax_model, model = models
    got = transcribe_timestamped(model, EMPTY, tokenizer=_tok(language), language=language, **OPTS)
    want = jax_transcribe(jax_model, EMPTY, tokenizer=make_tokenizer(), language=language, **OPTS)
    assert got["text"] == "" and got["segments"] == []
    assert ("language_probs" in got) == (language is None)
    assert loose(got) == loose(want)


BATCHES = {
    "one_empty": {"a": _speech(0, 5), "e": EMPTY, "b": _speech(1, 3)},
    "all_empty": {"e": EMPTY, "f": EMPTY},
}


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_transcribe_batch_with_empty_streams_matches_jax(models, case):
    jax_model, model = models
    audios = BATCHES[case]
    kw = dict(language="en", batch_size=4, temperature=[0.0], **OPTS)
    got = B.transcribe_batch(model, audios, _tok(), **kw)
    want = JB.transcribe_batch(jax_model, audios, make_tokenizer(language="en", task="transcribe"),
                               **kw)
    assert list(got) == list(want) == list(audios)
    for name in audios:
        assert [s["tokens"] for s in got[name]["segments"]] == \
            [s["tokens"] for s in want[name]["segments"]], name
        assert loose(got[name]) == loose(want[name]), name
    for name in ("e", "f"):
        if name in audios:
            assert got[name]["text"] == "" and got[name]["segments"] == []


@pytest.mark.parametrize("n", [160, 180, 200, 201])
@pytest.mark.parametrize("pcm", [False, True])
def test_log_mel_short_audio_matches_jax(n, pcm):
    """At most 200 samples: the reflection folds back (one frame, as JAX);
    201 is the first length ``F.pad``'s reflect takes as it is."""
    rng = np.random.default_rng(n)
    audio = (rng.standard_normal(n) * 0.1).astype(np.float32)
    if pcm:
        audio = np.round(audio * 32768).clip(-32768, 32767).astype(np.int16)
    ref = np.asarray(jax_log_mel(jnp.asarray(audio), n_mels=80, padding=0))
    ours = log_mel_spectrogram(torch.as_tensor(audio), n_mels=80, padding=0)
    assert ours.shape == ref.shape == (80, n // 160)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-4)


def test_log_mel_empty_with_padding_matches_jax():
    """0 samples and 30 s of padding, what ``transcribe_timestamped`` hands
    the front end for empty input: 3000 frames of silence."""
    ref = np.asarray(jax_log_mel(jnp.asarray(EMPTY), n_mels=80, padding=480000))
    ours = log_mel_spectrogram(torch.as_tensor(EMPTY), n_mels=80, padding=480000)
    assert ours.shape == ref.shape == (80, 3000)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-4)
