"""The port's batch pipeline with sampling: the temperature fallback
re-decode and best_of, against the JAX package's, in f32 on the CPU.

The model is the golden model of test_golden.py; both packages sample with
the same noise (test_torch_sampling.py's ``jax_noise``). The same seeds
(``rng_seed + 104729 * n_iter``, ``+ c0``, ``+ ti``) and the same padded
batch shapes must give the same tokens, and the results must be equal
under test_golden.py's ``loose`` rounding, on the device-aligner and host
routes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from model_utils import N_LANGS, hf_model_to_jax, make_hf_model, make_tokenizer  # noqa: E402
from test_golden import loose  # noqa: E402
from test_torch_sampling import jax_noise  # noqa: E402,F401
from whisper_timestamped_tpu.audio import N_FRAMES, pad_or_trim  # noqa: E402
from whisper_timestamped_tpu.audio import log_mel_spectrogram as jax_mel  # noqa: E402
from whisper_timestamped_tpu.decoding import DecodingOptions as JaxOptions  # noqa: E402
from whisper_timestamped_tpu.engine import DecodeEngine as JaxEngine  # noqa: E402
from whisper_timestamped_tpu.models.load import WhisperModel as JaxModel  # noqa: E402
from whisper_timestamped_tpu.parallel import batch as JB  # noqa: E402
from whisper_timestamped_tpu_torch.decoding import DecodingOptions  # noqa: E402
from whisper_timestamped_tpu_torch.engine import DecodeEngine, sequence_score  # noqa: E402
from whisper_timestamped_tpu_torch.models import WhisperDims, WhisperModel, params_from_jax_tree  # noqa: E402
from whisper_timestamped_tpu_torch.parallel import batch as B  # noqa: E402
from whisper_timestamped_tpu_torch.tokenizer import get_tokenizer, synthetic_ranks  # noqa: E402
from whisper_timestamped_tpu_torch.utils import profiling  # noqa: E402


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


def _jtok():
    return make_tokenizer(language="en", task="transcribe")


def _audio(seed, seconds):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(16000 * seconds)) * 0.1).astype(np.float32)


def _same(got, want, names):
    assert list(got) == list(want)
    for name in names:
        assert [s["tokens"] for s in got[name]["segments"]] == \
            [s["tokens"] for s in want[name]["segments"]], name
        assert loose(got[name]) == loose(want[name]), name


@pytest.mark.parametrize("route", ["device", "host"])
def test_default_schedule_redecodes_like_jax(models, jax_noise, route):  # noqa: F811
    """Streams of 7, 35 and 12 s with whisper's default schedule and
    thresholds: the random model fails them at every temperature below 1.0,
    so every window is decoded six times; the port returns JAX's result
    (it used to raise)."""
    jax_model, model = models
    audios = {"a": _audio(0, 7), "b": _audio(1, 35), "c": _audio(2, 12)}
    kw = dict(language="en", device_alignment=route == "device")
    profiling.reset_stage_timings()
    got = B.transcribe_batch(model, audios, _tok(), **kw)
    redecodes = profiling.get_counts().get("fallback_redecodes", 0)
    want = JB.transcribe_batch(jax_model, audios, _jtok(), **kw)
    _same(got, want, audios)
    assert {s["temperature"] for r in got.values() for s in r["segments"]} == {1.0}
    assert redecodes == 5 * 4  # four windows, five re-decodes each
    assert sum(len(s.get("words", [])) for r in got.values() for s in r["segments"]) > 0


@pytest.mark.parametrize("route", ["device", "host"])
def test_best_of_matches_jax(models, jax_noise, route):  # noqa: F811
    """``best_of=2`` at ``temperature=[0.7]`` (JAX ``tests/test_batch.py:242``):
    each row decoded twice in padded chunks, the best sample kept, equal
    to JAX's."""
    jax_model, model = models
    audios = {"a": _audio(0, 5), "b": _audio(1, 5), "c": _audio(2, 9)}
    kw = dict(language="en", temperature=[0.7], no_speech_threshold=None,
              logprob_threshold=None, batch_size=2, device_alignment=route == "device")
    got = B.transcribe_batch(model, audios, _tok(), decode_options=DecodingOptions(best_of=2),
                             **kw)
    want = JB.transcribe_batch(jax_model, audios, _jtok(), decode_options=JaxOptions(best_of=2),
                               **kw)
    _same(got, want, audios)
    assert {s["temperature"] for r in got.values() for s in r["segments"]} == {0.7}


def test_best_of_picks_max_score_like_jax(models, jax_noise):  # noqa: F811
    """``_decode_batch_best_of`` (JAX ``tests/test_batch.py:260``): the
    winner of each row is JAX's and has the best score of the row's
    samples, decoded by hand with the same chunks and seeds."""
    jax_model, model = models
    mel = pad_or_trim(np.asarray(jax_mel(_audio(9, 4), n_mels=80)), N_FRAMES, axis=-1)
    mels = np.stack([mel, mel * 0.5])
    bt = B.BatchTranscriber(DecodeEngine(model, _tok()), batch_size=2)
    jbt = JB.BatchTranscriber(JaxEngine(jax_model, _jtok()), batch_size=2)
    winners = bt._decode_batch_best_of(torch.from_numpy(mels), [[], []],
                                       DecodingOptions(language="en", best_of=4), 0.8, 123, None)
    want = jbt._decode_batch_best_of(mels, [[], []], JaxOptions(language="en", best_of=4), 0.8,
                                     123, None)
    assert [w.tokens for w in winners] == [w.tokens for w in want]
    scores = {0: [], 1: []}
    rep_idx = [i for i in range(2) for _ in range(4)]
    for c0 in range(0, len(rep_idx), 2):
        chunk = rep_idx[c0 : c0 + 2]
        rs = bt._decode_batch(torch.from_numpy(mels[chunk]), [[]] * 2,
                              DecodingOptions(language="en"), 0.8, 123 + c0, None)
        for k, i in enumerate(chunk):
            scores[i].append(sequence_score(rs[k], None))
    for i in range(2):
        assert sequence_score(winners[i], None) == pytest.approx(max(scores[i]))
        assert len(set(scores[i])) > 1


def test_failing_subset_is_padded_like_jax(models, jax_noise):  # noqa: F811
    """``batch_size=2`` where one window of the pair fails: the 35-s
    stream's first window is too repetitive (compression ratio 15 > 10), the
    4-s stream's is not (4.8). The re-decode runs one failing row padded to
    the batch with row 0, so its draw has JAX's (2, V) shape."""
    jax_model, model = models
    audios = {"long": _audio(2, 35), "short": _audio(3, 4)}
    kw = dict(language="en", temperature=[0.0, 0.2, 0.4], compression_ratio_threshold=10.0,
              logprob_threshold=None, no_speech_threshold=None, batch_size=2)
    profiling.reset_stage_timings()
    got = B.transcribe_batch(model, audios, _tok(), device_alignment=True, **kw)
    assert profiling.get_counts()["fallback_redecodes"] >= 1
    want = JB.transcribe_batch(jax_model, audios, _jtok(), device_alignment=True, **kw)
    _same(got, want, audios)
    assert got["short"]["segments"][0]["temperature"] == 0.0
    assert got["long"]["segments"][0]["temperature"] > 0.0
