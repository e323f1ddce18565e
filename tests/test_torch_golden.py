"""The port's ``transcribe_timestamped`` against the stored goldens of the
greedy configurations of test_golden.py (same model, audio and options; f32
on the CPU), under test_golden.py's ``loose`` rounding: once through the
device aligner's plain versions (``device_alignment=True``), once through
the host route that ``device_alignment=None`` takes on a CPU model. The
configurations that are also run against the JAX package live in
test_torch_slice.py."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from model_utils import N_LANGS, hf_model_to_jax, make_hf_model  # noqa: E402
from test_golden import CONFIGS, EXPECTED_DIR, _audio, loose  # noqa: E402
from whisper_timestamped_tpu_torch import transcribe_timestamped  # noqa: E402
from whisper_timestamped_tpu_torch.models import WhisperDims, WhisperModel, params_from_jax_tree  # noqa: E402
from whisper_timestamped_tpu_torch.tokenizer import get_tokenizer, synthetic_ranks  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GREEDY = ["condition_off", "confidence_punct", "initial_prompt", "monolingual_en",
          "no_refine", "no_speech_skip_all", "punctuation_stripped", "stuck_lm",
          "translate_task", "unspaced_ja"]


@pytest.fixture(scope="module")
def model():
    params, dims = hf_model_to_jax(make_hf_model(seed=0))
    module = params_from_jax_tree(params, WhisperDims(**dims.__dict__), device="cpu")
    return WhisperModel(module=module, alignment_heads=[(0, 1), (1, 0), (1, 2)])


def _check_golden(model, name, **route):
    opts = dict(CONFIGS[name])
    seed, seconds = opts.pop("_audio", (7, 7))
    tok_kw = opts.pop("_tok", {})
    tok = get_tokenizer(ranks=synthetic_ranks(), num_languages=N_LANGS,
                        multilingual=tok_kw.get("multilingual", True))
    kwargs = dict(tokenizer=tok, no_speech_threshold=None, logprob_threshold=None,
                  compression_ratio_threshold=None)
    kwargs.update(opts)
    result = transcribe_timestamped(model, _audio(seed, seconds), **route, **kwargs)
    if "language_probs" in result:
        result = {**result, "language_probs": loose(result["language_probs"])}
    with open(os.path.join(EXPECTED_DIR, name + ".words.json"), encoding="utf-8") as f:
        assert loose(result) == loose(json.load(f))


@pytest.mark.parametrize("name", GREEDY)
def test_port_matches_golden(model, name):
    _check_golden(model, name, device_alignment=True)


@pytest.mark.parametrize("name", GREEDY)
def test_port_host_route_matches_golden(model, name):
    _check_golden(model, name)
