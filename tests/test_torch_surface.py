"""The port's drop-in import surface against the JAX package's.

``import whisper_timestamped_tpu_torch as whisper`` must stand in for
whisper as ``whisper_timestamped_tpu`` does (``tests/test_api.py:564``):
every name of the JAX package's lazy surface resolves to the port's own
module, ``_download`` resolves against the local cache only, whisper.utils'
names are the port's, ``decode`` equals JAX's ``decode`` (greedy, language
detection, best_of with JAX's noise substituted, beam), and the cases of
``tests/test_normalizers.py`` hold on the port's copy of the normalizers.
f32 on the CPU, the golden model of test_golden.py.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_normalizers as TN  # noqa: E402
import whisper_timestamped_tpu as jwtt  # noqa: E402
import whisper_timestamped_tpu_torch as wtt  # noqa: E402
from model_utils import N_LANGS, hf_model_to_jax, make_hf_model, make_tokenizer  # noqa: E402
from test_torch_sampling import jax_noise  # noqa: E402,F401
from whisper_timestamped_tpu.models.load import WhisperModel as JaxModel  # noqa: E402
from whisper_timestamped_tpu_torch import normalizers  # noqa: E402
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
PORT = "whisper_timestamped_tpu_torch"


def test_dropin_import_surface(tmp_path):
    """whisper's re-exported names under whisper's own names
    (``test_dropin_import_surface``, tests/test_api.py:564)."""
    from whisper_timestamped_tpu_torch.models.load import WhisperModel as PortModel
    from whisper_timestamped_tpu_torch.models.whisper_torch import WhisperDims as PortDims

    assert wtt.Whisper is PortModel
    assert wtt.ModelDimensions is PortDims
    assert wtt.model.WhisperDims is PortDims  # whisper.model's counterpart
    assert set(wtt._MODELS) == set(wtt.available_models()) == set(jwtt._MODELS)

    # _download resolves against the local cache, never the network
    ckpt = tmp_path / "tiny.pt"
    ckpt.write_bytes(b"not-a-real-checkpoint")
    assert wtt._download(wtt._MODELS["tiny"], str(tmp_path)) == str(ckpt)
    assert wtt._download("tiny.pt", str(tmp_path), in_memory=True) == b"not-a-real-checkpoint"
    with pytest.raises(FileNotFoundError):
        wtt._download(wtt._MODELS["base"], str(tmp_path))


# every name of the JAX package's lazy surface, but VAD's, which comes with
# its slice
SURFACE = sorted((set(jwtt._LAZY) | set(jwtt._LAZY_MODULES)) - {"remove_non_speech"})


@pytest.mark.parametrize("name", SURFACE)
def test_surface_name_resolves_to_the_port(name):
    """Each name resolves, to the port's own module (never the JAX
    package's), and means what the JAX package's name means."""
    obj = getattr(wtt, name)
    if name in jwtt._LAZY_MODULES:
        assert obj.__name__.startswith(PORT + "."), obj.__name__
        want = jwtt._LAZY_MODULES[name].split(".")[-1]
        assert obj.__name__.split(".")[-1] == {"whisper_jax": "whisper_torch"}.get(want, want)
    elif isinstance(obj, dict):
        assert obj == getattr(jwtt, name)
    else:
        assert obj.__module__.startswith(PORT + "."), obj.__module__
        assert obj.__name__ == getattr(jwtt, name).__name__


@pytest.mark.parametrize("name", ["format_timestamp", "get_writer", "compression_ratio",
                                  "str2bool", "optional_int", "optional_float"])
def test_whisper_utils_names_are_the_ports(name):
    """``whisper.utils``' names on the port's ``utils`` (lazily), each the
    port's function, behaving as the JAX package's."""
    fn = getattr(wtt.utils, name)
    assert fn.__module__.startswith(PORT + ".")
    ref = getattr(jwtt.utils, name)
    args = {"format_timestamp": (3725.5,), "compression_ratio": ("ab ab ab ab ab ab",),
            "str2bool": ("True",), "optional_int": ("7",), "optional_float": ("None",)}
    if name == "get_writer":
        assert fn("json", ".").__module__ == PORT + ".writers"
        return
    assert fn(*args[name]) == ref(*args[name])
    with pytest.raises(AttributeError):
        wtt.utils.no_such_name  # noqa: B018


def _normalizer_cases():
    """``tests/test_normalizers.py``'s tests, one case per parameter set."""
    cases = []
    for name in sorted(dir(TN)):
        if not name.startswith("test_") or name == "test_package_export":
            continue
        marks = [m for m in getattr(getattr(TN, name), "pytestmark", []) if m.name == "parametrize"]
        if marks:
            cases += [pytest.param(name, args, id=f"{name}-{i}")
                      for i, args in enumerate(marks[0].args[1])]
        else:
            cases.append(pytest.param(name, (), id=name))
    return cases


@pytest.mark.parametrize("name,args", _normalizer_cases())
def test_normalizer_cases_on_the_ports_copy(monkeypatch, name, args):
    """The JAX package's normalizer tests, run with its module's names
    bound to the port's copy (``normalizers.py``)."""
    for attr in normalizers.__all__:
        if hasattr(TN, attr):
            monkeypatch.setattr(TN, attr, getattr(normalizers, attr))
    getattr(TN, name)(*args)


def test_normalizers_export():
    assert wtt.normalizers.EnglishTextNormalizer is normalizers.EnglishTextNormalizer
    assert normalizers.__name__ == PORT + ".normalizers"


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    params, dims = hf_model_to_jax(make_hf_model(seed=0))
    jax_model = JaxModel(params=jax.tree.map(jnp.asarray, params), dims=dims,
                         alignment_heads=HEADS)
    module = params_from_jax_tree(params, WhisperDims(**dims.__dict__), device="cpu")
    return jax_model, WhisperModel(module=module, alignment_heads=HEADS)


DECODE = {  # options; the language is detected where none is given
    "greedy": dict(language="en"),
    "detect_language": dict(),
    "best_of": dict(language="en", temperature=0.9, best_of=3),
    "beam": dict(language="en", beam_size=2, sample_len=24),
}


@pytest.mark.parametrize("mode", sorted(DECODE))
def test_decode_matches_jax(models, jax_noise, mode):  # noqa: F811
    """``decode`` equals the JAX package's ``decode`` (tests/test_decoding.py:
    481-514): tokens, language and its probabilities, scores within 1e-4,
    the per-token log-probs and the alignment-head attention."""
    jax_model, model = models
    mel = (np.random.default_rng(0).standard_normal((80, 3000)) * 0.5).astype(np.float32)
    got = wtt.decode(model, mel, wtt.DecodingOptions(**DECODE[mode]),
                     tokenizer=get_tokenizer(ranks=synthetic_ranks(), multilingual=True,
                                             num_languages=N_LANGS))
    want = jwtt.decode(jax_model, mel, jwtt.DecodingOptions(**DECODE[mode]),
                       tokenizer=make_tokenizer())
    assert isinstance(got, wtt.DecodingResult)
    assert got.tokens == want.tokens and got.tokens
    assert got.text == want.text and got.language == want.language
    assert got.temperature == want.temperature
    for field in ("avg_logprob", "no_speech_prob", "compression_ratio"):
        assert getattr(got, field) == pytest.approx(getattr(want, field), abs=1e-4), field
    if mode == "detect_language":
        assert got.language_probs.keys() == want.language_probs.keys()
        np.testing.assert_allclose(list(got.language_probs.values()),
                                   list(want.language_probs.values()), atol=1e-5)
    else:
        assert got.language_probs is None and want.language_probs is None
    np.testing.assert_allclose(got.token_logprobs, want.token_logprobs, atol=1e-4)
    assert got.cross_attention.shape == np.asarray(want.cross_attention).shape
    np.testing.assert_allclose(got.cross_attention, want.cross_attention, rtol=1e-4, atol=1e-4)


def test_decode_takes_a_batch_and_a_tensor(models):
    """A (B, n_mels, 3000) tensor gives the first row's result, as a numpy
    window does."""
    _, model = models
    mel = (np.random.default_rng(1).standard_normal((2, 80, 3000)) * 0.5).astype(np.float32)
    tok = get_tokenizer(ranks=synthetic_ranks(), multilingual=True, num_languages=N_LANGS)
    opts = wtt.DecodingOptions(language="en", sample_len=16)
    first = wtt.decode(model, torch.from_numpy(mel), opts, tokenizer=tok)
    alone = wtt.decode(model, mel[0], opts, tokenizer=tok)
    assert first.tokens == alone.tokens
    assert importlib.import_module(PORT + ".decoding").decode is wtt.decode


# ---------------------------------------------------------------------------
# models and utils: the JAX package's public names
# ---------------------------------------------------------------------------

import dataclasses  # noqa: E402
import json  # noqa: E402

import whisper_timestamped_tpu.models as jax_models  # noqa: E402
from whisper_timestamped_tpu.models import whisper_jax as J  # noqa: E402
from whisper_timestamped_tpu_torch import models as port_models  # noqa: E402
from whisper_timestamped_tpu_torch import utils as port_utils  # noqa: E402

MODEL_NAMES = sorted(n for n, v in vars(jax_models).items()
                     if not n.startswith("_") and not isinstance(v, type(jax_models)))


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_models_names_resolve_to_the_port(name):
    """Every public name of the JAX package's ``models`` resolves from the
    port's ``models``, to the port's own object (a function or class of its
    modules, a constant of its own)."""
    obj = getattr(port_models, name)
    if callable(obj) and hasattr(obj, "__module__"):
        assert obj.__module__.startswith(PORT + "."), obj.__module__
        assert obj.__name__ == getattr(jax_models, name).__name__
    else:
        assert obj is not getattr(jax_models, name)


def test_tiny_test_dims_has_jax_fields():
    assert dataclasses.asdict(port_models.TINY_TEST_DIMS) == dataclasses.asdict(J.TINY_TEST_DIMS)


@pytest.mark.parametrize("tree", ["init_params", "hf_checkpoint"])
def test_count_parameters_matches_jax(tree):
    """``count_parameters`` of the model ``params_from_jax_tree`` builds
    equals JAX's on the same tree: without an encoder ``pos_emb`` leaf (JAX's
    ``init_params``: the port's fixed sinusoids are left out) and with one
    (a checkpoint's trained positions)."""
    if tree == "init_params":
        params, dims = J.init_params(J.TINY_TEST_DIMS, jax.random.PRNGKey(0)), J.TINY_TEST_DIMS
    else:
        params, dims = hf_model_to_jax(make_hf_model(seed=0))
    np_tree = jax.tree.map(np.asarray, params)
    module = params_from_jax_tree(np_tree, WhisperDims(**dataclasses.asdict(dims)), device="cpu")
    assert module.fixed_pos_emb == (tree == "init_params")
    want = J.count_parameters(params)
    assert port_models.count_parameters(module) == want
    assert port_models.count_parameters(WhisperModel(module=module)) == want


def test_cast_params_keeps_the_integer_tensors():
    """``cast_params`` to bf16 and back casts every floating-point parameter
    in place (the bf16 values come back exactly) and leaves an integer
    buffer as it is, in dtype and bits."""
    module = port_models.init_params(port_models.TINY_TEST_DIMS, seed=1, device="cpu")
    codes = torch.arange(-64, 64, dtype=torch.int8)
    module.register_buffer("codes", codes.clone())
    rounded = {n: p.detach().bfloat16() for n, p in module.named_parameters()}
    model = WhisperModel(module=module)
    assert port_models.cast_params(model, torch.bfloat16) is model
    assert all(p.dtype == torch.bfloat16 for p in module.parameters())
    assert module.codes.dtype == torch.int8 and torch.equal(module.codes, codes)
    assert port_models.cast_params(module, torch.float32) is module
    for n, p in module.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p, rounded[n].float()), n
    assert module.codes.dtype == torch.int8 and torch.equal(module.codes, codes)


def test_trace_writes_a_trace_file(tmp_path):
    """``utils.trace(log_dir)`` records the block (here an encode on the CPU)
    into one Chrome trace file under ``log_dir``."""
    module = port_models.init_params(port_models.TINY_TEST_DIMS, seed=2, device="cpu")
    mel = torch.zeros((1, 80, 200))
    with port_utils.trace(str(tmp_path / "trace")):
        with torch.no_grad():
            port_models.encode(module, mel)
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)


def test_not_ported_is_gone():
    """Every option of the JAX package is ported: the helper that raised for
    those that were not has no caller left and is gone."""
    with pytest.raises(AttributeError):
        port_utils.not_ported  # noqa: B018
