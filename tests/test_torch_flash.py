"""The port's ``flash_attention`` (its plain version, as the CPU runs it) and
the encoder/prefill paths through it, against the JAX package, in f32.

- the plain version against JAX's ``_prefill_flash_attention`` (the library
  Pallas flash kernel, run here in interpret mode as tests/test_pallas.py
  runs it) on the prefill self (left padding + causal), prefill cross and
  encoder patterns, live rows, atol 2e-3 (the Pallas kernel's own
  tolerance against the unfused math there);
- the plain version against the port's ``_attention`` with the port's masks,
  every row, atol 1e-5 (f32, other summation order);
- the port's ``encode`` and one 232-slot prefill against JAX's, with a spy
  showing that they went through ``flash_attention``, rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from model_utils import hf_model_to_jax, make_hf_model, make_tokenizer  # noqa: E402
from whisper_timestamped_tpu.decoding import DecodingOptions as JaxOptions  # noqa: E402
from whisper_timestamped_tpu.engine import DecodeEngine as JaxEngine  # noqa: E402
from whisper_timestamped_tpu.models import whisper_jax as J  # noqa: E402
from whisper_timestamped_tpu.models.load import WhisperModel as JaxModel  # noqa: E402
from whisper_timestamped_tpu_torch.decoding import DecodingOptions  # noqa: E402
from whisper_timestamped_tpu_torch.engine import DecodeEngine  # noqa: E402
from whisper_timestamped_tpu_torch.models import WhisperModel  # noqa: E402
from whisper_timestamped_tpu_torch.models import load as L  # noqa: E402
from whisper_timestamped_tpu_torch.models import whisper_torch as W  # noqa: E402
from whisper_timestamped_tpu_torch.ops import kernels as K  # noqa: E402
from whisper_timestamped_tpu_torch.tokenizer import get_tokenizer, synthetic_ranks  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-5)
D, H = 128, 2  # head width 64, the kernel's
PAD = np.asarray([0, 7, 23], np.int32)

# pattern -> (Sq, Sk, causal)
PATTERNS = {"prefill_self": (24, 24, True), "prefill_cross": (24, 130, False),
            "encoder": (150, 150, False)}


def _qkv(Sq, Sk, seed=11):
    r = np.random.default_rng(seed)
    Bn = len(PAD)
    return (r.standard_normal((Bn, Sq, D)).astype(np.float32),
            r.standard_normal((Bn, Sk, D)).astype(np.float32),
            r.standard_normal((Bn, Sk, D)).astype(np.float32))


def _plain(q, k, v, causal):
    t = torch.from_numpy
    return K.flash_attention_plain(t(q), t(k), t(v), H, causal=causal,
                                   pad_len=t(PAD) if causal else None).numpy()


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_plain_matches_jax_flash_kernel(pattern):
    Sq, Sk, causal = PATTERNS[pattern]
    q, k, v = _qkv(Sq, Sk)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(J._prefill_flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H,
            pad_len=jnp.asarray(PAD) if causal else None, causal=causal))
    got = _plain(q, k, v, causal)
    assert np.all(np.isfinite(got))
    for b in range(len(PAD)):
        # JAX's left-padding rows are finite garbage by design: live rows only
        lo = int(PAD[b]) if causal else 0
        np.testing.assert_allclose(got[b, lo:], want[b, lo:], rtol=0, atol=2e-3)


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_plain_matches_port_attention_on_every_row(pattern):
    Sq, Sk, causal = PATTERNS[pattern]
    q, k, v = _qkv(Sq, Sk, seed=12)
    mask = None
    if causal:  # the prefill mask of decoding._prefill, own-slot escape included
        s = np.arange(Sq)
        valid = ((s[None, None] >= PAD[:, None, None]) & (s[None, None] <= s[None, :, None])
                 ) | (s[None, :, None] == s[None, None])
        mask = torch.from_numpy(np.where(valid, 0.0, -np.inf).astype(np.float32))[:, None]
    want, _ = W._attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), H,
                           mask=mask)
    np.testing.assert_allclose(_plain(q, k, v, causal), want.numpy(), rtol=0, atol=1e-5)


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(24, 24))
    before = dict(K.LAUNCHES)
    out = K.flash_attention(q, k, v, H, causal=True, pad_len=torch.from_numpy(PAD))
    assert K.LAUNCHES == before  # only a kernel launch counts
    np.testing.assert_array_equal(out.numpy(), _plain(q.numpy(), k.numpy(), v.numpy(), True))
    with pytest.raises(ValueError, match="needs causal"):
        K.flash_attention(q, k, v, H, pad_len=torch.from_numpy(PAD))
    with pytest.raises(ValueError, match="no kernel for device"):
        K.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"), H)


@pytest.fixture
def flash_calls(monkeypatch):
    """Spy on whisper_torch.flash_attention: (Sq, Sk, causal) per call."""
    calls = []

    def spy(q, k, v, n_head, *, causal=False, pad_len=None):
        calls.append((q.shape[1], k.shape[1], causal))
        return K.flash_attention(q, k, v, n_head, causal=causal, pad_len=pad_len)

    monkeypatch.setattr(W, "flash_attention", spy)
    return calls


def test_encode_goes_through_flash_and_matches_jax(flash_calls):
    params, dims = hf_model_to_jax(make_hf_model(seed=0))
    module = L.params_from_jax_tree(params, W.WhisperDims(**dims.__dict__), device="cpu")
    mel = np.random.default_rng(0).standard_normal((2, dims.n_mels, 3000)).astype(np.float32)
    want = np.asarray(J.encode(jax.tree.map(jnp.asarray, params), jnp.asarray(mel), dims))
    with torch.no_grad():
        got = W.encode(module, torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert flash_calls == [(1500, 1500, False)] * dims.n_audio_layer
    # short inputs keep the plain math (the JAX gate at 128 frames)
    x = torch.zeros((1, 100, D))
    W._encoder_attention(x, x, x, H)
    assert len(flash_calls) == dims.n_audio_layer


def test_prefill_of_232_slots_goes_through_flash_and_matches_jax(flash_calls):
    """One window with a carried prompt (the 232-slot region), dh=64 model:
    the prefill's self and cross attention go through flash_attention, and
    the decode buffers equal the JAX package's."""
    dims = J.WhisperDims(n_mels=80, n_audio_ctx=1500, n_audio_state=D, n_audio_head=H,
                         n_audio_layer=2, n_vocab=1928, n_text_ctx=448, n_text_state=D,
                         n_text_head=H, n_text_layer=2)
    params = jax.tree.map(np.asarray, J.init_params(dims, jax.random.PRNGKey(3)))
    heads = ((0, 1), (1, 0), (1, 1))
    jax_model = JaxModel(params=jax.tree.map(jnp.asarray, params), dims=dims, alignment_heads=heads)
    model = WhisperModel(module=L.params_from_jax_tree(params, W.WhisperDims(**dims.__dict__), device="cpu"),
                         alignment_heads=heads)
    tok = get_tokenizer(ranks=synthetic_ranks(), multilingual=True, num_languages=99)
    mel = np.random.default_rng(4).standard_normal((80, 3000)).astype(np.float32) * 0.5
    prompt = list(range(300, 330))
    rj = JaxEngine(jax_model, make_tokenizer()).decode_window(
        mel, JaxOptions(language="en", sample_len=24), prompt_tokens=prompt)[0]
    rt = DecodeEngine(model, tok).decode_window(
        torch.from_numpy(mel), DecodingOptions(language="en", sample_len=24), prompt_tokens=prompt)[0]
    prefill = [c for c in flash_calls if c[0] == 232]
    assert prefill == [(232, 232, True), (232, 1500, False)] * dims.n_text_layer
    assert rt.tokens == rj.tokens and len(rt.tokens) > 2
    np.testing.assert_allclose(rt.token_logprobs, rj.token_logprobs, **TOL)
    np.testing.assert_allclose(rt.attn, rj.attn, **TOL)
    # the small (8-slot) region of a promptless window keeps the plain math
    flash_calls.clear()
    DecodeEngine(model, tok).decode_window(
        torch.from_numpy(mel), DecodingOptions(language="en", sample_len=4))
    assert [c for c in flash_calls if c[0] != 1500] == []
