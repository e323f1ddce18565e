"""The port's model and front-end against the JAX package, in f32 on the CPU.

Two models: the synthetic golden model of model_utils (D=64, 4 heads, dh=16,
MLP 2x) and a JAX ``init_params`` model with the kernels' head width
(D=128, 2 heads, dh=64). Both packages get the same weights (the JAX tree,
converted by ``params_from_jax_tree``) and the same numpy-seeded inputs.
Tolerance rtol 1e-4 / atol 1e-5 (f32, other summation orders); the mel
atol 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from model_utils import hf_model_to_jax, make_hf_model  # noqa: E402
from whisper_timestamped_tpu.audio import N_SAMPLES  # noqa: E402
from whisper_timestamped_tpu.audio import log_mel_spectrogram as jax_mel  # noqa: E402
from whisper_timestamped_tpu.models import load as jax_load  # noqa: E402
from whisper_timestamped_tpu.models import whisper_jax as J  # noqa: E402
from whisper_timestamped_tpu_torch.audio import log_mel_spectrogram  # noqa: E402
from whisper_timestamped_tpu_torch.models import load as L  # noqa: E402
from whisper_timestamped_tpu_torch.models import whisper_torch as W  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-5)


def _port(params, dims):
    tree = jax.tree.map(np.asarray, params)
    return L.params_from_jax_tree(tree, W.WhisperDims(**dims.__dict__), device="cpu")


@pytest.fixture(scope="module", params=["golden_dh16", "init_dh64"])
def models(request):
    if request.param == "golden_dh16":
        params, dims = hf_model_to_jax(make_hf_model(seed=0))
        heads = ((0, 1), (1, 0), (1, 2))
    else:
        dims = J.WhisperDims(n_mels=80, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2,
                             n_audio_layer=2, n_vocab=1928, n_text_ctx=448, n_text_state=128,
                             n_text_head=2, n_text_layer=2)
        params = jax.tree.map(np.asarray, J.init_params(dims, jax.random.PRNGKey(3)))
        heads = ((0, 1), (1, 0), (1, 1))
    params = jax.tree.map(jnp.asarray, params)
    return params, dims, _port(params, dims), heads


@pytest.fixture(scope="module")
def encoded(models):
    params, dims, module, _ = models
    mel = np.random.default_rng(0).standard_normal((1, dims.n_mels, 3000)).astype(np.float32)
    xa_j = np.asarray(J.encode(params, jnp.asarray(mel), dims))
    with torch.no_grad():
        xa_t = W.encode(module, torch.from_numpy(mel))
    return xa_j, xa_t


def test_encode_matches_jax(encoded):
    xa_j, xa_t = encoded
    assert xa_t.shape == xa_j.shape
    np.testing.assert_allclose(xa_t.numpy(), xa_j, **TOL)


def test_decode_step_matches_jax(models, encoded):
    """Three cached steps with left padding: logits, alignment-head score
    rows and the new cache rows equal the JAX step (XLA branch)."""
    params, dims, module, heads = models
    xa_j, xa_t = encoded
    B, ctx, D = 2, 16, dims.n_text_state
    rng = np.random.default_rng(1)
    xa = np.repeat(xa_j, B, axis=0)
    cache_j = J.init_cache(params, jnp.asarray(xa), dims, ctx_len=ctx)
    cache_t = W.init_cache(module, torch.from_numpy(xa), ctx_len=ctx)
    np.testing.assert_allclose(cache_t.xk.numpy(), np.asarray(cache_j.xk), **TOL)
    # slots 0..4 already filled (as by a prefill); row 1 left-padded by 3
    k0 = rng.standard_normal((dims.n_text_layer, B, 5, D)).astype(np.float32)
    v0 = rng.standard_normal((dims.n_text_layer, B, 5, D)).astype(np.float32)
    cache_j = cache_j._replace(k=cache_j.k.at[:, :, :5].set(k0), v=cache_j.v.at[:, :, :5].set(v0))
    cache_t.k[:, :, :5] = torch.from_numpy(k0)
    cache_t.v[:, :, :5] = torch.from_numpy(v0)
    pad = np.array([0, 3], np.int32)
    for step, pos in enumerate((5, 6, 7)):
        tokens = rng.integers(0, dims.n_vocab, (B, 1)).astype(np.int32)
        lj, cache_j, rows_j = J.decode_step(
            params, jnp.asarray(tokens), cache_j, jnp.int32(pos), dims,
            pos_offset=jnp.asarray(pad), kv_valid_from=jnp.asarray(pad), align_heads=heads,
        )
        with torch.no_grad():
            lt, rows_t = W.decode_step(
                module, torch.from_numpy(tokens).long(), cache_t, pos,
                pos_offset=torch.from_numpy(pad), kv_valid_from=torch.from_numpy(pad),
                align_heads=heads,
            )
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        np.testing.assert_allclose(rows_t.numpy(), np.asarray(rows_j), **TOL)
        np.testing.assert_allclose(cache_t.k[:, :, pos].numpy(), np.asarray(cache_j.k[:, :, pos]), **TOL)


def test_decode_full_matches_jax(models, encoded):
    params, dims, module, _ = models
    xa_j, xa_t = encoded
    tokens = np.random.default_rng(2).integers(0, dims.n_vocab, (1, 6)).astype(np.int32)
    lj, wj = J.decode_full(params, jnp.asarray(tokens), jnp.asarray(xa_j), dims,
                           return_cross_attn=True)
    with torch.no_grad():
        lt, wt = W.decode_full(module, torch.from_numpy(tokens).long(), xa_t,
                               return_cross_attn=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), **TOL)


@pytest.mark.parametrize("seconds,pcm", [(3, False), (31, True)])
def test_log_mel_matches_jax(seconds, pcm):
    rng = np.random.default_rng(seconds)
    audio = (rng.standard_normal(16000 * seconds) * 0.1).astype(np.float32)
    if pcm:  # int16 PCM, dequantized as x / 32768 by both
        audio = np.clip(np.round(audio * 32768), -32768, 32767).astype(np.int16)
    for n_mels in (80, 128):
        mj = np.asarray(jax_mel(audio, n_mels=n_mels, padding=N_SAMPLES))
        mt = log_mel_spectrogram(audio, n_mels=n_mels, padding=N_SAMPLES, device="cpu").numpy()
        assert mt.shape == mj.shape
        np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-4)


def test_state_dict_converters_match_jax():
    """HF and OpenAI state dicts convert to the same numpy tree as the JAX
    package's converters, and that tree to the port's layouts."""
    import tempfile

    from model_utils import save_openai_pt

    hf = make_hf_model(seed=0)
    sd = hf.state_dict()
    tj, dj = jax_load.from_hf_state_dict(dict(sd), hf.config.to_dict())
    tt, dt = L.from_hf_state_dict(dict(sd), hf.config.to_dict())
    assert dj.__dict__ == dt.__dict__
    for (pj, a), (pt, b) in zip(jax.tree_util.tree_leaves_with_path(tj),
                                jax.tree_util.tree_leaves_with_path(tt)):
        assert pj == pt
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with tempfile.TemporaryDirectory() as d:
        path = save_openai_pt(hf, f"{d}/tiny.pt")
        model = L.load_model(path, device="cpu")
    module = model.module
    assert model.dims == dt
    # (L, in, out) -> (L, out, in); conv (k, in, out) -> (out, in, k)
    np.testing.assert_array_equal(module.decoder["cross_q_w"].numpy(),
                                  np.swapaxes(tt["decoder"]["blocks"]["cross"]["q"]["w"], 1, 2))
    np.testing.assert_array_equal(module.encoder["conv1_w"].numpy(),
                                  tt["encoder"]["conv1"]["w"].transpose(2, 1, 0))


def test_load_model_defaults_to_the_card(monkeypatch):
    """Without a device, load_model places the model on CUDA; with no card
    visible it raises instead of falling back to the CPU."""
    import tempfile

    from model_utils import save_openai_pt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tempfile.TemporaryDirectory() as d:
        path = save_openai_pt(make_hf_model(seed=0), f"{d}/tiny.pt")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            L.load_model(path)
        assert L.load_model(path, device="cpu").device.type == "cpu"


def test_params_from_jax_tree_defaults_to_the_card(monkeypatch):
    """Without a device, params_from_jax_tree places the weights on CUDA;
    with no card visible it raises; ``device="cpu"`` works."""
    tree, dims = hf_model_to_jax(make_hf_model(seed=0))
    dims = W.WhisperDims(**dims.__dict__)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.params_from_jax_tree(tree, dims)
    assert L.params_from_jax_tree(tree, dims, device="cpu").device.type == "cpu"


def test_init_params_geometry():
    """The seeded random model has the JAX init's shapes and scales."""
    dims = W.WhisperDims(n_mels=80, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
                         n_vocab=1928, n_text_state=128, n_text_head=2, n_text_layer=3)
    a = W.init_params(dims, seed=1, device="cpu")
    b = W.init_params(dims, seed=1, device="cpu")
    ref = _port(J.init_params(J.WhisperDims(**dims.__dict__), jax.random.PRNGKey(0)),
                J.WhisperDims(**dims.__dict__))
    for pd_a, pd_b, pd_r in ((a.encoder, b.encoder, ref.encoder), (a.decoder, b.decoder, ref.decoder)):
        assert list(pd_a.keys()) == list(pd_r.keys())
        for k in pd_a:
            assert pd_a[k].shape == pd_r[k].shape, k
            assert torch.equal(pd_a[k], pd_b[k]), k  # same seed, same weights
            ra, rr = pd_a[k].std().item(), pd_r[k].std().item()
            assert abs(ra - rr) <= 0.15 * max(rr, 1e-3) + 1e-6, (k, ra, rr)
