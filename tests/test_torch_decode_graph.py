"""The port's token loop as a step function over device state, against JAX's.

``decoding.decode_window`` runs ``_loop_step`` (JAX's ``while_loop`` body)
in chunks of ``STOP_CHECK_STEPS`` steps, gated on "not every row finished
yet", with the host testing for the stop between chunks. On the CPU the
chunks run eagerly, exactly as the card replays them, so these tests hold
the gating itself: the port's raw buffers against ``decode_window_jit``'s
on the same weights (``params_from_jax_tree``), with the loop stopping
inside a chunk, and chunk sizes 1 and 5 against each other bit for bit.

The self-attention plain versions take the step's slot as a device int32
and mask the whole extent; they are held against the former ``int`` form,
which read only slots [0, pos].

Tolerances (those of the goldens' tests, ``test_torch_slice.py`` and
``test_torch_quant.py``): f32 buffers at rtol 1e-4 / atol 1e-5 (timestamp
log-probs atol 1e-4); under a quantized cross K/V or ``w_int8`` at 1e-3
(JAX's XLA math rounds the int8 q·k products to bf16, the port keeps them
f32). Tokens, ``n_steps`` and ``n_sampled`` exactly.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import whisper_timestamped_tpu.engine as jax_engine_mod  # noqa: E402
import whisper_timestamped_tpu_torch.engine as port_engine_mod  # noqa: E402
from model_utils import N_LANGS, hf_model_to_jax, make_hf_model, make_tokenizer  # noqa: E402
from test_torch_sampling import jax_gumbel_source  # noqa: E402
from whisper_timestamped_tpu.decoding import DecodingOptions as JaxOptions  # noqa: E402
from whisper_timestamped_tpu.engine import DecodeEngine as JaxEngine  # noqa: E402
from whisper_timestamped_tpu.models.load import WhisperModel as JaxModel  # noqa: E402
from whisper_timestamped_tpu.parallel import batch as JB  # noqa: E402
from whisper_timestamped_tpu_torch import decoding  # noqa: E402
from whisper_timestamped_tpu_torch.decoding import DecodingOptions  # noqa: E402
from whisper_timestamped_tpu_torch.engine import DecodeEngine  # noqa: E402
from whisper_timestamped_tpu_torch.models import WhisperDims, WhisperModel, params_from_jax_tree  # noqa: E402
from whisper_timestamped_tpu_torch.ops import kernels as K  # noqa: E402
from whisper_timestamped_tpu_torch.parallel import batch as PB  # noqa: E402
from whisper_timestamped_tpu_torch.tokenizer import get_tokenizer, synthetic_ranks  # noqa: E402

HEADS = [(0, 1), (1, 0), (1, 2)]
MAX_NEW = 40
F32 = dict(rtol=1e-4, atol=1e-5)
INT8 = dict(rtol=1e-3, atol=1e-3)
CASES = {
    "greedy": dict(),
    "sampled": dict(temperature=0.7),
    "no_attention": dict(capture_attention=False),
    "kv_int8": dict(levers=dict(kv_int8=True)),
    "kv_int4_self_int8": dict(levers=dict(kv_int4=True, self_kv_int8=True)),
    "w_int8": dict(levers=dict(w_int8=True)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(params, dims):
    jax_model = JaxModel(params=jax.tree.map(jnp.asarray, params), dims=dims,
                         alignment_heads=HEADS)
    module = params_from_jax_tree(params, WhisperDims(**dims.__dict__), device="cpu")
    return jax_model, WhisperModel(module=module, alignment_heads=HEADS)


@pytest.fixture(scope="module")
def models():
    """The golden model: its windows run to ``max_new`` (EOT's logit is 0)."""
    return _pair(*hf_model_to_jax(make_hf_model(seed=0)))


@pytest.fixture(scope="module")
def eot_models():
    """The golden model with a reachable EOT (``test_torch_beam.py``'s
    ``eot_models``, the bias 0.25): with ``EOT_PROMPTS`` its three greedy
    rows finish after 5, 11 and 11 steps."""
    params, dims = hf_model_to_jax(make_hf_model(seed=0))
    params = copy.deepcopy(params)
    e = np.random.default_rng(1).standard_normal(dims.n_text_state).astype(np.float32) * 0.02
    emb = np.array(params["decoder"]["tok_emb"])
    emb[_tok().eot] = e
    params["decoder"]["tok_emb"] = emb
    params["decoder"]["ln"]["b"] = np.asarray(params["decoder"]["ln"]["b"]) + 0.25 * e / (e @ e)
    return _pair(params, dims)


# one prompt a row, mixed lengths: the 232-slot region, rows of their own
EOT_PROMPTS = [[], list(range(300, 330)), list(range(400, 500))]


def _tok():
    return get_tokenizer(ranks=synthetic_ranks(), multilingual=True, num_languages=N_LANGS,
                         language="en", task="transcribe")


def _mel(seed=5):
    """Two windows, so the rows finish at different steps."""
    return np.random.default_rng(seed).standard_normal((2, 80, 3000)).astype(np.float32) * 0.5


def _raw(monkeypatch, module, name):
    """Record the raw buffers that ``module.name`` returns."""
    seen = []
    fn = getattr(module, name)

    def record(*args, **kwargs):
        out = fn(*args, **kwargs)
        seen.append(out)
        return out

    monkeypatch.setattr(module, name, record)
    return seen


def _port_window(model, mel, prompt, monkeypatch, temperature=0.0, capture_attention=True,
                 levers=None):
    seen = _raw(monkeypatch, port_engine_mod, "decode_window")
    DecodeEngine(model, _tok(), **(levers or {})).decode_window(
        torch.from_numpy(mel), DecodingOptions(language="en", sample_len=MAX_NEW),
        prompt_tokens=prompt, temperature=temperature, rng_seed=3,
        capture_attention=capture_attention)
    monkeypatch.undo()
    return seen[0]


# every case with the 8-slot prompt region, the quantized-cache loop with
# the 232-slot one (a 120-token prompt); the greedy loop's 232-slot region
# is test_rows_that_finish_early_match_jax's
@pytest.mark.parametrize("case, prompt_len", [(c, 0) for c in sorted(CASES)]
                         + [("kv_int4_self_int8", 120)])
def test_decode_window_buffers_match_jax(models, monkeypatch, case, prompt_len):
    jax_model, model = models
    spec = dict(CASES[case])
    levers = spec.pop("levers", {})
    temperature = spec.get("temperature", 0.0)
    capture = spec.get("capture_attention", True)
    mel = _mel()
    prompt = list(range(300, 300 + prompt_len))
    want = _raw(monkeypatch, jax_engine_mod, "decode_window_jit")
    JaxEngine(jax_model, make_tokenizer(), **levers).decode_window(
        mel, JaxOptions(language="en", sample_len=MAX_NEW), prompt_tokens=prompt,
        temperature=temperature, rng_seed=3, capture_attention=capture)
    want = {k: np.asarray(v) for k, v in want[0].items() if k != "audio_features"}
    monkeypatch.undo()
    if temperature:
        monkeypatch.setattr(decoding, "make_gumbel_source", jax_gumbel_source)
    got = _port_window(model, mel, prompt, monkeypatch, temperature, capture, levers)

    n_steps = int(want["n_steps"])
    assert got["n_steps"] == n_steps
    assert n_steps % decoding.STOP_CHECK_STEPS != 0, "the stop must fall inside a chunk"
    assert got["chunks"] == -(-n_steps // decoding.STOP_CHECK_STEPS)
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
    np.testing.assert_array_equal(got["n_sampled"].numpy(), want["n_sampled"])
    tol = INT8 if levers.keys() & {"kv_int8", "kv_int4", "w_int8"} else F32
    np.testing.assert_allclose(got["token_logprobs"].numpy(), want["token_logprobs"], **tol)
    np.testing.assert_allclose(got["sum_logprobs"].numpy(), want["sum_logprobs"], **tol)
    np.testing.assert_allclose(got["no_speech_prob"].numpy(), want["no_speech_prob"],
                               rtol=tol["rtol"], atol=1e-6)
    if not capture:
        assert got["attn"] is None and got["ts_logprobs"] is None
        return
    # every row, those past the stop included: zero on both sides
    np.testing.assert_allclose(got["attn"].numpy(), want["attn"], **tol)
    np.testing.assert_allclose(got["ts_logprobs"].numpy(), want["ts_logprobs"],
                               rtol=tol["rtol"], atol=max(tol["atol"], 1e-4))
    assert not got["ts_logprobs"][:, n_steps:].any() and not got["attn"][:, n_steps + 1:].any()


def _eot_mel():
    return np.random.default_rng(0).standard_normal((3, 80, 3000)).astype(np.float32) * 0.5


def _port_batch_window(model):
    bt = PB.BatchTranscriber(DecodeEngine(model, _tok()), batch_size=3)
    return bt._dispatch_batch(torch.from_numpy(_eot_mel()), EOT_PROMPTS,
                              DecodingOptions(language="en", sample_len=MAX_NEW), 0.0, 3)


def test_rows_that_finish_early_match_jax(eot_models):
    """Rows that sample EOT at different steps (5, 11 and 11 of 40): the
    finished row's later steps write EOT, no log-prob and no alignment row,
    the loop stops after step 11, inside the first chunk, and the buffers
    equal JAX's, the rows past the stop zero."""
    jax_model, model = eot_models
    want = JB.BatchTranscriber(JaxEngine(jax_model, make_tokenizer()), batch_size=3)._dispatch_batch(
        _eot_mel(), EOT_PROMPTS, JaxOptions(language="en", sample_len=MAX_NEW), 0.0, 3)
    got = _port_batch_window(model)
    assert got["n_steps"] == int(want["n_steps"]) == 11 and got["chunks"] == 1
    np.testing.assert_array_equal(got["n_sampled"].numpy(), [5, 11, 11])
    np.testing.assert_array_equal(got["n_sampled"].numpy(), np.asarray(want["n_sampled"]))
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    for name in ("token_logprobs", "sum_logprobs", "attn"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), **F32)
    np.testing.assert_allclose(got["ts_logprobs"].numpy(), np.asarray(want["ts_logprobs"]),
                               rtol=1e-4, atol=1e-4)
    assert not got["token_logprobs"][0, 5:].any() and got["token_logprobs"][0, 4] != 0
    assert not got["attn"][:, 12:].any() and not got["ts_logprobs"][:, 11:].any()


@pytest.mark.parametrize("k", [1, 5])
def test_chunk_size_does_not_change_the_buffers(eot_models, monkeypatch, k):
    """k = 1 and k = 5 steps between the host's checks give the buffers
    and steps of the default k bit for bit, in ceil(n_steps / k) chunks:
    the steps past the stop in the last chunk change nothing."""
    _, model = eot_models
    want = _port_batch_window(model)
    monkeypatch.setattr(decoding, "STOP_CHECK_STEPS", k)
    got = _port_batch_window(model)
    assert got["n_steps"] == want["n_steps"] == 11
    assert got["chunks"] == -(-11 // k)
    for name in ("tokens", "token_logprobs", "sum_logprobs", "ts_logprobs", "attn",
                 "no_speech_prob", "n_sampled"):
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("eot", [False, True])
def test_steps_past_the_stop_change_nothing(models, eot_models, monkeypatch, eot):
    """Steps run after every row finished (``eot``) or after max_new leave
    the state as the last real step left it."""
    model = (eot_models if eot else models)[1]
    seen = {}

    def grab(model_, cache, st, cfg, draw, n_):
        seen.update(cache=cache, st=st, cfg=cfg, draw=draw)
        orig(model_, cache, st, cfg, draw, n_)

    orig = decoding._loop_chunk
    monkeypatch.setattr(decoding, "_loop_chunk", grab)
    n = (_port_batch_window(model) if eot else _port_window(model, _mel(7), [], monkeypatch))["n_steps"]
    monkeypatch.undo()
    # run the loop on from its end state, by hand: nothing moves
    st = seen["st"]
    # the carry; the staging rows of steps past the stop are never drained
    before = {f: getattr(st, f).clone() for f in ("i", "sum_logprobs", "finished", "last_token",
                                                   "penult_token", "max_timestamp",
                                                   "last_logits")}
    assert int(before["i"]) == n
    orig(model.module, seen["cache"], st, seen["cfg"], seen["draw"], 3)
    for name, t in before.items():
        assert torch.equal(getattr(st, name), t), name
    assert st.status.tolist() == [0, n]


def _former_self_attn(q, k_all, v_all, layer, pos, pad_len, n_head):
    """``self_attn_decode_plain`` as it read the cache before the slot
    moved to the device: slots [0, pos] only."""
    B, _, D = q.shape
    dh = D // n_head
    k = k_all[layer, :, : pos + 1].float()
    v = v_all[layer, :, : pos + 1].float()
    lo = torch.clamp(pad_len.long(), max=pos)
    live = torch.arange(pos + 1)[None, :] >= lo[:, None]
    qh = q.float().reshape(B, n_head, dh)
    kh = k.reshape(B, pos + 1, n_head, dh).transpose(1, 2)
    vh = v.reshape(B, pos + 1, n_head, dh).transpose(1, 2)
    s = torch.einsum("bhd,bhtd->bht", qh, kh) * dh**-0.5
    s = s.masked_fill(~live[:, None, :], float("-inf"))
    return torch.einsum("bht,bhtd->bhd", torch.softmax(s, dim=-1), vh).reshape(B, 1, D)


@pytest.mark.parametrize("pos", [0, 5, 17, 63, 64, 70])
def test_self_attn_plain_with_device_slot_matches_int_form(pos):
    """A device int32 slot over a 72-slot extent (the slots above pos hold
    values, as a reused cache does) equals the former int form, within f32
    rounding of the longer masked sums; at extent pos + 1, bit for bit. The
    int8 version the same, over the dequantized cache."""
    rng = np.random.default_rng(pos)
    L, B, ctx, H, D = 2, 4, 72, 2, 128
    q = torch.from_numpy(rng.standard_normal((B, 1, D)).astype(np.float32))
    k_all = torch.from_numpy(rng.standard_normal((L, B, ctx, D)).astype(np.float32))
    v_all = torch.from_numpy(rng.standard_normal((L, B, ctx, D)).astype(np.float32))
    pad = torch.tensor([0, 3, 17, 80], dtype=torch.int32)  # row 3: only its own slot
    slot = torch.tensor(pos, dtype=torch.int32)
    k8, ks = (torch.from_numpy(np.asarray(a)) for a in _quantize(k_all))
    v8, vs = (torch.from_numpy(np.asarray(a)) for a in _quantize(v_all))
    for layer in range(L):
        want = _former_self_attn(q, k_all, v_all, layer, pos, pad, H)
        got = K.self_attn_decode_plain(q, k_all, v_all, layer, slot, pad, H, extent=ctx)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
        assert torch.equal(K.self_attn_decode_plain(q, k_all, v_all, layer, slot, pad, H,
                                                    extent=pos + 1), want)
        assert torch.equal(K.self_attn_decode_plain(q, k_all, v_all, layer, pos, pad, H), want)
        kd, vd = k8.float() * ks[..., None], v8.float() * vs[..., None]
        want8 = _former_self_attn(q, kd, vd, layer, pos, pad, H)
        got8 = K.self_attn_decode_int8_plain(q, k8, ks, v8, vs, layer, slot, pad, H, extent=ctx)
        np.testing.assert_allclose(got8.numpy(), want8.numpy(), rtol=1e-6, atol=1e-6)


def _quantize(x):
    from whisper_timestamped_tpu_torch.ops.quant import quantize_rows

    return quantize_rows(x)


def test_row_writes_take_a_device_slot():
    """``self_attn_decode`` (CPU: ``write_row``) and
    ``write_quantized_row`` write slot ``pos`` of the layer, given as an
    int or as a device int32, and nothing else."""
    rng = np.random.default_rng(1)
    L, B, ctx, D = 2, 3, 16, 128
    new = torch.from_numpy(rng.standard_normal((B, 1, D)).astype(np.float32))
    for pos in (0, 9, 15):
        caches = []
        for p in (pos, torch.tensor(pos, dtype=torch.int32)):
            k = torch.zeros((L, B, ctx, D))
            v = torch.zeros((L, B, ctx, D))
            K.self_attn_decode(new, k, v, 1, p, torch.zeros(B, dtype=torch.int32), 2,
                               k_new=new, v_new=2 * new)
            k8 = torch.zeros((L, B, ctx, D), dtype=torch.int8)
            s8 = torch.zeros((L, B, ctx))
            v8, t8 = torch.zeros_like(k8), torch.zeros_like(s8)
            K.write_quantized_row(new, 2 * new, k8, s8, v8, t8, 1, p)
            caches.append((k, v, k8, s8, v8, t8))
        for a, b in zip(*caches):
            assert torch.equal(a, b)
        k, v, k8 = caches[0][:3]
        assert torch.equal(k[1, :, pos], new[:, 0]) and torch.equal(v[1, :, pos], 2 * new[:, 0])
        assert k.count_nonzero() == new.count_nonzero() and k8[0].count_nonzero() == 0
