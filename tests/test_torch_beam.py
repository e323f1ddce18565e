"""The port's beam search against the JAX package's, in f32 on the CPU.

Units first: ``rank_beam_results`` (whisper's ``finalize`` and ranker),
``top_candidates`` against ``lax.top_k`` (ties included), and the
candidate walk against a plain Python loop of whisper's
``BeamSearchDecoder.update``. Then one window and a batch of windows
through ``decode_window_beam`` / ``decode_window_beam_batch``, against
JAX's engine with the same options and levers, on the golden model with
EOT made reachable (``eot_models``: random weights never finish a
sequence, so the finished pool would stay empty). End to end: the batch
pipeline's beam mode (serial, batched, the serving loop; the device flow
refused), and ``use_backend_timestamps`` with beam, which warns and falls
back to the teacher-forced alignment.
"""

import copy
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from model_utils import N_LANGS, hf_model_to_jax, make_hf_model, make_tokenizer  # noqa: E402
from test_golden import _audio, loose  # noqa: E402
from whisper_timestamped_tpu.api import transcribe_timestamped as jax_transcribe  # noqa: E402
from whisper_timestamped_tpu.decoding import DecodingOptions as JaxOptions  # noqa: E402
from whisper_timestamped_tpu.decoding_beam import rank_beam_results as jax_rank  # noqa: E402
from whisper_timestamped_tpu.engine import DecodeEngine as JaxEngine  # noqa: E402
from whisper_timestamped_tpu.models.load import WhisperModel as JaxModel  # noqa: E402
from whisper_timestamped_tpu.parallel import batch as JB  # noqa: E402
from whisper_timestamped_tpu_torch import decoding_beam as DB  # noqa: E402
from whisper_timestamped_tpu_torch import transcribe_timestamped  # noqa: E402
from whisper_timestamped_tpu_torch.decoding import DecodingOptions  # noqa: E402
from whisper_timestamped_tpu_torch.engine import DecodeEngine  # noqa: E402
from whisper_timestamped_tpu_torch.models import WhisperDims, WhisperModel, params_from_jax_tree  # noqa: E402
from whisper_timestamped_tpu_torch.parallel import batch as B  # noqa: E402
from whisper_timestamped_tpu_torch.tokenizer import get_tokenizer, synthetic_ranks  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HEADS = [(0, 1), (1, 0), (1, 2)]
EOT = 320  # the synthetic vocabulary's <|endoftext|>


def _pair(params, dims):
    jax_model = JaxModel(params=jax.tree.map(jnp.asarray, params), dims=dims,
                         alignment_heads=HEADS)
    module = params_from_jax_tree(params, WhisperDims(**dims.__dict__), device="cpu")
    return jax_model, WhisperModel(module=module, alignment_heads=HEADS)


@pytest.fixture(scope="module")
def models():
    """The golden model of test_golden.py in both packages."""
    return _pair(*hf_model_to_jax(make_hf_model(seed=0)))


@pytest.fixture(scope="module")
def eot_models():
    """The golden model with a reachable EOT: its embedding row (zero in
    the synthetic model, so its logit is always 0) set to a seeded vector
    ``e`` and the final norm's bias moved by 0.3 e / |e|^2. Beams then
    finish after 4 to 31 tokens on the test's mel."""
    params, dims = hf_model_to_jax(make_hf_model(seed=0))
    params = copy.deepcopy(params)
    e = np.random.default_rng(1).standard_normal(dims.n_text_state).astype(np.float32) * 0.02
    emb = np.array(params["decoder"]["tok_emb"])
    emb[EOT] = e
    params["decoder"]["tok_emb"] = emb
    params["decoder"]["ln"]["b"] = np.asarray(params["decoder"]["ln"]["b"]) + 0.3 * e / (e @ e)
    return _pair(params, dims)


def _tok(language="en"):
    return get_tokenizer(ranks=synthetic_ranks(), multilingual=True, num_languages=N_LANGS,
                         language=language, task="transcribe" if language else None)


def _mel(seed=0, scale=0.5):
    return (np.random.default_rng(seed).standard_normal((80, 3000)) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# rank_beam_results
# ---------------------------------------------------------------------------


def _beam_out(n_fin, fin_scores, beam_scores, K=3, C=6, max_new=8, eot=99):
    """A beam core's per-window output (test_decoding.py:398's ``mk``)."""
    out = {
        "n_finished": np.int32(n_fin),
        "finished_seqs": np.full((C, max_new), eot, np.int32),
        "finished_scores": np.full((C,), -1e30, np.float32),
        "finished_len": np.zeros((C,), np.int32),
        "beam_tokens": np.tile(np.arange(max_new, dtype=np.int32), (K, 1)),
        "beam_scores": np.asarray(beam_scores, np.float32),
        "n_steps": np.int32(4),
    }
    for j, s in enumerate(fin_scores):
        out["finished_scores"][j] = s
        out["finished_seqs"][j, : 2 + j % 3] = [7, 8, 9, 10][: 2 + j % 3]
        out["finished_len"][j] = 2 + j % 3
    return out


RANK_CASES = {
    # the pool holds at least K: running beams are not considered
    "pool_at_k": (dict(n_fin=4, fin_scores=[-2.0, -3.0, -4.0, -5.0], beam_scores=[-0.1, -9, -9]),
                  None),
    # fewer than K finished: padded with the best running beams, to K only
    "pad_to_k": (dict(n_fin=1, fin_scores=[-50.0], beam_scores=[-0.5, -1.0, -20.0]), None),
    "none_finished": (dict(n_fin=0, fin_scores=[], beam_scores=[-3.0, -1.0, -2.0]), None),
    "length_penalty": (dict(n_fin=3, fin_scores=[-2.0, -2.9, -3.1], beam_scores=[-1, -9, -9]),
                       0.5),
}


@pytest.mark.parametrize("case", sorted(RANK_CASES))
def test_rank_beam_results_matches_jax(case):
    kw, length_penalty = RANK_CASES[case]
    out = _beam_out(**kw)
    assert DB.rank_beam_results(out, 99, length_penalty) == jax_rank(out, 99, length_penalty)
    if case == "pad_to_k":
        assert DB.rank_beam_results(out, 99, None) == (list(range(4)), pytest.approx(-0.5))


# ---------------------------------------------------------------------------
# top_candidates and the candidate walk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_top_candidates_match_lax_top_k(seed):
    """Indices and scores equal ``lax.top_k``'s, ties in index order: the
    -1e30 beams' equal candidates, -inf columns and repeated values."""
    rng = np.random.default_rng(seed)
    K, V = 3, 50
    logp = rng.standard_normal((4, K, V)).astype(np.float32)
    logp[rng.random(logp.shape) < 0.3] = -np.inf
    logp[:, :, 7] = logp[:, :, 3]  # repeated values
    logp[1, 0, :] = -np.inf  # a beam with no finite candidate
    sums = np.where(np.arange(K) == 0, 0.0, -1e30).astype(np.float32)
    sums = np.tile(sums, (4, 1))
    sums[2:] = rng.standard_normal((2, K)).astype(np.float32)
    flat = (sums[:, :, None] + logp).reshape(4, K * V)
    flat[3, : 2 * K + 1] = 1.5  # a tie across the cut
    scores, idx = DB.top_candidates(torch.from_numpy(flat), 2 * K)
    want_s, want_i = jax.lax.top_k(jnp.asarray(flat), 2 * K)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(want_s))


def _whisper_update(scores, src, tok, active, n_finished, sum_lp, K, C, eot):
    """whisper's ``BeamSearchDecoder.update`` on one step's candidates,
    window by window: walk them best first, EOT into the finished set, the
    rest into the next beams until K are saved; then the finished set into
    the pool in score order while it has room. A frozen window keeps its
    beams."""
    sel, pools = [], []
    for b in range(scores.shape[0]):
        if not active[b]:
            sel.append([(k, eot, sum_lp[b, k]) for k in range(K)])
            pools.append([])
            continue
        saved, finished = [], []
        for j in range(scores.shape[1]):
            if tok[b, j] == eot:
                finished.append((scores[b, j], j))
            else:
                saved.append((int(src[b, j]), int(tok[b, j]), scores[b, j]))
                if len(saved) == K:
                    break
        pool = []
        for s, j in sorted(finished, key=lambda t: -t[0]):
            if n_finished[b] + len(pool) >= C:
                break
            pool.append(j)
        sel.append(saved)
        pools.append(pool)
    return sel, pools


WALKS = {  # beam_size, patience, what else the case holds
    "k2": (2, 1.0, {}),
    "k3_patience2": (3, 2.0, {}),
    "k5_pool_one_short": (5, 1.0, dict(pool=4)),
    "k3_frozen": (3, 1.0, dict(frozen=True)),
}


@pytest.mark.parametrize("case", sorted(WALKS))
def test_beam_walk_matches_whisper_update(case):
    K, patience, extra = WALKS[case]
    C = max(1, round(K * patience))
    rng = np.random.default_rng(len(case))
    Bn, V, eot = 6, 4, 3  # a four-token vocabulary: a quarter of the candidates are EOT
    for _ in range(20):
        scores = -np.sort(rng.exponential(2.0, (Bn, 2 * K)), axis=1).astype(np.float32)
        # distinct (beam, token) pairs, as a top-2K over K x V gives
        flat = np.stack([rng.choice(K * V, 2 * K, replace=False) for _ in range(Bn)])
        src, tok = flat // V, flat % V
        n_fin = rng.integers(0, C + 1, Bn)
        if "pool" in extra:
            n_fin[:] = extra["pool"]
        active = n_fin < C
        if extra.get("frozen"):
            active[::2] = False
        sum_lp = rng.standard_normal((Bn, K)).astype(np.float32)
        got = DB.beam_walk(*(torch.from_numpy(a) for a in (scores, src, tok, active, n_fin,
                                                           sum_lp)),
                           eot=eot, beam_size=K, max_candidates=C)
        sel_src, sel_tok, sel_score, fin_slot, n_new = (t.numpy() for t in got)
        want_sel, want_pools = _whisper_update(scores, src, tok, active, n_fin, sum_lp, K, C, eot)
        for b in range(Bn):
            assert [(int(s), int(t), float(v)) for s, t, v in
                    zip(sel_src[b], sel_tok[b], sel_score[b])] == \
                [(s, t, float(v)) for s, t, v in want_sel[b]]
            pooled = [j for j in range(2 * K) if fin_slot[b, j] < C]
            assert pooled == sorted(want_pools[b])  # scores are already descending
            assert [fin_slot[b, j] for j in pooled] == list(range(n_fin[b], n_fin[b] + len(pooled)))
            assert n_new[b] == n_fin[b] + len(pooled)


# ---------------------------------------------------------------------------
# One window, and a batch of windows
# ---------------------------------------------------------------------------

# the quantized cross K/V: the port's decode step keeps each q·k product of
# the int8 math in f32 where JAX's XLA math rounds it to bf16 (as
# test_torch_quant.py's SLICE_TOL says), about 3e-4 a token
SCORE_TOL = {"kv_int8": 2e-3}

DECODES = {  # options, prompt, engine lever
    "k2": (dict(beam_size=2), [], {}),
    "k3_prompt_patience_penalty": (dict(beam_size=3, patience=2.0, length_penalty=0.5),
                                   [301, 302, 303, 304], {}),
    "k3_kv_int8": (dict(beam_size=3), [301, 302], dict(kv_int8=True)),
    "k3_kv_int4": (dict(beam_size=3), [301, 302], dict(kv_int4=True)),
    "k3_self_kv_int8": (dict(beam_size=3), [301, 302], dict(self_kv_int8=True)),
}


@pytest.mark.parametrize("case", sorted(DECODES))
def test_decode_window_beam_matches_jax(eot_models, case):
    """Tokens equal to JAX's ``DecodeEngine.decode_window_beam`` with the
    same options and engine; sum and average log-prob and the no-speech
    probability within 1e-4 (the int8 cross K/V: 2e-3)."""
    jax_model, model = eot_models
    opts, prompt, lever = DECODES[case]
    mel = _mel()
    got = DecodeEngine(model, _tok(), **lever).decode_window_beam(
        mel, DecodingOptions(language="en", sample_len=32, **opts), prompt)
    want = JaxEngine(jax_model, make_tokenizer(language="en", task="transcribe"),
                     **lever).decode_window_beam(
        mel, JaxOptions(language="en", sample_len=32, **opts), prompt)
    tol = SCORE_TOL.get(next(iter(lever), None), 1e-4)
    assert got.tokens == want.tokens and got.tokens
    assert got.sum_logprob == pytest.approx(want.sum_logprob, abs=tol)
    assert got.avg_logprob == pytest.approx(want.avg_logprob, abs=tol)
    assert got.no_speech_prob == pytest.approx(want.no_speech_prob, abs=1e-4)
    assert got.hit_limit == want.hit_limit and got.temperature == 0.0
    assert got.attn.size == 0 and not got.token_logprobs.any()


def test_beam_pool_fills_and_stops(eot_models, monkeypatch):
    """The finished pool at work on ``eot_models``: K=2 fills its pool of 2
    and stops before the budget; K=3 with patience 2 pools 4 of its 6 and
    runs to the budget. The pooled lengths and scores equal JAX's."""
    jax_model, model = eot_models
    seen = {}

    def spy(out, eot, length_penalty):
        seen["out"] = out
        return DB.rank_beam_results(out, eot, length_penalty)

    import whisper_timestamped_tpu.decoding_beam as JDB
    from whisper_timestamped_tpu_torch import engine as E

    monkeypatch.setattr(E, "rank_beam_results", spy)
    jax_seen = {}

    def jax_spy(out, eot, length_penalty):
        jax_seen["out"] = out
        return jax_rank(out, eot, length_penalty)

    monkeypatch.setattr(JDB, "rank_beam_results", jax_spy)
    for K, patience, n_fin, stopped in ((2, 1.0, 2, True), (3, 2.0, 4, False)):
        opts = dict(language="en", sample_len=32, beam_size=K, patience=patience)
        DecodeEngine(model, _tok()).decode_window_beam(_mel(), DecodingOptions(**opts))
        JaxEngine(jax_model, make_tokenizer(language="en", task="transcribe")).decode_window_beam(
            _mel(), JaxOptions(**opts))
        out, ref = seen["out"], jax_seen["out"]
        assert int(out["n_finished"]) == int(ref["n_finished"]) == n_fin
        assert (int(out["n_steps"]) < 32) == stopped
        n = n_fin
        np.testing.assert_array_equal(out["finished_len"][:n], ref["finished_len"][:n])
        np.testing.assert_array_equal(out["finished_seqs"][:n], ref["finished_seqs"][:n])
        np.testing.assert_allclose(out["finished_scores"][:n], ref["finished_scores"][:n],
                                   atol=1e-4)


def test_beam_size_one_equals_greedy(eot_models):
    """At K=1 the beam step is the greedy step plus the identity reorder."""
    _, model = eot_models
    engine = DecodeEngine(model, _tok())
    for mel in (_mel(0), _mel(3, 0.2)):
        greedy = engine.decode_window(mel, DecodingOptions(language="en", sample_len=32))[0]
        beam = engine.decode_window_beam(mel, DecodingOptions(language="en", sample_len=32,
                                                              beam_size=1))
        assert beam.tokens == greedy.tokens
        assert beam.sum_logprob == pytest.approx(greedy.sum_logprob, abs=1e-4)


def test_decode_window_beam_batch_matches_jax_and_single(eot_models):
    """Three windows with different prompts and per-row languages in one
    batch: each row equals JAX's batch row and the port's own single-window
    decode (``test_beam_batch_matches_single``, test_decoding.py:359)."""
    jax_model, model = eot_models
    mels = np.stack([_mel(0), _mel(7, 0.4), _mel(8, 0.2)])
    prompts = [[], [301, 302, 303, 304], [311, 312]]
    languages = ["en", "fr", None]
    opts = dict(language="en", beam_size=3, sample_len=32)
    engine = DecodeEngine(model, _tok())
    got = engine.decode_window_beam_batch(mels, DecodingOptions(**opts), prompts, languages)
    want = JaxEngine(jax_model, make_tokenizer(language="en", task="transcribe")
                     ).decode_window_beam_batch(mels, JaxOptions(**opts), prompts, languages)
    assert len(got) == 3
    for b in range(3):
        single = engine.decode_window_beam(
            mels[b], DecodingOptions(**{**opts, "language": languages[b] or "en"}), prompts[b])
        for other in (want[b], single):
            assert got[b].tokens == other.tokens, b
            assert got[b].sum_logprob == pytest.approx(other.sum_logprob, rel=1e-4, abs=1e-4)
            assert got[b].no_speech_prob == pytest.approx(other.no_speech_prob, abs=1e-5)
        assert got[b].batch_index == b and got[b].n_text == len(got[b].tokens)


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------

AUDIOS = {"a": _audio(6, 6), "b": _audio(7, 9)}
BATCH_KW = dict(language="en", batch_size=2, temperature=[0.0], no_speech_threshold=None,
                logprob_threshold=None, compression_ratio_threshold=None)


def test_device_flow_refuses_beam(models, monkeypatch):
    """A beam request never takes the greedy device flow, with
    ``WTT_DEVICE_FLOW`` unset (``batch.py:449`` of the JAX package)."""
    monkeypatch.delenv("WTT_DEVICE_FLOW", raising=False)
    _, model = models
    bt = B.BatchTranscriber(DecodeEngine(model, _tok()), batch_size=2)
    assert bt._device_flow_ok([], DecodingOptions(), [0.0])
    assert not bt._device_flow_ok([], DecodingOptions(beam_size=2), [0.0])


@pytest.mark.parametrize("device_flow", ["unset", "0"])
def test_transcribe_batch_beam_matches_jax_and_serial(models, monkeypatch, caplog, device_flow):
    """``transcribe_batch`` with beam 2 equals JAX's, and each stream the
    port's serial beam request (``test_batch.py:345``), with the device
    flow allowed (``unset``) or forced off. Device alignment, asked for,
    warns and does not apply."""
    if device_flow == "unset":
        monkeypatch.delenv("WTT_DEVICE_FLOW", raising=False)
    else:
        monkeypatch.setenv("WTT_DEVICE_FLOW", device_flow)
    jax_model, model = models
    opts = dict(beam_size=2, sample_len=32)
    with caplog.at_level(logging.WARNING, logger="whisper_timestamped_tpu_torch"):
        got = B.transcribe_batch(model, AUDIOS, _tok(), device_alignment=True,
                                 decode_options=DecodingOptions(**opts), **BATCH_KW)
    assert any("device_alignment does not apply" in r.message for r in caplog.records)
    want = JB.transcribe_batch(jax_model, AUDIOS, make_tokenizer(language="en", task="transcribe"),
                               decode_options=JaxOptions(**opts), **BATCH_KW)
    serial_kw = {k: v for k, v in BATCH_KW.items() if k not in ("batch_size", "temperature")}
    for name, audio in AUDIOS.items():
        serial = transcribe_timestamped(model, audio, tokenizer=_tok(), temperature=0.0,
                                        **opts, **serial_kw)
        for other in (want[name], serial):
            assert [s["tokens"] for s in got[name]["segments"]] == \
                [s["tokens"] for s in other["segments"]], name
            assert loose(got[name]) == loose(other), name
        assert [w for s in got[name]["segments"] for w in s.get("words", [])]


def test_transcribe_batch_stream_beam_equals_transcribe_batch(models):
    """The serving loop with beam: each batch equals ``transcribe_batch``
    on that batch alone."""
    _, model = models
    batches = [{"a": AUDIOS["a"]}, {"b": AUDIOS["b"], "c": _audio(8, 4)}]
    kw = dict(decode_options=DecodingOptions(beam_size=2, sample_len=32), **BATCH_KW)
    streamed = list(B.transcribe_batch_stream(model, batches, _tok(), **kw))
    assert len(streamed) == 2
    for batch, got in zip(batches, streamed):
        assert got == B.transcribe_batch(model, batch, _tok(), **kw)


def test_use_backend_timestamps_beam_contract(models, caplog):
    """``use_backend_timestamps`` with beam (``test_api.py:415``): beam
    windows carry no attention, so the port warns and returns exactly its
    plain beam two-pass output, which equals JAX's."""
    jax_model, model = models
    audio = _audio(3, 3)
    kw = dict(language="en", beam_size=2, sample_len=32, no_speech_threshold=None,
              logprob_threshold=None, compression_ratio_threshold=None)
    plain = transcribe_timestamped(model, audio, tokenizer=_tok(), **kw)
    with caplog.at_level(logging.WARNING, logger="whisper_timestamped_tpu_torch"):
        backend = transcribe_timestamped(model, audio, tokenizer=_tok(),
                                         use_backend_timestamps=True, **kw)
    assert any("use_backend_timestamps" in r.message for r in caplog.records)
    assert backend == plain
    assert [w for s in plain["segments"] for w in s.get("words", [])]
    ref = jax_transcribe(jax_model, audio, tokenizer=make_tokenizer(), use_backend_timestamps=True,
                         **kw)
    assert loose(backend) == loose(ref)
