"""The port's batch pipeline (``parallel/batch.py``, ``parallel/deviceflow.py``)
against the JAX package's, in f32 on the CPU.

The model is test_batch.py's (the synthetic golden model, alignment heads
(0, 1), (1, 0), (1, 2)), its weights converted by ``params_from_jax_tree``.
Both packages run each alignment route of the batch: the device aligner
(``device_alignment=True``; the port through the kernels' plain versions,
the JAX package through its Pallas kernels in interpret mode), with and
without disfluency detection, and the host route (``device_alignment=False``
or more alignment heads than ``MAX_K``). Segment tokens must be identical
and results equal under test_golden.py's ``loose`` rounding; the device flow must equal the host
loop exactly; the device-flow state functions must equal JAX's exactly.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from model_utils import N_LANGS, hf_model_to_jax, make_hf_model, make_tokenizer  # noqa: E402
from test_golden import loose  # noqa: E402
from whisper_timestamped_tpu.models.load import WhisperModel as JaxModel  # noqa: E402
from whisper_timestamped_tpu.parallel import batch as JB  # noqa: E402
from whisper_timestamped_tpu.parallel import deviceflow as JF  # noqa: E402
from whisper_timestamped_tpu_torch import transcribe_timestamped  # noqa: E402
from whisper_timestamped_tpu_torch.engine import DecodeEngine  # noqa: E402
from whisper_timestamped_tpu_torch.models import WhisperDims, WhisperModel, params_from_jax_tree  # noqa: E402
from whisper_timestamped_tpu_torch.parallel import batch as B  # noqa: E402
from whisper_timestamped_tpu_torch.parallel import deviceflow as F  # noqa: E402
from whisper_timestamped_tpu_torch.tokenizer import get_tokenizer, synthetic_ranks  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HEADS = [(0, 1), (1, 0), (1, 2)]
KW = dict(language="en", batch_size=4, temperature=[0.0], no_speech_threshold=None,
          logprob_threshold=None, compression_ratio_threshold=None)


def _audio(seed, seconds):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(16000 * seconds)) * 0.1).astype(np.float32)


AUDIOS = {"a": _audio(0, 8), "b": _audio(1, 5), "c": _audio(2, 12)}


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


def _tokens(res):
    return [s["tokens"] for s in res["segments"]]


def test_transcribe_batch_matches_jax(models):
    jax_model, model = models
    got = B.transcribe_batch(model, AUDIOS, _tok(), device_alignment=True, **KW)
    want = JB.transcribe_batch(jax_model, AUDIOS, make_tokenizer(language="en", task="transcribe"),
                               device_alignment=True, **KW)
    assert list(got) == list(want)
    for name in AUDIOS:
        assert _tokens(got[name]) == _tokens(want[name]), name
        assert loose(got[name]) == loose(want[name]), name
    assert sum(len(s.get("words", [])) for r in got.values() for s in r["segments"]) > 0


BATCH_ROUTES = {
    "device_disfluencies": dict(device_alignment=True, detect_disfluencies=True),
    "host": dict(device_alignment=False),
    "host_disfluencies": dict(device_alignment=False, detect_disfluencies=True),
    "host_over_max_k": dict(device_alignment=True, detect_disfluencies=True),
}


@pytest.mark.parametrize("route", sorted(BATCH_ROUTES))
def test_transcribe_batch_routes_match_jax(models, monkeypatch, route):
    """Each alignment route of the batch, port against JAX's
    ``transcribe_batch`` with the same options (as test_batch.py:324 and
    :377 hold JAX's routes to each other). ``host_over_max_k`` sets both
    packages' ``MAX_K`` to 2, below the model's 3 heads: device alignment
    requested, the host route taken."""
    import whisper_timestamped_tpu.device_align as jax_device_align

    jax_model, model = models
    if route == "host_over_max_k":
        monkeypatch.setattr(jax_device_align, "MAX_K", 2)
        monkeypatch.setattr(B, "MAX_K", 2)
    opts = {**KW, **BATCH_ROUTES[route]}
    got = B.transcribe_batch(model, AUDIOS, _tok(), **opts)
    want = JB.transcribe_batch(jax_model, AUDIOS, make_tokenizer(language="en", task="transcribe"),
                               **opts)
    assert list(got) == list(want)
    for name in AUDIOS:
        assert _tokens(got[name]) == _tokens(want[name]), name
        assert loose(got[name]) == loose(want[name]), name
    assert sum(len(s.get("words", [])) for r in got.values() for s in r["segments"]) > 0


def test_transcribe_batch_matches_serial(models):
    """Each stream of the batch equals the port's serial transcribe_timestamped."""
    _, model = models
    got = B.transcribe_batch(model, AUDIOS, _tok(), **KW)
    serial_kw = {k: v for k, v in KW.items() if k not in ("batch_size", "temperature")}
    for name, audio in AUDIOS.items():
        serial = transcribe_timestamped(model, audio, tokenizer=_tok(), **serial_kw)
        assert _tokens(got[name]) == _tokens(serial), name
        assert loose(got[name]) == loose(serial), name


def test_transcribe_batch_detects_each_language(models):
    """language=None: the batched language ID gives each stream the serial
    path's language, its probabilities and its tokens."""
    _, model = models
    audios = {"x": _audio(3, 4), "y": _audio(4, 6)}
    kw = {k: v for k, v in KW.items() if k != "language"}
    got = B.transcribe_batch(model, audios, _tok(None), **kw)
    serial_kw = {k: v for k, v in kw.items() if k not in ("batch_size", "temperature")}
    for name, audio in audios.items():
        serial = transcribe_timestamped(model, audio, tokenizer=_tok(None), **serial_kw)
        assert got[name]["language"] == serial["language"]
        assert loose(got[name]["language_probs"]) == loose(serial["language_probs"])
        assert _tokens(got[name]) == _tokens(serial), name


def _run_flow(model, flow: bool, monkeypatch, **kw):
    # staggered lengths: streams finish at different iterations, so the flow
    # keeps decoding finished rows while others go on
    audios = {"a": _audio(0, 15), "b": _audio(1, 35), "c": _audio(2, 5)}
    monkeypatch.setenv("WTT_DEVICE_FLOW", "1" if flow else "0")
    opts = {**KW, "no_speech_threshold": None, "logprob_threshold": None, **kw}
    return B.transcribe_batch(model, audios, _tok(), **opts)


FLOW_CASES = {
    "conditioned": dict(),
    "unconditioned": dict(condition_on_previous_text=False, initial_prompt="hello there"),
    "thresholds": dict(no_speech_threshold=0.6, logprob_threshold=-1.0),
}


@pytest.mark.parametrize("case", sorted(FLOW_CASES))
def test_device_flow_matches_host_loop(models, monkeypatch, case):
    """The device flow gives exactly the host window loop's results
    (``WTT_DEVICE_FLOW=0``), as tests/test_deviceflow.py holds the JAX one."""
    _, model = models
    ref = _run_flow(model, False, monkeypatch, **FLOW_CASES[case])
    got = _run_flow(model, True, monkeypatch, **FLOW_CASES[case])
    assert got == ref
    assert any(len(r["segments"]) > 1 for r in got.values())


# ---------------------------------------------------------------------------
# device-flow state functions against JAX's, on seeded inputs
# ---------------------------------------------------------------------------

TOK = make_tokenizer(language="en", task="transcribe")
EOT, TSB = TOK.eot, TOK.timestamp_begin


def _token_rows(seed, Bn=16, M=48):
    """Rows mixing text, timestamps, consecutive pairs and early EOTs."""
    rng = np.random.default_rng(seed)
    rows = np.full((Bn, M), EOT, np.int32)
    for b in range(Bn):
        n = int(rng.integers(0, M + 1))
        kinds = rng.random(n)
        text = rng.integers(100, 400, n)
        ts = TSB + rng.integers(0, 1501, n)
        rows[b, :n] = np.where(kinds < 0.35, ts, text)
        if b % 4 == 1 and n >= 4:  # a consecutive pair mid-row
            rows[b, n // 2: n // 2 + 2] = TSB + 40
    return rows


@pytest.mark.parametrize("thresholds", [(None, None), (0.5, -1.0), (0.5, None), (0.0, -0.5)])
def test_advance_window_state_matches_jax(thresholds):
    nsp_thr, lp_thr = thresholds
    tokens = _token_rows(1)
    Bn, H = tokens.shape[0], 64
    rng = np.random.default_rng(2)
    seek = rng.integers(0, 3000, Bn).astype(np.int32)
    content = (seek + rng.integers(-100, 9000, Bn)).astype(np.int32)
    done = rng.random(Bn) < 0.2
    hist = rng.integers(100, 400, (Bn, H)).astype(np.int32)
    count = rng.integers(0, H + 1, Bn).astype(np.int32)
    nsp = rng.uniform(0, 1, Bn).astype(np.float32)
    sum_lp = rng.uniform(-40, 0, Bn).astype(np.float32)
    kw = dict(eot=EOT, ts_begin=TSB, no_speech_threshold=nsp_thr, logprob_threshold=lp_thr)
    want = JF.advance_window_state(
        jnp.asarray(tokens), JF.WindowState(*(jnp.asarray(a) for a in (seek, done, hist, count))),
        jnp.asarray(content), no_speech_prob=jnp.asarray(nsp), sum_logprobs=jnp.asarray(sum_lp),
        **kw)
    got = F.advance_window_state(
        torch.from_numpy(tokens),
        F.WindowState(*(torch.from_numpy(a) for a in (seek, done, hist, count))),
        torch.from_numpy(content), no_speech_prob=torch.from_numpy(nsp),
        sum_logprobs=torch.from_numpy(sum_lp), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_build_prompt_batch_and_pack_match_jax():
    rng = np.random.default_rng(3)
    Bn, H, M = 5, 223, 24
    hist = rng.integers(100, 400, (Bn, H)).astype(np.int32)
    count = np.asarray([0, 1, 50, 223, 300], np.int32)
    sot = np.tile(np.asarray([TOK.sot, TOK.to_language_token("en"), TOK.transcribe], np.int32),
                  (Bn, 1))
    kw = dict(region=232, eot=EOT, sot_prev=TOK.sot_prev)
    want = JF.build_prompt_batch(jnp.asarray(hist), jnp.asarray(count), jnp.asarray(sot), **kw)
    got = F.build_prompt_batch(torch.from_numpy(hist), torch.from_numpy(count),
                               torch.from_numpy(sot), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    tokens = rng.integers(0, 2**31 - 1, (Bn, M), dtype=np.int32)
    tokens[0, 0] = 0x7FC00000  # a NaN bit pattern survives the round trip
    lp = rng.standard_normal((Bn, M)).astype(np.float32)
    sums, nsp = rng.standard_normal(Bn).astype(np.float32), rng.random(Bn).astype(np.float32)
    seek = np.asarray([0, 1, 2**30, -7, 2999], np.int32)
    done = np.asarray([True, False, True, False, False])
    st_j = JF.WindowState(jnp.asarray(seek), jnp.asarray(done), jnp.asarray(hist), jnp.asarray(count))
    st_t = F.WindowState(*(torch.from_numpy(a) for a in (seek, done, hist, count)))
    p_j = np.asarray(JF.pack_host_outputs(jnp.asarray(tokens), jnp.asarray(lp), jnp.asarray(sums),
                                          jnp.asarray(nsp), st_j))
    p_t = F.pack_host_outputs(torch.from_numpy(tokens), torch.from_numpy(lp),
                              torch.from_numpy(sums), torch.from_numpy(nsp), st_t).numpy()
    np.testing.assert_array_equal(p_t.view(np.int32), p_j.view(np.int32))
    for g, w in zip(F.split_host_outputs(p_t, M), (tokens, lp, sums, nsp, done, seek)):
        np.testing.assert_array_equal(g, w)


def test_initial_state_matches_jax():
    args = ([[1, 2, 3], list(range(400))], [100, 3000], [5000, 2900])
    kw = dict(batch_size=4, hist_len=223, eot=EOT)
    st_j, fr_j = JF.initial_state(*args, **kw)
    st_t, fr_t = F.initial_state(*args, **kw)
    for g, w in zip((*st_t, fr_t), (*st_j, fr_j)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_window_gather_and_batched_mel_match_jax(models):
    """The batched mel equals JAX's prepare_audio_batch, and the window
    gather reproduces dynamic_slice, its start clamp included."""
    jax_model, _ = models
    audios = {"s0": _audio(50, 4), "s1": _audio(51, 33)}
    want = np.array(JB.prepare_audio_batch(audios, 80).mel_stack)
    got = B.prepare_audio_batch(audios, 80, "cpu").mel_stack
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    rows = np.asarray([1, 0, 1, 0], np.int32)
    seeks = np.asarray([0, 150, 3100, 9999], np.int32)  # the last two are clamped
    w_j = np.asarray(JB._slice_windows_jit(jnp.asarray(want), jnp.asarray(rows), jnp.asarray(seeks)))
    w_t = B.slice_windows(torch.from_numpy(want), torch.from_numpy(rows), torch.from_numpy(seeks))
    np.testing.assert_array_equal(w_t.numpy(), w_j)


# ---------------------------------------------------------------------------
# the serving loop
# ---------------------------------------------------------------------------

STREAM_KW = dict(language="en", batch_size=2, temperature=[0.0], no_speech_threshold=0.6,
                 logprob_threshold=-1.0)


def test_stream_matches_per_batch_calls(models):
    _, model = models
    batches = [{"a": _audio(20, 4), "b": _audio(21, 6)}, {"c": _audio(22, 3)},
               {"d": _audio(23, 5), "e": _audio(24, 4)}]
    engine = DecodeEngine(model, _tok())
    got = list(B.transcribe_batch_stream(model, iter(batches), _tok(), engine=engine, **STREAM_KW))
    want = [B.transcribe_batch(model, b, _tok(), engine=engine, **STREAM_KW) for b in batches]
    assert got == want


def test_prepared_audio_mismatch_raises(models):
    _, model = models
    prepared = B.prepare_audio_batch({"x": _audio(27, 3)}, 80, "cpu")
    with pytest.raises(ValueError, match="does not match"):
        B.transcribe_batch(model, {"y": _audio(28, 3)}, _tok(), _prepared=prepared, **STREAM_KW)


def test_stream_source_exception_propagates(models):
    _, model = models

    def bad():
        yield {"a": _audio(41, 3)}
        raise RuntimeError("source broke")

    gen = B.transcribe_batch_stream(model, bad(), _tok(), **STREAM_KW)
    assert list(next(gen)) == ["a"]
    with pytest.raises(RuntimeError, match="source broke"):
        for _ in gen:
            pass


def test_stream_early_close_leaves_no_thread(models):
    _, model = models

    def endless():
        i = 0
        while True:
            yield {f"x{i}": _audio(30 + i, 2)}
            i += 1

    engine = DecodeEngine(model, _tok())
    gen = B.transcribe_batch_stream(model, endless(), _tok(), engine=engine, **STREAM_KW)
    first = next(gen)
    assert list(first) == ["x0"] and first["x0"]["segments"]
    gen.close()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and any(
            t.name.startswith(("wtt-prefetch", "wtt-assemble")) for t in threading.enumerate()):
        time.sleep(0.05)
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith(("wtt-prefetch", "wtt-assemble"))]
    again = B.transcribe_batch(model, {"y": _audio(40, 3)}, _tok(), engine=engine, **STREAM_KW)
    assert again["y"]["segments"]


def test_stage_timers_lose_no_update_across_threads():
    """The serving loop times stages from its assembly thread too: counts
    from many threads with a tiny switch interval must all land."""
    import sys

    from whisper_timestamped_tpu_torch.utils import profiling

    n_threads, n_each = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        profiling.reset_stage_timings()

        def work():
            for _ in range(n_each):
                profiling.add_count("stress", 1)
                with profiling.stage_timer("stress_stage"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        counts = profiling.get_counts()
        assert counts["stress"] == n_threads * n_each
        assert counts["stress_stage"] == n_threads * n_each
    finally:
        sys.setswitchinterval(old)
        profiling.reset_stage_timings()


NOT_PORTED = {
    "mesh": dict(mesh=object()),
    "vad": dict(vad="auditok"),
}


@pytest.mark.parametrize("option", sorted(NOT_PORTED))
def test_unported_options_raise(models, option, tmp_path):
    """Both options, once refused, now run. ``mesh``: on a one-rank gloo
    mesh (dp=1, tp=1) ``transcribe_batch`` and the serving loop return the
    results of the port's own calls without a mesh (test_torch_mesh_batch.py
    holds dp and tp > 1 to JAX); a ``mesh`` that is not a mesh raises
    ``TypeError``. ``vad``: the batch's results equal JAX's
    ``transcribe_batch`` with the same VAD, with each stream's
    ``speech_activity`` (test_torch_vad.py holds more cases)."""
    jax_model, model = models
    kw = {**KW, **NOT_PORTED[option]}
    if option == "mesh":
        from torch_mesh_ranks import one_rank_mesh

        audios = {"a": _audio(5, 2), "b": _audio(1, 5)}
        with pytest.raises(TypeError, match="DeviceMesh"):
            B.transcribe_batch(model, audios, _tok(), **kw)
        want = B.transcribe_batch(model, audios, _tok(), **KW)
        with one_rank_mesh(str(tmp_path)) as mesh:
            got = B.transcribe_batch(model, audios, _tok(), **{**kw, "mesh": mesh})
            served = list(B.transcribe_batch_stream(model, iter([audios]), _tok(),
                                                    **{**kw, "mesh": mesh}))
        assert got == want and served == [want]
        return
    audios = {"a": _audio(5, 2), "b": _audio(1, 5)}
    got = B.transcribe_batch(model, audios, _tok(), device_alignment=True, **kw)
    want = JB.transcribe_batch(jax_model, audios, make_tokenizer(language="en", task="transcribe"),
                               device_alignment=True, **kw)
    assert list(got) == list(want)
    for name in audios:
        assert got[name]["speech_activity"] == want[name]["speech_activity"], name
        assert loose(got[name]) == loose(want[name]), name


def test_unported_transcriber_options_and_fallback_raise(models, monkeypatch):
    """A ``mesh`` that is not a mesh raises ``TypeError`` (a one-rank mesh
    runs: test_unported_options_raise). ``tail_batch=2`` runs (``test_batch.py:186``'s
    case, with one stream long enough for two windows, so that the tail
    runs): once at most two streams are active the windows decode at B=2, with no
    device flow, and the segments and words equal the JAX transcriber's
    with ``tail_batch`` and the port's own without it (``WTT_TAIL_BATCH``
    for ``transcribe_batch``, as in JAX). The fallback re-decode runs:
    random weights fail the logprob threshold at 0.0, every window is
    decoded again at 0.2 (JAX's noise substituted), and the segments equal
    the JAX transcriber's."""
    from test_torch_sampling import jax_gumbel_source
    from whisper_timestamped_tpu.engine import DecodeEngine as JaxEngine
    from whisper_timestamped_tpu_torch import decoding
    from whisper_timestamped_tpu_torch.decoding import DecodingOptions
    from whisper_timestamped_tpu_torch.utils import get_stage_timings, reset_stage_timings

    jax_model, model = models
    engine = DecodeEngine(model, _tok())
    with pytest.raises(TypeError, match="DeviceMesh"):
        B.BatchTranscriber(engine, mesh=object())

    audios = {"a": _audio(0, 5), "b": _audio(1, 8), "c": _audio(2, 45)}
    tail = B.BatchTranscriber(engine, batch_size=4, tail_batch=2)
    assert not tail._device_flow_ok(list(audios), DecodingOptions(), [0.0])
    assert B.BatchTranscriber(engine, batch_size=4)._device_flow_ok(list(audios), DecodingOptions(),
                                                                    [0.0])
    skw = dict(language="en", temperature=[0.0], no_speech_threshold=None, logprob_threshold=None)
    reset_stage_timings()
    got = tail.transcribe_streams(audios, **skw)
    assert any(k.startswith("batch_decode_b2_") for k in get_stage_timings()), "no tail window"
    full = B.BatchTranscriber(engine, batch_size=4).transcribe_streams(audios, **skw)
    want = JB.BatchTranscriber(JaxEngine(jax_model, make_tokenizer(language="en", task="transcribe")),
                               batch_size=4, tail_batch=2).transcribe_streams(audios, **skw)
    for name in audios:
        for other in (full, want):
            assert [s.tokens for s in got[name]] == [s.tokens for s in other[name]], name
            assert [(s.start, s.end) for s in got[name]] == [(s.start, s.end) for s in other[name]]
    monkeypatch.setenv("WTT_TAIL_BATCH", "2")
    got_w = B.transcribe_batch(model, audios, _tok(), **KW)
    want_w = JB.transcribe_batch(jax_model, audios, make_tokenizer(language="en", task="transcribe"),
                                 **KW)
    monkeypatch.delenv("WTT_TAIL_BATCH")
    full_w = B.transcribe_batch(model, audios, _tok(), **KW)
    for name in audios:
        assert loose(got_w[name]) == loose(want_w[name]) == loose(full_w[name]), name

    monkeypatch.setattr(decoding, "make_gumbel_source", jax_gumbel_source)
    kw = dict(language="en", temperature=(0.0, 0.2), logprob_threshold=0.0,
              no_speech_threshold=None)
    got = B.BatchTranscriber(engine, batch_size=2).transcribe_streams({"a": _audio(6, 3)}, **kw)
    want = JB.BatchTranscriber(JaxEngine(jax_model, make_tokenizer(language="en",
                                                                   task="transcribe")),
                               batch_size=2).transcribe_streams({"a": _audio(6, 3)}, **kw)
    assert got["a"] and {s.temperature for s in got["a"]} == {0.2}
    assert [s.tokens for s in got["a"]] == [s.tokens for s in want["a"]]
    assert [(s.start, s.end) for s in got["a"]] == [(s.start, s.end) for s in want["a"]]
