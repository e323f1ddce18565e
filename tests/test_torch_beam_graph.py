"""Beam search's token loop as a step function over device state, against JAX's.

``decoding_beam.beam_core`` runs ``_beam_step`` (JAX's ``while_loop`` body
of ``_beam_core_batched``) in chunks of ``decoding.STOP_CHECK_STEPS``
steps, gated on JAX's ``cond``, with the host testing for the stop between
chunks; on the card each chunk is a captured CUDA graph, on the CPU the
same function runs eagerly in the same chunks. The self cache is never
reordered: a row table names the physical row of each beam row's slot,
and ``self_attn_decode`` reads through it.

Held here: every buffer ``beam_core`` returns against the buffers of JAX's
``decode_window_beam_jit`` / ``decode_window_beam_batch_jit`` through the
two engines (timestamps on and off, ``kv_int8``, one window and three that
stop at different steps, a prompt at which the text-context stop fires);
chunk sizes 1, 3 and 16 against each other bit for bit; steps past the
stop inert; the plain self attention through a table against the same
over the physically gathered cache (JAX's route), over random beam
histories; and no host read inside the step.

Tolerances (those of ``test_torch_beam.py``): the scores at atol 1e-4
(under ``kv_int8`` 2e-3: JAX's XLA math rounds the int8 q·k products to
bf16, the port keeps them f32), the no-speech probability at 1e-5; tokens,
lengths, counts and steps exactly.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import whisper_timestamped_tpu.decoding_beam as jax_beam_mod  # noqa: E402
from model_utils import hf_model_to_jax, make_hf_model, make_tokenizer  # noqa: E402
from test_torch_beam import EOT, _mel, _pair, _tok  # noqa: E402
from test_torch_decode_graph import _raw  # noqa: E402
from whisper_timestamped_tpu.decoding import DecodingOptions as JaxOptions  # noqa: E402
from whisper_timestamped_tpu.engine import DecodeEngine as JaxEngine  # noqa: E402
from whisper_timestamped_tpu_torch import decoding  # noqa: E402
from whisper_timestamped_tpu_torch import decoding_beam as DB  # noqa: E402
from whisper_timestamped_tpu_torch.decoding import DecodingOptions  # noqa: E402
from whisper_timestamped_tpu_torch.engine import DecodeEngine  # noqa: E402
from whisper_timestamped_tpu_torch.ops import kernels as K  # noqa: E402
from whisper_timestamped_tpu_torch.utils import get_counts  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The golden model: EOT's logit is 0, so no beam finishes."""
    return _pair(*hf_model_to_jax(make_hf_model(seed=0)))


@pytest.fixture(scope="module")
def eot_models():
    """``test_torch_beam.py``'s model with a reachable EOT (the bias 0.3)."""
    params, dims = hf_model_to_jax(make_hf_model(seed=0))
    params = copy.deepcopy(params)
    e = np.random.default_rng(1).standard_normal(dims.n_text_state).astype(np.float32) * 0.02
    emb = np.array(params["decoder"]["tok_emb"])
    emb[EOT] = e
    params["decoder"]["tok_emb"] = emb
    params["decoder"]["ln"]["b"] = np.asarray(params["decoder"]["ln"]["b"]) + 0.3 * e / (e @ e)
    return _pair(params, dims)


BATCH_MELS = [(0, 0.5), (7, 0.4), (8, 0.2)]
BATCH_PROMPTS = [[], [301, 302, 303, 304], [311, 312]]
BATCH_LANGUAGES = ["en", "fr", None]

# model, window batch, options, prompt, engine lever; and what the case
# shows: the steps of each window JAX runs
CASES = {
    # the pool fills after 8 steps, inside the first chunk
    "timestamps_k3": ("eot", 1, dict(beam_size=3), [301, 302], {}, [8]),
    # no beam pools its C; the loop runs to max_new, a whole number of chunks
    "no_timestamps_k3": ("eot", 1, dict(beam_size=3, without_timestamps=True), [301, 302], {},
                         [32]),
    "kv_int8_k3": ("eot", 1, dict(beam_size=3), [301, 302], dict(kv_int8=True), [8]),
    # three windows that stop at steps 27, 30 and 11
    "batch_b3_k2": ("eot", 3, dict(beam_size=2), None, {}, [27, 30, 11]),
    # a 300-token prompt (kept to 223, 227 slots with the sot sequence): the
    # window stops where the text context is used up, at step 447 - 227
    "text_ctx_stop_k2": ("plain", 1, dict(beam_size=2, sample_len=224), list(range(300, 600)),
                         {}, [220]),
}
INT_BUFFERS = ("finished_seqs", "finished_len", "n_finished", "beam_tokens", "n_steps")
SCORES = ("finished_scores", "beam_scores")


def _decode(engine, batch: int, opts: dict, prompt, jax_side: bool):
    """One beam decode through the engine: B=1 ``decode_window_beam``, else
    ``decode_window_beam_batch`` over BATCH_MELS."""
    options = (JaxOptions if jax_side else DecodingOptions)(
        language="en", **{"sample_len": 32, **opts})
    if batch == 1:
        return engine.decode_window_beam(_mel(), options, prompt)
    mels = np.stack([_mel(seed, scale) for seed, scale in BATCH_MELS])
    return engine.decode_window_beam_batch(mels, options, BATCH_PROMPTS, BATCH_LANGUAGES)


def _port_buffers(model, batch, opts, prompt, lever, monkeypatch):
    seen = _raw(monkeypatch, DB, "beam_core")
    before = get_counts().get("beam_chunks", 0)
    _decode(DecodeEngine(model, _tok(), **lever), batch, opts, prompt, False)
    monkeypatch.undo()
    return seen[0], get_counts()["beam_chunks"] - before


def _jax_buffers(jax_model, batch, opts, prompt, lever, monkeypatch):
    name = "decode_window_beam_jit" if batch == 1 else "decode_window_beam_batch_jit"
    seen = _raw(monkeypatch, jax_beam_mod, name)
    _decode(JaxEngine(jax_model, make_tokenizer(language="en", task="transcribe"), **lever),
            batch, opts, prompt, True)
    monkeypatch.undo()
    out = {k: np.asarray(v) for k, v in seen[0].items()}
    return out if batch > 1 else {k: v[None] for k, v in out.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_beam_buffers_match_jax(models, eot_models, monkeypatch, case):
    """Every buffer ``beam_core`` returns equals JAX's: the pool (its
    sequences, lengths and count), the beams' tokens, the steps of each
    window exactly; the scores and the no-speech probability within the
    tolerances above. The loop ran ceil(steps / STOP_CHECK_STEPS) chunks."""
    which, batch, opts, prompt, lever, steps = CASES[case]
    jax_model, model = eot_models if which == "eot" else models
    got, chunks = _port_buffers(model, batch, opts, prompt, lever, monkeypatch)
    want = _jax_buffers(jax_model, batch, opts, prompt, lever, monkeypatch)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["n_steps"].numpy(), steps)
    assert chunks == -(-max(steps) // decoding.STOP_CHECK_STEPS)
    for name in INT_BUFFERS:
        np.testing.assert_array_equal(got[name].numpy(), want[name], err_msg=name)
    tol = 2e-3 if lever.get("kv_int8") else 1e-4
    for name in SCORES:
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=0, atol=tol, err_msg=name)
    np.testing.assert_allclose(got["no_speech_prob"].numpy(), want["no_speech_prob"], atol=1e-5)
    if which == "eot":
        assert (got["n_finished"].numpy() > 0).all()


@pytest.mark.parametrize("k", [1, 3])
def test_chunk_size_does_not_change_the_buffers(eot_models, monkeypatch, k):
    """k = 1 and k = 3 steps between the host's checks give the buffers of
    the default 16 bit for bit, in ceil(30 / k) chunks (the longest window
    runs 30 steps): the steps past the stop change nothing."""
    _, model = eot_models
    args = (3, dict(beam_size=2), None, {})
    want, _ = _port_buffers(model, *args, monkeypatch)
    monkeypatch.setattr(decoding, "STOP_CHECK_STEPS", k)
    got, chunks = _port_buffers(model, *args, monkeypatch)
    assert chunks == -(-30 // k)
    for name, t in want.items():
        assert torch.equal(got[name], t), name


def test_steps_past_the_stop_change_nothing(eot_models, monkeypatch):
    """From the loop's end state (three windows, stopped at steps 27, 30
    and 11), a further chunk changes no beam, score, pool entry, step count
    or ``i``, no table column a step has written and no cache slot below
    the stop; its pool writes went to the spare slot only."""
    _, model = eot_models
    seen = {}
    orig = DB._beam_chunk

    def grab(model_, cache, st_, cfg, n):
        seen.update(cache=cache, st=st_, cfg=cfg)
        orig(model_, cache, st_, cfg, n)

    monkeypatch.setattr(DB, "_beam_chunk", grab)
    _port_buffers(model, 3, dict(beam_size=2), None, {}, monkeypatch)
    s, cfg, cache = seen["st"], seen["cfg"], seen["cache"]
    n = int(s.i)
    assert n == 30 and s.status.tolist() == [0, 30]
    C = cfg.C
    fields = ("i", "last_logits", "last_token", "penult_token", "max_timestamp", "tokens",
              "sum_logprobs", "n_finished", "steps")
    before = {f: getattr(s, f).clone() for f in fields}
    pool = {f: getattr(s, f)[:, :C].clone() for f in ("fin_seqs", "fin_scores", "fin_len")}
    table = s.src_row[:, :cfg.P + n].clone()
    written = [t[:, :, :cfg.P + n].clone() for t in (cache.k, cache.v)]
    orig(model.module, cache, s, cfg, 5)
    for f, t in before.items():
        assert torch.equal(getattr(s, f), t), f
    for f, t in pool.items():
        assert torch.equal(getattr(s, f)[:, :C], t), f
    assert torch.equal(s.src_row[:, :cfg.P + n], table)
    assert all(torch.equal(t[:, :, :cfg.P + n], w) for t, w in zip((cache.k, cache.v), written))
    assert s.status.tolist() == [0, 30]


def _histories(draw_src, n_steps: int, B: int, Kb: int, P: int, ctx: int, L: int, D: int,
               seed: int):
    """A random beam history of ``n_steps`` steps, kept both ways: the
    physical cache JAX keeps (gathered by the source rows each step, then
    the step's rows written at slot P + i) and the port's store and row
    table (the prompt written to row b*Kb only, the other rows' prompt
    slots garbage; the table gathered, column P + i set to each row, the
    step's rows written to their own rows)."""
    rng = np.random.default_rng(seed)
    R = B * Kb
    prompt = torch.from_numpy(rng.standard_normal((L, B, P, D)).astype(np.float32))
    phys = torch.from_numpy(rng.standard_normal((L, R, ctx, D)).astype(np.float32))
    store = torch.from_numpy(rng.standard_normal((L, R, ctx, D)).astype(np.float32))
    phys[:, :, :P] = prompt.repeat_interleave(Kb, dim=1)
    store[:, ::Kb, :P] = prompt
    row = torch.arange(R)
    table = torch.where(torch.arange(ctx)[None] < P, (row // Kb * Kb)[:, None], row[:, None])
    table = table.to(torch.int32)
    for i, src in enumerate(draw_src):
        rows = (torch.arange(B)[:, None] * Kb + torch.tensor(src)).reshape(-1)
        new = torch.from_numpy(rng.standard_normal((L, R, D)).astype(np.float32))
        phys = phys[:, rows]
        phys[:, :, P + i] = new
        table = table[rows]
        table[:, P + i] = row.to(torch.int32)
        store[:, :, P + i] = new
    return phys, store, table


@settings(max_examples=25, deadline=None, database=None)
@given(data=st.data())
def test_self_attn_plain_through_the_table_equals_the_gathered_cache(data):
    """``self_attn_decode_plain`` through the row table over the port's
    store equals it over the physically gathered cache (JAX's route) bit
    for bit, at the step's slot and the window's extent, over random beam
    histories and pad lengths; an identity table equals no table bit for
    bit."""
    B, Kb, P, L, H, D = 2, 3, 4, 2, 2, 128
    n = data.draw(st.integers(1, 9), label="steps")
    srcs = [data.draw(st.lists(st.lists(st.integers(0, Kb - 1), min_size=Kb, max_size=Kb),
                               min_size=B, max_size=B)) for _ in range(n)]
    ctx = data.draw(st.sampled_from([P + n, P + n + 3]), label="ctx")
    seed = data.draw(st.integers(0, 2**16), label="seed")
    phys, store, table = _histories(srcs, n, B, Kb, P, ctx, L, D, seed)
    rng = np.random.default_rng(seed + 1)
    R = B * Kb
    q = torch.from_numpy(rng.standard_normal((R, 1, D)).astype(np.float32))
    pad = torch.from_numpy(rng.integers(0, P + 1, R).astype(np.int32))
    slot = torch.tensor(P + n - 1, dtype=torch.int32)
    ident = torch.arange(R, dtype=torch.int32)[:, None].expand(R, ctx).contiguous()
    for layer in range(L):
        want = K.self_attn_decode_plain(q, phys, phys.flip(0), layer, slot, pad, H, extent=ctx)
        got = K.self_attn_decode_plain(q, store, store.flip(0), layer, slot, pad, H, extent=ctx,
                                       src_row=table)
        assert torch.equal(got, want)
        assert torch.equal(
            K.self_attn_decode_plain(q, store, store.flip(0), layer, slot, pad, H, extent=ctx,
                                     src_row=ident),
            K.self_attn_decode_plain(q, store, store.flip(0), layer, slot, pad, H, extent=ctx))


def test_self_attn_wrapper_reads_through_the_table_and_writes_its_own_row():
    """On CPU tensors ``self_attn_decode`` with the step's rows and a table
    writes slot pos of each row (``write_row``) and attends through the
    table: the same as the plain version over the cache written by hand."""
    rng = np.random.default_rng(3)
    L, R, ctx, D, H, pos = 2, 4, 10, 128, 2, 6
    k_all = torch.from_numpy(rng.standard_normal((L, R, ctx, D)).astype(np.float32))
    v_all = torch.from_numpy(rng.standard_normal((L, R, ctx, D)).astype(np.float32))
    q, k_new, v_new = (torch.from_numpy(rng.standard_normal((R, 1, D)).astype(np.float32))
                       for _ in range(3))
    table = torch.from_numpy(rng.integers(0, R, (R, ctx)).astype(np.int32))
    table[:, pos] = torch.arange(R, dtype=torch.int32)
    pad = torch.tensor([0, 1, 3, 7], dtype=torch.int32)
    k_p, v_p = k_all.clone(), v_all.clone()
    k_p[1, :, pos], v_p[1, :, pos] = k_new[:, 0], v_new[:, 0]
    want = K.self_attn_decode_plain(q, k_p, v_p, 1, pos, pad, H, extent=ctx, src_row=table)
    got = K.self_attn_decode(q, k_all, v_all, 1, torch.tensor(pos, dtype=torch.int32), pad, H,
                             k_new=k_new, v_new=v_new, extent=ctx, src_row=table)
    assert torch.equal(got, want) and torch.equal(k_all, k_p) and torch.equal(v_all, v_p)


def test_beam_step_makes_no_host_read(eot_models, monkeypatch):
    """Inside ``_beam_step`` no tensor is read by the host: ``item``,
    ``tolist`` and the conversions to bool, int and float raise there. The
    decode still runs to its end (three windows, 30 steps)."""
    _, model = eot_models
    calls = []
    orig = DB._beam_step

    def refuse(*args, **kwargs):
        raise AssertionError("host read inside the beam step")

    def guarded(*args):
        calls.append(1)
        with pytest.MonkeyPatch.context() as m:
            for name in ("item", "tolist", "__bool__", "__int__", "__float__"):
                m.setattr(torch.Tensor, name, refuse)
            orig(*args)

    monkeypatch.setattr(DB, "_beam_step", guarded)
    out, chunks = _port_buffers(model, 3, dict(beam_size=2), None, {}, monkeypatch)
    assert out["n_steps"].tolist() == [27, 30, 11]
    assert len(calls) == chunks * decoding.STOP_CHECK_STEPS == 32
