"""The port's mesh (``parallel/mesh.py`` on ``torch.distributed``) against the
JAX package's, in f32 on the CPU.

One spawned gloo world of 4 ranks (``torch_mesh_ranks.world_mesh``) runs
every check of this module; meanwhile this process computes JAX's side on
the virtual 8-device mesh of ``conftest.py``: the forward of
``test_parallel.py``'s geometry at tp=2 and tp=4 against JAX's unsharded and
dp=2 x tp=4 forwards (atol 2e-4, as ``test_parallel.py:60``), the greedy
window of ``test_batch.py:84`` on ``DecodeEngine(mesh=)`` at tp=2 and 4
(tokens equal, log-probs at 2e-4, attention at 2e-3), the ``kv_int8`` and
``self_kv_int8`` engines and beam 5 at tp=2, ``self_kv_int8`` and beam 5 at
tp=4 (tokens equal to JAX's mesh engines), a window sampled at T=0.7 at
tp=2 with JAX's noise for the seed (as the greedy window), the collectives
of a window (the chunks' stop flag a MAX over tp), gloo's eager chunks, the
quantizers' scales of the whole rows, and the refusals. A 6-head model
(tiny's head count at a narrower width, ``SIX_DIMS``) at tp=4, whose heads
are dealt 2, 2, 1, 1 (``mesh.head_deal``) where JAX's GSPMD cuts the same
axes evenly and splits heads: its q/k/v/o slices, the forward with the
alignment rows and every head's scores, the greedy, ``kv_int8``,
``self_kv_int8`` and beam-5 windows against JAX's tp=4 mesh, and the int8
caches' whole-row scales. The head deal and ``shard_slice`` are also held
without a world.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from model_utils import hf_model_to_jax, make_hf_model, make_tokenizer  # noqa: E402
from torch_mesh_ranks import SIX_DIMS, SIX_HEADS, run_world  # noqa: E402
from whisper_timestamped_tpu.audio import N_FRAMES, log_mel_spectrogram, pad_or_trim  # noqa: E402
from whisper_timestamped_tpu.decoding import DecodingOptions as JaxOptions  # noqa: E402
from whisper_timestamped_tpu.engine import DecodeEngine as JaxEngine  # noqa: E402
from whisper_timestamped_tpu.models import whisper_jax as JW  # noqa: E402
from whisper_timestamped_tpu.models.load import WhisperModel as JaxModel  # noqa: E402
from whisper_timestamped_tpu.parallel import mesh as JM  # noqa: E402
from whisper_timestamped_tpu_torch.decoding import STOP_CHECK_STEPS  # noqa: E402
from whisper_timestamped_tpu_torch.models import WhisperDims, params_from_jax_tree  # noqa: E402
from whisper_timestamped_tpu_torch.parallel import mesh as M  # noqa: E402

HEADS = [(0, 1), (1, 0), (1, 2)]
# tokens a window: every step of a tp mesh holds collectives, whose latency
# on a busy host is 0.3-4 ms each through gloo
SAMPLE_LEN = 24
# the sampled window's temperature and seed (JAX's engine draws its noise
# from PRNGKey(seed), one split a step)
SAMPLE_T, SAMPLE_SEED = 0.7, 3
# test_parallel.py's geometry
FWD_DIMS = dict(n_mels=80, n_audio_ctx=60, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
                n_vocab=1928, n_text_ctx=48, n_text_state=64, n_text_head=4, n_text_layer=2)


def _audio(seed, seconds):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(16000 * seconds) * 0.1).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_side(fwd_params, params, dims, six_params, inp):
    """JAX's forwards and mesh engines on the same inputs."""
    fdims, sdims = JW.WhisperDims(**FWD_DIMS), JW.WhisperDims(**SIX_DIMS)

    def fwd(p, mel, tokens):
        return JW.decode_full(p, tokens, JW.encode(p, mel, fdims), fdims)[0]

    def fwd_six(p, mel, tokens):
        return JW.decode_full(p, tokens, JW.encode(p, mel, sdims), sdims, return_cross_attn=True)

    mel, tokens = jnp.asarray(inp["fwd_mel"]), jnp.asarray(inp["fwd_tokens"])
    out = {"fwd_one": np.asarray(jax.jit(fwd)(fwd_params, mel, tokens))}
    mesh = JM.get_mesh(dp=2, tp=4)
    with mesh:
        out["fwd_mesh"] = np.asarray(jax.jit(fwd)(
            JM.shard_params(fwd_params, mesh), JM.shard_batch(mel, mesh),
            JM.shard_batch(tokens, mesh)))
        out["six_fwd_mesh"] = [np.asarray(a) for a in jax.jit(fwd_six)(
            JM.shard_params(six_params, mesh), JM.shard_batch(mel, mesh),
            JM.shard_batch(tokens, mesh))]
    out["six_fwd_one"] = [np.asarray(a) for a in jax.jit(fwd_six)(six_params, mel, tokens)]
    model = JaxModel(params=jax.tree.map(jnp.asarray, params), dims=dims, alignment_heads=HEADS)
    tok = make_tokenizer(language="en", task="transcribe")
    opts = JaxOptions(language="en", sample_len=SAMPLE_LEN)
    for tp in (2, 4):
        r = JaxEngine(model, tok, mesh=JM.get_mesh(tp=tp)).decode_window(inp["mel"], opts)[0]
        out[f"greedy_tp{tp}"] = r
    for lever in ("kv_int8", "self_kv_int8"):
        out[lever] = JaxEngine(model, tok, mesh=JM.get_mesh(tp=2),
                               **{lever: True}).decode_window(inp["mel"], opts)[0]
    beam_opts = JaxOptions(language="en", sample_len=SAMPLE_LEN, beam_size=5)
    out["beam"] = JaxEngine(model, tok, mesh=JM.get_mesh(tp=2)).decode_window_beam(
        inp["mel"], beam_opts)
    out["sampled"] = JaxEngine(model, tok, mesh=JM.get_mesh(tp=2)).decode_window(
        inp["mel"], opts, temperature=SAMPLE_T, rng_seed=SAMPLE_SEED)[0]
    out["self_kv_int8_tp4"] = JaxEngine(model, tok, mesh=JM.get_mesh(tp=4),
                                        self_kv_int8=True).decode_window(inp["mel"], opts)[0]
    out["beam_tp4"] = JaxEngine(model, tok, mesh=JM.get_mesh(tp=4)).decode_window_beam(
        inp["mel"], beam_opts)
    six = JaxModel(params=six_params, dims=sdims, alignment_heads=SIX_HEADS)
    for label, levers in (("greedy", {}), ("kv_int8", dict(kv_int8=True)),
                          ("self_kv_int8", dict(self_kv_int8=True))):
        out[f"six_{label}"] = JaxEngine(six, tok, mesh=JM.get_mesh(tp=4),
                                        **levers).decode_window(inp["mel"], opts)[0]
    out["six_beam"] = JaxEngine(six, tok, mesh=JM.get_mesh(tp=4)).decode_window_beam(
        inp["mel"], beam_opts)
    return out


def _jax_noise(seed: int, steps: int, V: int):
    """The (1, V) Gumbel draws of JAX's sampled loop for ``PRNGKey(seed)``,
    one split a step (``test_torch_sampling.jax_gumbel_source``)."""
    key, draws = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        draws.append(np.array(jax.random.gumbel(sub, (1, V), jnp.float32)))
    return draws


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the 4 ranks' results, JAX's results, the port model's JAX tree and dims, the
    6-head model's numpy tree)."""
    fwd_params = JW.init_params(JW.WhisperDims(**FWD_DIMS), jax.random.PRNGKey(1))
    six_params = JW.init_params(JW.WhisperDims(**SIX_DIMS), jax.random.PRNGKey(2))
    params, dims = hf_model_to_jax(make_hf_model(seed=0))
    rng = np.random.default_rng(0)
    inp = dict(
        fwd_tree=_np_tree(fwd_params), fwd_dims=FWD_DIMS,
        fwd_mel=(rng.standard_normal((2, 80, 120)) * 0.3).astype(np.float32),
        fwd_tokens=rng.integers(0, 300, (2, 8)).astype(np.int32),
        tree=_np_tree(params), dims=dims.__dict__, heads=HEADS, sample_len=SAMPLE_LEN,
        mel=pad_or_trim(np.asarray(log_mel_spectrogram(_audio(7, 6), n_mels=80)), N_FRAMES,
                        axis=-1),
        xa=rng.standard_normal((2, 40, 64)).astype(np.float32),
        rows=rng.standard_normal((3, 5, 64)).astype(np.float32),
        sample_t=SAMPLE_T, sample_seed=SAMPLE_SEED,
        # a draw for every step the port's loop runs: whole chunks
        sample_noise=_jax_noise(SAMPLE_SEED, -(-SAMPLE_LEN // STOP_CHECK_STEPS) * STOP_CHECK_STEPS,
                                dims.n_vocab),
        six_tree=_np_tree(six_params), six_dims=SIX_DIMS, six_heads=SIX_HEADS,
        six_xa=rng.standard_normal((2, 40, 96)).astype(np.float32),
        six_rows=rng.standard_normal((3, 5, 96)).astype(np.float32),
    )
    ranks, jax_out = run_world(4, "world_mesh", inp, str(tmp_path_factory.mktemp("mesh")),
                               overlap=lambda: _jax_side(fwd_params, params, dims, six_params,
                                                         inp))
    return ranks, jax_out, params, dims, inp["six_tree"]


def test_param_shard_dims_match_jax_pspecs(world):
    """Every leaf's axis is JAX's ``param_pspec_tree`` entry in the port's
    (L, out, in) layout: "tp" at JAX's axis 2 (out) is axis 1, at 1 (in) is 2."""
    _, _, params, dims, _ = world
    model = params_from_jax_tree(params, WhisperDims(**dims.__dict__), device="cpu")
    got = M.param_shard_dims(model)
    specs = JM.param_pspec_tree(params)
    want = {}
    for part in ("encoder", "decoder"):
        blocks = specs[part]["blocks"]
        for p in ("attn", "cross") if part == "decoder" else ("attn",):
            want[f"{part}.{p}_ln_g"] = blocks[f"{p}_ln"]["g"]
            want[f"{part}.{p}_ln_b"] = blocks[f"{p}_ln"]["b"]
            for n, leaves in blocks[p].items():
                for kind, spec in leaves.items():
                    want[f"{part}.{p}_{n}_{kind}"] = spec
        for n in ("fc1", "fc2"):
            for kind, spec in blocks["mlp"][n].items():
                want[f"{part}.{n}_{kind}"] = spec
        want[f"{part}.mlp_ln_g"] = blocks["mlp_ln"]["g"]
        want[f"{part}.mlp_ln_b"] = blocks["mlp_ln"]["b"]
    layout = {(None, None, "tp"): 1, (None, "tp", None): 2, (None, "tp"): 1}
    for name, spec in want.items():
        assert got[name] == layout.get(tuple(spec)), (name, spec, got[name])
    # everything outside the blocks is replicated, as P() in JAX
    assert {k for k, v in got.items() if v is not None} <= set(want)
    assert all(v is None for k, v in got.items() if k not in want)
    assert sum(v is not None for v in got.values()) == 9 + 15  # encoder, decoder


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_forward_matches_jax(world, tp):
    """``encode`` + ``decode_full`` on every rank of a tp mesh equal JAX's
    unsharded and dp=2 x tp=4 forwards; the alignment rows and every head's
    scores equal the unsharded port's (f32 sums in another order)."""
    ranks, jax_out, _, _, _ = world
    for r in ranks:
        got = r[f"fwd_tp{tp}"]
        assert got["heads_local"] == 4 // tp
        np.testing.assert_allclose(got["logits"], jax_out["fwd_one"], atol=2e-4)
        np.testing.assert_allclose(got["logits"], jax_out["fwd_mesh"], atol=2e-4)
        assert got["rows_err"] < 1e-4 and got["scores_err"] < 1e-4
        np.testing.assert_array_equal(got["logits"], ranks[0][f"fwd_tp{tp}"]["logits"])


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_decode_window_matches_jax_mesh(world, tp):
    """``test_batch.py:84``'s greedy window on the port's ``DecodeEngine(mesh=)``
    against JAX's ``DecodeEngine(mesh=get_mesh(tp=tp))``."""
    ranks, jax_out, _, _, _ = world
    want = jax_out[f"greedy_tp{tp}"]
    for r in ranks:
        got = r[f"greedy_tp{tp}"]
        assert got["tp"] == tp
        assert got["tokens"] == list(want.tokens)
        np.testing.assert_allclose(got["token_logprobs"], want.token_logprobs, atol=2e-4)
        np.testing.assert_allclose(got["attn"], want.attn, atol=2e-3)


@pytest.mark.parametrize("lever", ["kv_int8", "self_kv_int8"])
def test_tp_quantized_cache_matches_jax_mesh(world, lever):
    """The int8 cross K/V and the int8 self cache at tp=2: tokens equal to
    JAX's mesh engine with the same lever."""
    ranks, jax_out, _, _, _ = world
    for r in ranks:
        assert r[lever]["tokens"] == list(jax_out[lever].tokens)
        np.testing.assert_allclose(r[lever]["token_logprobs"], jax_out[lever].token_logprobs,
                                   atol=2e-3)


def test_tp_quantizer_scales_are_the_whole_rows(world):
    """Under tp=2 the scales are the whole row's (local max|x|, MAX over
    tp): ``quantize_rows`` of a rank's columns equals the unsharded
    quantizer's scales and its columns' codes bit for bit, and
    ``init_cache``'s int8 cross K/V scales equal the unsharded port's."""
    ranks, _, _, _, _ = world
    for r in ranks:
        s = r["scales"]
        assert s["rows_scales_equal"] and s["rows_codes_equal"]
        assert s["cross_equal"], s
        assert s["cross_codes_flips"] == 0, s


def test_tp_beam_matches_jax_mesh(world):
    """Beam 5 at tp=2 (the port's kernels run on each rank's heads; JAX keeps
    its XLA path for beam on a mesh): tokens equal."""
    ranks, jax_out, _, _, _ = world
    for r in ranks:
        assert r["beam"]["tokens"] == list(jax_out["beam"].tokens)
        assert abs(r["beam"]["avg_logprob"] - jax_out["beam"].avg_logprob) < 1e-3


def test_tp_sampled_window_matches_jax_mesh(world):
    """A window sampled at T=0.7 at tp=2, with JAX's noise for the seed:
    tokens equal to JAX's ``DecodeEngine(mesh=get_mesh(tp=2))`` decode of
    the same seed, log-probs at 2e-4 and attention at 2e-3, as the greedy
    window's."""
    ranks, jax_out, _, _, _ = world
    want = jax_out["sampled"]
    for r in ranks:
        got = r["sampled"]
        assert got["tokens"] == list(want.tokens)
        np.testing.assert_allclose(got["token_logprobs"], want.token_logprobs, atol=2e-4)
        np.testing.assert_allclose(got["attn"], want.attn, atol=2e-3)
    assert ranks[0]["sampled"]["tokens"] != jax_out["greedy_tp2"].tokens


@pytest.mark.parametrize("case", ["self_kv_int8", "beam"])
def test_tp4_matches_jax_mesh(world, case):
    """The int8 self cache (tokens equal, log-probs at 2e-3, as at tp=2) and
    beam 5 (tokens equal) at tp=4, against JAX's mesh engines at tp=4."""
    ranks, jax_out, _, _, _ = world
    want = jax_out[f"{case}_tp4"]
    for r in ranks:
        got = r[f"{case}_tp4"]
        assert got["tokens"] == list(want.tokens)
        if case == "beam":
            assert abs(got["avg_logprob"] - want.avg_logprob) < 1e-3
        else:
            np.testing.assert_allclose(got["token_logprobs"], want.token_logprobs, atol=2e-3)


def test_tp_window_collectives_and_stop_flag(world):
    """A greedy window at tp=2 issues, on every rank alike, the encoder's two
    sums a layer, the prefill's three a layer and its alignment rows' sum,
    then a chunk at a time: three sums a layer and the rows' sum a step
    for ``STOP_CHECK_STEPS`` steps, then the MAX over tp of the chunk's
    (1,) int64 running flag, the chunk's last collective."""
    ranks, _, _, dims, _ = world
    La, L, k = dims.n_audio_layer, dims.n_text_layer, STOP_CHECK_STEPS
    chunk = k * (3 * L + 1) + 1
    first = 2 * La + 3 * L + 1
    for r in ranks:
        s = r["stop"]
        calls, chunks = [tuple(c) for c in s["calls"]], s["chunks"]
        assert chunks == -(-s["steps"] // k) >= 1
        assert len(calls) == first + chunks * chunk
        maxes = [i for i, c in enumerate(calls) if c[0]]
        assert maxes == [first + (j + 1) * chunk - 1 for j in range(chunks)]
        assert all(calls[i][1:] == (1, "torch.int64") for i in maxes)
        assert calls == [tuple(c) for c in ranks[0]["stop"]["calls"]]


def test_gloo_tp_counts_eager_chunks(world):
    """A gloo tp group's loops run eagerly (gloo reduces through the host,
    which a CUDA graph cannot hold) and count every chunk in
    ``tp_eager_chunks``: the greedy window's chunks, the beam window's
    ``beam_chunks``."""
    ranks, _, _, _, _ = world
    for r in ranks:
        s = r["stop"]
        assert s["via_host"]
        assert s["greedy_eager"] == s["chunks"] >= 1
        assert s["beam_eager"] == s["beam_chunks"] >= 1


def test_shard_and_place_batch(world):
    """``shard_batch`` gives dp rank r its block of the leading axis (what
    ``P("dp")`` places on a device), leaves 0-d leaves whole and refuses an
    axis dp does not divide; ``place_batch`` replicates such a leaf instead.
    Ranks 0-1 are dp coordinate 0 of the dp=2 x tp=2 mesh, ranks 2-3
    coordinate 1."""
    ranks, _, _, _, _ = world
    for r, res in enumerate(ranks):
        d = r // 2
        got = res["shard_batch"]
        np.testing.assert_array_equal(got["x"].numpy(), np.arange(8).reshape(4, 2)[2 * d:2 * d + 2])
        np.testing.assert_array_equal(got["y"][0], np.arange(6)[3 * d:3 * d + 3])
        assert float(got["y"][1]) == 3.0
        placed = res["place_batch"]
        np.testing.assert_array_equal(placed["x"].numpy(), np.arange(4)[2 * d:2 * d + 2])
        np.testing.assert_array_equal(placed["odd"], np.arange(3))
        assert "not divisible by dp=2" in res["shard_odd"]


def test_tp_not_dividing_mlp_raises(world):
    """tp=3 over 4 heads and an MLP of 128: ``ValueError`` naming the MLP
    widths (fc1 / fc2 keep the even cut, though 4 heads would be dealt
    2, 1, 1)."""
    ranks, _, _, _, _ = world
    for r in ranks:
        assert r["tp3"] is not None and "MLP widths (128, 128)" in r["tp3"], r["tp3"]


def test_tp_exceeding_heads_raises(world):
    """tp=4 over 2 heads: ``ValueError``, a rank would hold no head."""
    ranks, _, _, _, _ = world
    for r in ranks:
        msg = r["tp4_two_heads"]
        assert msg is not None and "exceeds a head count" in msg and "n_text_head=2" in msg, msg


def test_train_step_refuses_uneven_deal(world):
    """``make_train_step(mesh=)`` refuses what ``shard_params`` refuses, with
    ``check_tp``'s ``ValueError``: tp=4 over 2 heads (a rank would hold
    none), tp=3 not dividing the MLP widths of the dims (4x the width 64:
    ``make_train_step`` sees no model); it takes tp=4 over 6 heads, the
    uneven deal 2, 2, 1, 1."""
    ranks, _, _, _, _ = world
    for r in ranks:
        msg = r["train_two_heads"]
        assert msg is not None and "exceeds a head count" in msg and "n_text_head=2" in msg, msg
        assert r["train_tp3"] is not None and "MLP widths (256, 256)" in r["train_tp3"], r["train_tp3"]
        assert r["train_uneven"] is None, r["train_uneven"]


@pytest.mark.parametrize("n_head,tp,want", [(6, 4, [2, 2, 1, 1]),
                                            (20, 8, [3, 3, 3, 3, 2, 2, 2, 2]),
                                            (12, 8, [2, 2, 2, 2, 1, 1, 1, 1]),
                                            (4, 2, [2, 2])])
def test_head_deal(n_head, tp, want):
    """The deal of ``n_head`` heads over tp ranks: ``n_head // tp`` a rank,
    one more for the first ``n_head % tp``, each rank a contiguous run
    (``rank_heads``), every head on exactly one rank."""
    assert M.head_deal(n_head, tp) == want
    runs = [M.rank_heads(n_head, tp, r) for r in range(tp)]
    assert [n for _, n in runs] == want
    assert [h for first, n in runs for h in range(first, first + n)] == list(range(n_head))


@pytest.mark.parametrize("n_head,tp", [(6, 4), (20, 8), (12, 8), (4, 2)])
def test_shard_slice_tiles_the_full_weight(n_head, tp):
    """Every parameter of a model with ``n_head`` heads of width 8: the
    ranks' ``shard_slice`` concatenated along ``param_shard_dims``' axis is
    the whole tensor, each element once (the tensors hold their own element
    indices); q/k/v/o are cut at the deal's head boundaries."""
    from whisper_timestamped_tpu_torch.models import init_params

    D = 8 * n_head
    dims = WhisperDims(n_mels=8, n_audio_ctx=4, n_audio_state=D, n_audio_head=n_head,
                       n_audio_layer=2, n_vocab=16, n_text_ctx=4, n_text_state=D,
                       n_text_head=n_head, n_text_layer=2)
    model = init_params(dims, device="cpu")
    for key, d in M.param_shard_dims(model).items():
        part, name = key.split(".", 1)
        t = getattr(model, part)[name]
        whole = torch.arange(t.numel()).reshape(t.shape)
        parts = [M.shard_slice(part, name, whole, dims, tp, r) for r in range(tp)]
        if d is None:
            assert all(p is whole for p in parts), key
            continue
        assert torch.equal(torch.cat(parts, dim=d), whole), key
        if not name.startswith(("fc1", "fc2")):
            assert [p.shape[d] for p in parts] == [8 * n for n in M.head_deal(n_head, tp)], key


def test_tp_uneven_shards_put_back_the_weights(world):
    """6 heads at tp=4: each rank holds its run of the deal (2, 2, 1, 1), and
    the ranks' q/k/v/o slices of ``shard_params``, concatenated along
    ``param_shard_dims``' axis, are the unsharded tensors bit for bit."""
    ranks, _, _, _, six_tree = world
    model = params_from_jax_tree(six_tree, WhisperDims(**SIX_DIMS), device="cpu")
    axes = M.param_shard_dims(model)
    assert [tuple(r["six"]["heads"]) for r in ranks] == [(0, 2), (2, 2), (4, 1), (5, 1)]
    names = ranks[0]["six"]["slices"]
    assert len(names) == 6 + 12  # encoder, decoder
    for key in names:
        part, name = key.split(".", 1)
        got = np.concatenate([r["six"]["slices"][key] for r in ranks], axis=axes[key])
        np.testing.assert_array_equal(got, getattr(model, part)[name].detach().numpy(), key)


def test_tp_uneven_forward_matches_jax(world):
    """6 heads at tp=4: ``encode`` + ``decode_full`` on every rank against
    JAX's unsharded forward and its dp=2 x tp=4 mesh (which splits heads):
    the logits (atol 2e-4, as the even meshes'), the alignment heads' rows
    and every head's scores, summed over the ranks (against JAX's at the
    same 2e-4, and within 1e-4 of the unsharded port's)."""
    ranks, jax_out, _, _, _ = world
    one_logits, one_scores = jax_out["six_fwd_one"]
    mesh_logits, mesh_scores = jax_out["six_fwd_mesh"]
    want_rows = np.stack([one_scores[l][:, h] for l, h in SIX_HEADS], axis=1)
    for r, deal in zip(ranks, [2, 2, 1, 1]):
        got = r["six"]["fwd"]
        assert got["heads_local"] == deal
        for want in (one_logits, mesh_logits):
            np.testing.assert_allclose(got["logits"], want, atol=2e-4)
        for want in (one_scores, mesh_scores):
            np.testing.assert_allclose(got["scores"], want, atol=2e-4)
        np.testing.assert_allclose(got["rows"], want_rows, atol=2e-4)
        assert got["rows_err"] < 1e-4 and got["scores_err"] < 1e-4
        np.testing.assert_array_equal(got["logits"], ranks[0]["six"]["fwd"]["logits"])


def test_tp_uneven_decode_window_matches_jax_mesh(world):
    """The greedy window of the 6-head model at tp=4 against JAX's
    ``DecodeEngine(mesh=get_mesh(tp=4))``: tokens equal, log-probs at 2e-4,
    attention at 2e-3 (the even tp windows' limits)."""
    ranks, jax_out, _, _, _ = world
    want = jax_out["six_greedy"]
    assert len(want.tokens) > 4
    for r in ranks:
        got = r["six"]["greedy"]
        assert got["tokens"] == list(want.tokens)
        np.testing.assert_allclose(got["token_logprobs"], want.token_logprobs, atol=2e-4)
        np.testing.assert_allclose(got["attn"], want.attn, atol=2e-3)


# the int8 cross K/V's log-probs against JAX: test_torch_quant.py's
# SLICE_TOL["kv_int8"] (JAX's XLA math rounds each q·k product of the
# quantized cross-attention to bf16, the port keeps f32; this model's
# larger scores make that 2.6e-3 on one card too), and within 2e-4 (the f32
# windows' limit) of the port's own unsharded run
UNEVEN_LOGPROB_TOL = {"kv_int8": dict(rtol=1e-3, atol=1e-3), "self_kv_int8": dict(atol=2e-3)}


@pytest.mark.parametrize("lever", ["kv_int8", "self_kv_int8"])
def test_tp_uneven_quantized_cache_matches_jax_mesh(world, lever):
    """The int8 cross K/V and the int8 self cache of the 6-head model at
    tp=4: tokens equal to JAX's tp=4 mesh engine with the same lever,
    log-probs within ``UNEVEN_LOGPROB_TOL`` (the int8 self cache at tp=2's
    2e-3); the int8 cross K/V's also within 2e-4 of the port's one-card
    run."""
    ranks, jax_out, _, _, _ = world
    want = jax_out[f"six_{lever}"]
    for r in ranks:
        got = r["six"][lever]
        assert got["tokens"] == list(want.tokens)
        np.testing.assert_allclose(got["token_logprobs"], want.token_logprobs,
                                   **UNEVEN_LOGPROB_TOL[lever])
        if lever == "kv_int8":
            one = r["six"]["kv_int8_one"]
            assert got["tokens"] == one["tokens"]
            np.testing.assert_allclose(got["token_logprobs"], one["token_logprobs"], atol=2e-4)


def test_tp_uneven_beam_matches_jax_mesh(world):
    """Beam 5 on the 6-head model at tp=4: tokens equal to JAX's tp=4 mesh
    engine's, the average log-prob within 1e-3."""
    ranks, jax_out, _, _, _ = world
    want = jax_out["six_beam"]
    for r in ranks:
        assert r["six"]["beam"]["tokens"] == list(want.tokens)
        assert abs(r["six"]["beam"]["avg_logprob"] - want.avg_logprob) < 1e-3


def test_tp_uneven_scales_are_the_whole_rows(world):
    """6 heads at tp=4, ranks 32, 32, 16 and 16 columns wide: ``init_cache``'s
    int8 cross K/V scales, and the int8 self cache's scales of a step's row
    (layer 0), equal the unsharded port's bit for bit, and so do the ranks'
    codes gathered over tp (``TensorParallel.gather`` pads the narrower
    ranks); ``quantize_rows`` of a rank's columns gives the whole row's
    scales and that rank's columns of its codes."""
    ranks, _, _, _, _ = world
    for r in ranks:
        s = r["six"]["scales"]
        assert s["cross_equal"] and s["cross_codes_flips"] == 0, s
        assert s["self_equal"] and s["self_codes_equal"], s
        assert s["rows_scales_equal"] and s["rows_codes_equal"], s


def test_get_mesh_without_process_group_raises():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun"):
        M.get_mesh(tp=1, device_type="cpu")
