"""The port's batch pipeline and serving loop on a mesh against the JAX
package's, in f32 on the CPU.

One spawned gloo world of 4 ranks (``torch_mesh_ranks.world_batch``): on a
dp=2 x tp=2 mesh, ``BatchTranscriber(DecodeEngine(model, tok, mesh=...),
batch_size=2).transcribe_streams`` (``test_batch.py:152``'s case, whose
JAX side runs here on ``get_mesh(dp=2, tp=4)``) and
``transcribe_batch_stream`` against per-batch ``transcribe_batch``
(``test_batch.py:463``); on a dp=2 x tp=1 mesh over ranks 0 and 1,
``BatchTranscriber(mesh=)`` with the device flow engaged
(``test_batch.py:68``); on a tp=4 mesh, ``transcribe_batch`` of a 6-head
model (tiny's head count, dealt 2, 2, 1, 1) against JAX's on its tp=4 mesh.
Every rank must return the same dict, in the caller's order.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from model_utils import hf_model_to_jax, make_hf_model, make_tokenizer  # noqa: E402
from test_golden import loose  # noqa: E402
from torch_mesh_ranks import SIX_DIMS, SIX_HEADS, _tok, one_rank_mesh, run_world  # noqa: E402
from whisper_timestamped_tpu.decoding import DecodingOptions as JaxOptions  # noqa: E402
from whisper_timestamped_tpu.engine import DecodeEngine as JaxEngine  # noqa: E402
from whisper_timestamped_tpu.models import whisper_jax as JW  # noqa: E402
from whisper_timestamped_tpu.models.load import WhisperModel as JaxModel  # noqa: E402
from whisper_timestamped_tpu.parallel import batch as JB  # noqa: E402
from whisper_timestamped_tpu.parallel import mesh as JM  # noqa: E402
from whisper_timestamped_tpu_torch.decoding import DecodingOptions  # noqa: E402
from whisper_timestamped_tpu_torch.engine import DecodeEngine  # noqa: E402
from whisper_timestamped_tpu_torch.models import WhisperDims, WhisperModel, params_from_jax_tree  # noqa: E402
from whisper_timestamped_tpu_torch.models.whisper_torch import QuantizedWhisper  # noqa: E402
from whisper_timestamped_tpu_torch.parallel import batch as B  # noqa: E402

HEADS = [(0, 1), (1, 0), (1, 2)]
# tokens a window: every step of a tp mesh holds collectives, whose latency
# on a busy host is 0.3-4 ms each through gloo
SAMPLE_LEN = 24
KW = dict(language="en", temperature=[0.0], no_speech_threshold=None, logprob_threshold=None,
          decode_options=DecodingOptions(sample_len=SAMPLE_LEN))
JAX_KW = {**KW, "decode_options": JaxOptions(sample_len=SAMPLE_LEN)}
SIX_KW = dict(KW, batch_size=2, device_alignment=True)


def _audio(seed, seconds):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(16000 * seconds) * 0.1).astype(np.float32)


AUDIOS = {"a": _audio(0, 5), "b": _audio(1, 8)}
BATCHES = [{"a": _audio(60, 5), "b": _audio(61, 8)}, {"c": _audio(62, 4)}]
DP_AUDIOS = {"b": _audio(1, 5), "a": _audio(0, 5), "c": _audio(3, 7)}


@pytest.fixture(scope="module")
def models():
    params, dims = hf_model_to_jax(make_hf_model(seed=0))
    jax_model = JaxModel(params=jax.tree.map(jnp.asarray, params), dims=dims,
                         alignment_heads=HEADS)
    module = params_from_jax_tree(params, WhisperDims(**dims.__dict__), device="cpu")
    return jax_model, WhisperModel(module=module, alignment_heads=HEADS), params, dims


@pytest.fixture(scope="module")
def world(models, tmp_path_factory):
    """(the ranks' results, the references computed meanwhile here)."""
    jax_model, model, params, dims = models
    six_params = JW.init_params(JW.WhisperDims(**SIX_DIMS), jax.random.PRNGKey(2))

    def references():
        tok = make_tokenizer(language="en", task="transcribe")
        jax_bt = JB.BatchTranscriber(JaxEngine(jax_model, tok, mesh=JM.get_mesh(dp=2, tp=4)),
                                     batch_size=2)
        one = DecodeEngine(model, _tok())
        six = JaxModel(params=six_params, dims=JW.WhisperDims(**SIX_DIMS),
                       alignment_heads=SIX_HEADS)
        return dict(
            jax_streams=jax_bt.transcribe_streams(AUDIOS, **JAX_KW),
            jax_six=JB.transcribe_batch(six, AUDIOS, tok, mesh=JM.get_mesh(dp=2, tp=4),
                                        **{**SIX_KW, **JAX_KW}),
            one_batches=[B.transcribe_batch(model, b, _tok(), engine=one, batch_size=2, **KW)
                         for b in BATCHES],
            one_dp=B.BatchTranscriber(one, batch_size=4).transcribe_streams(DP_AUDIOS, **KW))

    inp = dict(tree=jax.tree.map(np.asarray, params), dims=dims.__dict__, heads=HEADS, kw=KW,
               audios=AUDIOS, batches=BATCHES, dp_audios=DP_AUDIOS,
               six_tree=jax.tree.map(np.asarray, six_params), six_dims=SIX_DIMS,
               six_heads=SIX_HEADS, six_kw=SIX_KW)
    return run_world(4, "world_batch", inp, str(tmp_path_factory.mktemp("mesh_batch")),
                     overlap=references)


def test_tp_batched_pipeline_matches_jax_mesh(world):
    """dp=2 x tp=2: segment tokens and times equal to JAX's batched pipeline
    on its dp=2 x tp=4 mesh; every rank's dict the same, in the caller's
    order, the segments without their windows, with every stream's meta."""
    ranks, ref = world
    want = ref["jax_streams"]
    for r in ranks:
        assert list(r["streams"]) == list(AUDIOS)
        assert list(r["stream_meta"]) == list(AUDIOS)
        for name in AUDIOS:
            assert [s[0] for s in r["streams"][name]] == [s.tokens for s in want[name]], name
            for (_, start, end, no_window), s in zip(r["streams"][name], want[name]):
                assert start == s.start and end == s.end and no_window
        assert r["streams"] == ranks[0]["streams"]


def test_tp4_uneven_transcribe_batch_matches_jax_mesh(world):
    """The 6-head model at tp=4 (heads dealt 2, 2, 1, 1), ``transcribe_batch``
    with the device aligner at batch_size 2: segment tokens equal to JAX's
    ``transcribe_batch`` on its dp=2 x tp=4 mesh (which splits heads), the
    results equal under ``loose`` (word times to 0.1 s), every rank's the
    same."""
    ranks, ref = world
    want = ref["jax_six"]
    for r in ranks:
        got = r["six"]
        assert list(got) == list(AUDIOS)
        for name in AUDIOS:
            assert [s["tokens"] for s in got[name]["segments"]] == [
                s["tokens"] for s in want[name]["segments"]], name
            assert loose(got[name]) == loose(want[name]), name
        assert got == ranks[0]["six"]
    assert sum(len(s.get("words", [])) for res in want.values() for s in res["segments"]) > 0


def test_stream_on_mesh_matches_per_batch_calls(world):
    """The serving loop on the dp=2 x tp=2 mesh equals per-batch
    ``transcribe_batch`` on the same mesh engine (a batch of one stream
    leaves one dp rank without streams), every rank the same; the segment
    texts equal the unsharded port's."""
    ranks, ref = world
    for r in ranks:
        assert r["stream"] == r["per_batch"]
        assert r["stream"] == ranks[0]["stream"]
        assert [list(res) for res in r["stream"]] == [list(b) for b in BATCHES]
        for res_mesh, res_one in zip(r["stream"], ref["one_batches"]):
            for name in res_mesh:
                assert [s["text"] for s in res_mesh[name]["segments"]] == [
                    s["text"] for s in res_one[name]["segments"]], name


def test_dp_mesh_device_flow_matches_one_card(world):
    """dp=2 x tp=1 (ranks 0 and 1): the mesh attached to an engine without
    one, the device flow engaged, no eager tensor-parallel loop, each
    rank's streams decoded at batch_size // dp and the merged dict in the
    caller's order, its tokens those of one card's transcriber."""
    ranks, ref = world
    want = {n: [s.tokens for s in v] for n, v in ref["one_dp"].items()}
    for r in ranks[:2]:
        dp = r["dp"]
        assert dp["attached"] and dp["flow"] and dp["eager"] == 0
        assert dp["names"] == list(DP_AUDIOS)
        assert dp["streams"] == want
    assert "dp" not in ranks[2] and "dp" not in ranks[3]


def test_weight_levers_with_mesh_warn_and_are_off(models, tmp_path, caplog):
    """``w_int8`` / ``enc_int8`` with a mesh log JAX's warning and are off,
    whether the mesh comes with the engine or is attached later; JAX's
    engine does the same."""
    jax_model, model, _, _ = models
    with caplog.at_level(logging.WARNING):
        JaxEngine(jax_model, make_tokenizer(language="en"), mesh=JM.get_mesh(dp=8),
                  w_int8=True, enc_int8=True)
    jax_warning = [r.getMessage() for r in caplog.records if "w_int8" in r.getMessage()]
    assert jax_warning
    with one_rank_mesh(str(tmp_path)) as mesh:
        for attach_later in (False, True):
            caplog.clear()
            with caplog.at_level(logging.WARNING):
                if attach_later:
                    engine = DecodeEngine(model, _tok(), w_int8=True, enc_int8=True)
                    assert isinstance(engine.model.module, QuantizedWhisper)
                    B.BatchTranscriber(engine, mesh=mesh)
                else:
                    engine = DecodeEngine(model, _tok(), mesh=mesh, w_int8=True, enc_int8=True)
            assert [r.getMessage() for r in caplog.records if "w_int8" in r.getMessage()] \
                == jax_warning
            assert not engine.w_int8 and not engine.enc_int8 and engine.mesh is mesh
            assert not isinstance(engine.model.module, QuantizedWhisper)
            assert (engine.model.module.encoder["attn_q_w"].data_ptr()
                    == model.module.encoder["attn_q_w"].data_ptr())
