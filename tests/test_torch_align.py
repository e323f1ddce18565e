"""The port's word alignment against the JAX package's, on the CPU.

Token splitting, alignment planning and the host word assembly must match
the JAX functions exactly; the port's device aligner (cost + DTW kernels'
plain versions + backtrace) must give the words of the JAX host path, as
test_device_align.py holds the JAX device aligner to it (timestamps within
one 20 ms frame)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from model_utils import make_tokenizer  # noqa: E402
from whisper_timestamped_tpu import alignment as JA  # noqa: E402
from whisper_timestamped_tpu_torch import alignment as TA  # noqa: E402
from whisper_timestamped_tpu_torch.device_align import compute_jumps_batch, make_task  # noqa: E402
from whisper_timestamped_tpu_torch.tokenizer import get_tokenizer, synthetic_ranks  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOK_J = make_tokenizer(language="en", task="transcribe")
TOK_T = get_tokenizer(ranks=synthetic_ranks(), multilingual=True, num_languages=99,
                      language="en", task="transcribe")
TS = TOK_T.timestamp_begin
K, T_AUDIO = 4, 1500


def _tokens(rng, start, end, n_text, spaced=True):
    words = []
    for _ in range(n_text):
        w = rng.integers(ord("a"), ord("z"), rng.integers(1, 4)).tolist()
        words += (TOK_T.encode(" ") if spaced else []) + w
    return [TS + start] + words[:n_text] + [TS + end]


CASES = {
    "plain": dict(span=(0, 150, 20)),
    "offset": dict(span=(730, 880, 15)),
    "max_duration": dict(span=(0, 400, 12), max_duration=200),
    "overflow": dict(span=(0, 4, 30)),
    "refine": dict(span=(10, 200, 18), refine=25),
    "unfinished": dict(span=(20, -1, 25), unfinished=True),
}


def _case(name):
    c = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    a, b, n = c["span"]
    tokens = _tokens(rng, a, b, n)
    if b < 0:  # stuck LM: no closing timestamp
        tokens = tokens[:-1]
    attn = rng.standard_normal((len(tokens), K, T_AUDIO)).astype(np.float32)
    kw = dict(refine_whisper_precision_nframes=c.get("refine", 0),
              max_duration=c.get("max_duration"), unfinished_decoding=c.get("unfinished", False))
    return tokens, attn, kw


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_alignment_matches_jax(name):
    tokens, _, kw = _case(name)
    pj = JA.plan_alignment(tokens, TOK_J, kw["refine_whisper_precision_nframes"], kw["unfinished_decoding"])
    pt = TA.plan_alignment(tokens, TOK_T, kw["refine_whisper_precision_nframes"], kw["unfinished_decoding"])
    assert pt.tokens == pj.tokens
    np.testing.assert_array_equal(pt.row_indices, pj.row_indices)
    assert (pt.start_token, pt.end_token, pt.unfinished, pt.empty) == (
        pj.start_token, pj.end_token, pj.unfinished, pj.empty)


@pytest.mark.parametrize("use_space", [True, False])
@pytest.mark.parametrize("remove_punct", [False, True])
def test_split_tokens_matches_jax(use_space, remove_punct):
    text = " Hello, world! 日本語です。 (ok) -- fine."
    tokens = [TS] + TOK_T.encode(text) + [TS + 40]
    fj = JA.split_tokens_on_spaces if use_space else JA.split_tokens_on_unicode
    ft = TA.split_tokens_on_spaces if use_space else TA.split_tokens_on_unicode
    assert ft(tokens, TOK_T, remove_punctuation_from_words=remove_punct) == \
        fj(tokens, TOK_J, remove_punctuation_from_words=remove_punct)


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_words_match_jax(name):
    """The host cost + numpy DTW path: identical words and timestamps."""
    tokens, attn, kw = _case(name)
    wj = JA.perform_word_alignment(tokens, attn, TOK_J, detect_disfluencies=False, **kw)
    wt = TA.perform_word_alignment(tokens, attn, TOK_T, detect_disfluencies=False, **kw)
    assert wt == wj


@pytest.mark.parametrize("name", sorted(CASES))
def test_device_aligner_words_match_jax_host(name):
    tokens, attn, kw = _case(name)
    task = make_task(tokens, 0, np.arange(len(tokens)), TOK_T,
                     refine_whisper_precision_nframes=kw["refine_whisper_precision_nframes"],
                     unfinished_decoding=kw["unfinished_decoding"],
                     max_duration=kw["max_duration"])
    (jumps,) = compute_jumps_batch(torch.from_numpy(attn), [task])
    wt = TA.perform_word_alignment(tokens, None, TOK_T, precomputed_jumps=jumps,
                                   detect_disfluencies=False, **kw)
    wj = JA.perform_word_alignment(tokens, attn, TOK_J, detect_disfluencies=False, **kw)
    assert [w["text"] for w in wt] == [w["text"] for w in wj]
    for a, b in zip(wt, wj):
        assert a["start"] == pytest.approx(b["start"], abs=0.021)
        assert a["end"] == pytest.approx(b["end"], abs=0.021)


def test_empty_plan_and_unported_options(tmp_path):
    """An empty plan gives no task. ``plot``, once refused, now draws: the
    words equal JAX's and both write the same figure (a path prefix)."""
    from whisper_timestamped_tpu import plotting as jax_plotting
    from whisper_timestamped_tpu_torch import plotting

    assert make_task([TS + 5, TS + 5], 0, [0, 1], TOK_T) is None
    tokens, attn, kw = _case("plain")
    plotting.reset_plot_counter()  # figures are numbered per process until a reset
    jax_plotting.reset_plot_counter()
    wt = TA.perform_word_alignment(tokens, attn, TOK_T, plot=str(tmp_path / "ours"), **kw)
    wj = JA.perform_word_alignment(tokens, attn, TOK_J, plot=str(tmp_path / "jax"), **kw)
    assert wt == wj and wt
    assert sorted(os.listdir(tmp_path)) == ["jax.alignment001.jpg", "ours.alignment001.jpg"]
