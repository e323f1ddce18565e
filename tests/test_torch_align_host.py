"""The port's per-segment alignment against the JAX package's, on the CPU.

The three kernels of the per-segment route, through their plain versions
(CPU tensors), against the JAX Pallas kernels in interpret mode, as
tests/test_pallas.py runs them: ``median9`` equal, ``attention_to_cost`` at
rtol 1e-5 / atol 1e-6 (f32 sums in another order), the ``dtw_codes`` route
of ``dtw_path`` with equal paths whatever the padding. Then the port's copy
of ``find_peaks``, and ``perform_word_alignment`` with disfluency detection
by the kernel route and the host route, each against the JAX function's
same route: equal word lists.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_align_host.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from model_utils import make_tokenizer  # noqa: E402
from test_alignment import _synthetic_attention  # noqa: E402
from whisper_timestamped_tpu import alignment as JA  # noqa: E402
from whisper_timestamped_tpu.ops import peaks as JP  # noqa: E402
from whisper_timestamped_tpu.ops.pallas_kernels import (  # noqa: E402
    attention_to_cost_pallas,
    dtw_path_pallas,
    median9_pallas,
)
from whisper_timestamped_tpu_torch import alignment as TA  # noqa: E402
from whisper_timestamped_tpu_torch.ops import kernels as K  # noqa: E402
from whisper_timestamped_tpu_torch.ops import peaks as TP  # noqa: E402
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


MEDIAN_SHAPES = [(6, 256), (2, 4, 128), (3, 5, 37), (4, 3), (4, 1), (4, 5), (3, 9), (2, 1537)]


@pytest.mark.parametrize("shape", MEDIAN_SHAPES)
def test_median9_matches_pallas(shape):
    """Equal (a median is a selection), rows shorter than the window
    included: both reflect as numpy's symmetric padding."""
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    want = np.asarray(median9_pallas(jnp.asarray(x), interpret=True))
    got = K.median9(torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(K.median9_plain(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("shape", MEDIAN_SHAPES)
def test_median9_kernel_arithmetic_is_the_median(shape):
    """The card's kernel (``csrc/median9.cu``) shares Paeth's network
    between neighbouring outputs: each triple of consecutive values sorted
    once, then an output is the median of (the max of its three blocks'
    lows, the median of their middles, the min of their highs). That
    arithmetic, here in numpy on the reflected rows, equals the Pallas
    kernel's median exactly."""
    x = np.random.default_rng(7 + sum(shape)).standard_normal(shape).astype(np.float32)
    M = shape[-1]
    q = np.remainder(np.arange(-4, M + 4), 2 * M)
    w = x[..., np.where(q < M, q, 2 * M - 1 - q)]
    lo, mi, hi = np.moveaxis(np.sort(np.stack([w[..., :-2], w[..., 1:-1], w[..., 2:]], -1), -1),
                             -1, 0)
    blocks = lambda t: np.stack([t[..., :M], t[..., 3:M + 3], t[..., 6:M + 6]], -1)  # noqa: E731
    med3 = lambda t: np.sort(t, -1)[..., 1]  # noqa: E731
    got = med3(np.stack([blocks(lo).max(-1), med3(blocks(mi)), blocks(hi).min(-1)], -1))
    want = np.asarray(median9_pallas(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("Kh,N,M,n_tokens,span", [(3, 32, 256, 27, 201), (40, 16, 128, 11, 97),
                                                  (3, 16, 128, 5, 3)])
def test_attention_to_cost_matches_pallas(Kh, N, M, n_tokens, span):
    """The one-segment cost against ``attention_to_cost_pallas`` (interpret),
    n_tokens < N and span < M; the last case's span of 3 frames reflects
    into the zero padding as the JAX wrapper does."""
    rng = np.random.default_rng(Kh + N + span)
    scores = (rng.standard_normal((Kh, N, M)) * 3.0).astype(np.float32)
    scores[:, n_tokens:] = 0.0
    scores[:, :, span:] = 0.0
    want = np.asarray(attention_to_cost_pallas(jnp.asarray(scores), span, n_tokens=n_tokens,
                                               interpret=True))
    got = K.attention_to_cost(torch.from_numpy(scores), span, n_tokens=n_tokens)
    assert got.shape == (N, M)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert not got[n_tokens:].any() and not got[:, span:].any()


@pytest.mark.parametrize("shape", [(4, 7), (17, 99), (23, 151), (33, 128)])
def test_dtw_path_kernel_route_matches_pallas(shape):
    """``dtw_path`` (on a CPU tensor its plain version: the codes at S=1,
    then the host walk) against ``dtw_path_pallas`` (rows padded to 16,
    frames to 128): equal paths, so the padding does not reach the
    result."""
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    x = -rng.random(shape).astype(np.float32)
    i1j, i2j = dtw_path_pallas(x, interpret=True)
    i1t, i2t = K.dtw_path(torch.from_numpy(x))
    assert i1t.dtype == np.int64 and i2t.dtype == np.int64
    np.testing.assert_array_equal(i1t, i1j)
    np.testing.assert_array_equal(i2t, i2j)


def _signals():
    rng = np.random.default_rng(11)
    out = [rng.standard_normal(n) for n in (2, 3, 10, 64, 200)]
    smooth = np.convolve(rng.standard_normal(300), np.ones(9) / 9, mode="same")
    out.append(smooth)
    plateau = np.zeros(40)
    plateau[5:9] = 1.0  # a flat top
    plateau[20:22] = 0.5
    plateau[30] = 0.8
    out.append(plateau)
    two = np.exp(-0.5 * ((np.arange(80) - 20) / 3.0) ** 2) + np.exp(-0.5 * ((np.arange(80) - 55) / 4.0) ** 2)
    out.append(two)
    return out


@pytest.mark.parametrize("i", range(8))
@pytest.mark.parametrize("kw", [dict(width=3, prominence=0.02), dict(prominence=0.1), dict(width=2.0),
                                dict()])
def test_find_peaks_matches_jax(i, kw):
    x = _signals()[i]
    pj, propj = JP.find_peaks(x, **kw)
    pt, propt = TP.find_peaks(x, **kw)
    np.testing.assert_array_equal(pt, pj)
    assert sorted(propt) == sorted(propj)
    for name in propj:
        np.testing.assert_array_equal(propt[name], propj[name])


def _pallas_case():
    """tests/test_pallas.py:57-73: three words on a diagonal of blocks."""
    ts = TOK_T.timestamp_begin
    rng = np.random.default_rng(0)
    tokens = [ts] + TOK_T.encode(" aa bb cc") + [ts + 150]
    attn = rng.standard_normal((len(tokens), 4, 1500)).astype(np.float32) * 0.01
    for i in range(len(tokens)):
        attn[i, :, 15 * i: 15 * i + 20] += 6.0
    return tokens, attn


def _disfluency_case():
    """tests/test_alignment.py:135: token 3 has a second, earlier peak."""
    ts = TOK_T.timestamp_begin
    tokens = [ts] + TOK_T.encode(" aa bb") + [ts + 100]
    blocks = [(0, 2), (5, 15), (18, 28), (60, 70), (73, 83), (95, 100)]
    attn = _synthetic_attention(6, blocks, noise=0.001)
    attn[3, :, 35:42] += 6.0
    return tokens, attn


def _inserted_case():
    """Tokens on 10-frame blocks 36 frames apart; the first tokens of "bb"
    and "cc" also attend to an 8-frame echo 12 frames before their block, so
    a cost row has two separated peaks inside its DTW span and a disfluency
    mark is inserted (by both routes)."""
    ts = TOK_T.timestamp_begin
    n = 2 + len(TOK_T.encode(" aa bb cc"))
    tokens = [ts] + TOK_T.encode(" aa bb cc") + [ts + 36 * (n - 1) + 10]
    blocks = [(0, 6)] + [(36 * i, 36 * i + 10) for i in range(1, n)]
    attn = _synthetic_attention(n, blocks, noise=0.001)
    for i in (3, 5):
        attn[i, :, 36 * i - 20: 36 * i - 12] += 6.0
    return tokens, attn


CASES = {"pallas": _pallas_case, "disfluency": _disfluency_case, "inserted": _inserted_case}


@pytest.mark.parametrize("device_kernels", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_perform_word_alignment_with_disfluencies_matches_jax(case, device_kernels):
    """Kernel route (the port's plain versions on the CPU against JAX's
    Pallas kernels in interpret mode) and host route (numpy against numpy):
    equal word lists, disfluency marks included."""
    tokens, attn = CASES[case]()
    assert TOK_J.encode(" aa bb cc") == TOK_T.encode(" aa bb cc")
    want = JA.perform_word_alignment(tokens, attn, TOK_J, detect_disfluencies=True,
                                     use_device_kernels=device_kernels)
    got = TA.perform_word_alignment(tokens, attn, TOK_T, use_device_kernels=device_kernels,
                                    device="cpu")  # detect_disfluencies defaults to True
    assert got == want
    assert [w["text"] for w in got if w["text"] != TA.DISFLUENCY_MARK][:2] == ["aa", "bb"]
    if case == "inserted":
        assert TA.DISFLUENCY_MARK in [w["text"] for w in got]


def test_disfluencies_default_on_as_in_jax():
    """The JAX function detects disfluencies unless told not to; so does
    the port's."""
    import inspect

    for fn in (JA.perform_word_alignment, TA.perform_word_alignment):
        assert inspect.signature(fn).parameters["detect_disfluencies"].default is True


def test_precomputed_cost_feeds_disfluencies():
    """The batched aligner's route: jumps and cost from the host route fed
    back as ``precomputed_jumps``/``precomputed_cost`` give the same words."""
    tokens, attn = _inserted_case()
    plan = TA.plan_alignment(tokens, TOK_T)
    sliced = np.transpose(attn[plan.row_indices], (1, 0, 2))[..., plan.start_token:plan.end_token]
    weights = TA._attention_to_cost(sliced, 9, 1.0)
    weights[0, 0] = weights.min()
    i1, i2 = TA.dtw_path(weights)
    jumps = i2[np.pad(np.diff(i1), (1, 0), constant_values=1).astype(bool)]
    jumps = np.pad(jumps, (0, 1), constant_values=i2[-1])
    got = TA.perform_word_alignment(tokens, None, TOK_T, precomputed_jumps=jumps,
                                    precomputed_cost=weights.astype(np.float32))
    want = TA.perform_word_alignment(tokens, attn, TOK_T)
    assert got == want
    with pytest.raises(AssertionError):
        TA.perform_word_alignment(tokens, None, TOK_T, precomputed_jumps=jumps)
