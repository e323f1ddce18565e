"""The device aligner's plain versions against the JAX package.

The port's CUDA alignment kernels (``csrc/align_cost.cu``, ``csrc/dtw_codes.cu``)
run only on the card; on the CPU their wrappers run the plain versions, held
here to the JAX functions they replace (Pallas in interpret mode): the
batched walk (``dtw_starts``) to ``device_align._backtrace_batch`` over
``dtw_codes_batched``, the one-segment path (``dtw_path``) to
``dtw_path_pallas``, and the gather-form cost (``align_cost_gather``, the
aligner reading each segment's window of the attention rows) with its start
frames to ``_align_jumps_jit``. Tolerances: costs rtol 1e-5 / atol 1e-6
(float32 sums in another order), codes, starts and paths equal.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax.numpy as jnp  # noqa: E402

from model_utils import make_tokenizer  # noqa: E402
from whisper_timestamped_tpu import alignment as JA  # noqa: E402
from whisper_timestamped_tpu.api import device_align_segments as jax_device_align_segments  # noqa: E402
from whisper_timestamped_tpu.device_align import _align_jumps_jit, _backtrace_batch  # noqa: E402
from whisper_timestamped_tpu.ops.pallas_kernels import dtw_codes_batched, dtw_path_pallas  # noqa: E402
from whisper_timestamped_tpu_torch import alignment as TA  # noqa: E402
from whisper_timestamped_tpu_torch import api as TAPI  # noqa: E402
from whisper_timestamped_tpu_torch.device_align import M_PAD, _align_jumps  # noqa: E402
from whisper_timestamped_tpu_torch.ops import kernels as K  # noqa: E402
from whisper_timestamped_tpu_torch.tokenizer import get_tokenizer, synthetic_ranks  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dtw_case(kind, S, N, M, seed):
    """(cost (S, N, M) f32, dims (S, 4) int32) of one kind: random costs,
    small integers that tie often, the aligner's 2 x 2 dummy segments, or
    one-row and one-column segments."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        cost = -rng.integers(0, 3, (S, N, M)).astype(np.float32)
    else:
        cost = -rng.random((S, N, M)).astype(np.float32)
    n = rng.integers(1, N + 1, S)
    m = rng.integers(1, M + 1, S)
    n[0], m[0] = N, M
    if kind == "dummies":
        n[1:], m[1:] = 2, 2
        cost[1:] = 0.0
    elif kind == "thin":
        n[1], m[2] = 1, 1
        n[3], m[3] = 1, 1
    dims = np.stack([n, m, np.full(S, M), np.zeros(S, np.int64)], 1).astype(np.int32)
    return cost, dims


@pytest.mark.parametrize("kind", ["random", "ties", "dummies", "thin"])
@pytest.mark.parametrize("N,M", [(32, 96), (128, 1536)])
def test_dtw_starts_plain_matches_jax_backtrace(kind, N, M):
    """The DP and the walk back (``dtw_starts`` on CPU tensors: the plain
    version) against JAX's ``_backtrace_batch`` over ``dtw_codes_batched``:
    equal start frames, rows >= n zero."""
    cost, dims = _dtw_case(kind, 4, N, M, seed=N + M + len(kind))
    codes_j = dtw_codes_batched(jnp.asarray(cost), jnp.asarray(dims), interpret=True)
    want = np.asarray(_backtrace_batch(codes_j, jnp.asarray(dims[:, 0]), jnp.asarray(dims[:, 1])))
    got = K.dtw_starts(torch.from_numpy(cost), torch.from_numpy(dims))
    assert got.dtype == torch.int32 and got.shape == (4, N)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(K.dtw_starts_plain(torch.from_numpy(cost), torch.from_numpy(dims)).numpy(),
                                  want)
    for s, n in enumerate(dims[:, 0]):
        assert not got[s, n:].any()


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("shape", [(5, 40), (33, 128), (50, 7), (100, 300), (1, 9), (9, 1)])
def test_dtw_path_plain_matches_pallas(kind, shape):
    """The one-segment path (``dtw_path`` on a CPU tensor: the plain
    version, no row padding) against ``dtw_path_pallas`` (rows padded to 16,
    frames to 128), n not a multiple of 32: equal paths."""
    rng = np.random.default_rng(shape[0] * 1000 + shape[1] + len(kind))
    if kind == "ties":
        x = -rng.integers(0, 3, shape).astype(np.float32)
    else:
        x = -rng.random(shape).astype(np.float32)
    i1j, i2j = dtw_path_pallas(x, interpret=True)
    i1t, i2t = K.dtw_path(torch.from_numpy(x))
    assert i1t.dtype == np.int64 and i2t.dtype == np.int64
    np.testing.assert_array_equal(i1t, i1j)
    np.testing.assert_array_equal(i2t, i2j)


def _gather_case():
    """Attention rows (R, K, T) and four segments: a plain one; a full one
    whose window ends at T (start = T - span) with a max-duration mask;
    one whose token rows all repeat one row, with a 3-frame span; one whose
    window runs past T (the slice's zero padding)."""
    rng = np.random.default_rng(23)
    R, Kh, T, n_pad = 150, 3, 1500, 64
    attn = (rng.standard_normal((R, Kh, T)) * 3).astype(np.float32)
    specs = [(20, 150, M_PAD, 0), (64, 400, 200, T - 400), (10, 3, M_PAD, 700), (5, 300, M_PAD, T - 100)]
    rows = np.zeros((len(specs), n_pad), np.int64)
    dims = np.array(specs, np.int32)
    rows[0, :20] = rng.permutation(R)[:20]
    rows[1] = rng.integers(0, R, n_pad)  # with repeats
    rows[2, :10] = 17
    rows[3, :5] = [149, 0, 149, 3, 3]
    return attn, rows, dims, n_pad


def test_gather_cost_and_starts_match_align_jumps_jit():
    """The gather form (``align_cost_gather`` then ``dtw_starts``, through
    ``device_align._align_jumps`` on CPU tensors) against JAX's whole
    aligner program: cost at rtol 1e-5 / atol 1e-6, start frames equal."""
    attn, rows, dims, n_pad = _gather_case()
    starts_j, cost_j = _align_jumps_jit(jnp.asarray(attn), jnp.asarray(rows.astype(np.int32)),
                                        jnp.asarray(dims), n_pad=n_pad, return_cost=True,
                                        interpret=True)
    starts_t, cost_t = _align_jumps(torch.from_numpy(attn), rows, dims)
    assert cost_t.shape == (len(dims), n_pad, M_PAD)
    np.testing.assert_allclose(cost_t.numpy(), np.asarray(cost_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(starts_t.numpy(), np.asarray(starts_j))
    # the gather form is the pre-sliced form of the same window
    window = K.gather_window(torch.from_numpy(attn), torch.from_numpy(rows), torch.from_numpy(dims), M_PAD)
    torch.testing.assert_close(K.align_cost(window, torch.from_numpy(dims)), cost_t, rtol=0, atol=0)


def test_align_jumps_refuses_rows_outside_the_buffer():
    attn, rows, dims, _ = _gather_case()
    rows[0, 0] = attn.shape[0]
    with pytest.raises(ValueError, match="row indices"):
        _align_jumps(torch.from_numpy(attn), rows, dims)


TOK_J = make_tokenizer(language="en", task="transcribe")
TOK_T = get_tokenizer(ranks=synthetic_ranks(), multilingual=True, num_languages=99,
                      language="en", task="transcribe")


def _segments(rng, buffers):
    """Two segments per window of each (B, max_new, K, T) buffer: their
    ``Segment`` stand-ins (window = buffer and batch index) and
    ``prepare_segment_tokens`` outputs (tokens, local rows, unfinished,
    max_duration)."""
    ts = TOK_T.timestamp_begin
    out = []
    for buf in buffers:
        for b in range(buf.shape[0]):
            for a, e, n_text, row0 in ((0, 120, 8, 0), (150, 400, 12, 10)):
                words = rng.integers(ord("a"), ord("z"), n_text).tolist()
                tokens = [ts + a] + words + [ts + e]
                seg = SimpleNamespace(window=SimpleNamespace(attn_dev=buf, batch_index=b))
                out.append((seg, (tokens, list(range(row0, row0 + len(tokens))), False, 700)))
    return out


@pytest.mark.parametrize("n_buffers", [1, 2])
def test_device_align_segments_words_match_jax(n_buffers, monkeypatch):
    """``api.device_align_segments`` with the windows in one buffer (a
    batch's windows share one: the aligner reads its view, no copy) and in
    two (concatenated), against the JAX package's on the same rows: equal
    start frames and equal words."""
    rng = np.random.default_rng(n_buffers)
    bufs = [(rng.standard_normal((2, 32, 3, 1500)) * 3).astype(np.float32) for _ in range(n_buffers)]
    bufs_t = [torch.from_numpy(b) for b in bufs]
    entries_t = _segments(rng, bufs_t)
    # the JAX windows of one buffer share one array, as the port's share one tensor
    as_jax = {id(bt): jnp.asarray(b) for bt, b in zip(bufs_t, bufs)}
    entries_j = [(SimpleNamespace(window=SimpleNamespace(attn_dev=as_jax[id(seg.window.attn_dev)],
                                                         batch_index=seg.window.batch_index)), prep)
                 for seg, prep in entries_t]
    seen = []
    real = TAPI.compute_jumps_batch
    monkeypatch.setattr(TAPI, "compute_jumps_batch",
                        lambda flat, *a, **kw: seen.append(flat) or real(flat, *a, **kw))
    jumps_t = TAPI.device_align_segments(entries_t, TOK_T, 0)
    jumps_j = jax_device_align_segments(entries_j, TOK_J, 0)
    assert len(seen) == 1
    if n_buffers == 1:
        assert seen[0].data_ptr() == bufs_t[0].data_ptr()  # the buffer's view
    assert len(jumps_t) == len(jumps_j) == len(entries_t)
    for (seg, (tokens, _, _, maxdur)), jt, jj in zip(entries_t, jumps_t, jumps_j):
        np.testing.assert_array_equal(jt, jj)
        kw = dict(max_duration=maxdur, detect_disfluencies=False)
        wt = TA.perform_word_alignment(tokens, None, TOK_T, precomputed_jumps=jt, **kw)
        wj = JA.perform_word_alignment(tokens, None, TOK_J, precomputed_jumps=jj, **kw)
        assert wt == wj and wt
