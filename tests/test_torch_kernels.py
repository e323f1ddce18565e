"""Plain PyTorch versions of the port's four kernels vs the JAX Pallas
kernels they replace, run in interpret mode on the CPU (as test_pallas.py
runs them), on the same numpy-seeded inputs.

Inputs are bf16-representable f32 values, so q·k products are exact in f32
on both sides. Tolerances:
  * attention outputs atol 2e-2: the Pallas kernels round the softmax
    weights to bf16 before the V product; the port keeps them f32;
  * scores atol 1e-3: f32 sums of exact products, in another order;
  * alignment cost atol 1e-6 (f32 arithmetic, other reduction orders);
  * DTW codes and jumps exactly equal.
The card itself is exercised by test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from model_utils import make_tokenizer  # noqa: E402
from whisper_timestamped_tpu.device_align import compute_jumps_batch as jax_jumps  # noqa: E402
from whisper_timestamped_tpu.device_align import make_task as jax_make_task  # noqa: E402
from whisper_timestamped_tpu.ops import pallas_kernels as P  # noqa: E402
from whisper_timestamped_tpu.models.whisper_jax import _attention as jax_attention  # noqa: E402
from whisper_timestamped_tpu_torch.device_align import compute_jumps_batch, make_task  # noqa: E402
from whisper_timestamped_tpu_torch.ops import kernels as K  # noqa: E402
from whisper_timestamped_tpu_torch.tokenizer import get_tokenizer, synthetic_ranks  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_values(rng, *shape, scale=1.0):
    x = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
    return x.bfloat16().float().numpy()


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# xattn_decode vs cross_attention_stacked_pallas_v2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("beam_group", [1, 2])
@pytest.mark.parametrize("score_flag", [1, 0])
def test_xattn_plain_matches_pallas_v2(beam_group, score_flag):
    rng = np.random.default_rng(10 + beam_group + 3 * score_flag)
    L, B, T, D, H = 2, 4, 300, 128, 2  # dh = 64, the kernels' head width
    q = _bf16_values(rng, B, 1, D)
    xk = _bf16_values(rng, L, B // beam_group, T, D)
    xv = _bf16_values(rng, L, B // beam_group, T, D)
    for layer in range(L):
        o_j, s_j = P.cross_attention_stacked_pallas_v2(
            layer, jnp.asarray(q), jnp.asarray(xk), jnp.asarray(xv), H,
            block_t=128, score_flag=jnp.int32(score_flag), beam_group=beam_group,
            interpret=True,
        )
        o_t, s_t = K.xattn_decode(_t(q), _t(xk), _t(xv), layer, H,
                                  emit_scores=bool(score_flag), beam_group=beam_group)
        assert o_t.shape == (B, 1, D) and o_t.dtype == torch.float32
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=2e-2)
        if score_flag:
            assert s_t.shape == (B, H, 1, T)
            np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-3)
        else:
            assert s_t is None  # no scores buffer for a non-alignment layer


def test_xattn_plain_matches_f32_attention():
    """The plain version is exactly the f32 single-query attention."""
    rng = np.random.default_rng(3)
    L, B, T, D, H = 2, 2, 200, 128, 2
    q = rng.standard_normal((B, 1, D)).astype(np.float32)
    xk = rng.standard_normal((L, B, T, D)).astype(np.float32)
    xv = rng.standard_normal((L, B, T, D)).astype(np.float32)
    o_t, s_t = K.xattn_decode(_t(q), _t(xk), _t(xv), 1, H, emit_scores=True)
    o_j, s_j = jax_attention(jnp.asarray(q), jnp.asarray(xk[1]), jnp.asarray(xv[1]), H,
                             return_scores=True)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("T", [1, 63, 64, 65, 129, 1500, K.MAX_T])
@pytest.mark.parametrize("B", [1, 8, 40])
def test_xattn_split_covers_t_and_fills_the_card(B, T):
    """The CUDA kernel's grid rule on a 132-SM card: whole 64-frame tiles
    per split, every split non-empty, all of T covered, and at B=1, T=1500
    at least one block per multiprocessor."""
    n_split, per = K.xattn_split(B, 20, T, 132)
    assert per % K.XATTN_TILE == 0
    assert (n_split - 1) * per < T <= n_split * per
    assert n_split <= min(-(-T // K.XATTN_TILE), K.XATTN_MAX_SPLITS)
    if (B, T) == (1, 1500):
        assert n_split * 20 >= 132
    if B == 40:
        assert n_split == 1  # 800 (row, head) pairs fill the card unsplit


@pytest.mark.parametrize("T", [2, 64, 126, 128, 130, 1500, K.MAX_T])
@pytest.mark.parametrize("B", [1, 8, 40])
def test_int4_split_covers_the_packed_rows(B, T):
    """The grid rule over the T/2 nibble-packed rows of the int4 kernel on a
    132-SM card: whole 64-packed-row pieces (128 frames) per split, every
    split non-empty, every packed row covered, at most XATTN_MAX_SPLITS;
    blocks of 4 warps at every batch; at large-v3's T = 1500, 6 splits at
    B=1, 3 at B=8, none at B=40."""
    rows = T // 2
    n_split, per = K.xattn_split(B, 20, rows, 132, frames_per_row=2)
    assert per % K.XATTN_TILE == 0
    assert (n_split - 1) * per < rows <= n_split * per
    assert n_split <= min(-(-rows // K.XATTN_TILE), K.XATTN_MAX_SPLITS)
    if T == 1500:
        assert (n_split, per) == {1: (6, 128), 8: (3, 256), 40: (1, 768)}[B]
    assert K.pipeline_warps(B, 20, 132, frames_per_row=2) == 4


def _split_merge(q, xk, xv, H, n_split, per):
    """The split-T kernel's arithmetic, in f64: each split's running max m,
    sum l of exp(s - m) and o = sum exp(s - m) v, then the merge with
    exp(m_i - M)."""
    B, _, D = q.shape
    T = xk.shape[1]
    qh = q.astype(np.float64).reshape(B, H, 1, 64)
    kh = xk.astype(np.float64).reshape(B, T, H, 64).transpose(0, 2, 1, 3)
    vh = xv.astype(np.float64).reshape(B, T, H, 64).transpose(0, 2, 1, 3)
    s = (qh @ kh.transpose(0, 1, 3, 2))[:, :, 0] * 64**-0.5  # (B, H, T)
    parts = []
    for i in range(n_split):
        sl = slice(i * per, min(T, (i + 1) * per))
        m = s[..., sl].max(-1, keepdims=True)
        e = np.exp(s[..., sl] - m)
        parts.append((m, e.sum(-1, keepdims=True), np.einsum("bht,bhtd->bhd", e, vh[:, :, sl])))
    M = np.max([m for m, _, _ in parts], axis=0)
    L = sum(l * np.exp(m - M) for m, l, _ in parts)
    O = sum(o * np.exp(m - M) for m, _, o in parts)
    return (O / L).reshape(B, 1, D)


@pytest.mark.parametrize("B,T", [(1, 1500), (8, 1500), (4, 129), (2, 8192)])
def test_xattn_split_merge_matches_pallas_and_plain(B, T):
    """Merging the splits that ``xattn_split`` picks gives the Pallas
    kernel's output (bf16 there: atol 2e-2) and the plain version's (f32:
    atol 1e-5)."""
    rng = np.random.default_rng(B * 7 + T)
    D, H = 128, 2
    q = _bf16_values(rng, B, 1, D)
    xk, xv = _bf16_values(rng, 1, B, T, D), _bf16_values(rng, 1, B, T, D)
    n_split, per = K.xattn_split(B, 20, T, 132)
    merged = _split_merge(q, xk[0], xv[0], H, n_split, per)
    o_j, _ = P.cross_attention_stacked_pallas_v2(
        0, jnp.asarray(q), jnp.asarray(xk), jnp.asarray(xv), H, block_t=128,
        score_flag=jnp.int32(0), interpret=True)
    np.testing.assert_allclose(merged, np.asarray(o_j, np.float64), atol=2e-2)
    o_t, _ = K.xattn_decode(_t(q), _t(xk), _t(xv), 0, H)
    np.testing.assert_allclose(merged, o_t.numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# self_attn_decode vs self_attention_stacked_pallas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pos", [17, 39])
def test_self_attn_plain_matches_pallas(pos):
    rng = np.random.default_rng(pos)
    L, B, CTX, D, H = 2, 3, 40, 128, 2
    q = _bf16_values(rng, B, 1, D)
    k = _bf16_values(rng, L, B, CTX, D)
    v = _bf16_values(rng, L, B, CTX, D)
    pad_len = np.array([0, 5, 20], np.int32)  # row 2 at pos 17: pos < pad_len
    for layer in range(L):
        o_j = P.self_attention_stacked_pallas(
            layer, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos,
            jnp.asarray(pad_len), H, interpret=True,
        )
        o_t = K.self_attn_decode(_t(q), _t(k), _t(v), layer, pos, _t(pad_len), H)
        assert np.isfinite(o_t.numpy()).all()
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=2e-2)


def test_self_attn_padding_query_keeps_own_slot():
    """pos < pad_len: only the query's own slot is live (never a NaN row)."""
    rng = np.random.default_rng(1)
    L, B, CTX, D, H = 1, 1, 16, 128, 2
    q = _t(_bf16_values(rng, B, 1, D))
    v = _t(_bf16_values(rng, L, B, CTX, D))
    k = _t(_bf16_values(rng, L, B, CTX, D))
    out = K.self_attn_decode(q, k, v, 0, 4, torch.tensor([9], dtype=torch.int32), H)
    torch.testing.assert_close(out[0, 0], v[0, 0, 4], rtol=0, atol=0)


@pytest.mark.parametrize("pos", [0, 17, 39])
def test_self_attn_decode_writes_the_row_and_matches_pallas(pos):
    """With k_new/v_new on CPU tensors the wrapper writes slot pos of the
    layer, as the JAX step's ``lax.dynamic_update_slice`` does (bit for bit,
    every other slot untouched), then attends over the written cache as
    ``self_attention_stacked_pallas`` does (atol 2e-2)."""
    rng = np.random.default_rng(70 + pos)
    L, B, CTX, D, H = 2, 3, 40, 128, 2
    q = _bf16_values(rng, B, 1, D)
    k, v = _bf16_values(rng, L, B, CTX, D), _bf16_values(rng, L, B, CTX, D)
    k_new, v_new = _bf16_values(rng, B, 1, D), _bf16_values(rng, B, 1, D)
    pad_len = np.array([0, 5, 20], np.int32)
    layer = 1
    at = (layer, 0, pos, 0)
    k_j = jax.lax.dynamic_update_slice(jnp.asarray(k), jnp.asarray(k_new)[None, :, :, :], at)
    v_j = jax.lax.dynamic_update_slice(jnp.asarray(v), jnp.asarray(v_new)[None, :, :, :], at)
    o_j = P.self_attention_stacked_pallas(layer, jnp.asarray(q), k_j, v_j, pos,
                                          jnp.asarray(pad_len), H, interpret=True)
    k_t, v_t = _t(k).clone(), _t(v).clone()
    o_t = K.self_attn_decode(_t(q), k_t, v_t, layer, pos, _t(pad_len), H,
                             k_new=_t(k_new), v_new=_t(v_new))
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=2e-2)
    with pytest.raises(ValueError, match="neither"):
        K.self_attn_decode(_t(q), k_t, v_t, layer, pos, _t(pad_len), H, k_new=_t(k_new))


@pytest.mark.parametrize("pos", [0, 63, 64, 232, 455])
@pytest.mark.parametrize("B", [1, 8, 40])
def test_self_attn_split_covers_the_slots(B, pos):
    """The pipeline's grid rule over the slots [0, pos] on a 132-SM card:
    whole 64-slot tiles per split, every split starting at or before pos,
    the last one holding pos; 4 splits of 64 slots at B=1, pos=232, none
    at B=40."""
    n_split, per = K.xattn_split(B, 20, pos + 1, 132)
    assert per % K.XATTN_TILE == 0
    assert (n_split - 1) * per <= pos < n_split * per
    assert n_split <= min(-(-(pos + 1) // K.XATTN_TILE), K.XATTN_MAX_SPLITS)
    if (B, pos) == (1, 232):
        assert (n_split, per) == (4, 64)
    if B == 40:
        assert n_split == 1


def _self_split_merge(q, k, v, H, pos, pad_len, n_split, per):
    """The split self-attention kernel's arithmetic, in f64: split i attends
    slots [max(lo, i * per), min(pos + 1, (i + 1) * per)) with lo =
    min(pad_len[b], pos); a split with no slots leaves (-inf, 0, 0) and
    weighs 0 in the merge. Returns (out (B, 1, D), empty splits)."""
    B, _, D = q.shape
    qh = q.astype(np.float64).reshape(B, H, 64)
    kh = k[:, : pos + 1].astype(np.float64).reshape(B, pos + 1, H, 64).transpose(0, 2, 1, 3)
    vh = v[:, : pos + 1].astype(np.float64).reshape(B, pos + 1, H, 64).transpose(0, 2, 1, 3)
    s = np.einsum("bhd,bhtd->bht", qh, kh) * 64**-0.5
    out, empty = np.zeros((B, H, 64)), 0
    for b in range(B):
        lo = max(0, min(int(pad_len[b]), pos))
        parts = []
        for i in range(n_split):
            a, z = max(lo, i * per), min(pos + 1, (i + 1) * per)
            if a >= z:
                empty += 1
                parts.append((np.full((H, 1), -np.inf), np.zeros((H, 1)), np.zeros((H, 64))))
                continue
            m = s[b, :, a:z].max(-1, keepdims=True)
            e = np.exp(s[b, :, a:z] - m)
            parts.append((m, e.sum(-1, keepdims=True), np.einsum("ht,htd->hd", e, vh[b, :, a:z])))
        M = np.max([m for m, _, _ in parts], axis=0)
        w = [np.where(m == -np.inf, 0.0, np.exp(m - M)) for m, _, _ in parts]
        out[b] = sum(o * wi for (_, _, o), wi in zip(parts, w)) / sum(
            l * wi for (_, l, _), wi in zip(parts, w))
    return out.reshape(B, 1, D), empty


@pytest.mark.parametrize("pos", [64, 232, 455])
def test_self_attn_masked_split_merge_matches_pallas_and_plain(pos):
    """Merging the splits that ``xattn_split`` picks over pos + 1 slots at
    B=4 (large-v3's 20 heads on 132 SMs), with splits wholly below pad_len
    and a row whose pad_len lies past pos: the Pallas kernel's output (bf16
    weights there: atol 2e-2) and the plain version's (f32: atol 1e-5), no
    NaN."""
    rng = np.random.default_rng(80 + pos)
    B, CTX, D, H = 4, 456, 128, 2
    q = _bf16_values(rng, B, 1, D)
    k, v = _bf16_values(rng, 1, B, CTX, D), _bf16_values(rng, 1, B, CTX, D)
    pad_len = np.array([0, 5, 224, 300], np.int32)
    n_split, per = K.xattn_split(B, 20, pos + 1, 132)
    assert n_split > 1
    merged, empty = _self_split_merge(q, k[0], v[0], H, pos, pad_len, n_split, per)
    assert empty > 0 and np.isfinite(merged).all()
    o_j = P.self_attention_stacked_pallas(0, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos,
                                          jnp.asarray(pad_len), H, interpret=True)
    np.testing.assert_allclose(merged, np.asarray(o_j, np.float64), atol=2e-2)
    o_t = K.self_attn_decode(_t(q), _t(k), _t(v), 0, pos, _t(pad_len), H)
    np.testing.assert_allclose(merged, o_t.numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# align_cost vs attention_to_cost_batched, dtw_codes vs dtw_codes_batched
# ---------------------------------------------------------------------------


def _cost_case(rng, S, K_, N, M):
    n_tok = rng.integers(2, N + 1, S)
    span = np.minimum(np.maximum(n_tok + rng.integers(0, M, S), n_tok), M - 8)
    span[0] = max(n_tok[0], 3)  # short span: the two reflection edges meet
    maxdur = np.where(np.arange(S) % 2 == 0, M, np.maximum(span // 2, 1))
    dims = np.stack([n_tok, span, maxdur, np.zeros(S, np.int64)], 1).astype(np.int32)
    scores = (rng.standard_normal((S, K_, N, M)) * 3).astype(np.float32)
    return scores, dims


@pytest.mark.parametrize("N,M", [(64, 256), (128, 1536)])
def test_align_cost_plain_matches_pallas(N, M):
    rng = np.random.default_rng(N + M)
    scores, dims = _cost_case(rng, 4, 3, N, M)
    c_j = np.asarray(P.attention_to_cost_batched(jnp.asarray(scores), jnp.asarray(dims),
                                                 interpret=True))
    c_t = K.align_cost(_t(scores), _t(dims)).numpy()
    np.testing.assert_allclose(c_t, c_j, rtol=0, atol=1e-6)
    # invalid cells are exactly 0, cost[0, 0] is the segment minimum
    for s, (n, span, _, _) in enumerate(dims):
        assert not c_t[s, n:].any() and not c_t[s, :, span:].any()
        assert c_t[s, 0, 0] == c_t[s].min()


@pytest.mark.parametrize("N,M", [(64, 256), (128, 1536)])
def test_dtw_codes_plain_matches_pallas(N, M):
    rng = np.random.default_rng(7 * N + M)
    scores, dims = _cost_case(rng, 4, 2, N, M)
    cost = K.align_cost(_t(scores), _t(dims))
    codes_j = np.asarray(P.dtw_codes_batched(jnp.asarray(cost.numpy()), jnp.asarray(dims),
                                             interpret=True))
    codes_t = K.dtw_codes(cost, _t(dims)).numpy()
    assert codes_t.shape == codes_j.shape == (4, N + M - 1, N)
    for s, (n, m, _, _) in enumerate(dims):
        # rows d < n+m-1 are the ones each kernel writes
        np.testing.assert_array_equal(codes_t[s, : n + m - 1], codes_j[s, : n + m - 1])


def test_dtw_codes_tie_order_matches_scalar_dp():
    """Small-integer costs tie often; the codes follow the scalar DP with
    strict <, DIAG before LEFT before UP, cell by cell."""
    rng = np.random.default_rng(0)
    N, M, n, m = 32, 24, 9, 13
    cost = np.zeros((1, N, M), np.float32)
    cost[0, :n, :m] = -rng.integers(0, 3, (n, m))
    codes = K.dtw_codes(_t(cost), torch.tensor([[n, m, M, 0]], dtype=torch.int32))[0]
    inf = np.inf
    g = np.full((n, m), inf)
    for i in range(n):
        for j in range(m):
            if i == j == 0:
                g[0, 0] = cost[0, 0, 0]
                continue
            cands = [g[i - 1, j - 1] if i and j else inf, g[i, j - 1] if j else inf,
                     g[i - 1, j] if i else inf]
            best, code = cands[0], K.DIAG
            if cands[1] < best:
                best, code = cands[1], K.LEFT
            if cands[2] < best:
                best, code = cands[2], K.UP
            g[i, j] = cost[0, i, j] + best
            assert int(codes[i + j, i]) == code, (i, j)


# ---------------------------------------------------------------------------
# the whole device aligner: cost + DTW + backtrace -> jumps
# ---------------------------------------------------------------------------


def test_compute_jumps_batch_matches_jax():
    tok_j = make_tokenizer(language="en", task="transcribe")
    tok_t = get_tokenizer(ranks=synthetic_ranks(), multilingual=True, num_languages=99,
                          language="en", task="transcribe")
    ts = tok_t.timestamp_begin
    rng = np.random.default_rng(5)
    K_, T = 3, 1500
    R = 64
    attn_flat = rng.standard_normal((3 * R, K_, T)).astype(np.float32)
    specs = [((0, 150, 20), 0, None), ((300, 700, 40), R, None), ((5, 60, 8), 2 * R, 40),
             ((0, 4, 30), 0, None)]  # the last one overflows its span: truncated
    tasks_j, tasks_t = [], []
    for (a, b, n_text), off, maxdur in specs:
        tokens = [ts + a] + rng.integers(ord("a"), ord("z"), n_text).tolist() + [ts + b]
        rows = np.arange(len(tokens))
        tasks_j.append(jax_make_task(tokens, off, rows, tok_j, max_duration=maxdur))
        tasks_t.append(make_task(tokens, off, rows, tok_t, max_duration=maxdur))
    j_jax = jax_jumps(jnp.asarray(attn_flat), tasks_j, interpret=True)
    j_port = compute_jumps_batch(torch.from_numpy(attn_flat), tasks_t)
    assert len(j_port) == len(specs)
    for a, b in zip(j_port, j_jax):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# stacked_matmul: the split rule and the split-K merge
# ---------------------------------------------------------------------------

# chip_smoke.py's nine shapes, the batches around the block widths, a ragged N
MATMUL_CASES = ([(B, Kd, N) for Kd, N in ((1280, 5120), (5120, 1280), (1280, 1280))
                 for B in (1, 8, 40)]
                + [(B, 1280, 5120) for B in (41, 256, 300)] + [(40, 1280, 1000)])


def _k_ranges(Kd, n_split):
    """The k-ranges of the splits, as csrc/stacked_matmul.cu cuts them:
    split s takes 64-wide k-tiles [s T / n_split, (s + 1) T / n_split)."""
    T = -(-Kd // K.MATMUL_TILE)
    return [(s * T // n_split * K.MATMUL_TILE, min(Kd, (s + 1) * T // n_split * K.MATMUL_TILE))
            for s in range(n_split)]


@pytest.mark.parametrize("B,Kd,N", MATMUL_CASES)
def test_matmul_split_covers_k_and_fills_the_card(B, Kd, N):
    """Whole k-tiles, none empty, every k once, at most 8 splits; at least
    one block for each of the 132 SMs where the shape allows, with the
    fewest splits that give it."""
    n_split, cols, groups = K.matmul_split(B, N, Kd, 132)
    k_tiles = -(-Kd // 64)
    assert 1 <= n_split <= min(K.MATMUL_MAX_SPLITS, k_tiles)
    assert groups == -(-B // 256) and cols in K.MATMUL_COLS and cols >= -(-B // groups)
    ranges = _k_ranges(Kd, n_split)
    assert all(lo % 64 == 0 and lo < hi for lo, hi in ranges)
    assert [k for lo, hi in ranges for k in range(lo, hi)] == list(range(Kd))
    tiles = -(-N // 64) * groups
    if tiles * min(K.MATMUL_MAX_SPLITS, k_tiles) >= 132:
        assert n_split * tiles >= 132 and (n_split - 1) * tiles < 132
    else:
        assert n_split == min(K.MATMUL_MAX_SPLITS, k_tiles)


@pytest.mark.parametrize("B,Kd,N", [(8, 1280, 256), (40, 640, 512), (3, 1000, 128)])
def test_matmul_split_merge_matches_pallas_and_plain(B, Kd, N):
    """Each split's f32 partial over its k-tiles, summed in split order in
    f32 as the cluster's ranks sum them (and in float64, the witness), then
    rounded once to bf16: against ``stacked_matmul_pallas`` in interpret
    mode at atol 1e-4 (f32 sums in another order) and against
    ``stacked_matmul_plain`` within the kernel's 1e-2 of the output scale."""
    rng = np.random.default_rng(B + Kd)
    L, layer = 2, 1
    x = _bf16_values(rng, B, Kd)
    w = _bf16_values(rng, L, Kd, N, scale=Kd**-0.5)  # JAX's (L, K, N)
    w_port = torch.from_numpy(np.ascontiguousarray(np.swapaxes(w, 1, 2)))
    n_split = K.matmul_split(B, N, Kd, 132)[0]
    assert n_split > 1
    parts = [torch.from_numpy(x[:, lo:hi]) @ w_port[layer][:, lo:hi].T for lo, hi in _k_ranges(Kd, n_split)]
    merged = parts[0].clone()
    for p in parts[1:]:
        merged += p
    ref = np.asarray(P.stacked_matmul_pallas(layer, jnp.asarray(x), jnp.asarray(w), interpret=True))
    np.testing.assert_allclose(merged.numpy(), ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(sum(p.double() for p in parts).numpy(), ref, rtol=0, atol=1e-4)
    plain = K.stacked_matmul_plain(torch.from_numpy(x).bfloat16(), w_port.bfloat16(), layer)
    assert (merged.bfloat16().float() - plain.float()).abs().max() <= 1e-2 * np.abs(ref).max()
