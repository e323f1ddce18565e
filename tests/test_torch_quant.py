"""The port's KV-cache quantization (int8 and int4 cross K/V, int8 self
cache) against the JAX package, in f32 on the CPU.

Quantizers: bit-exact codes and equal scales on the same f32 input, ties
at .5 included. Plain versions of the three quantized kernels against every
JAX function they replace, the Pallas kernels run in interpret mode (as
test_pallas.py runs them) at head width 64, numpy-seeded inputs:

  * int8/int4 outputs atol 2e-2 against v2 and the int4 kernel (v2 rounds
    the V-weighted softmax weights and each weight·V product to bf16, the
    plain version only the weights), 3e-2 against v4 (8-bit q and p, the
    tolerance JAX holds v4 to against v2);
  * scores atol 1e-3 against v2 and v4 (the same f32 sums of exact bf16 x
    int8 products, in another order);
  * self-int8 atol 2e-2 (the Pallas kernel rounds the weights to bf16).

Against the JAX package's XLA math (``cross_attention``, the CPU path of
its decode step), which rounds the raw q·k dot product to bf16 where the
TPU kernels and the port do not: scores within half a bf16 step of that
product (times its scales) plus 1e-5, outputs atol 2e-3; the self
fallback at f32 tolerance.

The slice: the tiny synthetic model with the JAX weights, each lever on
both engines; tokens identical, log-probs and alignment rows within the
tolerances stated at ``SLICE_TOL``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from model_utils import N_LANGS, hf_model_to_jax, make_hf_model, make_tokenizer  # noqa: E402
from whisper_timestamped_tpu.decoding import DecodingOptions as JaxOptions  # noqa: E402
from whisper_timestamped_tpu.engine import DecodeEngine as JaxEngine  # noqa: E402
from whisper_timestamped_tpu.models import whisper_jax as J  # noqa: E402
from whisper_timestamped_tpu.models.load import WhisperModel as JaxModel  # noqa: E402
from whisper_timestamped_tpu.ops import pallas_kernels as P  # noqa: E402
from whisper_timestamped_tpu.api import transcribe_timestamped as jax_transcribe  # noqa: E402
from whisper_timestamped_tpu.parallel import batch as JB  # noqa: E402
import whisper_timestamped_tpu_torch.decoding as port_decoding  # noqa: E402
from whisper_timestamped_tpu_torch import transcribe_timestamped  # noqa: E402
from whisper_timestamped_tpu_torch.decoding import DecodingOptions  # noqa: E402
from whisper_timestamped_tpu_torch.engine import DecodeEngine  # noqa: E402
from whisper_timestamped_tpu_torch.models import WhisperDims, WhisperModel, params_from_jax_tree  # noqa: E402
from whisper_timestamped_tpu_torch.models import whisper_torch as W  # noqa: E402
from whisper_timestamped_tpu_torch.ops import kernels as K  # noqa: E402
from whisper_timestamped_tpu_torch.ops import quant as Q  # noqa: E402
from whisper_timestamped_tpu_torch.parallel import batch as B  # noqa: E402
from whisper_timestamped_tpu_torch.tokenizer import get_tokenizer, synthetic_ranks  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# Quantizers: bit-exact with the JAX package
# ---------------------------------------------------------------------------


def _with_ties(x, top):
    """Rows whose max is ``top`` (scale exactly 1) and which hold values at
    .5, so round-half-to-even decides them."""
    x = x.copy()
    x[..., 0, 0] = top
    x[..., 0, 1:6] = [2.5, -2.5, 3.5, 0.5, -1.5]
    x[..., 1, 0] = -top
    x[..., 1, 1:4] = [1.5, -0.5, 4.5]
    return x


def test_quantize_rows_bit_exact():
    rng = np.random.default_rng(0)
    x = _with_ties(_f32(rng, 2, 3, 10, 16, scale=3.0), 127.0)
    x[1, 2, 5] = 0.0  # an all-zero row: scale 0, codes 0
    qj, sj = J._quantize_rows(jnp.asarray(x))
    qt, st = Q.quantize_rows(_t(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert qt[0, 0, 0, 1:6].tolist() == [2, -2, 4, 0, -2]  # half to even


def test_quantize_rows_int4_bit_exact():
    rng = np.random.default_rng(1)
    x = _with_ties(_f32(rng, 2, 3, 10, 16, scale=3.0), 7.0)
    pj, sj = J._quantize_rows_int4(jnp.asarray(x))
    pt, st = Q.quantize_rows_int4(_t(x))
    assert pt.shape == (2, 3, 5, 16) and pt.dtype == torch.int8 and st.shape == (2, 3, 10)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    codes = Q.unpack_int4_rows(pt)
    assert codes[0, 0, 0, 1:6].tolist() == [2, -2, 4, 0, -2]
    with pytest.raises(ValueError, match="even"):
        Q.quantize_rows_int4(_t(x[..., :9, :]))


def test_int4_unpack_and_scale_order_bit_exact():
    """Every nibble pair, both helpers, and the pack/unpack round trip."""
    vals = np.arange(-7, 8, dtype=np.int32)
    lo, hi = np.meshgrid(vals, vals, indexing="ij")
    packed = ((lo.reshape(-1) & 0xF) | (hi.reshape(-1) << 4)).astype(np.int8)
    packed = np.tile(packed.reshape(1, -1, 1), (2, 1, 3))  # (2, 225, 3)
    got = Q.unpack_int4_rows(_t(packed))
    np.testing.assert_array_equal(got.numpy(), np.asarray(J._unpack_int4_rows(jnp.asarray(packed))))
    np.testing.assert_array_equal(got[0, 0::2, 0].numpy(), lo.reshape(-1))
    np.testing.assert_array_equal(got[0, 1::2, 0].numpy(), hi.reshape(-1))
    s = np.random.default_rng(2).random((2, 3, 12)).astype(np.float32)
    np.testing.assert_array_equal(Q.int4_scales_frame_order(_t(s)).numpy(),
                                  np.asarray(J._int4_scales_frame_order(jnp.asarray(s))))
    # round trip: quantize, unpack, reorder = the frame-ordered int4 codes
    x = _f32(np.random.default_rng(3), 2, 10, 16, scale=4.0)
    pt, st = Q.quantize_rows_int4(_t(x))
    sf = Q.int4_scales_frame_order(st).numpy()
    want = np.clip(np.round(x / np.maximum(sf, 1e-8)[..., None]), -7, 7).astype(np.int8)
    np.testing.assert_array_equal(Q.unpack_int4_rows(pt).numpy(), want)


# ---------------------------------------------------------------------------
# Plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

L_, B_, T_, D_, H_ = 2, 4, 300, 128, 2  # dh = 64, H even: the kernels' layout


def _int8_inputs(seed, B_kv, quantizer=J._quantize_rows):
    """q bf16-representable (the kernels take bf16 q; the unstacked Pallas
    kernel reads q as it comes), int8/int4 K/V from the JAX quantizer."""
    rng = np.random.default_rng(seed)
    q = _t(_f32(rng, B_, 1, D_)).bfloat16().float().numpy()
    k8, ks = quantizer(jnp.asarray(_f32(rng, L_, B_kv, T_, D_)))
    v8, vs = quantizer(jnp.asarray(_f32(rng, L_, B_kv, T_, D_)))
    return q, np.asarray(k8), np.asarray(ks), np.asarray(v8), np.asarray(vs)


@pytest.mark.parametrize("version", ["v2", "v4"])
@pytest.mark.parametrize("beam_group", [1, 2])
@pytest.mark.parametrize("score_flag", [1, 0])
def test_xattn_int8_plain_matches_pallas(version, beam_group, score_flag):
    fn = {"v2": P.cross_attention_stacked_int8_pallas_v2,
          "v4": P.cross_attention_stacked_int8_pallas_v4}[version]
    q, k8, ks, v8, vs = _int8_inputs(20 + beam_group + 3 * score_flag, B_ // beam_group)
    for layer in range(L_):
        o_j, s_j = fn(layer, jnp.asarray(q), *map(jnp.asarray, (k8, ks, v8, vs)), H_,
                      block_t=128, score_flag=jnp.int32(score_flag), beam_group=beam_group,
                      interpret=True)
        o_t, s_t = K.xattn_decode_int8(_t(q), _t(k8), _t(ks), _t(v8), _t(vs), layer, H_,
                                       emit_scores=bool(score_flag), beam_group=beam_group)
        assert o_t.shape == (B_, 1, D_) and o_t.dtype == torch.float32
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j),
                                   atol=2e-2 if version == "v2" else 3e-2)
        if score_flag:
            assert s_t.shape == (B_, H_, 1, T_)
            np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-3)
        else:
            assert s_t is None


def test_xattn_int8_plain_matches_unstacked_pallas():
    """cross_attention_int8_pallas: the same function on one (B, T, D) layer
    (what the JAX prefill runs for the last prompt row)."""
    q, k8, ks, v8, vs = _int8_inputs(30, B_)
    o_j, s_j = P.cross_attention_int8_pallas(jnp.asarray(q), *map(jnp.asarray, (k8[1], ks[1], v8[1], vs[1])),
                                             H_, interpret=True)
    o_t, s_t = K.xattn_decode_int8(_t(q), _t(k8), _t(ks), _t(v8), _t(vs), 1, H_, emit_scores=True)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=2e-2)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-3)


def _int8_split_merge(q, k8, ks, v8, vs, H, n_split, per):
    """The split-T int8 kernel's arithmetic, in f64: scores (q·k)·ks·dh^-0.5
    over the exactly widened codes, each split's max m, sum l of exp(s - m)
    and o = sum exp(s - m)·vs·v, then the merge with exp(m_i - M)."""
    B, _, D = q.shape
    T = k8.shape[1]
    qh = q.astype(np.float64).reshape(B, H, 1, 64)
    kh = k8.astype(np.float64).reshape(B, T, H, 64).transpose(0, 2, 1, 3)
    vh = v8.astype(np.float64).reshape(B, T, H, 64).transpose(0, 2, 1, 3)
    s = (qh @ kh.transpose(0, 1, 3, 2))[:, :, 0] * ks.astype(np.float64)[:, None] * 64**-0.5
    parts = []
    for i in range(n_split):
        sl = slice(i * per, min(T, (i + 1) * per))
        m = s[..., sl].max(-1, keepdims=True)
        e = np.exp(s[..., sl] - m)
        w = e * vs[:, None, sl].astype(np.float64)
        parts.append((m, e.sum(-1, keepdims=True), np.einsum("bht,bhtd->bhd", w, vh[:, :, sl])))
    M = np.max([m for m, _, _ in parts], axis=0)
    L = sum(l * np.exp(m - M) for m, l, _ in parts)
    O = sum(o * np.exp(m - M) for m, _, o in parts)
    return (O / L).reshape(B, 1, D), s[:, :, None]


@pytest.mark.parametrize("B,T", [(1, 1500), (8, 1500), (4, 129)])
def test_xattn_int8_split_merge_matches_pallas_and_plain(B, T):
    """Merging the splits that ``xattn_split`` picks for the int8 kernel
    (large-v3's 20 heads on 132 SMs) gives v2's output in interpret mode
    (atol 2e-2, as the plain version is held to it) and the plain
    version's (atol 4e-3: the plain version rounds the V-weighted weights
    to bf16, as the card tests hold the kernel to it); the scores equal the
    plain version's at f32 tolerance."""
    rng = np.random.default_rng(B * 11 + T)
    D, H = 128, 2
    q = _t(_f32(rng, B, 1, D)).bfloat16().float().numpy()
    k8, ks = map(np.asarray, J._quantize_rows(jnp.asarray(_f32(rng, 1, B, T, D))))
    v8, vs = map(np.asarray, J._quantize_rows(jnp.asarray(_f32(rng, 1, B, T, D))))
    n_split, per = K.xattn_split(B, 20, T, 132)
    assert n_split > 1
    merged, s = _int8_split_merge(q, k8[0], ks[0], v8[0], vs[0], H, n_split, per)
    o_j, _ = P.cross_attention_stacked_int8_pallas_v2(
        0, jnp.asarray(q), *map(jnp.asarray, (k8, ks, v8, vs)), H, block_t=128,
        score_flag=jnp.int32(0), interpret=True)
    np.testing.assert_allclose(merged, np.asarray(o_j, np.float64), atol=2e-2)
    o_t, s_t = K.xattn_decode_int8(_t(q), _t(k8), _t(ks), _t(v8), _t(vs), 0, H, emit_scores=True)
    np.testing.assert_allclose(merged, o_t.numpy(), rtol=0, atol=4e-3)
    np.testing.assert_allclose(s, s_t.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("beam_group", [1, 2])
@pytest.mark.parametrize("score_flag", [1, 0])
def test_xattn_int4_plain_matches_pallas(beam_group, score_flag):
    q, k4, ks, v4, vs = _int8_inputs(40 + beam_group + 3 * score_flag, B_ // beam_group,
                                     quantizer=J._quantize_rows_int4)
    assert k4.shape[2] == T_ // 2 and ks.shape[2] == T_
    # the JAX int4 kernel's own beam_group path reshapes its scales with the
    # query batch and fails for beam_group > 1, so it reads the K/V rows
    # repeated beam_group times instead (what beam_group stands for)
    kv_j = [jnp.repeat(jnp.asarray(a), beam_group, axis=1) for a in (k4, ks, v4, vs)]
    for layer in range(L_):
        o_j, s_j = P.cross_attention_stacked_int4_pallas(
            layer, jnp.asarray(q), *kv_j, H_, block_t=128,
            score_flag=jnp.int32(score_flag), interpret=True)
        o_t, s_t = K.xattn_decode_int4(_t(q), _t(k4), _t(ks), _t(v4), _t(vs), layer, H_,
                                       emit_scores=bool(score_flag), beam_group=beam_group)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=3e-2)
        if score_flag:
            assert s_t.shape == (B_, H_, 1, T_)  # frame order
            np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=3e-2)
        else:
            assert s_t is None


@pytest.mark.parametrize("B,T", [(1, 1500), (8, 1500), (4, 258)])
def test_xattn_int4_split_merge_matches_pallas_and_plain(B, T):
    """The int4 kernel's split is over the T/2 packed rows (``xattn_split``
    over T // 2 rows of two frames, large-v3's 20 heads on 132 SMs), so split i holds frames
    [2 i per, 2 (i + 1) per). Merging those splits' (m, l, o) in f64 over the
    unpacked codes and frame-ordered scales gives the int4 Pallas kernel's
    output in interpret mode (atol 3e-2, as the plain version is held to it)
    and the plain version's (atol 4e-3, as the card tests hold the kernel to
    it); the scores, in frame order, equal the plain version's at f32
    tolerance."""
    rng = np.random.default_rng(B * 13 + T)
    D, H = 128, 2
    q = _t(_f32(rng, B, 1, D)).bfloat16().float().numpy()
    k4, ks = map(np.asarray, J._quantize_rows_int4(jnp.asarray(_f32(rng, 1, B, T, D))))
    v4, vs = map(np.asarray, J._quantize_rows_int4(jnp.asarray(_f32(rng, 1, B, T, D))))
    n_split, per = K.xattn_split(B, 20, T // 2, 132, frames_per_row=2)
    assert n_split > 1 and per % K.XATTN_TILE == 0
    frames = [np.asarray(J._unpack_int4_rows(jnp.asarray(a)))[0] for a in (k4, v4)]
    scales = [np.asarray(J._int4_scales_frame_order(jnp.asarray(a)))[0] for a in (ks, vs)]
    merged, s = _int8_split_merge(q, frames[0], scales[0], frames[1], scales[1], H, n_split,
                                  2 * per)
    o_j, _ = P.cross_attention_stacked_int4_pallas(
        0, jnp.asarray(q), *map(jnp.asarray, (k4, ks, v4, vs)), H, block_t=128,
        score_flag=jnp.int32(0), interpret=True)
    np.testing.assert_allclose(merged, np.asarray(o_j, np.float64), atol=3e-2)
    o_t, s_t = K.xattn_decode_int4(_t(q), _t(k4), _t(ks), _t(v4), _t(vs), 0, H, emit_scores=True)
    np.testing.assert_allclose(merged, o_t.numpy(), rtol=0, atol=4e-3)
    assert s_t.shape == (B, H, 1, T)
    np.testing.assert_allclose(s, s_t.numpy(), rtol=1e-5, atol=1e-5)


def _self_inputs(seed):
    rng = np.random.default_rng(seed)
    ctx = 40
    q = _f32(rng, B_, 1, D_)
    k8, ks = J._quantize_rows(jnp.asarray(_f32(rng, L_, B_, ctx, D_)))
    v8, vs = J._quantize_rows(jnp.asarray(_f32(rng, L_, B_, ctx, D_)))
    # row 3's padding reaches past pos: only its own slot is live
    pad = np.array([0, 5, 17, 30], np.int32)
    return q, np.asarray(k8), np.asarray(ks), np.asarray(v8), np.asarray(vs), pad


@pytest.mark.parametrize("pos", [17, 25])
def test_self_attn_int8_plain_matches_pallas(pos):
    q, k8, ks, v8, vs, pad = _self_inputs(50 + pos)
    for layer in range(L_):
        o_j = P.self_attention_stacked_int8_pallas(
            layer, jnp.asarray(q), *map(jnp.asarray, (k8, ks, v8, vs)), pos,
            jnp.asarray(pad), H_, interpret=True)
        o_t = K.self_attn_decode_int8_plain(_t(q), _t(k8), _t(ks), _t(v8), _t(vs), layer, pos,
                                            _t(pad), H_)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=2e-2)
    # a padding-slot row attends only its own slot: its output is that V row
    v_own = v8[1, 3, pos].astype(np.float32) * vs[1, 3, pos]
    np.testing.assert_allclose(o_t[3, 0].numpy(), v_own, rtol=1e-6, atol=1e-6)


def test_self_attn_int8_wrapper_writes_the_row():
    """On the CPU the wrapper quantizes the new rows into slot pos (as the
    JAX step's cache update does) and attends with the plain version."""
    q, k8, ks, v8, vs, pad = _self_inputs(60)
    rng = np.random.default_rng(61)
    k_new, v_new = _f32(rng, B_, 1, D_), _f32(rng, B_, 1, D_)
    caches = [_t(a).clone() for a in (k8, ks, v8, vs)]
    out = K.self_attn_decode_int8(_t(q), _t(k_new), _t(v_new), *caches, 1, 20, _t(pad), H_)
    kq, kq_s = J._quantize_rows(jnp.asarray(k_new[:, 0]))
    vq, vq_s = J._quantize_rows(jnp.asarray(v_new[:, 0]))
    np.testing.assert_array_equal(caches[0][1, :, 20].numpy(), np.asarray(kq))
    np.testing.assert_array_equal(caches[1][1, :, 20].numpy(), np.asarray(kq_s))
    np.testing.assert_array_equal(caches[2][1, :, 20].numpy(), np.asarray(vq))
    np.testing.assert_array_equal(caches[3][1, :, 20].numpy(), np.asarray(vq_s))
    assert torch.equal(caches[0][0], _t(k8)[0]) and torch.equal(caches[0][1, :, 21:], _t(k8)[1, :, 21:])
    want = K.self_attn_decode_int8_plain(_t(q), *caches, 1, 20, _t(pad), H_)
    assert torch.equal(out, want)


def _self_int8_split_merge(q, k8, ks, v8, vs, H, pos, pad_len, n_split, per):
    """The split int8 self kernel's arithmetic, in f64: split i attends slots
    [max(lo, i * per), min(pos + 1, (i + 1) * per)) with lo = min(pad_len[b],
    pos), scores (q·k)·ks·dh^-0.5 over the exact codes, weights exp(s - m)·vs;
    a split with no slots leaves (-inf, 0, 0) and weighs 0 in the merge.
    Returns (out (B, 1, D), empty splits)."""
    B, _, D = q.shape
    n = pos + 1
    qh = q.astype(np.float64).reshape(B, H, 64)
    kh = k8[:, :n].astype(np.float64).reshape(B, n, H, 64).transpose(0, 2, 1, 3)
    vh = v8[:, :n].astype(np.float64).reshape(B, n, H, 64).transpose(0, 2, 1, 3)
    s = np.einsum("bhd,bhtd->bht", qh, kh) * ks[:, None, :n].astype(np.float64) * 64**-0.5
    out, empty = np.zeros((B, H, 64)), 0
    for b in range(B):
        lo = max(0, min(int(pad_len[b]), pos))
        parts = []
        for i in range(n_split):
            a, z = max(lo, i * per), min(n, (i + 1) * per)
            if a >= z:
                empty += 1
                parts.append((np.full((H, 1), -np.inf), np.zeros((H, 1)), np.zeros((H, 64))))
                continue
            m = s[b, :, a:z].max(-1, keepdims=True)
            e = np.exp(s[b, :, a:z] - m)
            w = e * vs[b, a:z].astype(np.float64)
            parts.append((m, e.sum(-1, keepdims=True), np.einsum("ht,htd->hd", w, vh[b, :, a:z])))
        M = np.max([m for m, _, _ in parts], axis=0)
        wt = [np.where(m == -np.inf, 0.0, np.exp(m - M)) for m, _, _ in parts]
        out[b] = sum(o * w for (_, _, o), w in zip(parts, wt)) / sum(
            l * w for (_, l, _), w in zip(parts, wt))
    return out.reshape(B, 1, D), empty


@pytest.mark.parametrize("pos", [0, 63, 64, 232, 455])
def test_self_attn_int8_split_merge_matches_pallas_and_plain(pos):
    """The int8 self kernel's launch at B=4, ctx 456: the step's new rows
    quantized into slot pos bit for bit as the JAX step does
    (``_quantize_rows`` + ``lax.dynamic_update_slice``), then the splits
    that ``xattn_split`` picks over pos + 1 slots (large-v3's 20 heads on
    132 SMs), some wholly below pad_len (224) and one row's pad_len past
    pos (300), merged in f64: the int8 Pallas kernel's output in interpret
    mode (atol 2e-2: it rounds the weights to bf16) and the plain
    version's (f32 over the dequantized cache: atol 1e-5), no NaN."""
    rng = np.random.default_rng(90 + pos)
    B, CTX, D, H = 4, 456, 128, 2
    q = _t(_f32(rng, B, 1, D)).bfloat16().float().numpy()
    k_new, v_new = (_t(_f32(rng, B, 1, D)).bfloat16().float().numpy() for _ in range(2))
    k8, ks = map(np.asarray, J._quantize_rows(jnp.asarray(_f32(rng, 1, B, CTX, D))))
    v8, vs = map(np.asarray, J._quantize_rows(jnp.asarray(_f32(rng, 1, B, CTX, D))))
    pad = np.array([0, 5, 224, 300], np.int32)
    kq, kqs = J._quantize_rows(jnp.asarray(k_new[:, 0]))
    vq, vqs = J._quantize_rows(jnp.asarray(v_new[:, 0]))
    up = jax.lax.dynamic_update_slice
    written = [np.asarray(a) for a in (
        up(jnp.asarray(k8), kq[None, :, None, :], (0, 0, pos, 0)),
        up(jnp.asarray(ks), kqs[None, :, None], (0, 0, pos)),
        up(jnp.asarray(v8), vq[None, :, None, :], (0, 0, pos, 0)),
        up(jnp.asarray(vs), vqs[None, :, None], (0, 0, pos)))]
    caches = [_t(a).clone() for a in (k8, ks, v8, vs)]
    o_t = K.self_attn_decode_int8(_t(q), _t(k_new), _t(v_new), *caches, 0, pos, _t(pad), H)
    for got, want in zip(caches, written):
        np.testing.assert_array_equal(got.numpy(), want)
    n_split, per = K.xattn_split(B, 20, pos + 1, 132)
    merged, empty = _self_int8_split_merge(q, *(a[0] for a in written), H, pos, pad, n_split, per)
    if pos >= 232:
        assert n_split > 1 and empty > 0
    assert np.isfinite(merged).all()
    o_j = P.self_attention_stacked_int8_pallas(0, jnp.asarray(q), *map(jnp.asarray, written), pos,
                                               jnp.asarray(pad), H, interpret=True)
    np.testing.assert_allclose(merged, np.asarray(o_j, np.float64), atol=2e-2)
    np.testing.assert_allclose(merged, o_t.numpy(), rtol=0, atol=1e-5)


def test_xattn_plain_matches_pallas_v1():
    """The bf16 plain version against the first stacked bf16 kernel
    (cross_attention_stacked_pallas, v1): the same function as v2."""
    rng = np.random.default_rng(70)
    q = _f32(rng, B_, 1, D_)
    xk, xv = _f32(rng, L_, B_, T_, D_), _f32(rng, L_, B_, T_, D_)
    for layer in range(L_):
        o_j, s_j = P.cross_attention_stacked_pallas(layer, jnp.asarray(q), jnp.asarray(xk),
                                                    jnp.asarray(xv), H_, interpret=True)
        o_t, s_t = K.xattn_decode(_t(q), _t(xk), _t(xv), layer, H_, emit_scores=True)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# Plain versions against the JAX package's XLA math (its CPU decode path)
# ---------------------------------------------------------------------------


def _bf16_half_step(x):
    """Half the spacing of bf16 values at |x|: the largest error of rounding
    x to bf16."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return 2.0 ** (e - 8)


@pytest.mark.parametrize("int4", [False, True])
def test_xattn_quantized_plain_matches_xla_math(int4):
    """Scores equal the XLA math's up to its bf16 rounding of the raw q·k
    product; outputs atol 2e-3 (that rounding, and XLA's bf16 output)."""
    q, kq, ks, vq, vs = _int8_inputs(80 + int4, B_, J._quantize_rows_int4 if int4 else J._quantize_rows)
    fn = K.xattn_decode_int4 if int4 else K.xattn_decode_int8
    k8, v8 = (J._unpack_int4_rows(jnp.asarray(a)) for a in (kq, vq)) if int4 else (kq, vq)
    ksf, vsf = (J._int4_scales_frame_order(jnp.asarray(a)) for a in (ks, vs)) if int4 else (ks, vs)
    dh = D_ // H_
    for layer in range(L_):
        o_j, s_j = J.cross_attention(jnp.asarray(q), jnp.asarray(k8[layer]), jnp.asarray(v8[layer]),
                                     jnp.asarray(ksf[layer]), jnp.asarray(vsf[layer]), H_)
        o_t, s_t = fn(_t(q), _t(kq), _t(ks), _t(vq), _t(vs), layer, H_, emit_scores=True)
        raw = s_t.numpy() / (np.asarray(ksf[layer])[:, None, None, :] * dh**-0.5)
        bound = _bf16_half_step(raw) * np.asarray(ksf[layer])[:, None, None, :] * dh**-0.5 + 1e-5
        assert np.all(np.abs(s_t.numpy() - np.asarray(s_j)) <= bound)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=2e-3)


def test_self_attn_int8_plain_matches_jax_fallback():
    """The JAX step's CPU fallback: dequantize in the activation type and
    run the masked ``_attention``; f32 tolerance."""
    q, k8, ks, v8, vs, pad = _self_inputs(90)
    pos, ctx = 25, k8.shape[2]
    col = np.arange(ctx)
    mask = np.where(((col[None] >= pad[:, None]) & (col[None] <= pos)) | (col[None] == pos),
                    0.0, -np.inf)[:, None, None, :].astype(np.float32)
    for layer in range(L_):
        kd = jnp.asarray(k8[layer]).astype(jnp.float32) * jnp.asarray(ks[layer])[..., None]
        vd = jnp.asarray(v8[layer]).astype(jnp.float32) * jnp.asarray(vs[layer])[..., None]
        o_j, _ = J._attention(jnp.asarray(q), kd, vd, H_, mask=jnp.asarray(mask))
        o_t = K.self_attn_decode_int8_plain(_t(q), _t(k8), _t(ks), _t(v8), _t(vs), layer, pos,
                                            _t(pad), H_)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# The slice: the engine levers end to end, against the JAX engine
# ---------------------------------------------------------------------------

HEADS = [(0, 1), (1, 0), (1, 2)]
LEVERS = {"kv_int8": dict(kv_int8=True), "kv_int4": dict(kv_int4=True),
          "self_kv_int8": dict(self_kv_int8=True)}
# log-probs and alignment rows: in the decode steps the XLA math of the JAX
# engine rounds each q·k dot product of the quantized cross-attention to
# bf16 (up to 2^-9 of it), the port keeps it f32 (see int8_attention):
# measured up to 3.2e-4 and 4.1e-4 here; the self cache's dequantized math
# is the same on both sides, f32 tolerance. The small prompt region's
# prefill runs the XLA math on both sides, so the first row of alignment
# scores (the last prompt row's) is held at f32 tolerance.
SLICE_TOL = {"kv_int8": dict(rtol=1e-3, atol=1e-3), "kv_int4": dict(rtol=1e-3, atol=1e-3),
             "self_kv_int8": dict(rtol=1e-4, atol=1e-5)}


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


@pytest.mark.parametrize("prompt_len", [0, 120])
@pytest.mark.parametrize("lever", sorted(LEVERS))
def test_decode_window_with_lever_matches_jax(models, lever, prompt_len):
    jax_model, model = models
    mel = np.random.default_rng(5).standard_normal((80, 3000)).astype(np.float32) * 0.5
    prompt = list(range(300, 300 + prompt_len))
    rj = JaxEngine(jax_model, make_tokenizer(), **LEVERS[lever]).decode_window(
        mel, JaxOptions(language="en", sample_len=40), prompt_tokens=prompt)[0]
    engine = DecodeEngine(model, _tok(), **LEVERS[lever])
    assert getattr(engine, lever)
    rt = engine.decode_window(torch.from_numpy(mel), DecodingOptions(language="en", sample_len=40),
                              prompt_tokens=prompt)[0]
    assert rt.tokens == rj.tokens and len(rt.tokens) > 2
    assert rt.hit_limit == rj.hit_limit
    tol = SLICE_TOL[lever]
    np.testing.assert_allclose(rt.token_logprobs, rj.token_logprobs, **tol)
    assert rt.no_speech_prob == pytest.approx(rj.no_speech_prob, rel=tol["rtol"], abs=1e-6)
    np.testing.assert_allclose(rt.attn, rj.attn, **tol)
    if prompt_len == 0:
        np.testing.assert_allclose(rt.attn[:1], rj.attn[:1], rtol=1e-5, atol=1e-6)


def test_transcribe_batch_kv_int8_matches_jax(models):
    jax_model, model = models
    audios = {"a": _audio(0, 8), "b": _audio(1, 5), "c": _audio(2, 12)}
    kw = dict(language="en", batch_size=4, temperature=[0.0], no_speech_threshold=None,
              logprob_threshold=None, compression_ratio_threshold=None)
    got = B.transcribe_batch(model, audios, _tok(), engine=DecodeEngine(model, _tok(), kv_int8=True),
                             **kw)
    jtok = make_tokenizer(language="en", task="transcribe")
    want = JB.transcribe_batch(jax_model, audios, jtok, engine=JaxEngine(jax_model, jtok, kv_int8=True),
                               device_alignment=True, **kw)
    assert list(got) == list(want)
    for name in audios:
        assert [s["tokens"] for s in got[name]["segments"]] == \
            [s["tokens"] for s in want[name]["segments"]], name
    assert sum(len(s.get("words", [])) for r in got.values() for s in r["segments"]) > 0


def _audio(seed, seconds):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(16000 * seconds)) * 0.1).astype(np.float32)


def test_kv_int8_env_default_reaches_transcribe_timestamped(models, monkeypatch):
    """WTT_KV_INT8=1 makes transcribe_timestamped's engine build int8 cross
    K/V, and the result's tokens are the JAX package's under the same
    variable."""
    from whisper_timestamped_tpu.api import transcribe_timestamped as jax_transcribe

    jax_model, model = models
    monkeypatch.setenv("WTT_KV_INT8", "1")
    seen = []
    init_cache = port_decoding.init_cache

    def spy(*args, **kwargs):
        cache = init_cache(*args, **kwargs)
        seen.append((kwargs.get("quantize_cross"), cache.xk.dtype))
        return cache

    monkeypatch.setattr(port_decoding, "init_cache", spy)
    kw = dict(language="en", no_speech_threshold=None, logprob_threshold=None,
              compression_ratio_threshold=None)
    audio = _audio(7, 7)
    got = transcribe_timestamped(model, audio, tokenizer=_tok(), **kw)
    want = jax_transcribe(jax_model, audio, tokenizer=make_tokenizer(), device_alignment=True, **kw)
    assert seen and all(s == (True, torch.int8) for s in seen)
    assert [s["tokens"] for s in got["segments"]] == [s["tokens"] for s in want["segments"]]


@pytest.mark.parametrize("lever", ["w_int8", "enc_int8"])
def test_unported_weight_levers_raise_from_env(models, monkeypatch, lever):
    """Once refused, each weight lever's environment variable now sets its
    default (an argument wins), and reaches ``transcribe_timestamped``: its
    tokens equal JAX's under the same variable."""
    jax_model, model = models
    monkeypatch.setenv(f"WTT_{lever.upper()}", "1")
    assert getattr(DecodeEngine(model, _tok()), lever)
    assert not getattr(DecodeEngine(model, _tok(), **{lever: False}), lever)
    kw = dict(language="en", no_speech_threshold=None, logprob_threshold=None,
              compression_ratio_threshold=None)
    audio = _audio(7, 7)
    got = transcribe_timestamped(model, audio, tokenizer=_tok(), **kw)
    want = jax_transcribe(jax_model, audio, tokenizer=make_tokenizer(), device_alignment=True, **kw)
    assert [s["tokens"] for s in got["segments"]] == [s["tokens"] for s in want["segments"]]


# ---------------------------------------------------------------------------
# The weight levers: int8 copies of the linears (w_int8, enc_int8)
# ---------------------------------------------------------------------------


def _jax_leaf(tree, name):
    """The JAX blocks leaf of a port parameter name (``attn_q_w`` ->
    ``tree["attn"]["q"]``, ``fc1_w`` -> ``tree["mlp"]["fc1"]``)."""
    p, _, n = name[: -len("_w")].partition("_")
    return tree["mlp"][p] if p in ("fc1", "fc2") else tree[p][n]


def test_quantize_linear_bit_exact():
    """Codes and scales of ``quantize_linear`` equal JAX's jitted
    ``quantize_linear_tree`` on the transposed weight, bit for bit: ties at
    .5 of a scale-1 column, an all-zero column (scale 0, codes 0)."""
    rng = np.random.default_rng(7)
    w = _f32(rng, 3, 24, 40, scale=0.2)  # (L, in, out), JAX's layout
    w[0, :, 0] = 0.0
    w[1, 0, 1] = 127.0
    w[1, 1:6, 1] = [2.5, -2.5, 3.5, 0.5, -1.5]
    got = W.quantize_linear(_t(np.swapaxes(w, -1, -2)))
    want = jax.jit(J.quantize_linear_tree)({"w": jnp.asarray(w), "b": jnp.zeros((3, 40))})
    assert got.w8.dtype == torch.int8 and got.s.dtype == torch.float32
    np.testing.assert_array_equal(got.w8.numpy(), np.swapaxes(np.asarray(want["w8"]), -1, -2))
    np.testing.assert_array_equal(got.s.numpy(), np.swapaxes(np.asarray(want["s"]), -1, -2))
    assert got.w8[1, 1, 1:6].tolist() == [2, -2, 4, 0, -2]  # half to even
    assert not got.w8[0, 0].any() and float(got.s[0, 0, 0]) == 0.0


def test_engine_int8_copies_equal_jax(models):
    """Every int8 copy the port's engine builds (decoder blocks, logits,
    encoder blocks) equals the JAX engine's, transposed, bit for bit; the
    caller's module is left as it was."""
    jax_model, model = models
    before = {k: v.clone() for pd in (model.module.encoder, model.module.decoder)
              for k, v in pd.items()}
    je = JaxEngine(jax_model, make_tokenizer(), w_int8=True, enc_int8=True)
    te = DecodeEngine(model, _tok(), w_int8=True, enc_int8=True)
    jd, td = je.model.params["decoder"], te.model.module.decoder
    je_enc, te_enc = je.model.params["encoder"]["blocks_w8"], te.model.module.encoder
    pairs = [(q, _jax_leaf(jd["blocks_w8"], n)) for n, q in td["blocks_w8"].items()]
    pairs += [(q, _jax_leaf(je_enc, n)) for n, q in te_enc.items() if isinstance(q, W.Int8Weight)]
    assert len(pairs) == 10 + 6
    for q, jq in pairs:
        np.testing.assert_array_equal(q.w8.numpy(), np.swapaxes(np.asarray(jq["w8"]), -1, -2))
        np.testing.assert_array_equal(q.s.numpy(), np.swapaxes(np.asarray(jq["s"]), -1, -2))
    lq, jl = td["logits_w8"], jd["logits_w8"]
    np.testing.assert_array_equal(lq.w8.numpy(), np.asarray(jl["w8"]).T)
    np.testing.assert_array_equal(lq.s.numpy(), np.asarray(jl["s"]).T)
    assert all(te_enc[n].act_int8 for n in te_enc if isinstance(te_enc[n], W.Int8Weight))
    assert not any(q.act_int8 for q in td["blocks_w8"].values())
    after = {k: v for pd in (model.module.encoder, model.module.decoder) for k, v in pd.items()}
    assert list(after) == list(before)
    for k in before:
        assert after[k].dtype == before[k].dtype and torch.equal(after[k], before[k]), k


def test_int8_linears_match_jax(models):
    """The weight-only linear, the W8A8 linear and the int8 logits against
    JAX's jitted ``_linear`` (``w8`` branch), ``_linear_w8a8`` and
    ``_logits`` on the engines' copies and the same inputs: equal within
    1e-6 (measured 0: the same f32 products in the same order here)."""
    jax_model, model = models
    je = JaxEngine(jax_model, make_tokenizer(), w_int8=True, enc_int8=True)
    te = DecodeEngine(model, _tok(), w_int8=True, enc_int8=True)
    rng = np.random.default_rng(3)
    x = _f32(rng, 2, 40, 64)
    x[0, 3] = 0.0  # an all-zero token: scale 0, codes 0
    jd, td = je.model.params["decoder"], te.model.module.decoder
    layer = lambda tree: jax.tree.map(lambda a: a[1], tree)  # noqa: E731
    cases = [
        (jax.jit(J._linear)(jnp.asarray(x), layer(jd["blocks_w8"]["mlp"]["fc1"])),
         W._linear(_t(x), td["blocks_w8"]["fc1_w"][1], td["fc1_b"][1])),
        (jax.jit(J._linear)(jnp.asarray(x), layer(jd["blocks_w8"]["attn"]["k"])),
         W._linear(_t(x), td["blocks_w8"]["attn_k_w"][1])),
        (jax.jit(J._linear_w8a8)(jnp.asarray(x),
                                 layer(je.model.params["encoder"]["blocks_w8"]["attn"]["q"])),
         W._linear(_t(x), te.model.module.encoder["attn_q_w"][1],
                   te.model.module.encoder["attn_q_b"][1])),
        (jax.jit(J._logits)(jnp.asarray(x), jd), W._logits(_t(x), td)),
    ]
    for want, got in cases:
        assert got.dtype == torch.float32 and got.shape == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_encode_enc_int8_matches_jax(models):
    """``encode`` with the ``enc_int8`` engine's parameters against JAX's
    jitted ``encode`` on its engine's: a token's activation codes flip where
    its f32 sums, in another order, land across a rounding edge, and each
    flip moves outputs by a fraction of a code step (measured: max 5.8e-4,
    0.75 % of outputs beyond 1e-5, 99.9th percentile 1.7e-4; the int8
    encoder itself is 2.7e-3 from the float one)."""
    jax_model, model = models
    je = JaxEngine(jax_model, make_tokenizer(), enc_int8=True)
    te = DecodeEngine(model, _tok(), enc_int8=True)
    mel = _f32(np.random.default_rng(5), 2, 80, 3000, scale=0.5)
    want = np.asarray(jax.jit(J.encode, static_argnums=2)(je.model.params, jnp.asarray(mel), je.dims))
    got = W.encode(te.model.module, _t(mel)).numpy()
    d = np.abs(got - want)
    assert d.max() < 2e-3 and np.quantile(d, 0.999) < 5e-4 and d.mean() < 1e-5
    plain = W.encode(model.module, _t(mel)).numpy()
    assert np.abs(plain - got).max() > 10 * d.mean()  # the lever did change the encoder


WEIGHT_LEVERS = {"w_int8": dict(w_int8=True), "enc_int8": dict(enc_int8=True),
                 "both_kv_int8": dict(w_int8=True, enc_int8=True, kv_int8=True)}


@pytest.mark.parametrize("lever", sorted(WEIGHT_LEVERS))
def test_decode_window_with_weight_lever_matches_jax(models, lever):
    """``decode_window`` under each weight lever (and the production mix
    with ``kv_int8``) against the JAX engine's: tokens identical; log-probs
    and alignment rows within ``SLICE_TOL``'s int8 tolerance (the encoder's
    code flips, the bf16-rounded q·k of JAX's int8 cross-attention)."""
    jax_model, model = models
    mel = np.random.default_rng(5).standard_normal((80, 3000)).astype(np.float32) * 0.5
    rj = JaxEngine(jax_model, make_tokenizer(), **WEIGHT_LEVERS[lever]).decode_window(
        mel, JaxOptions(language="en", sample_len=40))[0]
    rt = DecodeEngine(model, _tok(), **WEIGHT_LEVERS[lever]).decode_window(
        torch.from_numpy(mel), DecodingOptions(language="en", sample_len=40))[0]
    assert rt.tokens == rj.tokens and len(rt.tokens) > 2
    np.testing.assert_allclose(rt.token_logprobs, rj.token_logprobs, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(rt.attn, rj.attn, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("lever", sorted(LEVERS))
def test_kv_lever_env_defaults(models, monkeypatch, lever):
    """Each lever's environment variable sets its default; an argument wins."""
    _, model = models
    monkeypatch.setenv(f"WTT_{lever.upper()}", "1")
    assert getattr(DecodeEngine(model, _tok()), lever)
    assert not getattr(DecodeEngine(model, _tok(), **{lever: False}), lever)
