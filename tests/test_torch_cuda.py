"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (through the ``cuda`` fixture) where
PyTorch sees no CUDA device. On a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

The first test builds the kernels with nvcc into build/. Shapes are the
large-v3 main path's (D=1280, H=20, T=1500, ctx=456, M=1536).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from whisper_timestamped_tpu_torch.device_align import M_PAD  # noqa: E402
from whisper_timestamped_tpu_torch.ops import kernels as K  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _randn(gen, *shape, dtype=torch.bfloat16, device="cuda", scale=1.0):
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


# The quantized kernels' limits, as chip_smoke.py states them: the cross
# kernels' bf16 output against the plain version (which rounds the
# V-weighted weights to bf16) atol 4e-3; the self kernel against the plain
# version in f32, half a bf16 step (2^-8 of it) plus 1e-4.
XATTN_Q_ATOL = 4e-3
SELF_Q_RTOL, SELF_Q_ATOL = 2.0**-8, 1e-4


@pytest.mark.parametrize("B,beam_group,emit", [(1, 1, True), (1, 1, False), (4, 2, True)])
def test_xattn_kernel_matches_plain(cuda, B, beam_group, emit):
    g = torch.Generator(device=cuda).manual_seed(B + beam_group)
    L, T, D, H = 4, 1500, 1280, 20
    q = _randn(g, B, 1, D)
    xk, xv = _randn(g, L, B // beam_group, T, D), _randn(g, L, B // beam_group, T, D)
    before = K.LAUNCHES["xattn_decode"]
    o_k, s_k = K.xattn_decode(q, xk, xv, 3, H, emit_scores=emit, beam_group=beam_group)
    torch.cuda.synchronize()
    assert K.LAUNCHES["xattn_decode"] == before + 1
    o_p, s_p = K.xattn_decode_plain(q, xk, xv, 3, H, emit_scores=emit, beam_group=beam_group)
    torch.testing.assert_close(o_k.float(), o_p.float(), rtol=0, atol=2e-2)
    if emit:
        torch.testing.assert_close(s_k, s_p, rtol=0, atol=1e-3)
    else:
        assert s_k is None


@pytest.mark.parametrize("T", [1, 63, 64, 65, 129, 1500, K.MAX_T])
@pytest.mark.parametrize("B", [1, 8, 40])
def test_xattn_split_kernel_matches_plain(cuda, B, T):
    """The split-T kernel at the batches of the serial path, [f] and [g]:
    a T below one 64-frame tile, a one-frame tail tile, and the longest T,
    with scores, and without them at beam_group 2 where B allows."""
    g = torch.Generator(device=cuda).manual_seed(B * 10007 + T)
    L, D, H = 2, 1280, 20
    for beam_group, emit in ((1, True), (2 if B % 2 == 0 else 1, False)):
        q = _randn(g, B, 1, D)
        xk, xv = _randn(g, L, B // beam_group, T, D), _randn(g, L, B // beam_group, T, D)
        o_k, s_k = K.xattn_decode(q, xk, xv, 1, H, emit_scores=emit, beam_group=beam_group)
        torch.cuda.synchronize()
        o_p, s_p = K.xattn_decode_plain(q, xk, xv, 1, H, emit_scores=emit, beam_group=beam_group)
        torch.testing.assert_close(o_k.float(), o_p.float(), rtol=0, atol=2e-2)
        if emit:
            torch.testing.assert_close(s_k, s_p, rtol=0, atol=1e-3)
        else:
            assert s_k is None
        del xk, xv


def test_xattn_split_counters_reset_between_calls(cuda):
    """Back-to-back calls on one stream, each merging its splits in the
    launch (within a block cluster), give the same output, also after a
    call of another shape in between: no merge state outlives a launch."""
    g = torch.Generator(device=cuda).manual_seed(11)
    L, T, D, H = 2, 1500, 1280, 20
    assert K.xattn_split(1, H, T, K._sm_count(cuda))[0] > 1
    q, xk, xv = _randn(g, 1, 1, D), _randn(g, L, 1, T, D), _randn(g, L, 1, T, D)
    q8, xk8, xv8 = _randn(g, 8, 1, D), _randn(g, L, 8, T, D), _randn(g, L, 8, T, D)
    first, _ = K.xattn_decode(q, xk, xv, 0, H)
    again = [K.xattn_decode(q, xk, xv, 0, H)[0] for _ in range(3)]
    K.xattn_decode(q8, xk8, xv8, 1, H, emit_scores=True)
    again.append(K.xattn_decode(q, xk, xv, 0, H)[0])
    torch.cuda.synchronize()
    for o in again:
        assert torch.equal(o, first)


@pytest.mark.parametrize("pos", [232, 455])
def test_self_attn_kernel_matches_plain(cuda, pos):
    g = torch.Generator(device=cuda).manual_seed(pos)
    L, B, ctx, D, H = 2, 4, 456, 1280, 20
    q = _randn(g, B, 1, D)
    k_all, v_all = _randn(g, L, B, ctx, D), _randn(g, L, B, ctx, D)
    pad = torch.tensor([0, 5, 224, 300], dtype=torch.int32, device=cuda)
    o_k = K.self_attn_decode(q, k_all, v_all, 1, pos, pad, H)
    torch.cuda.synchronize()
    o_p = K.self_attn_decode_plain(q, k_all, v_all, 1, pos, pad, H)
    torch.testing.assert_close(o_k.float(), o_p.float(), rtol=0, atol=2e-2)


SELF_PADS = (0, 5, 224, 300)  # 224: the splits below slot 224 are empty; 300: pad_len > pos


def _self_pads(B, cuda):
    return torch.tensor([SELF_PADS[b % 4] for b in range(B)], dtype=torch.int32, device=cuda)


@pytest.mark.parametrize("pos", [0, 63, 64, 65, 232, 455])
@pytest.mark.parametrize("B", [1, 8, 40])
def test_self_attn_split_kernel_matches_plain(cuda, B, pos):
    """The split self-attention at the batches of the serial path, [f] and
    [g], and the slots around a 64-slot tile's edges, each row's pad_len
    one of SELF_PADS (at B=1 each in turn), atol 2e-2; no NaN."""
    g = torch.Generator(device=cuda).manual_seed(B * 1009 + pos)
    L, ctx, D, H = 2, 456, 1280, 20
    q = _randn(g, B, 1, D)
    k_all, v_all = _randn(g, L, B, ctx, D), _randn(g, L, B, ctx, D)
    pads = [_self_pads(B, cuda)] if B > 1 else [
        torch.tensor([p], dtype=torch.int32, device=cuda) for p in SELF_PADS]
    for pad in pads:
        before = K.LAUNCHES["self_attn_decode"]
        o_k = K.self_attn_decode(q, k_all, v_all, 1, pos, pad, H)
        torch.cuda.synchronize()
        assert K.LAUNCHES["self_attn_decode"] == before + 1
        assert torch.isfinite(o_k.float()).all()
        o_p = K.self_attn_decode_plain(q, k_all, v_all, 1, pos, pad, H)
        torch.testing.assert_close(o_k.float(), o_p.float(), rtol=0, atol=2e-2)


@pytest.mark.parametrize("pos", [0, 64, 232, 455])
@pytest.mark.parametrize("B", [1, 8, 40])
def test_self_attn_fused_write_bit_for_bit(cuda, B, pos):
    """With k_new/v_new the launch writes slot pos of the layer: the whole
    cache afterwards equals the plain indexing write bit for bit (so every
    other slot is untouched), and the output equals the kernel's on the
    cache written beforehand, bit for bit, and the plain version's within
    atol 2e-2."""
    g = torch.Generator(device=cuda).manual_seed(B * 7 + pos)
    L, ctx, D, H = 3, 456, 1280, 20
    q, k_new, v_new = _randn(g, B, 1, D), _randn(g, B, 1, D), _randn(g, B, 1, D)
    k_all, v_all = _randn(g, L, B, ctx, D), _randn(g, L, B, ctx, D)
    pad = _self_pads(B, cuda)
    k_f, v_f = k_all.clone(), v_all.clone()
    o_f = K.self_attn_decode(q, k_f, v_f, 1, pos, pad, H, k_new=k_new, v_new=v_new)
    torch.cuda.synchronize()
    k_p, v_p = k_all.clone(), v_all.clone()
    k_p[1, :, pos] = k_new[:, 0]
    v_p[1, :, pos] = v_new[:, 0]
    assert torch.equal(k_f, k_p) and torch.equal(v_f, v_p)
    assert torch.equal(o_f, K.self_attn_decode(q, k_p, v_p, 1, pos, pad, H))
    o_p = K.self_attn_decode_plain(q, k_p, v_p, 1, pos, pad, H)
    torch.testing.assert_close(o_f.float(), o_p.float(), rtol=0, atol=2e-2)


def test_split_merge_on_two_streams(cuda):
    """The five pipeline kernels, each split, on the default stream and on
    a second one at once: each launch merges its own splits, so the outputs
    equal across the streams and across repeated calls (the int8 self
    cache's write goes to a cache of its own each call)."""
    from whisper_timestamped_tpu_torch.ops.quant import quantize_rows, quantize_rows_int4

    g = torch.Generator(device=cuda).manual_seed(12)
    L, T, ctx, D, H = 2, 1500, 456, 1280, 20
    q, k_new, v_new = _randn(g, 1, 1, D), _randn(g, 1, 1, D), _randn(g, 1, 1, D)
    xk, xv = _randn(g, L, 1, T, D), _randn(g, L, 1, T, D)
    k8, ks = quantize_rows(xk.float())
    v8, vs = quantize_rows(xv.float())
    k4, ks4 = quantize_rows_int4(xk.float())
    v4, vs4 = quantize_rows_int4(xv.float())
    k_all, v_all = _randn(g, L, 1, ctx, D), _randn(g, L, 1, ctx, D)
    cache8 = (*quantize_rows(k_all.float()), *quantize_rows(v_all.float()))
    pad = torch.zeros((1,), dtype=torch.int32, device=cuda)
    assert K.xattn_split(1, H, 233, K._sm_count(cuda))[0] > 1

    def calls():
        return (K.xattn_decode(q, xk, xv, 1, H, emit_scores=True)[0],
                K.xattn_decode_int8(q, k8, ks, v8, vs, 1, H)[0],
                *K.xattn_decode_int4(q, k4, ks4, v4, vs4, 1, H, emit_scores=True),
                K.self_attn_decode(q, k_all, v_all, 1, 232, pad, H),
                K.self_attn_decode_int8(q, k_new, v_new, *[t.clone() for t in cache8], 1, 232,
                                        pad, H))

    first = calls()
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        on_side = [calls() for _ in range(2)]
    again = calls()
    torch.cuda.synchronize()
    for outs in (*on_side, again):
        for a, b in zip(outs, first):
            assert torch.equal(a, b)


@pytest.mark.parametrize("T", [1, 63, 64, 65, 1500])
@pytest.mark.parametrize("B", [1, 8, 40])
def test_xattn_int8_split_kernel_matches_plain(cuda, B, T):
    """The split-T int8 kernel at the batches of the serial path, [f] and
    [g] and at T around a tile's edges, with scores, and without them at
    beam_group 2 where B allows: output atol 4e-3, scores atol 1e-3 (as
    ``test_quantized_xattn_kernels_match_plain``). That output limit is four
    bf16 steps at outputs of ~0.2, the size a softmax over 1500 frames of
    N(0, 1) values gives; over a few frames an output is a V row itself, so
    V is drawn at 1/16 of N(0, 1) to keep the outputs that small."""
    from whisper_timestamped_tpu_torch.ops.quant import quantize_rows

    g = torch.Generator(device=cuda).manual_seed(B * 10009 + T)
    L, D, H = 2, 1280, 20
    for beam_group, emit in ((1, True), (2 if B % 2 == 0 else 1, False)):
        q = _randn(g, B, 1, D)
        xk, xks = quantize_rows(_randn(g, L, B // beam_group, T, D, dtype=torch.float32))
        xv, xvs = quantize_rows(_randn(g, L, B // beam_group, T, D, dtype=torch.float32,
                                       scale=1 / 16))
        o_k, s_k = K.xattn_decode_int8(q, xk, xks, xv, xvs, 1, H, emit_scores=emit,
                                       beam_group=beam_group)
        torch.cuda.synchronize()
        o_p, s_p = K.xattn_decode_int8_plain(q, xk, xks, xv, xvs, 1, H, emit_scores=emit,
                                             beam_group=beam_group)
        torch.testing.assert_close(o_k.float(), o_p.float(), rtol=0, atol=4e-3)
        if emit:
            torch.testing.assert_close(s_k, s_p, rtol=0, atol=1e-3)
        else:
            assert s_k is None
        del xk, xv


@pytest.mark.parametrize("warps", [2, 4])
def test_pipeline_kernels_match_plain_at_each_block_size(cuda, monkeypatch, warps):
    """The five pipeline kernels built for 2 and 4 warps a block (the
    wrappers' choice forced), split and unsplit, against their plain
    versions at the tolerances above; the row writes bit for bit."""
    from whisper_timestamped_tpu_torch.ops.quant import quantize_rows, quantize_rows_int4

    monkeypatch.setattr(K, "PIPELINE_WARPS", warps)
    g = torch.Generator(device=cuda).manual_seed(warps)
    L, T, ctx, D, H = 2, 1500, 456, 1280, 20
    for B, per_sm in ((1, 12), (8, 0), (40, 12)):
        monkeypatch.setattr(K, "XATTN_WARPS_PER_SM", per_sm)
        q, k_new, v_new = _randn(g, B, 1, D), _randn(g, B, 1, D), _randn(g, B, 1, D)
        xk, xv = _randn(g, L, B, T, D), _randn(g, L, B, T, D)
        o_k, s_k = K.xattn_decode(q, xk, xv, 1, H, emit_scores=True)
        o_p, s_p = K.xattn_decode_plain(q, xk, xv, 1, H, emit_scores=True)
        torch.testing.assert_close(o_k.float(), o_p.float(), rtol=0, atol=2e-2)
        torch.testing.assert_close(s_k, s_p, rtol=0, atol=1e-3)
        k8, ks = quantize_rows(xk.float())
        v8, vs = quantize_rows(xv.float())
        k4, ks4 = quantize_rows_int4(xk.float())
        v4, vs4 = quantize_rows_int4(xv.float())
        del xk, xv
        o_k, s_k = K.xattn_decode_int8(q, k8, ks, v8, vs, 1, H, emit_scores=True)
        o_p, s_p = K.xattn_decode_int8_plain(q, k8, ks, v8, vs, 1, H, emit_scores=True)
        torch.testing.assert_close(o_k.float(), o_p.float(), rtol=0, atol=4e-3)
        torch.testing.assert_close(s_k, s_p, rtol=0, atol=1e-3)
        del k8, v8
        o_k, s_k = K.xattn_decode_int4(q, k4, ks4, v4, vs4, 1, H, emit_scores=True)
        o_p, s_p = K.xattn_decode_int4_plain(q, k4, ks4, v4, vs4, 1, H, emit_scores=True)
        torch.testing.assert_close(o_k.float(), o_p.float(), rtol=0, atol=XATTN_Q_ATOL)
        torch.testing.assert_close(s_k, s_p, rtol=0, atol=1e-3)
        del k4, v4
        k_all, v_all = _randn(g, L, B, ctx, D), _randn(g, L, B, ctx, D)
        pad = _self_pads(B, cuda)
        k_p, v_p = k_all.clone(), v_all.clone()
        k_p[1, :, 455] = k_new[:, 0]
        v_p[1, :, 455] = v_new[:, 0]
        o_k = K.self_attn_decode(q, k_all, v_all, 1, 455, pad, H, k_new=k_new, v_new=v_new)
        torch.cuda.synchronize()
        assert torch.equal(k_all, k_p) and torch.equal(v_all, v_p)
        o_p = K.self_attn_decode_plain(q, k_p, v_p, 1, 455, pad, H)
        torch.testing.assert_close(o_k.float(), o_p.float(), rtol=0, atol=2e-2)
        cache = (*quantize_rows(k_all.float()), *quantize_rows(v_all.float()))
        del k_all, v_all, k_p, v_p
        _check_self_int8(q, k_new, v_new, cache, 1, 455, pad, H)


@pytest.mark.parametrize("N", [64, 256])
def test_align_cost_and_dtw_kernels_match_plain(cuda, N):
    gen = torch.Generator().manual_seed(N)
    S, Kh, M = 8, 10, M_PAD
    n_tok = torch.randint(2, N + 1, (S,), generator=gen)
    span = torch.clamp(n_tok + torch.randint(0, 1400, (S,), generator=gen), max=1500)
    maxdur = torch.where(torch.arange(S) % 2 == 0, M, span // 2)
    dims = torch.stack([n_tok, span, maxdur, torch.zeros(S, dtype=torch.long)], 1)
    dims = dims.to(torch.int32).to(cuda)
    scores = _randn(torch.Generator(device=cuda).manual_seed(N), S, Kh, N, M,
                    dtype=torch.float32, scale=3.0)
    c_k = K.align_cost(scores, dims)
    torch.cuda.synchronize()
    c_p = K.align_cost_plain(scores, dims)
    torch.testing.assert_close(c_k, c_p, rtol=1e-5, atol=1e-6)
    d_k = K.dtw_codes(c_p, dims)
    torch.cuda.synchronize()
    d_p = K.dtw_codes_plain(c_p, dims)
    for s in range(S):
        nd = int(dims[s, 0] + dims[s, 1] - 1)
        assert torch.equal(d_k[s, :nd], d_p[s, :nd])
    steps = int((dims[:, 0] + dims[:, 1] - 1).max())
    assert torch.equal(K.backtrace_batch(d_k, dims[:, 0], dims[:, 1], steps),
                       K.backtrace_batch(d_p, dims[:, 0], dims[:, 1], steps))


def _segments(gen, S, N, M, kind, device):
    """(cost (S, N, M) f32, dims (S, 4) int32): segment 0 full, the others
    random extents; "ties" small integer costs, "dummies" the aligner's
    2 x 2 padding segments, "thin" one-row and one-column segments."""
    n = torch.randint(1, N + 1, (S,), generator=gen)
    m = torch.randint(1, M + 1, (S,), generator=gen)
    n[0], m[0] = N, M
    if kind == "ties":
        cost = -torch.randint(0, 3, (S, N, M), generator=gen).float()
    else:
        cost = -torch.rand((S, N, M), generator=gen)
    if kind == "dummies":
        n[1:], m[1:] = 2, 2
    elif kind == "thin":
        n[1], m[2], n[3], m[3] = 1, 1, 1, 1
    dims = torch.stack([n, m, torch.full((S,), M), torch.zeros(S, dtype=torch.long)], 1)
    return cost.to(device), dims.to(torch.int32).to(device)


@pytest.mark.parametrize("kind", ["random", "ties", "dummies", "thin"])
@pytest.mark.parametrize("N,M", [(64, 1536), (128, 1536), (256, 1536), (384, 1536), (512, 1536),
                                 (1024, 700), (1024, 1536), (96, 1499)])
def test_dtw_starts_kernel_matches_plain(cuda, kind, N, M):
    """The DP and its walk in one launch: start frames equal to the plain
    version's bit for bit (blocks of 1, 2, 4, 6 and 8 warps, by the warp
    rule; at N=1024, M=1536 the walk's codes do not fit in shared memory and
    stay in device memory; M=1499 is padded to a multiple of 4), and the
    codes of the same kernel equal to ``dtw_codes_plain`` where the segment
    writes them."""
    cost, dims = _segments(torch.Generator().manual_seed(N + M), 4, N, M, kind, cuda)
    before = K.LAUNCHES["dtw_codes"]
    st_k = K.dtw_starts(cost, dims)
    torch.cuda.synchronize()
    assert K.LAUNCHES["dtw_codes"] == before + 1
    assert torch.equal(st_k, K.dtw_starts_plain(cost, dims))
    d_k = K.dtw_codes(cost, dims)
    torch.cuda.synchronize()
    d_p = K.dtw_codes_plain(cost, dims)
    for s in range(4):
        nd = int(dims[s, 0] + dims[s, 1] - 1)
        assert torch.equal(d_k[s, :nd], d_p[s, :nd])


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("n,m", [(1, 9), (9, 1), (17, 1500), (200, 1500), (226, 1499), (700, 900)])
def test_dtw_path_kernel_matches_plain(cuda, kind, n, m):
    """The path walked on the card equal to the host walk of the plain
    codes, n not a multiple of 32, the codes never copied."""
    cost, _ = _segments(torch.Generator().manual_seed(n * m), 1, n, m, kind, cuda)
    path_k = K.dtw_path(cost[0].contiguous())
    path_p = K.dtw_path_plain(cost[0])
    for a, b in zip(path_k, path_p):
        assert a.dtype == np.int64 and np.array_equal(a, b)


@pytest.mark.parametrize("N", [64, 256])
def test_align_cost_gather_matches_plain_and_repeats(cuda, N):
    """The gather form reads each segment's window of a (R, K, T) buffer
    (repeated rows, windows that reach past T): at rtol 1e-5 / atol 1e-6 of
    the plain version, and the same bits from run to run (no float
    atomics); the pre-sliced form of the same window at the same tolerance
    (its lanes' tiles start at frame 0, the gather form's at -(start & 3):
    the softmax sums add in another order)."""
    gen = torch.Generator().manual_seed(N)
    S, Kh, T = 8, 10, 1500
    R = 40 * 224
    attn = _randn(torch.Generator(device=cuda).manual_seed(N), R, Kh, T, dtype=torch.float32,
                  scale=3.0)
    n_tok = torch.randint(2, N + 1, (S,), generator=gen)
    span = torch.clamp(n_tok + torch.randint(0, 1400, (S,), generator=gen), max=1500)
    start = torch.randint(0, 1500, (S,), generator=gen)
    start[0], span[0] = T - int(span[0]), int(span[0])
    span[1] = 3
    maxdur = torch.where(torch.arange(S) % 2 == 0, M_PAD, span // 2)
    dims = torch.stack([n_tok, span, maxdur, start], 1).to(torch.int32).to(cuda)
    rows = torch.randint(0, R, (S, N), generator=gen)
    rows[2] = rows[2, 0]
    rows = rows.to(torch.int32).to(cuda)
    before = K.LAUNCHES["align_cost"]
    c_k = K.align_cost_gather(attn, rows, dims, M_PAD)
    again = K.align_cost_gather(attn, rows, dims, M_PAD)
    torch.cuda.synchronize()
    assert K.LAUNCHES["align_cost"] == before + 2
    assert torch.equal(c_k, again)
    c_p = K.align_cost_gather_plain(attn, rows, dims, M_PAD)
    torch.testing.assert_close(c_k, c_p, rtol=1e-5, atol=1e-6)
    window = K.gather_window(attn, rows, dims, M_PAD)
    torch.testing.assert_close(K.align_cost(window, dims), c_k, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("M,offset", [(1499, 0), (1536, 1), (1497, 3)])
def test_align_cost_pads_what_it_cannot_read_in_16_bytes(cuda, M, offset):
    """Frames not a multiple of 4, or scores not 16-byte aligned (a view at
    ``offset`` floats into its storage): the three wrappers pad a copy and
    launch the one 16-byte staging path once; at rtol 1e-5 / atol 1e-6 of
    the plain versions, the cost M frames wide, a span past M cut to M."""
    gen = torch.Generator(device=cuda).manual_seed(M + offset)
    S, Kh, N, T = 3, 4, 40, M

    def view(*shape):
        flat = _randn(gen, offset + math.prod(shape), dtype=torch.float32, scale=3.0)
        return flat[offset:].view(shape)

    scores = view(S, Kh, N, M)
    dims = torch.tensor([[N, M + 7, 1536, 0], [17, M - 300, 600, 0], [2, 3, 1536, 0]],
                        dtype=torch.int32, device=cuda)
    before = K.LAUNCHES["align_cost"]
    c_k = K.align_cost(scores, dims)
    torch.cuda.synchronize()
    assert K.LAUNCHES["align_cost"] == before + 1 and c_k.shape == (S, N, M)
    torch.testing.assert_close(c_k, K.align_cost_plain(scores, dims), rtol=1e-5, atol=1e-6)
    one = scores[0].contiguous() if offset == 0 else view(Kh, N, M)
    c_k = K.attention_to_cost(one, M - 5, n_tokens=N - 3)
    torch.cuda.synchronize()
    assert c_k.shape == (N, M)
    torch.testing.assert_close(c_k, K.attention_to_cost_plain(one, M - 5, N - 3), rtol=1e-5, atol=1e-6)
    attn = view(2 * N, Kh, T)
    rows = torch.arange(S * N, device=cuda, dtype=torch.int32).reshape(S, N) % (2 * N)
    dims[:, 3] = torch.tensor([0, T - 40, T + 2], dtype=torch.int32)
    c_k = K.align_cost_gather(attn, rows, dims, 1536)
    torch.cuda.synchronize()
    torch.testing.assert_close(c_k, K.align_cost_gather_plain(attn, rows, dims, 1536),
                               rtol=1e-5, atol=1e-6)


def test_alignment_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    dims = torch.tensor([[4, 8, 8, 0]], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        K.align_cost(torch.zeros((1, 2, 8, 1600), device=cuda), dims)
    with pytest.raises(ValueError, match="f32"):
        K.align_cost(torch.zeros((1, 2, 8, 64), device=cuda, dtype=torch.float16), dims)
    with pytest.raises(ValueError, match="int32"):
        K.align_cost_gather(torch.zeros((4, 2, 64), device=cuda), torch.zeros((1, 8), device=cuda,
                                                                             dtype=torch.int64), dims, 64)
    with pytest.raises(ValueError, match="contiguous"):
        K.align_cost_gather(torch.zeros((4, 64, 2), device=cuda).transpose(1, 2),
                            torch.zeros((1, 8), device=cuda, dtype=torch.int32), dims, 64)
    with pytest.raises(ValueError, match="unsupported"):
        K.attention_to_cost(torch.zeros((2, 8, 2048), device=cuda), 1500)
    with pytest.raises(ValueError, match="unsupported"):
        K.dtw_starts(torch.zeros((1, 1056, 8), device=cuda), dims)
    with pytest.raises(ValueError, match="unsupported"):
        K.dtw_path(torch.zeros((1100, 8), device=cuda))
    with pytest.raises(ValueError, match="dims"):
        K.dtw_codes(torch.zeros((1, 8, 8), device=cuda), dims.long())


@pytest.mark.parametrize("Kh", [3, 120])
@pytest.mark.parametrize("n", [17, 33])
def test_per_segment_kernels_match_plain(cuda, n, Kh):
    """The per-segment route's three wrappers at large-v3's frame width:
    ``attention_to_cost`` (tokens padded to 16 and frames to 128, as the
    aligner pads them) at rtol 1e-5 / atol 1e-6, f32 sums in another order;
    ``median9`` on the same scores equal (a selection); ``dtw_path`` on the
    plain cost, kernel against plain version, equal paths."""
    span = 1500 - 7 * n
    N, M = -(-n // 16) * 16, -(-span // 128) * 128
    g = torch.Generator(device=cuda).manual_seed(n * Kh)
    scores = torch.zeros((Kh, N, M), dtype=torch.float32, device=cuda)
    scores[:, :n, :span] = _randn(g, Kh, n, span, dtype=torch.float32, scale=3.0)
    before = dict(K.LAUNCHES)
    c_k = K.attention_to_cost(scores, span, n_tokens=n)
    m_k = K.median9(scores)
    torch.cuda.synchronize()
    assert K.LAUNCHES["attention_to_cost"] == before["attention_to_cost"] + 1
    assert K.LAUNCHES["median9"] == before["median9"] + 1
    c_p = K.attention_to_cost_plain(scores, span, n)
    torch.testing.assert_close(c_k, c_p, rtol=1e-5, atol=1e-6)
    assert torch.equal(m_k, K.median9_plain(scores))
    weights = c_p[:n, :span].contiguous()
    before = K.LAUNCHES["dtw_codes"]
    path_k = K.dtw_path(weights)
    assert K.LAUNCHES["dtw_codes"] == before + 1
    path_p = K.dtw_path(weights.cpu())
    for a, b in zip(path_k, path_p):
        assert (a == b).all()


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 1, 96), dtype=torch.bfloat16, device=cuda)  # dh = 48
    kv = torch.zeros((1, 1, 8, 96), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head width"):
        K.xattn_decode(q, kv, kv, 0, 2)
    with pytest.raises(ValueError, match="bf16"):
        K.xattn_decode(q.float()[..., :64], kv.float()[..., :64].contiguous(),
                       kv.float()[..., :64].contiguous(), 0, 1)


def _quantized_kv(gen, L, B_kv, T, D, int4):
    from whisper_timestamped_tpu_torch.ops.quant import quantize_rows, quantize_rows_int4

    fn = quantize_rows_int4 if int4 else quantize_rows
    return fn(_randn(gen, L, B_kv, T, D, dtype=torch.float32))


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("B,beam_group,emit", [(1, 1, True), (1, 1, False), (4, 2, True),
                                               (4, 1, False)])
def test_quantized_xattn_kernels_match_plain(cuda, int4, B, beam_group, emit):
    """xattn_decode_int8 / _int4 at large-v3 width, layers 0 and 31; bf16
    output atol 4e-3 (four bf16 steps at the outputs' largest magnitude,
    ~0.2: the plain version rounds the V-weighted weights to bf16, the
    kernel does not), scores atol 1e-3 (f32 sums in another order)."""
    g = torch.Generator(device=cuda).manual_seed(10 * B + beam_group + int4)
    L, T, D, H = 32, 1500, 1280, 20
    q = _randn(g, B, 1, D)
    xk, xks = _quantized_kv(g, L, B // beam_group, T, D, int4)
    xv, xvs = _quantized_kv(g, L, B // beam_group, T, D, int4)
    name = "xattn_decode_int4" if int4 else "xattn_decode_int8"
    kernel, plain = getattr(K, name), getattr(K, name + "_plain")
    for layer in (0, 31):
        before = K.LAUNCHES[name]
        o_k, s_k = kernel(q, xk, xks, xv, xvs, layer, H, emit_scores=emit, beam_group=beam_group)
        torch.cuda.synchronize()
        assert K.LAUNCHES[name] == before + 1
        o_p, s_p = plain(q, xk, xks, xv, xvs, layer, H, emit_scores=emit, beam_group=beam_group)
        torch.testing.assert_close(o_k.float(), o_p.float(), rtol=0, atol=4e-3)
        if emit:
            assert s_k.shape == (B, H, 1, T)
            torch.testing.assert_close(s_k, s_p, rtol=0, atol=1e-3)
        else:
            assert s_k is None


@pytest.mark.parametrize("pos", [232, 455])
def test_self_attn_int8_kernel_matches_plain(cuda, pos):
    """The fused write and attention against the plain quantizer and the
    plain version in f32 (the cache dequantized to f32): the caches equal
    bit for bit afterwards; the kernel sums in f32 and rounds its output to
    bf16 once, so the output is held to half a bf16 step (2^-8 of the
    reference) plus 1e-4 for f32 sums in another order. Row 3's padding
    (300) reaches past pos 232."""
    from whisper_timestamped_tpu_torch.ops.quant import quantize_rows

    g = torch.Generator(device=cuda).manual_seed(pos + 1)
    L, B, ctx, D, H = 32, 4, 456, 1280, 20
    q, k_new, v_new = _randn(g, B, 1, D), _randn(g, B, 1, D), _randn(g, B, 1, D)
    k8, ks = quantize_rows(_randn(g, L, B, ctx, D, dtype=torch.float32))
    v8, vs = quantize_rows(_randn(g, L, B, ctx, D, dtype=torch.float32))
    pad = torch.tensor([0, 5, 224, 300], dtype=torch.int32, device=cuda)
    for layer in (0, 31):
        ck = [t.clone() for t in (k8, ks, v8, vs)]
        o_k = K.self_attn_decode_int8(q, k_new, v_new, *ck, layer, pos, pad, H)
        torch.cuda.synchronize()
        cp = [t.clone() for t in (k8, ks, v8, vs)]
        K.write_quantized_row(k_new, v_new, *cp, layer, pos)
        o_p = K.self_attn_decode_int8_plain(q.float(), *cp, layer, pos, pad, H)
        for a, b in zip(ck, cp):
            assert torch.equal(a, b)
        torch.testing.assert_close(o_k.float(), o_p, rtol=2.0**-8, atol=1e-4)


INT4_T = (2, 62, 64, 66, 128, 130, 1500)  # frames: one packed row, a 64-row piece's edges


@pytest.mark.parametrize("warps", [2, 4])
@pytest.mark.parametrize("T", INT4_T)
@pytest.mark.parametrize("B", [1, 8, 40])
def test_xattn_int4_split_kernel_matches_plain(cuda, monkeypatch, B, T, warps):
    """The int4 kernel split over the T/2 packed rows, at the batches of the
    serial path, [h] and [g], at T around a 64-packed-row piece's edges and
    at both block sizes (forced): with scores (their shape (B, H, 1, T),
    frame order, as the plain version unpacks them) and without them at
    beam_group 2 where B allows; output atol XATTN_Q_ATOL, scores atol
    1e-3. V is drawn at 1/16 of N(0, 1), as in the int8 test above."""
    from whisper_timestamped_tpu_torch.ops.quant import quantize_rows_int4

    monkeypatch.setattr(K, "PIPELINE_WARPS", warps)
    g = torch.Generator(device=cuda).manual_seed(B * 10009 + T * 3 + warps)
    L, D, H = 2, 1280, 20
    for beam_group, emit in ((1, True), (2 if B % 2 == 0 else 1, False)):
        q = _randn(g, B, 1, D)
        xk, xks = quantize_rows_int4(_randn(g, L, B // beam_group, T, D, dtype=torch.float32))
        xv, xvs = quantize_rows_int4(_randn(g, L, B // beam_group, T, D, dtype=torch.float32,
                                            scale=1 / 16))
        before = K.LAUNCHES["xattn_decode_int4"]
        o_k, s_k = K.xattn_decode_int4(q, xk, xks, xv, xvs, 1, H, emit_scores=emit,
                                       beam_group=beam_group)
        torch.cuda.synchronize()
        assert K.LAUNCHES["xattn_decode_int4"] == before + 1
        o_p, s_p = K.xattn_decode_int4_plain(q, xk, xks, xv, xvs, 1, H, emit_scores=emit,
                                             beam_group=beam_group)
        torch.testing.assert_close(o_k.float(), o_p.float(), rtol=0, atol=XATTN_Q_ATOL)
        if emit:
            assert s_k.shape == (B, H, 1, T)
            torch.testing.assert_close(s_k, s_p, rtol=0, atol=1e-3)
        else:
            assert s_k is None


def _check_self_int8(q, k_new, v_new, cache, layer, pos, pad, H):
    """One launch of the int8 self kernel on a copy of ``cache``: the whole
    cache and its scales afterwards equal the plain quantizer's write bit
    for bit, and the output the plain version's in f32 within SELF_Q_RTOL /
    SELF_Q_ATOL; no NaN."""
    ck = [t.clone() for t in cache]
    before = K.LAUNCHES["self_attn_decode_int8"]
    o_k = K.self_attn_decode_int8(q, k_new, v_new, *ck, layer, pos, pad, H)
    torch.cuda.synchronize()
    assert K.LAUNCHES["self_attn_decode_int8"] == before + 1
    cp = [t.clone() for t in cache]
    K.write_quantized_row(k_new, v_new, *cp, layer, pos)
    for a, b in zip(ck, cp):
        assert torch.equal(a, b)
    assert torch.isfinite(o_k.float()).all()
    o_p = K.self_attn_decode_int8_plain(q.float(), *cp, layer, pos, pad, H)
    torch.testing.assert_close(o_k.float(), o_p, rtol=SELF_Q_RTOL, atol=SELF_Q_ATOL)


@pytest.mark.parametrize("pos", [0, 63, 64, 65, 232, 455])
@pytest.mark.parametrize("B", [1, 8, 40])
def test_self_attn_int8_split_kernel_matches_plain(cuda, B, pos):
    """The int8 self kernel split over the pos + 1 slots with its quantized
    row write, at the batches of the serial path, [h] and [g] and the
    slots around a 64-slot split's edges, each row's pad_len one of
    SELF_PADS (at B=1 each in turn: 224 empties the splits below it, 300
    lies past pos)."""
    from whisper_timestamped_tpu_torch.ops.quant import quantize_rows

    g = torch.Generator(device=cuda).manual_seed(B * 4099 + pos)
    L, ctx, D, H = 2, 456, 1280, 20
    q, k_new, v_new = _randn(g, B, 1, D), _randn(g, B, 1, D), _randn(g, B, 1, D)
    cache = (*quantize_rows(_randn(g, L, B, ctx, D, dtype=torch.float32)),
             *quantize_rows(_randn(g, L, B, ctx, D, dtype=torch.float32)))
    pads = [_self_pads(B, cuda)] if B > 1 else [
        torch.tensor([p], dtype=torch.int32, device=cuda) for p in SELF_PADS]
    for pad in pads:
        _check_self_int8(q, k_new, v_new, cache, 1, pos, pad, H)


def test_quantized_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 1, 128), dtype=torch.bfloat16, device=cuda)
    k8 = torch.zeros((1, 1, 8, 128), dtype=torch.int8, device=cuda)
    s = torch.ones((1, 1, 8), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="K/V must be int8"):
        K.xattn_decode_int8(q, k8.bfloat16(), s, k8.bfloat16(), s, 0, 2)
    with pytest.raises(ValueError, match="q must be bf16"):
        K.xattn_decode_int8(q.float(), k8, s, k8, s, 0, 2)
    with pytest.raises(ValueError, match="scales must be f32"):
        K.xattn_decode_int8(q, k8, s.bfloat16(), k8, s.bfloat16(), 0, 2)
    odd = torch.ones((1, 1, 17), dtype=torch.float32, device=cuda)  # 17 frames, 8 packed rows
    with pytest.raises(ValueError, match="even frame count"):
        K.xattn_decode_int4(q, k8, odd, k8, odd, 0, 2)
    strided = torch.zeros((1, 1, 128, 8), dtype=torch.int8, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        K.xattn_decode_int8(q, strided, s, strided, s, 0, 2)
    pad = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="K/V cache must be int8"):
        K.self_attn_decode_int8(q, q, q, k8.bfloat16(), s, k8.bfloat16(), s, 0, 3, pad, 2)
    with pytest.raises(ValueError, match="contiguous"):
        K.self_attn_decode_int8(q, q, q, strided, s, strided, s, 0, 3, pad, 2)


# flash_attention at the large-v3 shapes of the encoder (T=1500) and the
# 232-slot prompt prefill; bf16 output against the f32 plain version
FLASH_CASES = {
    "encoder_b1": dict(B=1, Sq=1500, Sk=1500, causal=False),
    "encoder_b8": dict(B=8, Sq=1500, Sk=1500, causal=False),
    "prefill_self": dict(B=11, Sq=232, Sk=232, causal=True),  # B = len(PAD_LENS)
    "prefill_cross": dict(B=8, Sq=232, Sk=1500, causal=False),
}
PAD_LENS = [0, 5, 63, 64, 100, 127, 128, 129, 224, 231, 232]  # 128: the key tile


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_kernel_matches_plain(cuda, case):
    c = FLASH_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(len(case))
    D, H = 1280, 20
    q = _randn(g, c["B"], c["Sq"], D)
    k, v = _randn(g, c["B"], c["Sk"], D), _randn(g, c["B"], c["Sk"], D)
    pad = (torch.tensor(PAD_LENS, dtype=torch.int32, device=cuda) if c["causal"] else None)
    before = K.LAUNCHES["flash_attention"]
    o_k = K.flash_attention(q, k, v, H, causal=c["causal"], pad_len=pad)
    torch.cuda.synchronize()
    assert K.LAUNCHES["flash_attention"] == before + 1
    o_p = K.flash_attention_plain(q, k, v, H, causal=c["causal"], pad_len=pad)
    assert torch.isfinite(o_k.float()).all()
    torch.testing.assert_close(o_k.float(), o_p.float(), rtol=0, atol=2e-2)


@pytest.mark.parametrize("Sk", [1, 65, 200])
@pytest.mark.parametrize("Sq", [1, 65, 200])
def test_flash_attention_small_shapes_match_plain(cuda, Sq, Sk):
    """Sequences shorter than one 128-row tile, or one tile and a ragged
    one: out-of-bounds rows arrive zero-filled and are masked; with Sq == Sk
    also causal, left pads around the tile edge."""
    g = torch.Generator(device=cuda).manual_seed(Sq * 1000 + Sk)
    B, D, H = 3, 1280, 20
    q = _randn(g, B, Sq, D)
    k, v = _randn(g, B, Sk, D), _randn(g, B, Sk, D)
    cases = [(False, None)]
    if Sq == Sk:
        pads = [min(x, Sq) for x in (0, 64, 129)]
        cases.append((True, torch.tensor(pads, dtype=torch.int32, device=cuda)))
    for causal, pad in cases:
        o_k = K.flash_attention(q, k, v, H, causal=causal, pad_len=pad)
        torch.cuda.synchronize()
        o_p = K.flash_attention_plain(q, k, v, H, causal=causal, pad_len=pad)
        assert torch.isfinite(o_k.float()).all()
        torch.testing.assert_close(o_k.float(), o_p.float(), rtol=0, atol=2e-2)


def test_flash_attention_padded_rows_keep_their_own_slot(cuda):
    """A row wholly inside the left padding attends only its own slot: its
    output is that slot's V row, finite, on every row."""
    g = torch.Generator(device=cuda).manual_seed(7)
    B, P, D, H = 2, 232, 128, 2
    q, k, v = (_randn(g, B, P, D) for _ in range(3))
    pad = torch.tensor([232, 150], dtype=torch.int32, device=cuda)
    out = K.flash_attention(q, k, v, H, causal=True, pad_len=pad)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out[0].float(), v[0].float(), rtol=0, atol=1e-6)
    torch.testing.assert_close(out[1, :150].float(), v[1, :150].float(), rtol=0, atol=1e-6)


def test_flash_attention_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((1, 130, 96), dtype=torch.bfloat16, device=cuda)  # dh = 48
    with pytest.raises(ValueError, match="head width"):
        K.flash_attention(x, x, x, 2)
    y = torch.zeros((1, 130, 128), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        K.flash_attention(y, y, y, 2)
    z = torch.zeros((1, 128, 130), dtype=torch.bfloat16, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        K.flash_attention(z, z, z, 2)


# the training flash kernels (forward with lse, dQ, dK/dV) against their
# plain versions on the same inputs, each output to a share of its max abs:
# f32 1e-4 (f32 FMAs in another order; the backward's products 3xTF32,
# about f32's accuracy); bf16 1e-2 (both round the f32 result to bf16: one
# bf16 step is 2^-8 of a value; the backward also rounds P and dS to bf16
# for their products, as the library does), and the bf16 forward's output
# at the inference kernel's atol 2e-2
TRAIN_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _close_to_max(got, want, share, what):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), what
    torch.testing.assert_close(got, want, rtol=0, atol=share * float(want.abs().max()), msg=what)


def _check_train_backward(q, k, v, dout, H, tol, one_key=False):
    """The backward kernels on the plain forward's out and lse against the
    plain backward, each gradient to ``tol`` of its max abs, twice (the same
    bits both times: no atomics)."""
    out_p, lse_p = K.flash_attention_fwd_plain(q, k, v, H)
    grads = K.flash_attention_bwd(q, k, v, out_p, lse_p, dout, H)
    again = K.flash_attention_bwd(q, k, v, out_p, lse_p, dout, H)
    torch.cuda.synchronize()
    want = K.flash_attention_bwd_plain(q, k, v, out_p, lse_p, dout, H)
    # at one key dq and dk are zero in exact arithmetic (dS = dP - D, D = dP
    # there) and both sides give rounding (~1e-8): they take dv's scale
    scales = [float(w.float().abs().max()) for w in want]
    if one_key:
        scales = [scales[2]] * 3
    for name, got, w, a, scale in zip(("dq", "dk", "dv"), grads, want, again, scales):
        assert got.dtype == q.dtype and got.shape == w.shape and torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), w.float(), rtol=0, atol=tol * scale, msg=name)
        assert torch.equal(got, a), f"{name} differs from run to run"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [1, 65, 127, 128, 129, 200, 1500])
def test_flash_train_kernels_match_plain(cuda, T, dtype):
    """The encoder's shape (B=2, T=1500, D=1280, H=20: the backward's 11
    full 128-row blocks and a 92-row tail, 46 32-column f32 tiles or 23
    64-column bf16 tiles and a 28-column tail) and short ragged sequences
    about one block (127, 128, 129)."""
    g = torch.Generator(device=cuda).manual_seed(T)
    B, D, H = 2, 1280, 20
    q, k, v, dout = (_randn(g, B, T, D, dtype=dtype) for _ in range(4))
    tol = TRAIN_TOL[dtype]
    before = dict(K.LAUNCHES)
    out, lse = K.flash_attention_fwd(q, k, v, H)
    torch.cuda.synchronize()
    out_p, lse_p = K.flash_attention_fwd_plain(q, k, v, H)
    assert out.dtype == dtype and lse.shape == (B, H, T) and lse.dtype == torch.float32
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), out_p.float(), rtol=0, atol=2e-2)
    else:
        _close_to_max(out, out_p, tol, "out")
    _close_to_max(lse, lse_p, 1e-4, "lse")
    _check_train_backward(q, k, v, dout, H, tol, one_key=T == 1)
    assert K.LAUNCHES["flash_attention_fwd"] == before["flash_attention_fwd"] + 1
    assert K.LAUNCHES["flash_attention_bwd_dq"] == before["flash_attention_bwd_dq"] + 2
    assert K.LAUNCHES["flash_attention_bwd_dkv"] == before["flash_attention_bwd_dkv"] + 2
    assert K.LAUNCHES["flash_attention"] == before["flash_attention"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("Sq,Sk", [(300, 77), (70, 1500)])
def test_flash_train_backward_with_other_key_count(cuda, Sq, Sk, dtype):
    """Sq != Sk: each kernel walks a column side of another length than
    its row side (a one-tile and a long walk, both ragged)."""
    g = torch.Generator(device=cuda).manual_seed(Sq + Sk)
    B, D, H = 2, 256, 4
    q, dout = (_randn(g, B, Sq, D, dtype=dtype) for _ in range(2))
    k, v = (_randn(g, B, Sk, D, dtype=dtype) for _ in range(2))
    _check_train_backward(q, k, v, dout, H, TRAIN_TOL[dtype])


def test_flash_attention_function_on_the_card(cuda):
    """Under autograd ``flash_attention`` takes the training kernels (f32),
    and its gradients equal autograd of the plain version; without grad it
    takes the inference kernel."""
    g = torch.Generator(device=cuda).manual_seed(3)
    B, T, D, H = 2, 300, 256, 4
    leaves = [_randn(g, B, T, D, dtype=torch.float32).requires_grad_() for _ in range(3)]
    dout = _randn(g, B, T, D, dtype=torch.float32)
    before = dict(K.LAUNCHES)
    out = K.flash_attention(*leaves, H)
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert K.LAUNCHES["flash_attention_fwd"] == before["flash_attention_fwd"] + 1
    assert K.LAUNCHES["flash_attention_bwd_dkv"] == before["flash_attention_bwd_dkv"] + 1
    assert K.LAUNCHES["flash_attention"] == before["flash_attention"]
    ref_leaves = [x.detach().clone().requires_grad_() for x in leaves]
    ref = K.flash_attention_plain(*ref_leaves, H)
    want = torch.autograd.grad(ref, ref_leaves, dout)
    _close_to_max(out.detach(), ref.detach(), 1e-4, "out")
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close_to_max(a, b, 1e-4, name)
    with torch.no_grad():
        K.flash_attention(*(x.detach().bfloat16() for x in leaves), H)
    assert K.LAUNCHES["flash_attention"] == before["flash_attention"] + 1


def test_flash_train_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros((1, 130, 64), dtype=torch.float32, device=cuda)  # head width 32
    lse = torch.zeros((1, 2, 130), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="head width"):
        K.flash_attention_fwd(x, x, x, 2)
    with pytest.raises(ValueError, match="head width"):
        K.flash_attention_bwd(x, x, x, x, lse, x, 2)
    y = torch.zeros((1, 130, 128), dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError, match="f32 or all bf16"):
        K.flash_attention_fwd(y, y, y, 2)
    z = torch.zeros((1, 130, 128), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="f32 or all bf16"):
        K.flash_attention_fwd(z, z, z.bfloat16(), 2)
    strided = torch.zeros((1, 128, 130), dtype=torch.float32, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        K.flash_attention_fwd(z, strided, z, 2)
    with pytest.raises(ValueError, match="lse"):
        K.flash_attention_bwd(z, z, z, z, lse[:, :1], z, 2)
    # a contiguous view 4 bytes into its storage: TMA's tensor maps refuse it
    shifted = torch.zeros(130 * 128 + 1, dtype=torch.float32, device=cuda)[1:].view(1, 130, 128)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.flash_attention_bwd(z, shifted, z, z, lse, z, 2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.flash_attention_bwd(z, z, z, z, lse, shifted, 2)
    # the two launches check their own TMA inputs: called alone, too
    with pytest.raises(ValueError, match="flash_attention_bwd_dq: inputs must be 16-byte"):
        K._flash_bwd_dq(shifted, z, z, z, z, lse, 2)
    with pytest.raises(ValueError, match="flash_attention_bwd_dkv: inputs must be 16-byte"):
        K._flash_bwd_dkv(z, z, shifted, z, lse, lse, 2)
    with pytest.raises(ValueError, match="no backward for causal"):
        K.flash_attention(z.requires_grad_(), z, z, 2, causal=True)


@pytest.mark.parametrize("rows,seconds,n_mels", [(3, 35, 128), (2, 7.3, 80)])
def test_log10_mel_kernel_matches_plain(cuda, rows, seconds, n_mels):
    """The fused log-mel kernel against its plain version (TF32 off) on
    whisper's padded input (30 s of zeros after the audio; 6500 and 3730
    frames, neither a multiple of the 32-frame tile): the raw log10 at atol
    2e-4 above each row's max - 8 floor, and ``log_mel_spectrogram``
    through the kernel against its plain route at atol 1e-4."""
    from whisper_timestamped_tpu_torch import audio as TA

    assert not torch.backends.cuda.matmul.allow_tf32
    n = int(16000 * seconds)
    t = torch.arange(n, device=cuda) / 16000.0
    g = torch.Generator(device=cuda).manual_seed(rows)
    audio = 0.2 * torch.sin(2 * torch.pi * 220.0 * t) + 0.05 * torch.randn((rows, n), generator=g,
                                                                          device=cuda)
    x = TA._padded_audio(audio, TA.N_SAMPLES, TA.N_FFT // 2)
    consts = TA._front_end_constants(n_mels, TA.N_FFT, cuda)
    before = K.LAUNCHES["log10_mel"]
    raw_k = K.log10_mel(x, *consts, TA.HOP_LENGTH)
    torch.cuda.synchronize()
    assert K.LAUNCHES["log10_mel"] == before + 1
    raw_p = K.log10_mel_plain(x, *consts, TA.HOP_LENGTH)
    assert raw_k.shape == raw_p.shape == (rows, n_mels, (n + TA.N_SAMPLES) // TA.HOP_LENGTH)
    assert raw_k.is_contiguous()
    above = raw_p >= raw_p.amax(dim=(-2, -1), keepdim=True) - 8.0
    torch.testing.assert_close(raw_k[above], raw_p[above], rtol=0, atol=2e-4)
    norm_k = TA.log_mel_spectrogram(audio, n_mels=n_mels, padding=TA.N_SAMPLES)
    assert K.LAUNCHES["log10_mel"] == before + 2
    saved = K.log10_mel
    K.log10_mel = K.log10_mel_plain
    try:
        norm_p = TA.log_mel_spectrogram(audio, n_mels=n_mels, padding=TA.N_SAMPLES)
    finally:
        K.log10_mel = saved
    torch.testing.assert_close(norm_k, norm_p, rtol=0, atol=1e-4)


@pytest.mark.parametrize("B", [1, 8, 40])
@pytest.mark.parametrize("k_in,n_out", [(1280, 5120), (5120, 1280), (1280, 1280)])
def test_stacked_matmul_kernel_matches_plain(cuda, B, k_in, n_out):
    """The layer-indexed matmul at the decode step's shapes (L=32), layers 0
    and 31, against its plain version (f32 sums, one bf16 rounding): within
    1e-2 of the output's largest magnitude."""
    g = torch.Generator(device=cuda).manual_seed(B * k_in + n_out)
    w = (torch.randn((32, n_out, k_in), generator=g, device=cuda) * k_in**-0.5).bfloat16()
    x = _randn(g, B, k_in)
    for layer in (0, 31):
        before = K.LAUNCHES["stacked_matmul"]
        o_k = K.stacked_matmul(x, w, layer)
        torch.cuda.synchronize()
        assert K.LAUNCHES["stacked_matmul"] == before + 1
        o_p = K.stacked_matmul_plain(x, w, layer).float()
        assert o_k.shape == (B, n_out) and o_k.dtype == torch.bfloat16
        assert (o_k.float() - o_p).abs().max() <= 1e-2 * o_p.abs().max()


def _mel_witness(x, n_fft, hop, mel_w):
    """The float64 log10 mel of reflect-padded rows x on the card: periodic
    Hann window, ``torch.fft.rfft`` in float64, the filterbank. The
    kernel's witness only; the port never calls it."""
    n_frames = (x.shape[-1] - n_fft) // hop
    frames = x.double().unfold(-1, n_fft, hop)[:, :n_frames]
    window = torch.hann_window(n_fft, periodic=True, dtype=torch.float64, device=x.device)
    spec = torch.fft.rfft(frames * window, dim=-1)
    mel = (spec.real**2 + spec.imag**2) @ mel_w.double().T
    return torch.log10(torch.clamp(mel, min=1e-10)).transpose(-1, -2)


@pytest.mark.parametrize("n_fft", [400, 512])
@pytest.mark.parametrize("rows,seconds", [(2, 7.3), (3, 35)])
def test_log10_mel_fft_kernel_near_float64(cuda, n_fft, rows, seconds):
    """The FFT kernel at whisper's n_fft and at 512, on rows whose frame
    counts (3730 and 6500 at hop 160) are not multiples of its 32-frame
    tile, against the float64 witness: within 2e-4 on the cells within 6
    decades of their row's loudest and 1e-3 on every cell above the max - 8
    floor, the limits its plain version is held to on the CPU; and against
    the plain version itself as ``test_log10_mel_kernel_matches_plain``."""
    from whisper_timestamped_tpu_torch import audio as TA

    n = int(16000 * seconds)
    t = torch.arange(n, device=cuda) / 16000.0
    g = torch.Generator(device=cuda).manual_seed(rows * n_fft)
    audio = 0.2 * torch.sin(2 * torch.pi * 220.0 * t) + 0.05 * torch.randn((rows, n), generator=g,
                                                                          device=cuda)
    x = TA._padded_audio(audio, TA.N_SAMPLES, n_fft // 2)
    consts = TA._front_end_constants(80, n_fft, cuda)
    raw_k = K.log10_mel(x, *consts, TA.HOP_LENGTH)
    torch.cuda.synchronize()
    exact = _mel_witness(x, n_fft, TA.HOP_LENGTH, consts[2])
    assert raw_k.shape == exact.shape and raw_k.shape[-1] % 32  # the kernel's tile: 32 frames
    top = exact.amax(dim=(-2, -1), keepdim=True)
    above, loud = exact >= top - 8.0, exact >= top - 6.0
    err = (raw_k.double() - exact).abs()
    assert err[loud].max() <= 2e-4 and err[above].max() <= 1e-3
    raw_p = K.log10_mel_plain(x, *consts, TA.HOP_LENGTH)
    above_p = raw_p >= raw_p.amax(dim=(-2, -1), keepdim=True) - 8.0
    torch.testing.assert_close(raw_k[above_p], raw_p[above_p], rtol=0, atol=2e-4)


def _tilted_harmonics(n, rows, device):
    """rows of a 100-180 Hz harmonic series whose harmonics fall 1.5
    decades of power each, plus 1e-6 noise: the top band is many decades
    below each frame's peak, as in speech, so most bins are refined."""
    g = torch.Generator(device=device).manual_seed(rows)
    t = torch.arange(n, device=device, dtype=torch.float64) / 16000.0
    out = torch.zeros((rows, n), dtype=torch.float64, device=device)
    for r in range(rows):
        f0 = 100.0 + 80.0 * r / max(rows - 1, 1)
        for h in range(1, int(7900 // f0) + 1):
            out[r] += 0.3 * 10.0 ** (-0.75 * (h - 1)) * torch.sin(2 * torch.pi * f0 * h * t + h)
    return (out + 1e-6 * torch.randn((rows, n), generator=g, device=device,
                                      dtype=torch.float64)).float()


@pytest.mark.parametrize("n_fft", [400, 512])
def test_log10_mel_refines_dense_tiles(cuda, n_fft):
    """On rows whose bins mostly lie below the refinement threshold (the
    tiles take the dense refinement, the whole DFT product again) and on
    tone-and-noise rows (the sparse one, a bin at a time): the kernel within
    2e-4 of its plain version above the max - 8 floor, and within 2e-4
    (loud) and 1e-3 (above the floor) of the float64 witness."""
    from whisper_timestamped_tpu_torch import audio as TA

    n = 16000 * 12
    t = torch.arange(n, device=cuda) / 16000.0
    g = torch.Generator(device=cuda).manual_seed(n_fft)
    noisy = 0.2 * torch.sin(2 * torch.pi * 500.0 * t) + 0.05 * torch.randn((2, n), generator=g,
                                                                          device=cuda)
    consts = TA._front_end_constants(128, n_fft, cuda)
    for audio in (_tilted_harmonics(n, 3, cuda), noisy):
        x = TA._padded_audio(audio, TA.N_SAMPLES, n_fft // 2)
        raw_k = K.log10_mel(x, *consts, TA.HOP_LENGTH)
        raw_p = K.log10_mel_plain(x, *consts, TA.HOP_LENGTH)
        above_p = raw_p >= raw_p.amax(dim=(-2, -1), keepdim=True) - 8.0
        torch.testing.assert_close(raw_k[above_p], raw_p[above_p], rtol=0, atol=2e-4)
        exact = _mel_witness(x, n_fft, TA.HOP_LENGTH, consts[2])
        top = exact.amax(dim=(-2, -1), keepdim=True)
        err = (raw_k.double() - exact).abs()
        assert err[exact >= top - 6.0].max() <= 2e-4 and err[exact >= top - 8.0].max() <= 1e-3


def test_log10_mel_refuses_what_the_kernel_does_not_take(cuda):
    from whisper_timestamped_tpu_torch import audio as TA

    x = torch.zeros((1, 16000), device=cuda)
    consts = TA._front_end_constants(80, TA.N_FFT, cuda)
    with pytest.raises(ValueError, match="hop"):
        K.log10_mel(x, *consts, 162)
    odd = TA._front_end_constants(80, 392, cuda)  # 196 = 4 * 7 * 7: no plan
    with pytest.raises(ValueError, match="n_fft=392"):
        K.log10_mel(x, *odd, 160)


MATMUL_SHAPES = [(1280, 5120), (5120, 1280), (1280, 1280), (1280, 1000)]


@pytest.mark.parametrize("B", [1, 7, 8, 9, 40, 41, 256, 300])
@pytest.mark.parametrize("k_in,n_out", MATMUL_SHAPES)
def test_stacked_matmul_at_every_split(cuda, monkeypatch, B, k_in, n_out):
    """The tensor-core matmul at the batches around its column widths (8,
    64, 256 and two column groups at 300) and the decode shapes plus a
    ragged N, at every split count ``matmul_split`` can choose for the
    shape (1 to 8), within 1e-2 of the output's largest magnitude; the
    layer read in place from the stack."""
    g = torch.Generator(device=cuda).manual_seed(B * 7 + k_in + n_out)
    w = (torch.randn((3, n_out, k_in), generator=g, device=cuda) * k_in**-0.5).bfloat16()
    x = _randn(g, B, k_in)
    rule = K.matmul_split
    for n_split in range(1, 1 + min(K.MATMUL_MAX_SPLITS, -(-k_in // K.MATMUL_TILE))):
        monkeypatch.setattr(K, "matmul_split", lambda *a, s=n_split: (s, *rule(*a)[1:]))
        for layer in (0, 2):
            o_k = K.stacked_matmul(x, w, layer)
            torch.cuda.synchronize()
            o_p = K.stacked_matmul_plain(x, w, layer).float()
            assert o_k.shape == (B, n_out)
            assert (o_k.float() - o_p).abs().max() <= 1e-2 * o_p.abs().max(), (n_split, layer)


# ---------------------------------------------------------------------------
# sampling and the teacher-forced forward on the card
# ---------------------------------------------------------------------------


def test_gumbel_source_on_the_card_is_seeded(cuda):
    """The sampler's noise on the card: the same seed gives the same draws,
    another seed others; finite f32 on the card."""
    from whisper_timestamped_tpu_torch.decoding import make_gumbel_source

    a, b, c = (make_gumbel_source(s, cuda) for s in (7, 7, 8))
    for _ in range(3):
        x, y, z = a(40, 51866), b(40, 51866), c(40, 51866)
        assert x.device.type == "cuda" and x.dtype == torch.float32
        assert torch.isfinite(x).all()
        assert torch.equal(x, y) and not torch.equal(x, z)


def _small_models():
    """A small model of the kernels' head width (64) in bf16 on the card, and
    the same weights in f32 on the CPU, with a tokenizer of its vocabulary."""
    import copy

    from whisper_timestamped_tpu_torch.models import WhisperDims, WhisperModel, init_params
    from whisper_timestamped_tpu_torch.tokenizer import get_tokenizer, synthetic_ranks

    tok = get_tokenizer(ranks=synthetic_ranks(), multilingual=True, num_languages=99,
                        language="en", task="transcribe")
    dims = WhisperDims(n_mels=80, n_audio_state=256, n_audio_head=4, n_audio_layer=2,
                       n_vocab=tok.n_vocab, n_text_state=256, n_text_head=4, n_text_layer=2)
    cpu = init_params(dims, seed=3, device="cpu")
    card = copy.deepcopy(cpu).to("cuda", torch.bfloat16)
    heads = [(0, 1), (1, 0), (1, 3)]
    return (WhisperModel(module=card, alignment_heads=heads),
            WhisperModel(module=cpu, alignment_heads=heads), tok)


def test_sampled_decode_window_on_card_matches_plain(cuda, monkeypatch):
    """One window at temperature 0.7 on the card through the kernels, and
    the same call with the plain versions in place of the kernels (same
    card, same bf16 weights): the draws come from one source (the same
    seed), so the tokens are equal; log-probs within 5e-2."""
    import whisper_timestamped_tpu_torch.models.whisper_torch as wt
    from whisper_timestamped_tpu_torch.decoding import DecodingOptions
    from whisper_timestamped_tpu_torch.engine import DecodeEngine

    model, _, tok = _small_models()
    mel = torch.randn((80, 3000), generator=torch.Generator(device=cuda).manual_seed(2),
                      device=cuda) * 0.5
    opts = DecodingOptions(language="en", sample_len=24)
    engine = DecodeEngine(model, tok)
    before = dict(K.LAUNCHES)
    got = engine.decode_window(mel, opts, temperature=0.7, rng_seed=4)[0]
    torch.cuda.synchronize()
    assert all(K.LAUNCHES[k] > before[k] for k in ("xattn_decode", "self_attn_decode",
                                                   "flash_attention"))

    def plain_self(q, k_all, v_all, layer, pos, pad, H, k_new, v_new):
        k_all[layer, :, pos] = k_new[:, 0]
        v_all[layer, :, pos] = v_new[:, 0]
        return K.self_attn_decode_plain(q, k_all, v_all, layer, pos, pad, H)

    monkeypatch.setattr(wt, "self_attn_decode", plain_self)
    monkeypatch.setattr(wt, "xattn_decode", K.xattn_decode_plain)
    monkeypatch.setattr(wt, "flash_attention", K.flash_attention_plain)
    want = engine.decode_window(mel, opts, temperature=0.7, rng_seed=4)[0]
    assert got.tokens == want.tokens and len(got.tokens) > 2
    np.testing.assert_allclose(got.token_logprobs, want.token_logprobs, rtol=0, atol=5e-2)
    greedy = engine.decode_window(mel, opts)[0]
    assert greedy.tokens != got.tokens


def test_decode_full_align_heads_on_card_matches_cpu(cuda):
    """The teacher-forced forward with ``align_heads`` on the card (bf16,
    the encoder through ``flash_attention``) against the same weights in
    f32 on the CPU (plain versions): alignment rows and logits at atol
    2e-2 of their scale."""
    from whisper_timestamped_tpu_torch.models.whisper_torch import decode_full, encode

    card, cpu, _ = _small_models()
    g = torch.Generator().manual_seed(6)
    mel = torch.randn((2, 80, 3000), generator=g) * 0.5
    tokens = torch.randint(0, card.dims.n_vocab, (2, 40), generator=g)
    heads = card.alignment_heads
    with torch.no_grad():
        before = K.LAUNCHES["flash_attention"]
        lc, rc = decode_full(card.module, tokens.to(cuda), encode(card.module, mel.to(cuda)),
                             align_heads=heads)
        assert K.LAUNCHES["flash_attention"] > before
        lp, rp = decode_full(cpu.module, tokens, encode(cpu.module, mel), align_heads=heads)
    assert rc.shape == rp.shape == (2, len(heads), 40, 1500)
    scale_r, scale_l = rp.abs().max().item(), lp.abs().max().item()
    torch.testing.assert_close(rc.cpu(), rp, rtol=0, atol=2e-2 * scale_r)
    torch.testing.assert_close(lc.float().cpu(), lp, rtol=0, atol=2e-2 * scale_l)


@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("name", ["xattn_decode", "xattn_decode_int8", "xattn_decode_int4"])
def test_cross_kernels_at_beam_group_5_match_plain(cuda, name, emit):
    """Beam search's reads: B=10 query rows over 2 K/V rows (``beam_group=5``,
    row b reads K/V row b // 5), against the plain versions at the limits
    above (bf16 output atol 2e-2, quantized 4e-3; scores atol 1e-3)."""
    from whisper_timestamped_tpu_torch.ops.quant import quantize_rows, quantize_rows_int4

    g = torch.Generator(device=cuda).manual_seed(len(name) + emit)
    L, T, D, H, B, G = 2, 1500, 1280, 20, 10, 5
    q = _randn(g, B, 1, D)
    if name == "xattn_decode":
        kv, atol = (_randn(g, L, B // G, T, D), _randn(g, L, B // G, T, D)), 2e-2
    else:
        quant = quantize_rows if name == "xattn_decode_int8" else quantize_rows_int4
        kv = (*quant(_randn(g, L, B // G, T, D, dtype=torch.float32)),
              *quant(_randn(g, L, B // G, T, D, dtype=torch.float32, scale=1 / 16)))
        atol = XATTN_Q_ATOL
    before = K.LAUNCHES[name]
    o_k, s_k = getattr(K, name)(q, *kv, 1, H, emit_scores=emit, beam_group=G)
    torch.cuda.synchronize()
    assert K.LAUNCHES[name] == before + 1
    o_p, s_p = getattr(K, name + "_plain")(q, *kv, 1, H, emit_scores=emit, beam_group=G)
    torch.testing.assert_close(o_k.float(), o_p.float(), rtol=0, atol=atol)
    if emit:
        torch.testing.assert_close(s_k, s_p, rtol=0, atol=1e-3)
    else:
        assert s_k is None
    # each group of 5 rows reads its own K/V row: the same queries give the same outputs
    o_same, _ = getattr(K, name)(q[:5].repeat(2, 1, 1).contiguous(), *kv, 1, H, beam_group=G)
    assert not torch.equal(o_same[:5], o_same[5:])


def test_beam_size_one_equals_greedy_on_card(cuda):
    """A K=1 beam decode on the card gives the greedy decode's tokens (a
    20-token prompt, so both prefill the 232-slot region; no alignment
    rows): the beam step is the greedy step plus the identity reorder."""
    from whisper_timestamped_tpu_torch.decoding import DecodingOptions
    from whisper_timestamped_tpu_torch.engine import DecodeEngine

    model, _, tok = _small_models()
    engine = DecodeEngine(model, tok)
    for seed in (2, 3):
        mel = torch.randn((80, 3000), generator=torch.Generator(device=cuda).manual_seed(seed),
                          device=cuda) * 0.5
        prompt = list(range(300, 320))
        opts = dict(language="en", sample_len=48)
        greedy = engine.decode_window(mel, DecodingOptions(**opts), prompt,
                                      capture_attention=False)[0]
        one = engine.decode_window_beam(mel, DecodingOptions(beam_size=1, **opts), prompt)
        assert one.tokens == greedy.tokens and len(one.tokens) > 2
        assert one.sum_logprob == pytest.approx(greedy.sum_logprob, abs=1e-3)


def test_beam_k3_on_card_is_well_formed(cuda):
    """K=3 on the card through the kernels: the cross-attention kernel
    launched once a layer a step (the cross K/V one row for the 3 beams),
    the tokens whisper's timestamp rules allow, and the self-cache reorder
    equal to a plain gather."""
    import whisper_timestamped_tpu_torch.decoding_beam as beam
    from whisper_timestamped_tpu_torch.decoding import DecodingOptions
    from whisper_timestamped_tpu_torch.engine import DecodeEngine
    from whisper_timestamped_tpu_torch.utils import get_counts

    model, _, tok = _small_models()
    mel = torch.randn((80, 3000), generator=torch.Generator(device=cuda).manual_seed(4),
                      device=cuda) * 0.5
    before, steps0 = dict(K.LAUNCHES), get_counts().get("decode_steps", 0)
    res = DecodeEngine(model, tok).decode_window_beam(
        mel, DecodingOptions(language="en", beam_size=3, sample_len=40))
    torch.cuda.synchronize()
    steps = get_counts()["decode_steps"] - steps0
    assert K.LAUNCHES["xattn_decode"] - before["xattn_decode"] == 2 * steps
    assert K.LAUNCHES["self_attn_decode"] - before["self_attn_decode"] == 2 * steps
    assert K.LAUNCHES["flash_attention"] > before["flash_attention"]
    assert res.tokens and all(0 <= t < tok.n_vocab for t in res.tokens)
    assert tok.timestamp_begin <= res.tokens[0] <= tok.timestamp_begin + 50
    stamps = [t for t in res.tokens if t >= tok.timestamp_begin]
    assert stamps == sorted(stamps) and np.isfinite(res.sum_logprob)
    g = torch.Generator(device=cuda).manual_seed(9)
    cur = _randn(g, 2, 12, 64, 256)
    rows = torch.tensor([2, 2, 0, 3, 5, 4, 8, 6, 6, 11, 9, 9], device=cuda)
    got = beam.reorder_rows(cur, torch.zeros_like(cur), rows, 40)
    assert torch.equal(got[:, :, :40], cur[:, rows, :40]) and not got[:, :, 40:].any()
