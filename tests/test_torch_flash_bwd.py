"""The training flash attention's plain versions (what the CPU runs, and
what the card's kernels are held to) and its autograd Function, against
the JAX package and against autograd, in f32.

- ``flash_attention_fwd_plain``'s out and lse, and ``flash_attention_bwd_plain``'s
  dq, dk, dv, against ``jax.vjp`` of the JAX package's ``_attention`` (what
  its ``encode`` runs on the CPU) and of the library's
  ``mha_reference_no_custom_vjp`` (the flash kernel's own reference; its
  ``save_residuals`` m and l give lse = m + log l). ``mha_reference``'s own
  VJP raises under ``jax.vjp`` on the CPU, so the no-custom-VJP form is the
  one differentiated. Seeded inputs, B=2, H=2, head width 64, Sq = Sk in
  {1, 65, 130}; each output to 1e-5 of its max abs (f32, other summation
  orders). At one key dq and dk are zero in exact arithmetic (dS = dP - D,
  and D = dP there) and JAX's are exactly 0, where the port's are that
  difference's rounding (~1e-6): a zero gradient takes its tolerance from
  the largest of the three;
- ``FlashAttentionFn`` (through ``flash_attention`` under autograd) against
  autograd of ``flash_attention_plain``, and the routing: no Function
  without grad, a causal or padded call under autograd refused;
- the card's backward kernels' arithmetic (``csrc/flash_attn_bwd.cu``),
  emulated at H=2 against a float64 backward, one test a choice it rests
  on: bf16 inputs with P and dS rounded to bf16 for their products (the
  library's rounding) hold the bf16 limit (1e-2 of each gradient's max
  abs) against the plain version; f32 inputs as 3xTF32 products (hi = the value with
  its low 13 mantissa bits cleared, lo = the rest, hi·hi + hi·lo + lo·hi)
  hold the f32 limit (1e-4) where one TF32 product does not, also with
  each k-step's sum rounded toward zero as the tensor cores round it;
- the backward's two launches refuse inputs TMA cannot read (not 16-byte
  aligned) before they launch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference_no_custom_vjp  # noqa: E402

from whisper_timestamped_tpu.models import whisper_jax as J  # noqa: E402
from whisper_timestamped_tpu_torch.ops import kernels as K  # noqa: E402

B, H, DH = 2, 2, 64
D = H * DH
TOL = 1e-5  # of each output's max abs


def _inputs(S, seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal((B, S, D)).astype(np.float32) for _ in range(4)]  # q, k, v, dout


def _bhsd(x):  # (B, S, D) -> (B, H, S, dh)
    return x.reshape(x.shape[0], x.shape[1], H, DH).transpose(0, 2, 1, 3)


def _bsd(x):  # (B, H, S, dh) -> (B, S, D)
    x = np.asarray(x)
    return x.transpose(0, 2, 1, 3).reshape(x.shape[0], x.shape[2], D)


def _close(got, want, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * (scale or np.abs(want).max()))


def _close_grads(gots, wants):
    wants = [np.asarray(w) for w in wants]
    largest = max(np.abs(w).max() for w in wants)
    for got, want in zip(gots, wants):
        _close(got, want, np.abs(want).max() or largest)


def _plain(q, k, v, dout):
    t = torch.from_numpy
    out, lse = K.flash_attention_fwd_plain(t(q), t(k), t(v), H)
    grads = K.flash_attention_bwd_plain(t(q), t(k), t(v), out, lse, t(dout), H)
    return out.numpy(), lse.numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("S", [1, 65, 130])
def test_plain_matches_jax_attention_vjp(S):
    q, k, v, dout = _inputs(S, seed=S)
    want_out, vjp = jax.vjp(lambda q, k, v: J._attention(q, k, v, H)[0],
                            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(dout))
    out, _, grads = _plain(q, k, v, dout)
    _close(out, want_out)
    _close_grads(grads, want_grads)


@pytest.mark.parametrize("S", [1, 65, 130])
def test_plain_matches_library_reference_vjp_and_residuals(S):
    q, k, v, dout = _inputs(S, seed=100 + S)
    scale = DH**-0.5
    qh, kh, vh = (jnp.asarray(_bhsd(x)) for x in (q, k, v))
    _, l, m = mha_reference_no_custom_vjp(qh, kh, vh, sm_scale=scale, save_residuals=True)
    want_out, vjp = jax.vjp(lambda q, k, v: mha_reference_no_custom_vjp(q, k, v, sm_scale=scale),
                            qh, kh, vh)
    want_grads = vjp(jnp.asarray(_bhsd(dout)))
    out, lse, grads = _plain(q, k, v, dout)
    _close(out, _bsd(want_out))
    _close(lse, np.asarray(m) + np.log(np.asarray(l)))
    _close_grads(grads, [_bsd(w) for w in want_grads])


@pytest.mark.parametrize("S", [1, 65, 130])
def test_function_gradients_equal_autograd_of_the_plain_version(S):
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(S, seed=200 + S))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = K.flash_attention(*leaves, H)
    assert out.grad_fn is not None and "FlashAttentionFn" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, dout)
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = K.flash_attention_plain(*ref_leaves, H)
    want = torch.autograd.grad(ref, ref_leaves, dout)
    np.testing.assert_array_equal(out.detach().numpy(), ref.detach().numpy())
    _close_grads([g.numpy() for g in got], [w.numpy() for w in want])


def test_routing_and_refusals_on_cpu_tensors():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(65, seed=7))
    before = dict(K.LAUNCHES)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    with torch.no_grad():  # inference keeps today's path: nothing saved
        out = K.flash_attention(*leaves, H)
    assert out.grad_fn is None
    np.testing.assert_array_equal(out.numpy(), K.flash_attention_plain(q, k, v, H).numpy())
    K.flash_attention(*leaves, H).sum().backward()
    assert K.LAUNCHES == before  # the plain versions launch nothing
    with pytest.raises(ValueError, match="no backward for causal"):
        K.flash_attention(*leaves, H, causal=True)
    with pytest.raises(ValueError, match="no backward for causal"):
        K.flash_attention(*leaves, H, causal=True, pad_len=torch.zeros(B, dtype=torch.int32))
    with pytest.raises(ValueError, match="no kernel for device"):
        K.flash_attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"), H)


@pytest.mark.parametrize("which", ["dq", "dkv"])
def test_backward_wrappers_refuse_what_tma_cannot_read(which):
    """Each backward launch checks the tensors it hands to TMA (q, k, v and
    dout) for 16-byte bases itself, before it launches: a contiguous view 4
    bytes into its storage is refused by name."""
    z = torch.zeros((1, 65, D))
    lse = torch.zeros((1, H, 65))
    shifted = torch.zeros(65 * D + 1)[1:].view(1, 65, D)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    before = dict(K.LAUNCHES)
    for args in ((shifted, z, z, z), (z, shifted, z, z), (z, z, shifted, z), (z, z, z, shifted)):
        q, k, v, dout = args
        with pytest.raises(ValueError, match=f"flash_attention_bwd_{which}: inputs must be 16"):
            if which == "dq":
                K._flash_bwd_dq(q, k, v, z, dout, lse, H)
            else:
                K._flash_bwd_dkv(q, k, v, dout, lse, lse, H)
    assert K.LAUNCHES == before


def _tf32(x):
    """x as the tensor cores read a float: its low 13 mantissa bits cleared."""
    return (x.float().contiguous().view(torch.int32) & -8192).view(torch.float32)


def _mm_tf32(a, b):  # one TF32 product, summed in f32
    return _tf32(a) @ _tf32(b)


def _mm_3xtf32(a, b):  # hi·hi + hi·lo + lo·hi, each lo also read as tf32
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a.float() - ah), _tf32(b.float() - bh)
    return ah @ bh + ah @ bl + al @ bh


def _mm_3xtf32_toward_zero(a, b, acc=None):
    """3xTF32 as the kernels' ``wgmma`` sum it: the K dimension walked tile
    by tile (the head width's 64 whole, else 32 rows a tile), each tile's
    hi·hi, then hi·lo, then lo·hi, one k-step of 8 at a time, the k-step's
    exact sum added to the f32 accumulator (zeros, or ``acc``) rounded
    toward zero."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a.float() - ah), _tf32(b.float() - bh)
    parts, n = [(ah, bh), (ah, bl), (al, bh)], a.shape[-1]
    tile = n if n == DH else 32
    acc = (torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=torch.float64) if acc is None
           else acc.float().double())
    for t0 in range(0, n, tile):
        for x, y in parts:
            for k0 in range(t0, min(t0 + tile, n), 8):
                exact = acc + x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double()
                f = exact.float()
                acc = torch.where(f.double().abs() > exact.abs(),
                                  torch.nextafter(f, torch.zeros_like(f)), f).double()
    return acc.float()


def _emulated_backward(q, k, v, out, lse, dout, mm, round_ps=lambda x: x):
    """The kernels' backward, head by head in f32: S and dP by ``mm``, P and
    dS from them in f32, then ``round_ps`` of P and dS into their products
    (dV, dQ, dK) by ``mm``. Returns (dq, dk, dv) (B, S, D) f32."""
    scale = DH**-0.5
    qh, kh, vh, oh, doh = (torch.from_numpy(_bhsd(x)).float() for x in (q, k, v, out, dout))
    p = torch.exp(mm(qh, kh.transpose(-1, -2)) * scale - torch.from_numpy(lse).float()[..., None])
    dp = mm(doh, vh.transpose(-1, -2))
    ds = p * (dp - (doh * oh).sum(-1, keepdim=True))
    p, ds = round_ps(p), round_ps(ds)
    dv = mm(p.transpose(-1, -2), doh)
    dq = mm(ds, kh) * scale
    dk = mm(ds.transpose(-1, -2), qh) * scale
    return [_bsd(g.numpy()) for g in (dq, dk, dv)]


def _float64_backward(q, k, v, dout):
    """out, lse and (dq, dk, dv) worked by their formulas in float64 (the
    plain versions work in f32 whatever their inputs), the judge of the
    emulations."""
    qh, kh, vh, doh = (torch.from_numpy(_bhsd(np.asarray(x, np.float64))) for x in (q, k, v, dout))
    s = qh @ kh.transpose(-1, -2) * DH**-0.5
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    oh = p @ vh
    ds = p * (doh @ vh.transpose(-1, -2) - (doh * oh).sum(-1, keepdim=True))
    grads = (ds @ kh * DH**-0.5, ds.transpose(-1, -2) @ qh * DH**-0.5, p.transpose(-1, -2) @ doh)
    return _bsd(oh.numpy()), lse.numpy(), [_bsd(g.numpy()) for g in grads]


def _errors(gots, wants):  # each gradient's max error over its max abs
    return [float(np.abs(np.asarray(g, np.float64) - w).max() / np.abs(w).max())
            for g, w in zip(gots, wants)]


@pytest.mark.parametrize("S", [65, 200])
def test_bf16_rounding_of_p_and_ds_holds_the_bf16_limit(S):
    """bf16 inputs: the kernels round P and dS to bf16 for their products
    (``p.T.astype(do.dtype)``, ``ds.astype(k.dtype)`` in the library) and
    the gradients to bf16; S, dP, D and lse stay f32. That holds 1e-2 of
    each gradient's max abs against the plain version (which rounds only
    the gradients), and against float64."""
    bf = lambda x: torch.from_numpy(x).bfloat16()  # noqa: E731
    q, k, v, dout = (bf(x).float().numpy() for x in _inputs(S, seed=300 + S))
    out64, lse64, want64 = _float64_backward(q, k, v, dout)
    out = torch.from_numpy(out64).bfloat16().float().numpy()  # the forward's bf16 out
    rounded = lambda x: x.bfloat16().float()  # noqa: E731
    got = _emulated_backward(q, k, v, out, lse64.astype(np.float32), dout, torch.matmul, rounded)
    got = [torch.from_numpy(g).bfloat16().float().numpy() for g in got]
    t = torch.from_numpy
    plain = K.flash_attention_bwd_plain(*(t(x).bfloat16() for x in (q, k, v, out)),
                                        t(lse64.astype(np.float32)), t(dout).bfloat16(), H)
    plain = [g.float().numpy().astype(np.float64) for g in plain]
    assert max(_errors(got, plain)) <= 1e-2
    assert max(_errors(got, want64)) <= 1e-2


@pytest.mark.parametrize("S", [65, 200])
def test_3xtf32_holds_the_f32_limit_where_one_tf32_product_does_not(S):
    """f32 inputs: every product as hi·hi + hi·lo + lo·hi of tf32 parts
    stays within 1e-4 of each gradient's max abs of float64 (about 2e-6);
    one TF32 product a product (~3e-3) does not."""
    q, k, v, dout = _inputs(S, seed=400 + S)
    out64, lse64, want64 = _float64_backward(q, k, v, dout)
    out, lse = out64.astype(np.float32), lse64.astype(np.float32)
    three = _errors(_emulated_backward(q, k, v, out, lse, dout, _mm_3xtf32), want64)
    one = _errors(_emulated_backward(q, k, v, out, lse, dout, _mm_tf32), want64)
    assert max(three) <= 1e-4
    assert min(one) > 1e-4


@pytest.mark.parametrize("S", [65, 200])
def test_3xtf32_summed_toward_zero_holds_the_f32_limit(S):
    """The tensor cores add each k-step's products to the f32 accumulator
    rounded toward zero, not to nearest: in the kernels' order (three
    products a tile, k-steps of 8) that costs a few times the error of
    nearest sums (at T = 1500 ~3e-5 of a gradient's max, the card's own
    figure; tools/torch_kernel_sweeps.py flash-bwd-accuracy) and still
    holds the f32 limit (1e-4) against float64."""
    q, k, v, dout = _inputs(S, seed=500 + S)
    out64, lse64, want64 = _float64_backward(q, k, v, dout)
    out, lse = out64.astype(np.float32), lse64.astype(np.float32)
    toward_zero = _errors(_emulated_backward(q, k, v, out, lse, dout, _mm_3xtf32_toward_zero),
                          want64)
    nearest = _errors(_emulated_backward(q, k, v, out, lse, dout, _mm_3xtf32), want64)
    assert max(toward_zero) <= 1e-4
    assert max(toward_zero) > max(nearest)
