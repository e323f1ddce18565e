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
  without grad, a causal or padded call under autograd refused.
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
