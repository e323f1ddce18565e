"""The training flash attention's forward with lse, as the card's kernels
compute it, against float64 and against the JAX library's forward with
residuals.

The kernels (``csrc/flash_attn.cu`` for bf16, ``csrc/flash_attn_fwd_lse.cu``
for f32) walk the keys 64 at a time with an online softmax: per tile
S = Q·Kᵀ, the running max m (log2 units of the scaled scores) and sum l,
P = exp2(S·dh^-0.5·log2e - m), O rescaled then O += P·V; at the end
out = O / l and lse = m·ln2 + log(l). f32 takes both products as 3xTF32
with each k-step's sum rounded toward zero (``_mm_3xtf32_toward_zero``, the
tensor cores' rounding); bf16 rounds P to bf16 for P·V, as the library does,
and the output to bf16. That emulation, at B=2, H=2 and S = 65 and 200
(one ragged key tile, and three whole tiles and an 8-key tail), is held to:

- a float64 forward on the same inputs;
- the library kernel's ``_flash_attention_fwd`` (what the JAX package's
  ``train_step`` runs; here in interpret mode, as tests/test_torch_flash.py
  runs the library kernel) and its residuals m and l as lse = m + log(l).

Limits: out within 1e-4 of its max abs in f32 and 2e-2 (absolute, the
inference kernel's) in bf16; lse within 1e-4 of its max abs.
The forward's wrapper refuses, before it launches, inputs TMA cannot read.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402
from jax.experimental.pallas.ops.tpu import flash_attention as JF  # noqa: E402

from test_torch_flash_bwd import _bhsd, _bsd, _mm_3xtf32_toward_zero  # noqa: E402
from whisper_timestamped_tpu_torch.ops import kernels as K  # noqa: E402

B, H, DH = 2, 2, 64
D = H * DH
BN = 64  # keys a tile, both kernels' kBN
LOG2E = 1.4426950408889634
OUT_TOL = {"f32": 1e-4, "bf16": 2e-2}  # f32 of out's max abs; bf16 absolute
LSE_TOL = 1e-4  # of lse's max abs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(S, seed, dtype):
    """q, k, v (B, S, D) f32, rounded to bf16 first for ``dtype`` bf16."""
    r = np.random.default_rng(seed)
    xs = [r.standard_normal((B, S, D)).astype(np.float32) for _ in range(3)]
    if dtype == "bf16":
        xs = [torch.from_numpy(x).bfloat16().float().numpy() for x in xs]
    return xs


def _emulated_forward(q, k, v, dtype):
    """The kernels' forward in their order (see the module docstring).
    Returns (out (B, S, D), lse (B, H, S)) as float32 numpy."""
    qh, kh, vh = (torch.from_numpy(_bhsd(x)).float() for x in (q, k, v))
    scale_log2 = DH**-0.5 * LOG2E
    m = torch.full(qh.shape[:-1], float("-inf"))
    l = torch.zeros(qh.shape[:-1])
    o = torch.zeros(qh.shape)
    for k0 in range(0, kh.shape[2], BN):
        kt, vt = kh[:, :, k0:k0 + BN], vh[:, :, k0:k0 + BN]
        if dtype == "f32":
            s = _mm_3xtf32_toward_zero(qh, kt.transpose(-1, -2))
        else:
            s = (qh.double() @ kt.transpose(-1, -2).double()).float()
        mn = torch.maximum(m, s.amax(-1) * scale_log2)
        alpha = torch.exp2(m - mn)
        p = torch.exp2(s * scale_log2 - mn[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None]
        if dtype == "f32":
            o = _mm_3xtf32_toward_zero(p, vt, acc=o)
        else:
            o = (o.double() + p.bfloat16().double() @ vt.double()).float()
        m = mn
    out = o / l[..., None]
    if dtype == "bf16":
        out = out.bfloat16().float()
    lse = m * float(np.log(2.0)) + torch.log(l)
    return _bsd(out.numpy()), lse.numpy()


def _float64_forward(q, k, v):
    qh, kh, vh = (torch.from_numpy(_bhsd(np.asarray(x, np.float64))) for x in (q, k, v))
    s = qh @ kh.transpose(-1, -2) * DH**-0.5
    lse = torch.logsumexp(s, dim=-1)
    return _bsd((torch.exp(s - lse[..., None]) @ vh).numpy()), lse.numpy()


def _library_forward(q, k, v, dtype):
    """The JAX library kernel's forward with residuals (interpret mode):
    out and lse = m + log(l)."""
    S = q.shape[1]
    jt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    qh, kh, vh = (jnp.asarray(_bhsd(x)).astype(jt) for x in (q, k, v))
    sizes = JF.BlockSizes(block_q=S, block_k_major=S, block_k=S, block_b=1)
    with pltpu.force_tpu_interpret_mode():
        out, res = JF._flash_attention_fwd(qh, kh, vh, None, None, False, False, DH**-0.5,
                                           sizes, False)
    l, m = np.asarray(res[-2], np.float64), np.asarray(res[-1], np.float64)
    return _bsd(np.asarray(out.astype(jnp.float32))), m + np.log(l)


def _check(got, want, dtype):
    (out, lse), (out_w, lse_w) = got, want
    out, out_w = np.asarray(out, np.float64), np.asarray(out_w, np.float64)
    assert out.shape == out_w.shape and np.all(np.isfinite(out)) and np.all(np.isfinite(lse))
    limit = OUT_TOL[dtype] * (np.abs(out_w).max() if dtype == "f32" else 1.0)
    assert np.abs(out - out_w).max() <= limit
    assert np.abs(lse - lse_w).max() <= LSE_TOL * np.abs(lse_w).max()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("S", [65, 200])
def test_emulated_forward_near_float64(S, dtype):
    q, k, v = _inputs(S, seed=600 + S, dtype=dtype)
    _check(_emulated_forward(q, k, v, dtype), _float64_forward(q, k, v), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("S", [65, 200])
def test_emulated_forward_near_library_forward_and_residuals(S, dtype):
    q, k, v = _inputs(S, seed=700 + S, dtype=dtype)
    _check(_emulated_forward(q, k, v, dtype), _library_forward(q, k, v, dtype), dtype)


@pytest.mark.parametrize("S", [65, 200])
def test_plain_forward_near_library_forward_and_residuals(S):
    """The plain version (what the CPU runs and the card's kernels are held
    to) against the library's forward, f32."""
    q, k, v = _inputs(S, seed=800 + S, dtype="f32")
    t = torch.from_numpy
    out, lse = K.flash_attention_fwd_plain(t(q), t(k), t(v), H)
    _check((out.numpy(), lse.numpy()), _library_forward(q, k, v, "f32"), "f32")


def test_f32_emulation_rounds_toward_zero_within_the_limit():
    """Each k-step's sum rounded toward zero (the tensor cores' rounding)
    moves out farther from float64 than nearest sums would (3xTF32 products
    summed in f32), and stays inside the f32 limit at S = 200."""
    q, k, v = _inputs(200, seed=900, dtype="f32")
    out64, _ = _float64_forward(q, k, v)
    out_tz, _ = _emulated_forward(q, k, v, "f32")
    err_tz = np.abs(out_tz - out64).max() / np.abs(out64).max()
    qh, kh, vh = (torch.from_numpy(_bhsd(x)) for x in (q, k, v))
    p = torch.softmax((qh @ kh.transpose(-1, -2)) * DH**-0.5, dim=-1)
    err_f32 = np.abs(_bsd((p @ vh).numpy()) - out64).max() / np.abs(out64).max()
    assert err_f32 < err_tz <= OUT_TOL["f32"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_forward_wrapper_refuses_what_tma_cannot_read(dtype):
    """The forward's launch checks the tensors it hands to TMA (q, k and v)
    for 16-byte bases itself, before it launches: a contiguous view 4 bytes
    into its storage is refused by name."""
    z = torch.zeros((1, 65, D), dtype=dtype)
    shifted = torch.zeros(65 * D + 1, dtype=dtype)[1:].view(1, 65, D)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    before = dict(K.LAUNCHES)
    for q, k, v in ((shifted, z, z), (z, shifted, z), (z, z, shifted)):
        with pytest.raises(ValueError, match="flash_attention_fwd: inputs must be 16"):
            K._flash_fwd(q, k, v, H)
    assert K.LAUNCHES == before
