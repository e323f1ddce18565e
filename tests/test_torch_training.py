"""The port's fine-tuning (``whisper_timestamped_tpu_torch.training``)
against the JAX package's (``whisper_timestamped_tpu/training.py``), on the
CPU, in f32, with the same weights (``init_params``' tree through
``params_from_jax_tree``) and the same seeded mel, tokens and mask.

The dims are tiny but keep head width 64 and 128 encoder frames, so the
port's encoder takes ``flash_attention`` and, under autograd,
``FlashAttentionFn`` (its plain versions here); JAX's ``encode`` takes its
plain ``_attention`` on the CPU.

Tolerances:
- the loss to rtol 1e-5 (f32, other summation orders);
- each gradient leaf to 1e-4 of its max abs (JAX's gradient tree mapped
  with ``params_from_jax_tree``, which only transposes and renames);
- after three AdamW steps (optax's ``adamw(1e-5)`` against the port's
  default ``adamw``): the losses to rtol 1e-5; Adam's first moments to
  1e-4 and second moments to 2e-4 of each leaf's max abs (linear and
  quadratic in the gradients); the parameters to 1e-6, a tenth of one
  step (lr = 1e-5). Adam's early steps are about lr·sign(g), so where JAX's
  gradient lies within the gradients' own tolerance of 0 at some step, the
  sign, and so a whole step, may differ: there a parameter is held to
  3 steps of lr (plus 1e-6).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from whisper_timestamped_tpu import training as JT  # noqa: E402
from whisper_timestamped_tpu.models import whisper_jax as J  # noqa: E402
from whisper_timestamped_tpu_torch import training as T  # noqa: E402
from whisper_timestamped_tpu_torch.models import load as L  # noqa: E402
from whisper_timestamped_tpu_torch.models import whisper_torch as W  # noqa: E402
from whisper_timestamped_tpu_torch.ops import kernels as K  # noqa: E402

FIELDS = dict(n_mels=80, n_audio_ctx=128, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
              n_vocab=512, n_text_ctx=32, n_text_state=128, n_text_head=2, n_text_layer=2)
JDIMS, DIMS = J.WhisperDims(**FIELDS), W.WhisperDims(**FIELDS)
LR, STEPS = 1e-5, 3
GRAD_TOL, MU_TOL, NU_TOL, PARAM_TOL = 1e-4, 1e-4, 2e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0):
    r = np.random.default_rng(seed)
    mel = (r.standard_normal((2, 80, 2 * FIELDS["n_audio_ctx"])) * 0.3).astype(np.float32)
    tokens = r.integers(0, FIELDS["n_vocab"], (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.float32)
    mask[1, 8:] = 0.0  # a partial mask: the second row's tail does not count
    return mel, tokens, mask


def _torch_batch(seed=0):
    mel, tokens, mask = _batch(seed)
    return torch.from_numpy(mel), torch.from_numpy(tokens).long(), torch.from_numpy(mask)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_leaves(tree, fixed_pos_emb=True):
    """JAX-layout tree -> {name: tensor} in the port's names and layouts,
    the encoder's fixed positions (filled in, not a leaf of JAX's) left out."""
    model = L.params_from_jax_tree(_np_tree(tree), DIMS, device="cpu")
    return {n: p.detach() for n, p in model.named_parameters()
            if not (fixed_pos_emb and n == "encoder.pos_emb")}


@pytest.fixture(scope="module")
def jax_params():
    return J.init_params(JDIMS, jax.random.PRNGKey(3))


@pytest.fixture(scope="module")
def jax_grad_fn():
    return jax.jit(jax.value_and_grad(lambda p, m, t, k: JT.teacher_forced_loss(p, m, t, k, JDIMS)))


@pytest.fixture(scope="module")
def jax_steps(jax_params, jax_grad_fn):
    """Three jitted steps of JAX's make_train_step: the losses, the final
    state and each step's gradients (at the parameters it started from)."""
    init_state, train_step = JT.make_train_step(JDIMS)
    step = jax.jit(train_step)
    state = init_state(jax_params)
    batch = [jnp.asarray(x) for x in _batch()]
    losses, grads = [], []
    for _ in range(STEPS):
        grads.append(jax_grad_fn(state.params, *batch)[1])
        state, loss = step(state, *batch)
        losses.append(float(loss))
    return losses, state, grads


def _port_model(jax_params):
    return L.params_from_jax_tree(_np_tree(jax_params), DIMS, device="cpu")


def test_loss_and_gradients_match_jax(jax_params, jax_grad_fn, monkeypatch):
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = K.flash_attention_fwd, K.flash_attention_bwd

    def spy_fwd(*a):
        calls["fwd"] += 1
        return fwd(*a)

    def spy_bwd(*a):
        calls["bwd"] += 1
        return bwd(*a)

    monkeypatch.setattr(K, "flash_attention_fwd", spy_fwd)
    monkeypatch.setattr(K, "flash_attention_bwd", spy_bwd)
    want_loss, want_grads = jax_grad_fn(jax_params, *(jnp.asarray(x) for x in _batch()))
    model = _port_model(jax_params)
    for p in T.trainable_parameters(model):
        p.requires_grad_(True)
    loss = T.teacher_forced_loss(model, *_torch_batch())
    loss.backward()
    # every encoder layer's attention went through the Function, both ways
    assert calls == {"fwd": DIMS.n_audio_layer, "bwd": DIMS.n_audio_layer}
    assert loss.dim() == 0 and loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = _port_leaves(want_grads)
    got = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    assert set(got) == set(want)  # the fixed encoder positions have no gradient
    for n, g in want.items():
        np.testing.assert_allclose(got[n].numpy(), g.numpy(), rtol=0,
                                   atol=GRAD_TOL * float(g.abs().max()), err_msg=n)


def test_three_train_steps_match_jax(jax_params, jax_steps):
    want_losses, want_state, want_grads = jax_steps
    model = _port_model(jax_params)
    init_state, train_step = T.make_train_step(DIMS)
    state = init_state(model)
    batch = _torch_batch()
    losses = []
    for _ in range(STEPS):
        state, loss = train_step(state, *batch)
        losses.append(loss.item())
    assert state.step == STEPS and int(want_state.step) == STEPS
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert losses[-1] < losses[0]  # it learns the fixed batch, as JAX's does

    adam = want_state.opt_state[0]
    mu, nu, params = _port_leaves(adam.mu), _port_leaves(adam.nu), _port_leaves(want_state.params)
    grads = [_port_leaves(g) for g in want_grads]
    named = dict(model.named_parameters())
    assert set(params) == {n for n, p in named.items() if p.requires_grad}
    for n in params:
        st = state.opt_state.state[named[n]]
        for got, want, tol in ((st["exp_avg"], mu[n], MU_TOL), (st["exp_avg_sq"], nu[n], NU_TOL)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=tol * float(want.abs().max()), err_msg=n)
        # where a step's gradient is within its tolerance of 0, the step's sign may differ
        unsure = torch.zeros_like(params[n], dtype=torch.bool)
        for g in grads:
            unsure |= g[n].abs() <= GRAD_TOL * float(g[n].abs().max())
        diff = (named[n].detach() - params[n]).abs()
        limit = torch.where(unsure, PARAM_TOL + STEPS * LR, torch.full_like(diff, PARAM_TOL))
        assert bool((diff <= limit).all()), (n, float(diff.max()), int(unsure.sum()))


def test_fixed_positions_stay_and_checkpoint_positions_train(jax_params):
    batch = _torch_batch()
    model = _port_model(jax_params)  # JAX's init_params: no encoder pos_emb
    assert model.fixed_pos_emb
    fixed = model.encoder["pos_emb"].detach().clone()
    init_state, train_step = T.make_train_step(DIMS)
    state, _ = train_step(init_state(model), *batch)
    assert not model.encoder["pos_emb"].requires_grad
    assert torch.equal(model.encoder["pos_emb"], fixed)
    assert W.init_params(DIMS, device="cpu").fixed_pos_emb  # the port's own random weights

    tree = _np_tree(jax_params)
    tree["encoder"]["pos_emb"] = fixed.numpy() + 0.01  # a checkpoint's trained positions
    loaded = L.params_from_jax_tree(tree, DIMS, device="cpu")
    assert not loaded.fixed_pos_emb
    before = loaded.encoder["pos_emb"].detach().clone()
    train_step(init_state(loaded), *batch)
    step = (loaded.encoder["pos_emb"].detach() - before).abs()
    # AdamW's first step moves each position by about lr (sign of its gradient)
    assert float(step.max()) <= 1.01 * LR * (1 + 1e-4) and float(step.mean()) > 0.5 * LR


def test_checkpoint_round_trip(jax_params, tmp_path):
    batch = _torch_batch()
    init_state, train_step = T.make_train_step(DIMS)
    state = init_state(_port_model(jax_params))
    path = str(tmp_path / "ckpt")
    state, _ = train_step(state, *batch)
    T.save_checkpoint(path, state)
    state, _ = train_step(state, *batch)
    T.save_checkpoint(path, state)  # overwrites the first save
    restored = T.load_checkpoint(path, init_state(_port_model(jax_params)))
    assert restored.step == 2
    for (n, a), b in zip(state.params.named_parameters(), restored.params.parameters()):
        assert torch.equal(a, b), n
    for a, b in zip(state.params.parameters(), restored.params.parameters()):
        if a.requires_grad:
            sa, sb = state.opt_state.state[a], restored.opt_state.state[b]
            assert all(torch.equal(sa[k], sb[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    # training goes on from the restored state as from the saved one
    state, loss = train_step(state, *batch)
    restored, loss_r = train_step(restored, *batch)
    assert restored.step == 3 and torch.equal(loss, loss_r) and np.isfinite(loss_r.item())
    for a, b in zip(state.params.parameters(), restored.params.parameters()):
        assert torch.equal(a, b)


def test_refusals(jax_params, tmp_path):
    """A mesh that is not a ("dp", "tp") DeviceMesh raises ``TypeError``;
    a one-rank mesh (dp=1, tp=1) trains as one card does, bit for bit."""
    from torch_mesh_ranks import one_rank_mesh
    from whisper_timestamped_tpu_torch.parallel.mesh import shard_params

    with pytest.raises(TypeError, match="DeviceMesh"):
        T.make_train_step(DIMS, mesh=object())
    other = W.WhisperDims(**{**FIELDS, "n_vocab": 513})
    init_state, _ = T.make_train_step(other)
    with pytest.raises(ValueError, match="dims"):
        init_state(_port_model(jax_params))

    batch = _torch_batch()
    init_state, train_step = T.make_train_step(DIMS)
    one, loss = train_step(init_state(_port_model(jax_params)), *batch)
    with one_rank_mesh(str(tmp_path)) as mesh:
        init_mesh, step_mesh = T.make_train_step(DIMS, mesh=mesh)
        got, got_loss = step_mesh(init_mesh(shard_params(_port_model(jax_params), mesh)), *batch)
    assert torch.equal(got_loss, loss)
    for (n, a), b in zip(got.params.named_parameters(), one.params.parameters()):
        assert torch.equal(a, b), n
