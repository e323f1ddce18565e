"""Training on the port's mesh (``training.make_train_step(mesh=)`` on a model
sharded by ``parallel.shard_params``, the batch cut by ``shard_batch``)
against the JAX package's jitted ``make_train_step``, in f32 on the CPU.

One spawned gloo world of 4 ranks (``torch_mesh_ranks.world_train``) trains
the same weights (JAX's ``init_params`` through ``params_from_jax_tree``)
on dp=1 x tp=4, dp=2 x tp=2 and dp=4 x tp=1, three AdamW steps each, then
crosses checkpoints between dp=2 x tp=2 and one card; then a 6-head model
(``SIX``, width 384) on dp=1 x tp=4, its heads dealt 2, 2, 1, 1 (the run
"six"), with its checkpoints crossing too. Meanwhile this process runs
JAX's step unsharded and on its own dp=2 x tp=2 mesh, and the 6-head
model's unsharded and on a dp=1 x tp=4 mesh, where GSPMD cuts the 384
columns evenly and so splits heads (``jax.devices()[:4]`` of
``conftest.py``'s 8 virtual devices, as ``__graft_entry__.py:196-214``
builds it). The geometries take tp=4 and keep head width 64 over 128
encoder frames, so the encoder's attention runs ``FlashAttentionFn`` (its
plain versions here) on each rank's heads. The four rows' masks count 11,
8, 4 and 10 targets, so the dp blocks' own means differ from the whole
batch's.

Tolerances (``test_torch_training.py``'s): the loss to rtol 1e-5; each
gradient leaf's slice to 1e-4 of the leaf's max abs; after three steps
Adam's moments to 1e-4 / 2e-4 of the leaf's max abs and the parameters to
1e-6, or 1e-6 + 3 steps of lr where some step's gradient lies within its
tolerance of 0 (Adam's step may take the other sign there).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_mesh_ranks import TRAIN_MESHES, run_world  # noqa: E402
from whisper_timestamped_tpu import training as JT  # noqa: E402
from whisper_timestamped_tpu.models import whisper_jax as J  # noqa: E402
from whisper_timestamped_tpu.parallel import mesh as JM  # noqa: E402
from whisper_timestamped_tpu_torch import training as T  # noqa: E402
from whisper_timestamped_tpu_torch.models import load as L  # noqa: E402
from whisper_timestamped_tpu_torch.models import whisper_torch as W  # noqa: E402
from whisper_timestamped_tpu_torch.parallel import mesh as M  # noqa: E402

FIELDS = dict(n_mels=80, n_audio_ctx=128, n_audio_state=256, n_audio_head=4, n_audio_layer=2,
              n_vocab=512, n_text_ctx=32, n_text_state=256, n_text_head=4, n_text_layer=2)
JDIMS, DIMS = J.WhisperDims(**FIELDS), W.WhisperDims(**FIELDS)
# tiny's 6 heads at head width 64 (MLP 1536): tp=4 deals them 2, 2, 1, 1
SIX = dict(FIELDS, n_audio_state=384, n_audio_head=6, n_text_state=384, n_text_head=6)
JSIX, SIX_DIMS = J.WhisperDims(**SIX), W.WhisperDims(**SIX)
LR, STEPS = 1e-5, 3
GRAD_TOL, MU_TOL, NU_TOL, PARAM_TOL = 1e-4, 1e-4, 2e-4, 1e-6
MESHES = [f"{dp}x{tp}" for dp, tp in TRAIN_MESHES]
RUNS = MESHES + ["six"]  # torch_mesh_ranks.TRAIN_RUNS' keys


def _dims(run: str):
    return SIX_DIMS if run == "six" else DIMS


def _wants(jax_out, run: str):
    """The JAX runs a port run is held to: the unsharded step, and for the
    6-head model also JAX's own tp=4 mesh."""
    return [jax_out["six_one"], jax_out["six_mesh"]] if run == "six" else [jax_out["one"]]


def _batch():
    r = np.random.default_rng(5)
    mel = (r.standard_normal((4, 80, 2 * FIELDS["n_audio_ctx"])) * 0.3).astype(np.float32)
    tokens = r.integers(0, FIELDS["n_vocab"], (4, 12)).astype(np.int32)
    mask = np.ones((4, 12), np.float32)
    for row, end in ((1, 9), (2, 5), (3, 11)):
        mask[row, end:] = 0.0
    return mel, tokens, mask


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_leaves(tree, dims=DIMS):
    """JAX-layout tree -> {port name: numpy array}, the encoder's fixed
    positions (not a leaf of JAX's) left out."""
    model = L.params_from_jax_tree(_np_tree(tree), dims, device="cpu")
    return {n: p.detach().numpy() for n, p in model.named_parameters() if n != "encoder.pos_emb"}


def _jax_steps(params, batch, mesh=None, jdims=JDIMS):
    """Three jitted steps of JAX's make_train_step (on ``mesh``'s sharded
    tree and batch when given): the losses, the last state's parameters and
    moments and each step's gradients, as port-layout leaves."""
    grad_fn = jax.jit(jax.value_and_grad(lambda p, m, t, k: JT.teacher_forced_loss(p, m, t, k, jdims)))
    init_state, train_step = JT.make_train_step(jdims)
    dims = W.WhisperDims(**jdims.__dict__)
    step = jax.jit(train_step)
    batch = [jnp.asarray(x) for x in batch]
    if mesh is not None:
        params = JM.shard_params(params, mesh)
        batch = [JM.shard_batch(x, mesh) for x in batch]
    state = init_state(params)
    losses, grads = [], []
    for _ in range(STEPS):
        grads.append(_port_leaves(grad_fn(state.params, *batch)[1], dims))
        state, loss = step(state, *batch)
        losses.append(float(loss))
    adam = state.opt_state[0]
    return dict(losses=losses, grads=grads, params=_port_leaves(state.params, dims),
                mu=_port_leaves(adam.mu, dims), nu=_port_leaves(adam.nu, dims))


def _jax_side(params, six, batch):
    out = {"one": _jax_steps(params, batch), "six_one": _jax_steps(six, batch, jdims=JSIX)}
    mesh = JM.get_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    with mesh:
        out["mesh"] = _jax_steps(params, batch, mesh)
    mesh = JM.get_mesh(dp=1, tp=4, devices=jax.devices()[:4])
    with mesh:
        out["six_mesh"] = _jax_steps(six, batch, mesh, jdims=JSIX)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the 4 ranks' results, JAX's unsharded and dp=2 x tp=2 runs, each
    leaf's sharded axis)."""
    params = J.init_params(JDIMS, jax.random.PRNGKey(3))
    six = J.init_params(JSIX, jax.random.PRNGKey(4))
    mel, tokens, mask = _batch()
    tmp = tmp_path_factory.mktemp("mesh_train")
    inp = dict(tree=_np_tree(params), dims=FIELDS, mel=mel, tokens=tokens, mask=mask,
               steps=STEPS, ckpt_dir=str(tmp / "ckpt"), six=dict(tree=_np_tree(six), dims=SIX))
    ranks, jax_out = run_world(4, "world_train", inp, str(tmp),
                               overlap=lambda: _jax_side(params, six, (mel, tokens, mask)))
    dims_of = M.param_shard_dims(L.params_from_jax_tree(inp["tree"], DIMS, device="cpu"))
    return ranks, jax_out, dims_of


def _slice(want: np.ndarray, name: str, dims, tp: int, tp_rank: int) -> np.ndarray:
    """tp rank ``tp_rank``'s slice of the whole leaf ``name``
    (``parallel.mesh.shard_slice``: its heads' columns, an even MLP cut)."""
    part, base = name.split(".", 1)
    return M.shard_slice(part, base, torch.from_numpy(want), dims, tp, tp_rank).numpy()


def _tp(mesh: str) -> int:
    return 4 if mesh == "six" else int(mesh.split("x")[1])


def _covered(ranks, mesh, dims_of):
    """(leaf name, tp rank, the rank's returned leaves) for every slice the
    ranks returned; fails unless they cover every trainable leaf."""
    rows = [(n, r[mesh]["tp_rank"], leaf) for r in ranks for n, leaf in r[mesh]["leaves"].items()]
    names = {n for n, _, _ in rows}
    assert names == set(_port_leaves(J.init_params(JDIMS, jax.random.PRNGKey(3))))
    for n in names:
        want = _tp(mesh) if dims_of[n] is not None else 1
        assert len([1 for m, _, _ in rows if m == n]) == want, n
    return rows


def _check_steps(got: dict, want: dict, unsure_from) -> None:
    """``got``'s three-step state (losses, moments, parameters) against
    ``want``'s, leaf by leaf (already sliced as ``got``)."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for n, leaf in got["leaves"].items():
        w = want["leaves"][n]
        for key, tol in (("mu", MU_TOL), ("nu", NU_TOL)):
            np.testing.assert_allclose(leaf[key], w[key], rtol=0,
                                       atol=tol * float(np.abs(w[key]).max()), err_msg=(n, key))
        unsure = np.zeros(leaf["param"].shape, bool)
        for g in unsure_from[n]:
            unsure |= np.abs(g) <= GRAD_TOL * float(np.abs(g).max())
        diff = np.abs(leaf["param"] - w["param"])
        limit = np.where(unsure, PARAM_TOL + STEPS * LR, PARAM_TOL)
        assert (diff <= limit).all(), (n, float(diff.max()), int(unsure.sum()))


@pytest.mark.parametrize("mesh", RUNS)
def test_loss_and_gradients_match_jax(world, mesh):
    """The first step's loss on every rank and the dp-summed gradient's
    slices against JAX's unsharded step on the whole batch (the 6-head
    model's also against JAX's tp=4 step)."""
    ranks, jax_out, dims_of = world
    for want in _wants(jax_out, mesh):
        for r in ranks:
            np.testing.assert_allclose(r[mesh]["losses"][0], want["losses"][0], rtol=1e-5)
        for n, tp_rank, leaf in _covered(ranks, mesh, dims_of):
            g = want["grads"][0][n]
            np.testing.assert_allclose(leaf["grad"], _slice(g, n, _dims(mesh), _tp(mesh), tp_rank),
                                       rtol=0, atol=GRAD_TOL * float(np.abs(g).max()),
                                       err_msg=(mesh, n))


@pytest.mark.parametrize("mesh", RUNS)
def test_three_steps_match_jax(world, mesh):
    """Three AdamW steps: the losses, each slice of the moments and the
    parameters against JAX's unsharded steps (the 6-head model's also
    against JAX's tp=4 steps)."""
    ranks, jax_out, dims_of = world
    tp = _tp(mesh)
    for want in _wants(jax_out, mesh):
        for r in ranks:
            t, leaves = r[mesh]["tp_rank"], r[mesh]["leaves"]
            cut = lambda x, n: _slice(x, n, _dims(mesh), tp, t)  # noqa: E731
            ref = {n: dict(param=cut(want["params"][n], n), mu=cut(want["mu"][n], n),
                           nu=cut(want["nu"][n], n)) for n in leaves}
            unsure = {n: [cut(g[n], n) for g in want["grads"]] for n in leaves}
            _check_steps(dict(losses=r[mesh]["losses"], leaves=leaves),
                         dict(losses=want["losses"], leaves=ref), unsure)
            assert r[mesh]["losses"][-1] < r[mesh]["losses"][0]


def _check_jax_sharded(one, sharded):
    for n, g in one["grads"][0].items():
        np.testing.assert_allclose(sharded["grads"][0][n], g, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(g).max()), err_msg=n)

    def steps(run):
        return dict(losses=run["losses"], leaves={
            n: dict(param=run["params"][n], mu=run["mu"][n], nu=run["nu"][n]) for n in run["params"]})

    _check_steps(steps(sharded), steps(one), {n: [g[n] for g in one["grads"]] for n in one["params"]})


def test_jax_sharded_step_matches_unsharded(world):
    """JAX's own dp=2 x tp=2 step, the yardstick of a sharded step, holds to
    JAX's unsharded step at the same tolerances."""
    _, jax_out, _ = world
    _check_jax_sharded(jax_out["one"], jax_out["mesh"])


def test_jax_head_splitting_step_matches_unsharded(world):
    """JAX's tp=4 step on the 6-head model, whose GSPMD cut of 96 columns a
    device splits heads 1 and 4 (the port's yardstick for the uneven deal),
    holds to JAX's unsharded step at the same tolerances."""
    _, jax_out, _ = world
    _check_jax_sharded(jax_out["six_one"], jax_out["six_mesh"])


@pytest.mark.parametrize("mesh", RUNS)
def test_ranks_stay_equal(world, mesh):
    """After the steps every rank returns the same losses bit for bit, every
    replicated parameter is bit-equal on all 4 ranks, and every shard on its
    dp replicas."""
    ranks, _, dims_of = world
    tp = _tp(mesh)
    for r in ranks:
        assert r[mesh]["losses"] == ranks[0][mesh]["losses"]
    for n, d in dims_of.items():
        if d is None or tp == 1:
            assert len({r[mesh]["digests"][n] for r in ranks}) == 1, n
        else:
            for t in range(tp):
                replicas = {r[mesh]["digests"][n] for r in ranks if r[mesh]["tp_rank"] == t}
                assert len(replicas) == 1, (n, t)
            assert len({r[mesh]["digests"][n] for r in ranks}) == tp, n


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_loss_is_the_global_masked_mean(world, mesh):
    """On dp > 1 the loss is the whole batch's masked mean (JAX's, to rtol
    1e-5), not the mean of the dp blocks' own means, which the unequal
    masks move more than 50 times that tolerance away from it."""
    ranks, jax_out, _ = world
    want = jax_out["one"]["losses"][0]
    own = {r[mesh]["dp_rank"]: r[mesh]["own_mean"] for r in ranks}
    assert len(own) == int(mesh.split("x")[0])
    mean_of_means = float(np.mean(list(own.values())))
    assert abs(mean_of_means - want) > 50 * 1e-5 * want
    for r in ranks:
        np.testing.assert_allclose(r[mesh]["losses"][0], want, rtol=1e-5)


@pytest.mark.parametrize("mesh", RUNS)
def test_flash_function_runs_on_the_rank_heads(world, mesh):
    """Each step's encoder attention runs ``FlashAttentionFn`` once a layer
    on the rank's heads: 4 // tp, and 2, 2, 1, 1 of the 6-head model."""
    ranks, _, _ = world
    deal = M.head_deal(_dims(mesh).n_audio_head, _tp(mesh))
    for r in ranks:
        assert r[mesh]["flash_heads"] == [deal[r[mesh]["tp_rank"]]]
        assert r[mesh]["flash_calls"] == FIELDS["n_audio_layer"]


@pytest.mark.parametrize("mesh", RUNS)
def test_backward_is_deterministic_under_tp(world, mesh):
    """With tp > 1 each rank computes the replicated gradients itself, so
    the backward runs with cuDNN's deterministic algorithms (on the card
    conv1's weight gradient differs run to run without them), and the flag
    is restored after the step; with tp = 1 it is left alone."""
    ranks, _, _ = world
    for r in ranks:
        during, after = r[mesh]["cudnn_deterministic"]
        assert during == [_tp(mesh) > 1] * STEPS and after is False


@pytest.mark.parametrize("mesh", RUNS)
def test_training_a_shard_leaves_the_callers_model(world, mesh):
    """``shard_params`` copies the replicated parameters: after the steps
    the unsharded model it was given is unchanged bit for bit."""
    ranks, _, _ = world
    assert all(r[mesh]["caller_unchanged"] for r in ranks)


def _check_checkpoints(ranks, run: str, way: str) -> None:
    for r in ranks:
        ck = r[run]["checkpoint"]
        assert ck[f"{way}_equal"] and ck[f"{way}_step"] == STEPS
        gap = ck[way]
        np.testing.assert_allclose(gap["loss"], gap["other_loss"], rtol=1e-5)
        assert gap["clear"] <= PARAM_TOL and gap["unsure"] <= PARAM_TOL + LR, gap


@pytest.mark.parametrize("way", ["mesh_to_one", "one_to_mesh"])
def test_checkpoints_cross_mesh_and_one_card(world, way):
    """A checkpoint written on dp=2 x tp=2 loads on one card, and one written
    on one card loads on the mesh: the loaded state equals the saved one
    bit for bit (each rank's slices), and the next step on the loaded side
    agrees with the next step of the saved side (the loss to rtol 1e-5, the
    parameters as after three steps, one step of lr where the gradient is
    within 1e-4 of its leaf's max of 0)."""
    _check_checkpoints(world[0], "2x2", way)


@pytest.mark.parametrize("way", ["mesh_to_one", "one_to_mesh"])
def test_checkpoints_cross_uneven_mesh_and_one_card(world, way):
    """The same crossings between the 6-head model's tp=4 mesh (heads 2, 2,
    1, 1: the gathered q/k/v/o parts of unequal widths, each rank's
    ``shard_slice`` on loading) and one card."""
    _check_checkpoints(world[0], "six", way)


def test_sum_over_dp_buckets(world):
    """``sum_over_dp`` on dp=4 with 32-byte buckets (each tensor alone, a
    strided one through a flat copy, a float64 one in its own bucket):
    every element is the 4 ranks' sum, in place, in each tensor's dtype."""
    ranks, _, _ = world
    for r in ranks:
        got = r["4x1"]["sum_over_dp"]
        assert [a.shape for a, _ in got] == [(5,), (4, 3), (7,), (2,)]
        assert [f64 for _, f64 in got] == [False, False, True, False]
        assert all((a == 10.0).all() for a, _ in got)


def test_refusals(world):
    """A mesh that is not a ("dp", "tp") DeviceMesh raises ``TypeError``; a
    model not sharded for the mesh (unsharded on dp=2 x tp=2, sharded for
    tp=2 on tp=4) raises ``ValueError`` from ``init_state``."""
    ranks, _, _ = world
    with pytest.raises(TypeError, match="DeviceMesh"):
        T.make_train_step(DIMS, mesh=object())
    for r in ranks:
        assert "tp=1" in r["2x2"]["unsharded_refusal"] and "tp=2" in r["2x2"]["unsharded_refusal"]
        assert "tp=2" in r["1x4"]["other_tp_refusal"] and "tp=4" in r["1x4"]["other_tp_refusal"]
