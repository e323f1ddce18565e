"""Rank workers of the port's mesh tests (``test_torch_mesh*.py``).

``run_world`` spawns a gloo world of n CPU processes (start method
``spawn``, a ``file://`` store under the test's temporary directory, so
that parallel test workers never share a port), runs one of this module's
``world_*`` functions in every rank with the pickled inputs the test wrote,
and returns each rank's pickled result. A rank's exception fails the spawn
and so the test. This module imports neither JAX nor the JAX package, so
the ranks start fast; the tests compute JAX's side in their own process.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import pickle

import numpy as np

WORLD_TIMEOUT_S = 240


def run_world(n: int, fn_name: str, inputs: dict, tmp_dir: str, overlap=None):
    """Run ``fn_name(rank, inputs)`` in n ranks; returns the ranks' results
    in rank order. ``overlap``, a zero-argument function, runs in this
    process while the ranks work; its result comes back second."""
    import torch.multiprocessing as mp

    with open(os.path.join(tmp_dir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    ctx = mp.spawn(_rank_main, args=(n, fn_name, tmp_dir), nprocs=n, join=False)
    extra = overlap() if overlap is not None else None
    while not ctx.join(timeout=WORLD_TIMEOUT_S):
        pass
    results = []
    for r in range(n):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results, extra


def _rank_main(rank: int, n: int, fn_name: str, tmp_dir: str) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp_dir, "store"),
                            world_size=n, rank=rank)
    try:
        with open(os.path.join(tmp_dir, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        out = globals()[fn_name](rank, inputs)
        with open(os.path.join(tmp_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _tok():
    from whisper_timestamped_tpu_torch.tokenizer import get_tokenizer, synthetic_ranks

    return get_tokenizer(ranks=synthetic_ranks(), multilingual=True, num_languages=99,
                         language="en", task="transcribe")


def _model(tree, dims: dict, heads=None):
    from whisper_timestamped_tpu_torch.models import WhisperDims, WhisperModel, params_from_jax_tree

    module = params_from_jax_tree(tree, WhisperDims(**dims), device="cpu")
    return WhisperModel(module=module, alignment_heads=heads)


def _window(r) -> dict:
    return dict(tokens=list(r.tokens), token_logprobs=np.asarray(r.token_logprobs),
                attn=None if r.attn is None else np.asarray(r.attn))


def world_mesh(rank: int, inp: dict) -> dict:
    """test_torch_mesh.py's checks on a 4-rank world."""
    import torch

    from whisper_timestamped_tpu_torch.decoding import DecodingOptions
    from whisper_timestamped_tpu_torch.engine import DecodeEngine
    from whisper_timestamped_tpu_torch.models.whisper_torch import decode_full, encode, init_cache
    from whisper_timestamped_tpu_torch.ops.quant import quantize_rows
    from whisper_timestamped_tpu_torch.parallel.mesh import get_mesh, shard_params

    out: dict = {}
    meshes = {tp: get_mesh(dp=4 // tp, tp=tp, device_type="cpu") for tp in (2, 4)}

    # (b) the forward at tp=2 and tp=4, with the alignment rows and all heads' scores
    fwd = _model(inp["fwd_tree"], inp["fwd_dims"])
    mel, tokens = torch.from_numpy(inp["fwd_mel"]), torch.from_numpy(inp["fwd_tokens"]).long()
    heads = [(0, 1), (1, 3), (1, 0)]
    with torch.no_grad():
        _, rows_one = decode_full(fwd.module, tokens, encode(fwd.module, mel), align_heads=heads)
        _, scores_one = decode_full(fwd.module, tokens, encode(fwd.module, mel),
                                    return_cross_attn=True)
        for tp, mesh in meshes.items():
            m = shard_params(fwd, mesh).module
            xa = encode(m, mel)
            logits, rows = decode_full(m, tokens, xa, align_heads=heads)
            _, scores = decode_full(m, tokens, xa, return_cross_attn=True)
            out[f"fwd_tp{tp}"] = dict(
                logits=logits.numpy(), heads_local=m.decoder["attn_q_w"].shape[1] // 16,
                rows_err=(rows - rows_one).abs().max().item(),
                scores_err=(scores - scores_one).abs().max().item())

    # (c) greedy decode_window on DecodeEngine(mesh=) at tp=2 and 4
    model = _model(inp["tree"], inp["dims"], inp["heads"])
    tok = _tok()
    mel = torch.from_numpy(inp["mel"])
    opts = DecodingOptions(language="en", sample_len=inp["sample_len"])
    for tp, mesh in meshes.items():
        engine = DecodeEngine(model, tok, mesh=mesh)
        out[f"greedy_tp{tp}"] = dict(_window(engine.decode_window(mel, opts)[0]), tp=engine.tp)

    # (d) kv_int8 and self_kv_int8 at tp=2; the scales against the unsharded quantizer
    for lever in ("kv_int8", "self_kv_int8"):
        engine = DecodeEngine(model, tok, mesh=meshes[2], **{lever: True})
        out[lever] = _window(engine.decode_window(mel, opts)[0])
    sharded = shard_params(model, meshes[2]).module
    tp = sharded.tensor_parallel
    xa = torch.from_numpy(inp["xa"])
    with torch.no_grad():
        mine = init_cache(sharded, xa, ctx_len=16, quantize_cross=True)
        one = init_cache(model.module, xa, ctx_len=16, quantize_cross=True)
        x = torch.from_numpy(inp["rows"])
        D = x.shape[-1] // tp.size
        q_local, s_local = quantize_rows(x[..., tp.rank * D:(tp.rank + 1) * D], tp)
        q_full, s_full = quantize_rows(x)
        gathered = tp.gather(mine.xk.float())
    out["scales"] = dict(
        cross_equal=torch.equal(mine.xk_scale, one.xk_scale)
        and torch.equal(mine.xv_scale, one.xv_scale),
        cross_codes_flips=(gathered != one.xk.float()).sum().item(),
        rows_scales_equal=torch.equal(s_local, s_full),
        rows_codes_equal=torch.equal(q_local, q_full[..., tp.rank * D:(tp.rank + 1) * D]))

    # (e) beam 5 at tp=2
    engine = DecodeEngine(model, tok, mesh=meshes[2])
    beam = engine.decode_window_beam(mel, DecodingOptions(language="en", beam_size=5,
                                                          sample_len=inp["sample_len"]))
    out["beam"] = dict(tokens=list(beam.tokens), avg_logprob=beam.avg_logprob)

    # shard_batch / place_batch over dp=2 (the tp=2 mesh)
    from whisper_timestamped_tpu_torch.parallel.mesh import place_batch, shard_batch

    tree = {"x": torch.arange(8).reshape(4, 2), "y": [np.arange(6), torch.tensor(3.0)]}
    out["shard_batch"] = shard_batch(tree, meshes[2])
    out["place_batch"] = place_batch({"x": torch.arange(4), "odd": np.arange(3)}, meshes[2])
    try:
        shard_batch(np.arange(3), meshes[2])
        out["shard_odd"] = None
    except ValueError as e:
        out["shard_odd"] = str(e)

    # (f) tp=3 does not divide 4 heads
    mesh3 = get_mesh(dp=1, tp=3, device_type="cpu")
    try:
        shard_params(model, mesh3)
        out["tp3"] = None
    except ValueError as e:
        out["tp3"] = str(e)
    return out


def world_batch(rank: int, inp: dict) -> dict:
    """test_torch_mesh_batch.py's checks on a 4-rank world (dp=2 x tp=2, then
    dp=2 x tp=1 on ranks 0 and 1)."""
    from whisper_timestamped_tpu_torch.engine import DecodeEngine
    from whisper_timestamped_tpu_torch.parallel import batch as B
    from whisper_timestamped_tpu_torch.parallel.mesh import get_mesh
    from whisper_timestamped_tpu_torch.utils import get_counts, get_stage_timings, reset_stage_timings

    out: dict = {}
    model = _model(inp["tree"], inp["dims"], inp["heads"])
    tok = _tok()
    kw = inp["kw"]
    mesh = get_mesh(dp=2, tp=2, device_type="cpu")
    engine = DecodeEngine(model, tok, mesh=mesh)
    bt = B.BatchTranscriber(engine, batch_size=2)
    segs = bt.transcribe_streams(inp["audios"], **kw)
    out["streams"] = {n: [(s.tokens, s.start, s.end, s.window is None) for s in v]
                      for n, v in segs.items()}
    out["stream_meta"] = bt.stream_meta

    bkw = dict(kw, batch_size=2)
    out["stream"] = list(B.transcribe_batch_stream(model, iter(inp["batches"]), tok,
                                                   engine=engine, **bkw))
    out["per_batch"] = [B.transcribe_batch(model, b, tok, engine=engine, **bkw)
                        for b in inp["batches"]]

    mesh_dp = get_mesh(dp=2, tp=1, device_type="cpu")  # ranks 0 and 1
    if rank < 2:
        one = DecodeEngine(model, tok)
        bt = B.BatchTranscriber(one, batch_size=8, mesh=mesh_dp)
        reset_stage_timings()
        before = get_counts().get("tp_eager_chunks", 0)
        segs = bt.transcribe_streams(inp["dp_audios"], **kw)
        out["dp"] = dict(
            attached=one.mesh is mesh_dp and one.tp == 1,
            flow="devflow_dispatch" in get_stage_timings(),
            eager=get_counts().get("tp_eager_chunks", 0) - before,
            names=list(segs), streams={n: [s.tokens for s in v] for n, v in segs.items()})
    return out


TRAIN_MESHES = ((1, 4), (2, 2), (4, 1))  # (dp, tp) of test_torch_mesh_train.py


def _digest(t) -> str:
    return hashlib.sha1(t.detach().contiguous().numpy().tobytes()).hexdigest()


def _train_setup(inp: dict):
    """(dims, the batch as tensors, a fresh one-card model of the test's weights)."""
    import torch

    from whisper_timestamped_tpu_torch.models import WhisperDims, params_from_jax_tree

    dims = WhisperDims(**inp["dims"])
    batch = (torch.from_numpy(inp["mel"]), torch.from_numpy(inp["tokens"]).long(),
             torch.from_numpy(inp["mask"]))
    return dims, batch, lambda: params_from_jax_tree(inp["tree"], dims, device="cpu")


def _slice(full, d, tp):
    """The rank's slice of a whole tensor: along ``d`` for a sharded leaf."""
    if d is None or tp is None:
        return full
    m = full.shape[d] // tp.size
    return full.narrow(d, tp.rank * m, m)


def _step_gap(mine, other, tp, dims_of) -> dict:
    """One step taken on both sides of a checkpoint round trip: the losses
    and the largest parameter differences, where the gradient is clear of 0
    (limit 1e-6) and where it lies within 1e-4 of its leaf's max of 0
    (limit 1e-6 + one step of lr: Adam's step may take the other sign)."""
    (m_state, m_loss), (o_state, o_loss) = mine, other
    o_params = dict(o_state.params.named_parameters())
    clear = unsure = 0.0
    for n, p in m_state.params.named_parameters():
        if p.grad is None:
            continue
        diff = (p.detach() - _slice(o_params[n].detach(), dims_of[n], tp)).abs()
        near0 = p.grad.abs() <= 1e-4 * float(p.grad.abs().max())
        clear = max(clear, float(diff[~near0].max()) if (~near0).any() else 0.0)
        unsure = max(unsure, float(diff[near0].max()) if near0.any() else 0.0)
    return dict(loss=m_loss.item(), other_loss=o_loss.item(), clear=clear, unsure=unsure)


def _state_equal(state, whole, tp, dims_of) -> bool:
    """Each parameter and AdamW moment of the sharded ``state`` equals the
    rank's slice of the one-card ``whole``'s, bit for bit."""
    import torch

    w_params = dict(whole.params.named_parameters())
    for n, p in state.params.named_parameters():
        q = w_params[n]
        if not torch.equal(p, _slice(q, dims_of[n], tp)):
            return False
        if p.requires_grad:
            a, b = state.opt_state.state[p], whole.opt_state.state[q]
            if not all(torch.equal(a[k], _slice(b[k], dims_of[n], tp))
                       for k in ("exp_avg", "exp_avg_sq")) or not torch.equal(a["step"], b["step"]):
                return False
    return True


def world_train(rank: int, inp: dict) -> dict:
    """test_torch_mesh_train.py's checks on a 4-rank world: ``steps`` AdamW
    steps on each mesh of ``TRAIN_MESHES``, the checkpoints across the
    dp=2 x tp=2 mesh and one card, the refusals."""
    import torch
    import torch.distributed as dist

    from whisper_timestamped_tpu_torch import training as T
    from whisper_timestamped_tpu_torch.ops import kernels as K
    from whisper_timestamped_tpu_torch.parallel import mesh as mesh_module
    from whisper_timestamped_tpu_torch.parallel.mesh import (get_mesh, mesh_rank, param_shard_dims,
                                                              shard_batch, shard_params, sum_over_dp)

    dims, batch, fresh = _train_setup(inp)
    heads = []
    fwd = K.flash_attention_fwd

    def counted_fwd(q, k, v, n_head):
        heads.append(n_head)
        return fwd(q, k, v, n_head)

    K.flash_attention_fwd = counted_fwd
    out: dict = {}
    for dp, tp_size in TRAIN_MESHES:
        mesh = get_mesh(dp=dp, tp=tp_size, device_type="cpu")
        base = fresh()
        before = {n: p.detach().clone() for n, p in base.named_parameters()}
        model = shard_params(base, mesh)
        init_state, train_step = T.make_train_step(dims, mesh=mesh)
        state = init_state(model)
        tp = state.params.tensor_parallel
        dims_of = param_shard_dims(state.params)
        mine = shard_batch(batch, mesh)
        with torch.no_grad():  # this rank's rows' own masked mean, at the first weights
            own_mean = T.teacher_forced_loss(state.params, *mine).item()
        del heads[:]
        deterministic = []  # cuDNN's flag while conv1's weight gradient is computed
        state.params.encoder["conv1_w"].register_hook(
            lambda g: deterministic.append(torch.backends.cudnn.deterministic))
        losses, grads = [], {}
        for i in range(inp["steps"]):
            state, loss = train_step(state, *mine)
            losses.append(loss.item())
            if i == 0:
                grads = {n: p.grad.clone() for n, p in state.params.named_parameters()
                         if p.grad is not None}
        named = dict(state.params.named_parameters())
        # the first dp row returns its slices of the sharded leaves, its tp rank 0 the rest
        first_row, tp_rank = mesh_rank(mesh, "dp") == 0, mesh_rank(mesh, "tp")
        keep = [n for n in grads
                if first_row and (tp_rank == 0 or (tp is not None and dims_of[n] is not None))]
        res = dict(
            losses=losses, own_mean=own_mean, tp_rank=tp_rank, dp_rank=mesh_rank(mesh, "dp"),
            flash_heads=sorted(set(heads)),
            flash_calls=len(heads) // inp["steps"],
            cudnn_deterministic=(list(deterministic), torch.backends.cudnn.deterministic),
            caller_unchanged=all(torch.equal(before[n], p) for n, p in base.named_parameters()),
            digests={n: _digest(p) for n, p in named.items()},
            # copies: the checkpoints' steps below go on updating these tensors in place
            leaves={n: dict(grad=grads[n].numpy(), param=named[n].detach().numpy().copy(),
                            mu=state.opt_state.state[named[n]]["exp_avg"].numpy().copy(),
                            nu=state.opt_state.state[named[n]]["exp_avg_sq"].numpy().copy())
                    for n in keep})
        if (dp, tp_size) == (2, 2):
            res["checkpoint"] = _checkpoints(rank, inp, state, train_step, mine, batch, dims,
                                              fresh, tp, dims_of, mesh)
            try:
                init_state(fresh())
                res["unsharded_refusal"] = None
            except ValueError as e:
                res["unsharded_refusal"] = str(e)
        if (dp, tp_size) == (4, 1):  # sum_over_dp's buckets: split by size and dtype, one strided
            parts = [torch.full((5,), rank + 1.0), torch.full((3, 4), rank + 1.0).t(),
                     torch.full((7,), rank + 1.0, dtype=torch.float64), torch.full((2,), rank + 1.0)]
            bucket, mesh_module.GRAD_BUCKET_BYTES = mesh_module.GRAD_BUCKET_BYTES, 32
            try:
                sum_over_dp(parts, mesh)
            finally:
                mesh_module.GRAD_BUCKET_BYTES = bucket
            res["sum_over_dp"] = [(t.numpy().copy(), t.dtype == torch.float64) for t in parts]
        if (dp, tp_size) == (1, 4):
            try:
                init_state(shard_params(fresh(), get_mesh(dp=2, tp=2, device_type="cpu")))
                res["other_tp_refusal"] = None
            except ValueError as e:
                res["other_tp_refusal"] = str(e)
        out[f"{dp}x{tp_size}"] = res
        dist.barrier()
    return out


def _checkpoints(rank, inp, state, train_step, mine, batch, dims, fresh, tp, dims_of, mesh):
    """Save on the mesh and load on one card, then the reverse; each side
    then takes one more step."""
    import torch.distributed as dist

    from whisper_timestamped_tpu_torch import training as T
    from whisper_timestamped_tpu_torch.parallel.mesh import shard_params

    init_one, step_one = T.make_train_step(dims)
    init_mesh, _ = T.make_train_step(dims, mesh=mesh)
    mesh_dir, one_dir = (os.path.join(inp["ckpt_dir"], d) for d in ("mesh", "one"))

    # the mesh's state -> file -> one card
    T.save_checkpoint(mesh_dir, state)
    loaded_one = T.load_checkpoint(mesh_dir, init_one(fresh()))
    out = dict(mesh_to_one_equal=_state_equal(state, loaded_one, tp, dims_of),
               mesh_to_one_step=loaded_one.step)
    out["mesh_to_one"] = _step_gap(train_step(state, *mine), step_one(loaded_one, *batch),
                                   tp, dims_of)

    # one card's state -> file -> the mesh (every rank runs the same one-card steps)
    one = init_one(fresh())
    for _ in range(inp["steps"]):
        one, _ = step_one(one, *batch)
    if rank == 0:
        T.save_checkpoint(one_dir, one)
    dist.barrier()
    loaded_mesh = T.load_checkpoint(one_dir, init_mesh(shard_params(fresh(), mesh)))
    out.update(one_to_mesh_equal=_state_equal(loaded_mesh, one, tp, dims_of),
               one_to_mesh_step=loaded_mesh.step)
    out["one_to_mesh"] = _step_gap(train_step(loaded_mesh, *mine), step_one(one, *batch),
                                   tp, dims_of)
    return out


@contextlib.contextmanager
def one_rank_mesh(tmp_dir: str):
    """A one-rank gloo world in this process with its (1, 1) CPU mesh,
    destroyed on exit."""
    import torch.distributed as dist

    from whisper_timestamped_tpu_torch.parallel.mesh import get_mesh

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp_dir, "store1"),
                            world_size=1, rank=0)
    try:
        yield get_mesh(dp=1, tp=1, device_type="cpu")
    finally:
        dist.destroy_process_group()
