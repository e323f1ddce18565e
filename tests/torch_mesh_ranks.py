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
