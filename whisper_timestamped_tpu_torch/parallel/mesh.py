"""Device meshes and Megatron-style sharding on ``torch.distributed``.

Port of ``whisper_timestamped_tpu/parallel/mesh.py``. The JAX package places
sharded arrays on a ``jax.sharding.Mesh`` and lets GSPMD insert the
collectives; here the execution model is torch's own: one process (rank) per
device, started by ``torchrun`` (or ``torch.multiprocessing``), every rank
calling the same entry point with the same arguments and returning the same
result. The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
axes ("dp", "tp") over the default process group.

Sharding rules (the layer-stacked parameters of ``models.whisper_torch``,
linears ``(L, out, in)``; JAX's ``(L, in, out)`` "tp" at axis 2 is axis 1
here, and its axis 1 is axis 2):

  * attention q/k/v weights and biases: the output (head) axis over ``tp``;
    the o projection: its input axis;
  * MLP fc1: the output axis; fc2: the input axis;
  * the o and fc2 biases, embeddings, layer norms and convolutions:
    replicated.

A rank's model holds whole heads, so its attentions, and the decode kernels
that run them, are complete locally. ``head_deal`` deals a stack's ``H``
heads over ``tp`` ranks in contiguous runs, ``H // tp`` a rank and one more
to each of the first ``H % tp`` (tiny's 6 heads at tp=4: 2, 2, 1, 1;
large-v3's 20 at tp=8: 3, 3, 3, 3, 2, 2, 2, 2): the q/k/v columns and the o
rows of a rank are its heads' (``shard_slice``), where JAX's GSPMD cuts the
same axes evenly and may split a head; both compute the same sum over heads
in the o product, in another order. The MLP keeps the even cut. The forward
sums the o and fc2 products over ``tp`` (``TensorParallel.sum_``) and adds
the replicated bias once, after the sum. Data parallelism splits
the streams of a batch over ``dp`` (``parallel.batch``); each dp rank runs
the one-card pipeline on its own streams and the results are gathered
(``gather_streams``).

Training (``training.make_train_step(mesh=)``) is Megatron's form of the
same cut: under autograd the sum after o / fc2 is ``reduce_from`` (a sum
forward, the identity backward) and the input of every column-parallel
linear passes ``copy_to`` (the identity forward, the gradient summed over
``tp`` backward), so the replicated activations and parameters get their
whole gradient on every tp rank; ``sum_over_dp`` sums the gradients
over ``dp``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

AXES = ("dp", "tp")

# the block parameters sharded over tp, by name without the "attn_" /
# "cross_" prefix, and the axis: 1 the output axis, 2 the input axis
_SHARD_DIM = {"q_w": 1, "q_b": 1, "k_w": 1, "v_w": 1, "v_b": 1, "fc1_w": 1, "fc1_b": 1,
              "o_w": 2, "fc2_w": 2}
_MLP = ("fc1_w", "fc1_b", "fc2_w")  # cut evenly; the attention's by the head deal


def rank_heads(n_head: int, tp: int, rank: int) -> Tuple[int, int]:
    """(first head, heads) of ``rank``'s contiguous run of a stack of
    ``n_head`` heads dealt over ``tp`` ranks: ``n_head // tp`` heads, one
    more on each of the first ``n_head % tp`` ranks."""
    base, extra = divmod(n_head, tp)
    return rank * base + min(rank, extra), base + (rank < extra)


def head_deal(n_head: int, tp: int) -> List[int]:
    """The heads each of ``tp`` ranks holds, in rank order (``rank_heads``)."""
    return [rank_heads(n_head, tp, r)[1] for r in range(tp)]


def get_mesh(dp: Optional[int] = None, tp: int = 1, device_type: str = "cuda",
             axis_names=AXES):
    """A (dp, tp) ``DeviceMesh`` over the initialized default process group
    (dp inferred as world // tp if None). ``device_type`` "cuda" (the
    default) first makes ``cuda:{LOCAL_RANK % device_count}`` this rank's
    device (the global rank when ``LOCAL_RANK`` is unset), so that two ranks
    on a one-card machine share ``cuda:0``; it raises without CUDA. The CPU
    tests pass "cpu". The port's entry points take the default
    ``axis_names`` only (``check_mesh``)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "get_mesh: torch.distributed is not initialized: start the program under torchrun "
            "(each rank calling torch.distributed.init_process_group('nccl')) or call "
            "torch.distributed.init_process_group yourself first")
    n = dist.get_world_size()
    if dp is None:
        if n % tp:
            raise ValueError(f"{n} devices not divisible by tp={tp}")
        dp = n // tp
    if dp * tp > n:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} devices, have {n}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("get_mesh: no CUDA device; pass device_type='cpu' for a CPU mesh")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dp, tp), mesh_dim_names=tuple(axis_names))


def check_mesh(mesh) -> None:
    """Raise ``TypeError`` unless ``mesh`` is a ``DeviceMesh`` with the
    ("dp", "tp") axes of ``get_mesh``."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or tuple(mesh.mesh_dim_names or ()) != AXES:
        raise TypeError(f"mesh must be a DeviceMesh with axes {AXES} (get_mesh), got {mesh!r}")


def mesh_size(mesh, axis: str) -> int:
    """The mesh's extent along ``axis``; 1 without a mesh."""
    return 1 if mesh is None else mesh.size(AXES.index(axis))


def mesh_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``; 0 without a mesh."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def _all_reduce_(t: torch.Tensor, group, via_host: bool, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group`` in place; returns ``t``. ``via_host``
    (the group is gloo's): a CUDA tensor is reduced through a host copy
    (gloo's collectives run on the host; NCCL refuses two ranks on one
    card, which gloo serves)."""
    if via_host and t.is_cuda:
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        return t.copy_(host)
    dist.all_reduce(t, op=op, group=group)
    return t


class TensorParallel:
    """This rank's share of a tensor-parallel model: its place in the
    ``tp`` group and the collectives the sharded forward calls
    (``models.whisper_torch``), through a host copy on gloo (``via_host``),
    which a CUDA graph cannot hold: the token loops run eagerly there, and
    capture NCCL's collectives with their steps (``decoding.DecodeGraphs``)."""

    def __init__(self, mesh):
        self.size = mesh_size(mesh, "tp")
        self.rank = mesh_rank(mesh, "tp")
        self.group = mesh.get_group("tp")
        self.via_host = dist.get_backend(self.group) == "gloo"

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the tp ranks, in place; returns ``t``."""
        return _all_reduce_(t, self.group, self.via_host)

    def max_(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s elementwise max over the tp ranks, in place; returns ``t``."""
        return _all_reduce_(t, self.group, self.via_host, dist.ReduceOp.MAX)

    def summed(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the tp ranks into a new tensor; ``t`` is left as it is."""
        return self.sum_(t.clone(memory_format=torch.contiguous_format))

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` entering the rank's columns (the input of q/k/v or fc1):
        itself forward; where autograd tracks it, its gradient, a partial
        sum over this rank's columns, is summed over tp backward."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _CopyToTensorParallel.apply(x, self)
        return x

    def reduce_from(self, x: torch.Tensor) -> torch.Tensor:
        """The o / fc2 partial product ``x`` summed over tp. Where autograd
        tracks it, out of place with the identity backward (every rank
        holds the whole gradient of the sum); otherwise ``sum_`` in place."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _ReduceFromTensorParallel.apply(x, self)
        return self.sum_(x)

    def gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The tp ranks' ``t`` concatenated along ``dim`` in rank order. The
        ranks' extents along ``dim`` may differ (an uneven head deal): each
        part is padded to the largest for ``all_gather``, which takes equal
        sizes, and the padding dropped."""
        src = t.cpu() if self.via_host and t.is_cuda else t.contiguous()
        dim = dim % src.dim()
        sizes = [torch.zeros((1,), dtype=torch.int64, device=src.device) for _ in range(self.size)]
        dist.all_gather(sizes, torch.tensor([src.shape[dim]], device=src.device), group=self.group)
        sizes = [int(n) for n in sizes]
        pad = max(sizes) - src.shape[dim]
        if pad:
            src = torch.cat([src, src.new_zeros((*src.shape[:dim], pad, *src.shape[dim + 1:]))],
                            dim=dim)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)], dim=dim).to(t.device)


class _CopyToTensorParallel(torch.autograd.Function):
    """The identity forward, the gradient summed over tp backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.summed(grad), None


class _ReduceFromTensorParallel(torch.autograd.Function):
    """The sum over tp forward (out of place), the identity backward."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.summed(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


GRAD_BUCKET_BYTES = 256 << 20  # the most one flat buffer of sum_over_dp packs


def sum_over_dp(tensors: List[torch.Tensor], mesh) -> None:
    """Sum each of ``tensors`` over the mesh's dp axis, in place. Runs of
    tensors of one dtype and device are packed into flat buffers of at most
    ``GRAD_BUCKET_BYTES`` (a larger tensor goes alone), one collective a
    buffer, through a host copy on gloo. Every rank of the axis passes
    tensors of the same shapes in the same order."""
    if mesh_size(mesh, "dp") == 1:
        return
    group = mesh.get_group("dp")
    via_host = dist.get_backend(group) == "gloo"

    def reduce(bucket):
        if len(bucket) == 1 and bucket[0].is_contiguous():
            _all_reduce_(bucket[0], group, via_host)  # alone: reduced where it lies
            return
        flat = torch.cat([t.reshape(-1) for t in bucket])
        _all_reduce_(flat, group, via_host)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))

    bucket: List[torch.Tensor] = []
    size = 0
    for t in tensors:
        if bucket and (t.dtype != bucket[0].dtype or t.device != bucket[0].device
                       or size + t.nbytes > GRAD_BUCKET_BYTES):
            reduce(bucket)
            bucket, size = [], 0
        bucket.append(t)
        size += t.nbytes
    if bucket:
        reduce(bucket)


def _shard_dim(name: str) -> Optional[int]:
    base = name.split("_", 1)[1] if name.startswith(("attn_", "cross_")) else name
    return _SHARD_DIM.get(base)


def check_tp(dims, n_mlp: Tuple[int, int], tp: int) -> None:
    """Raise ``ValueError`` unless ``tp`` ranks can each hold whole heads of
    both stacks (tp at most either head count) and an even cut of both MLP
    widths ``n_mlp`` (encoder, decoder)."""
    if tp > min(dims.n_audio_head, dims.n_text_head):
        raise ValueError(f"tp={tp} exceeds a head count (n_audio_head={dims.n_audio_head}, "
                         f"n_text_head={dims.n_text_head}): a rank would hold no head")
    if any(n % tp for n in n_mlp):
        raise ValueError(f"tp={tp} must divide the MLP widths {n_mlp} (encoder, decoder): "
                         f"fc1 and fc2 are cut evenly")


def shard_slice(part: str, name: str, t: torch.Tensor, dims, tp: int, rank: int) -> torch.Tensor:
    """``rank``'s slice (a view) of the parameter ``part``.``name`` ("encoder"
    or "decoder"; a layer-stacked tensor or any tensor of its shape, such
    as an optimizer moment) among ``tp`` ranks: the columns of the rank's
    heads (``rank_heads``) for q/k/v and the o rows, an even cut of fc1 /
    fc2, the whole tensor for a replicated one."""
    d = _shard_dim(name)
    if d is None or tp == 1:
        return t
    if name in _MLP:
        m = t.shape[d] // tp
        return t.narrow(d, rank * m, m)
    n_head = dims.n_audio_head if part == "encoder" else dims.n_text_head
    dh = t.shape[d] // n_head
    first, count = rank_heads(n_head, tp, rank)
    return t.narrow(d, first * dh, count * dh)


def param_shard_dims(model) -> Dict[str, Optional[int]]:
    """``param_pspec_tree``'s counterpart: "encoder.<name>" / "decoder.<name>"
    -> the axis sharded over ``tp``, or None for a replicated parameter."""
    module = getattr(model, "module", model)
    return {f"{part}.{name}": _shard_dim(name)
            for part in ("encoder", "decoder")
            for name in getattr(module, part)}


def shard_params(model, mesh):
    """A new ``WhisperModel`` whose module holds this rank's slices of the
    tp-sharded parameters and copies of the replicated ones (so that the
    full tensors are not kept alive by it, and training the shard never
    writes into ``model``), with its ``TensorParallel`` (None at tp=1,
    where nothing is cut). ``model`` is a ``WhisperModel`` or a
    ``WhisperTorch``. A rank holds whole heads, dealt by ``head_deal``
    (unevenly where tp does not divide a head count; the JAX package's
    GSPMD splits a head there), and its slices are ``shard_slice``'s.
    Raises ``ValueError`` (``check_tp``) when tp exceeds a head count or
    does not divide an MLP width."""
    from ..models.load import WhisperModel
    from ..models.whisper_torch import WhisperTorch

    check_mesh(mesh)
    module = getattr(model, "module", model)
    dims = module.dims
    tp = mesh_size(mesh, "tp")
    dec = module.decoder
    n_mlp = (module.encoder["fc1_b"].shape[-1], dec["fc1_b"].shape[-1])
    check_tp(dims, n_mlp, tp)
    rank = mesh_rank(mesh, "tp")
    new = WhisperTorch(dims, device="meta", untied_proj="proj_w" in dec, n_mlp=n_mlp)
    for part in ("encoder", "decoder"):
        target = getattr(new, part)
        for name, t in getattr(module, part).items():
            t = shard_slice(part, name, t.detach(), dims, tp, rank)
            target[name] = nn.Parameter(t.clone(), requires_grad=False)
    new.fixed_pos_emb = module.fixed_pos_emb
    new.tensor_parallel = TensorParallel(mesh) if tp > 1 else None
    if not isinstance(model, WhisperModel):
        return WhisperModel(module=new)
    return WhisperModel(module=new, alignment_heads=model.alignment_heads,
                        model_name=model.model_name, tokenizer_ranks=model.tokenizer_ranks,
                        tokenizer_multilingual=model.tokenizer_multilingual)


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    return fn(tree) if hasattr(tree, "shape") else tree


def shard_batch(tree, mesh, axis: str = "dp"):
    """This rank's block of the leading (batch) axis of every tensor or
    array leaf of ``tree``: rows [r n / k, (r + 1) n / k) for coordinate r
    of k along ``axis`` (what a ``P(axis)`` sharding places on the
    device). Raises ``ValueError`` for a leading axis that k does not
    divide; 0-d leaves are replicated."""
    k, r = mesh_size(mesh, axis), mesh_rank(mesh, axis)

    def cut(x):
        if len(x.shape) == 0:
            return x
        if x.shape[0] % k:
            raise ValueError(f"shard_batch: leading axis {x.shape[0]} not divisible by {axis}={k}")
        m = x.shape[0] // k
        return x[r * m:(r + 1) * m]

    return _map_leaves(tree, cut)


def place_batch(tree, mesh, axis: str = "dp"):
    """Like ``shard_batch`` but tolerant: leaves whose leading axis is not
    divisible by the mesh axis are replicated (returned whole)."""
    k = mesh_size(mesh, axis)
    divisible = lambda x: len(x.shape) >= 1 and x.shape[0] % k == 0  # noqa: E731
    return _map_leaves(tree, lambda x: shard_batch(x, mesh, axis) if divisible(x) else x)


def gather_streams(part: Dict[str, Any], names: List[str], mesh) -> Dict[str, Any]:
    """The per-stream results of every dp rank (each rank's ``part`` holds
    its own streams; pickled: what the host reads, never device tensors),
    merged in the caller's order ``names``."""
    parts: List[Any] = [None] * mesh_size(mesh, "dp")
    dist.all_gather_object(parts, part, group=mesh.get_group("dp"))
    merged: Dict[str, Any] = {}
    for p in parts:
        merged.update(p)
    return {n: merged[n] for n in names}


def dp_streams(names: List[str], mesh) -> List[str]:
    """The streams this dp rank decodes: ``names[r::dp]``."""
    return list(names)[mesh_rank(mesh, "dp")::mesh_size(mesh, "dp")]
