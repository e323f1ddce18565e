"""Fine-tuning: the teacher-forced loss and a train step under autograd.

Port of ``whisper_timestamped_tpu/training.py``. ``jax.value_and_grad`` and
optax become ``backward`` and a ``torch.optim`` optimizer. The encoder's
self-attention runs through ``ops.kernels.FlashAttentionFn``: on the card
the forward that keeps each row's log-sum-exp and the two backward kernels
(dQ, then dK/dV), on the CPU their plain versions. Everything else is
autograd's.

Training runs in the parameters' dtype, as in JAX: no mixed precision, no
gradient clipping, no schedule. The step updates the model in place, so
``TrainState.params`` is the same ``WhisperTorch`` before and after it.

On a ("dp", "tp") mesh (``parallel.get_mesh``) every rank calls the same
step on its shard of the model (``parallel.shard_params``) and its block of
the batch (``parallel.shard_batch``), as JAX's jitted step runs on the
sharded tree (``__graft_entry__.py:196-220``), in Megatron's form: the
sharded forward and backward sum over ``tp`` (``models.whisper_torch``),
the loss is the whole batch's masked mean (its mask count summed over
``dp``), the gradients are summed over ``dp`` after the backward, and
AdamW, elementwise, updates each shard where it lies. Every rank returns
the same loss, and the replicated parameters stay equal on every rank
(with tp > 1 the backward takes cuDNN's deterministic algorithms for it).

Checkpoints are ``torch.save`` files (the parameters, the optimizer's
``state_dict`` and the step in one file under a directory), not orbax's:
orbax is a JAX library, so the port neither writes nor reads orbax
checkpoints. On a mesh the file holds the whole (gathered) tensors, as
orbax writes global arrays: a one-card run and a mesh read each other's.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from .models.whisper_torch import WhisperDims, WhisperTorch, decode_full, encode
from .parallel.mesh import check_mesh, mesh_rank, mesh_size, param_shard_dims, sum_over_dp

CHECKPOINT_FILE = "train_state.pt"  # the file save_checkpoint writes under its directory


def teacher_forced_loss(model: WhisperTorch, mel: torch.Tensor, tokens: torch.Tensor,
                        loss_mask: torch.Tensor, mesh=None) -> torch.Tensor:
    """Mean next-token cross entropy over masked positions.

    mel (B, n_mels, T); tokens (B, S) int, full sequences with sot and eot;
    loss_mask (B, S) float, which positions contribute. Returns a 0-d f32
    tensor. On a ``mesh`` whose dp is more than 1 the rows are this rank's
    block of the batch, the mean's denominator is the whole batch's mask
    count (summed over dp), and the result is this rank's share of the
    whole batch's mean: the shares sum over dp to it, and so do their
    gradients."""
    xa = encode(model, mel)
    logits, _ = decode_full(model, tokens[:, :-1], xa)
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    mask = loss_mask[:, 1:].to(nll.dtype)
    count = mask.sum()
    if mesh_size(mesh, "dp") > 1:
        count = _summed_over_dp(count.detach(), mesh)
    return (nll * mask).sum() / torch.clamp(count, min=1.0)


def _summed_over_dp(t: torch.Tensor, mesh) -> torch.Tensor:
    t = t.clone()
    sum_over_dp([t], mesh)
    return t


class TrainState(NamedTuple):
    params: WhisperTorch
    opt_state: torch.optim.Optimizer
    step: int
    mesh: Any = None  # the mesh the state was made for (init_state's)


def adamw(params: List[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """The default optimizer: optax's ``adamw(1e-5)``. Its defaults are
    optax's (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every leaf),
    not torch's (weight decay 0.01); the update is the same
    p - lr * (m̂ / (sqrt(v̂) + eps) + wd * p)."""
    return torch.optim.AdamW(params, lr=1e-5, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def trainable_parameters(model: WhisperTorch) -> List[torch.nn.Parameter]:
    """Every parameter but a fixed-sinusoid encoder ``pos_emb``
    (``WhisperTorch.fixed_pos_emb``), in ``named_parameters`` order."""
    return [p for name, p in model.named_parameters()
            if not (model.fixed_pos_emb and name == "encoder.pos_emb")]


@contextlib.contextmanager
def _deterministic_cudnn(on: bool):
    """cuDNN's deterministic algorithms while ``on``. Every tp rank computes
    the replicated parameters' gradients itself, so they stay equal only if
    each is the same run to run; the convolutions' weight gradient is not
    by default on the card (cuDNN's backward-filter algorithms sum in an
    order that varies), and the ranks' conv1 weights would drift apart."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = saved or on
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def _check_sharded_for(module: WhisperTorch, mesh) -> None:
    """Raise ``ValueError`` unless ``module`` holds this rank's shard for
    ``mesh``'s tp (``parallel.shard_params``; unsharded at tp=1)."""
    tp = module.tensor_parallel
    have = (1, 0) if tp is None else (tp.size, tp.rank)
    want = (mesh_size(mesh, "tp"), mesh_rank(mesh, "tp"))
    if have != want:
        raise ValueError(f"the model is sharded for tp={have[0]} (rank {have[1]}), the mesh has "
                         f"tp={want[0]} (this rank {want[1]}): shard it with "
                         f"parallel.shard_params(model, mesh)")


def make_train_step(
    dims: WhisperDims,
    optimizer: Optional[Callable[[List[torch.nn.Parameter]], torch.optim.Optimizer]] = None,
    mesh=None,
):
    """Returns (init_state, train_step). ``optimizer`` builds the optimizer
    from the trainable parameters (default ``adamw``). ``train_step`` runs
    on the model's device (the inputs must be there) and does not wait for
    it: the loss comes back as a 0-d tensor.

    ``mesh``: a ("dp", "tp") ``DeviceMesh`` (``parallel.get_mesh``; else
    ``TypeError``). ``init_state`` then takes the rank's shard
    (``parallel.shard_params(model, mesh)``; a model sharded for another tp
    raises ``ValueError``, it is not re-sharded) and ``train_step`` the
    rank's block of the batch (``parallel.shard_batch``); see the module
    docstring. The returned loss is the whole batch's on every rank."""
    if mesh is not None:
        check_mesh(mesh)
    make_optimizer = optimizer or adamw

    def init_state(model) -> TrainState:
        model = getattr(model, "module", model)  # a WhisperModel, as shard_params returns
        if model.dims != dims:
            raise ValueError(f"the model's dims {model.dims} are not {dims}")
        if mesh is not None:
            _check_sharded_for(model, mesh)
        params = trainable_parameters(model)
        for p in params:
            p.requires_grad_(True)
        return TrainState(params=model, opt_state=make_optimizer(params), step=0, mesh=mesh)

    def train_step(state: TrainState, mel, tokens, loss_mask) -> Tuple[TrainState, torch.Tensor]:
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss = teacher_forced_loss(state.params, mel, tokens, loss_mask, mesh=mesh)
        with _deterministic_cudnn(mesh_size(mesh, "tp") > 1):
            loss.backward()
        loss = loss.detach()
        if mesh_size(mesh, "dp") > 1:
            grads = [p.grad for p in trainable_parameters(state.params) if p.grad is not None]
            sum_over_dp(grads, mesh)
            loss = _summed_over_dp(loss, mesh)  # the shares' sum: the whole batch's mean
        opt.step()
        return state._replace(step=state.step + 1), loss

    return init_state, train_step


_MOMENTS = ("exp_avg", "exp_avg_sq")  # AdamW's per-parameter state, shaped as the parameter


def _sharded(state: TrainState) -> Dict[str, int]:
    """Parameter name -> its axis cut over tp, for the state's sharded
    parameters (none without a mesh or at tp=1)."""
    if mesh_size(state.mesh, "tp") == 1:
        return {}
    return {n: d for n, d in param_shard_dims(state.params).items() if d is not None}


def _moment_owners(state: TrainState) -> Dict[int, str]:
    """The optimizer's parameter index (its ``state_dict``'s keys) -> name."""
    names = {id(p): n for n, p in state.params.named_parameters()}
    group_params = [p for g in state.opt_state.param_groups for p in g["params"]]
    return {i: names[id(p)] for i, p in enumerate(group_params)}


def _map_sharded(state: TrainState, params: dict, opt: dict, fn) -> None:
    """Replace each sharded parameter of the ``state_dict``s ``params`` /
    ``opt`` and its AdamW moments by ``fn(tensor, axis)``. A parameter's
    entry in ``opt["state"]`` is replaced by a new dict: the optimizer's
    ``state_dict`` hands out its live ones."""
    cut = _sharded(state)
    for name, d in cut.items():
        params[name] = fn(params[name], d)
    for i, name in _moment_owners(state).items():
        if name in cut and i in opt["state"]:
            entry = opt["state"][i]
            opt["state"][i] = {**entry, **{k: fn(entry[k], cut[name]) for k in _MOMENTS}}


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write the parameters, the optimizer's state and the step into the
    directory ``path`` (made if missing), replacing what a previous save
    left there, as JAX's ``force=True`` does for periodic saves to one path.

    On a mesh every rank calls it: each sharded parameter and its AdamW
    moments are gathered over tp (into host memory, one at a time on the
    device), global rank 0 writes the file a one-card run writes, and every
    rank waits for it at a barrier."""
    params, opt = state.params.state_dict(), state.opt_state.state_dict()
    tp = state.params.tensor_parallel
    _map_sharded(state, params, opt, lambda t, d: tp.gather(t, dim=d).cpu())
    if state.mesh is None or dist.get_rank() == 0:
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp")
        torch.save({"params": params, "opt_state": opt, "step": state.step}, tmp)
        os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))
    if state.mesh is not None:
        dist.barrier()


def load_checkpoint(path: str, template: TrainState) -> TrainState:
    """Restore a state written by ``save_checkpoint`` into ``template`` (a
    state from ``init_state`` on a model of the same dims and the same
    optimizer), read with ``torch.load(weights_only=True)``. On a mesh each
    rank reads the whole file and keeps its slices of the sharded
    parameters and their moments: a file written on one card or on any
    mesh loads on any other."""
    blob = torch.load(os.path.join(path, CHECKPOINT_FILE), map_location=template.params.device,
                      weights_only=True)
    tp = template.params.tensor_parallel

    def cut(t, d):  # a copy: the optimizer keeps the moments it is given
        m = t.shape[d] // tp.size
        return t.narrow(d, tp.rank * m, m).clone()

    _map_sharded(template, blob["params"], blob["opt_state"], cut)
    template.params.load_state_dict(blob["params"])
    template.opt_state.load_state_dict(blob["opt_state"])
    return template._replace(step=blob["step"])
