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
Sharded training (JAX's mesh) is not ported: ``mesh=`` is refused.

Checkpoints are ``torch.save`` files (the parameters, the optimizer's
``state_dict`` and the step in one file under a directory), not orbax's:
orbax is a JAX library, so the port neither writes nor reads orbax
checkpoints.
"""

from __future__ import annotations

import os
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from .models.whisper_torch import WhisperDims, WhisperTorch, decode_full, encode
from .utils import not_ported

CHECKPOINT_FILE = "train_state.pt"  # the file save_checkpoint writes under its directory


def teacher_forced_loss(model: WhisperTorch, mel: torch.Tensor, tokens: torch.Tensor,
                        loss_mask: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy over masked positions.

    mel (B, n_mels, T); tokens (B, S) int, full sequences with sot and eot;
    loss_mask (B, S) float, which positions contribute. Returns a 0-d f32
    tensor."""
    xa = encode(model, mel)
    logits, _ = decode_full(model, tokens[:, :-1], xa)
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    mask = loss_mask[:, 1:].to(nll.dtype)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


class TrainState(NamedTuple):
    params: WhisperTorch
    opt_state: torch.optim.Optimizer
    step: int


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


def make_train_step(
    dims: WhisperDims,
    optimizer: Optional[Callable[[List[torch.nn.Parameter]], torch.optim.Optimizer]] = None,
    mesh=None,
):
    """Returns (init_state, train_step). ``optimizer`` builds the optimizer
    from the trainable parameters (default ``adamw``). ``train_step`` runs
    on the model's device (the inputs must be there) and does not wait for
    it: the loss comes back as a 0-d tensor."""
    if mesh is not None:
        raise not_ported("mesh")
    make_optimizer = optimizer or adamw

    def init_state(model: WhisperTorch) -> TrainState:
        if model.dims != dims:
            raise ValueError(f"the model's dims {model.dims} are not {dims}")
        params = trainable_parameters(model)
        for p in params:
            p.requires_grad_(True)
        return TrainState(params=model, opt_state=make_optimizer(params), step=0)

    def train_step(state: TrainState, mel, tokens, loss_mask) -> Tuple[TrainState, torch.Tensor]:
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss = teacher_forced_loss(state.params, mel, tokens, loss_mask)
        loss.backward()
        opt.step()
        return TrainState(params=state.params, opt_state=opt, step=state.step + 1), loss.detach()

    return init_state, train_step


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write the parameters, the optimizer's state and the step into the
    directory ``path`` (made if missing), replacing what a previous save
    left there, as JAX's ``force=True`` does for periodic saves to one path."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp")
    torch.save({"params": state.params.state_dict(), "opt_state": state.opt_state.state_dict(),
                "step": state.step}, tmp)
    os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))


def load_checkpoint(path: str, template: TrainState) -> TrainState:
    """Restore a state written by ``save_checkpoint`` into ``template`` (a
    state from ``init_state`` on a model of the same dims and the same
    optimizer), read with ``torch.load(weights_only=True)``."""
    blob = torch.load(os.path.join(path, CHECKPOINT_FILE), map_location=template.params.device,
                      weights_only=True)
    template.params.load_state_dict(blob["params"])
    template.opt_state.load_state_dict(blob["opt_state"])
    return TrainState(params=template.params, opt_state=template.opt_state, step=blob["step"])
