"""Seeded random weights, made on the device in the type they are served
in, one draw per layer-stacked tensor, and handed alike to the system under
test and to the reference. Linear and convolution weights are N(0, 1/fan_in),
the token embedding N(0, 1/d), the decoder positions N(0, 0.01^2), biases
N(0, 0.02^2), layer-norm gains 1 + N(0, 0.05^2) and shifts N(0, 0.02^2); the
encoder positions are the fixed sinusoids."""

from __future__ import annotations

from typing import Dict

import torch

from reference.model import param_shapes, sinusoids


def _scale_of(name: str, shape: tuple) -> tuple:
    """(mean, std) of the draw for one tensor."""
    if name.endswith("_ln_g") or name in ("ln_g", "ln_post_g"):
        return 1.0, 0.05
    if name.endswith("_b") or name in ("ln_b",):
        return 0.0, 0.02
    if name == "pos_emb":
        return 0.0, 0.01
    if name.startswith("conv"):
        return 0.0, (shape[1] * shape[2]) ** -0.5
    return 0.0, shape[-1] ** -0.5


def make(dims: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, Dict[str, torch.Tensor]]:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    with torch.no_grad():
        for part, shapes in param_shapes(dims).items():
            out[part] = {}
            for name in sorted(shapes):
                shape = shapes[name]
                if part == "encoder" and name == "pos_emb":
                    t = torch.as_tensor(sinusoids(*shape), dtype=torch.float32, device=device)
                    out[part][name] = t.to(dtype)
                    continue
                mean, std = _scale_of(name, shape)
                t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
                t.mul_(std)
                if mean:
                    t.add_(mean)
                out[part][name] = t
    return out
