"""AdamW with decoupled weight decay + global-norm clipping (paper §4.1).

Port of ``repro.optim.adamw`` on the flat layout: ``params``, ``grads`` and
the moments are one ``[P]`` vector per node (the engine vmaps the update over
the node axis), so the clipping norm is the global norm over that node's
leaves and weight decay applies to every leaf, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import TrainConfig


def adamw_init(params: torch.Tensor):
    return {"mu": torch.zeros_like(params, dtype=torch.float32),
            "nu": torch.zeros_like(params, dtype=torch.float32),
            "count": torch.zeros((), dtype=torch.int32, device=params.device)}


def global_norm(grads: torch.Tensor) -> torch.Tensor:
    g = grads.to(torch.float32)
    return torch.sqrt(torch.sum(g * g))


def clip_by_global_norm(grads: torch.Tensor, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return (grads.to(torch.float32) * scale).to(grads.dtype), norm


def adamw_update(params, grads, state, cfg: TrainConfig, lr):
    """Returns (new_params, new_state). ``lr`` may be a tensor."""
    if cfg.grad_clip > 0:
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    count = state["count"] + 1
    b1, b2 = cfg.b1, cfg.b2
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, c)
    bc2 = 1.0 - torch.pow(b2, c)
    g32 = grads.to(torch.float32)
    mu = b1 * state["mu"] + (1 - b1) * g32
    nu = b2 * state["nu"] + (1 - b2) * (g32 * g32)
    step = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
    p32 = params.to(torch.float32)
    p32 = p32 - lr * (step + cfg.weight_decay * p32)
    return p32.to(params.dtype), {"mu": mu, "nu": nu, "count": count}
