"""Plain AdamW with decoupled weight decay, global-norm clipping and the
cosine schedule with linear warm-up, leaf by leaf in float32.

``lr(count) = base · count / warmup`` while ``count < warmup``, then
``base · (0.1 + 0.9 · ½(1 + cos(π · progress)))`` with ``progress =
clamp((count − warmup) / (total − warmup), 0, 1)``; the update of step
``count + 1`` takes ``lr(count)``. The gradient is scaled by
``min(1, clip / ‖g‖)`` over all leaves; then ``m ← b1 m + (1 − b1) g``,
``v ← b2 v + (1 − b2) g²``, ``θ ← θ − lr ((m / (1 − b1ᵗ)) / (√(v / (1 −
b2ᵗ)) + eps) + wd θ)``. ``store`` rounds each new leaf as the
configuration stores it.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch


def lr_at(count: int, t: dict) -> float:
    base, warm, total = t["lr"], t["warmup_steps"], t["max_steps"]
    if count < warm:
        return base * count / max(warm, 1)
    prog = min(max((count - warm) / max(total - warm, 1), 0.0), 1.0)
    return base * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], t: dict,
                 store: Callable[[str, torch.Tensor], torch.Tensor]):
        self.t, self.store, self.count = t, store, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def clip(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        clip = self.t.get("grad_clip", 1.0)
        if clip <= 0:
            return grads
        norm = math.sqrt(sum(float((g.double() ** 2).sum())
                             for g in grads.values()))
        scale = min(1.0, clip / max(norm, 1e-9))
        return {k: g * scale for k, g in grads.items()}

    @torch.no_grad()
    def step(self, params, grads):
        """The clipped gradient and the new params (fresh tensors)."""
        t = self.t
        b1, b2, eps, wd = t.get("b1", 0.9), t.get("b2", 0.95), \
            t.get("eps", 1e-8), t.get("weight_decay", 1e-4)
        lr = lr_at(self.count, t)
        self.count += 1
        g = self.clip(grads)
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        new = {}
        for k, p in params.items():
            self.m[k] = b1 * self.m[k] + (1 - b1) * g[k]
            self.v[k] = b2 * self.v[k] + (1 - b2) * g[k] * g[k]
            upd = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + eps)
            new[k] = self.store(k, p - lr * (upd + wd * p))
        return g, new
