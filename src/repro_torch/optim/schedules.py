"""LR schedules: cosine annealing (paper §4.1), WSD and constant. Port of
``repro.optim.schedules``; ``step`` is a tensor (the optimizer's count), and
the lr comes back as an f32 tensor on the same device."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig


def cosine_schedule(step, base_lr, warmup, total, min_frac=0.1):
    step = torch.as_tensor(step).to(torch.float32)
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def wsd_schedule(step, base_lr, warmup, total, decay_frac=0.1, min_frac=0.1):
    """Warmup → stable plateau → sharp final decay (last `decay_frac` steps)."""
    step = torch.as_tensor(step).to(torch.float32)
    decay_start = total * (1.0 - decay_frac)
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - decay_start) / max(total - decay_start, 1),
                       0.0, 1.0)
    decay = base_lr * (1.0 - (1.0 - min_frac) * prog)
    stable = torch.full_like(step, base_lr)
    return torch.where(step < warmup, warm,
                       torch.where(step < decay_start, stable, decay))


def make_schedule(cfg: TrainConfig):
    if cfg.schedule == "cosine":
        return lambda step: cosine_schedule(step, cfg.lr, cfg.warmup_steps,
                                            cfg.max_steps)
    if cfg.schedule == "wsd":
        return lambda step: wsd_schedule(step, cfg.lr, cfg.warmup_steps,
                                         cfg.max_steps)
    if cfg.schedule == "const":
        return lambda step: torch.full_like(
            torch.as_tensor(step), cfg.lr, dtype=torch.float32)
    raise ValueError(f"unknown schedule {cfg.schedule!r}")
