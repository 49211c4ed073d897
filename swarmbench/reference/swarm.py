"""Plain P2P-SL pieces: a node's local steps, a node's params out of the
stacked ones, and the gate's accept decision (the merged candidate is the
cell's sync reference's, `swarmbench.reference.sync`).

A node's params are a dict ``{path: tensor}``. ``store(path, t)`` rounds
a leaf as the configuration stores it (float32 leaves pass unchanged).
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

from swarmbench.reference import precision
from swarmbench.reference.optim import AdamW


def _f32(params: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device=device, dtype=torch.float32) for k, v in params.items()}


def local_steps(loss_fn: Callable, params, batches: List, train: dict, store,
                device, policy: str = "f32", fault: str = "",
                keep=()) -> dict:
    """``len(batches)`` AdamW steps of one node from ``params``: the loss of
    each step, the clipped gradient of the first, the params after the
    last and after each step counted in ``keep`` (1-based).
    ``fault="half_batch"`` takes the loss over the first half of each
    batch (a control of the comparison)."""
    p = _f32(params, device)
    opt = AdamW(p, train, store)
    losses, first, kept = [], None, {}
    for batch in batches:
        if fault == "half_batch":
            batch = _half(batch)
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        with precision.exact():
            loss = loss_fn(leaves, batch, policy)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        g, new = opt.step(p, dict(zip(leaves, grads)))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: v.detach() for k, v in g.items()}
        p = new
        if len(losses) in keep:
            kept[len(losses)] = {k: v.detach() for k, v in p.items()}
    return {"loss": losses, "grad": first, "params": p, "kept": kept}


def _half(batch):
    """The first half of a batch's rows (of its tokens, for one row)."""
    def cut(v):
        if v.shape[0] >= 2:
            return v[: v.shape[0] // 2]
        return v[:, : v.shape[1] // 2]
    if isinstance(batch, dict):
        return {k: cut(v) for k, v in batch.items()}
    return tuple(cut(v) for v in batch)


def node(stacked: Dict[str, torch.Tensor], i: int, device) -> Dict[str, torch.Tensor]:
    return {k: v[i].to(device=device, dtype=torch.float32)
            for k, v in stacked.items()}


def accept(metric_merged: float, metric_local: float, threshold: float) -> bool:
    """The relative gate: merged ≥ threshold × local."""
    return metric_merged >= threshold * metric_local
