"""What the benchmark reads of the program's first round, for the check.

:func:`first_round` drives one ``SwarmSession.round`` (the window's own
call, on the window's own feed) and records, around the engine's calls,
what the comparison needs: each node's loss of steps 1-3, the gradient
the optimizer got at step 1 (its first moment after one step over
``1 − b1``) and the params after step 3 as per-leaf norms, and from the
sync the params it started from, its gate metrics and decisions and the
committed params. Everything kept goes to the host, so the window's peak
memory is the program's.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict

import numpy as np
import torch

CHUNK = 1 << 24


def _sq(v: torch.Tensor) -> torch.Tensor:
    """Σ v² of one node's leaf, in float32 pieces."""
    flat = v.reshape(-1)
    total = torch.zeros((), dtype=torch.float64, device=v.device)
    for a in range(0, flat.numel(), CHUNK):
        total += flat[a:a + CHUNK].float().square().sum().double()
    return total


def leaf_norms(tree: Dict[str, torch.Tensor], base=None, scale=1.0) -> np.ndarray:
    """[N, leaves] norms of ``scale · (tree − base)`` over the sorted paths."""
    paths = sorted(tree)
    n = tree[paths[0]].shape[0]
    out = np.zeros((n, len(paths)))
    for j, k in enumerate(paths):
        for i in range(n):
            v = tree[k][i]
            if base is not None:
                v = v.float() - base[k].float()
            out[i, j] = float(_sq(v).sqrt()) * scale
    return out


@contextmanager
def wrapped(engine, **wrappers):
    """Inside the block each engine call named in ``wrappers`` runs as
    ``wrappers[name](the call)``; the engine's own calls come back after."""
    for name, wrap in wrappers.items():
        setattr(engine, name, wrap(getattr(engine, name)))
    try:
        yield
    finally:
        for name in wrappers:
            delattr(engine, name)


def first_round(cell, batches) -> dict:
    """Drive the cell's first round on ``batches`` and read it."""
    layout, init = cell.layout, cell.init
    b1 = cell.train.get("b1", 0.9)
    obs: dict = {}
    calls = [0]

    def watch_steps(local_steps):
        def steps(params, opt_state, *args, **kw):
            out = local_steps(params, opt_state, *args, **kw)
            calls[0] += 1
            if calls[0] == 1:
                mu = layout.value_layout.unflatten(out[1]["mu"])
                obs["grad"] = leaf_norms(mu, scale=1.0 / (1.0 - b1))
            if calls[0] == 3:
                obs["change"] = leaf_norms(layout.unflatten(out[0]),
                                           base=init)
            return out
        return steps

    def watch_sync(sync):
        def call(params, *args, **kw):
            obs["pre"] = params.detach().to("cpu", copy=True)
            committed, log = sync(params, *args, **kw)
            obs["committed"] = committed.detach().to("cpu", copy=True)
            for key in ("gates", "metric_local", "metric_merged"):
                obs[key] = log[key].detach().cpu().numpy()
            return committed, log
        return call

    with wrapped(cell.session.engine, local_steps=watch_steps,
                 sync=watch_sync):
        log = cell.session.round(batches, cell.traffic.val)
    obs["loss"] = log["train"]["loss"][:3].detach().cpu().numpy()
    if calls[0] < 3:
        raise RuntimeError(f"a round of {calls[0]} local steps; the check "
                           "reads steps 1-3")
    obs["pre"] = layout.unflatten(obs["pre"])
    obs["committed"] = layout.unflatten(obs["committed"])
    return obs
