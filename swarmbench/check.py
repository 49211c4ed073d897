"""The comparison that decides ``correct``.

The reference follows each node's first three steps from the same
weights on the same batches, and the sync from the params the program's
sync started from (its merged candidates from the cell's sync reference,
`swarmbench.reference.sync`). The numbers compared, each against the limit the
cell's file gives it (``workloads/<cell>.json``, key ``limits``):

``loss_gap``      max over nodes and steps 1-3 of |L_prog − L_ref| / |L_ref|.
``grad_gap``      the gradient the optimizer got at step 1, by the worst
                  leaf: |‖g_prog‖ − ‖g_ref‖| over the larger of ‖g_ref‖ of
                  that leaf and of the median leaf; max over nodes.
``change_gap``    the same of the params' change after step 3, over the
                  leaves whose reference gradient is at least a thousandth
                  of the median leaf's (a gradient nought to rounding
                  moves a leaf under Adam by round-off alone).
``metric_gap``    max over nodes of |m_prog − m_ref| of the gate metric of
                  each node's params and of its merged candidate.
``gate_flips``    nodes whose accept bit differs from the reference's where
                  the reference's margin ``merged − threshold · local`` is
                  wider than ``(1 + threshold) · metric_gap``'s limit (a
                  narrower margin is the metrics' to judge). Exact: 0.
``commit_gap``    by the worst leaf and node, ‖c_prog − c_ref‖ over the
                  larger of ‖c_ref‖ of that leaf and of the median leaf,
                  where c_ref is the reference's merged candidate for an
                  accepted node and the params the sync started from for a
                  rejected one.

A number missing from ``limits`` is printed and not compared. A number
that is not finite fails.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch

from swarmbench.observe import leaf_norms
from swarmbench.reference import swarm as ref_swarm

ORDER = ("loss_gap", "grad_gap", "change_gap", "metric_gap", "gate_flips",
         "commit_gap")


def _worst(prog: np.ndarray, ref: np.ndarray, keep=None) -> float:
    """Worst leaf of |prog − ref| / max(ref, median leaf of ref), one row
    a node."""
    worst = 0.0
    for i in range(ref.shape[0]):
        r, p = ref[i], prog[i]
        cols = np.ones(r.shape[0], bool) if keep is None else keep[i]
        floor = np.median(r[cols]) if cols.any() else 0.0
        gap = np.abs(p - r)[cols] / np.maximum(np.maximum(r[cols], floor),
                                                1e-30)
        worst = max(worst, float(gap.max()) if gap.size else 0.0)
    return worst


def follow(init: Dict[str, torch.Tensor], first_batches: Callable, model,
           n: int, train: dict, device) -> dict:
    """The reference's first three steps of each node: its losses [3, N],
    first gradients' and changes' leaf norms [N, leaves]."""
    losses, grads, changes = [], [], []
    for i in range(n):
        out = ref_swarm.local_steps(model.loss, init, first_batches(i), train,
                                    model.store, device, keep=(3,))
        losses.append(out["loss"])
        g = {k: v[None] for k, v in out["grad"].items()}
        grads.append(leaf_norms(g)[0])
        p3 = {k: v[None] for k, v in out["kept"][3].items()}
        changes.append(leaf_norms(p3, base={k: v.to(device) for k, v in
                                            init.items()})[0])
        del out, g, p3
    return {"loss": np.asarray(losses).T, "grad": np.asarray(grads),
            "change": np.asarray(changes)}


def judge(obs: dict, start: dict, val_of: Callable, model, swarm: dict,
          data_sizes, limits: dict, device) -> dict:
    """The numbers of :data:`ORDER` for the program's observations
    ``obs`` (`swarmbench.observe.first_round`) against the reference's
    first steps ``start`` (:func:`follow`) and its sync from the params the
    program's sync started from. ``model`` is the reference's cell model
    (``loss``, ``gate_metric``, ``store``, ``sync``)."""
    n = swarm["n_nodes"]
    ref_loss, ref_grad, ref_change = start["loss"], start["grad"], start["change"]
    gap = np.abs(obs["loss"] - ref_loss) / np.maximum(np.abs(ref_loss), 1e-30)
    numbers = {"loss_gap": float(gap.max()),
               "grad_gap": _worst(obs["grad"], ref_grad)}
    med = np.median(ref_grad, axis=1, keepdims=True)
    numbers["change_gap"] = _worst(obs["change"], ref_change,
                                   keep=ref_grad >= 1e-3 * med)

    thr = swarm["val_threshold"]
    pre, committed = obs["pre"], obs["committed"]
    paths = sorted(pre)
    m_local, m_merged, cand = [], [], []
    for i in range(n):
        m_local.append(model.gate_metric(ref_swarm.node(pre, i, device),
                                         val_of(i)))
        c = model.sync.candidate(pre, i, swarm, data_sizes, model.store,
                                 device)
        m_merged.append(model.gate_metric(c, val_of(i)))
        cand.append({k: v.cpu() for k, v in c.items()})
        del c
    m_local, m_merged = np.asarray(m_local), np.asarray(m_merged)
    numbers["metric_gap"] = float(max(
        np.abs(obs["metric_local"] - m_local).max(),
        np.abs(obs["metric_merged"] - m_merged).max()))
    margin = m_merged - thr * m_local
    wide = np.abs(margin) > (1 + thr) * limits.get("metric_gap", 0.0)
    flips = (np.asarray(obs["gates"], bool) != (margin >= 0)) & wide
    numbers["gate_flips"] = float(flips.sum())

    worst = 0.0
    for i in range(n):
        take = cand[i] if bool(obs["gates"][i]) else {
            k: pre[k][i].float() for k in paths}
        diff = np.array([float((committed[k][i].float() - take[k].float())
                               .norm()) for k in paths])
        size = np.array([float(take[k].float().norm()) for k in paths])
        floor = max(float(np.median(size)), 1e-30)
        worst = max(worst, float((diff / np.maximum(size, floor)).max()))
    numbers["commit_gap"] = worst
    return numbers


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number with a limit is finite and within it."""
    for k, v in numbers.items():
        if not math.isfinite(v):
            return False
        if k in limits and v > limits[k]:
            return False
    return True


def lines(numbers: dict, limits: dict) -> list:
    """``name value limit`` for each number, in :data:`ORDER`."""
    out = []
    for k in ORDER:
        if k in numbers:
            lim = limits.get(k, "not compared")
            out.append(f"{k} {numbers[k]!r} limit {lim}")
    return out
