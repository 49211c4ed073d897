"""The reference put in the program's place: the controls of the check.

:func:`first_round` gives what `swarmbench.observe.first_round` reads of
the program, computed instead by the plain reference, node by node:
``sync_every`` local steps, then the sync (each node's gate metric local
and merged, the accept decision, the commit). ``policy`` computes it one
precision below the configuration's (`swarmbench.reference.precision`);
``fault`` plants one fault where it is produced (a step that leaves its
state unchanged reads 1 in ``change_gap`` by that number's measure, and is
planted only in the CPU tests):

* ``half_batch``: each step's loss over the first half of its batch;
* ``no_exchange``: the commit leaves every node's params as they were;
* ``altered``: node 0's committed largest leaf scaled by 1.01;
* ``altered_metric``: node 0's gate metric of its own params raised by
  0.01.

The last three change only what the sync gives, so :func:`derive` makes
them from one sound round.
"""
from __future__ import annotations

import numpy as np
import torch

from swarmbench.observe import leaf_norms
from swarmbench.reference import swarm as ref_swarm

DERIVED = ("no_exchange", "altered", "altered_metric")


def first_round(cell, batches, device, policy: str = "f32",
                fault: str = "") -> dict:
    ref, sw, tr = cell.ref, cell.swarm, cell.train
    n, t = sw["n_nodes"], cell.steps
    traffic = cell.traffic
    init = cell.init
    loss_fn = (lambda p, b, pol=policy: ref.loss(p, b, pol))
    losses, grads, changes, pre = [], [], [], []
    for i in range(n):
        out = ref_swarm.local_steps(
            loss_fn, init, [traffic.batch(batches, k, i) for k in range(t)],
            tr, ref.store, device, policy=policy,
            fault=fault if fault == "half_batch" else "",
            keep=(3,))
        losses.append(out["loss"][:3])
        grads.append(leaf_norms({k: v[None] for k, v in out["grad"].items()})[0])
        changes.append(leaf_norms({k: v[None] for k, v in out["kept"][3].items()},
                                  base=init)[0])
        pre.append({k: v.cpu() for k, v in out["params"].items()})
        del out
    stacked = {k: torch.stack([p[k] for p in pre]) for k in pre[0]}
    del pre
    m_local, m_merged, gates, committed = [], [], [], []
    for i in range(n):
        val = traffic.val_of(i)
        local = ref_swarm.node(stacked, i, device)
        ml = ref.gate_metric(local, val, policy)
        cand = ref.sync.candidate(stacked, i, sw, traffic.data_sizes,
                                  ref.store, device, policy)
        mm = ref.gate_metric(cand, val, policy)
        ok = ref_swarm.accept(mm, ml, sw["val_threshold"])
        take = cand if ok else local
        committed.append({k: v.cpu() for k, v in take.items()})
        m_local.append(ml)
        m_merged.append(mm)
        gates.append(ok)
        del local, cand, take
    committed = {k: torch.stack([c[k] for c in committed]) for k in committed[0]}
    obs = {"loss": np.asarray(losses).T, "grad": np.asarray(grads),
           "change": np.asarray(changes), "pre": stacked,
           "committed": committed, "gates": np.asarray(gates),
           "metric_local": np.asarray(m_local),
           "metric_merged": np.asarray(m_merged)}
    return derive(obs, fault) if fault in DERIVED else obs


def derive(obs: dict, fault: str) -> dict:
    """A sound round's observations with ``fault`` (one of
    :data:`DERIVED`) planted in what its sync gave."""
    out = dict(obs)
    if fault == "no_exchange":
        out["committed"] = {k: v.clone() for k, v in obs["pre"].items()}
    elif fault == "altered":
        committed = {k: v.clone() for k, v in obs["committed"].items()}
        big = max(committed, key=lambda k: float(committed[k][0].norm()))
        committed[big][0] *= 1.01
        out["committed"] = committed
    elif fault == "altered_metric":
        out["metric_local"] = obs["metric_local"].copy()
        out["metric_local"][0] += 0.01
    else:
        raise ValueError(f"{fault!r} is not a fault of the sync's output")
    return out
