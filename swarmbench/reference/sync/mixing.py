"""Plain mixing on the f32 wire: node i's candidate is Σ_j W[i, j] θ_j,
leaf by leaf in float32, with W row-stochastic: ``full`` (FedAvg weights
∝ data sizes for ``fedavg``, uniform for ``mean``) or ``ring`` (self
weight, the rest split between the two neighbours). Any other topology,
merge or wire is refused: a Fisher merge, an error-feedback wire or a
quantised commit needs a reference of its own.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from swarmbench.reference import precision

TOPOLOGIES = ("full", "ring")
MERGES = ("fedavg", "mean")
WIRES = ("f32",)


def refuse(swarm: dict) -> Optional[str]:
    for key, known in (("topology", TOPOLOGIES), ("merge", MERGES),
                       ("wire_dtype", WIRES)):
        if swarm[key] not in known:
            return (f"the mixing reference computes {key} {known}, not "
                    f"{swarm[key]!r}")
    return None


def mixing_matrix(swarm: dict, data_sizes) -> np.ndarray:
    """Row-stochastic W [N, N] of the cell's topology and merge."""
    why = refuse(swarm)
    if why:
        raise ValueError(why)
    n = swarm["n_nodes"]
    if swarm["topology"] == "full":
        w = (np.asarray(data_sizes, np.float64) if swarm["merge"] == "fedavg"
             else np.ones(n))
        return np.tile((w / w.sum())[None, :], (n, 1))
    sw = swarm.get("self_weight", 0.5)
    W = np.zeros((n, n))
    for i in range(n):
        W[i, i] += sw
        W[i, (i - 1) % n] += (1 - sw) / 2
        W[i, (i + 1) % n] += (1 - sw) / 2
    return W


def candidate(stacked: Dict[str, torch.Tensor], node: int, swarm: dict,
              data_sizes, store, device,
              policy: str = "f32") -> Dict[str, torch.Tensor]:
    """Σ_j W[node, j] θ_j (each θ_j rounded as ``policy`` rounds an
    operand), stored as the configuration stores each leaf."""
    W = mixing_matrix(swarm, data_sizes)
    out = {}
    for k, v in stacked.items():
        acc = None
        for j in range(v.shape[0]):
            if W[node, j] == 0.0:
                continue
            x = precision.round_to(v[j].to(device=device, dtype=torch.float32),
                                   policy)
            term = float(W[node, j]) * x
            acc = term if acc is None else acc + term
        out[k] = store(k, acc)
    return out
