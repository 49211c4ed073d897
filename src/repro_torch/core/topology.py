"""Swarm peer topologies as mixing matrices — host (numpy) and device (torch).

Port of ``repro.core.topology``. One gossip round maps node i's params to
θ_i ← Σ_j W[i,j] θ_j with a row-stochastic mixing matrix W:

  full + FedAvg weights  → classic FedAvg (one-round consensus)
  ring                   → each node touches only its two graph neighbours
  dynamic                → membership-masked matrix; absent nodes are isolated
                           (W[i,i]=1) and contribute nothing

``build_matrix`` and friends are host-side numpy. ``mixing_matrix_traced``
builds the same matrix on the device from a runtime ``active`` mask tensor,
so join/leave is data and never rebuilds anything on the host.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def fedavg_weights(data_sizes: Sequence[float]) -> np.ndarray:
    """Dataset-size-proportional weights (McMahan et al.)."""
    w = np.asarray(data_sizes, np.float64)
    if (w < 0).any() or w.sum() <= 0:
        raise ValueError("data sizes must be non-negative with positive sum")
    return w / w.sum()


def full_matrix(n: int, weights: Optional[Sequence[float]] = None) -> np.ndarray:
    """Fully-connected merge: every node averages everyone (FedAvg if weighted)."""
    w = fedavg_weights(weights) if weights is not None else np.full(n, 1.0 / n)
    return np.tile(w[None, :], (n, 1))


def ring_matrix(n: int, self_weight: float = 0.5) -> np.ndarray:
    """Symmetric ring gossip: self + two neighbours. Doubly stochastic."""
    if not 0.0 < self_weight <= 1.0:
        raise ValueError("self_weight in (0,1]")
    side = (1.0 - self_weight) / 2.0
    W = np.zeros((n, n))
    for i in range(n):
        W[i, i] = self_weight
        W[i, (i - 1) % n] += side
        W[i, (i + 1) % n] += side
    return W


def dynamic_matrix(base: np.ndarray, active: Sequence[bool]) -> np.ndarray:
    """Mask out absent nodes and renormalize rows; absent rows become identity.

    An absent node neither sends nor receives; remaining nodes redistribute
    its weight proportionally.
    """
    n = base.shape[0]
    a = np.asarray(active, bool)
    W = base * a[None, :]                       # drop absent senders
    rows = W.sum(axis=1, keepdims=True)
    W = np.divide(W, rows, out=np.zeros_like(W), where=rows > 0)
    W[~a] = 0.0
    W[~a, ~a] = 1.0                              # absent nodes keep their params
    # a fully-isolated active row (all its peers absent) also keeps its params
    for i in range(n):
        if a[i] and W[i].sum() == 0:
            W[i, i] = 1.0
    return W


def spectral_gap(W: np.ndarray) -> float:
    """1 - |λ₂|: per-round contraction rate of disagreement under gossip."""
    eig = np.linalg.eigvals(W)
    mags = np.sort(np.abs(eig))[::-1]
    return float(1.0 - (mags[1] if len(mags) > 1 else 0.0))


def build_matrix(topology: str, n: int, *, weights=None, self_weight=0.5,
                 active=None) -> np.ndarray:
    if topology == "full":
        W = full_matrix(n, weights)
    elif topology == "ring":
        W = ring_matrix(n, self_weight)
    elif topology == "dynamic":
        W = full_matrix(n, weights)
    else:
        raise ValueError(f"unknown topology {topology!r}")
    if active is not None:
        W = dynamic_matrix(W, active)
    return W


# ---------------------------------------------------------------------------
# device builders: W from a runtime active mask tensor
# ---------------------------------------------------------------------------

def dynamic_matrix_traced(base: torch.Tensor, active: torch.Tensor
                          ) -> torch.Tensor:
    """On-device :func:`dynamic_matrix`: mask absent senders, renormalize
    rows; absent and fully-isolated rows fall back to identity."""
    base = base.to(torch.float32)
    n = base.shape[0]
    a = active.to(torch.float32)
    W = base * a[None, :]
    rows = W.sum(1, keepdim=True)
    W = torch.where(rows > 0, W / torch.where(rows > 0, rows, 1.0), 0.0)
    eye = torch.eye(n, dtype=torch.float32, device=base.device)
    W = torch.where(a[:, None] > 0, W, eye)   # absent nodes keep their params
    rows = W.sum(1, keepdim=True)
    return torch.where(rows > 0, W, eye)      # fully-isolated active rows too


def mixing_matrix_traced(topology: str, active: torch.Tensor, *, weights=None,
                         self_weight: float = 0.5) -> torch.Tensor:
    """Mixing matrix built on ``active``'s device from the runtime mask.

    Equivalent to ``dynamic_matrix(build_matrix(topology, n, ...), active)``
    in f32; ``weights`` (FedAvg dataset sizes) are normalized here.
    """
    dev = active.device
    n = active.shape[0]
    if topology in ("full", "dynamic"):
        if weights is None:
            w = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
        else:
            w = torch.as_tensor(weights, dtype=torch.float32, device=dev)
            w = w / torch.clamp(w.sum(), min=1e-30)
        base = w[None, :].expand(n, n)
    elif topology == "ring":
        base = torch.as_tensor(ring_matrix(n, self_weight),
                               dtype=torch.float32, device=dev)
    else:
        raise ValueError(f"unknown topology {topology!r}")
    return dynamic_matrix_traced(base, active)
