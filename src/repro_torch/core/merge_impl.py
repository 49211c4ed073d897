"""Model-merging algorithms for swarm aggregation, on the flat ``[N, P]``
swarm state. Port of ``repro.core.merge_impl``.

  mean / fedavg — arithmetic & dataset-size-weighted averaging (weighting is
                  folded into the mixing matrix)
  fisher        — diagonal-Fisher-weighted averaging
  gradmatch     — uncertainty-based gradient matching (Daheim et al.):
                  Fisher-preconditioned delta correction around a reference

:class:`MergeStrategy` wraps each method with ``init_stats / accumulate /
accumulate_grads / fishers / propose`` hooks. ``propose`` returns the merge
candidate (what the gate evaluates) plus the row weights and optional
importance the commit kernel re-contracts with. Where the reference maps each of these over a
stacked pytree leaf by leaf, here each is one tensor op over ``[N, P]``.

A layout with wide leaves (a bf16 LM, `repro_torch.core.flat`) keeps its
statistics over values ``[N, n_values]`` f32; ``accumulate`` then takes the
params as the layout's parts (a tuple: the f32 prefix, the 16-bit rest) and
differences each part in its own dtype, as the reference does leaf by leaf.
"""
from __future__ import annotations

from typing import Optional

import torch


def mix(stacked: torch.Tensor, W) -> torch.Tensor:
    """θ_i ← Σ_j W[i,j] θ_j: one f32 matrix product ``[N,N] @ [N,P]``.

    The reference pins this contraction to full f32 (HIGHEST); a session
    refuses to run with TF32 matmuls enabled, so this stays exact f32.
    """
    Wf = torch.as_tensor(W, dtype=torch.float32, device=stacked.device)
    return torch.matmul(Wf, stacked.to(torch.float32)).to(stacked.dtype)


def fisher_merge(stacked, fishers, eps: float = 1e-8):
    """θ* = Σ_i F_i ⊙ θ_i / Σ_i F_i, broadcast back to every node."""
    xf = stacked.to(torch.float32)
    ff = fishers.to(torch.float32) + eps
    merged = (ff * xf).sum(0) / ff.sum(0)
    return merged.expand_as(stacked).to(stacked.dtype)


def gradmatch_merge(stacked, fishers, weights: Optional[torch.Tensor] = None,
                    eps: float = 1e-8):
    """θ* = θ̄ + Σ_i w_i (F_i/F̄ − 1) ⊙ (θ_i − θ̄), F̄ = Σ w_i F_i; reduces to
    FedAvg when all Fishers are equal."""
    n = stacked.shape[0]
    w = (torch.full((n,), 1.0 / n, device=stacked.device) if weights is None
         else torch.as_tensor(weights, dtype=torch.float32,
                              device=stacked.device))
    xf = stacked.to(torch.float32)
    ff = fishers.to(torch.float32) + eps
    wb = w.reshape(n, 1)
    mean = (wb * xf).sum(0)
    fbar = (wb * ff).sum(0)
    corr = (wb * (ff / fbar - 1.0) * (xf - mean)).sum(0)
    return (mean + corr).expand_as(stacked).to(stacked.dtype)


def topo_weighted_merge(stacked, fishers, rows, eps: float = 1e-8):
    """Topology-restricted importance-weighted merge (per-row ratio):

        θ*_i = Σ_j rows[i,j]·(F_j+eps)⊙θ_j / Σ_j rows[i,j]·(F_j+eps)
    """
    R = torch.as_tensor(rows, dtype=torch.float32, device=stacked.device)
    xf = stacked.to(torch.float32)
    ff = fishers.to(torch.float32) + eps
    num = torch.matmul(R, ff * xf)
    den = torch.matmul(R, ff)
    return (num / torch.clamp(den, min=1e-30)).to(stacked.dtype)


def mask_fishers(fishers, active):
    """Zero departed nodes' Fisher mass so their stale params can't enter
    fisher/gradmatch merges (reached through ``finalize_mass``)."""
    if fishers is None:
        return None
    a = torch.as_tensor(active, device=fishers.device)
    return fishers * a.to(fishers.dtype).reshape(-1, 1)


class MergeStrategy:
    """``init_stats`` → ``accumulate`` → ``fishers`` → ``propose``.

    ``propose(stacked, W, weights=, fishers=, rows=)`` returns
    ``(candidate, W_commit, imp)``: the candidate for every node, plus the
    row weights and optional ``[N, P]`` importance the fused commit kernel
    re-contracts with (``imp is None``: a plain W-row mix).
    """

    method = "mean"
    uses_stats = False
    eps = 1e-8

    def init_stats(self, stacked):
        return None

    def accumulate(self, stats, old_params, new_params, step):
        return stats

    def accumulate_grads(self, stats, grads, step):
        """True-Fisher accumulation from the exact per-step gradients a
        4-tuple train step returns (instead of the Δθ² proxy). Default:
        no-op."""
        return stats

    def fishers(self, stats, mean=None):
        return stats

    def gossip_mass(self, fishers, weights):
        """Per-node importance mass for the collective (psum) realization —
        the one place any weight-folding identity lives for the gossip
        backend (``weights``: the rows' dataset weights)."""
        return fishers

    def finalize_mass(self, fishers, active=None, mean=None):
        """Mask-then-normalize, in that order: a departed node's stale mass
        must be zeroed before it can drag the normalization mean.
        ``mean``: how the mean over every node's mass is taken (default
        ``Tensor.mean``; the gossip backend's rank holds only its rows and
        passes a collective mean)."""
        if fishers is None:
            return None
        if active is not None:
            fishers = mask_fishers(fishers, active)
        return self.fishers(fishers, mean)

    def topo_rows(self, W, weights=None):
        return None

    def propose(self, stacked, W, *, weights=None, fishers=None, rows=None):
        raise NotImplementedError


class MixStrategy(MergeStrategy):
    """mean / fedavg: candidate is the mixing-matrix contraction; the fused
    commit re-contracts the same W rows (no importance weights)."""

    def __init__(self, method: str = "fedavg"):
        self.method = method

    def propose(self, stacked, W, *, weights=None, fishers=None, rows=None):
        return mix(stacked, W), W, None


class FisherStrategy(MergeStrategy):
    """Diagonal-Fisher-weighted merging with on-device mass accumulation:
    F ← γF + (θ_{t+1} − θ_t)², a curvature proxy whose scale cancels in the
    merge ratio (see the reference's docstring for its AdamW caveat), or,
    from a 4-tuple train step, the exact F ← γF + g²."""

    method = "fisher"
    uses_stats = True

    def __init__(self, decay: float = 0.95, eps: float = 1e-8):
        self.decay = decay
        self.eps = eps

    def init_stats(self, stacked):
        return torch.zeros(stacked.shape, dtype=torch.float32,
                           device=stacked.device)

    def accumulate(self, stats, old_params, new_params, step):
        if isinstance(old_params, tuple):      # the parts of a wide layout
            d = torch.cat([(pn - po).to(torch.float32) for po, pn
                           in zip(old_params, new_params)], dim=-1)
        else:
            d = (new_params - old_params).to(torch.float32)
        return self.decay * stats + d * d

    def accumulate_grads(self, stats, grads, step):
        """Exact diagonal-Fisher mass from per-step gradients: F ← γF + g²
        (same decayed-sum shape as the Δθ² proxy, but scale-correct under
        adaptive optimizers)."""
        g = grads.to(torch.float32)
        return self.decay * stats + g * g

    def fishers(self, stats, mean=None):
        """Normalize accumulated mass to a global mean of 1 — one mean over
        all N·P elements of the flat buffer (``mean``: a callable taking
        it, when the buffer holds only some of the nodes)."""
        mean = stats.mean() if mean is None else mean(stats)
        scale = torch.where(mean > 0, 1.0 / torch.clamp(mean, min=1e-30), 1.0)
        return stats * scale

    def _imp(self, fishers):
        """Importance for the fused commit: F_j + eps."""
        return fishers.to(torch.float32) + self.eps

    def _rows(self, n, weights, device):
        return torch.ones((n, n), dtype=torch.float32, device=device)

    def topo_rows(self, W, weights=None):
        """Graph-restricted fisher: contribution weights are the mixing rows."""
        return W.to(torch.float32)

    def propose(self, stacked, W, *, weights=None, fishers=None, rows=None):
        if fishers is None:
            fishers = torch.ones_like(stacked)
        if rows is not None:   # ring/dynamic: per-row neighbour-restricted
            candidate = topo_weighted_merge(stacked, fishers, rows,
                                            eps=self.eps)
            return candidate, rows, self._imp(fishers)
        candidate = self._merge(stacked, fishers, weights)
        n = stacked.shape[0]
        return (candidate, self._rows(n, weights, stacked.device),
                self._imp(fishers))

    def _merge(self, stacked, fishers, weights):
        return fisher_merge(stacked, fishers, eps=self.eps)


class GradMatchStrategy(FisherStrategy):
    """Gradient matching ≡ a dataset-weighted Fisher ratio
    Σ w_j F_j θ_j / Σ w_j F_j, so the commit reuses the importance-weighted
    kernel with w_j folded into the row weights."""

    method = "gradmatch"

    def _rows(self, n, weights, device):
        w = (torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
             if weights is None
             else torch.as_tensor(weights, dtype=torch.float32, device=device))
        return w[None, :].expand(n, n)

    def topo_rows(self, W, weights=None):
        Wf = W.to(torch.float32)
        if weights is None:
            return Wf
        return Wf * torch.as_tensor(weights, dtype=torch.float32,
                                    device=Wf.device)[None, :]

    def _merge(self, stacked, fishers, weights):
        return gradmatch_merge(stacked, fishers, weights, eps=self.eps)

    def gossip_mass(self, fishers, weights):
        """Fold w_j into the mass so the fisher psum realizes the weighted
        ratio Σ w_j F_j θ_j / Σ w_j F_j."""
        w = torch.as_tensor(weights, dtype=torch.float32,
                            device=fishers.device)
        return fishers * w.reshape(-1, 1)


def get_strategy(cfg) -> MergeStrategy:
    """SwarmConfig → MergeStrategy (the single merge-method dispatch)."""
    method = cfg.merge
    if method in ("mean", "fedavg"):
        return MixStrategy(method)
    decay = cfg.fisher_decay
    if method == "fisher":
        return FisherStrategy(decay=decay)
    if method == "gradmatch":
        return GradMatchStrategy(decay=decay)
    raise ValueError(f"unknown merge {method!r}")
