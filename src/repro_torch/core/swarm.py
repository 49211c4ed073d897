"""Host-driven P2P-SL loop: port of ``repro.core.swarm`` (the session's
``backend="host"``).

The paper's loop (§3.1) in its most literal form:
  1. nodes train locally for ``sync_every`` steps,
  2. exchange payloads (LoRA adapters, or full params) with peers,
  3. each node merges locally (weighted averaging),
  4. each node ACCEPTS the merge only if a local validation check clears
     the threshold; otherwise it keeps its own params (autonomy).

**The public entry point is** `repro_torch.core.session.SwarmSession`
``(..., backend="host")``; :class:`SwarmLearner` is the machinery under it.
It takes **arbitrary Python** callables, applied node by node:

  ``train_step_fn(params [P], opt_state, batch, step) -> (params,
  opt_state, metrics)``, or the true-Fisher 4-tuple ``(..., grads)``;
  ``eval_fn(params [P], val) -> float`` in [0, 1], called on the host once
  per node for its locals and once for its candidate.

A node's params are its flat ``[P]`` tensor under the session's
:class:`~repro_torch.core.flat.FlatLayout`, on the session's device (the
card unless the caller asks for the CPU). Propose and commit run stacked
on that device through the engine's pieces
(:meth:`~repro_torch.core.engine.SwarmEngine.propose_host`,
:meth:`~repro_torch.core.engine.SwarmEngine.commit_host`): the commit is one
``fused_merge_all`` launch a sync, as the reference commits through its
fused Pallas kernel. Fisher mass for fisher/gradmatch accumulates in
:meth:`SwarmLearner.local_steps`; an explicitly set ``node.fisher`` wins
over it at sync.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import SwarmConfig
from repro_torch.core import merge_impl as merge_lib
from repro_torch.core import topology as topo
from repro_torch.core.engine import (SwarmEngine, active_weights,
                                     gate_decisions, mixing_matrix)
from repro_torch.core.flat import FlatLayout


@dataclass
class NodeState:
    params: torch.Tensor      # [P] slots under the swarm's layout
    opt_state: Any
    data_size: float
    fisher: Any = None        # explicit importance [n_values]; never mutated
    fisher_stats: Any = None  # strategy-accumulated Δθ² mass (local_steps)
    active: bool = True
    history: list = field(default_factory=list)


@dataclass
class SwarmLearner:
    """N independent learners + a periodic gated P2P merge (the paper's
    system). ``layout`` is the nodes' :class:`FlatLayout` (None: each
    node's params are one leaf)."""

    cfg: SwarmConfig
    train_step_fn: Callable
    eval_fn: Callable
    nodes: List[NodeState]
    layout: Optional[FlatLayout] = None
    step: int = 0
    sync_log: list = field(default_factory=list)

    def __post_init__(self):
        self.engine = SwarmEngine(
            self.cfg, None, None,
            data_sizes=[nd.data_size for nd in self.nodes],
            layout=self.layout)

    @property
    def n(self) -> int:
        return len(self.nodes)

    @property
    def strategy(self):
        return merge_lib.get_strategy(self.cfg)

    def zero_stats(self, params: torch.Tensor) -> torch.Tensor:
        """Zero importance mass over the values of one node's params."""
        return torch.zeros(self.engine._n_values(params[None]),
                           dtype=torch.float32, device=params.device)

    def local_steps(self, batches_per_node: Sequence[Any]):
        """One local step on every node with a batch (``None`` skips a
        node). Data gates local training; membership gates merge
        participation only: a departed node keeps training on its own shard
        if its stream still supplies batches, as on the engine backend. For
        fisher/gradmatch the strategy accumulates each node's importance
        mass here (``node.fisher_stats``); an explicit ``node.fisher`` is
        never touched. A step that updates its params in place leaves
        nothing of the old ones for the Δθ² proxy, so a copy is kept."""
        strategy = self.strategy
        for node, batch in zip(self.nodes, batches_per_node):
            if batch is None:
                continue
            old = node.params.clone() if strategy.uses_stats else None
            out = self.train_step_fn(node.params, node.opt_state, batch,
                                     self.step)
            grads = None
            if len(out) == 4:  # opt-in true-Fisher hook: per-step grads
                node.params, node.opt_state, metrics, grads = out
            else:
                node.params, node.opt_state, metrics = out
            if strategy.uses_stats:
                if node.fisher_stats is None:
                    node.fisher_stats = self.zero_stats(node.params)
                if grads is not None:
                    node.fisher_stats = strategy.accumulate_grads(
                        node.fisher_stats, grads, self.step)
                else:
                    node.fisher_stats = strategy.accumulate(
                        node.fisher_stats, self.engine._parts(old),
                        self.engine._parts(node.params), self.step)
            node.history.append({k: float(v) for k, v in metrics.items()})
        self.step += 1

    def maybe_sync(self, val_data_per_node: Sequence[Any],
                   force: bool = False):
        if not force and (self.step == 0
                          or self.step % self.cfg.sync_every != 0):
            return None
        return self.sync(val_data_per_node)

    def sync(self, val_data_per_node: Sequence[Any]):
        """One full propose → validate → commit round. Returns the round
        log: ``step``, ``gates``, ``metric_local``, ``metric_merged`` (Python
        lists), ``spectral_gap`` (and ``quorum_ok`` with a quorum)."""
        active = [nd.active for nd in self.nodes]
        sizes = [nd.data_size for nd in self.nodes]
        W = mixing_matrix(self.cfg, sizes, active=active)
        stacked = torch.stack([nd.params for nd in self.nodes])
        dev = stacked.device
        strategy = self.strategy
        fishers = None
        if strategy.uses_stats:
            # an explicit node.fisher wins over accumulated stats; a node
            # with neither gets zero mass (about excluded): a ones default
            # would dwarf the lr²-scaled Δθ² mass of the trained nodes
            masses = [nd.fisher if nd.fisher is not None
                      else (nd.fisher_stats if nd.fisher_stats is not None
                            else self.zero_stats(nd.params))
                      for nd in self.nodes]
            masses = [torch.as_tensor(m, dtype=torch.float32, device=dev)
                      for m in masses]
            has_explicit = [nd.fisher is not None for nd in self.nodes]
            if any(has_explicit) and not all(has_explicit):
                # mixed sources: explicit squared-grad Fishers (~O(1)) and
                # the Δθ² proxy (~lr²) are on incomparable scales; each
                # node's mass is normalized to mean 1 first
                masses = [strategy.fishers(m) for m in masses]
            fishers = strategy.finalize_mass(
                torch.stack(masses), torch.as_tensor(active, device=dev))
        weights = torch.as_tensor(active_weights(sizes, active),
                                  dtype=torch.float32, device=dev)
        W_t = torch.as_tensor(W, dtype=torch.float32, device=dev)
        rows = None
        if strategy.uses_stats and self.cfg.topology in ("ring", "dynamic"):
            # topology-restricted weighted merge: graph-neighbour rows only
            rows = strategy.topo_rows(W_t, weights)
        candidate, W_eff, imp = self.engine.propose_host(
            stacked, W_t, fishers=fishers, weights=weights, rows=rows)

        metric_local, metric_merged = [], []
        for node, cand, val in zip(self.nodes, candidate.unbind(0),
                                   val_data_per_node):
            if node.active and val is not None:
                metric_local.append(float(self.eval_fn(node.params, val)))
                metric_merged.append(float(self.eval_fn(cand, val)))
            else:
                metric_local.append(1.0)
                metric_merged.append(0.0)  # inactive nodes never accept
        gates = gate_decisions(torch.tensor(metric_merged),
                               torch.tensor(metric_local),
                               self.cfg.val_threshold).numpy()
        gates &= np.asarray(active)
        quorum = int(getattr(self.cfg, "quorum", 0) or 0)
        quorum_ok = True
        if quorum > 0:
            # below quorum the round holds every node's locals
            quorum_ok = int(np.asarray(active).sum()) >= quorum
            if not quorum_ok:
                gates[:] = False
        committed = self.engine.commit_host(stacked, candidate, W_eff,
                                            gates, imp=imp)
        for node, row in zip(self.nodes, committed.unbind(0)):
            node.params = row
        log = {"step": self.step, "gates": gates.tolist(),
               "metric_local": metric_local, "metric_merged": metric_merged,
               "spectral_gap": topo.spectral_gap(W)}
        if quorum > 0:
            log["quorum_ok"] = bool(quorum_ok)
        self.sync_log.append(log)
        return log

    def set_active(self, idx: int, active: bool):
        """Dynamic membership: a node joins or leaves the swarm."""
        self.nodes[idx].active = active
