"""Drive a `SwarmSession` through a :class:`~repro_torch.faults.plan.FaultPlan`.

Counterpart of ``repro.faults.runner``. The runner is the host-side
choreography and nothing more: every fault lands as *data* the session's
round already consumes —

  * membership windows (crash / straggle / drop) become
    ``session.set_active`` updates between rounds;
  * corruption becomes a :class:`FaultSignals` threaded through
    ``session.round(batches, val, faults=...)`` — armed on the engine
    backend's quantized wire, lowered to drops elsewhere (the f32 wire and
    the host loop);
  * a rejoin triggers the EF quarantine (``session.quarantine_wire``) so
    a returning node's stale wire reference cannot poison the telescoping
    residual;
  * a preempt checkpoint-cycles the whole session (save → fresh session
    via ``make_session`` → restore), which must be bit-identical to the
    uninterrupted run.

On the gossip backend every rank replays the same plan against its own
session: the membership updates are replicated data, a rejoin quarantines
the whole mesh wire on every rank, corruption lowers to drops (the mesh
wire carries no in-graph injection), and a preempt's save and load are
collective (`repro_torch.core.session.SwarmSession.save`). An
inner-sharded gossip session (``param_specs`` over a mesh with ``data`` /
``model`` axes) runs a plan the same way: the quarantine zeroes every
rank's shard of the mesh wire, and a preempt's save gathers the shards
into the unsharded session's file, whose load keeps each rank's shard.

On the quantized wire the runner threads a (possibly idle)
``FaultSignals`` every round, so every round of a plan runs the same steps
(both checksums) whether or not it is armed.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.faults.plan import FaultPlan
from repro_torch.faults.signals import idle_signals, signals_for_round


def _supports_in_graph_corrupt(session) -> bool:
    return (session.backend == "engine"
            and session.state.wire is not None)


def _numpy(value) -> np.ndarray:
    """A log entry (a device tensor, or the host loop's Python values) as
    a numpy array."""
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy()
    return np.asarray(value)


def run_plan(session, plan: FaultPlan, batches, val, *,
             make_session: Optional[Callable[[], Any]] = None,
             checkpoint_path: Optional[str] = None,
             on_round: Optional[Callable[[int, dict], None]] = None
             ) -> Tuple[Any, List[Dict[str, Any]]]:
    """Replay ``plan`` against ``session``, one ``session.round`` per plan
    round. Returns ``(session, logs)`` — the session object can change
    identity across a preempt event, so callers must keep the returned
    one.

    ``batches`` is either a fixed per-round batch tree (reused every round)
    or a callable ``round_index -> batches``. ``make_session`` /
    ``checkpoint_path`` are required iff the plan contains preempt events.
    ``on_round(r, log)`` is an optional per-round observer hook. Each log
    holds ``round``, ``active``, ``preempted``, ``corrupt`` and ``gates``
    (plus ``wire_ok`` / ``quorum_ok`` where the round reports them) as
    numpy values: the only device reads of a round.
    """
    if plan.n_nodes != session.cfg.n_nodes:
        raise ValueError(f"plan is for {plan.n_nodes} nodes, session has "
                         f"{session.cfg.n_nodes}")
    # corruption is injected on the engine backend's quantized wire,
    # dropped elsewhere (the host loop among them)
    in_graph = _supports_in_graph_corrupt(session)
    lowered = plan.lower(corrupt_in_graph=in_graph)
    has_preempt = bool(lowered.preempt.any())
    if has_preempt and (make_session is None or checkpoint_path is None):
        raise ValueError("plan contains preempt events: run_plan needs "
                         "make_session= and checkpoint_path=")
    logs: List[Dict[str, Any]] = []
    for r in range(plan.n_rounds):
        if lowered.preempt[r]:
            session.save(checkpoint_path)
            session = make_session()
            session.load(checkpoint_path)
        mask = lowered.active[r]
        prev = session.active
        if not np.array_equal(prev, mask):
            session.set_active(mask)
        for node in np.flatnonzero(mask & ~prev):
            # EF quarantine before the rejoined node's first sync
            session.quarantine_wire(int(node))
        faults = None
        if in_graph:
            faults = (signals_for_round(plan, lowered, r)
                      if lowered.corrupt[r].any()
                      else idle_signals(plan.n_nodes))
        round_batches = batches(r) if callable(batches) else batches
        out = session.round(round_batches, val, faults=faults)
        log = {"round": r, "active": mask.copy(),
               "preempted": bool(lowered.preempt[r]),
               "corrupt": lowered.corrupt[r].copy(),
               "gates": _numpy(out["gates"]).astype(bool)}
        for key in ("wire_ok", "quorum_ok"):
            if key in out:
                log[key] = _numpy(out[key])
        logs.append(log)
        if on_round is not None:
            on_round(r, log)
    return session, logs
