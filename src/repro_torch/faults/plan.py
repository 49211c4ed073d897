"""Seeded, declarative fault plans.

The port's own copy of ``repro.faults.plan`` (numpy only; the port imports
nothing of the reference, and a test holds this copy against the original).

A :class:`FaultPlan` is an immutable schedule of fault events against an
``n_nodes``-node swarm over ``n_rounds`` sync rounds. Events are appended
with the builder methods (each returns a NEW plan, so plans compose like
configs) and validated eagerly:

    plan = (FaultPlan(n_nodes=4, n_rounds=10, seed=0)
            .crash(1, at=2, rejoin=5)      # out for rounds [2, 5)
            .straggle(2, at=3, rounds=2)   # misses syncs 3 and 4
            .drop(3, at=6)                 # one dropped sync payload
            .corrupt(0, at=7)              # bit-flipped wire payload
            .preempt(at=8))                # save + rebuild + restore

``lower()`` compiles the event list into dense per-round directives
(:class:`LoweredPlan`) the runner replays against a live session. Every
fault kind lowers to **data the round already consumes**:

  crash / straggle / drop
      windows of the ``[R, N]`` active mask — the masked merges (fedavg
      active-weight renormalization, zeroed Fisher mass, the mixing matrix
      rebuilt on the device from the mask) absorb them.
  corrupt
      a ``[R, N]`` boolean feeding the bit-flip injector on the quantized
      engine wire (`repro_torch.faults.signals`). When the session has no
      such path (an uncompressed f32 wire), ``lower(corrupt_in_graph=False)``
      folds the event into the active mask instead — the post-detection
      degraded behavior (reject-and-keep-local) without the detection.
  preempt
      a ``[R]`` boolean: before that round the runner checkpoints the
      session, constructs a fresh one, and restores — proving wire/EF
      state round-trips mid-plan (bit-identical to uninterrupted).

Determinism: the plan's ``seed`` keys every random choice downstream
(bit-flip patterns), so a (plan, session) pair replays identically.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

FAULT_KINDS = ("crash", "straggle", "drop", "corrupt", "preempt")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault. ``until`` is the exclusive end round for
    windowed kinds (crash rejoin round / straggle end); None for a crash
    means the node never returns."""

    kind: str
    node: int = -1           # -1 for node-less events (preempt)
    round: int = 0           # first round the fault is visible
    until: Optional[int] = None


@dataclass(frozen=True)
class LoweredPlan:
    """Dense per-round directives (all numpy, host-side)."""

    active: np.ndarray       # [R, N] bool — sync membership per round
    corrupt: np.ndarray      # [R, N] bool — in-graph wire corruption
    rejoin: np.ndarray       # [R, N] bool — node returns at this round
    preempt: np.ndarray      # [R] bool — save+rebuild+restore BEFORE round


@dataclass(frozen=True)
class FaultPlan:
    n_nodes: int
    n_rounds: int
    seed: int = 0
    events: Tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        if self.n_nodes < 1 or self.n_rounds < 1:
            raise ValueError("FaultPlan needs n_nodes >= 1 and n_rounds >= 1")
        for event in self.events:   # directly-constructed plans validate too
            self._validate(event)

    # -- builders (each returns a new, validated plan) -----------------------

    def _validate(self, event: FaultEvent) -> None:
        if event.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {event.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if event.kind != "preempt" and not 0 <= event.node < self.n_nodes:
            raise ValueError(
                f"{event.kind}: node {event.node} out of range "
                f"[0, {self.n_nodes})")
        if not 0 <= event.round < self.n_rounds:
            raise ValueError(
                f"{event.kind}: round {event.round} out of range "
                f"[0, {self.n_rounds})")
        if event.until is not None and event.until <= event.round:
            raise ValueError(
                f"{event.kind}: until={event.until} must be > "
                f"round={event.round}")

    def _add(self, event: FaultEvent) -> "FaultPlan":
        self._validate(event)
        return dataclasses.replace(self, events=self.events + (event,))

    def crash(self, node: int, *, at: int,
              rejoin: Optional[int] = None) -> "FaultPlan":
        """Node dies before round ``at``; back at ``rejoin`` (None: never)."""
        return self._add(FaultEvent("crash", node, at, rejoin))

    def straggle(self, node: int, *, at: int, rounds: int = 1) -> "FaultPlan":
        """Node falls ``rounds`` sync rounds behind: it keeps training on
        whatever batches the caller feeds it but its updates miss the sync
        window, so it is excluded from merges for rounds [at, at+rounds)."""
        if rounds < 1:
            raise ValueError(f"straggle: rounds must be >= 1, got {rounds}")
        return self._add(FaultEvent("straggle", node, at, at + rounds))

    def drop(self, node: int, *, at: int) -> "FaultPlan":
        """Node's sync payload is lost for exactly one round."""
        return self._add(FaultEvent("drop", node, at))

    def corrupt(self, node: int, *, at: int) -> "FaultPlan":
        """Node's wire payload arrives bit-flipped at round ``at`` — the
        per-payload checksum must detect it and quarantine the sender."""
        return self._add(FaultEvent("corrupt", node, at))

    def preempt(self, *, at: int) -> "FaultPlan":
        """Kill-and-restore the whole session before round ``at`` via
        checkpoint round-trip (preemption mid-run)."""
        return self._add(FaultEvent("preempt", -1, at))

    # -- lowering ------------------------------------------------------------

    def lower(self, corrupt_in_graph: bool = True) -> LoweredPlan:
        """Compile events to per-round directives. With
        ``corrupt_in_graph=False`` corrupt events degrade to one-round
        drops (membership mask) instead of in-graph bit flips."""
        r, n = self.n_rounds, self.n_nodes
        active = np.ones((r, n), bool)
        corrupt = np.zeros((r, n), bool)
        preempt = np.zeros((r,), bool)
        for ev in self.events:
            if ev.kind == "preempt":
                preempt[ev.round] = True
            elif ev.kind == "corrupt":
                if corrupt_in_graph:
                    corrupt[ev.round, ev.node] = True
                else:
                    active[ev.round, ev.node] = False
            elif ev.kind == "drop":
                active[ev.round, ev.node] = False
            else:  # crash / straggle: a [round, until) absence window
                end = r if ev.until is None else min(ev.until, r)
                active[ev.round:end, ev.node] = False
        prev = np.vstack([np.ones((1, n), bool), active[:-1]])
        rejoin = active & ~prev
        return LoweredPlan(active=active, corrupt=corrupt, rejoin=rejoin,
                           preempt=preempt)
