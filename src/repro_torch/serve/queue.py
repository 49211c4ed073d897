"""Request queue for the serving plane. Own copy of ``repro.serve.queue``
(numpy only; a test holds the two equal).

Single-threaded and tick-driven: :class:`~repro_torch.serve.engine.
ServeEngine` pumps the queue from its scheduler loop, so admission order,
param-version pinning and completion are fully deterministic.

Degradation surface: the queue is BOUNDED when ``max_pending`` is set — a
submit beyond the bound is rejected explicitly (terminal
``status="rejected"``, never enqueued) instead of growing an unbounded
backlog; and every request can carry a ``deadline_s`` budget —
:meth:`RequestQueue.expire` sweeps pending requests past their deadline
(terminal ``status="deadline_exceeded"``) so stale work never occupies a
prefill dispatch.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional, Tuple

import numpy as np


@dataclass
class Request:
    """One generation request and its full lifecycle record.

    ``node_tokens`` accumulates the per-node token vector emitted at each
    step (a list of ``[N]`` int32 arrays); ``tokens`` is the aggregated
    stream — identical across nodes for consensus/average/topk modes, node
    0's stream under ``per_node``. ``param_version`` is pinned at admission:
    every token of this request comes from exactly that version of the
    hot-swap slot, even if a newer checkpoint is published mid-request.

    ``status`` is the lifecycle verdict: ``"pending"`` → ``"live"`` on
    admission → one terminal state — ``"done"`` (completed normally),
    ``"rejected"`` (bounded-queue backpressure: never admitted), or
    ``"deadline_exceeded"`` (its ``deadline_s`` budget ran out, queued or
    mid-decode; any already-emitted tokens are kept). Every terminal
    transition also stamps ``finish_t``, so ``done`` means "reached a
    terminal state", not "succeeded" — check ``status`` for the verdict.
    """

    rid: int
    prompt: np.ndarray              # [prompt_len] int32
    max_new: int
    submit_t: float = 0.0
    admit_t: Optional[float] = None
    finish_t: Optional[float] = None
    param_version: Optional[int] = None
    node_tokens: List[np.ndarray] = field(default_factory=list)
    deadline_s: Optional[float] = None
    status: str = "pending"

    @property
    def tokens(self) -> List[int]:
        return [int(v[0]) for v in self.node_tokens]

    @property
    def done(self) -> bool:
        return self.finish_t is not None

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.finish_t is None else self.finish_t - self.submit_t


class RequestQueue:
    """FIFO admission queue with monotonically increasing request ids.

    ``max_pending`` bounds the backlog: ``None`` (default) keeps the
    historical unbounded behaviour; with a bound, an over-limit submit
    returns the request already in terminal ``status="rejected"`` — the
    caller observes explicit backpressure instead of unbounded growth.
    """

    def __init__(self, now=time.perf_counter,
                 max_pending: Optional[int] = None):
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self._pending: Deque[Request] = deque()
        self._ids = itertools.count()
        self._now = now
        self.max_pending = max_pending

    def submit(self, prompt, max_new: int,
               deadline_s: Optional[float] = None) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        req = Request(rid=next(self._ids), prompt=prompt, max_new=int(max_new),
                      submit_t=self._now(), deadline_s=deadline_s)
        if (self.max_pending is not None
                and len(self._pending) >= self.max_pending):
            req.status = "rejected"
            req.finish_t = req.submit_t
            return req
        self._pending.append(req)
        return req

    def expire(self, now: Optional[float] = None) -> List[Request]:
        """Sweep pending requests whose ``deadline_s`` budget has elapsed;
        each is marked terminal ``deadline_exceeded`` and returned."""
        t = self._now() if now is None else now
        expired: List[Request] = []
        kept: Deque[Request] = deque()
        for req in self._pending:
            if (req.deadline_s is not None
                    and t - req.submit_t >= req.deadline_s):
                req.status = "deadline_exceeded"
                req.finish_t = t
                expired.append(req)
            else:
                kept.append(req)
        self._pending = kept
        return expired

    @property
    def pending(self) -> Tuple[Request, ...]:
        return tuple(self._pending)

    def pop(self) -> Request:
        return self._pending.popleft()

    def __len__(self) -> int:
        return len(self._pending)
