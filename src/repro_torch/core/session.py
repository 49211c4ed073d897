"""SwarmSession: the entry point of P2P swarm learning in the port.

Port of ``repro.core.session`` for the engine backend:

    session = SwarmSession(cfg, train_step, eval_fn, params=flat,
                           opt_state=adamw_init(flat), data_sizes=sizes,
                           layout=layout)            # device="cuda" by default
    log = session.round(batches, val)                # T steps + gated sync
    session.leave(3); session.round(batches, val)    # membership is data
    session.join(3)

The swarm lives in one :class:`SwarmState`: ``params``, the AdamW moments
and the strategy's importance statistics are flat ``[N, P]`` tensors on the
session's device (see `repro_torch.core.flat`), ``active`` is the ``[N]``
membership mask, and ``round``/``step`` are the global counters.

Not in this slice: the gossip and host backends, checkpointing
(``save``/``restore``), the wire state and the comms cost model.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import SwarmConfig
from repro_torch.core.engine import SwarmEngine, _leading, _not_ported
from repro_torch.core.flat import FlatLayout


@dataclass
class SwarmState:
    """The whole swarm. ``params`` [N, P]; ``opt_state`` a dict of stacked
    tensors (AdamW: ``mu``/``nu`` [N, P], ``count`` [N]); ``stats`` the
    strategy's [N, P] importance accumulators (None for mean/fedavg);
    ``active`` the [N] bool membership mask; ``round``/``step`` counters."""

    params: torch.Tensor
    opt_state: Any = None
    stats: Optional[torch.Tensor] = None
    active: Optional[torch.Tensor] = None
    round: int = 0
    step: int = 0


def _stack_per_node(value, n: int, device):
    """One node's value (a tensor, or a dict of tensors such as an optimizer
    state) tiled over the N nodes, on ``device``."""
    if value is None:
        return None
    if isinstance(value, dict):
        return {k: _stack_per_node(v, n, device) for k, v in value.items()}
    t = torch.as_tensor(value).to(device)
    return t.unsqueeze(0).expand((n,) + tuple(t.shape)).contiguous()


def _to_device(value, device):
    if value is None:
        return None
    if isinstance(value, dict):
        return {k: _to_device(v, device) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return type(value)(_to_device(v, device) for v in value)
    return torch.as_tensor(value).to(device)


class SwarmSession:
    """Swarm driver over a single :class:`SwarmState`.

    Parameters
    ----------
    cfg : SwarmConfig
    train_step_fn : per-node ``(params [P], opt_state, batch, step) ->
        (params, opt_state, metrics)``; the engine vmaps it over the nodes.
    eval_fn : ``(params [N, P], val) -> [N]`` gate metric for every node.
    params / opt_state : one node's flat params ``[P]`` and optimizer state,
        replicated over the N nodes (the shared warm start).
    data_sizes : per-node dataset sizes (fedavg / weighted-merge weights).
    layout : the :class:`FlatLayout` of the params, for :attr:`node_params`.
    device : where the swarm runs; CUDA unless the caller asks for the CPU.
    """

    def __init__(self, cfg: SwarmConfig, train_step_fn: Optional[Callable],
                 eval_fn: Optional[Callable], *, params=None, opt_state=None,
                 data_sizes: Optional[Sequence[float]] = None,
                 backend: str = "engine",
                 layout: Optional[FlatLayout] = None, device="cuda"):
        if backend in ("gossip", "host"):
            item = ("queue 1 item 13, distributed gossip backend"
                    if backend == "gossip" else "queue 1 item 12, host backend")
            raise _not_ported(f"backend={backend!r}", item)
        if backend != "engine":
            raise ValueError(f"unknown backend {backend!r}")
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "torch.backends.cuda.matmul.allow_tf32 is True: the merge "
                "contraction must run in full f32, as the reference's "
                "HIGHEST-precision mix does")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.layout = layout
        n = cfg.n_nodes
        if params is None:
            raise ValueError("SwarmSession needs initial params")
        stacked_params = _stack_per_node(params, n, self.device)
        stacked_opt = _stack_per_node(opt_state, n, self.device)
        self.engine = SwarmEngine(cfg, train_step_fn, eval_fn,
                                  data_sizes=data_sizes)
        self._state = SwarmState(
            params=stacked_params, opt_state=stacked_opt,
            stats=self.engine.init_stats(stacked_params),
            active=torch.ones((n,), dtype=torch.bool, device=self.device))

    # -- state ---------------------------------------------------------------

    @property
    def state(self) -> SwarmState:
        return self._state

    @property
    def node_params(self) -> List[dict]:
        """Per-node parameters in the reference's tree layout
        (``stem``/``blocks``/``head``, HWIO convs); flat ``[P]`` rows when the
        session has no layout."""
        rows = list(self._state.params.unbind(0))
        if self.layout is None:
            return rows
        from repro_torch.convert import to_reference_tree
        return [to_reference_tree(self.layout, row) for row in rows]

    @property
    def active(self):
        return self._state.active.cpu().numpy()

    # -- dynamic membership (runtime data) -----------------------------------

    def join(self, node: int) -> None:
        """Node (re-)joins the swarm: flips one element of the active mask."""
        self._set_active_index(node, True)

    def leave(self, node: int) -> None:
        """Node leaves the swarm: excluded from every merge; its own params
        pass through commits untouched. Local training is governed by the
        batches the caller still supplies."""
        self._set_active_index(node, False)

    def set_active(self, mask) -> None:
        self._state = dataclasses.replace(
            self._state,
            active=torch.as_tensor(mask, device=self.device).to(torch.bool))

    def _set_active_index(self, node: int, value: bool) -> None:
        active = self._state.active.clone()
        active[node] = value
        self._state = dataclasses.replace(self._state, active=active)

    # -- drivers -------------------------------------------------------------

    def round(self, batches, val):
        """One full round: ``sync_every`` local steps + gated sync over a
        stacked ``[T, N, ...]`` batch pytree. The log holds device tensors
        ``gates`` / ``metric_local`` / ``metric_merged`` [N] and ``train``
        ([T, N] per-step metrics)."""
        st = self._state
        batches, val = _to_device(batches, self.device), _to_device(
            val, self.device)
        t = _leading(batches)
        p, o, out = self.engine.round(st.params, st.opt_state, batches, val,
                                      st.active, st.step, st.stats)
        stats = out.pop("stats", None)
        self._state = SwarmState(params=p, opt_state=o, stats=stats,
                                 active=st.active, round=st.round + 1,
                                 step=st.step + t)
        return out

    def run_rounds(self, batches, val):
        """R rounds over ``[R, T, N, ...]`` batches. Returns the per-round
        logs stacked ``[R, ...]`` plus a ``train`` key."""
        st = self._state
        batches, val = _to_device(batches, self.device), _to_device(
            val, self.device)
        r = _leading(batches)
        t = (batches[0] if isinstance(batches, (tuple, list))
             else batches).shape[1]
        p, o, tm, logs = self.engine.run_rounds(
            st.params, st.opt_state, batches, val, st.active, st.step,
            st.stats)
        stats = logs.pop("stats", None)
        self._state = SwarmState(params=p, opt_state=o, stats=stats,
                                 active=st.active, round=st.round + r,
                                 step=st.step + r * t)
        return dict(logs, train=tm)

    def run_local(self, batches):
        """Sync-free local training over ``[S, N, ...]`` batches."""
        st = self._state
        batches = _to_device(batches, self.device)
        s_count = _leading(batches)
        p, o, tm, stats = self.engine.run_local(st.params, st.opt_state,
                                                batches, st.step, st.stats)
        self._state = dataclasses.replace(st, params=p, opt_state=o,
                                          stats=stats, step=st.step + s_count)
        return tm

