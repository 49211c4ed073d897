"""SwarmSession: the entry point of P2P swarm learning in the port.

Port of ``repro.core.session`` for the engine backend:

    session = SwarmSession(cfg, train_step, eval_fn, params=flat,
                           opt_state=adamw_init(flat), data_sizes=sizes,
                           layout=layout)            # device="cuda" by default
    log = session.round(batches, val)                # T steps + gated sync
    session.leave(3); session.round(batches, val)    # membership is data
    session.join(3)
    session.save("ckpt.msgpack")
    session = SwarmSession.restore("ckpt.msgpack", cfg, train_step, eval_fn,
                                   params=flat, opt_state=adamw_init(flat),
                                   data_sizes=sizes, layout=layout)

The swarm lives in one :class:`SwarmState`: ``params``, the AdamW moments,
the strategy's importance statistics and the quantized wire's
error-feedback reference are flat ``[N, P]`` tensors on the session's
device (see `repro_torch.core.flat`; with a bf16 LM's wide leaves the
params are ``[N, P]`` slots and the others f32 over its ``n_values``
values, the wire over the adapters' values when ``lora_only`` carves
them out of a full state), ``active`` is the ``[N]`` membership
mask, ``rng`` the reference's legacy PRNG key and ``round``/``step`` the
global counters. Checkpoints hold all of it in the reference's msgpack
layout (`repro_torch.checkpointing`), so either package restores the
other's files.

In the heterogeneous ``cfg.payload="lora"`` mode (the model zoo) the
state is the shared adapter payload: ``params`` is a list of the N nodes'
payload rows, stacked into ``[N, P]`` under the :class:`FlatLayout` of the
sorted payload paths (:meth:`FlatLayout.of_payload`), and ``train_step_fn`` /
``eval_fn`` are lists of per-node closures that hold each node's frozen
backbone (`repro_torch.experiments.scenarios`).

``backend="host"`` runs the paper's loop over arbitrary Python callables,
node by node (`repro_torch.core.swarm.SwarmLearner`): a node's params are
its flat ``[P]`` row, ``eval_fn(params [P], val) -> float`` runs on the host
once per node, and propose and commit run stacked on the session's device,
the commit through the fused merge kernel. f32 wire only, full payloads,
one callable for every node, as the reference's host loop; its checkpoints
are the reference's host-session files.

``backend="gossip"`` (``mesh``, ``axis`` from `repro_torch.launch.mesh.
make_swarm_mesh`) runs the same round with the merge as collectives over a
process group, one process a rank (`repro_torch.core.gossip`). Every rank
builds the session with the same global arguments (params, opt_state,
data_sizes, seed) and keeps the rows of its nodes ``mesh.rows`` of the
params, moments, statistics and mesh wire; ``round`` / ``run_rounds`` /
``run_local`` take the global ``[T, N, ...]`` batches and ``[N, ...]``
validation rows and use the rank's; the logs are ``[N]`` on every rank;
:attr:`node_params` gathers the whole swarm. A two-level mesh
(`repro_torch.launch.mesh.make_two_level_swarm_mesh`) works the same way,
the cost model choosing between the flat and the hierarchical schedules.

A gossip session's :meth:`SwarmSession.save` and :meth:`SwarmSession.load`
are collective: every rank calls them. ``save`` gathers every rank's rows
into the reference's file of the WHOLE swarm (its global ``SwarmState``:
``[N, ...]`` params, moments and statistics, the mesh wire as the
reference's ``init_mesh_wire`` lays it out for the schedule), rank 0
writes it, and a barrier follows; ``load`` reads it on every rank and
keeps the rank's rows (a replicated leaf whole).

**Inner (model) sharding.** With ``param_specs`` that name the mesh's
``data`` / ``model`` axes (``make_swarm_mesh(n, data=D, model=M)``,
`repro_torch.sharding.rules.param_specs`) a rank holds, between rounds,
only its shard of its nodes (`repro_torch.core.flat.ShardLayout`): the
params, the AdamW moments, the importance statistics and the mesh wire.
Which steps split:

* a `repro_torch.launch.train.TrainStep` (``make_train_step``'s, passed
  as the session's ``train_step_fn``) runs **split** on the shard
  (``TrainStep.split``): the rank takes ``B / D`` of its node's rows (all
  of them when ``D · accum_steps`` does not divide ``B``), each layer is
  gathered over the shard group just before its block
  (`repro_torch.models.gather`; with ``remat`` inside the checkpoint, so
  at most two whole layers are alive), the gradient comes back summed over
  the node's data group to the shard, and AdamW and the Δθ² statistics
  update the shard in place. No rank holds a whole node's gradient or
  moments; with ``D = 1`` and ``M = 1`` the step is the whole node's bit
  for bit, with ``D > 1`` the gradient is summed in another order (exact
  to the train-parity tolerances). With ``M > 1`` the layer's work
  divides over the node's model group (tensor parallelism,
  `repro_torch.sharding.tensor`: the reference's head-, sequence-,
  expert-, SSM-head- and vocab-parallel placements): a rank gathers only
  its compute blocks of each layer, never the whole layer, and computes
  its share, also exact only to the train-parity tolerances (the enc-dec
  family too: its encoder, cross-attention and decoder);
* any other closure (the CNN's batch-statistics step, the true-Fisher
  4-tuple, a lambda around a step) **gathers**: the round gathers the
  node's params, moments and statistics over the shard group once, runs
  the ``sync_every`` unchanged steps on the whole node and keeps the
  shard, so every rank of a node computes what an unsharded rank computes
  (an f32 round is the unsharded one bit for bit) and a step's peak
  memory is a whole node's.

The sync moves only shards, and its gate scores the node's gathered
params (not its moments or statistics) alike on every rank of the node.
``save`` gathers the shards as well, so the file is the unsharded
session's; ``load`` keeps the rank's shard.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpointing import (Fields, load_metadata, load_pytree,
                                       save_pytree)
from repro_torch.configs.base import SwarmConfig
from repro_torch.convert import (chunks_from_reference,
                                 chunks_to_reference_tree, from_reference,
                                 to_reference_tree)
from repro_torch.core import comms
from repro_torch.core.engine import (SwarmEngine, _index, _index_node,
                                     _leading, _stack_logs,
                                     _stack_nodes)
from repro_torch.core.flat import FlatLayout
from repro_torch.core.prng import fold_in_key, prng_key
from repro_torch.core.swarm import NodeState, SwarmLearner


@dataclass
class SwarmState:
    """The whole swarm. ``params`` [N, P]; ``opt_state`` a dict of stacked
    tensors (AdamW: ``mu``/``nu`` [N, P], ``count`` [N]); ``stats`` the
    strategy's [N, P] importance accumulators (None for mean/fedavg);
    ``wire`` the error-feedback reference θ̂ [N, P] of a quantized wire
    (None for ``wire_dtype="f32"``); ``active`` the [N] bool membership
    mask; ``rng`` the legacy ``uint32[2]`` PRNG key (numpy), folded once per
    round; ``round``/``step`` counters."""

    params: torch.Tensor
    opt_state: Any = None
    stats: Optional[torch.Tensor] = None
    wire: Optional[torch.Tensor] = None
    active: Optional[torch.Tensor] = None
    rng: Any = None
    round: int = 0
    step: int = 0


def _stack_per_node(value, n: int, device):
    """A list/tuple of N per-node values (tensors, or dicts of tensors such
    as optimizer states) → stacked; a single value → tiled over the N nodes
    (the shared warm start). On ``device``."""
    if value is None:
        return None
    if isinstance(value, (list, tuple)):
        if len(value) != n:
            raise ValueError(
                f"expected {n} per-node values, got a length-{len(value)} "
                "list/tuple (a top-level list/tuple is one entry per node)")
        return _stack_nodes([_to_device(v, device) for v in value])
    if isinstance(value, dict):
        return {k: _stack_per_node(v, n, device) for k, v in value.items()}
    t = torch.as_tensor(value).to(device)
    return t.unsqueeze(0).expand((n,) + tuple(t.shape)).contiguous()


def _node_rows(value, rows: slice, dim: int):
    """The ``rows`` of the node axis ``dim`` of every tensor in a
    dict/tuple/list tree (numpy arrays too); a copy when they are not the
    whole axis, so the rest can be freed."""
    if value is None:
        return None
    if isinstance(value, dict):
        return {k: _node_rows(v, rows, dim) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return type(value)(_node_rows(v, rows, dim) for v in value)
    t = torch.as_tensor(value)
    idx = (slice(None),) * dim + (rows,)
    part = t[idx]
    return part if part.shape == t.shape else part.clone()


#: the mesh wire's replicated leaves (every rank holds them whole): the
#: gathered schedules' table and the psum-q8 consensus
_REPLICATED = ("table", "cons")


def _tree_map(fn, value, top=None):
    """``fn(tensor, top)`` over a dict tree of tensors (None passes
    through); ``top`` is the first key on the tensor's path."""
    if value is None:
        return None
    if isinstance(value, dict):
        return {k: _tree_map(fn, v, top or k) for k, v in value.items()}
    return fn(value, top)


def _zip_map(fn, saved, local, top=None):
    """``fn(saved leaf, local tensor, top)`` over ``local``'s dict tree
    (None passes through) and the same keys of ``saved``; ``top`` as in
    :func:`_tree_map`."""
    if local is None:
        return None
    if isinstance(local, dict):
        return {k: _zip_map(fn, saved[k], v, top or k)
                for k, v in local.items()}
    return fn(saved, local, top)


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
        Both may instead be a LIST of ``n_nodes`` per-node closures (model
        zoo: heterogeneous frozen backbones captured per closure, the shared
        adapter payload as the state, ``cfg.payload="lora"``); an eval
        closure then scores its own node, ``(params [P], val_i) -> scalar``.
        On ``backend="host"`` both are arbitrary Python, called node by
        node: the train step as above (not vmapped) and ``eval_fn(params
        [P], val_i) -> float``.
    params / opt_state : one node's flat params ``[P]`` and optimizer state,
        replicated over the N nodes (the shared warm start), or a list of N
        per-node values (a zoo's payload rows, flattened through
        :meth:`FlatLayout.of_payload`).
    data_sizes : per-node dataset sizes (fedavg / weighted-merge weights).
    backend : ``"engine"`` (default), ``"host"`` (`core.swarm`) or
        ``"gossip"`` (collectives over ``mesh``, one rank a process).
    mesh / axis : the gossip backend's `repro_torch.launch.mesh.SwarmMesh`
        and its swarm axis (``make_swarm_mesh`` returns both).
    param_specs : inner (within-node) sharding of the params on the
        gossip backend, ``{leaf path: spec}`` with one entry per dimension
        of the reference's leaf (`repro_torch.sharding.rules.param_specs`
        makes them): over a mesh with ``data`` / ``model`` axes each rank
        keeps its shard of its nodes between rounds, and a ``TrainStep``
        runs split on it (see the module's docstring). Axes of size 1
        shard nothing, and drop the q8 psums from the cost model's picks,
        as in the reference; a two-level mesh refuses them.
    layout : the :class:`FlatLayout` of the params: the leaf boundaries of
        the wire's block grid, the reference tree of :attr:`node_params` and
        of checkpoints. Without one the params are a single leaf.
    device : where the swarm runs; CUDA unless the caller asks for the CPU.
    seed : session rng seed (defaults to ``cfg.seed``).
    """

    def __init__(self, cfg: SwarmConfig, train_step_fn: Optional[Callable],
                 eval_fn: Optional[Callable], *, params=None, opt_state=None,
                 data_sizes: Optional[Sequence[float]] = None,
                 backend: str = "engine",
                 layout: Optional[FlatLayout] = None, device="cuda",
                 seed: Optional[int] = None, mesh=None,
                 axis: Optional[str] = None, param_specs=None):
        zoo = (isinstance(train_step_fn, (list, tuple))
               or isinstance(eval_fn, (list, tuple)))
        if backend not in ("engine", "gossip", "host"):
            raise ValueError(f"unknown backend {backend!r}")
        if (backend == "host"
                and comms.validate_wire_dtype(cfg.wire_dtype) != "f32"):
            raise ValueError(
                "wire_dtype compression needs a compiled backend "
                '(backend="engine" carries the error-feedback reference; '
                '"gossip" carries the sharded mesh EF state for int8 and '
                "casts bf16); the host loop is uncompressed")
        if backend == "host" and comms.payload_mode(cfg) == "lora":
            raise ValueError(
                'payload="lora" (adapter-only state, heterogeneous '
                "backbones in per-node closures) needs a compiled backend; "
                "the host loop threads full per-node param pytrees")
        if backend == "host" and zoo:
            raise ValueError(
                "per-node closure lists (model zoo) are engine-backend "
                "only; the host loop applies one callable to every node")
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "torch.backends.cuda.matmul.allow_tf32 is True: the merge "
                "contraction must run in full f32, as the reference's "
                "HIGHEST-precision mix does")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.backend = backend
        n = cfg.n_nodes
        if params is None:
            raise ValueError("SwarmSession needs initial params")
        self.layout = layout
        self._rows = None      # gossip: this rank's nodes
        stacked_params = _stack_per_node(params, n, self.device)
        stacked_opt = _stack_per_node(opt_state, n, self.device)
        self._param_dtype = stacked_params.dtype
        self._payload_params = comms.payload_param_count(
            stacked_params, comms.split_payload_at_sync(cfg), n, layout)
        if backend == "host":
            # the host loop: one NodeState a node, its rows views of the
            # stacked buffers (see `core.swarm`)
            sizes = (np.ones(n) if data_sizes is None
                     else np.asarray(data_sizes, np.float64))
            opts = [None if stacked_opt is None
                    else _index_node(stacked_opt, i) for i in range(n)]
            nodes = [NodeState(params=p, opt_state=o, data_size=float(sz))
                     for p, o, sz in zip(stacked_params.unbind(0), opts,
                                         sizes)]
            self._learner = SwarmLearner(cfg, train_step_fn, eval_fn, nodes,
                                         layout=layout)
            self.engine = self._learner.engine
            self._rng = prng_key(cfg.seed if seed is None else seed)
            self._round_ct = 0
            self.sync_schedule = comms.pick_schedule(cfg, simulated=True)
            return
        self.engine = SwarmEngine(
            cfg, train_step_fn, eval_fn, data_sizes=data_sizes,
            layout=layout, backend="gossip" if backend == "gossip" else "host",
            mesh=mesh, axis=axis, param_specs=param_specs)
        self._rows = self.engine.mesh.rows if backend == "gossip" else None
        if self._rows is not None:
            # a rank keeps its nodes' rows (its shard of them)
            stacked_params = self.engine.shard_tensor(
                _node_rows(stacked_params, self._rows, 0))
            stacked_opt = self._per_node(
                self.engine.shard_tensor,
                _node_rows(stacked_opt, self._rows, 0))
        self._state = SwarmState(
            params=stacked_params, opt_state=stacked_opt,
            stats=self.engine.init_stats(stacked_params),
            wire=self.engine._auto_wire(stacked_params, None),
            active=torch.ones((n,), dtype=torch.bool, device=self.device),
            rng=prng_key(cfg.seed if seed is None else seed))
        # the cost model's schedule, surfaced for logs and benchmarks
        self.sync_schedule = self.engine.sync_schedule

    # -- predicted wire cost -------------------------------------------------

    @property
    def payload_params(self) -> int:
        """Per-node payload values P that cross the wire per sync."""
        return self._payload_params

    @property
    def predicted_sync_bytes(self) -> float:
        return self.sync_schedule.bytes_per_sync(self.payload_params)

    @property
    def predicted_link_bytes(self) -> dict:
        return self.sync_schedule.bytes_by_link_class(self.payload_params)

    @property
    def counted_step_bytes(self) -> Optional[dict]:
        """A split step's bytes by collective, of this rank's last step
        (`core.engine.SwarmEngine.step_bytes`: ``layer_gather``, the
        gradient's ``grad_reduce_scatter``, ``grad_reduce_owner`` and
        ``grad_reduce``, ``step_control``); None without one."""
        return None if self.backend == "host" else self.engine.step_bytes

    @property
    def counted_sync_bytes(self) -> Optional[dict]:
        """Gossip backend: the bytes this rank handed to the collectives in
        its last sync (`core.gossip.sync_bytes`: ``by_collective``,
        ``by_link_class``, ``control``); None before one, or on another
        backend."""
        return None if self.backend != "gossip" else self.engine.sync_bytes

    # -- state ---------------------------------------------------------------

    @property
    def state(self) -> SwarmState:
        """The swarm's state. On the engine backend these are the session's
        own buffers, updated in place by every later step and round (the
        reference donates them to its compiled round): keep a ``.clone()``
        of what must outlive one. On the host backend a stacked copy of the
        nodes' state, built on each read."""
        if self.backend != "host":
            return self._state
        lr = self._learner
        nodes = lr.nodes
        stats = None
        if lr.strategy.uses_stats:
            stats = torch.stack([
                nd.fisher_stats if nd.fisher_stats is not None
                else lr.zero_stats(nd.params) for nd in nodes])
        opt = (None if all(nd.opt_state is None for nd in nodes)
               else _stack_nodes([nd.opt_state for nd in nodes]))
        return SwarmState(
            params=torch.stack([nd.params for nd in nodes]), opt_state=opt,
            stats=stats, active=torch.tensor(
                [nd.active for nd in nodes], device=self.device),
            rng=self._rng, round=self._round_ct, step=lr.step)

    def load_state(self, state: SwarmState) -> None:
        """Replace the session's state (either backend)."""
        if self.backend != "host":
            self._state = state
            return
        lr = self._learner
        active = np.asarray(torch.as_tensor(state.active).cpu())
        for i, nd in enumerate(lr.nodes):
            nd.params = state.params[i]
            nd.opt_state = (None if state.opt_state is None
                            else _index_node(state.opt_state, i))
            nd.fisher_stats = (None if state.stats is None
                               else state.stats[i])
            nd.active = bool(active[i])
        self._rng = np.asarray(state.rng, np.uint32)
        self._round_ct = int(state.round)
        lr.step = int(state.step)

    @property
    def node_params(self) -> List[dict]:
        """Per-node parameters in the reference's tree layout (numpy
        leaves): ``stem``/``blocks``/``head`` with HWIO convs for the CNN,
        the flat path-keyed payload dict in ``payload="lora"`` mode; flat
        ``[P]`` rows when the session has no layout."""
        if self.backend == "host":
            rows = [nd.params for nd in self._learner.nodes]
        elif self._rows is not None:
            # every rank gathers the whole swarm (its shards first)
            from repro_torch.core import gossip
            rows = list(gossip.all_gather(
                self.engine.mesh, self.engine.node_tensor(
                    self._state.params, kind="control"),
                kind="control").unbind(0))
        else:
            rows = list(self._state.params.unbind(0))
        if self.layout is None:
            return rows
        return [to_reference_tree(self.layout, row) for row in rows]

    @property
    def active(self):
        if self.backend == "host":
            return np.asarray([nd.active for nd in self._learner.nodes])
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
        if self.backend == "host":
            for i, v in enumerate(np.asarray(mask)):
                self._learner.nodes[i].active = bool(v)
            return
        self._state = dataclasses.replace(
            self._state,
            active=torch.as_tensor(mask, device=self.device).to(torch.bool))

    def _set_active_index(self, node: int, value: bool) -> None:
        if self.backend == "host":
            self._learner.nodes[node].active = value
            return
        active = self._state.active.clone()
        active[node] = value
        self._state = dataclasses.replace(self._state, active=active)

    def quarantine_wire(self, node: Optional[int] = None) -> None:
        """Reset the error-feedback reference for a crash → rejoin: zero
        ``node``'s row of θ̂ (its next sync retransmits its full payload;
        everyone else's residual is untouched), or all of θ̂ when ``node``
        is None. A no-op without wire state (the host loop's wire is
        uncompressed)."""
        if self.backend == "host":
            return
        wire = self._state.wire
        if wire is None:
            return
        if self._rows is not None:
            # the neighbour replicas must track their senders bit for bit:
            # the whole mesh wire resets, on every rank
            from repro_torch.core import gossip
            self._state = dataclasses.replace(
                self._state, wire=gossip.reset_mesh_wire(wire))
            return
        wire = wire.clone()
        if node is None:
            wire.zero_()
        else:
            wire[node] = 0
        self._state = dataclasses.replace(self._state, wire=wire)

    # -- drivers -------------------------------------------------------------

    def round(self, batches, val, faults=None):
        """One full round: ``sync_every`` local steps + gated sync.

        engine: ``batches`` is a stacked ``[T, N, ...]`` batch pytree; the
        log holds device tensors ``gates`` / ``metric_local`` /
        ``metric_merged`` [N] and ``train`` ([T, N] per-step metrics). The
        params, moments and statistics are updated in their own buffers, so
        a :attr:`state` read before the round sees the round's result.
        host: ``batches`` is a ``[T][N]`` nested list of per-node batch
        objects (``None`` skips a node's step), ``val`` an ``[N]`` list,
        both handed to the callables as they are; the log is the
        `SwarmLearner` sync record, the same ``gates`` / ``metric_local`` /
        ``metric_merged`` keys as Python lists plus ``step`` /
        ``spectral_gap``, with per-step train metrics in each node's
        ``history``.

        ``faults``: optional `repro_torch.faults.signals.FaultSignals` —
        corrupt-wire injection on the engine backend's quantized wire
        (flagged senders quarantined for the round, ``"wire_ok"`` in the
        log); a ``ValueError`` on the f32 wire or the host loop, raised
        before any step runs. `repro_torch.faults.run_plan` drives a whole
        fault plan."""
        if self.backend == "host":
            if faults is not None:
                raise ValueError(
                    "in-graph fault injection (faults=) needs a compiled "
                    "backend; lower corrupt events to drops on the host loop")
            return self._host_round(batches, val)
        self.engine.check_faults(faults, self._state.wire)
        batches, val = self._mine(batches, 1), self._mine(val, 0)
        train = self._local_steps(batches)
        committed, log = self._sync(val, faults)
        self._commit(committed)
        return dict(log, train=train)

    def _commit(self, committed) -> None:
        """The committed params written into the state's own buffer."""
        params = self._state.params
        if committed is not params:
            params.copy_(committed)

    @staticmethod
    def _per_node(fn, value):
        """``fn`` over every per-node ``[rows, W]`` tensor of a state field
        (a tensor or a dict tree of them); anything else (the AdamW count)
        as it is."""
        if value is None:
            return None
        if isinstance(value, dict):
            return {k: SwarmSession._per_node(fn, v)
                    for k, v in value.items()}
        return fn(value) if value.dim() == 2 else value

    def _map_state(self, fn, st: SwarmState, wire: bool = False
                   ) -> SwarmState:
        """The state with ``fn`` applied to its params, moments and
        statistics (and its mesh wire, with ``wire``)."""
        return dataclasses.replace(
            st, params=fn(st.params),
            opt_state=self._per_node(fn, st.opt_state),
            stats=self._per_node(fn, st.stats),
            wire=self._per_node(fn, st.wire) if wire else st.wire)

    def _local_steps(self, batches):
        """The local steps of ``[T, N, ...]`` batches. With inner sharding
        a split step (`repro_torch.launch.train.TrainStep`) runs on the
        rank's shard; for any other step the node's params, moments and
        statistics are gathered over its shard group first (uncounted: not
        sync traffic), the steps run on the whole node, and the rank keeps
        its shard after them (also when a step raises)."""
        if self.engine.shard is None or self.engine.splits:
            return self._node_steps(batches)
        eng = self.engine
        self._state = self._map_state(
            lambda t: eng.node_tensor(t, kind=None), self._state)
        try:
            return self._node_steps(batches)
        finally:
            self._state = self._map_state(eng.shard_tensor, self._state)

    def _node_steps(self, batches):
        """The local steps of ``[T, N, ...]`` batches, one engine call a
        step, the session's state replaced after each: a step's inputs are
        then held by nobody once the next one returns, so at most two
        generations of params and moments are alive (the reference donates
        them to its compiled round). A round whose sync then fails keeps
        its local steps. Returns the metrics stacked [T, N]."""
        logs = []
        for k in range(_leading(batches)):
            st = self._state
            stats = (st.stats if st.stats is not None
                     else self.engine.init_stats(st.params))
            p, o, stats, m = self.engine.local_steps(
                st.params, st.opt_state, _index(batches, slice(k, k + 1)),
                st.step, stats)
            self._state = dataclasses.replace(st, params=p, opt_state=o,
                                              stats=stats, step=st.step + 1)
            logs.append(m)
        return {key: torch.cat([m[key] for m in logs]) for key in logs[0]}

    def _sync(self, val, faults=None):
        """The gated sync of the session's params: the wire reference
        advances, the round counter and the rng fold; returns (committed
        params, log) and leaves the params to the caller."""
        st = self._state
        committed, log = self.engine.sync(st.params, val, st.active,
                                          stats=st.stats, wire=st.wire,
                                          faults=faults)
        self._state = dataclasses.replace(
            st, wire=log.pop("wire", st.wire),
            rng=fold_in_key(st.rng, st.round), round=st.round + 1)
        return committed, log

    def run_rounds(self, batches, val):
        """R rounds over ``[R, T, N, ...]`` batches. Returns the per-round
        logs stacked ``[R, ...]`` plus a ``train`` key ([R, T, N]).
        ``cfg.overlap_sync`` switches to the stale-by-one schedule: round
        k's commit delta is folded in after round k+1's local steps, each
        part of the params in its own dtype. On the host backend the
        ``[R][T][N]`` rounds run one by one and the logs come back as
        per-key lists of the R round logs."""
        if self.backend == "host":
            logs = [self._host_round(rb, val) for rb in batches]
            return {k: [lg[k] for lg in logs] for k in logs[0]}
        batches, val = self._mine(batches, 2), self._mine(val, 0)
        # the state's own layout (a shard's on an inner-sharded mesh)
        lay = self.engine.layout
        split = (lambda p: (p,)) if lay is None else lay.parts

        def land(deltas):
            # a commit delta added into the params buffer, part by part
            for a, d in zip(split(self._state.params), deltas):
                a.add_(d)

        pending = None
        logs, train = [], []
        for k in range(_leading(batches)):
            train.append(self._local_steps(_index(batches, k)))
            committed, log = self._sync(val)
            if self.cfg.overlap_sync:
                # local steps never wait on the in-flight merge: this
                # round's commit lands one round late
                fresh = tuple(c - a for c, a in zip(
                    split(committed), split(self._state.params)))
                if pending is not None:
                    land(pending)
                pending = fresh
            else:
                self._commit(committed)
            del committed
            logs.append(log)
        if pending is not None:       # no accepted merge is dropped
            land(pending)
        return dict(_stack_logs(logs), train=_stack_logs(train))

    def run_local(self, batches):
        """Sync-free local training over ``[S, N, ...]`` batches (engine;
        returns the metrics [S, N]) or ``[S][N]`` nested lists (host;
        returns None)."""
        if self.backend == "host":
            for step_batches in batches:
                self._learner.local_steps(step_batches)
            return None
        return self._local_steps(self._mine(batches, 1))

    def _mine(self, tree, dim: int):
        """Batches or validation rows on the session's device: on the
        gossip backend the rank's nodes of the node axis ``dim``."""
        if self._rows is not None:
            tree = _node_rows(tree, self._rows, dim)
        return _to_device(tree, self.device)

    def _host_round(self, batches, val):
        lr = self._learner
        for step_batches in batches:
            lr.local_steps(step_batches)
        log = lr.sync(val)
        self._rng = fold_in_key(self._rng, self._round_ct)
        self._round_ct += 1
        return log

    # -- checkpoint / resume -------------------------------------------------

    def _tree_layout(self, t) -> Optional[FlatLayout]:
        """The layout a stacked ``[N, W]`` state tensor is laid out in: the
        params' slots, the value vector (moments, statistics, the wire) or
        the adapter payload (the wire of an adapter-only sync); None for
        anything else."""
        if self.layout is None or t.dim() != 2 \
                or t.shape[0] != self.cfg.n_nodes:
            return None
        width = t.shape[1]
        if width == self.layout.size and (
                t.dtype == self._param_dtype or not self.layout.wide):
            return self.layout
        if t.dtype == torch.float32 and width == self.layout.n_values:
            return self.layout.value_layout
        if self.engine._split_lora:
            payload = self._full_payload_layout()
            if t.dtype == torch.float32 and width == payload.size:
                return payload
        return None

    def _full_payload_layout(self):
        """The sync payload's layout of a whole node: the adapters, or
        every value (a shard's payload on an inner-sharded mesh is
        ``engine._payload_layout``)."""
        eng = self.engine
        if eng.payload_shard() is not None:
            return eng.payload_shard().full
        return eng._payload_layout("cpu")

    def _reference_tree(self, value):
        """A state field in the reference's tree layout (numpy leaves):
        ``[N, P]`` buffers become the layout's param tree (HWIO convs)."""
        if value is None:
            return None
        if isinstance(value, dict):
            return {k: self._reference_tree(v) for k, v in value.items()}
        t = value.detach().cpu()
        layout = self._tree_layout(t)
        if layout is not None:
            return to_reference_tree(layout, t)
        return t.numpy()

    def _from_reference_tree(self, tree, like):
        """Inverse of :meth:`_reference_tree`, onto ``like``'s device and
        dtype."""
        if like is None:
            return None
        if isinstance(like, dict):
            return {k: self._from_reference_tree(tree[k], v)
                    for k, v in like.items()}
        if isinstance(tree, np.ndarray):
            out = torch.from_numpy(np.array(tree))
        else:
            out = from_reference(self._tree_layout(like), tree, lead=1,
                                 dtype=like.dtype)
        return out.to(like.device)

    def _checkpoint_tree(self, st: SwarmState) -> Fields:
        """The reference's ``SwarmState`` pytree, field by field."""
        return Fields(
            params=self._reference_tree(st.params),
            opt_state=self._reference_tree(st.opt_state),
            stats=self._reference_tree(st.stats),
            wire=self._reference_tree(st.wire),
            active=st.active.cpu().numpy(),
            rng=np.asarray(st.rng, np.uint32),
            round=np.asarray(st.round, np.int32),
            step=np.asarray(st.step, np.int32))

    # -- the gossip backend's whole-swarm state ----------------------------

    def _gossip_global(self, st: SwarmState, shard):
        """``(params, opt_state, stats, wire)`` of the whole swarm from this
        rank's: each rank-sharded tensor ``[r, ...]`` through ``shard`` (to
        ``[W·r, ...]``, rank order), a replicated wire leaf as it is."""
        def one(t, top):
            return t if top in _REPLICATED else shard(t)
        return (shard(st.params), _tree_map(one, st.opt_state),
                None if st.stats is None else shard(st.stats),
                _tree_map(one, st.wire))

    def _wire_chunked(self, top) -> bool:
        """Whether a mesh wire leaf holds chunks of the padded grid (the
        psum-q8 residual, every hierarchical reference), which the
        reference keeps as ``[rows, chunk]`` a leaf."""
        return top == "cres" or self.sync_schedule.name.startswith("hier_")

    def _wire_codec(self):
        """``(to_tree, from_tree)`` of one mesh wire tensor and the
        reference's leaves of it: its payload's tree (``[rows, *leaf]``) or
        chunk tree (``[rows, chunk]`` a leaf)."""
        from repro_torch.core import gossip
        eng = self.engine
        layout = self._full_payload_layout()
        chunks = (None if layout is None else gossip.padded_grid(
            layout, eng.wire_block, eng.mesh_chunks()).leaf_chunks)

        def to_tree(t, top):
            t = t.detach().cpu()
            if layout is None:
                return t.numpy()
            if self._wire_chunked(top):
                return chunks_to_reference_tree(chunks, t)
            return to_reference_tree(layout, t)

        def from_tree(tree, top):
            if layout is None:
                return torch.from_numpy(np.array(tree))
            if self._wire_chunked(top):
                return chunks_from_reference(chunks, tree)
            return from_reference(layout, tree, lead=1)

        return to_tree, from_tree

    def _gossip_tree(self, fields, st: SwarmState) -> Fields:
        """The reference's global ``SwarmState`` pytree of the whole-swarm
        ``fields`` (:meth:`_gossip_global`)."""
        params, opt, stats, wire = fields
        to_tree, _ = self._wire_codec()
        return Fields(
            params=self._reference_tree(params),
            opt_state=self._reference_tree(opt),
            stats=self._reference_tree(stats),
            wire=_tree_map(to_tree, wire),
            active=st.active.cpu().numpy(),
            rng=np.asarray(st.rng, np.uint32),
            round=np.asarray(st.round, np.int32),
            step=np.asarray(st.step, np.int32))

    def _save_gossip(self, path: str, meta: dict) -> None:
        """Collective: every rank's rows (its shards first) gathered (not
        sync traffic: no byte count), the first rank writes, all wait."""
        import torch.distributed as dist
        from repro_torch.core import gossip

        eng = self.engine
        mesh = eng.mesh
        st = self._map_state(lambda t: eng.node_tensor(t, kind=None),
                             self._state, wire=True)
        # on an inner-sharded mesh every node group now holds the same
        # whole nodes: the first one gathers the swarm, its rank 0 writes
        if not any(mesh.coords.values()):
            fields = self._gossip_global(
                st, lambda t: gossip.all_gather(mesh, t, kind=None))
            if mesh.rank == 0:
                save_pytree(path, self._gossip_tree(fields, st),
                            metadata=meta)
            del fields
        del st
        dist.barrier(group=mesh.world_group)

    def _load_gossip(self, path: str) -> None:
        """Every rank reads the whole swarm and keeps its rows (its shard
        of them)."""
        eng = self.engine
        mesh = eng.mesh
        world, rank = mesh.world_size, mesh.rank
        # the node-wide shapes of the rank's state (no data)
        st = self._map_state(lambda t: torch.empty(
            t.shape[:-1] + (eng.node_width(t.shape[-1]),), dtype=t.dtype,
            device="meta"), self._state, wire=True)
        like = tuple(_tree_map(
            lambda t, top: torch.zeros(t.shape, dtype=t.dtype) if t.is_meta
            else t, f) for f in self._gossip_global(st, lambda t: torch.zeros(
                (world * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype)))
        tree = load_pytree(path, self._gossip_tree(like, st))
        _, from_tree = self._wire_codec()

        def mine(full, local, top=None):
            if top not in _REPLICATED:
                r = local.shape[0]
                full = full[rank * r:(rank + 1) * r]
            full = full.to(device=self.device, dtype=local.dtype, copy=True)
            return eng.shard_tensor(full) if full.dim() == 2 else full

        fields = {f: _zip_map(mine, self._from_reference_tree(tree[f], glob),
                              getattr(st, f))
                  for f, glob in zip(("params", "opt_state", "stats"), like)}
        fields["wire"] = _zip_map(
            lambda saved, local, top: mine(from_tree(saved, top), local, top),
            tree["wire"], st.wire)
        self.load_state(SwarmState(
            **fields, active=torch.from_numpy(np.array(tree["active"])).to(
                self.device, torch.bool),
            rng=np.array(tree["rng"], np.uint32),
            round=int(tree["round"]), step=int(tree["step"])))

    # -- checkpoint / resume (every backend) -------------------------------

    def save(self, path: str) -> None:
        """Checkpoint the FULL session state (params, opt state, strategy
        stats, wire reference, active mask, rng, counters) in the
        reference's msgpack layout. On the gossip backend every rank calls
        it: the file holds the whole swarm, written by rank 0."""
        st = self.state
        meta = {"cfg": dataclasses.asdict(self.cfg), "backend": self.backend,
                "round": int(st.round), "step": int(st.step), "format": 1}
        if self._rows is not None:
            self._save_gossip(path, meta)
            return
        save_pytree(path, self._checkpoint_tree(st), metadata=meta)

    def load(self, path: str) -> "SwarmSession":
        """Restore a checkpoint into this session (same cfg and shapes). On
        the gossip backend every rank calls it and keeps its rows."""
        saved_cfg = load_metadata(path).get("cfg", {})
        for key in ("n_nodes", "merge", "topology", "lora_only",
                    "payload", "wire_dtype"):
            if key in saved_cfg and saved_cfg[key] != getattr(self.cfg, key):
                raise ValueError(
                    f"checkpoint cfg mismatch: {key}={saved_cfg[key]!r} "
                    f"saved vs {getattr(self.cfg, key)!r} in session")
        if self._rows is not None:
            self._load_gossip(path)
            return self
        st = self.state
        tree = load_pytree(path, self._checkpoint_tree(st))
        fields = ("params", "opt_state", "stats", "wire")
        self.load_state(SwarmState(
            **{f: self._from_reference_tree(tree[f], getattr(st, f))
               for f in fields},
            active=torch.from_numpy(np.array(tree["active"])).to(
                self.device, torch.bool),
            rng=np.array(tree["rng"], np.uint32),
            round=int(tree["round"]), step=int(tree["step"])))
        return self

    @classmethod
    def restore(cls, path: str, cfg: SwarmConfig, train_step_fn, eval_fn,
                **kwargs) -> "SwarmSession":
        """Build a session (constructor kwargs supply the param template)
        and restore the checkpointed state into it."""
        return cls(cfg, train_step_fn, eval_fn, **kwargs).load(path)


def load_checkpoint_params(path: str, params_template: torch.Tensor, *,
                           layout: Optional[FlatLayout] = None,
                           expect_nodes: Optional[int] = None
                           ) -> torch.Tensor:
    """Read ONLY the stacked per-node params out of a full
    :meth:`SwarmSession.save` checkpoint (the serving plane's ingest).

    ``params_template`` is a stacked ``[N, P]`` tensor with the target
    shape, dtype and device; ``layout`` its :class:`FlatLayout` (None for a
    single-leaf ``.params``). The opt state, stats, wire and counters are
    never read into tensors. ``expect_nodes`` cross-checks the checkpoint
    cfg's ``n_nodes``."""
    saved_cfg = load_metadata(path).get("cfg", {})
    if (expect_nodes is not None and "n_nodes" in saved_cfg
            and saved_cfg["n_nodes"] != expect_nodes):
        raise ValueError(
            f"checkpoint has n_nodes={saved_cfg['n_nodes']}, the serving "
            f"ensemble expects {expect_nodes}")
    t = params_template.detach().cpu()
    like = t.numpy() if layout is None else to_reference_tree(layout, t)
    tree = load_pytree(path, Fields(params=like))["params"]
    out = (torch.from_numpy(np.array(tree)) if layout is None
           else from_reference(layout, tree, lead=1,
                               dtype=params_template.dtype))
    return out.to(device=params_template.device, dtype=params_template.dtype)
