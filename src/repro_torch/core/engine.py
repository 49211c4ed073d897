"""Stacked swarm engine: the P2P-SL round over the flat ``[N, P]`` state.

Port of ``repro.core.engine`` (engine/host backend). The engine gives the
pieces of a round and `repro_torch.core.session.SwarmSession` drives them
(``round``, ``run_rounds``, ``run_local``: one :meth:`SwarmEngine.
local_steps` call a step, then :meth:`SwarmEngine.sync`). One round is

  local steps   ``torch.func.vmap`` of the per-node train step over the node
                axis, a Python loop over the ``sync_every`` steps; the merge
                strategy accumulates importance statistics in the same loop;
  propose       the strategy's candidate (mixing-matrix contraction or
                Fisher-weighted merge), with W built on the device from the
                runtime ``active`` mask;
  gate          the stacked ``eval_fn`` scores local and merged params for
                every node at once → per-node accept bits, all on the device;
  commit        `kernels.fused_merge.fused_merge_all`: one launch of the
                hand-written CUDA kernel over ``[N, P]`` (mean/fedavg
                re-contract the W rows, fisher/gradmatch pass their
                importance, plus the gate), as the reference's
                ``host_commit`` does leaf by leaf.

With ``cfg.wire_dtype`` = ``"int8"``/``"bf16"`` the peers exchange the
quantized error-feedback wire (`core.comms`): propose and the gate see the
wire reconstruction θ̂' = θ̂ + deq(q(θ − θ̂)), and the commit is one launch of
`kernels.fused_merge.fused_quant_merge_all`, which re-derives θ̂' and merges
it; the advanced θ̂' comes back in the log under ``"wire"``. On that wire a
round takes fault signals (``faults=``, `repro_torch.faults`): flagged
senders' θ̂' arrive bit-flipped, the per-payload checksum detects it, and the
sender is quarantined for the round (``"wire_ok"`` in the log).

Contracts: ``train_step_fn(params [P], opt_state, batch, step) -> (params,
opt_state, metrics)`` is per node and is vmapped here, as the reference
vmaps it (or the true-Fisher 4-tuple ``(..., grads)``, whose per-step
gradients feed the strategy's ``accumulate_grads``); ``eval_fn(params
[N, P], val) -> [N]`` takes the whole swarm (the gate metrics carry an
explicit node axis). Both may instead be a LIST of N
per-node closures (the heterogeneous model zoo, ``cfg.payload="lora"``:
each node's frozen backbone lives in its closures, the stacked state is the
shared adapter payload): :func:`zoo_vstep` and :func:`zoo_veval` call them
node by node and restack, with the same stacked-in, stacked-out contract;
an eval closure then scores one node, ``(params [P], val_i) -> scalar``.

**Values.** The sync treats the params as numbers. A buffer whose slots
are its values (no wide leaf) syncs on the f32 wire in its own dtype, one
``fused_merge_all`` launch, as before the wide leaves. Otherwise it reads
the ``[N, P]`` slot buffer as its f32 value vector (`repro_torch.core.flat`:
``FlatLayout.values``), so a bf16 LM's wide leaves (f32 ``A_log``, ``D``,
``dt_bias``, ``lora_scale``) merge, cross the wire and enter the checksum
as f32 numbers and the rest as the f32 of its bf16 values; importance
statistics, the wire reference θ̂ and the optimizer's moments live over
values too. Propose, the quantized round trip and the commit run on that
``[N, n_values]`` f32 vector (one commit launch: `fused_quant_merge_all`
takes f32 params only, so the quantized wire needs that vector in any
case), and the result is written back into slots, each leaf in its dtype:
a rejected row or a leaf outside the payload comes back bit for bit.

**Adapter-only sync** (``lora_only=True`` with ``payload="full"``, the
LoRA'd LM of the trainer): the adapter leaves (``lora_`` paths) are carved
out of the value vector at sync; propose, the wire, the checksum and the
commit see only them, and the base passes through, as the reference's
``strategy_propose`` / ``host_commit`` do with ``split_adapters``.

The host loop (`repro_torch.core.swarm.SwarmLearner`, the session's
``backend="host"``) shares the strategy pieces through
:meth:`SwarmEngine.propose_host` and :meth:`SwarmEngine.commit_host`.

**The gossip backend** (``backend="gossip"``, ``mesh`` a
`repro_torch.launch.mesh.SwarmMesh`): one engine a rank, over the rank's
rows ``[per, P]`` of params, statistics and wire, with the rank's rows of
the validation set; the replicated ``[N]`` active mask. Propose runs the
collective schedule the cost model picks for ``per`` nodes a rank
(`core.gossip`, :meth:`SwarmEngine._propose_gossip`), the gate scores the
rank's nodes and all-gathers the ``[N]`` metrics (every rank returns the
reference's ``[N]`` logs), and the commit is the reference's where-select
(:func:`gated_commit`): its gossip backend has no kernel commit. On the
int8 wire the schedule's mesh error-feedback state (`core.gossip.
init_mesh_wire`) comes back in the log under ``"wire"``. On a two-level
``("pod", "node")`` mesh the cost model prices the flat schedules as
cross-pod traffic and offers the hierarchical pod-delegate forms, which
win when ``cfg.cross_pod_cost`` dominates.

With ``param_specs`` that name the swarm mesh's ``data`` / ``model`` axes
(`repro_torch.sharding.rules.param_specs`) a rank holds one block of each
of its nodes (`repro_torch.core.flat.ShardLayout`): :attr:`SwarmEngine.
layout` is the shard's, :attr:`SwarmEngine.step_layout` the node's. A
train step with a split form (`repro_torch.launch.train.TrainStep`) then
runs on the shard (:attr:`SwarmEngine.splits`: each layer gathered just in
time, the batch over the node's data ranks, each layer's work over its
model ranks, gradients and AdamW on the shard); the session gathers the
whole node for any other step. The
sync's payload, wire and commit are the shard's, the schedule runs on the
rank's node group, and the gate scores the node's params and candidate
through the eval's split form (`repro_torch.launch.train.SwarmEval`,
:attr:`SwarmEngine.split_gate`: a layer at a time on the shard), or
gathered whole over its shard group for any other eval
(:meth:`SwarmEngine.node_tensor`), so every rank of a node reaches the
same gate bits. The split gate trades gate bytes for peak memory: a
layer's gather carries every rank's block of every cut leaf, zeros where
the rank's span of a leaf's layer axis does not hold the layer
(`repro_torch.core.flat.LayerCut`), so a leaf whose layer axis is cut
moves more than its bytes; with ``model`` above 1 a rank is sent only the
pieces of its compute blocks it does not store (tensor parallelism).
Mamba2-370M at 2 layers on (2, 2, 1), whose tied embedding is whole on
every rank and moves nothing, hands over 44,302,336 bytes a rank a sync
through the split gate against 233,037,312 through the whole-node gather
(measured on an NVIDIA H100 80GB HBM3 at 700 W). The cost
model then drops the q8 psums, as the reference's does
(``model_sharded``). A two-level mesh refuses inner specs.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import SwarmConfig
from repro_torch.core import comms
from repro_torch.core import merge_impl as merge_lib
from repro_torch.core import topology as topo
from repro_torch.core.flat import FlatLayout
from repro_torch.core.lora import is_adapter_path
from repro_torch.faults.signals import flip_payload_bits
from repro_torch.kernels.fused_merge import (fused_merge_all,
                                             fused_quant_merge_all)


# ---------------------------------------------------------------------------
# model-zoo dispatch: per-node closures over a shared stacked payload
# ---------------------------------------------------------------------------
# In the heterogeneous payload="lora" mode every node's frozen backbone lives
# inside its own train/eval closure and only the shared adapter payload is
# stacked. One vmap cannot dispatch to N different programs, so closure
# lists run node by node in a Python loop, and the outputs restack: the same
# (stacked in, stacked out) contract as the vmapped homogeneous path.

def _index_node(tree, i: int):
    """Row ``i`` of every stacked tensor of a dict/tuple/list tree (None
    passes through)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _index_node(v, i) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_index_node(v, i) for v in tree)
    return tree[i]


def _write_node(tree, i: int, new) -> None:
    """Write a per-node tree ``new`` into row ``i`` of the stacked
    ``tree`` (a tensor that already is that row passes)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            _write_node(v, i, new[k])
        return
    row = tree[i]
    if not (new.data_ptr() == row.data_ptr() and new.shape == row.shape):
        row.copy_(new)


def _stack_nodes(trees):
    """Inverse of :func:`_index_node` over a list of per-node trees."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack_nodes([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack_nodes([t[j] for t in trees])
                           for j in range(len(first)))
    return torch.stack([torch.as_tensor(t) for t in trees])


def _restack(trees, like):
    """:func:`_stack_nodes` of per-node trees, except that a tensor whose
    N rows are the rows of ``like``'s tensor (a step that wrote node i's
    row view in place) comes back as ``like``'s tensor itself."""
    first = trees[0]
    if isinstance(first, dict) and isinstance(like, dict):
        return {key: _restack([t[key] for t in trees], like.get(key))
                for key in first}
    if (isinstance(first, torch.Tensor) and isinstance(like, torch.Tensor)
            and like.dim() > 0 and len(trees) == like.shape[0]
            and all(t.shape == like.shape[1:] and t.stride()
                    == like[i].stride() and t.data_ptr()
                    == like[i].data_ptr() for i, t in enumerate(trees))):
        return like
    return _stack_nodes(trees)


def zoo_vstep(step_fns: Sequence[Callable]) -> Callable:
    """Stacked train-step dispatcher over per-node closures.

    Each ``step_fns[i]`` sees node i's (params, opt_state, batch) rows and
    must return the same 3-tuple ``(params, opt_state, metrics)`` (or the
    reference's true-Fisher 4-tuple) with structurally identical outputs
    across nodes; the backbones may differ arbitrarily inside the closures.
    """
    step_fns = list(step_fns)

    def vstep(p, o, b, s):
        outs = [fn(_index_node(p, i), _index_node(o, i), _index_node(b, i), s)
                for i, fn in enumerate(step_fns)]
        k = len(outs[0])
        if any(len(out) != k for out in outs):
            raise ValueError("zoo train steps must agree on the 3-tuple vs "
                             "true-Fisher 4-tuple return form")
        # a step that updated its rows in place hands back the stacked
        # input itself; any other output is stacked anew
        return tuple(_restack([out[j] for out in outs], like)
                     for j, like in zip(range(k), (p, o) + (None,) * k))

    return vstep


def zoo_veval(eval_fns: Sequence[Callable]) -> Callable:
    """Stacked eval dispatcher: node i's closure scores its own params row
    on its own validation rows → the ``[N]`` metric vector."""
    eval_fns = list(eval_fns)

    def veval(p, val):
        return torch.stack([
            torch.as_tensor(fn(_index_node(p, i), _index_node(val, i)),
                            dtype=torch.float32, device=p.device).reshape(())
            for i, fn in enumerate(eval_fns)])

    return veval


def _vmap_stateless(step_fn: Callable) -> Callable:
    """vmap of a per-node train step over the node axis for a stateless
    optimizer: the ``None`` opt_state goes around the vmap, so the step may
    return the 3-tuple or the true-Fisher 4-tuple."""
    def step(p, b, s):
        out = step_fn(p, None, b, s)
        return (out[0],) + tuple(out[2:])

    vstep = torch.func.vmap(step, in_dims=(0, 0, None))

    def run(p, o, b, s):
        out = vstep(p, b, s)
        return (out[0], None) + tuple(out[1:])

    return run


def mixing_matrix(cfg: SwarmConfig, data_sizes: Sequence[float],
                  active: Optional[Sequence[bool]] = None) -> np.ndarray:
    """Host-side (numpy) mixing matrix for the configured topology."""
    weights = topo.fedavg_weights(data_sizes) if cfg.merge == "fedavg" else None
    return topo.build_matrix(cfg.topology, cfg.n_nodes,
                             weights=weights, self_weight=cfg.self_weight,
                             active=active)


def active_weights(data_sizes, active=None) -> np.ndarray:
    """FedAvg weights zeroed + renormalized over the active membership."""
    w = np.asarray(data_sizes, np.float64)
    if active is not None:
        w = w * np.asarray(active, np.float64)
    s = w.sum()
    if s <= 0:  # nobody active: uniform (downstream gates reject everything)
        return np.full(len(w), 1.0 / len(w))
    return w / s


def active_weights_traced(data_sizes, active: torch.Tensor) -> torch.Tensor:
    """On-device :func:`active_weights` from a runtime mask tensor."""
    w = (torch.as_tensor(data_sizes, dtype=torch.float32, device=active.device)
         * active.to(torch.float32))
    s = w.sum()
    n = w.shape[0]
    return torch.where(s > 0, w / torch.where(s > 0, s, 1.0),
                       torch.full((n,), 1.0 / n, device=active.device))


def gate_decisions(metric_merged, metric_local, threshold: float,
                   mode: str = "relative"):
    """Per-node accept bits. `relative`: merged ≥ thr × local (robust default);
    `absolute`: merged ≥ thr (the paper's literal 80% reading)."""
    if mode == "relative":
        return metric_merged >= threshold * metric_local
    return metric_merged >= threshold


def gated_commit(candidate, local, gates):
    """θ_i ← gate_i ? merged_i : local_i — the unfused select, for a
    candidate that has no kernel form."""
    return torch.where(gates.reshape(-1, 1), candidate, local)


class SwarmEngine:
    """Stacked swarm: vmapped local steps + on-device gated sync.

    backend="host"    the reference's engine backend: N param copies on one
                      device, fused-kernel commit.
    backend="gossip"  one engine a rank of ``mesh`` (``axis`` its swarm
                      axis), over the rank's rows: merge by the collective
                      schedule, where-select commit."""

    def __init__(self, cfg: SwarmConfig, train_step_fn: Optional[Callable],
                 eval_fn: Optional[Callable], *,
                 data_sizes: Optional[Sequence[float]] = None,
                 layout: Optional[FlatLayout] = None, backend: str = "host",
                 mesh=None, axis: Optional[str] = None, param_specs=None):
        zoo = (isinstance(train_step_fn, (list, tuple))
               or isinstance(eval_fn, (list, tuple)))
        if zoo and backend == "gossip":
            raise ValueError(
                "per-node closure lists (model zoo) are engine-backend only: "
                "the gossip backend shards the node axis and per-node "
                "dispatch would lower to cross-shard gathers")
        if backend not in ("host", "gossip"):
            raise ValueError(f"unknown engine backend {backend!r}")
        if backend == "gossip" and (mesh is None or axis is None):
            raise ValueError("gossip backend needs mesh and axis")
        if backend == "gossip":
            if axis != mesh.axis:
                raise ValueError(f"axis {axis!r} is not the mesh's swarm "
                                 f"axis {mesh.axis!r}")
            if mesh.n_nodes != cfg.n_nodes:
                raise ValueError(f"the mesh holds {mesh.n_nodes} nodes, "
                                 f"cfg.n_nodes={cfg.n_nodes}")
        model_sharded = (backend == "gossip"
                         and comms.has_inner_sharding(param_specs))
        # the params' layout for the local steps; on an inner-sharded mesh
        # the sync works on the rank's shard (`core.flat.ShardLayout`)
        self.step_layout = layout
        self.shard = None
        if model_sharded:
            layout = self._shard_layout(mesh, layout, param_specs)
        self.cfg = cfg
        self.backend = backend
        self.mesh = mesh if backend == "gossip" else None
        self._q8 = None
        # gossip: the bytes each collective moved in the last sync
        # (`core.gossip.sync_bytes`)
        self.sync_bytes = None
        self.wire_dtype = comms.validate_wire_dtype(cfg.wire_dtype)
        self.wire_block = comms.validate_wire_block(cfg.wire_block)
        # the leaf boundaries of the payload: the wire's block grid restarts
        # at every leaf, as the reference's per-leaf quantization does (the
        # shard's leaves on an inner-sharded mesh)
        self.layout = layout
        self._payload_shard = None
        self._split_lora = comms.split_payload_at_sync(cfg)
        self._adapters = None
        self._grid = None
        self._ref = None
        # a two-level ("pod", "node") mesh: the per-link-class cost model
        # decides whether the hierarchical pod-delegate forms win
        self.mesh_shape = None
        if self.mesh is not None and isinstance(self.mesh.axis, tuple):
            pod_ax, node_ax = self.mesh.axis
            self.mesh_shape = (self.mesh.shape[pod_ax],
                               self.mesh.shape[node_ax])
        # the engine backend reports the SPMD-equivalent wire cost; the
        # gossip backend runs the schedule picked for its nodes a rank
        # model-sharded payloads drop the q8 psums from the candidates
        self.sync_schedule = comms.pick_schedule(
            cfg, per=1 if self.mesh is None else self.mesh.per,
            simulated=self.mesh is None, model_sharded=model_sharded,
            mesh_shape=self.mesh_shape)
        self.data_sizes = (np.ones(cfg.n_nodes) if data_sizes is None
                           else np.asarray(data_sizes, np.float64))
        self.strategy = merge_lib.get_strategy(cfg)
        self.quorum = cfg.quorum
        if self.quorum > cfg.n_nodes:
            raise ValueError(f"quorum={self.quorum} can never be met with "
                             f"n_nodes={cfg.n_nodes}")
        self.fairness_floor = cfg.fairness_floor
        if not 0.0 <= self.fairness_floor <= 1.0:
            raise ValueError("fairness_floor must be a gate-metric value in "
                             f"[0, 1], got {self.fairness_floor}")

        def fn_list(fn, what):
            fns = list(fn)
            if len(fns) != cfg.n_nodes:
                raise ValueError(f"{what} zoo must list one closure per node "
                                 f"(got {len(fns)}, n_nodes={cfg.n_nodes})")
            return fns

        # closure lists run node by node; a single train step is vmapped
        # over the node axis, and a stateless optimizer (opt_state None) is
        # passed through unbatched
        if isinstance(train_step_fn, (list, tuple)):
            zstep = zoo_vstep(fn_list(train_step_fn, "train_step_fn"))
            self._vstep = {True: zstep, False: zstep}
        else:
            self._vstep = (None if train_step_fn is None else {
                True: torch.func.vmap(train_step_fn, in_dims=(0, 0, 0, None)),
                False: _vmap_stateless(train_step_fn)})
        self._veval = (zoo_veval(fn_list(eval_fn, "eval_fn"))
                       if isinstance(eval_fn, (list, tuple)) else eval_fn)
        # a step with a split form (`launch.train.TrainStep`) runs on the
        # rank's shard of an inner-sharded mesh; any other closure takes
        # the node whole (the session gathers it)
        self.splits = (self.shard is not None
                       and callable(getattr(train_step_fn, "split", None)))
        self._split = train_step_fn if self.splits else None
        # a gate metric with a split form (`launch.train.SwarmEval`) scores
        # each node on the rank's shard, a layer at a time; any other
        # closure scores the node gathered whole
        self.split_gate = (self.shard is not None
                           and callable(getattr(eval_fn, "split", None)))
        #: split steps: the bytes the last step handed to each collective
        #: (``layer_gather``, ``grad_reduce_scatter``,
        #: ``grad_reduce_owner``, ``grad_reduce``, ``step_control``)
        self.step_bytes = None
        self._base_W = mixing_matrix(cfg, self.data_sizes)
        self.spectral_gap = topo.spectral_gap(self._base_W)

    def _shard_layout(self, mesh, layout, param_specs):
        """The rank's shard of a node under ``param_specs`` on the gossip
        mesh; returns the layout the sync works on (the shard's, or
        ``layout`` when no leaf is cut). A two-level mesh refuses inner
        specs, as the reference's hierarchical schedules do."""
        from repro_torch.core.flat import ShardLayout
        from repro_torch.core.gossip import inner_axes
        inner = sorted(set(inner_axes(param_specs)))
        if isinstance(mesh.axis, tuple):
            raise ValueError(
                f"the two-level {mesh.axis} mesh does not support "
                f"model-sharded payloads (param_specs name {inner}): the "
                "hierarchical schedules' delegate chunks slice the "
                "globally-flattened payload, and its flat schedules run "
                "on whole nodes")
        unknown = [a for a in inner if a not in ("data", "model")]
        if unknown:
            raise ValueError(f"param_specs name {unknown}: an inner spec "
                             "names the swarm mesh's data and model axes")
        if layout is None:
            raise ValueError("param_specs need the params' layout (their "
                             "leaf paths)")
        shard = ShardLayout(layout, param_specs, mesh.inner, mesh.coords)
        if not shard.sharded:
            return layout
        self.shard = shard
        return shard.local

    def payload_shard(self):
        """The :class:`~repro_torch.core.flat.ShardLayout` of the sync
        payload's values (every value, or the adapters of an adapter-only
        sync) on an inner-sharded mesh; None otherwise."""
        if self.shard is None:
            return None
        if self._payload_shard is None:
            full = self.shard.full.value_layout
            if self._split_lora:
                full = FlatLayout([(lf.path, lf.shape) for lf in full.leaves
                                   if is_adapter_path(lf.path)])
            self._payload_shard = self.shard.sub(full)
        return self._payload_shard

    def _shard_for(self, width: int, local: bool = True):
        """The shard layout of a tensor of ``width`` (a shard's if
        ``local``, else a node's): the params' (slots or values), else the
        payload's."""
        lay = self.shard.local if local else self.shard.full
        if width in (lay.size, lay.n_values):
            return self.shard
        return self.payload_shard()

    def node_width(self, width: int) -> int:
        """The width of the node tensor whose shard is ``width`` wide."""
        if self.shard is None:
            return width
        shard = self._shard_for(width)
        return (shard.full.size if width == shard.local.size
                else shard.full.n_values)

    def node_tensor(self, t, kind="shard_gather"):
        """A rank's shard rows of a per-node tensor (slots, values or a
        payload's values) gathered over the node's shard group into the
        whole node's (``kind`` names the byte count, None for none); ``t``
        itself without inner sharding."""
        if self.shard is None:
            return t
        return self._shard_for(t.shape[-1]).gather(
            t, self.mesh.shard_view, kind=kind)

    def shard_tensor(self, t):
        """Inverse of :meth:`node_tensor`: this rank's shard of a node
        tensor."""
        if self.shard is None:
            return t
        return self._shard_for(t.shape[-1], local=False).shard(t)

    def init_stats(self, stacked):
        """Strategy importance accumulators over the params' values
        (None for mean/fedavg)."""
        if not self.strategy.uses_stats:
            return None
        shape = (stacked.shape[0], self._n_values(stacked))
        return self.strategy.init_stats(
            torch.empty((), device=stacked.device).expand(shape))

    # -- slots and values ----------------------------------------------------

    def _n_values(self, params) -> int:
        if self.layout is None:
            return params.shape[-1]
        if self.shard is not None and \
                params.shape[-1] == self.step_layout.size:
            return self.step_layout.n_values     # a whole node's slots
        return self.layout.n_values

    def _values(self, params):
        """``[N, P]`` slots → the f32 value vector ``[N, n_values]``."""
        if self.layout is None:
            return params.to(torch.float32)
        return self.layout.values(params)

    def _slots(self, values, like):
        """Inverse of :meth:`_values`, in ``like``'s dtype."""
        if self.layout is None:
            return values.to(like.dtype)
        return self.layout.from_values(values, like.dtype)

    def _parts(self, params):
        """What the strategy differences: the layout's parts for a layout
        with wide leaves, else the buffer."""
        if self.step_layout is None or not self.step_layout.wide:
            return params
        return self.step_layout.parts(params)

    def _adapter_index(self, device):
        """``(payload layout, value positions [A])`` of the adapter leaves
        (``lora_`` paths) in the value vector, in value order; built once
        per device. Without a layout the state has no adapters."""
        ad = self._adapters
        if ad is None or ad[1].device != torch.device(device):
            leaves = ([] if self.layout is None else
                      [lf for lf in self.layout.value_layout.leaves
                       if is_adapter_path(lf.path)])
            idx = torch.cat([torch.arange(lf.offset, lf.offset + lf.size)
                             for lf in leaves] or
                            [torch.zeros(0, dtype=torch.int64)])
            ad = (FlatLayout([(lf.path, lf.shape) for lf in leaves]),
                  idx.to(device))
            self._adapters = ad
        return ad

    def _payload_layout(self, device):
        """The layout the wire grid and the checksum walk: the adapter
        leaves, or every leaf of the value vector."""
        if self._split_lora:
            return self._adapter_index(device)[0]
        return None if self.layout is None else self.layout.value_layout

    # -- local training ------------------------------------------------------

    def local_steps(self, params, opt_state, batches, step0, stats=None):
        """Loop over the leading [T] time axis of vmapped local steps; the
        strategy's importance accumulation rides in the same loop. Returns
        ``(params, opt_state, stats, metrics)`` with metrics stacked [T, N].

        A train step may opt into the true-Fisher hook by returning a
        4-tuple ``(params, opt_state, metrics, grads)``: the per-step grads
        feed ``strategy.accumulate_grads`` (exact squared gradients) instead
        of the Δθ² proxy.

        A split step (:attr:`splits`) runs node by node on the rank's
        shard rows (:meth:`_split_steps`)."""
        if self.splits:
            return self._split_steps(params, opt_state, batches, step0,
                                     stats)
        t = _leading(batches)
        metrics = []
        for k in range(t):
            batch = _index(batches, k)
            # a step that updates in place leaves nothing of the old params
            # for the Δθ² proxy: keep a copy
            old = params.clone() if stats is not None else None
            out = self._vstep[opt_state is not None](params, opt_state,
                                                     batch, step0 + k)
            p2, opt_state, m = out[:3]
            if stats is not None:
                if len(out) == 4:
                    stats = self.strategy.accumulate_grads(stats, out[3],
                                                           step0 + k)
                else:
                    stats = self.strategy.accumulate(
                        stats, self._parts(old), self._parts(p2), step0 + k)
            del old
            params = p2
            metrics.append(m)
        return params, opt_state, stats, _stack_logs(metrics)

    def _split_steps(self, params, opt_state, batches, step0, stats=None):
        """:meth:`local_steps` of a split step on the rank's shard rows
        ``[per, P_local]``: each node's ``step.split`` (`repro_torch.
        launch.train.TrainStep.split`) outside ``vmap`` (its gathers are
        collectives), its params and moments updated in place; the Δθ²
        statistics accumulate on the shard (they are elementwise)."""
        lay = self.layout
        parts = ((lambda p: p) if lay is None or not lay.wide
                 else lay.parts)
        self.mesh.reset_counts()
        metrics = []
        for k in range(_leading(batches)):
            batch = _index(batches, k)
            old = params.clone() if stats is not None else None
            rows = []
            for j in range(params.shape[0]):
                o = _index_node(opt_state, j)
                _, o2, m = self._split.split(
                    params[j], o, _index_node(batch, j), step0 + k,
                    shard=self.shard, mesh=self.mesh)
                _write_node(opt_state, j, o2)
                rows.append(m)
            if stats is not None:
                stats = self.strategy.accumulate(stats, parts(old),
                                                 parts(params), step0 + k)
            del old
            metrics.append(_stack_nodes(rows))
        self.step_bytes = dict(self.mesh.counts)
        return params, opt_state, stats, _stack_logs(metrics)

    # -- propose -------------------------------------------------------------

    def _traced_W(self, active):
        weights = self.data_sizes if self.cfg.merge == "fedavg" else None
        return topo.mixing_matrix_traced(self.cfg.topology, active,
                                         weights=weights,
                                         self_weight=self.cfg.self_weight)

    def propose(self, stacked, active=None, fishers=None, stats=None):
        """Merge candidate for every node: ``(candidate, W_commit, imp)``,
        over the payload's f32 values ``stacked`` [N, A]. Importance over the
        whole value vector is normalized whole, then carved to the adapters
        (as the reference finalizes the full tree before its split)."""
        if fishers is None and stats is not None:
            fishers = stats
        if self.mesh is not None:
            # gossip: the rank's slot rows in and out (`make_swarm_sync_step`)
            x, full = self._payload(stacked)
            if x.shape[-1] == 0:
                return stacked, None, None
            cand, _ = self._propose_gossip(x, active, fishers)
            return self._slots(self._full(cand, full), stacked), None, None
        n = self.cfg.n_nodes
        a = (torch.ones((n,), dtype=torch.bool, device=stacked.device)
             if active is None else active.to(torch.bool))
        W = self._traced_W(a)
        w = active_weights_traced(self.data_sizes, a)
        if self.strategy.uses_stats and fishers is None:
            # no evidence for any node -> zero mass everywhere, which the
            # eps floor turns into a uniform mean
            fishers = torch.zeros_like(stacked)
        fishers = self.strategy.finalize_mass(fishers, a)
        if fishers is not None and fishers.shape[-1] != stacked.shape[-1]:
            fishers = fishers.index_select(
                1, self._adapter_index(stacked.device)[1])
        rows = None
        if self.strategy.uses_stats and self.cfg.topology in ("ring",
                                                              "dynamic"):
            # topology-restricted weighted merge: only graph-neighbour
            # contributions enter each node's fisher/gradmatch candidate
            rows = self.strategy.topo_rows(W, w)
        return self.strategy.propose(stacked, W, weights=w, fishers=fishers,
                                     rows=rows)

    # -- gated sync ----------------------------------------------------------

    def _wire_grid(self, payload) -> comms.WireGrid:
        """The payload's :class:`~repro_torch.core.comms.WireGrid` on its
        device, built once (from the payload's layout, or as one leaf)."""
        g = self._grid
        if g is None or g.size != payload.shape[-1] \
                or g.segments.device != payload.device:
            layout = self._payload_layout(payload.device)
            g = comms.wire_grid(
                layout if layout is not None else payload.shape[-1],
                self.wire_dtype, self.wire_block, device=payload.device)
            self._grid = g
        return g

    def _ref_index(self, payload) -> comms.RefIndex:
        """The payload's :class:`~repro_torch.core.comms.RefIndex` on its
        device (what the checksum and the flip pattern are keyed on), built
        once."""
        ref = self._ref
        if ref is None or ref.pos.numel() != payload.shape[-1] \
                or ref.pos.device != payload.device:
            layout = self._payload_layout(payload.device)
            ref = comms.ref_index(
                layout if layout is not None else payload.shape[-1],
                payload.device)
            self._ref = ref
        return ref

    def _auto_wire(self, params, wire):
        """Default EF wire reference when ``cfg.wire_dtype`` enables
        compression but the caller threads no state (the direct engine API):
        a zero reference per call — stateless quantization, so the knob is
        honoured even without the session's carried ``SwarmState.wire``.
        It covers the payload's values: the adapters, or every value."""
        if wire is not None or self.wire_dtype == "f32":
            return wire
        width = (self._adapter_index(params.device)[1].numel()
                 if self._split_lora else self._n_values(params))
        if self.mesh is not None:
            # the schedule's mesh EF state for int8; bf16 is a stateless cast
            if self.wire_dtype != "int8":
                return None
            return self._mesh_wire(torch.empty((), device=params.device)
                                   .expand(params.shape[0], width))
        return torch.zeros((params.shape[0], width), dtype=torch.float32,
                           device=params.device)

    def _mesh_wire(self, payload):
        """Zero mesh EF state of the schedule for the payload rows."""
        from repro_torch.core import gossip
        return gossip.init_mesh_wire(
            self.sync_schedule.name, payload,
            n_shards=self.mesh.world_size, wire_block=self.wire_block,
            layout=self._mesh_grid(payload), mesh_shape=self.mesh_shape)

    def mesh_chunks(self) -> int:
        """The chunks of the schedule's padded int8 grid: a chunk a rank
        for the psum-q8 forms, a chunk a node of a pod for the
        hierarchical forms, else one."""
        name = self.sync_schedule.name
        if name.endswith("psum_q8"):
            return self.mesh.world_size
        return self.mesh_shape[1] if name.startswith("hier_") else 1

    def _mesh_grid(self, payload):
        """The payload's int8 block grid on its device
        (`core.gossip.PaddedGrid`; the chunk-major one of the psum-q8 forms,
        a chunk a rank, and of the hierarchical forms, a chunk a node of a
        pod), built once."""
        from repro_torch.core import gossip
        chunks = self.mesh_chunks()
        g = self._q8
        if g is None or g.size != payload.shape[-1] \
                or g.back.device != payload.device:
            layout = self._payload_layout(payload.device)
            g = gossip.padded_grid(
                layout if layout is not None else payload.shape[-1],
                self.wire_block, chunks, payload.device)
            self._q8 = g
        return g

    def check_faults(self, faults, wire) -> None:
        """Corrupt-wire injection needs the engine backend's quantized
        wire state."""
        if faults is not None and (self.mesh is not None or (
                wire is None and self.wire_dtype == "f32")):
            raise ValueError(
                "in-graph corrupt-wire injection (faults=) requires the "
                "engine backend with a quantized/EF wire (SwarmState.wire); "
                "lower corrupt events to drops instead "
                "(FaultPlan.lower(corrupt_in_graph=False))")

    def sync(self, params, val, active=None, stats=None, wire=None,
             faults=None):
        """propose → validate → gate → fused commit; returns
        ``(committed, log)`` with ``gates`` / ``metric_local`` /
        ``metric_merged`` [N] device tensors (plus ``quorum_ok``,
        ``fairness_ok``, ``worst_site`` when those policies are on).

        ``wire``: the error-feedback reference θ̂ [N, P] of a quantized wire
        — peers merge the wire reconstruction θ̂' instead of the exact
        params, rejected nodes keep their exact f32 locals, and the advanced
        θ̂' is returned in the log under ``"wire"``.

        ``faults``: optional `repro_torch.faults.signals.FaultSignals` —
        corrupt-wire injection. Flagged nodes' θ̂' arrive bit-flipped; the
        per-payload checksum (`comms.payload_checksum`) detects the damage
        and the sender is quarantined for the round (reject-and-keep-local:
        excluded from the merge AND gated off, so nobody — the sender
        included — commits corrupted bytes); ``"wire_ok"`` [N] in the log.
        Only the quantized wire carries it; elsewhere lower corrupt events
        to drops.

        Gossip backend: ``params``, ``stats``, ``wire`` and ``val`` are the
        rank's rows, ``active`` the whole [N] mask; the logs are [N] on
        every rank (see :meth:`_sync_gossip`)."""
        if self.mesh is not None:
            self.check_faults(faults, wire)
            return self._sync_gossip(params, val, active, stats, wire)
        n = self.cfg.n_nodes
        a = (torch.ones((n,), dtype=torch.bool, device=params.device)
             if active is None else active.to(torch.bool))
        wire = self._auto_wire(params, wire)
        self.check_faults(faults, wire)
        x, full = self._payload(params, quantized=wire is not None)
        log = {}
        if x.shape[-1] == 0:
            # nothing crosses the wire (lora_only on a state without
            # adapters): the candidate is the local state, no commit
            candidate, cand_eval = x, params
        elif wire is not None:
            grid = self._wire_grid(x)
            # θ̂' — what every peer reconstructs from this round's wire
            # traffic; also next round's reference
            eff = comms.wire_effective(x, wire, grid)
            if faults is not None:
                # sender-side checksum of the honest reconstruction, then
                # the seeded wire damage, then the receiver-side checksum:
                # a mismatch quarantines the sender like an absence. The
                # commit below re-derives θ̂' from the honest params and
                # wire, so the damage reaches only the candidate.
                ref = self._ref_index(x)
                sent = comms.payload_checksum(eff, ref)
                eff = flip_payload_bits(eff, faults.corrupt, faults.key, ref)
                wire_ok = sent == comms.payload_checksum(eff, ref)
                a = a & wire_ok
                log["wire_ok"] = wire_ok
            fishers = None
            if self.strategy.uses_stats:
                f = (stats if stats is not None else torch.zeros(
                    (n, self._n_values(params)), dtype=torch.float32,
                    device=params.device))
                f = self.strategy.finalize_mass(f, a)
                if self._split_lora:
                    f = f.index_select(1, self._adapter_index(
                        params.device)[1])
                # the importance mass crosses the wire too (stateless
                # round-trip); propose re-finalizes, which only rescales
                fishers = comms.quant_dequant(f, grid)
            candidate, W, imp = self.propose(eff, a, fishers=fishers)
            del eff, fishers     # the commit re-derives θ̂' from x and wire
            # the gate sees the wire's f32 reconstruction, as the
            # reference's does
            cand_eval = self._full(candidate, full)
        else:
            candidate, W, imp = self.propose(x, a, stats=stats)
            # the gate sees the candidate in the params' dtypes
            cand_eval = self._slots(self._full(candidate, full), params)
        with torch.no_grad():
            metric_local = torch.where(a, self._veval(params, val), 1.0)
            metric_merged = torch.where(a, self._veval(cand_eval, val), 0.0)
        gates = self._gates(a, metric_local, metric_merged, log, lambda:
                            torch.min(torch.where(a, metric_merged, 1.0)))
        if x.shape[-1] == 0:
            committed = params
            if wire is not None:
                log["wire"] = wire
        else:
            # what the gate read goes back before the commit allocates
            if wire is not None:
                del candidate, cand_eval   # re-derived from x and the wire
                committed, log["wire"] = fused_quant_merge_all(
                    x, wire, W, gates, imp, grid=grid)
            elif self.cfg.merge in ("mean", "fedavg") or imp is not None:
                # the kernel re-contracts the W rows (with the importance)
                del candidate, cand_eval
                committed = fused_merge_all(x, W, gates, imp)
            else:
                # a candidate with no kernel form
                committed = gated_commit(candidate, x, gates)
            del x
            committed = self._slots(self._full(committed, full), params)
        return committed, dict(log, gates=gates, metric_local=metric_local,
                               metric_merged=metric_merged)

    # -- the gossip backend -----------------------------------------------

    def _mass_mean(self, f):
        """The mean of every node's mass, from this rank's rows of it (on
        an inner-sharded mesh, of its shard: each block counted once over
        the shard group)."""
        from repro_torch.core import gossip
        shard = self.payload_shard()
        if shard is None:
            total = gossip.all_reduce(self.mesh, f.sum().reshape(1),
                                      kind="control")
            return total[0] / float(self.cfg.n_nodes * f.shape[-1])
        total = gossip.all_reduce(self.mesh, shard.share(f).reshape(1),
                                  kind="control")
        total = gossip.all_reduce(self.mesh.shard_view, total,
                                  kind="control")
        return total[0] / float(self.cfg.n_nodes * shard.full.size)

    def _pod_rows(self, device):
        """The pod ring's mixing matrix [K, K] of the hierarchical
        schedules (`topology.ring_matrix` folds both neighbour edges onto
        the one peer at K = 2: s·ā_self + (1−s)·ā_peer)."""
        return torch.as_tensor(topo.ring_matrix(self.mesh_shape[0],
                                                self.cfg.self_weight),
                               dtype=torch.float32, device=device)

    def _refuse_absent_pod(self, active) -> None:
        """The hierarchical schedules average within each pod first: a pod
        with no active node has no average (the reference leaves this case
        out of scope; here it raises)."""
        pods = active.reshape(self.mesh_shape).any(1).tolist()  # noqa: SWL002 — the gossip sync runs eagerly; one [K] read before its first collective, so every rank raises alike
        if not all(pods):
            raise ValueError(
                f"{self.sync_schedule.name}: pod(s) "
                f"{[q for q, ok in enumerate(pods) if not ok]} have no "
                "active node; the hierarchical schedules need an active "
                "node in every pod")

    def _propose_gossip(self, x, active, fishers, wire=None):
        """Merge the rank's payload rows ``x`` [per, A] over the ranks, by
        the schedule the cost model picked (``self.sync_schedule``):

          fedavg_psum / fisher_psum       — all_reduce(s), f32
          *_psum_q8                       — int8 all_to_all reduce-scatter
                                            + int8 all_gather
          ring_ppermute / ring_topo_...   — both ring neighbours
          gathered_rows / gathered_topo_… — one all_gather + the rank's
                                            rows of the contraction
          hier_*_ring_q8                  — intra-pod all_reduce, int8
                                            pod ring, intra-pod all_gather

        The point-to-point and gathered schedules cast their payloads per
        ``cfg.wire_dtype``; ``int8`` runs every schedule's error-feedback
        form against the mesh wire ``wire`` (zero when not threaded).
        ``fishers``: the rank's raw importance rows [per, n_values].
        Returns ``(merged [per, A], new_wire)``; ``new_wire`` is None unless
        the int8 wire is on."""
        from repro_torch.core import gossip

        cfg, mesh = self.cfg, self.mesh
        sched = self.sync_schedule.name
        q8 = self.wire_dtype == "int8"
        cast = None if self.wire_dtype == "f32" or q8 else self.wire_dtype
        dev = x.device
        a = (torch.ones((cfg.n_nodes,), dtype=torch.bool, device=dev)
             if active is None else active.to(device=dev, dtype=torch.bool))
        mine = a[mesh.rows]
        qkw = {}
        if q8:
            qkw = dict(layout=self._mesh_grid(x), wire_block=self.wire_block)
            if wire is None:
                wire = self._mesh_wire(x)
        # mean averages uniformly; only fedavg folds dataset sizes in
        sizes = (torch.as_tensor(self.data_sizes, dtype=torch.float32,
                                 device=dev) if cfg.merge == "fedavg"
                 else torch.ones(cfg.n_nodes, device=dev))
        new_wire = None
        if sched.startswith("hier_"):
            self._refuse_absent_pod(a)
        if cfg.merge in ("fisher", "gradmatch"):
            if fishers is None:
                fishers = torch.zeros(x.shape, dtype=torch.float32,
                                      device=dev)
            elif fishers.shape[-1] != x.shape[-1]:
                # the adapters' mass, carved before it is normalized
                fishers = fishers.index_select(
                    1, self._adapter_index(dev)[1])
            fishers = self.strategy.finalize_mass(fishers, mine,
                                                  mean=self._mass_mean)
            w = active_weights_traced(self.data_sizes, a)
            eps = self.strategy.eps
            if sched == "hier_fisher_ring_q8":
                # intra-pod sums of the (num ⊕ mass) side channel; the pod
                # ring's matrix plays the flat forms' topology rows, and
                # the strategy folds any weights into the mass (gradmatch)
                fishers = self.strategy.gossip_mass(fishers, w[mesh.rows])
                merged, new_wire = gossip.hier_fisher_ring_q8(
                    x, fishers, self._pod_rows(dev), wire, mesh, eps=eps,
                    **qkw)
            elif sched in ("fisher_psum", "fisher_psum_q8"):
                # the strategy folds any weights into the mass (gradmatch)
                fishers = self.strategy.gossip_mass(fishers, w[mesh.rows])
                if q8:
                    merged, new_wire = gossip.fisher_psum_q8(
                        x, fishers, wire, mesh, eps=eps, **qkw)
                else:
                    merged = gossip.fisher_gossip(x, fishers, mesh, eps=eps)
            else:
                # topology-restricted ratio over graph neighbours only
                rows = self.strategy.topo_rows(self._traced_W(a), w)
                ring = sched == "ring_topo_ppermute"
                if q8:
                    fn = (gossip.ring_topo_fisher_gossip_q8 if ring
                          else gossip.topo_fisher_gossip_q8)
                    merged, new_wire = fn(x, fishers, rows, wire, mesh,
                                          eps=eps, **qkw)
                else:
                    fn = (gossip.ring_topo_fisher_gossip if ring
                          else gossip.topo_fisher_gossip)
                    merged = fn(x, fishers, rows, mesh, eps=eps,
                                wire_dtype=cast)
        elif sched in ("fedavg_psum", "fedavg_psum_q8",
                       "hier_fedavg_ring_q8"):
            # membership stays on the psum: active-masked, renormalized
            # weights, and absent nodes keep their own rows
            w_eff = active_weights_traced(sizes, a)
            if sched == "hier_fedavg_ring_q8":
                # each pod's weighted average, mixed over the pod ring
                merged, new_wire = gossip.hier_fedavg_ring_q8(
                    x, w_eff, self._pod_rows(dev), wire, mesh, **qkw)
            elif q8:
                merged, new_wire = gossip.fedavg_psum_q8(x, w_eff, wire,
                                                         mesh, **qkw)
            else:
                merged = gossip.fedavg_gossip(x, w_eff, mesh)
            merged = torch.where(mine.reshape(-1, 1), merged, x)
        else:
            W = self._traced_W(a)
            if sched == "ring_ppermute":
                if q8:
                    merged, new_wire = gossip.ring_rows_gossip_q8(
                        x, W, wire, mesh, **qkw)
                else:
                    merged = gossip.ring_rows_gossip(x, W, mesh,
                                                     wire_dtype=cast)
            elif q8:
                merged, new_wire = gossip.matrix_gossip_q8(x, W, wire, mesh,
                                                           **qkw)
            else:
                merged = gossip.matrix_gossip(x, W, mesh, wire_dtype=cast)
        return merged, new_wire

    def _sync_gossip(self, params, val, active, stats, wire):
        """The gossip backend's sync on this rank's rows: propose over the
        ranks, score the rank's nodes, all-gather the [N] metrics, gate on
        the replicated mask (quorum, and the fairness floor's min over the
        active sites by an all_reduce), commit by where-select. The bytes
        each collective moved land in ``self.sync_bytes``."""
        from repro_torch.core import gossip

        mesh = self.mesh
        mesh.reset_counts()
        n = self.cfg.n_nodes
        a = (torch.ones((n,), dtype=torch.bool, device=params.device)
             if active is None else active.to(device=params.device,
                                              dtype=torch.bool))
        mine = a[mesh.rows]
        wire = self._auto_wire(params, wire)
        x, full = self._payload(params)
        log = {}
        if x.shape[-1] == 0:
            candidate, cand_eval, new_wire = x, params, wire
        else:
            candidate, new_wire = self._propose_gossip(x, a, stats, wire)
            cand_eval = self._slots(self._full(candidate, full), params)
        with torch.no_grad():
            # inner sharding: the gate scores the node's params and
            # candidate, alike on every rank of the node
            ml = torch.where(mine, self._gate_scores(params, val), 1.0)
            mm = torch.where(mine, self._gate_scores(cand_eval, val), 0.0)
        del cand_eval
        metric_local = gossip.all_gather(mesh, ml, kind="control")
        metric_merged = gossip.all_gather(mesh, mm, kind="control")
        gates = self._gates(a, metric_local, metric_merged, log, lambda:
                            gossip.all_reduce(mesh, torch.min(torch.where(
                                mine, mm, 1.0)).reshape(1), op="min",
                                kind="control")[0])
        if x.shape[-1] == 0:
            committed = params
        else:
            committed = self._slots(self._full(gated_commit(
                candidate, x, gates[mesh.rows]), full), params)
        if new_wire is not None:
            log["wire"] = new_wire
        self.sync_bytes = gossip.sync_bytes(mesh)
        return committed, dict(log, gates=gates, metric_local=metric_local,
                               metric_merged=metric_merged)

    def _gate_scores(self, rows, val):
        """The gate metric [per] of the rank's slot rows on their
        validation rows: node by node through the eval's split form on the
        shard (:attr:`split_gate`), else the eval on the nodes gathered
        whole (:meth:`node_tensor`)."""
        if not self.split_gate:
            return self._veval(self.node_tensor(rows), val)
        return torch.stack([
            self._veval.split(rows[j], _index_node(val, j),
                              shard=self.shard, mesh=self.mesh)
            for j in range(rows.shape[0])])

    def _gates(self, a, metric_local, metric_merged, log, worst):
        """The accept bits [N] from the [N] metrics and mask: the gate,
        then the quorum (below it the whole round holds locals) and the
        fairness floor (the merged candidate must clear it at every active
        site; ``worst()`` gives the least merged metric among them)."""
        gates = gate_decisions(metric_merged, metric_local,
                               self.cfg.val_threshold) & a
        if self.quorum > 0:
            quorum_ok = a.to(torch.int32).sum() >= self.quorum
            gates = gates & quorum_ok
            log["quorum_ok"] = quorum_ok
        if self.fairness_floor > 0.0:
            worst = worst()
            fair_ok = worst >= self.fairness_floor
            gates = gates & fair_ok
            log["fairness_ok"] = fair_ok
            log["worst_site"] = worst
        return gates

    def _payload(self, params, quantized: bool = False):
        """``(x, full)``: what crosses the wire. The buffer as it is where
        slots are values and the f32 wire commits it in its dtype, else the
        f32 numbers the wire's kernel takes: every value, or the adapters
        carved out of them (``full`` keeps the rest, which passes through;
        None when ``x`` is the whole vector)."""
        native = (not quantized and not self._split_lora
                  and (self.layout is None or not self.layout.wide))
        x = params if native else self._values(params)
        if not self._split_lora:
            return x, None
        return x.index_select(1, self._adapter_index(params.device)[1]), x

    # -- the host loop's propose and commit (`core.swarm.SwarmLearner`) ------

    def propose_host(self, stacked, W, *, fishers=None, weights=None,
                     rows=None):
        """The reference's ``propose_host``: the strategy's candidate for
        every node of the stacked slot buffer ``[N, P]`` on its device, from
        a mixing matrix ``W`` [N, N], active FedAvg ``weights`` [N] and
        topology ``rows`` the host loop built from its membership, and
        ``fishers`` [N, n_values] it already finalized. With ``lora_only``
        only the adapters merge. Returns ``(candidate [N, P] slots,
        W_commit, imp)``."""
        x, full = self._payload(stacked)
        if x.shape[-1] == 0:
            return stacked, W, None
        if fishers is not None and full is not None:
            fishers = fishers.index_select(
                1, self._adapter_index(stacked.device)[1])
        candidate, W_eff, imp = self.strategy.propose(
            x, W, weights=weights, fishers=fishers, rows=rows)
        return (self._slots(self._full(candidate, full), stacked), W_eff,
                imp)

    def commit_host(self, stacked, candidate, W, gates, imp=None):
        """The reference's ``host_commit``: mean/fedavg re-contract the W
        rows and fisher/gradmatch pass their importance ``imp``, both in
        one ``fused_merge_all`` launch over the payload; any other merge
        selects between the candidate and the locals by gate. Rejected rows
        and the base of an adapter-only sync come back bit for bit."""
        x, full = self._payload(stacked)
        if x.shape[-1] == 0:
            return stacked
        gates = torch.as_tensor(gates, device=stacked.device).to(torch.bool)
        if self.cfg.merge in ("mean", "fedavg") or imp is not None:
            committed = fused_merge_all(x, W, gates, imp)
        else:
            committed = gated_commit(self._payload(candidate)[0], x, gates)
        return self._slots(self._full(committed, full), stacked)

    def _full(self, payload, full):
        """An adapter payload [N, A] written into a copy of the full value
        vector (``full`` None: the payload is the whole vector)."""
        if full is None:
            return payload
        return full.index_copy(1, self._adapter_index(full.device)[1],
                               payload)

def _stack_logs(logs):
    """A list of same-keyed dicts of tensors → one dict of stacked tensors."""
    return {key: torch.stack([lg[key] for lg in logs]) for key in logs[0]}


def _leading(batches) -> int:
    """The leading (time) axis of a batch tensor, tuple or dict."""
    if isinstance(batches, dict):
        batches = next(iter(batches.values()))
    first = batches[0] if isinstance(batches, (tuple, list)) else batches
    return first.shape[0]


def _index(batches, k: int):
    if isinstance(batches, dict):
        return {key: b[k] for key, b in batches.items()}
    if isinstance(batches, (tuple, list)):
        return type(batches)(b[k] for b in batches)
    return batches[k]
