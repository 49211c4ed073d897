"""The gossip backend's worlds for ``tests/test_torch_gossip.py``,
``tests/test_torch_gossip_session.py``, ``tests/test_torch_hier.py`` and
``tests/test_torch_gossip_faults.py``.

Run as a script, one process a rank (a gloo world on the CPU) or one for
the reference (JAX with forced host devices):

    python tests/torch_gossip_world.py schedules RANK WORLD INIT OUT
    python tests/torch_gossip_world.py sessions RANK WORLD INIT OUT
    python tests/torch_gossip_world.py reference 0 WORLD - OUT
    python tests/torch_gossip_world.py hier RANK WORLD INIT OUT
    python tests/torch_gossip_world.py hier_reference 0 WORLD - OUT
    python tests/torch_gossip_world.py faults RANK WORLD INIT OUT

``hier`` runs on a two-level mesh of WORLD / 2 pods of 2 nodes (the
schedules; at WORLD 4 also the sessions, picks, bytes and refusals), and
``hier_reference`` on as many forced devices; ``faults`` runs the gossip
checkpoints and the fault plane on 4 ranks.

Each reads ``OUT/inputs.npz`` (seeded numpy, written by the test) and
writes ``OUT/<task>_rank<r>.npz``. The port's side imports no jax; the
reference's side imports no torch. Every process is torch.set_num_threads(1)
small.
"""
import os
import sys

import numpy as np

N = 4
WB = 128
# the schedules' payload: a conv leaf (stored OIHW, HWIO in the reference)
# and a plain one, neither a multiple of the wire block
LEAVES = (("a", (4, 3, 3, 3)), ("b", (200,)))
REF_SHAPES = {"a": (3, 3, 3, 4), "b": (200,)}
WIRES = ("f32", "bf16")
#: the mesh-wire schedule of each q8 function
Q8_SCHEDULE = {"ring_rows_gossip_q8": "ring_ppermute",
               "ring_topo_fisher_gossip_q8": "ring_topo_ppermute",
               "matrix_gossip_q8": "gathered_rows",
               "topo_fisher_gossip_q8": "gathered_topo_stack",
               "fedavg_psum_q8": "fedavg_psum_q8",
               "fisher_psum_q8": "fisher_psum_q8"}
#: syncs of a q8 schedule on constant inputs; merged and wire are kept
#: after the first and the last
Q8_SYNCS = 3
TELESCOPE_SYNCS = 5


def ring_matrix(n, s=0.5):
    W = np.zeros((n, n))
    for i in range(n):
        W[i, i] = s
        W[i, (i - 1) % n] += (1 - s) / 2
        W[i, (i + 1) % n] += (1 - s) / 2
    return W


def dynamic_full(sizes, active):
    """The full FedAvg matrix masked by ``active`` (absent rows identity)."""
    w = np.asarray(sizes, np.float64) * np.asarray(active, np.float64)
    n = len(sizes)
    W = np.tile(w / w.sum(), (n, 1))
    for i, a in enumerate(active):
        if not a:
            W[i] = 0.0
            W[i, i] = 1.0
    return W


def schedule_inputs(n, seed=0, shapes=REF_SHAPES):
    """Seeded numpy inputs of the schedule tests, reference layout."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in shapes.items():
        out[f"x/{k}"] = rng.normal(0, 1, (n,) + shape).astype(np.float32)
        out[f"f/{k}"] = np.abs(rng.normal(1, 0.3, (n,) + shape)).astype(
            np.float32)
    out["w"] = (np.arange(1, n + 1) / np.arange(1, n + 1).sum()).astype(
        np.float32)
    out["Wring"] = ring_matrix(n).astype(np.float32)
    act = [i != 2 for i in range(n)]
    out["Wdyn"] = dynamic_full([1] + [3] * (n - 1), act).astype(np.float32)
    return out


def _tree(inp, name, shapes=REF_SHAPES):
    return {k: inp[f"{name}/{k}"] for k in shapes}


def _flat_keys(prefix, tree, out):
    """Nested dict of arrays → ``prefix/k1/k2`` keys in ``out``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat_keys(f"{prefix}/{k}", v, out)
    else:
        out[prefix] = tree


# ---------------------------------------------------------------------------
# the port's side (torch, no jax)
# ---------------------------------------------------------------------------

def layout():
    from repro_torch.core.flat import FlatLayout
    return FlatLayout(list(LEAVES), convs=["a"])


def port_schedules(mesh, inp, shard=None):
    """Every schedule of `repro_torch.core.gossip` on this rank's rows:
    {key: numpy} with the merged rows ``<case>/merged`` [per, A] (stored
    order), q8 wires after the first and the last sync, and the bytes the
    first sync handed to each collective (``<case>/bytes/<kind>``).

    ``shard`` (a `ShardLayout` of :func:`inner_layout`): the rank's shard of
    the rows on an inner-sharded mesh; the psum-q8 forms, which refuse
    inner specs, are left out, and every tensor kept is the node's,
    gathered over the shard group."""
    import torch
    from repro_torch.convert import from_reference
    from repro_torch.core import gossip as g

    lay = layout() if shard is None else shard.full
    shapes = REF_SHAPES if shard is None else INNER_REF
    cut = (lambda t: t) if shard is None else shard.shard
    x = cut(from_reference(lay, _tree(inp, "x", shapes),
                           lead=1)[mesh.rows].contiguous())
    f = cut(from_reference(lay, _tree(inp, "f", shapes),
                           lead=1)[mesh.rows].contiguous())
    if shard is not None:
        lay = shard.local
    w, Wr, Wd = (torch.from_numpy(inp[k]) for k in ("w", "Wring", "Wdyn"))
    ring = mesh.per == 1 and mesh.world_size >= 3
    cases = {"fedavg_gossip": lambda: g.fedavg_gossip(x, w, mesh),
             "fisher_gossip": lambda: g.fisher_gossip(x, f, mesh)}
    if ring:
        cases["ring_gossip"] = lambda: g.ring_gossip(x, mesh, 0.6)
    for wd in WIRES:
        cases[f"topo_fisher_gossip_{wd}"] = (
            lambda wd=wd: g.topo_fisher_gossip(x, f, Wr, mesh,
                                               wire_dtype=wd))
        cases[f"matrix_gossip_{wd}"] = (
            lambda wd=wd: g.matrix_gossip(x, Wd, mesh, wire_dtype=wd))
        if ring:
            cases[f"ring_rows_gossip_{wd}"] = (
                lambda wd=wd: g.ring_rows_gossip(x, Wr, mesh, wire_dtype=wd))
            cases[f"ring_topo_fisher_gossip_{wd}"] = (
                lambda wd=wd: g.ring_topo_fisher_gossip(x, f, Wr, mesh,
                                                        wire_dtype=wd))
    node = ((lambda t: t) if shard is None
            else lambda t: shard.gather(t, mesh.shard_view, kind=None))
    out = {}
    for name, fn in cases.items():
        mesh.reset_counts()
        merged = fn()
        _flat_keys(f"{name}/bytes", dict(mesh.counts), out)
        out[f"{name}/merged"] = node(merged).numpy()
    kw = dict(layout=lay, wire_block=WB)
    q8 = {"matrix_gossip_q8": lambda wr: g.matrix_gossip_q8(
              x, Wd, wr, mesh, **kw),
          "topo_fisher_gossip_q8": lambda wr: g.topo_fisher_gossip_q8(
              x, f, Wr, wr, mesh, **kw),
          "fedavg_psum_q8": lambda wr: g.fedavg_psum_q8(x, w, wr, mesh, **kw),
          "fisher_psum_q8": lambda wr: g.fisher_psum_q8(x, f, wr, mesh,
                                                        **kw)}
    if shard is not None:
        del q8["fedavg_psum_q8"], q8["fisher_psum_q8"]
    if ring:
        q8["ring_rows_gossip_q8"] = lambda wr: g.ring_rows_gossip_q8(
            x, Wr, wr, mesh, **kw)
        q8["ring_topo_fisher_gossip_q8"] = (
            lambda wr: g.ring_topo_fisher_gossip_q8(x, f, Wr, wr, mesh,
                                                    **kw))
    for name, fn in q8.items():
        wire = g.init_mesh_wire(Q8_SCHEDULE[name], x,
                                n_shards=mesh.world_size, wire_block=WB,
                                layout=lay)
        for k in range(Q8_SYNCS):
            mesh.reset_counts()
            merged, wire = fn(wire)
            if k == 0:
                _flat_keys(f"{name}/bytes", dict(mesh.counts), out)
            if k in (0, Q8_SYNCS - 1):
                tag = "" if k == 0 else str(k + 1)
                out[f"{name}/merged{tag}"] = node(merged).numpy()
                _flat_keys(f"{name}/wire{k + 1}",
                           _numpy(_map_tree(node, wire)), out)
    if ring:
        # EF telescoping on constant inputs: the residual |ref − x| per sync
        wire = g.init_mesh_wire("ring_ppermute", x, n_shards=mesh.world_size,
                                wire_block=WB, layout=lay)
        res = []
        for _ in range(TELESCOPE_SYNCS):
            _, wire = g.ring_rows_gossip_q8(x, Wr, wire, mesh, **kw)
            res.append(float((wire["ref"] - x).abs().max()))
        out["telescope/residual"] = np.asarray(res)
        _flat_keys("telescope/wire", _numpy(_map_tree(node, wire)), out)
    return out


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


def _init_world(rank, world, init):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)


# --- the session scenarios --------------------------------------------------

SESSION_LEAVES = (("c", (3, 2, 2, 2)), ("v", (40,)))
LORA_LEAVES = (("attn.w", (8, 6)), ("attn.lora_A", (8, 2)),
               ("attn.lora_B", (2, 6)))
SETTLED = (("full", "fedavg"), ("ring", "fisher"), ("dynamic", "mean"))
REAL = (("full", "fedavg"), ("ring", "fisher"), ("full", "gradmatch"),
        ("dynamic", "mean"))
SIZES = [1.0, 2.0, 3.0, 4.0]


def session_inputs(n, seed=1):
    rng = np.random.default_rng(seed)
    p = sum(int(np.prod(s)) for _, s in SESSION_LEAVES)
    w0 = rng.normal(0, 1, (n, p)).astype(np.float32)
    pl = sum(int(np.prod(s)) for _, s in LORA_LEAVES)
    return {"w0": w0,
            # bf16-representable params (the bf16 wire's casts are exact)
            "w0_bf16": (w0.view(np.uint32)
                        & np.uint32(0xFFFF0000)).view(np.float32),
            "targets": rng.normal(0, 1, (3, 2, n, p)).astype(np.float32),
            "lora0": rng.normal(0, 0.1, (n, pl)).astype(np.float32)}


def id_step(p, o, b, s):
    return p, o, {"loss": (p * 0).sum()}


def pull_step(p, o, b, s):
    """A deterministic step toward the node's target ``b`` [P]."""
    return p + 0.1 * (b - p), o, {"loss": ((b - p) ** 2).mean()}


def lora_step(p, o, b, s):
    return p + 0.01, o, {"loss": b.sum() * 0}


def const_eval(params, val):
    return 1.0 - 0.0 * params.sum(-1)


def session_layout(leaves=SESSION_LEAVES):
    from repro_torch.core.flat import FlatLayout
    convs = [path for path, s in leaves if len(s) == 4]
    return FlatLayout(list(leaves), convs=convs)


def session_cfg(topo, merge, wire="f32", thr=0.0, **kw):
    from repro_torch.configs.base import SwarmConfig
    return SwarmConfig(n_nodes=N, sync_every=1, topology=topo, merge=merge,
                       lora_only=False, val_threshold=thr, wire_dtype=wire,
                       wire_block=WB, **kw)


def make_session(cfg, step, params, layout, mesh=None, sizes=None):
    """A SwarmSession on the CPU: the gossip backend with ``mesh``, else
    the engine backend."""
    import torch
    from repro_torch.core.session import SwarmSession
    kw = {} if mesh is None else dict(backend="gossip", mesh=mesh,
                                      axis=mesh.axis)
    return SwarmSession(cfg, step, const_eval,
                        params=[torch.from_numpy(r) for r in params],
                        data_sizes=sizes or [1.0] * N, layout=layout,
                        device="cpu", **kw)


def settled_commit(topo, merge, wire, params, mesh=None):
    """The reference's settled regime: six syncs whose gates reject (the
    wire settles on unchanged params), then one accepted commit from the
    same state. Returns (params rows, gates)."""
    import torch
    lay = session_layout()
    val = torch.zeros((N, 1))
    batches = torch.zeros((1, N, 1))
    sa = make_session(session_cfg(topo, merge, wire, thr=1.5), id_step,
                      params, lay, mesh)
    for _ in range(6):
        assert not sa.round(batches, val)["gates"].any()
    sb = make_session(session_cfg(topo, merge, wire, thr=0.0), id_step,
                      params, lay, mesh)
    sb.load_state(sa.state)
    log = sb.round(batches, val)
    return sb.state.params.clone(), log


def real_rounds(topo, merge, inp, mesh=None, membership=False,
                overlap=False, policy=False):
    """Rounds of the pull step on the f32 wire, fedavg sizes [1, 2, 3, 4]:
    two rounds; with ``membership`` three, node 2 leaving for the second;
    with ``overlap`` three under ``run_rounds`` with ``overlap_sync``;
    ``policy`` adds a quorum of 4 and a fairness floor of 0.5. Returns
    (params rows, stacked gates [R, N])."""
    import torch
    extra = dict(quorum=4, fairness_floor=0.5) if policy else {}
    cfg = session_cfg(topo, merge, "f32", thr=0.0, overlap_sync=overlap,
                      **extra)
    s = make_session(cfg, pull_step, inp["w0"], session_layout(), mesh,
                     sizes=SIZES)
    val = torch.zeros((N, 1))
    tg = torch.from_numpy(inp["targets"])
    if overlap:
        logs = s.run_rounds(tg, val)
        return s.state.params.clone(), logs["gates"]
    gates = []
    for r in range(3 if membership else 2):
        if membership and r == 1:
            s.leave(2)
        if membership and r == 2:
            s.join(2)
        gates.append(s.round(tg[r], val)["gates"])
    return s.state.params.clone(), torch.stack(gates)


def port_sessions(mesh, inp):
    """Every session scenario on this rank: {key: numpy}."""
    import torch
    from repro_torch.launch.train import make_swarm_sync_step

    out = {}
    for topo, merge in SETTLED:
        for wire in ("f32", "bf16", "int8"):
            w0 = inp["w0_bf16"] if wire == "bf16" else inp["w0"]
            p, log = settled_commit(topo, merge, wire, w0, mesh)
            out[f"settled/{topo}/{merge}/{wire}"] = p.numpy()
            out[f"settled/{topo}/{merge}/{wire}/gates"] = log["gates"].numpy()
    for topo, merge in REAL:
        p, gates = real_rounds(topo, merge, inp, mesh)
        out[f"real/{topo}/{merge}"] = p.numpy()
        out[f"real/{topo}/{merge}/gates"] = gates.numpy()
        p, gates = real_rounds(topo, merge, inp, mesh, membership=True)
        out[f"member/{topo}/{merge}"] = p.numpy()
        out[f"member/{topo}/{merge}/gates"] = gates.numpy()
    p, gates = real_rounds("dynamic", "mean", inp, mesh, membership=True,
                           policy=True)
    out["policy"] = p.numpy()
    out["policy/gates"] = gates.numpy()
    p, gates = real_rounds("ring", "fisher", inp, mesh, overlap=True)
    out["overlap/f32"] = p.numpy()
    out["overlap/f32/gates"] = gates.numpy()
    # the mesh wire under overlap_sync (the reference's overlap check)
    ocfg = session_cfg("ring", "fisher", "int8", overlap_sync=True)
    s = make_session(ocfg, id_step, inp["w0"], session_layout(), mesh)
    logs = s.run_rounds(torch.zeros((4, 1, N, 1)), torch.zeros((N, 1)))
    out["overlap/int8"] = s.state.params.numpy()
    out["overlap/int8/gates"] = logs["gates"].numpy()
    # adapter-only sync: the base passes through, the adapters merge
    from repro_torch.core.flat import FlatLayout
    llay = FlatLayout(list(LORA_LEAVES))
    for wire in ("f32", "int8"):
        from repro_torch.configs.base import SwarmConfig
        lcfg = SwarmConfig(n_nodes=N, sync_every=1, topology="full",
                           merge="fedavg", lora_only=True, val_threshold=0.0,
                           wire_dtype=wire, wire_block=WB)
        s = make_session(lcfg, lora_step, inp["lora0"], llay, mesh)
        if wire == "int8":
            out["lora/int8/wire_width"] = np.asarray(
                s.state.wire["ref"].shape[-1])
        s.round(torch.zeros((1, N, 4)), torch.zeros((N, 1)))
        out[f"lora/{wire}"] = s.state.params.numpy()
    # bitwise determinism of two int8 runs
    for k in range(2):
        cfg = session_cfg("ring", "fisher", "int8")
        s = make_session(cfg, id_step, inp["w0"], session_layout(), mesh)
        for _ in range(3):
            s.round(torch.zeros((1, N, 1)), torch.zeros((N, 1)))
        out[f"determinism/{k}/params"] = s.state.params.numpy()
        out[f"determinism/{k}/wire"] = s.state.wire["ref"]["num"].numpy()
        if k == 0:
            out["bytes/ring_topo_int8/counted"] = np.asarray(
                s.counted_sync_bytes["by_collective"]["ring"])
            out["bytes/ring_topo_int8/control"] = np.asarray(
                s.counted_sync_bytes["control"])
            trees = s.node_params
            for path, _ in SESSION_LEAVES:
                out[f"node_params/{path}"] = np.stack(
                    [np.asarray(t[path]) for t in trees])
    # make_swarm_sync_step: propose over the ring, commit by the gates
    cfg = session_cfg("ring", "fedavg", thr=0.8)
    propose, commit = make_swarm_sync_step(cfg, mesh, mesh.axis, SIZES,
                                           layout=session_layout())
    rows = torch.from_numpy(inp["w0"])[mesh.rows]
    cand = propose(rows, active=torch.ones(N, dtype=torch.bool))
    out["sync_step/candidate"] = cand.numpy()
    ones = torch.ones(mesh.per)
    keep = mesh.rank % 2 == 1
    out["sync_step/committed"] = commit(
        cand, rows, ones * (0.5 if keep else 1.0), ones).numpy()
    return out


# ---------------------------------------------------------------------------
# the reference's side (jax, no torch)
# ---------------------------------------------------------------------------

def reference_schedules(mesh, inp, specs=None):
    """The reference's functions on the same inputs (reference trees);
    with ``specs`` (``{leaf: PartitionSpec or None}``) every schedule on
    the :data:`INNER_LEAVES` payload with ``inner_specs=specs``, the psum-q8
    forms, which refuse them, left out."""
    import jax
    import jax.numpy as jnp
    from repro.core import gossip as g

    if specs is not None:
        g = _with_inner_specs(g, specs)
    shapes = REF_SHAPES if specs is None else INNER_REF
    n = mesh.shape["node"]
    x = {k: jnp.asarray(v) for k, v in _tree(inp, "x", shapes).items()}
    f = {k: jnp.asarray(v) for k, v in _tree(inp, "f", shapes).items()}
    w, Wr, Wd = (jnp.asarray(inp[k]) for k in ("w", "Wring", "Wdyn"))
    ring = n >= 3 and n == inp["w"].shape[0]

    def psum_form(fn):
        # the psum forms need the mesh in context on a multi-device mesh
        def run():
            with jax.set_mesh(mesh):
                return jax.jit(fn)()
        return run

    cases = {"fedavg_gossip": psum_form(
                 lambda: g.fedavg_gossip(x, w, mesh, "node")),
             "fisher_gossip": psum_form(
                 lambda: g.fisher_gossip(x, f, mesh, "node"))}
    if ring:
        cases["ring_gossip"] = lambda: g.ring_gossip(x, mesh, "node", 0.6)
    for wd in WIRES:
        cases[f"topo_fisher_gossip_{wd}"] = (
            lambda wd=wd: g.topo_fisher_gossip(x, f, Wr, mesh, "node",
                                               wire_dtype=wd))
        cases[f"matrix_gossip_{wd}"] = (
            lambda wd=wd: g.matrix_gossip(x, Wd, mesh, "node",
                                          wire_dtype=wd))
        if ring:
            cases[f"ring_rows_gossip_{wd}"] = (
                lambda wd=wd: g.ring_rows_gossip(x, Wr, mesh, "node",
                                                 wire_dtype=wd))
            cases[f"ring_topo_fisher_gossip_{wd}"] = (
                lambda wd=wd: g.ring_topo_fisher_gossip(
                    x, f, Wr, mesh, "node", wire_dtype=wd))
    out = {}
    for name, fn in cases.items():
        run = fn if name in ("fedavg_gossip", "fisher_gossip") else jax.jit(fn)
        _flat_keys(f"{name}/merged", jax.tree.map(np.asarray, run()), out)
    kw = dict(wire_block=WB)
    q8 = {"matrix_gossip_q8": lambda wr: g.matrix_gossip_q8(
              x, Wd, wr, mesh, "node", **kw),
          "topo_fisher_gossip_q8": lambda wr: g.topo_fisher_gossip_q8(
              x, f, Wr, wr, mesh, "node", **kw),
          "fedavg_psum_q8": lambda wr: g.fedavg_psum_q8(
              x, w, wr, mesh, "node", **kw),
          "fisher_psum_q8": lambda wr: g.fisher_psum_q8(
              x, f, wr, mesh, "node", **kw)}
    if specs is not None:
        del q8["fedavg_psum_q8"], q8["fisher_psum_q8"]
    if ring:
        q8["ring_rows_gossip_q8"] = lambda wr: g.ring_rows_gossip_q8(
            x, Wr, wr, mesh, "node", **kw)
        q8["ring_topo_fisher_gossip_q8"] = (
            lambda wr: g.ring_topo_fisher_gossip_q8(x, f, Wr, wr, mesh,
                                                    "node", **kw))
    for name, fn in q8.items():
        wire = g.init_mesh_wire(Q8_SCHEDULE[name], x, n_shards=n,
                                wire_block=WB)
        # the first sync op by op (XLA's fusion under jit may contract the
        # EF advance θ̂ + q·s into one rounding), the rest compiled
        jfn = jax.jit(fn)
        for k in range(Q8_SYNCS):
            merged, wire = (fn if k == 0 else jfn)(wire)
            if k in (0, Q8_SYNCS - 1):
                tag = "" if k == 0 else str(k + 1)
                _flat_keys(f"{name}/merged{tag}",
                           jax.tree.map(np.asarray, merged), out)
                _flat_keys(f"{name}/wire{k + 1}",
                           jax.tree.map(np.asarray, wire), out)
    return out


# ---------------------------------------------------------------------------
# inner (model) sharding within a node
# ---------------------------------------------------------------------------

#: the sharded schedules' payload: a conv leaf (OIHW, HWIO in the
#: reference) cut on its output axis, a plain leaf replicated, and a
#: scan-stacked [L, d, f] leaf with Mamba2's in_proj spec on a mesh without
#: a data axis (d_model over model); none a multiple of the wire block
INNER_LEAVES = (("a", (4, 3, 3, 3)), ("b", (200,)), ("c", (3, 16, 10)))
INNER_REF = {"a": (3, 3, 3, 4), "b": (200,), "c": (3, 16, 10)}
INNER_SPECS = {"a": (None, None, None, "model"), "b": None,
               "c": (None, "model", None)}
#: the sharded schedules' world: 4 nodes × model 2
INNER_NODES, INNER_MODEL = 4, 2


def inner_layout():
    from repro_torch.core.flat import FlatLayout
    return FlatLayout(list(INNER_LEAVES), convs=["a"])


def _with_inner_specs(g, specs):
    """The reference's gossip module with ``inner_specs`` bound on every
    schedule function."""
    import functools
    import types
    from jax.sharding import PartitionSpec as P
    tree = {k: None if v is None else P(*v) for k, v in specs.items()}
    names = ("fedavg_gossip", "fisher_gossip", "ring_gossip",
             "topo_fisher_gossip", "matrix_gossip", "ring_rows_gossip",
             "ring_topo_fisher_gossip", "ring_rows_gossip_q8",
             "ring_topo_fisher_gossip_q8", "matrix_gossip_q8",
             "topo_fisher_gossip_q8")
    ns = types.SimpleNamespace(**{k: getattr(g, k) for k in dir(g)
                                  if not k.startswith("__")})
    for name in names:
        setattr(ns, name, functools.partial(getattr(g, name),
                                            inner_specs=tree))
    return ns


#: (merge, topology, wire) of the cost model's picks on a sharded mesh
INNER_PICKS = tuple((m, t, w) for m in ("fedavg", "fisher")
                    for t in ("full", "ring", "dynamic")
                    for w in ("f32", "bf16", "int8"))


def inner_cfg(merge, topo, wire, n=INNER_NODES):
    from repro_torch.configs.base import SwarmConfig
    return SwarmConfig(n_nodes=n, sync_every=1, topology=topo, merge=merge,
                       lora_only=False, val_threshold=0.0, wire_dtype=wire,
                       wire_block=WB)


def port_inner(inp):
    """On 4 nodes × model 2: every flat schedule on the rank's shard
    (:func:`port_schedules`), the engine's picks with the specs, the
    shard's coordinates, and the refusals."""
    import torch
    from repro_torch.core import gossip as g
    from repro_torch.core.engine import SwarmEngine
    from repro_torch.core.flat import ShardLayout
    from repro_torch.launch.mesh import make_swarm_mesh

    mesh, axis = make_swarm_mesh(INNER_NODES, model=INNER_MODEL)
    lay = inner_layout()
    shard = ShardLayout(lay, INNER_SPECS, mesh.inner, mesh.coords)
    out = port_schedules(mesh, inp, shard)
    out["mesh/coords"] = np.asarray([mesh.coords["data"],
                                     mesh.coords["model"]])
    out["mesh/rows"] = np.asarray([mesh.rows.start, mesh.rows.stop])
    out["mesh/local_size"] = np.asarray(shard.local.size)
    for merge, topo, wire in INNER_PICKS:
        eng = SwarmEngine(inner_cfg(merge, topo, wire), None, None,
                          layout=lay, backend="gossip", mesh=mesh,
                          axis=axis, param_specs=INNER_SPECS)
        out[f"pick/{merge}/{topo}/{wire}"] = np.asarray(
            eng.sync_schedule.name)
    # make_swarm_sync_step with the specs: mean on the ring, on the shard
    from repro_torch.convert import from_reference
    from repro_torch.launch.train import make_swarm_sync_step
    propose, _ = make_swarm_sync_step(
        inner_cfg("mean", "ring", "f32"), mesh, axis, [1.0] * INNER_NODES,
        param_specs=INNER_SPECS, layout=lay)
    rows = shard.shard(from_reference(lay, _tree(inp, "x", INNER_REF),
                                      lead=1)[mesh.rows])
    out["sync_step/candidate"] = shard.gather(
        propose(rows), mesh.shard_view, kind=None).numpy()
    x = torch.zeros((1, shard.local.size))
    cases = {
        "refuse/fedavg_psum_q8": lambda: g.fedavg_psum_q8(
            x, np.full(INNER_NODES, 0.25), None, mesh, wire_block=WB,
            inner_specs=INNER_SPECS),
        "refuse/fisher_psum_q8": lambda: g.fisher_psum_q8(
            x, x, None, mesh, wire_block=WB, inner_specs=INNER_SPECS),
        "refuse/engine_axis": lambda: SwarmEngine(
            inner_cfg("fedavg", "full", "f32"), None, None, layout=lay,
            backend="gossip", mesh=mesh, axis=axis,
            param_specs={"a": ("pod",)}),
        "refuse/engine_layout": lambda: SwarmEngine(
            inner_cfg("fedavg", "full", "f32"), None, None,
            backend="gossip", mesh=mesh, axis=axis,
            param_specs=INNER_SPECS),
    }
    for key, fn in cases.items():
        try:
            fn()
        except ValueError as e:
            out[key] = np.asarray(str(e))
    return out


def reference_inner(inp):
    """The reference on 8 forced devices as a (node, model) = (4, 2)
    mesh: the schedules with ``inner_specs`` (:func:`reference_schedules`),
    its psum-q8 refusals, and its cost model's picks with
    ``model_sharded=True``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.configs.base import SwarmConfig
    from repro.core import comms
    from repro.core import gossip as g

    mesh = jax.make_mesh((INNER_NODES, INNER_MODEL), ("node", "model"),
                         devices=jax.devices()[:INNER_NODES * INNER_MODEL])
    out = reference_schedules(mesh, inp, INNER_SPECS)
    specs = {k: None if v is None else P(*v) for k, v in INNER_SPECS.items()}
    x = {k: jnp.zeros((INNER_NODES,) + s) for k, s in INNER_REF.items()}
    w = np.full(INNER_NODES, 0.25, np.float32)
    for name, args in (("fedavg_psum_q8", (x, w)),
                       ("fisher_psum_q8", (x, x))):
        try:
            getattr(g, name)(*args, None, mesh, "node", inner_specs=specs,
                             wire_block=WB)
        except ValueError as e:
            out[f"refuse/{name}"] = np.asarray(str(e))
    for merge, topo, wire in INNER_PICKS:
        cfg = SwarmConfig(n_nodes=INNER_NODES, sync_every=1, topology=topo,
                          merge=merge, lora_only=False, val_threshold=0.0,
                          wire_dtype=wire, wire_block=WB)
        out[f"pick/{merge}/{topo}/{wire}"] = np.asarray(comms.pick_schedule(
            cfg, per=1, model_sharded=comms.has_inner_sharding(specs)).name)
    return out


# --- inner-sharded sessions: 2 nodes × model 2 against 2 unsharded ranks ----

INNER_SESSION_NODES = 2
INNER_SIZES = [1.0, 2.0]
INNER_ROUNDS = 2
#: the TINY CNN's widths (tests/torch_parity.py)
INNER_CNN = dict(steps=4, growth=4, stem=8, feat_dim=32, hidden=16,
                 n_blocks=1, layers_per_block=2)
INNER_LM = dict(batch=2, seq=16)
INNER_FAULT_ROUNDS = 9


def inner_session_inputs(seed=5):
    """Seeded numpy batches of the session worlds: CNN images and labels
    [R, T, N, B, ...], validation rows [N, 6, ...], the LM's token rows
    (Mamba2's smoke vocabulary) [R, T, N, B, S], and the fault plane's
    params [N, P]."""
    from repro_torch.configs import get_config, smoke_variant
    rng = np.random.default_rng(seed)
    n, r = INNER_SESSION_NODES, INNER_ROUNDS
    vocab = smoke_variant(get_config("mamba2-370m")).vocab_size
    b, sq = INNER_LM["batch"], INNER_LM["seq"]
    toks = rng.integers(0, vocab, (r, 1, n, b, sq + 1))
    p = sum(int(np.prod(sh)) for _, sh in INNER_LEAVES)
    return {"xs": rng.normal(0, 1, (r, 1, n, 4, 16, 16, 3)).astype(
                np.float32),
            "ys": rng.integers(0, 3, (r, 1, n, 4)),
            "vx": rng.normal(0, 1, (n, 6, 16, 16, 3)).astype(np.float32),
            "vy": rng.integers(0, 3, (n, 6)),
            "tokens": toks[..., :-1].astype(np.int64),
            "labels": toks[..., 1:].astype(np.int64),
            "fw0": rng.normal(0, 1, (n, p)).astype(np.float32)}


def cnn_specs(layout):
    """Explicit specs for the CNN (reference axes: a conv HWIO): a conv's
    output axis, a matrix's input axis and a vector over ``model``; the
    shard layout replicates what 2 does not divide."""
    axes = {4: (None, None, None, "model"), 2: ("model", None),
            1: ("model",)}
    return {lf.path: axes[len(lf.shape)] for lf in layout.leaves}


def _cnn(cfg, mesh, sharded):
    import torch
    from repro_torch.core.flat import FlatLayout
    from repro_torch.core.session import SwarmSession
    from repro_torch.experiments import histo
    from repro_torch.optim import adamw_init

    ecfg = histo.HistoExperimentConfig(**INNER_CNN)
    model = histo._model(ecfg)
    layout = FlatLayout.of_module(model)
    step, _ = histo._make_model_fns(ecfg, model, layout)
    flat = layout.flatten(histo._init_params(ecfg, model))
    return SwarmSession(cfg, step, histo._make_eval_fn(cfg, model, layout),
                        params=flat, opt_state=adamw_init(flat),
                        data_sizes=INNER_SIZES, layout=layout, device="cpu",
                        backend="gossip", mesh=mesh, axis=mesh.axis,
                        param_specs=cnn_specs(layout) if sharded else None)


def _lm(cfg, mesh, sharded):
    import torch
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.session import SwarmSession
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.rules import param_specs

    model = build_model(smoke_variant(get_config("mamba2-370m")))
    layout = model.layout
    step = train.make_train_step(model, TrainConfig(
        lr=1e-3, warmup_steps=1, max_steps=4, remat=False))
    veval = torch.func.vmap(lambda p, v: 1.0 / (1.0 + model.loss_fn(
        layout.unflatten(p), v, remat=False)[0]))
    p0 = model.init(torch.Generator().manual_seed(0), "cpu")
    return SwarmSession(cfg, lambda p, o, b, s: step(p, o, b),
                        lambda p, v: veval(p, v), params=p0,
                        opt_state=adamw_init(layout.parts(p0)),
                        data_sizes=INNER_SIZES, layout=layout, device="cpu",
                        backend="gossip", mesh=mesh, axis=mesh.axis,
                        param_specs=(param_specs(layout, mesh) if sharded
                                     else None))


def _node_rows(sess):
    """The rank's rows of the session's params, the whole node's (its
    shards gathered; uncounted)."""
    return sess.engine.node_tensor(sess.state.params, kind=None).clone()


def _inner_batches(inp, r):
    import torch
    cnn = (torch.from_numpy(inp["xs"][r]), torch.from_numpy(inp["ys"][r]))
    lm = {k: torch.from_numpy(inp[k][r]) for k in ("tokens", "labels")}
    return cnn, lm


def _inner_val(inp):
    import torch
    n = INNER_SESSION_NODES
    cnn = (torch.from_numpy(inp["vx"]), torch.from_numpy(inp["vy"]),
           torch.ones((n, 6), dtype=torch.bool))
    lm = {k: torch.from_numpy(inp[k][0, 0]) for k in ("tokens", "labels")}
    return cnn, lm


def port_inner_sessions(inp, tmp, sharded):
    """``sharded``: 4 ranks as 2 nodes × model 2 with param specs, else
    2 ranks, one node each: the TINY CNN (explicit specs) and the Mamba2
    smoke model (the rules' specs) for INNER_ROUNDS rounds of real steps on
    the f32 wire (fedavg, full), each round's gates and the whole node's
    params, the sync's counted bytes, and the CNN's checkpoint. Sharded
    only: the CNN's first int8 sync from its local steps' params, loads
    across (the unsharded file into a sharded session, the sharded file
    into a whole-node session on the same ranks) and the fault plane."""
    import torch
    from repro_torch.launch.mesh import make_swarm_mesh

    n = INNER_SESSION_NODES
    if sharded:
        mesh, _ = make_swarm_mesh(n, model=2)
    else:
        mesh, _ = make_swarm_mesh(n)
    tag = "sharded" if sharded else "twin"
    val = [v for v in _inner_val(inp)]
    out = {"coords": np.asarray(list(mesh.coords.values()) or [0, 0]),
           "rows": np.asarray([mesh.rows.start, mesh.rows.stop])}
    cfg = inner_cfg("fedavg", "full", "f32", n=n)
    for k, build in enumerate((_cnn, _lm)):
        name = ("cnn", "lm")[k]
        sess = build(cfg, mesh, sharded)
        out[f"{name}/schedule"] = np.asarray(sess.sync_schedule.name)
        out[f"{name}/slots"] = np.asarray(sess.state.params.shape[-1])
        for r in range(INNER_ROUNDS):
            log = sess.round(_inner_batches(inp, r)[k], val[k])
            out[f"{name}/gates{r}"] = log["gates"].numpy()
            out[f"{name}/metric{r}"] = log["metric_merged"].numpy()
        p = _node_rows(sess)
        out[f"{name}/params"] = (p.view(torch.int16) if p.element_size()
                                 == 2 else p).numpy()
        out[f"{name}/sync_bytes"] = np.asarray(
            sess.counted_sync_bytes["by_collective"]["all_reduce"])
        if name == "cnn":
            path = os.path.join(tmp, f"inner_ckpt_{tag}.msgpack")
            sess.save(path)
            out["ckpt/path"] = np.asarray(path)
            cnn = sess
    if not sharded:
        return out
    # loads across: the unsharded file into a fresh sharded session, the
    # sharded file into a whole-node session on the same ranks
    fresh = _cnn(cfg, mesh, True).load(os.path.join(
        tmp, "inner_ckpt_twin.msgpack"))
    st, ft = cnn.state, fresh.state
    out["load/twin_into_sharded"] = np.asarray(
        _states_equal(st, ft))
    whole = _cnn(cfg, mesh, False).load(os.path.join(
        tmp, "inner_ckpt_sharded.msgpack"))
    out["load/sharded_into_whole"] = np.asarray(
        torch.equal(whole.state.params, _node_rows(cnn)))
    out["load/whole_params"] = whole.state.params.numpy()
    # the int8 wire (gathered_rows: the q8 psums drop out): the first sync
    # from the local steps' params, on the per-shard grid
    q8 = _cnn(inner_cfg("fedavg", "full", "int8", n=n), mesh, True)
    out["int8/schedule"] = np.asarray(q8.sync_schedule.name)
    q8.run_local(_inner_batches(inp, 0)[0])
    out["int8/pre"] = _node_rows(q8).numpy()
    committed, log = q8._sync(q8._mine(val[0], 0))
    q8._commit(committed)
    out["int8/gates"] = log["gates"].numpy()
    out["int8/post"] = _node_rows(q8).numpy()
    out.update(inner_fault_plane(mesh, inp, tmp))
    return out


def inner_fault_plane(mesh, inp, tmp):
    """`run_plan` on an inner-sharded session of the :data:`INNER_LEAVES`
    payload on the int8 wire: a crash of node 1 at round 1 with its rejoin
    at 3 under held gates, then one accepting round (against
    `repro.faults.oracle` in the test), and a preempt mid-plan against the
    same plan without it, bit for bit."""
    import dataclasses
    import torch
    from repro_torch.core.session import SwarmSession
    from repro_torch.faults import FaultPlan, run_plan
    from repro_torch.optim import adamw_init

    n = INNER_SESSION_NODES
    lay = inner_layout()
    val, batches = torch.zeros((n, 1)), torch.zeros((1, n, 1))

    def sess(thr, merge, topo, step):
        cfg = dataclasses.replace(inner_cfg(merge, topo, "int8", n=n),
                                  val_threshold=thr)
        return SwarmSession(
            cfg, step, const_eval,
            params=[torch.from_numpy(r) for r in inp["fw0"]],
            opt_state=adamw_init(torch.zeros(lay.size)), layout=lay,
            device="cpu", backend="gossip", mesh=mesh, axis=mesh.axis,
            param_specs=INNER_SPECS)

    out = {}
    for topo, merge in (("ring", "fisher"), ("full", "fedavg")):
        pre = f"fault/crash/{topo}/{merge}"
        sa = sess(1.5, merge, topo, id_step)
        plan = FaultPlan(n_nodes=n, n_rounds=INNER_FAULT_ROUNDS,
                         seed=0).crash(1, at=1, rejoin=3)
        sa, logs = run_plan(sa, plan, batches, val)
        out[f"{pre}/gates_any"] = np.asarray(
            any(lg["gates"].any() for lg in logs))
        out[f"{pre}/schedule"] = np.asarray(sa.sync_schedule.name)
        sb = sess(0.0, merge, topo, id_step)
        sb.load_state(sa.state)
        out[f"{pre}/gates"] = sb.round(batches, val)["gates"].numpy()
        out[f"{pre}/committed"] = _node_rows(sb).numpy()
    base = FaultPlan(n_nodes=n, n_rounds=6, seed=0).crash(1, at=1, rejoin=4)

    def run(plan):
        mk = lambda: sess(0.0, "fedavg", "full", decay_step)
        return run_plan(mk(), plan, batches, val, make_session=mk,
                        checkpoint_path=os.path.join(
                            tmp, "inner_preempt.msgpack"))

    ra, la = run(base)
    rb, lb = run(base.preempt(at=3))
    out["fault/preempt/equal"] = np.asarray(_states_equal(ra.state,
                                                          rb.state))
    out["fault/preempt/gates_equal"] = np.asarray(
        [lg["gates"].tolist() for lg in la]
        == [lg["gates"].tolist() for lg in lb])
    out["fault/preempt/preempted"] = np.asarray([lg["preempted"]
                                                 for lg in lb])
    return out


# ---------------------------------------------------------------------------
# the two-level mesh: the hierarchical schedules, picks, sessions, bytes
# ---------------------------------------------------------------------------

HIER = ("hier_fedavg_ring_q8", "hier_fisher_ring_q8")
#: the schedules' payload: a conv leaf and a 700-value leaf, neither a
#: multiple of the per_pod·wire_block delegate grid (256)
HIER_LEAVES = (("a", (4, 3, 3, 3)), ("b", (700,)))
HIER_REF = {"a": (3, 3, 3, 4), "b": (700,)}
HIER_MESHES = ((2, 2), (3, 2))
HIER_SYNCS = 6
HIER_SW = 0.7
#: the sessions' payload width (a multiple of the delegate grid: the
#: reference's exact byte arithmetic)
HIER_D = 1024
CROSS = (1.0, 5.0, 6.0, 10.0)


def hier_inputs(seed=3):
    """Seeded numpy inputs of the two-level tests (6 nodes; a 2 × 2 mesh
    takes the first 4), reference layout."""
    rng = np.random.default_rng(seed)
    n = max(k * per for k, per in HIER_MESHES)
    out = {}
    for k, shape in HIER_REF.items():
        out[f"x/{k}"] = rng.normal(0, 1, (n,) + shape).astype(np.float32)
        out[f"f/{k}"] = np.abs(rng.normal(1, 0.3, (n,) + shape)).astype(
            np.float32)
    out["w0"] = rng.normal(0, 1, (N, HIER_D)).astype(np.float32)
    return out


def hier_weights(n):
    return (np.arange(1, n + 1) / np.arange(1, n + 1).sum()).astype(
        np.float32)


def _htree(inp, name, n):
    return {k: inp[f"{name}/{k}"][:n] for k in HIER_REF}


def hier_layout():
    from repro_torch.core.flat import FlatLayout
    return FlatLayout(list(HIER_LEAVES), convs=["a"])


def port_hier_schedules(mesh, inp, k):
    """The port's two hierarchical schedules on this rank's row, HIER_SYNCS
    syncs on constant inputs: merged and wire after the first and the
    last."""
    import torch
    from repro_torch.convert import from_reference
    from repro_torch.core import gossip as g

    n = 2 * k
    lay = hier_layout()
    x = from_reference(lay, _htree(inp, "x", n), lead=1)[mesh.rows]
    f = from_reference(lay, _htree(inp, "f", n), lead=1)[mesh.rows]
    w = torch.from_numpy(hier_weights(n))
    Wp = torch.from_numpy(ring_matrix(k, HIER_SW).astype(np.float32))
    kw = dict(layout=lay, wire_block=WB)
    fns = {"hier_fedavg_ring_q8": lambda wr: g.hier_fedavg_ring_q8(
               x, w, Wp, wr, mesh, **kw),
           "hier_fisher_ring_q8": lambda wr: g.hier_fisher_ring_q8(
               x, f, Wp, wr, mesh, **kw)}
    out = {}
    for name, fn in fns.items():
        wire = g.init_mesh_wire(name, x, n_shards=n, wire_block=WB,
                                layout=lay, mesh_shape=(k, 2))
        for sync in range(HIER_SYNCS):
            mesh.reset_counts()
            merged, wire = fn(wire)
            if sync in (0, HIER_SYNCS - 1):
                out[f"{name}/merged{sync + 1}"] = merged.numpy()
                _flat_keys(f"{name}/wire{sync + 1}", _numpy(wire), out)
    return out


def hier_cfg(merge, thr=0.0, cross=10.0, topo="ring"):
    from repro_torch.configs.base import SwarmConfig
    return SwarmConfig(n_nodes=N, sync_every=1, topology=topo, merge=merge,
                       lora_only=False, val_threshold=thr,
                       self_weight=HIER_SW, wire_dtype="int8",
                       wire_block=WB, cross_pod_cost=cross)


def _bytes(prefix, counted, out):
    """A session's counted bytes: by link class, and by collective within
    each."""
    for link, v in counted["by_link_class"].items():
        out[f"{prefix}/link/{link}"] = np.asarray(v)
    for link, kinds in counted["by_link_collective"].items():
        for kind, v in kinds.items():
            out[f"{prefix}/{link}/{kind}"] = np.asarray(v)


def port_hier_sessions(mesh, inp):
    """On the 2 × 2 mesh: the cost model's picks, the settled session
    commits (hierarchical at cross_pod_cost 10, flat at 5) with their
    predicted and counted bytes, the flat ring q8 raw on the joint axis,
    and the refusals."""
    import torch
    from repro_torch.core import gossip as g
    from repro_torch.core.engine import SwarmEngine
    from repro_torch.launch.mesh import (make_swarm_mesh,
                                         make_two_level_swarm_mesh)

    out = {}
    for merge in ("fedavg", "fisher"):
        for cross in CROSS:
            eng = SwarmEngine(hier_cfg(merge, cross=cross), None, None,
                              data_sizes=[1.0] * N, backend="gossip",
                              mesh=mesh, axis=mesh.axis)
            out[f"pick/{merge}/{cross:g}"] = np.asarray(
                eng.sync_schedule.name)
    # the same ranks as a flat mesh never offer the hierarchical forms
    flat, _ = make_swarm_mesh(N)
    eng = SwarmEngine(hier_cfg("fedavg", cross=100.0), None, None,
                      backend="gossip", mesh=flat, axis=flat.axis)
    out["pick/flat_mesh"] = np.asarray(eng.sync_schedule.name)
    w0 = inp["w0"]
    val, batches = torch.zeros((N, 1)), torch.zeros((1, N, 1))
    for merge in ("fedavg", "fisher"):
        for cross in (10.0, 5.0):
            sa = make_session(hier_cfg(merge, 1.5, cross), id_step, w0, None,
                              mesh, sizes=SIZES)
            for _ in range(6):
                assert not sa.round(batches, val)["gates"].any()
            sb = make_session(hier_cfg(merge, 0.0, cross), id_step, w0, None,
                              mesh, sizes=SIZES)
            sb.load_state(sa.state)
            log = sb.round(batches, val)
            key = f"session/{merge}/{cross:g}"
            out[f"{key}/committed"] = sb.state.params.numpy()
            out[f"{key}/gates"] = log["gates"].numpy()
            out[f"{key}/schedule"] = np.asarray(sb.sync_schedule.name)
            for link, v in sb.predicted_link_bytes.items():
                out[f"{key}/predicted/{link}"] = np.asarray(v)
            _bytes(f"{key}/counted", sb.counted_sync_bytes, out)
    # the flat ring q8 schedule, raw, over the joint ("pod", "node") axis
    x = torch.from_numpy(w0)[mesh.rows]
    W4 = torch.from_numpy(ring_matrix(N).astype(np.float32))
    wire = g.init_mesh_wire("ring_ppermute", x, n_shards=N, wire_block=WB)
    for _ in range(HIER_SYNCS):
        merged, wire = g.ring_rows_gossip_q8(x, W4, wire, mesh,
                                             wire_block=WB)
    out["flat_ring_q8/merged"] = merged.numpy()
    out.update(hier_refusals(mesh, x))
    # a world of the wrong size, and meshes of too few pods or nodes
    for key, shape in (("refuse/world", (2, 3)),):
        try:
            make_two_level_swarm_mesh(*shape)
        except RuntimeError as e:
            out[key] = np.asarray(str(e))
    for key, shape in (("refuse/pods", (1, 4)), ("refuse/nodes", (4, 1))):
        m, _ = make_two_level_swarm_mesh(*shape)
        try:
            g.hier_fedavg_ring_q8(x, np.full(N, 0.25), np.eye(shape[0]),
                                  None, m, wire_block=WB)
        except ValueError as e:
            out[key] = np.asarray(str(e))
    return out


def hier_refusals(mesh, x):
    """The refusals on the 2 × 2 mesh: {key: message}."""
    import torch
    from repro_torch.core import gossip as g
    from repro_torch.core.engine import SwarmEngine

    out = {}
    Wp = ring_matrix(2, HIER_SW)
    w = np.full(N, 0.25, np.float32)
    wire = g.init_mesh_wire(HIER[0], x, n_shards=N, wire_block=WB,
                            mesh_shape=(2, 2))
    cases = {
        "refuse/rows": lambda: g.hier_fedavg_ring_q8(
            x.repeat(2, 1), w, Wp, wire, mesh, wire_block=WB),
        "refuse/inner": lambda: g.hier_fisher_ring_q8(
            x, x.abs(), Wp, wire, mesh, wire_block=WB,
            inner_specs={"w": (None, "model")}),
        "refuse/mesh_shape": lambda: g.init_mesh_wire(
            HIER[0], x, n_shards=N, wire_block=WB),
        "refuse/absent_pod": lambda: g.hier_fedavg_ring_q8(
            x, np.asarray([0.0, 0.0, 0.5, 0.5]), Wp, wire, mesh,
            wire_block=WB),
        "refuse/engine_inner": lambda: SwarmEngine(
            hier_cfg("fedavg"), None, None, backend="gossip", mesh=mesh,
            axis=mesh.axis, param_specs={"w": (None, "model")}),
    }
    for key, fn in cases.items():
        try:
            fn()
        except ValueError as e:
            out[key] = np.asarray(str(e))
    # a session whose pod 0 has left: its next sync raises on every rank
    for merge in HIER:
        s = make_session(hier_cfg(merge.split("_")[1]), id_step,
                         np.zeros((N, HIER_D), np.float32), None, mesh)
        s.leave(0)
        s.leave(1)
        try:
            s.round(torch.zeros((1, N, 1)), torch.zeros((N, 1)))
        except ValueError as e:
            out[f"refuse/session_absent_pod/{merge}"] = np.asarray(str(e))
    return out


def reference_hier(inp, world):
    """The reference's hierarchical schedules on the mesh of ``world``
    devices, ``world / 2`` pods of 2 (the first sync op by op, as the port's
    is: compiled, XLA rewrites some of its arithmetic and the references
    differ in the last bit; the rest compiled), and on 2 × 2 its engine's
    picks."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import SwarmConfig
    from repro.core import gossip as g
    from repro.core.engine import SwarmEngine

    devs = jax.devices()
    axis = ("pod", "node")
    out = {}
    for k, per in [m for m in HIER_MESHES if m[0] * m[1] == world]:
        n = k * per
        mesh = jax.make_mesh((k, per), axis, devices=devs[:n])
        x = {a: jnp.asarray(v) for a, v in _htree(inp, "x", n).items()}
        f = {a: jnp.asarray(v) for a, v in _htree(inp, "f", n).items()}
        w = jnp.asarray(hier_weights(n))
        Wp = jnp.asarray(ring_matrix(k, HIER_SW), jnp.float32)
        fns = {"hier_fedavg_ring_q8": lambda wr: g.hier_fedavg_ring_q8(
                   x, w, Wp, wr, mesh, axis, wire_block=WB),
               "hier_fisher_ring_q8": lambda wr: g.hier_fisher_ring_q8(
                   x, f, Wp, wr, mesh, axis, wire_block=WB)}
        for name, fn in fns.items():
            wire = g.init_mesh_wire(name, x, n_shards=n, wire_block=WB,
                                    mesh_shape=(k, per))
            jfn = jax.jit(fn)
            for sync in range(HIER_SYNCS):
                merged, wire = (fn if sync == 0 else jfn)(wire)
                if sync in (0, HIER_SYNCS - 1):
                    pre = f"{k}x{per}/{name}"
                    _flat_keys(f"{pre}/merged{sync + 1}",
                               jax.tree.map(np.asarray, merged), out)
                    _flat_keys(f"{pre}/wire{sync + 1}",
                               jax.tree.map(np.asarray, wire), out)
    if world != N:
        return out
    mesh = jax.make_mesh((2, 2), axis, devices=devs[:N])
    for merge in ("fedavg", "fisher"):
        for cross in CROSS:
            cfg = SwarmConfig(n_nodes=N, topology="ring", merge=merge,
                              lora_only=False, wire_dtype="int8",
                              wire_block=WB, cross_pod_cost=cross)
            eng = SwarmEngine(cfg, None, None, data_sizes=[1.0] * N,
                              backend="gossip", mesh=mesh, axis=axis)
            out[f"pick/{merge}/{cross:g}"] = np.asarray(
                eng.sync_schedule.name)
    return out


# ---------------------------------------------------------------------------
# checkpoints of a gossip session, and the fault plane on the gossip backend
# ---------------------------------------------------------------------------

#: (topology, merge, wire, two-level) of each checkpointed wire
CKPT = {"f32": ("ring", "fedavg", "f32", False),
        "ring_q8": ("ring", "fisher", "int8", False),
        "gathered_q8": ("dynamic", "fedavg", "int8", False),
        "psum_q8": ("full", "fisher", "int8", False),
        "hier_fedavg_q8": ("ring", "fedavg", "int8", True),
        "hier_fisher_q8": ("ring", "fisher", "int8", True)}
CKPT_ROUNDS = 2
#: the fault plane's payload: one leaf, as the reference's fault tests
FAULT_D = 640
FAULT_LEAVES = (("w", (FAULT_D,)),)


def faults_inputs(seed=4):
    rng = np.random.default_rng(seed)
    p = sum(int(np.prod(s)) for _, s in SESSION_LEAVES)
    return {"w0": rng.normal(0, 1, (N, p)).astype(np.float32),
            "fw0": rng.normal(0, 1, (N, FAULT_D)).astype(np.float32)}


def decay_step(p, o, b, s):
    return p * 0.999, o, {"loss": (p * 0).sum()}


def ckpt_cfg(case, thr=0.0):
    from repro_torch.configs.base import SwarmConfig
    topo, merge, wire, two = CKPT[case]
    return SwarmConfig(n_nodes=N, sync_every=1, topology=topo, merge=merge,
                       lora_only=False, val_threshold=thr, wire_dtype=wire,
                       wire_block=WB, cross_pod_cost=10.0 if two else 1.0)


def _equal(a, b) -> bool:
    """Two states' trees equal bit for bit."""
    import torch
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if a is None or b is None:
        return a is b
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return np.array_equal(np.asarray(a), np.asarray(b))


def _states_equal(a, b) -> bool:
    return all(_equal(getattr(a, f), getattr(b, f))
               for f in ("params", "opt_state", "stats", "wire", "active",
                         "rng")) and (a.round, a.step) == (b.round, b.step)


def port_checkpoints(meshes, inp, tmp):
    """Each CKPT wire: CKPT_ROUNDS rounds of the decay step, save, load into
    a fresh session (equal bit for bit), then CKPT_ROUNDS more rounds of
    both (equal bit for bit). Records the saved rows and wire, the
    schedule and the file's path."""
    import torch
    from repro_torch.core.session import SwarmSession
    from repro_torch.optim import adamw_init

    lay = session_layout()
    val, batches = torch.zeros((N, 1)), torch.zeros((1, N, 1))
    out = {}
    for case, (_, _, _, two) in CKPT.items():
        mesh = meshes[two]

        def mk():
            return SwarmSession(
                ckpt_cfg(case), decay_step, const_eval,
                params=[torch.from_numpy(r) for r in inp["w0"]],
                opt_state=adamw_init(torch.zeros(lay.size)),
                data_sizes=SIZES, layout=lay, device="cpu",
                backend="gossip", mesh=mesh, axis=mesh.axis)

        s1 = mk()
        for _ in range(CKPT_ROUNDS):
            s1.round(batches, val)
        path = os.path.join(tmp, f"ckpt_{case}.msgpack")
        s1.save(path)
        pre = f"ckpt/{case}"
        out[f"{pre}/path"] = np.asarray(path)
        out[f"{pre}/schedule"] = np.asarray(s1.sync_schedule.name)
        out[f"{pre}/params"] = s1.state.params.numpy().copy()
        if s1.state.stats is not None:
            out[f"{pre}/stats"] = s1.state.stats.numpy().copy()
        if s1.state.wire is not None:
            _flat_keys(f"{pre}/wire", _numpy(s1.state.wire), out)
            for key in [k for k in out if k.startswith(f"{pre}/wire/")]:
                out[key] = out[key].copy()
        s2 = mk().load(path)
        out[f"{pre}/roundtrip"] = np.asarray(_states_equal(s1.state,
                                                           s2.state))
        for _ in range(CKPT_ROUNDS):
            s1.round(batches, val)
            s2.round(batches, val)
        out[f"{pre}/resume"] = np.asarray(_states_equal(s1.state, s2.state))
    return out


def fault_cfg(thr, topo="ring", merge="fisher", cross=1.0, **kw):
    from repro_torch.configs.base import SwarmConfig
    return SwarmConfig(n_nodes=N, sync_every=1, topology=topo, merge=merge,
                       lora_only=False, val_threshold=thr, wire_dtype="int8",
                       wire_block=WB, self_weight=0.5, cross_pod_cost=cross,
                       **kw)


def port_fault_plane(meshes, inp, tmp):
    """The reference's gossip fault checks (`tests/test_faults_spmd.py`)
    on the port: crash → rejoin settling, the whole-wire quarantine, a
    preempt mid-plan (flat and hierarchical), the quorum, and the train
    step's calls over an 8-round plan."""
    import torch
    from repro_torch.core.flat import FlatLayout
    from repro_torch.faults import FaultPlan, run_plan

    flat = meshes[False]
    lay = FlatLayout(list(FAULT_LEAVES))
    w0 = inp["fw0"]
    val, batches = torch.zeros((N, 1)), torch.zeros((1, N, 1))
    out = {}

    def sess(cfg, step, mesh=flat):
        return make_session(cfg, step, w0, lay, mesh)

    for topo, merge in (("ring", "fisher"), ("full", "fedavg")):
        pre = f"crash/{topo}/{merge}"
        sa = sess(fault_cfg(1.5, topo, merge), id_step)
        plan = FaultPlan(n_nodes=N, n_rounds=9, seed=0).crash(1, at=1,
                                                              rejoin=3)
        sa, logs = run_plan(sa, plan, batches, val)
        out[f"{pre}/gates_any"] = np.asarray(
            any(lg["gates"].any() for lg in logs))
        out[f"{pre}/held"] = sa.state.params.numpy().copy()
        out[f"{pre}/active"] = sa.active
        out[f"{pre}/schedule"] = np.asarray(sa.sync_schedule.name)
        sb = sess(fault_cfg(0.0, topo, merge), id_step)
        sb.load_state(sa.state)
        out[f"{pre}/gates"] = sb.round(batches, val)["gates"].numpy()
        out[f"{pre}/committed"] = sb.state.params.numpy()

    sq = sess(fault_cfg(1.5), id_step)
    sq.round(batches, val)
    leaves = lambda w: [t for p in w.values() for t in p.values()]
    out["quarantine/before"] = np.asarray(
        any(bool(t.any()) for t in leaves(sq.state.wire)))
    sq.quarantine_wire(2)
    out["quarantine/after"] = np.asarray(
        any(bool(t.any()) for t in leaves(sq.state.wire)))

    base = FaultPlan(n_nodes=N, n_rounds=6, seed=0).crash(2, at=1, rejoin=4)
    for tag, two, merge in (("flat", False, "fisher"),
                            ("hier_fedavg", True, "fedavg"),
                            ("hier_fisher", True, "fisher")):
        cfg = fault_cfg(0.0, merge=merge, cross=10.0 if two else 1.0)

        def run(plan):
            mk = lambda: sess(cfg, decay_step, meshes[two])
            return run_plan(mk(), plan, batches, val, make_session=mk,
                            checkpoint_path=os.path.join(
                                tmp, f"preempt_{tag}.msgpack"))

        ra, la = run(base)
        rb, lb = run(base.preempt(at=3))
        pre = f"preempt/{tag}"
        out[f"{pre}/schedule"] = np.asarray(rb.sync_schedule.name)
        out[f"{pre}/equal"] = np.asarray(_states_equal(ra.state, rb.state))
        out[f"{pre}/gates_equal"] = np.asarray(
            [lg["gates"].tolist() for lg in la]
            == [lg["gates"].tolist() for lg in lb])
        out[f"{pre}/preempted"] = np.asarray([lg["preempted"] for lg in lb])
        out[f"{pre}/params"] = rb.state.params.numpy()

    sp = sess(fault_cfg(0.0, quorum=3), id_step)
    sp.set_active([True, False, False, True])
    log = sp.round(batches, val)
    out["quorum/low/gates"] = log["gates"].numpy()
    out["quorum/low/ok"] = log["quorum_ok"].numpy()
    out["quorum/low/params"] = sp.state.params.numpy().copy()
    sp.set_active([True, True, False, True])
    log = sp.round(batches, val)
    out["quorum/back/gates"] = log["gates"].numpy()
    out["quorum/back/ok"] = log["quorum_ok"].numpy()

    calls = []

    def counting_step(p, o, b, s):
        calls.append(1)
        return id_step(p, o, b, s)

    sc = sess(fault_cfg(1.5, quorum=2), counting_step)
    sc.round(batches, val)
    warm = len(calls)
    plan = (FaultPlan(n_nodes=N, n_rounds=8, seed=3)
            .crash(1, at=1, rejoin=3).straggle(3, at=4, rounds=1)
            .drop(0, at=5).corrupt(2, at=6))
    _, logs = run_plan(sc, plan, batches, val)
    out["plan/warm_calls"] = np.asarray(warm)
    out["plan/calls"] = np.asarray(len(calls))
    out["plan/active"] = np.stack([lg["active"] for lg in logs])
    out["plan/gates"] = np.stack([lg["gates"] for lg in logs])
    return out


# --- split compute within a node: a TrainStep on its shard ------------------

#: a node's leaves for the gather Function on a (1, 2, 2) world, named so
#: that the rules' specs cut them: the embedding over model, the final norm
#: replicated; stacked [L, ...]: Mamba2's in_proj (the layer axis over
#: data, d over model), the SSM's conv (its kernel axis over model) and a
#: replicated norm
SPLIT_LEAVES = (("embed.table", (10, 8)), ("final_norm.scale", (8,)),
                ("layers.ssm.in_proj.w", (4, 8, 12)),
                ("layers.ssm.conv_w", (4, 4, 6)),
                ("layers.ssm_norm.scale", (4, 8)))
SPLIT_L = 4
#: the (node, data, model) shapes of the split worlds
SPLIT_UNITS, SPLIT_D1 = (1, 2, 2), (2, 1, 2)
SPLIT_D2, SPLIT_D2M2 = (2, 2, 1), (2, 2, 2)
#: the session families: (name, arch) of the ssm, hybrid and moe smokes
SPLIT_ARCHS = (("ssm", "mamba2-370m"), ("hybrid", "hymba-1.5b"),
               ("moe", "granite-moe-3b-a800m"))
#: the JAX package's step against one node's split step
SPLIT_JAX = (("dense", "minicpm-2b"), ("ssm", "mamba2-370m"))
SPLIT_NODES, SPLIT_ROUNDS, SPLIT_STEPS = 2, 2, 2
SPLIT_BATCH, SPLIT_SEQ = 4, 16
SPLIT_JAX_STEPS, SPLIT_JAX_BATCH, SPLIT_JAX_SEQ = 2, 4, 32
SPLIT_WIRES = ("f32", "int8")


def split_layout():
    from repro_torch.core.flat import FlatLayout
    return FlatLayout(list(SPLIT_LEAVES))


def split_bytes(shard, n_layers, rest_itemsize=4):
    """A split step's bytes by kind and a split gate's bytes a score,
    counted from the shard layout and the specs alone: ``chip_smoke.
    _split_bytes``, the count the card run holds its steps and gates to,
    and the one the tests hold the port's counted bytes to."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._split_bytes(shard, n_layers, rest_itemsize)


def tp_bytes(*args, **kw):
    """A tensor-parallel split step's and gate's bytes by kind, counted
    from the layout: ``chip_smoke._tp_bytes``, the count the card run
    holds (g) and (h) to."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._tp_bytes(*args, **kw)


def split_cotangents(rank):
    """A rank's seeded cotangents of the whole unit and of each whole layer
    (``{path: [*shape]}`` for the unit's leaves, ``[L, ...]`` for the
    stacked ones, layer i at index i)."""
    rng = np.random.default_rng(100 + rank)
    return {p: rng.normal(0, 1, sh).astype(np.float32)
            for p, sh in SPLIT_LEAVES}


def split_inputs(seed=6):
    """Seeded numpy inputs of the split worlds: the gather's node [P], the
    sessions' token rows per family [R, T, N, B, S] and validation rows
    [N, B, S], a fallback batch of 3 rows."""
    from repro_torch.configs import get_config, smoke_variant
    rng = np.random.default_rng(seed)
    p = sum(int(np.prod(sh)) for _, sh in SPLIT_LEAVES)
    out = {"node": rng.normal(0, 1, (p,)).astype(np.float32)}
    for fam, arch in SPLIT_ARCHS:
        vocab = smoke_variant(get_config(arch)).vocab_size
        toks = rng.integers(0, vocab, (SPLIT_ROUNDS, SPLIT_STEPS,
                                       SPLIT_NODES, SPLIT_BATCH,
                                       SPLIT_SEQ + 1))
        out[f"{fam}/tokens"] = toks[..., :-1].astype(np.int64)
        out[f"{fam}/labels"] = toks[..., 1:].astype(np.int64)
        val = rng.integers(0, vocab, (SPLIT_NODES, SPLIT_BATCH,
                                      SPLIT_SEQ + 1))
        out[f"{fam}/vtokens"] = val[..., :-1].astype(np.int64)
        out[f"{fam}/vlabels"] = val[..., 1:].astype(np.int64)
    odd = rng.integers(0, 64, (3, SPLIT_SEQ + 1))
    out["odd/tokens"] = odd[:, :-1].astype(np.int64)
    out["odd/labels"] = odd[:, 1:].astype(np.int64)
    return out


#: the session worlds: the unsharded twin and the split meshes
SPLIT_WORLDS = {"split_twin": None, "split_d2": SPLIT_D2,
                "split_d2m2": SPLIT_D2M2}


def _split_mesh(shape):
    """The (node, data, model) mesh of ``shape``: a node a position."""
    from repro_torch.launch.mesh import make_swarm_mesh
    n, d, m = shape
    return make_swarm_mesh(n, data=d, model=m)[0]


def split_tc(remat=False, lr=1e-3, **kw):
    from repro_torch.configs.base import TrainConfig
    return TrainConfig(**dict(dict(lr=lr, warmup_steps=1, max_steps=4,
                                   remat=remat), **kw))


def _smoke(arch):
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import build_model
    return build_model(smoke_variant(get_config(arch)))


def _gather_case(mesh, out):
    """The gather Function on :data:`SPLIT_LEAVES` with the rules' specs:
    each unit forward against ``ShardLayout.gather`` of the node, and the
    local gradient of Σ whole · cotangent (the test holds it against the
    data group's cotangents)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.flat import ShardLayout
    from repro_torch.models.gather import NodeSplit
    from repro_torch.sharding.rules import param_specs

    layout = split_layout()
    specs = param_specs(layout, mesh)
    shard = ShardLayout(layout, specs, mesh.inner, mesh.coords)
    inp = np.load(os.path.join(os.environ["SPLIT_DIR"], "inputs.npz"))
    node = torch.from_numpy(inp["node"])
    local = shard.shard(node[None])[0].clone().requires_grad_()
    want = layout.unflatten(shard.gather(local.detach()[None],
                                         mesh.shard_view, kind=None)[0])
    plan = NodeSplit(shard, mesh.shard_view, mesh.data_view)
    tree = plan.tree(shard.local.unflatten(local))
    layer = plan.layers("layers", tree["layers"], lazy=False)
    cots = {p: torch.from_numpy(c)
            for p, c in split_cotangents(dist.get_rank()).items()}
    loss, equal = 0.0, []
    for path in plan.unit.paths:
        t = tree
        for key in path.split("."):
            t = t[key]
        equal.append(torch.equal(t, want[path]))
        loss = loss + (t * cots[path]).sum()
    for i in range(SPLIT_L):
        lp = layer(i)
        for path in plan.cuts["layers"].paths:
            t = lp
            for key in path.split(".")[1:]:
                t = t[key]
            equal.append(torch.equal(t, want[path][i]))
            loss = loss + (t * cots[path][i]).sum()
    (grad,) = torch.autograd.grad(loss, local)
    out["gather/forward_equal"] = np.asarray(equal)
    out["gather/grad"] = grad.numpy()
    out["gather/coords"] = np.asarray([mesh.coords["data"],
                                       mesh.coords["model"]])
    out["gather/specs"] = np.asarray(repr(sorted(specs.items())))


def _node_params(shard, mesh, local):
    """The whole node gathered from the rank's shard (uncounted)."""
    return shard.gather(local[None], mesh.shard_view, kind=None)[0]


def _memory_case(mesh, out):
    """A Mamba2 smoke split step with the whole layers that are alive at
    once counted (remat on and off), the gradient's and moments' sizes and
    the largest whole cotangent a reduce takes."""
    import gc
    import weakref
    import torch
    from repro_torch.core.flat import ShardLayout
    from repro_torch.launch import train
    from repro_torch.models import gather
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.rules import param_specs

    model = _smoke("mamba2-370m")
    layout = model.layout
    shard = ShardLayout(layout, param_specs(layout, mesh), mesh.inner,
                        mesh.coords)
    inp = np.load(os.path.join(os.environ["SPLIT_DIR"], "inputs.npz"))
    batch = {k: torch.from_numpy(inp[f"ssm/{k}"][0, 0, 0])
             for k in ("tokens", "labels")}
    live, peak, sizes, cots = [0], [0], {}, [0]

    orig_gather, orig_reduce = gather.NodeSplit.gather, gather.NodeSplit.reduce

    def gathered(self, cut, local, i):
        whole = orig_gather(self, cut, local, i)
        if cut.stacked:
            gc.collect()
            live[0] += 1
            peak[0] = max(peak[0], live[0])
            weakref.finalize(whole[cut.gathered[0]],
                             lambda: live.__setitem__(0, live[0] - 1))
        return whole

    def reduce(self, cut, cts, i, local):
        cots[0] = max(cots[0], sum(c.numel() for c in cts if c is not None))
        return orig_reduce(self, cut, cts, i, local)

    orig_update = train.adamw_update_

    def update(parts, grads, opt, tc, lr, norm=None):
        sizes["grads"] = sum(g.numel() for g in grads)
        sizes["mu"] = opt["mu"].numel()
        return orig_update(parts, grads, opt, tc, lr, norm=norm)

    gather.NodeSplit.gather, gather.NodeSplit.reduce = gathered, reduce
    train.adamw_update_ = update
    try:
        for remat in (True, False):
            live[0] = peak[0] = cots[0] = 0
            step = train.make_train_step(model, split_tc(remat))
            p0 = model.init(torch.Generator().manual_seed(0), "cpu")
            p = shard.shard(p0[None])[0]
            o = adamw_init(shard.local.parts(p))
            step.split(p, o, batch, shard=shard, mesh=mesh)
            gc.collect()
            tag = "remat" if remat else "plain"
            out[f"memory/{tag}/peak_layers"] = np.asarray(peak[0])
            out[f"memory/{tag}/grads"] = np.asarray(sizes["grads"])
            out[f"memory/{tag}/mu"] = np.asarray(sizes["mu"])
            out[f"memory/{tag}/largest_cotangent"] = np.asarray(cots[0])
    finally:
        gather.NodeSplit.gather, gather.NodeSplit.reduce = (orig_gather,
                                                            orig_reduce)
        train.adamw_update_ = orig_update
    cuts = gather.NodeSplit(shard, mesh.shard_view).cuts["layers"]
    out["memory/layer_values"] = np.asarray(
        sum(int(np.prod(sh)) for sh in cuts.shapes))
    out["memory/local_values"] = np.asarray(shard.local.n_values)
    out["memory/node_values"] = np.asarray(layout.n_values)
    out["memory/n_layers"] = np.asarray(model.cfg.n_layers)


def _step_case(mesh, out):
    """One node's split step on this rank's shard: the JAX package's
    params (converted), SPLIT_JAX_STEPS steps, the node's params gathered;
    a batch of 3 rows (no split over 2 data ranks) against the opaque
    whole-node step (both runs' params, moments and losses); accumulation;
    remat on against off."""
    import torch
    from repro_torch.core.flat import ShardLayout
    from repro_torch.launch import train
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.rules import param_specs

    inp = np.load(os.path.join(os.environ["SPLIT_DIR"], "inputs.npz"))
    for fam, arch in SPLIT_JAX:
        model = _smoke(arch)
        layout = model.layout
        shard = ShardLayout(layout, param_specs(layout, mesh), mesh.inner,
                            mesh.coords)
        # test_torch_train's settings (lr 1e-4, no warmup), remat on
        step = train.make_train_step(model, split_tc(
            True, lr=1e-4, warmup_steps=0, max_steps=10))
        p = shard.shard(torch.from_numpy(inp[f"jax/{fam}/flat"])[None])[0]
        o = adamw_init(shard.local.parts(p))
        losses = []
        for k in range(SPLIT_JAX_STEPS):
            b = {key: torch.from_numpy(inp[f"jax/{fam}/{key}"][k])
                 for key in ("tokens", "labels")}
            p, o, m = step.split(p, o, b, shard=shard, mesh=mesh)
            losses.append(float(m["loss"]))
        out[f"jax/{fam}/loss"] = np.asarray(losses)
        out[f"jax/{fam}/params"] = _node_params(shard, mesh, p).numpy()
    # the fallback: 3 rows over 2 data ranks stay whole
    model = _smoke("mamba2-370m")
    layout = model.layout
    shard = ShardLayout(layout, param_specs(layout, mesh), mesh.inner,
                        mesh.coords)
    odd = {k: torch.from_numpy(inp[f"odd/{k}"]) for k in ("tokens",
                                                           "labels")}
    p0 = model.init(torch.Generator().manual_seed(0), "cpu")
    step = train.make_train_step(model, split_tc())
    pw, ow = p0.clone(), adamw_init(layout.parts(p0))
    ps = shard.shard(p0[None])[0]
    os_ = adamw_init(shard.local.parts(ps))
    for _ in range(2):
        pw, ow, mw = step(pw, ow, odd)
        ps, os_, ms = step.split(ps, os_, odd, shard=shard, mesh=mesh)
    out["odd/params"] = np.stack([shard.shard(pw[None])[0].numpy(),
                                  ps.numpy()])
    out["odd/moments"] = np.stack([
        np.stack([shard.shard(ow[k][None])[0].numpy(), os_[k].numpy()])
        for k in ("mu", "nu")])
    out["odd/loss"] = np.asarray([float(mw["loss"]), float(ms["loss"])])
    # accumulation: 4 rows over 2 data ranks in 2 microbatches of one row
    # against the whole node's 2 microbatches of two; 6 rows stay whole
    for rows in (4, 6):
        tc = split_tc(accum_steps=2)
        st = train.make_train_step(model, tc)
        b = {k: torch.from_numpy(np.concatenate(
            [inp[f"ssm/{k}"][0, 0, 0], inp[f"ssm/{k}"][0, 1, 0]])[:rows])
             for k in ("tokens", "labels")}
        pw, ow = p0.clone(), adamw_init(layout.parts(p0))
        pw, ow, mw = st(pw, ow, b)
        ps = shard.shard(p0[None])[0]
        os_ = adamw_init(shard.local.parts(ps))
        ps, os_, ms = st.split(ps, os_, b, shard=shard, mesh=mesh)
        want = shard.shard(ow["mu"][None])[0] / (1 - tc.b1)
        out[f"accum/{rows}/grad_diff"] = np.asarray(float(
            (os_["mu"] / (1 - tc.b1) - want).abs().max()))
        out[f"accum/{rows}/params"] = np.stack(
            [shard.shard(pw[None])[0].numpy(), ps.numpy()])
        out[f"accum/{rows}/loss"] = np.asarray([float(mw["loss"]),
                                                float(ms["loss"])])
    # remat on against off on the split path (4 rows: split over data):
    # one step's loss and clipped gradient (its first moment over 1 - b1)
    batch = {k: torch.from_numpy(inp[f"ssm/{k}"][0, 0, 0])
             for k in ("tokens", "labels")}
    got = {}
    for remat in (False, True):
        tc = split_tc(remat)
        st = train.make_train_step(model, tc)
        p = shard.shard(p0[None])[0]
        o = adamw_init(shard.local.parts(p))
        p, o, m = st.split(p, o, batch, shard=shard, mesh=mesh)
        got[remat] = (o["mu"] / (1 - tc.b1), float(m["loss"]))
    out["remat/grad_diff"] = np.asarray(float(
        (got[True][0] - got[False][0]).abs().max()))
    out["remat/loss"] = np.asarray([got[False][1], got[True][1]])


def port_split_units(inp):
    """On one node as (data, model) = (2, 2): the gather Function, one
    node's split step against the JAX package's (converted params), the
    indivisible batch's fallback, remat, and the memory a step holds."""
    mesh = _split_mesh(SPLIT_UNITS)
    out = {}
    _gather_case(mesh, out)
    _step_case(mesh, out)
    _memory_case(mesh, out)
    return out


def _split_session(arch, cfg, mesh, sharded, opaque=False):
    """A Mamba2 / Hymba / granite smoke session of SPLIT_NODES on the
    gossip backend, remat on: with ``sharded`` the rules' specs; the step
    the ``TrainStep`` itself, or with ``opaque`` a lambda around it (the
    whole-node gather)."""
    import torch
    from repro_torch.core.session import SwarmSession
    from repro_torch.launch import train
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.rules import param_specs

    model = _smoke(arch)
    layout = model.layout
    step = train.make_train_step(model, split_tc(remat=True))
    veval = torch.func.vmap(lambda p, v: 1.0 / (1.0 + model.loss_fn(
        layout.unflatten(p), v, remat=False)[0]))
    p0 = model.init(torch.Generator().manual_seed(0), "cpu")
    return SwarmSession(cfg, (lambda p, o, b, s: step(p, o, b)) if opaque
                        else step, lambda p, v: veval(p, v), params=p0,
                        opt_state=adamw_init(layout.parts(p0)),
                        data_sizes=INNER_SIZES, layout=layout, device="cpu",
                        backend="gossip", mesh=mesh, axis=mesh.axis,
                        param_specs=(param_specs(layout, mesh) if sharded
                                     else None))


def split_cfg(wire="f32"):
    from repro_torch.configs.base import SwarmConfig
    return SwarmConfig(n_nodes=SPLIT_NODES, sync_every=SPLIT_STEPS,
                       topology="full", merge="fedavg", lora_only=False,
                       val_threshold=0.0, wire_dtype=wire, wire_block=WB)


def _split_batches(inp, fam, r):
    import torch
    return {k: torch.from_numpy(inp[f"{fam}/{k}"][r])
            for k in ("tokens", "labels")}


def _split_val(inp, fam):
    import torch
    return {"tokens": torch.from_numpy(inp[f"{fam}/vtokens"]),
            "labels": torch.from_numpy(inp[f"{fam}/vlabels"])}


def port_split_d1(inp):
    """(node, data, model) = (2, 1, 2): the Mamba2 smoke session with its
    TrainStep split (remat on; tensor-parallel over the model group)
    against the same session with the step opaque (the whole-node gather)
    on each wire: each round's gates, params, moments and losses, both
    runs'."""
    import torch
    mesh = _split_mesh(SPLIT_D1)
    out = {}
    for wire in SPLIT_WIRES:
        runs = {}
        for opaque in (False, True):
            sess = _split_session("mamba2-370m", split_cfg(wire), mesh, True,
                                  opaque=opaque)
            assert sess.engine.splits != opaque
            rec = []
            for r in range(SPLIT_ROUNDS):
                log = sess.round(_split_batches(inp, "ssm", r),
                                 _split_val(inp, "ssm"))
                st = sess.state
                rec.append((log["gates"].clone(), st.params.clone(),
                            st.opt_state["mu"].clone(),
                            st.opt_state["nu"].clone(),
                            log["train"]["loss"].clone()))
            runs[opaque] = rec
        for r in range(SPLIT_ROUNDS):
            a, b = runs[False][r], runs[True][r]
            out[f"d1/{wire}/{r}/gates"] = np.stack([a[0].numpy(),
                                                    b[0].numpy()])
            for name, x, y in zip(("params", "mu", "nu", "loss"), a[1:],
                                  b[1:]):
                out[f"d1/{wire}/{r}/{name}"] = np.stack([x.numpy(),
                                                         y.numpy()])
        out[f"d1/{wire}/schedule"] = np.asarray(sess.sync_schedule.name)
    return out


def _reduce_case(mesh, fam, arch, out):
    """The data group's reduce of seeded whole cotangents of every unit of
    the ``arch`` smoke model (bf16, its wide leaves f32; the rank's own
    seed) against the whole-cotangent form on the same cotangents: the
    whole f32 cotangent all_reduced over the data group, divided by D,
    cut to the rank's blocks and rounded once. Records, a unit each, whether every
    held block is equal bit for bit, and the bytes the reduces counted
    by kind."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import gossip
    from repro_torch.core.flat import ShardLayout
    from repro_torch.models.gather import NodeSplit
    from repro_torch.sharding.rules import param_specs

    layout = _smoke(arch).layout
    shard = ShardLayout(layout, param_specs(layout, mesh), mesh.inner,
                        mesh.coords)
    plan = NodeSplit(shard, mesh.shard_view, mesh.data_view,
                     dtype=torch.bfloat16)
    depth = {lf.path: lf.shape[0] for lf in layout.leaves}
    units = [(plan.unit, 0)] + [(cut, i) for cut in plan.cuts.values()
                                for i in range(depth[cut.paths[0]])]
    gen = torch.Generator().manual_seed(1000 + dist.get_rank())
    view, d = mesh.data_view, mesh.data_view.world_size
    mesh.reset_counts()
    equal = []
    for cut, i in units:
        cots = [torch.randn(shape, generator=gen).to(dtype)
                for shape, dtype in zip(cut.shapes, cut.dtypes)]
        held = [torch.empty(0) if cut.holds(k, i) else None
                for k in range(len(cut.paths))]
        got = plan.reduce(cut, cots, i, held)
        flat = gossip.all_reduce(view, torch.cat(
            [c.reshape(-1).to(torch.float32) for c in cots]), kind=None)
        flat.div_(d)
        whole = [part.view(c.shape) for part, c in
                 zip(flat.split([c.numel() for c in cots]), cots)]
        want = [cut.shard_of(k, c).to(cut.dtypes[k])
                for k, (c, t) in enumerate(zip(whole, held))
                if t is not None]
        equal.append(len(got) == len(want) and all(
            g.dtype == w.dtype and torch.equal(g, w)
            for g, w in zip(got, want)))
    out[f"{fam}/reduce/equal"] = np.asarray(equal)
    for kind, n in mesh.counts.items():
        out[f"{fam}/reduce/bytes/{kind}"] = np.asarray(n)


def port_split_sessions(inp, shape):
    """The three smoke families' sessions: ``shape`` None, 2 unsharded
    ranks (the twin); else the (node, data, model) world with the rules'
    specs and the TrainStep split. Each round's gates and node losses,
    the node's params after the last round (gathered), the steps' and the
    sync's counted bytes."""
    import torch
    from repro_torch.launch.mesh import make_swarm_mesh
    mesh = (make_swarm_mesh(SPLIT_NODES)[0] if shape is None
            else _split_mesh(shape))
    out = {"rows": np.asarray([mesh.rows.start, mesh.rows.stop]),
           "coords": np.asarray([mesh.coords.get("data", 0),
                                 mesh.coords.get("model", 0)])}
    for fam, arch in SPLIT_ARCHS:
        if shape is not None:
            _reduce_case(mesh, fam, arch, out)
        sess = _split_session(arch, split_cfg(), mesh, shape is not None)
        out[f"{fam}/splits"] = np.asarray(sess.engine.splits)
        for r in range(SPLIT_ROUNDS):
            log = sess.round(_split_batches(inp, fam, r),
                             _split_val(inp, fam))
            out[f"{fam}/gates{r}"] = log["gates"].numpy()
            out[f"{fam}/loss{r}"] = log["train"]["loss"].numpy()
        out[f"{fam}/params"] = sess.engine.node_tensor(
            sess.state.params, kind=None).numpy()
        if shape is not None:
            for k, v in (sess.counted_step_bytes or {}).items():
                out[f"{fam}/step_bytes/{k}"] = np.asarray(v)
    return out


#: the split gate's world: (node, data, model)
SPLIT_GATE = (2, 2, 2)


def _gate_session(cfg, mesh, specs, split_step, split_gate):
    """The Mamba2 smoke session of SPLIT_NODES on ``mesh`` with ``specs``,
    remat on: the TrainStep itself (``split_step``) or in a lambda, the
    `SwarmEval` itself (``split_gate``) or in a lambda (the whole-node
    gather)."""
    import torch
    from repro_torch.core.session import SwarmSession
    from repro_torch.launch import train
    from repro_torch.optim import adamw_init

    model = _smoke("mamba2-370m")
    layout = model.layout
    step = train.make_train_step(model, split_tc(remat=True))
    ev = train.make_swarm_eval(model)
    p0 = model.init(torch.Generator().manual_seed(0), "cpu")
    return SwarmSession(
        cfg, step if split_step else (lambda p, o, b, s: step(p, o, b)),
        ev if split_gate else (lambda p, v: ev(p, v)), params=p0,
        opt_state=adamw_init(layout.parts(p0)), data_sizes=INNER_SIZES,
        layout=layout, device="cpu", backend="gossip", mesh=mesh,
        axis=mesh.axis, param_specs=specs)


def _gate_runs(inp, mesh, specs, wire, rounds, split_step, out, tag):
    """The same session with the split gate and with an opaque eval:
    each round's metrics, gates, params and moments, the sync's gather
    bytes, into ``out`` under ``tag``."""
    import torch
    runs = {}
    for split_gate in (True, False):
        sess = _gate_session(split_cfg(wire), mesh, specs, split_step,
                             split_gate)
        assert sess.engine.split_gate == split_gate
        assert sess.engine.splits == split_step
        rec = []
        for r in range(rounds):
            log = sess.round(_split_batches(inp, "ssm", r),
                             _split_val(inp, "ssm"))
            st = sess.state
            rec.append(dict(
                metrics=torch.stack([log["metric_local"],
                                     log["metric_merged"]]).numpy(),
                state=(log["gates"].clone(), st.params.clone(),
                       st.opt_state["mu"].clone(),
                       st.opt_state["nu"].clone()),
                bytes=dict(sess.counted_sync_bytes)))
        runs[split_gate] = rec
        out[f"{tag}/split_gate/{int(split_gate)}"] = np.asarray(
            sess.engine.split_gate)
    for r in range(rounds):
        a, b = runs[True][r], runs[False][r]
        out[f"{tag}/{r}/equal"] = np.asarray(
            [torch.equal(x, y) for x, y in zip(a["state"], b["state"])])
        out[f"{tag}/{r}/metrics"] = np.stack([a["metrics"], b["metrics"]])
        out[f"{tag}/{r}/gates"] = a["state"][0].numpy()
        for name, rec in (("split", a), ("whole", b)):
            for kind in ("gate_gather", "shard_gather"):
                out[f"{tag}/{r}/{name}/{kind}"] = np.asarray(
                    rec["bytes"].get(kind, -1))


def port_split_gate(inp):
    """(node, data, model) = (2, 2, 2), the Mamba2 smoke session: the
    split gate against the whole-node gate, with the TrainStep split, on
    each wire; then with every stacked leaf cut over ``data`` on its layer
    axis only (half of a node's ranks hold no block of a layer), the step
    opaque, on the f32 wire."""
    from repro_torch.core.flat import ShardLayout
    from repro_torch.models.gather import NodeSplit
    from repro_torch.sharding.rules import param_specs

    mesh = _split_mesh(SPLIT_GATE)
    layout = _smoke("mamba2-370m").layout
    out = {"rows": np.asarray([mesh.rows.start, mesh.rows.stop]),
           "coords": np.asarray([mesh.coords["data"],
                                 mesh.coords["model"]])}
    specs = param_specs(layout, mesh)
    for wire in SPLIT_WIRES:
        _gate_runs(inp, mesh, specs, wire, SPLIT_ROUNDS, True, out,
                   f"gate/{wire}")
    layered = dict(specs)
    for lf in layout.leaves:
        if lf.path.startswith("layers."):
            layered[lf.path] = ("data",) + (None,) * (len(lf.shape) - 1)
    cut = NodeSplit(ShardLayout(layout, layered, mesh.inner, mesh.coords),
                    mesh.shard_view).cuts["layers"]
    depth = {lf.path: lf.shape[0] for lf in layout.leaves}[cut.paths[0]]
    out["empty/layers"] = np.asarray(
        [i for i in range(depth)
         if not any(cut.holds(k, i) for k in range(len(cut.paths)))])
    _gate_runs(inp, mesh, layered, "f32", 1, False, out, "empty")
    return out


# --- tensor parallelism within a node: the split step on a model group ------

#: the (node, data, model) shapes: the units' world, the steps' worlds
TP_UNITS = (1, 1, 2)
TP_WORLDS = {"tp_m2": (1, 1, 2), "tp_d2m2": (1, 2, 2)}
#: the families' smoke models two split steps run against the JAX package
TP_ARCHS = (("dense", "minicpm-2b"), ("ssm", "mamba2-370m"),
            ("moe", "granite-moe-3b-a800m"), ("hybrid", "hymba-1.5b"),
            ("encdec", "seamless-m4t-medium"))
TP_JAX_STEPS, TP_JAX_BATCH, TP_JAX_SEQ = 2, 4, 32
#: the blocks held against the reference's functions: (case, arch, config
#: changes, module, window)
TP_BLOCKS = (("attn_heads", "minicpm-2b", {}, "attn", 0),
             ("attn_seq", "granite-moe-3b-a800m", {}, "attn", 0),
             ("attn_seq_window", "granite-moe-3b-a800m", {}, "attn", 6),
             ("mlp", "minicpm-2b", {}, "mlp", 0),
             ("moe_cut", "granite-moe-3b-a800m", {}, "moe", 0),
             ("moe_whole", "granite-moe-3b-a800m", {"n_experts": 3}, "moe",
              0),
             ("ssm", "mamba2-370m", {}, "ssm", 0),
             ("enc_heads", "seamless-m4t-medium", {}, "enc", 0),
             ("enc_seq", "seamless-m4t-medium", {"n_kv_heads": 1}, "enc", 0),
             ("dec_heads", "seamless-m4t-medium", {}, "dec", 0),
             ("dec_seq", "seamless-m4t-medium", {"n_kv_heads": 1}, "dec", 0))
#: the blocks' batch and sequence; the encoder output's length (a decoder
#: block's cross-attention keys)
TP_B, TP_S, TP_T = 2, 16, 24
#: the collectives' input shape, and the vocab of the loss's case
TP_X = (2, 8, 6)
TP_VOCAB, TP_D = 12, 6


def tp_block_cfg(arch, changes):
    from repro_torch.configs import get_config, smoke_variant
    return smoke_variant(get_config(arch)).replace(**changes)


def tp_block_prefix(module):
    """The leaf paths' prefix of a block case's module: a decoder-only
    layer's mixer (``layers.<module>.``), or an enc-dec's whole encoder
    (``enc``) or decoder (``dec``) layer."""
    return {"enc": "enc_layers.", "dec": "dec_layers."}.get(
        module, f"layers.{module}.")


def tp_block_params(case, seed=11):
    """A block case's per-layer params (layer 0 of the smoke model's init:
    ``{"<prefix><leaf>": array}``, `tp_block_prefix`) and its config."""
    import torch
    from repro_torch.models import build_model
    name, arch, changes, module, _ = next(c for c in TP_BLOCKS
                                          if c[0] == case)
    cfg = tp_block_cfg(arch, changes)
    model = build_model(cfg)
    views = model.layout.unflatten(model.init(
        torch.Generator().manual_seed(seed), "cpu"))
    prefix = tp_block_prefix(module)
    return cfg, {p: t[0].numpy().copy() for p, t in views.items()
                 if p.startswith(prefix)}


def tp_inputs(seed=12):
    """Seeded numpy inputs of the units' world: each rank's collective
    input and cotangent, the loss case's logits, labels, mask and tables,
    each block's params, input and cotangent (a decoder block's encoder
    output too)."""
    rng = np.random.default_rng(seed)
    out = {}
    m = TP_UNITS[2]
    for r in range(m):
        out[f"x{r}"] = rng.normal(0, 1, TP_X).astype(np.float32)
        for name, shape in (("gather", (2, 8 * m, 6)),
                            ("scatter", (2, 8 // m, 6)),
                            ("a2a", (2, 8 // m, 6 * m)),
                            ("local", (2, 8 // m, 6)),
                            ("reduce", TP_X), ("replicated", TP_X)):
            out[f"cot/{name}{r}"] = rng.normal(0, 1, shape).astype(
                np.float32)
    out["xent/logits"] = rng.normal(0, 2, (2, 8, TP_VOCAB)).astype(
        np.float32)
    out["xent/labels"] = rng.integers(0, TP_VOCAB - 2, (2, 8))
    out["xent/mask"] = rng.random((2, 8)) > 0.3
    out["xent/tokens"] = rng.integers(0, TP_VOCAB, (2, 8))
    out["xent/table"] = rng.normal(0, 1, (TP_VOCAB, TP_D)).astype(np.float32)
    for case, *_ in TP_BLOCKS:
        cfg, params = tp_block_params(case)
        for p, a in params.items():
            out[f"block/{case}/p/{p}"] = a
        out[f"block/{case}/h"] = rng.normal(0, 1, (TP_B, TP_S, cfg.d_model)
                                            ).astype(np.float32)
        out[f"block/{case}/cot"] = rng.normal(
            0, 1, (TP_B, TP_S, cfg.d_model)).astype(np.float32)
    for case, _, _, module, _ in TP_BLOCKS:
        if module == "dec":
            out[f"block/{case}/kv"] = rng.normal(
                0, 1, (TP_B, TP_T, cfg.d_model)).astype(np.float32)
    return out


def tp_slices(ivs):
    """Index arrays of a compute block's intervals a dimension."""
    return [np.concatenate([np.arange(a, a + n) for a, n in dim])
            for dim in ivs]


def tp_take(a, ivs):
    """A compute block of ``a`` from its intervals."""
    for dim, idx in enumerate(tp_slices(ivs)):
        a = np.take(a, idx, axis=dim)
    return a


def _tp_collectives(mesh, inp, out):
    """Each collective of `repro_torch.sharding.tensor` on this rank's
    seeded input: its output and the gradient of Σ out · cotangent."""
    import torch
    from repro_torch.sharding import tensor
    r = mesh.model_view.rank
    plan = tensor.TensorPlan(mesh.model_view, None, None)
    x = torch.from_numpy(inp[f"x{r}"])
    cases = {"gather": lambda t: tensor.gather(t, 1),
             "scatter": lambda t: tensor.scatter_sum(t, 1),
             "a2a": lambda t: tensor.all_to_all(t, 1, 2),
             "local": lambda t: tensor.local(t, 1),
             "reduce": tensor.all_reduce, "replicated": tensor.replicated}
    with tensor.model_group(plan):
        for name, fn in cases.items():
            xi = x.clone().requires_grad_()
            y = fn(xi)
            (g,) = torch.autograd.grad(
                (y * torch.from_numpy(inp[f"cot/{name}{r}"])).sum(), xi)
            out[f"coll/{name}/out"] = y.detach().numpy()
            out[f"coll/{name}/grad"] = g.numpy()


def _tp_xent(mesh, inp, out):
    """The vocab-parallel loss (the masked token mean of
    `repro_torch.models.layers.softmax_xent` on the rank's vocab cut) and
    its gradient; the embedding's lookups from a vocab-cut and a
    d_model-cut table onto the rank's cut of the sequence."""
    import torch
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.layers import softmax_xent
    from repro_torch.models.transformer import embed_tp
    from repro_torch.sharding import tensor
    from repro_torch.sharding.rules import Placement
    r, m = mesh.model_view.rank, mesh.model_view.world_size
    v = TP_VOCAB // m
    logits = torch.from_numpy(inp["xent/logits"][..., r * v:(r + 1) * v]
                              ).requires_grad_()
    for tied in (True, False):
        place = Placement(model=m, attention="heads", ff=True, experts=True,
                          ssm_heads=True, vocab=True,
                          embed="vocab" if tied else "d_model")
        plan = tensor.TensorPlan(mesh.model_view, place, None)
        table = inp["xent/table"]
        cut = table[r * v:(r + 1) * v] if tied else \
            table[:, r * (TP_D // m):(r + 1) * (TP_D // m)]
        cfg = ModelConfig(d_model=TP_D, compute_dtype="float32")
        with tensor.model_group(plan):
            x = embed_tp({"table": torch.from_numpy(cut)},
                         torch.from_numpy(inp["xent/tokens"]), cfg)
            out[f"embed/{'vocab' if tied else 'd_model'}"] = x.numpy()
            if tied:
                loss = softmax_xent(logits, torch.from_numpy(
                    inp["xent/labels"]), torch.from_numpy(inp["xent/mask"]))
                (g,) = torch.autograd.grad(loss, logits)
                out["xent/loss"] = loss.detach().numpy()
                out["xent/grad"] = g.numpy()


def tp_block_fn(module):
    """A block case's function of ``(p, h, cfg, positions, window, kv)``:
    the tensor-parallel form under a model group, the plain one
    without."""
    from repro_torch.models import encdec
    from repro_torch.models.attention import attention, attention_tp
    from repro_torch.models.layers import mlp
    from repro_torch.models.moe import moe, moe_tp
    from repro_torch.models.ssm import ssm_block, ssm_tp
    from repro_torch.sharding import tensor

    def fn(p, h, cfg, positions, window, kv):
        tp = tensor.current() is not None
        if module == "attn":
            return (attention_tp if tp else attention)(
                p, h, cfg, positions=positions, window=window)
        if module == "mlp":
            return mlp(p, h, cfg)
        if module == "moe":
            return (moe_tp if tp else moe)(p, h, cfg)
        if module == "ssm":
            return (ssm_tp if tp else ssm_block)(p, h, cfg)[0]
        if module == "enc":
            return encdec._enc_block(p, h, cfg, positions)
        return encdec._dec_block(p, h, cfg, positions, kv, None, None, None)

    return fn


def _tp_blocks(mesh, inp, out):
    """Each block of TP_BLOCKS under tensor parallelism on this rank's
    cut of the sequence and its compute blocks of the params: its output
    (the MoE's aux too), and the gradients of Σ out · cotangent of the
    params' compute blocks, of the input's cut and of a decoder block's
    whole encoder output."""
    import torch
    from repro_torch.models import nest
    from repro_torch.sharding import tensor
    from repro_torch.sharding.rules import compute_cut, placement
    m, r = mesh.model_view.world_size, mesh.model_view.rank
    for case, arch, changes, module, window in TP_BLOCKS:
        cfg = tp_block_cfg(arch, changes)
        place = placement(cfg, m)
        prefix = f"block/{case}/p/"
        params = {k[len(prefix):]: v for k, v in inp.items()
                  if k.startswith(prefix)}
        blocks = {p: torch.from_numpy(tp_take(a, compute_cut(
            cfg, place, p, a.shape, r))).requires_grad_()
            for p, a in params.items()}
        n = TP_S // m
        h = torch.from_numpy(inp[f"block/{case}/h"][:, r * n:(r + 1) * n]
                             ).requires_grad_()
        cot = torch.from_numpy(inp[f"block/{case}/cot"][:, r * n:(r + 1) * n])
        kv = inp.get(f"block/{case}/kv")
        ins = [h] if kv is None else [
            h, torch.from_numpy(kv).requires_grad_()]
        lead = len(tp_block_prefix(module))
        p = nest({k[lead:]: t for k, t in blocks.items()})
        positions = torch.arange(TP_S)[None].expand(TP_B, TP_S)
        with tensor.model_group(tensor.TensorPlan(mesh.model_view, place,
                                                  cfg)):
            y = tp_block_fn(module)(p, h, cfg, positions, window,
                                    ins[-1] if kv is not None else None)
            aux = None
            if module == "moe":
                y, aux = y
            loss = (y * cot).sum() + (0 if aux is None else aux)
            grads = torch.autograd.grad(loss, ins + list(blocks.values()))
        out[f"block/{case}/y"] = y.detach().numpy()
        if aux is not None:
            out[f"block/{case}/aux"] = aux.detach().numpy()
        out[f"block/{case}/gh"] = grads[0].numpy()
        if kv is not None:
            out[f"block/{case}/gkv"] = grads[1].numpy()
        for path, g in zip(blocks, grads[len(ins):]):
            out[f"block/{case}/g/{path}"] = g.numpy()


def port_tp_units(inp):
    """(node, data, model) = (1, 1, 2): the collectives, the vocab-parallel
    loss and embedding, and every block of TP_BLOCKS."""
    mesh = _split_mesh(TP_UNITS)
    out = {}
    _tp_collectives(mesh, inp, out)
    _tp_xent(mesh, inp, out)
    _tp_blocks(mesh, inp, out)
    return out


def _tp_capture(step_fn):
    """Run ``step_fn()`` with AdamW's gradient parts recorded: (its
    result, the gradient parts the update took)."""
    from repro_torch.launch import train
    orig, seen = train.adamw_update_, {}

    def update(parts, grads, opt, tc, lr, norm=None):
        seen["grads"] = [g.detach().clone() for g in grads]
        return orig(parts, grads, opt, tc, lr, norm=norm)

    train.adamw_update_ = update
    try:
        return step_fn(), seen["grads"]
    finally:
        train.adamw_update_ = orig


def port_tp_steps(inp, shape):
    """A world of ``shape`` (node, data, model): for each family of
    TP_ARCHS, two split steps from the JAX package's params (remat on;
    the losses, the node's params, each step's bytes by kind), the split
    gate's metric against the whole node's, the first step's gradient
    gathered leaf by leaf against the unsharded step's, the compute
    blocks a step gathers (their shapes, how many of a checkpointed stack
    alive at once; an enc-dec's gathers of frame rows a step); then the
    TP_MORE steps and the enc-dec's sequence-parallel form."""
    import gc
    import weakref
    import torch
    from repro_torch.core.flat import ShardLayout
    from repro_torch.launch import train
    from repro_torch.models import gather as G
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.rules import param_specs
    mesh = _split_mesh(shape)
    out = {"coords": np.asarray([mesh.coords["data"], mesh.coords["model"]])}
    for fam, arch in TP_ARCHS:
        model = _smoke(arch)
        layout = model.layout
        shard = ShardLayout(layout, param_specs(layout, mesh), mesh.inner,
                            mesh.coords)
        step = train.make_train_step(model, split_tc(
            True, lr=1e-4, warmup_steps=0, max_steps=10))
        flat = torch.from_numpy(inp[f"jax/{fam}/flat"])
        p = shard.shard(flat[None])[0]
        o = adamw_init(shard.local.parts(p))
        keys = [k for k in ("tokens", "labels", "frames")
                if f"jax/{fam}/{k}" in inp]
        batches = [{key: torch.from_numpy(inp[f"jax/{fam}/{key}"][k])
                    for key in keys} for k in range(TP_JAX_STEPS)]
        # the compute blocks the steps gather: alive at once (of the
        # stacks remat checkpoints: not an enc-dec's encoder, whose layers
        # the backward keeps, as the reference's), and their shapes against
        # the whole layer's
        live, peak, whole_layer = [0], [0], [False]
        orig = G.NodeSplit.gather

        def gathered(self, cut, local, i):
            got = orig(self, cut, local, i)
            if cut.stacked:
                for k, t in enumerate(got):
                    cut_leaf = any(len(ivs) != 1 or ivs[0] != (0, n)
                                   for ivs, n in zip(cut._cblocks[0][k],
                                                     cut.shapes[k]))
                    if cut_leaf and tuple(t.shape) == tuple(cut.shapes[k]):
                        whole_layer[0] = True
            if cut.stacked and not cut.paths[0].startswith("enc_layers."):
                gc.collect()
                live[0] += 1
                peak[0] = max(peak[0], live[0])
                weakref.finalize(got[0], lambda: live.__setitem__(
                    0, live[0] - 1))
            return got

        G.NodeSplit.gather = gathered
        losses = []
        try:
            for k, b in enumerate(batches):
                mesh.reset_counts()
                with _seq_gathers() as seqs:
                    (p, o, met), grads = _tp_capture(
                        lambda: step.split(p, o, b, shard=shard, mesh=mesh))
                if "frames" in b:
                    rows = b["frames"].shape[1] // shape[2]
                    out[f"{fam}/frame_gathers{k}"] = np.asarray(
                        seqs.count(rows))
                losses.append(float(met["loss"]))
                for kind, nbytes in mesh.counts.items():
                    out[f"{fam}/bytes{k}/{kind}"] = np.asarray(nbytes)
                if k == 0:
                    first = grads
        finally:
            G.NodeSplit.gather = orig
        out[f"{fam}/peak_blocks"] = np.asarray(peak[0])
        out[f"{fam}/whole_layer"] = np.asarray(whole_layer[0])
        out[f"{fam}/loss"] = np.asarray(losses)
        out[f"{fam}/params"] = _node_params(shard, mesh, p).numpy()
        # the first step's gradient against the unsharded step's
        whole = train.make_train_step(model, split_tc(
            True, lr=1e-4, warmup_steps=0, max_steps=10))
        _, want = _tp_capture(lambda: whole(flat.clone(), adamw_init(
            layout.parts(flat)), batches[0]))
        got = shard.gather(shard.local.join(first)[None], mesh.shard_view,
                           kind=None)[0]
        gv = layout.value_layout.unflatten(layout.values(got))
        wv = layout.value_layout.unflatten(layout.values(
            layout.join(want)))
        out[f"{fam}/grad_leaves"] = np.asarray(sorted(gv))
        out[f"{fam}/grad_rel"] = np.asarray(
            [float((gv[q] - wv[q]).abs().max()
                   / wv[q].abs().max().clamp(min=1e-30)) for q in sorted(gv)])
        # the split gate against the whole node's metric
        val = batches[-1]
        mesh.reset_counts()
        ev = train.make_swarm_eval(model)
        out[f"{fam}/gate"] = np.asarray([
            float(ev.split(p, val, shard=shard, mesh=mesh)),
            float(ev(_node_params(shard, mesh, p)[None],
                     {k: v[None] for k, v in val.items()})[0])])
        for kind, nbytes in mesh.counts.items():
            out[f"{fam}/gate_bytes/{kind}"] = np.asarray(nbytes)
    # the vlm family (the patches and the text gathered whole, then the
    # rank's cut) and a LoRA'd dense model (its adapters cut with their
    # layers): the first split step's gradient against the unsharded one
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import build_model
    for name, arch, rank in TP_MORE:
        model = build_model(smoke_variant(get_config(arch)), lora_rank=rank)
        layout = model.layout
        shard = ShardLayout(layout, param_specs(layout, mesh), mesh.inner,
                            mesh.coords)
        step = train.make_train_step(model, split_tc(True))
        p0 = model.init(torch.Generator().manual_seed(0), "cpu")
        b = {k[len(name) + 1:]: torch.from_numpy(v) for k, v in inp.items()
             if k.startswith(f"{name}/")}
        ps = shard.shard(p0[None])[0]
        _, first = _tp_capture(lambda: step.split(
            ps, adamw_init(shard.local.parts(ps)), b, shard=shard,
            mesh=mesh))
        _, want = _tp_capture(lambda: step(p0.clone(), adamw_init(
            layout.parts(p0)), b))
        got = shard.gather(shard.local.join(first)[None], mesh.shard_view,
                           kind=None)[0]
        gv = layout.value_layout.unflatten(layout.values(got))
        wv = layout.value_layout.unflatten(layout.values(
            layout.join(want)))
        out[f"{name}/grad_rel"] = np.asarray(
            [float((gv[q] - wv[q]).abs().max()
                   / wv[q].abs().max().clamp(min=1e-30)) for q in sorted(gv)])
    out.update(_tp_encdec_seq(inp, mesh, shape))
    out.update(_tp_uneven(inp, mesh))
    return out


#: the split steps whose sequence, padded vocab or SSM groups the model
#: group does not divide: (name, arch, config changes, tokens a row,
#: frames a row or None). Odd sequences (the whole residual) on the
#: head-parallel dense model with its vocab-cut tied table, the hybrid
#: (sequence-parallel attention, its SSM heads cut), the moe with its
#: experts cut; an odd unpadded vocab (the logits and the loss whole) with
#: the tied table whole, and with the whole residual and the experts
#: whole; 6 SSM heads in 3 groups (a rank's 3 heads read 2 groups
#: unevenly: the mixer whole); the enc-dec head-parallel with odd frames
#: and tokens
TP_UNEVEN = (("seq_dense", "minicpm-2b", {}, 15, None),
             ("seq_hybrid", "hymba-1.5b", {}, 15, None),
             ("seq_moe", "granite-moe-3b-a800m", {}, 15, None),
             ("vocab", "minicpm-2b", {"vocab_size": 501, "vocab_pad_to": 0},
              16, None),
             ("vocab_seq", "granite-moe-3b-a800m", {
                 "vocab_size": 501, "vocab_pad_to": 0, "n_experts": 3}, 15,
              None),
             ("groups", "mamba2-370m", {"d_model": 192, "ssm_groups": 3},
              16, None),
             ("encdec_odd", "seamless-m4t-medium", {}, 15, 15))


def _split_against_whole(model, step, shard, mesh, p0, b, key, out):
    """One split step of ``b`` from the node ``p0`` against the whole
    node's step on the same batch: into ``out`` under ``key``, the split
    step's bytes by kind, the losses [split, whole], the node's params
    after each, every leaf's gradient difference over its largest
    magnitude, and the split gate's metric against the whole node's on
    the same rows. Returns the rank's shard after the step."""
    from repro_torch.launch import train
    from repro_torch.optim import adamw_init
    layout = model.layout
    ps = shard.shard(p0[None])[0]
    mesh.reset_counts()
    (ps, _, ms), first = _tp_capture(lambda: step.split(
        ps, adamw_init(shard.local.parts(ps)), b, shard=shard, mesh=mesh))
    for kind, nbytes in mesh.counts.items():
        out[f"{key}/bytes/{kind}"] = np.asarray(nbytes)
    (pw, _, mw), want = _tp_capture(lambda: step(
        p0.clone(), adamw_init(layout.parts(p0)), b))
    got = shard.gather(shard.local.join(first)[None], mesh.shard_view,
                       kind=None)[0]
    gv = layout.value_layout.unflatten(layout.values(got))
    wv = layout.value_layout.unflatten(layout.values(layout.join(want)))
    out[f"{key}/grad_rel"] = np.asarray(
        [float((gv[q] - wv[q]).abs().max()
               / wv[q].abs().max().clamp(min=1e-30)) for q in sorted(gv)])
    out[f"{key}/loss"] = np.asarray([float(ms["loss"]), float(mw["loss"])])
    node = _node_params(shard, mesh, ps)
    out[f"{key}/params"] = node.numpy()
    out[f"{key}/whole"] = pw.numpy()
    mesh.reset_counts()
    ev = train.make_swarm_eval(model)
    out[f"{key}/gate"] = np.asarray([
        float(ev.split(ps, b, shard=shard, mesh=mesh)),
        float(ev(node[None], {k: v[None] for k, v in b.items()})[0])])
    for kind, nbytes in mesh.counts.items():
        out[f"{key}/gate_bytes/{kind}"] = np.asarray(nbytes)
    return ps


def _tp_uneven(inp, mesh):
    """Each TP_UNEVEN case: one split step from the JAX package's params
    (remat on) against the whole node's step (`_split_against_whole`),
    under ``uneven/<name>/``."""
    import torch
    from repro_torch.core.flat import ShardLayout
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.sharding.rules import param_specs
    out = {}
    for name, arch, changes, _, frames in TP_UNEVEN:
        model = build_model(tp_block_cfg(arch, changes))
        layout = model.layout
        shard = ShardLayout(layout, param_specs(layout, mesh), mesh.inner,
                            mesh.coords)
        step = train.make_train_step(model, split_tc(
            True, lr=1e-4, warmup_steps=0, max_steps=10))
        keys = ("tokens", "labels") + (("frames",) if frames else ())
        b = {k: torch.from_numpy(inp[f"uneven/{name}/{k}"]) for k in keys}
        _split_against_whole(model, step, shard, mesh, torch.from_numpy(
            inp[f"uneven/{name}/flat"]), b, f"uneven/{name}", out)
    return out


def tp_uneven_batch(name, rng):
    """A TP_UNEVEN case's batch: TP_JAX_BATCH rows of its tokens (and
    frames)."""
    _, arch, changes, seq, frames = next(c for c in TP_UNEVEN
                                         if c[0] == name)
    cfg = tp_block_cfg(arch, changes)
    toks = rng.integers(0, cfg.vocab_size, (TP_JAX_BATCH, seq + 1))
    out = {"tokens": toks[:, :-1].astype(np.int64),
           "labels": toks[:, 1:].astype(np.int64)}
    if frames:
        out["frames"] = rng.normal(0, 1, (TP_JAX_BATCH, frames,
                                          cfg.frontend_dim)).astype(np.float32)
    return out


class _seq_gathers:
    """Within the block, the sequence length of every cut the model
    group's forward gathers (`repro_torch.sharding.tensor.gather`, remat's
    recompute included), in order: ``with _seq_gathers() as seqs``."""

    def __enter__(self):
        from repro_torch.sharding import tensor
        self.orig, self.seqs = tensor.gather, []

        def gather(x, dim=1):
            self.seqs.append(int(x.shape[dim]))
            return self.orig(x, dim)

        tensor.gather = gather
        return self.seqs

    def __exit__(self, *exc):
        from repro_torch.sharding import tensor
        tensor.gather = self.orig


def _tp_encdec_seq(inp, mesh, shape):
    """The enc-dec smoke model in its sequence-parallel form (TP_ENCDEC_SEQ:
    one KV head, a padded vocab): one split step against the whole
    node's (losses, params, the gradient leaf by leaf), its bytes by kind
    and its gathers of frame rows, the split gate's metric and bytes
    against the whole node's; and a step in each of TP_ENCDEC_PAIRS'
    forms (`_split_against_whole`)."""
    import torch
    from repro_torch.core.flat import ShardLayout
    from repro_torch.launch import train
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.rules import param_specs
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import build_model
    arch, changes = TP_ENCDEC_SEQ
    model = build_model(smoke_variant(get_config(arch)).replace(**changes))
    layout = model.layout
    shard = ShardLayout(layout, param_specs(layout, mesh), mesh.inner,
                        mesh.coords)
    step = train.make_train_step(model, split_tc(
        True, lr=1e-4, warmup_steps=0, max_steps=10))
    p0 = model.init(torch.Generator().manual_seed(0), "cpu")
    b = {k: torch.from_numpy(inp[f"encdec_seq/{k}"])
         for k in ("tokens", "labels", "frames")}
    out = {"encdec_seq/tensor_plan": np.asarray(
        train.tensor_plan(model, mesh) is not None)}
    ps = shard.shard(p0[None])[0]
    mesh.reset_counts()
    with _seq_gathers() as seqs:
        (ps, _, ms), first = _tp_capture(lambda: step.split(
            ps, adamw_init(shard.local.parts(ps)), b, shard=shard,
            mesh=mesh))
    for kind, nbytes in mesh.counts.items():
        out[f"encdec_seq/bytes/{kind}"] = np.asarray(nbytes)
    out["encdec_seq/frame_gathers"] = np.asarray(
        seqs.count(b["frames"].shape[1] // shape[2]))
    (pw, _, mw), want = _tp_capture(lambda: step(
        p0.clone(), adamw_init(layout.parts(p0)), b))
    got = shard.gather(shard.local.join(first)[None], mesh.shard_view,
                       kind=None)[0]
    gv = layout.value_layout.unflatten(layout.values(got))
    wv = layout.value_layout.unflatten(layout.values(layout.join(want)))
    out["encdec_seq/grad_rel"] = np.asarray(
        [float((gv[q] - wv[q]).abs().max()
               / wv[q].abs().max().clamp(min=1e-30)) for q in sorted(gv)])
    out["encdec_seq/loss"] = np.asarray([float(ms["loss"]),
                                         float(mw["loss"])])
    node = _node_params(shard, mesh, ps)
    out["encdec_seq/params"] = node.numpy()
    out["encdec_seq/whole"] = pw.numpy()
    mesh.reset_counts()
    ev = train.make_swarm_eval(model)
    out["encdec_seq/gate"] = np.asarray([
        float(ev.split(ps, b, shard=shard, mesh=mesh)),
        float(ev(node[None], {k: v[None] for k, v in b.items()})[0])])
    for kind, nbytes in mesh.counts.items():
        out[f"encdec_seq/gate_bytes/{kind}"] = np.asarray(nbytes)
    # frames, tokens or both that the model group does not divide: each
    # stack in the whole-residual form on its own
    for what in TP_ENCDEC_PAIRS:
        bad = dict(b)
        if what in ("frames", "both"):
            bad["frames"] = b["frames"][:, 1:]
        if what in ("tokens", "both"):
            bad["tokens"], bad["labels"] = (b["tokens"][:, 1:],
                                            b["labels"][:, 1:])
        _split_against_whole(model, step, shard, mesh, p0, bad,
                             f"encdec_seq/{what}", out)
    return out


#: the enc-dec's pairs of forms past the cut encoder and decoder: odd
#: frames (the encoder whole), odd tokens (the decoder whole), both
TP_ENCDEC_PAIRS = ("frames", "tokens", "both")


#: the enc-dec's sequence-parallel form: (arch, config changes), and its
#: frames a row (its tokens 16: a cut of each tells the two apart)
TP_ENCDEC_SEQ = ("seamless-m4t-medium", {"n_kv_heads": 1, "vocab_size": 500})
TP_ENCDEC_FRAMES = 24

#: the other tensor-parallel steps: (name, arch, LoRA rank)
TP_MORE = (("vlm", "internvl2-1b", 0), ("lora", "minicpm-2b", 4))


def tp_encdec_batch(rng):
    """The batches of the enc-dec's sequence-parallel step and the TP_MORE
    steps: 4 rows of 16 tokens (the enc-dec's frames, the vlm's patch
    embeddings)."""
    from repro_torch.configs import get_config, smoke_variant
    out = {}
    for name, arch, changes in (("encdec_seq",) + TP_ENCDEC_SEQ,) + tuple(
            (n, a, {}) for n, a, _ in TP_MORE):
        cfg = smoke_variant(get_config(arch)).replace(**changes)
        toks = rng.integers(0, cfg.vocab_size, (4, 17))
        out[f"{name}/tokens"] = toks[:, :-1].astype(np.int64)
        out[f"{name}/labels"] = toks[:, 1:].astype(np.int64)
        if cfg.is_encdec:
            out[f"{name}/frames"] = rng.normal(0, 1, (
                4, TP_ENCDEC_FRAMES, cfg.frontend_dim)).astype(np.float32)
        if cfg.family == "vlm":
            out[f"{name}/patch_embeds"] = rng.normal(0, 1, (
                4, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    # the gate world's session: [T, N, B, S] a round, [N, B, S] to validate
    cfg = smoke_variant(get_config("seamless-m4t-medium"))
    n, b, s = SPLIT_NODES, 2, 16
    for pre, lead in (("", (SPLIT_STEPS, n, b)), ("v", (n, b))):
        toks = rng.integers(0, cfg.vocab_size, lead + (s + 1,))
        out[f"encgate/{pre}tokens"] = toks[..., :-1].astype(np.int64)
        out[f"encgate/{pre}labels"] = toks[..., 1:].astype(np.int64)
        out[f"encgate/{pre}frames"] = rng.normal(0, 1, lead + (
            cfg.enc_seq_len, cfg.frontend_dim)).astype(np.float32)
    return out


#: the enc-dec gate world: (node, data, model), and its relative gate's
#: threshold, between the two nodes' merged / local metrics (1.0044 and
#: 1.0018): one gate opens, the other stays shut
TP_GATE = (2, 1, 2)
TP_GATE_THRESHOLD = 1.003


def port_tp_encdec_gate(inp):
    """(node, data, model) = TP_GATE: one round of the enc-dec smoke
    session (its TrainStep split and tensor-parallel, a relative gate at
    TP_GATE_THRESHOLD) with the split gate, then with the
    whole-node gate (an opaque eval): each run's metrics, gates and sync
    bytes."""
    import dataclasses
    import torch
    from repro_torch.core.session import SwarmSession
    from repro_torch.launch import train
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.rules import param_specs
    mesh = _split_mesh(TP_GATE)
    model = _smoke("seamless-m4t-medium")
    layout = model.layout
    keys = ("tokens", "labels", "frames")
    batch = {k: torch.from_numpy(inp[f"encgate/{k}"]) for k in keys}
    val = {k: torch.from_numpy(inp[f"encgate/v{k}"]) for k in keys}
    cfg = dataclasses.replace(split_cfg(), val_threshold=TP_GATE_THRESHOLD)
    out = {"coords": np.asarray([mesh.coords["data"], mesh.coords["model"]])}
    for tag in ("split", "whole"):
        step = train.make_train_step(model, split_tc(True))
        ev = train.make_swarm_eval(model)
        p0 = model.init(torch.Generator().manual_seed(0), "cpu")
        sess = SwarmSession(
            cfg, step, ev if tag == "split" else (lambda p, v: ev(p, v)),
            params=p0, opt_state=adamw_init(layout.parts(p0)),
            data_sizes=INNER_SIZES, layout=layout, device="cpu",
            backend="gossip", mesh=mesh, axis=mesh.axis,
            param_specs=param_specs(layout, mesh))
        log = sess.round(batch, val)
        out[f"encgate/{tag}/split_gate"] = np.asarray(
            sess.engine.split_gate)
        out[f"encgate/{tag}/metrics"] = torch.stack(
            [log["metric_local"], log["metric_merged"]]).numpy()
        out[f"encgate/{tag}/gates"] = log["gates"].numpy()
        for kind, nbytes in sess.counted_sync_bytes.items():
            if not isinstance(nbytes, dict):
                out[f"encgate/{tag}/bytes/{kind}"] = np.asarray(nbytes)
    return out


# --- serving under tensor parallelism ----------------------------------------

#: (case, arch, config changes, model size M): a head-parallel dense model
#: (the KV heads on the ranks), a dense model whose one KV head does not
#: divide M (the cache on the head dim), the moe with its experts cut and
#: whole, the ssm with its heads cut, the hybrid, and the hybrid at M = 4
#: with 2 SSM heads (whole: the state whole on every rank) and 16 of
#: the head dim's 64 a rank; a dense model with an odd unpadded vocab
#: (the logits whole), the ssm with 6 heads in 3 groups (a rank's 3 heads
#: read 2 groups unevenly: the heads whole), and the enc-dec head-parallel
#: (the self cache on the KV heads) and with one KV head and 15 frames
#: (the self cache on the head dim, the encoder whole)
TP_SERVE = (("dense_heads", "minicpm-2b", {}, 2),
            ("dense_head_dim", "nemotron-4-15b", {}, 2),
            ("moe_cut", "granite-moe-3b-a800m", {}, 2),
            ("moe_whole", "granite-moe-3b-a800m", {"n_experts": 3}, 2),
            ("ssm", "mamba2-370m", {}, 2),
            ("hybrid", "hymba-1.5b", {}, 2),
            ("hybrid_m4", "hymba-1.5b", {"ssm_head_dim": 256}, 4),
            ("vocab_whole", "minicpm-2b", {"vocab_size": 501,
                                           "vocab_pad_to": 0}, 2),
            ("ssm_groups", "mamba2-370m", {"d_model": 192,
                                           "ssm_groups": 3}, 2),
            ("encdec", "seamless-m4t-medium", {}, 2),
            ("encdec_head_dim", "seamless-m4t-medium", {
                "n_kv_heads": 1, "enc_seq_len": 15}, 2))
TP_SERVE_WORLDS = {"tp_serve_m2": 2, "tp_serve_m4": 4}
TP_SERVE_B, TP_SERVE_NEW, TP_SERVE_LEN = 2, 6, 16


def tp_serve_prompts(m):
    """The prompt lengths a case serves: one M divides, one it does not."""
    return (8, 7) if m == 2 else (8, 6)


def tp_serve_cfg(arch, changes):
    from repro_torch.configs import get_config, smoke_variant
    return smoke_variant(get_config(arch)).replace(**changes)


def tp_serve_bytes(*args, **kw):
    """A served forward's bytes by kind over a model group, counted from
    the config: ``chip_smoke._tp_serve_bytes``, the count the card run
    holds (j) and (k) to."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._tp_serve_bytes(*args, **kw)


def tp_serve_encoded(model, st, enc, dec, frames, prompt, new):
    """An enc-dec served with its frames: the caches zeroed, ``frames``
    encoded into ``enc_out`` by the encode program ``enc``, the prompt fed
    token by token through the decode program ``dec``, then ``new - 1``
    more steps: (the greedy tokens [B, new], the logits of every step
    [B, S + new - 1, V])."""
    import torch
    from repro_torch.launch.serve import tree_leaves
    for t in tree_leaves(st.caches):
        t.zero_()
    st.frames.copy_(frames)
    enc.run()
    seen = []
    for i in range(prompt.shape[1]):
        st.tok.copy_(prompt[:, i:i + 1])
        st.pos.fill_(i)
        dec.run()
        seen.append(st.logits.clone())
    out = [st.tok.clone()]
    for _ in range(new - 1):
        dec.run()
        out.append(st.tok.clone())
        seen.append(st.logits.clone())
    return torch.cat(out, 1), torch.stack(seen, 1)


def _tp_serve_grad(model, st, mesh, inp, case, odd, out):
    """A forward that records a gradient over the model group on a
    prompt it does not divide (an enc-dec's frames and tokens both), and
    its cross entropy against the prompt shifted by one: the loss, the
    bytes by kind, and the rank's gradient of each of its compute blocks;
    the unsharded forward's loss and gradient beside them."""
    import json
    import torch
    from repro_torch.models import nest
    from repro_torch.models.encdec import forward_encdec
    from repro_torch.models.layers import softmax_xent
    from repro_torch.models.transformer import forward_lm
    from repro_torch.sharding import tensor
    cfg = model.cfg
    toks = torch.from_numpy(inp[f"serve/{case}/prompt{odd}"])
    labels = torch.roll(toks, -1, 1)
    if cfg.is_encdec:
        frames = torch.from_numpy(inp[f"serve/{case}/frames"])[:, :odd]
        fwd = lambda tree: forward_encdec(tree, cfg, frames, toks)[0]
    else:
        fwd = lambda tree: forward_lm(tree, cfg, toks)[0]
    flat = torch.from_numpy(inp[f"serve/{case}/flat"])
    whole = {p: t.clone().requires_grad_()
             for p, t in model.layout.unflatten(flat).items()}
    loss = softmax_xent(fwd(nest(whole)), labels)
    grads = torch.autograd.grad(loss, list(whole.values()))
    out[f"serve/{case}/grad/whole_loss"] = np.asarray(float(loss))
    for p, g in zip(whole, grads):
        out[f"serve/{case}/grad/whole/{p}"] = g.numpy()
    mine = {p: t.clone().requires_grad_() for p, t in st.views.items()}
    mesh.reset_counts()
    forms, enter = [], tensor.enter

    def recorded(x, dim=1):     # each block's entry: the form it ran in
        forms.append(tensor.current().whole)
        return enter(x, dim)

    tensor.enter = recorded
    try:
        with torch.enable_grad(), tensor.model_group(st.plan):
            loss = softmax_xent(fwd(nest(mine)), labels)
            grads = torch.autograd.grad(loss, list(mine.values()))
    finally:
        tensor.enter = enter
    out[f"serve/{case}/grad/forms"] = np.asarray(forms)
    out[f"serve/{case}/grad/bytes"] = np.asarray(json.dumps(mesh.counts))
    out[f"serve/{case}/grad/loss"] = np.asarray(float(loss))
    for p, g in zip(mine, grads):
        out[f"serve/{case}/grad/rank/{p}"] = g.numpy()


def port_tp_serve(inp, m):
    """Each TP_SERVE case of model size ``m`` on a (1, 1, m) mesh: for
    each prompt, ``generate`` over the model group (tokens and logits),
    a prefill (an enc-dec's encode) and a decode step alone with their
    bytes by kind, the step programs' pools and eager passes, and the
    unsharded ``generate`` in this process; an enc-dec's frames encoded
    over the group and its prompt fed after them (`tp_serve_encoded`);
    the rank's cache shapes and its params' leaf shapes; a forward that
    records a gradient on a sequence the group does not divide
    (`_tp_serve_grad`)."""
    import json
    import torch
    from repro_torch.launch.mesh import make_swarm_mesh
    from repro_torch.launch.serve import (encode_step_for, generate,
                                          prefill_step_for, serve_step_for,
                                          step_buffers)
    from repro_torch.models import build_model
    mesh, _ = make_swarm_mesh(1, model=m)
    cpu = torch.device("cpu")
    b, new, t = TP_SERVE_B, TP_SERVE_NEW, TP_SERVE_LEN
    out = {"model_rank": np.asarray(mesh.model_view.rank)}
    for case, arch, changes, mm in TP_SERVE:
        if mm != m:
            continue
        model = build_model(tp_serve_cfg(arch, changes))
        encdec = model.cfg.is_encdec
        flat = torch.from_numpy(inp[f"serve/{case}/flat"])
        for s in tp_serve_prompts(m):
            prompt = torch.from_numpy(inp[f"serve/{case}/prompt{s}"])
            key = f"serve/{case}/{s}"
            toks, logits = generate(model, flat, prompt, new, t, cpu,
                                    mesh=mesh, with_logits=True)
            out[f"{key}/tokens"], out[f"{key}/logits"] = (toks.numpy(),
                                                          logits.numpy())
            st = step_buffers(model, b, t, cpu, mesh)
            pre = (encode_step_for(model, b, t, cpu, mesh) if encdec
                   else prefill_step_for(model, b, s, t, cpu, mesh))
            dec = serve_step_for(model, b, t, cpu, mesh)
            out[f"{key}/eager_calls"] = np.asarray([pre.eager_calls,
                                                    dec.eager_calls])
            for name, prog in (("prefill", pre), ("token", dec)):
                mesh.reset_counts()
                prog.run()
                out[f"{key}/bytes_{name}"] = np.asarray(json.dumps(
                    mesh.counts))
            toks, logits = generate(model, flat, prompt, new, t, cpu,
                                    with_logits=True)
            out[f"{key}/single_tokens"] = toks.numpy()
            out[f"{key}/single_logits"] = logits.numpy()
            single = step_buffers(model, b, t, cpu)
            out[f"{key}/pools"] = np.asarray(
                [st.graphs.eager, single.graphs.eager,
                 serve_step_for(model, b, t, cpu).captured, dec.captured])
        for s in tp_serve_prompts(m) if encdec else ():
            frames = torch.from_numpy(inp[f"serve/{case}/frames"])
            prompt = torch.from_numpy(inp[f"serve/{case}/prompt{s}"])
            for tag, on in (("encoded", (mesh,)), ("single_encoded", ())):
                sb = step_buffers(model, b, t, cpu, *on)
                if not on:
                    sb.load(flat)
                toks, logits = tp_serve_encoded(
                    model, sb, encode_step_for(model, b, t, cpu, *on),
                    serve_step_for(model, b, t, cpu, *on), frames, prompt,
                    new)
                out[f"serve/{case}/{s}/{tag}_tokens"] = toks.numpy()
                out[f"serve/{case}/{s}/{tag}_logits"] = logits.numpy()
        caches = st.caches["self"] if encdec else st.caches
        out[f"serve/{case}/cache"] = np.asarray(json.dumps(
            [{k: list(v.shape) for k, v in c.items()} for c in caches]))
        if encdec:
            out[f"serve/{case}/enc_out"] = np.asarray(
                list(st.caches["enc_out"].shape))
        out[f"serve/{case}/leaves"] = np.asarray(json.dumps(
            {p: list(v.shape) for p, v in st.views.items()}))
        out[f"serve/{case}/params"] = np.asarray(st.params.numel())
        _tp_serve_grad(model, st, mesh, inp, case, tp_serve_prompts(m)[1],
                       out)
    return out


# --- the decode cache cut on its sequence (long-context placement) ---------

#: (case, arch, config changes): a dense model with a window (its heads
#: cut over model) and the hybrid (its one KV head: the head-dim cut)
SEQ_CACHE = (("dense_window", "minicpm-2b", {"sliding_window": 4}),
             ("hybrid", "hymba-1.5b", {}))
#: one row (the data group of 2 does not divide it), a cache of 16 cut
#: into 2 × 8 positions, a prompt of 6 and 8 new tokens (positions 6-12
#: cross from data rank 0's slice into rank 1's)
SEQ_CACHE_WORLD, SEQ_CACHE_B, SEQ_CACHE_S = 4, 1, 6
SEQ_CACHE_NEW, SEQ_CACHE_LEN = 8, 16


def port_seq_cache(inp):
    """Each SEQ_CACHE case served on a (1, 2, 2) mesh, whose data group
    cuts the decode cache's sequence (the batch of 1 does not divide over
    it), and on a (2, 1, 2) mesh of the same world, whose caches are whole:
    ``generate``'s tokens and logits on both, the rank's cache shapes and
    a decode step's bytes by kind under the cut."""
    import json
    import torch
    from repro_torch.launch.mesh import make_swarm_mesh
    from repro_torch.launch.serve import (generate, serve_step_for,
                                          step_buffers)
    from repro_torch.models import build_model
    cut, _ = make_swarm_mesh(1, data=2, model=2)
    whole, _ = make_swarm_mesh(2, model=2)
    cpu = torch.device("cpu")
    b, t = SEQ_CACHE_B, SEQ_CACHE_LEN
    out = {"coords": np.asarray([cut.coords["data"], cut.coords["model"]])}
    for case, arch, changes in SEQ_CACHE:
        model = build_model(tp_serve_cfg(arch, changes))
        flat = torch.from_numpy(inp[f"seq/{case}/flat"])
        prompt = torch.from_numpy(inp[f"seq/{case}/prompt"])
        for tag, mesh in (("cut", cut), ("whole", whole)):
            toks, logits = generate(model, flat, prompt, SEQ_CACHE_NEW, t,
                                    cpu, mesh=mesh, with_logits=True)
            out[f"seq/{case}/{tag}/tokens"] = toks.numpy()
            out[f"seq/{case}/{tag}/logits"] = logits.numpy()
        st = step_buffers(model, b, t, cpu, cut)
        out[f"seq/{case}/seq"] = np.asarray(st.seq)
        out[f"seq/{case}/cache"] = np.asarray(json.dumps(
            {k: list(v.shape) for k, v in st.caches[0].items()}))
        cut.reset_counts()
        st.pos.fill_(t - 1)
        serve_step_for(model, b, t, cpu, cut).run()
        out[f"seq/{case}/bytes"] = np.asarray(json.dumps(cut.counts))
    return out


# --- the dry run's dp and zero3 profiles (tests/test_torch_profiles.py) ----

#: the training families (one with SSM heads, one MoE) and the served ones
PROFILE_TRAIN = (("hybrid", "hymba-1.5b"), ("moe", "granite-moe-3b-a800m"))
PROFILE_SERVE = ("hymba-1.5b", "granite-moe-3b-a800m", "minicpm-2b")
PROFILE_SHAPE = (1, 2, 2)
PROFILE_STEPS, PROFILE_BATCH, PROFILE_SEQ = 2, 4, 32
#: served: rows (4 split over the profile's axes; 1: the cache's sequence
#: cut), prompt length, new tokens (the prefill's and 4 decode steps'),
#: cache depth
PROFILE_SERVE_ROWS, PROFILE_PROMPT, PROFILE_NEW, PROFILE_LEN = (4, 1), 7, 5, 16


def profile_mesh(profile):
    """One node as (data, model) = (2, 2) under ``profile``."""
    from repro_torch.launch.mesh import use_profile
    return use_profile(_split_mesh(PROFILE_SHAPE), profile)


def port_profiles(inp):
    """Under ``dp`` and ``zero3`` on one node as (data, model) = (2, 2):
    PROFILE_STEPS split steps of each PROFILE_TRAIN family from the JAX
    package's params (converted) and the whole node's opaque step on the
    same batches in this process (the node's params gathered, losses,
    bytes by kind); two rows (the fallback: the input's cut) against the
    whole node's step; ``generate`` of each PROFILE_SERVE smoke model
    from the stored shard against the unsharded ``generate`` in this
    process (tokens and logits, the rank's rows, its cache shapes and a
    decode step's bytes by kind)."""
    import json
    import torch
    from repro_torch.launch import specs, train
    from repro_torch.launch.serve import generate, serve_step_for, step_buffers
    from repro_torch.optim import adamw_init
    cpu = torch.device("cpu")
    out = {}
    for prof in ("dp", "zero3"):
        mesh = profile_mesh(prof)
        out[f"{prof}/coords"] = np.asarray([mesh.coords["data"],
                                            mesh.coords["model"]])
        for fam, arch in PROFILE_TRAIN:
            model = _smoke(arch)
            shard = specs.shard_layout(model, mesh.inner, mesh.coords, prof)
            tc = split_tc(True, lr=1e-4, warmup_steps=0, max_steps=10)
            step = train.make_train_step(model, tc)
            flat = torch.from_numpy(inp[f"jax/{fam}/flat"])
            p = shard.shard(flat[None])[0]
            o = adamw_init(shard.local.parts(p))
            pw, ow = flat.clone(), adamw_init(model.layout.parts(flat))
            losses = []
            for k in range(PROFILE_STEPS):
                b = {key: torch.from_numpy(inp[f"jax/{fam}/{key}"][k])
                     for key in ("tokens", "labels")}
                mesh.reset_counts()
                p, o, m = step.split(p, o, b, shard=shard, mesh=mesh)
                counts = dict(mesh.counts)
                pw, ow, mw = step(pw, ow, b)
                losses.append([float(m["loss"]), float(mw["loss"])])
            key = f"{prof}/{fam}"
            out[f"{key}/loss"] = np.asarray(losses)
            out[f"{key}/bytes"] = np.asarray(json.dumps(counts))
            out[f"{key}/params"] = np.stack([shard.gather(
                p[None], mesh.store_view, kind=None)[0].numpy(), pw.numpy()])
            # two rows: the profile's input cut (dp: model, zero3: data)
            b = {key: torch.from_numpy(inp[f"jax/{fam}/{key}"][0][:2])
                 for key in ("tokens", "labels")}
            p = shard.shard(flat[None])[0]
            o = adamw_init(shard.local.parts(p))
            pw, ow = flat.clone(), adamw_init(model.layout.parts(flat))
            p, o, m = step.split(p, o, b, shard=shard, mesh=mesh)
            pw, ow, mw = step(pw, ow, b)
            out[f"{key}/two/params"] = np.stack([shard.gather(
                p[None], mesh.store_view, kind=None)[0].numpy(), pw.numpy()])
            out[f"{key}/two/loss"] = np.asarray([float(m["loss"]),
                                                 float(mw["loss"])])
        t, new = PROFILE_LEN, PROFILE_NEW
        for arch in PROFILE_SERVE:
            model = _smoke(arch)
            flat = torch.from_numpy(inp[f"serve/{arch}/flat"])
            for rows in PROFILE_SERVE_ROWS:
                prompt = torch.from_numpy(inp[f"serve/{arch}/prompt"])[:rows]
                key = f"{prof}/serve/{arch}/{rows}"
                toks, logits = generate(model, flat, prompt, new, t, cpu,
                                        mesh=mesh, with_logits=True)
                st = step_buffers(model, rows, t, cpu, mesh)
                r = st.rows or slice(0, rows)
                out[f"{key}/rows"] = np.asarray([r.start, r.stop, st.seq])
                out[f"{key}/tokens"], out[f"{key}/logits"] = (
                    toks.numpy(), logits.numpy())
                out[f"{key}/cache"] = np.asarray(json.dumps(
                    {k: list(v.shape) for k, v in st.caches[0].items()}))
                out[f"{key}/params_size"] = np.asarray(st.params.numel())
                mesh.reset_counts()
                serve_step_for(model, rows, t, cpu, mesh).run()
                out[f"{key}/bytes"] = np.asarray(json.dumps(mesh.counts))
                toks, logits = generate(model, flat, prompt, new, t, cpu,
                                        with_logits=True)
                out[f"{key}/single_tokens"] = toks[r].numpy()
                out[f"{key}/single_logits"] = logits[r].numpy()
    return out


def main(argv):
    task, rank, world, init, out_dir = argv[:5]
    rank, world = int(rank), int(world)
    os.environ["SPLIT_DIR"] = out_dir
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    if task in ("reference", "hier_reference", "inner_reference"):
        import jax
        if task == "hier_reference":
            res = reference_hier(inp, world)
        elif task == "inner_reference":
            res = reference_inner(inp)
        else:
            mesh = jax.make_mesh((world,), ("node",),
                                 devices=jax.devices()[:world])
            res = reference_schedules(mesh, inp)
    else:
        import torch.distributed as dist
        from repro_torch.launch.mesh import (make_swarm_mesh,
                                             make_two_level_swarm_mesh)
        _init_world(rank, world, init)
        try:
            if task == "inner":
                res = port_inner(inp)
            elif task in ("inner_sessions", "inner_twin"):
                res = port_inner_sessions(inp, out_dir,
                                          task == "inner_sessions")
            elif task == "split_units":
                res = port_split_units(inp)
            elif task == "split_d1":
                res = port_split_d1(inp)
            elif task == "split_gate":
                res = port_split_gate(inp)
            elif task == "tp_units":
                res = port_tp_units(inp)
            elif task in TP_WORLDS:
                res = port_tp_steps(inp, TP_WORLDS[task])
            elif task == "tp_encdec_gate":
                res = port_tp_encdec_gate(inp)
            elif task in TP_SERVE_WORLDS:
                res = port_tp_serve(inp, TP_SERVE_WORLDS[task])
            elif task == "seq_cache":
                res = port_seq_cache(inp)
            elif task == "profiles":
                res = port_profiles(inp)
            elif task in SPLIT_WORLDS:
                res = port_split_sessions(inp, SPLIT_WORLDS[task])
            elif task == "hier":
                mesh, _ = make_two_level_swarm_mesh(world // 2, 2)
                res = port_hier_schedules(mesh, inp, world // 2)
                if world == N:
                    res.update(port_hier_sessions(mesh, inp))
            elif task == "faults":
                meshes = {False: make_swarm_mesh(N)[0],
                          True: make_two_level_swarm_mesh(2, 2)[0]}
                res = port_checkpoints(meshes, inp, out_dir)
                res.update(port_fault_plane(meshes, inp, out_dir))
            else:
                mesh, _ = make_swarm_mesh(N)
                if task == "schedules":
                    res = port_schedules(mesh, inp)
                    try:
                        make_swarm_mesh(N + 2)
                    except ValueError as e:
                        res["mesh/indivisible"] = np.asarray(str(e))
                else:
                    res = port_sessions(mesh, inp)
        finally:
            dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"{task}_rank{rank}.npz"), **res)


if __name__ == "__main__":
    main(sys.argv[1:])
