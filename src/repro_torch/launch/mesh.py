"""The swarm's process group: port of ``repro.launch.mesh``.

The reference runs one program over a device mesh and shards the stacked
node axis over a mesh axis. The port runs one process per rank
(``torch.distributed``, multi-controller): rank ``r`` of a world of ``W``
ranks holds the rows of nodes ``[r·per, (r+1)·per)`` of the ``[N, P]``
state, ``per = N / W``, and the gossip schedules (`repro_torch.core.
gossip`) move them with explicit collectives.

The caller starts the process group, and chooses its backend: ``"nccl"``
when each rank owns a card, ``"gloo"`` otherwise (two ranks on one card, or
the CPU). NCCL refuses two ranks on one device, so a world of more than
one rank on a one-card machine is gloo. Nothing here switches backend.

    dist.init_process_group("gloo", init_method="tcp://localhost:29500",
                            rank=rank, world_size=4)
    mesh, axis = make_swarm_mesh(4)          # one node a rank
    session = SwarmSession(cfg, step, eval_fn, params=flat, layout=layout,
                           backend="gossip", mesh=mesh, axis=axis)

A two-level mesh (:func:`make_two_level_swarm_mesh`) groups the ranks into
pods: rank ``p·per_pod + j`` is node ``j`` of pod ``p``. Its swarm axis is
the tuple ``("pod", "node")``; the flat schedules run over the joint world
unchanged, and the hierarchical ones (`repro_torch.core.gossip.
hier_fedavg_ring_q8` / ``hier_fisher_ring_q8``) move their intra-pod legs
over the rank's **node group** (:attr:`SwarmMesh.node_view`) and their
cross-pod leg over its **pod group** (:attr:`SwarmMesh.pod_view`). The
cost model (``cfg.intra_pod_cost`` / ``cfg.cross_pod_cost``) picks
between them.

A swarm mesh with inner axes (``make_swarm_mesh(n, data=D, model=M)``,
the reference's ``("node", "data", "model")`` mesh) shards each node over
``D·M`` ranks: rank ``(i·D + d)·M + m`` holds block ``(d, m)`` of node
axis position ``i`` (row-major). The schedules run on the rank's **node
group** (the ranks that hold the same block of every node; the mesh's
``group``, link class ``intra``), and a node's ranks gather its state over
their **shard group** (:attr:`SwarmMesh.shard_view`). Which values a block
holds is decided by the param specs (`repro_torch.sharding.rules.
param_specs`, `repro_torch.core.flat.ShardLayout`). A split step splits the
node's batch rows over its **data group** (:attr:`SwarmMesh.data_view`,
the ranks of one position and model index) and each layer's work over its
**model group** (:attr:`SwarmMesh.model_view`, the ranks of one position
and data index: tensor parallelism, `repro_torch.sharding.tensor`):

    mesh, axis = make_swarm_mesh(2, model=2)   # 4 ranks: 2 nodes × 2
    specs = param_specs(layout, mesh)
    session = SwarmSession(cfg, step, eval_fn, params=flat, layout=layout,
                           backend="gossip", mesh=mesh, axis=axis,
                           param_specs=specs)
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional

# The reference's axis registry (`repro.launch.mesh.MESH_AXES`), copied: the
# swarm axis of a mesh is one of these names.
MESH_AXES = ("pod", "node", "data", "model")


class SwarmMesh:
    """A process group seen as a mesh of ``world_size`` shards.

    ``group`` the process group (None: the default group), ``rank`` and
    ``world_size`` this process's place in it, ``backend`` its transport
    (``"nccl"`` or ``"gloo"``), ``axis`` the swarm axis's name (the tuple
    ``("pod", "node")`` on a two-level mesh), ``n_nodes`` the swarm's N and
    ``per`` the nodes a rank holds (``rows``: their slice of the node
    axis). ``shape`` maps each axis to its size, as a reference mesh's
    ``shape`` does.

    With inner axes (:func:`make_swarm_mesh` with ``data`` / ``model``
    above 1) ``group`` is the rank's node group, ``inner`` maps the inner
    axes to their sizes and ``coords`` to this rank's index on each,
    :attr:`shard_view` is the node's shard group, :attr:`data_view` (with
    ``data`` above 1) the rank's data group within it, :attr:`model_view`
    (with ``model`` above 1) its model group, and ``world_group``
    the group the mesh was built over (None: the default group); otherwise
    ``inner`` and ``coords`` are empty and both views None.

    ``counts`` holds the bytes handed to each collective since the last
    :meth:`reset_counts` and ``link_counts`` the same by link class
    (`repro_torch.core.gossip` adds to both): what crosses this group's
    links counts as ``link``, ``"intra"`` on a flat mesh, ``"cross"`` on a
    two-level one, whose joint world spans the pods. A two-level mesh's
    :attr:`node_view` and :attr:`pod_view` add to the same counts under
    ``"intra"`` and ``"cross"``."""

    def __init__(self, n_nodes: int, *, group=None, axis="node",
                 shape: Optional[Dict[str, int]] = None,
                 link: str = "intra"):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("no process group: call "
                               "torch.distributed.init_process_group first")
        for name in (axis if isinstance(axis, tuple) else (axis,)):
            if name not in MESH_AXES:
                raise ValueError(f"axis {name!r} is not one of {MESH_AXES}")
        self.group = group
        self.world_size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        self.axis = axis
        self.shape = dict(shape or {axis: self.world_size})
        self.link = link
        if n_nodes % self.world_size:
            raise ValueError(f"n_nodes={n_nodes} must divide over the "
                             f"{self.world_size} ranks of the swarm mesh")
        self.n_nodes = n_nodes
        self.per = n_nodes // self.world_size
        self.node_view: Optional[GroupView] = None
        self.pod_view: Optional[GroupView] = None
        self.shard_view: Optional[GroupView] = None
        self.data_view: Optional[GroupView] = None
        self.model_view: Optional[GroupView] = None
        #: the ranks a served batch's rows divide over (None: the data
        #: group; `repro_torch.launch.serve.StepBuffers`); under a
        #: profile (:func:`use_profile`) the ranks a step's rows divide
        #: over
        self.batch_view: Optional[GroupView] = None
        #: the dry run's sharding profile (:func:`use_profile`), its
        #: store group (the ranks a node's params are cut over) and its
        #: replica group (the ranks that hold the same blocks)
        self.profile = "default"
        self.store_view: Optional[GroupView] = None
        self.replica_view: Optional[GroupView] = None
        #: ``{axes: view}``: the group of this rank over those inner axes
        #: (``("data",)``, ``("model",)``, ``("data", "model")``; with
        #: pods those with ``"pod"`` first)
        self.axis_views: Dict[tuple, GroupView] = {}
        self.world_group = group
        self.inner: Dict[str, int] = {}
        self.coords: Dict[str, int] = {}
        self.reset_counts()

    @property
    def rows(self) -> slice:
        """This rank's nodes on the node axis."""
        return slice(self.rank * self.per, (self.rank + 1) * self.per)

    def reset_counts(self) -> None:
        self.counts: Dict[str, int] = {}
        self.link_counts: Dict[str, Dict[str, int]] = {}

    def __repr__(self) -> str:
        return (f"SwarmMesh({self.axis}={self.world_size}, rank={self.rank}, "
                f"per={self.per}, backend={self.backend!r})")


class GroupView:
    """One axis of a two-level :class:`SwarmMesh` as a mesh of its own: the
    subgroup ``group`` of the ranks that share this rank's pod (the node
    axis, ``link`` ``"intra"``) or its node index (the pod axis,
    ``"cross"``), or of a swarm mesh with inner axes the ranks that hold
    one node (its shard group, ``"intra"``). ``rank`` and ``world_size`` are this process's place in
    the subgroup; the collectives of `repro_torch.core.gossip` take a view
    as they take a mesh, and add their bytes to the parent's counts."""

    def __init__(self, parent: SwarmMesh, group, axis: str, link: str):
        import torch.distributed as dist

        self.parent = parent
        self.group = group
        self.axis = axis
        self.link = link
        self.backend = parent.backend
        self.world_size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    @property
    def counts(self) -> Dict[str, int]:
        return self.parent.counts

    @property
    def link_counts(self) -> Dict[str, Dict[str, int]]:
        return self.parent.link_counts

    def __repr__(self) -> str:
        return (f"GroupView({self.axis}={self.world_size}, rank={self.rank}, "
                f"link={self.link!r})")


@contextmanager
def fake_world(world_size: int, rank: int):
    """This process as rank ``rank`` of a world of ``world_size`` ranks that
    do not exist: PyTorch's fake process group (backend ``"fake"``), whose
    collectives return at once and move nothing. One process then plays
    one rank of a large job: on the ``meta`` device to count its memory and
    work (`repro_torch.launch.dryrun`), or on the card to run that rank's
    step for real. Every mesh maker works on it as on a real world; to play
    another rank, leave the block and enter a new one (the makers create
    their groups in the same order on every rank).

    The backend is neither gloo nor NCCL, so the collectives of
    `repro_torch.core.gossip` stage nothing through host memory
    (``_staged`` copies only for gloo): a rank played here takes NCCL's
    path, the one a real job of one card a rank takes. What a fake
    collective leaves in its output is whatever the buffer held (or a copy
    of the input): values, never sizes, which the step computes from the
    config alone.

    The default group is destroyed when the block ends, also on an
    exception, so ``torch.distributed.is_initialized()`` is False again
    after it. Refuses to start inside another process group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=int(rank),
                            world_size=int(world_size))
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False, group=None):
    """The reference's production mesh, ``(16, 16)`` over ``("data",
    "model")`` (``(2, 16, 16)`` over ``("pod", "data", "model")`` with
    ``multi_pod``), as a descriptor over a world of that many ranks; a
    world too small raises the reference's error. The gossip backend runs
    on a swarm mesh: a node sharded over ``data`` × ``model`` ranks is
    :func:`make_swarm_mesh` with those sizes."""
    import torch.distributed as dist

    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    n = 1
    for s in shape.values():
        n *= s
    have = dist.get_world_size(group) if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} devices, have {have} — start a process group of "
            f"{n} ranks first")
    return SwarmMesh(n, group=group, axis="data", shape=shape)


def make_swarm_mesh(n_nodes: int = 4, *, data: int = 1, model: int = 1,
                    group=None):
    """The swarm mesh over an initialized process group: the ``node`` axis
    spans its ranks, each holding ``n_nodes / world_size`` nodes. Raises,
    as the reference does, when the nodes do not divide over the shards.
    Returns ``(mesh, "node")``.

    ``data`` / ``model`` above 1 make the reference's ``("node", "data",
    "model")`` mesh: each node position spans ``data · model`` ranks, rank
    ``(i·data + d)·model + m`` holding block ``(d, m)`` of the nodes of
    position ``i``. Every rank of the group must call it then: it creates,
    in the same order on every rank, the node group of each block ``(d,
    m)`` (the mesh's ``group``: the schedules run on it), the shard
    group of each node position (:attr:`SwarmMesh.shard_view`) and, with
    ``data`` above 1, the data group of each position and model index
    ``m``, the ranks ``(i, ·, m)`` (:attr:`SwarmMesh.data_view`): a split
    step (`repro_torch.launch.train.TrainStep.split`) gives each its share
    of the node's batch rows and sums the gradients and batch statistics
    over it; with ``model`` above 1, the model group of each position and
    data index ``d``, the ranks ``(i, d, ·)`` (:attr:`SwarmMesh.
    model_view`): a split step divides each layer's work over it (the
    activations' collectives count as ``tp_gather``, ``tp_reduce_scatter``,
    ``tp_all_reduce`` and ``tp_all_to_all``). A world that ``data · model``
    does not divide raises."""
    import torch.distributed as dist

    inner = data * model
    if inner == 1:
        mesh = SwarmMesh(n_nodes, group=group, axis="node")
        return mesh, mesh.axis
    have = dist.get_world_size(group) if dist.is_initialized() else 0
    if have < inner or have % inner:
        raise RuntimeError(
            f"need a multiple of {inner} devices (data={data} × "
            f"model={model}), have {have}")
    positions = have // inner

    def world(r):
        return r if group is None else dist.get_global_rank(group, r)

    rank = dist.get_rank(group)
    i, g = divmod(rank, inner)
    node_groups = [dist.new_group([world(q * inner + b)
                                   for q in range(positions)])
                   for b in range(inner)]
    shard_groups = [dist.new_group([world(q * inner + b)
                                    for b in range(inner)])
                    for q in range(positions)]
    # with data above 1: each (position, model index)'s data group, made
    # after the groups above so that they keep their order
    data_groups = [[dist.new_group([world((q * data + d) * model + m)
                                    for d in range(data)])
                    for m in range(model)]
                   for q in range(positions)] if data > 1 else None
    # with model above 1: each (position, data index)'s model group, made
    # last for the same reason
    model_groups = [[dist.new_group([world((q * data + d) * model + m)
                                     for m in range(model)])
                     for d in range(data)]
                    for q in range(positions)] if model > 1 else None
    mesh = SwarmMesh(n_nodes, group=node_groups[g], axis="node",
                     shape={"node": positions, "data": data,
                            "model": model})
    mesh.world_group = group
    mesh.inner = {"data": data, "model": model}
    mesh.coords = {"data": g // model, "model": g % model}
    mesh.shard_view = GroupView(mesh, shard_groups[i], "shard", "intra")
    if data_groups is not None:
        mesh.data_view = GroupView(mesh, data_groups[i][g % model], "data",
                                   "intra")
    if model_groups is not None:
        mesh.model_view = GroupView(mesh, model_groups[i][g // model],
                                    "model", "intra")
    mesh.axis_views = {("data", "model"): mesh.shard_view}
    if mesh.data_view is not None:
        mesh.axis_views[("data",)] = mesh.data_view
    if mesh.model_view is not None:
        mesh.axis_views[("model",)] = mesh.model_view
    return mesh, mesh.axis


def use_profile(mesh: SwarmMesh, profile: str) -> SwarmMesh:
    """Name the groups of an inner-sharded mesh (`make_swarm_mesh(n,
    data=D, model=M)`, ``D`` and ``M`` above 1) that a step under the
    reference dry run's ``profile`` runs on (`repro_torch.launch.specs`):

    * ``"dp"``: params cut over ``data`` alone, so the **store group** (the
      ranks a layer is gathered from) is the rank's data group and the
      **replica group** (the ranks that hold the same blocks, over which a
      gradient brought onto the blocks is summed) its model group; the
      rows divide over the whole position (the **batch group**);
    * ``"zero3"``: params cut over the whole position, which is both the
      store group and the batch group; no replica group;
    * ``"default"``: the store group is the shard group, the rest as
      :func:`make_swarm_mesh` leaves them (tensor parallelism on
      ``model``).

    ``batch_sizes`` (the axes a served batch's rows divide over, with
    their sizes: the inner axes, with ``"pod"`` first where a dry run
    folds pods into the batch) start as the inner axes. Returns the mesh,
    its ``profile`` set."""
    if profile not in ("default", "dp", "zero3"):
        raise ValueError(f"no profile {profile!r}")
    if profile != "default" and (mesh.data_view is None
                                 or mesh.model_view is None):
        raise ValueError(f"--profile {profile} needs data and model above "
                         f"1, not {mesh.inner}")
    mesh.profile = profile
    mesh.batch_sizes = dict(mesh.inner)
    mesh.store_view, mesh.replica_view = mesh.shard_view, None
    mesh.batch_view = None
    if profile == "dp":
        mesh.store_view = mesh.data_view
        mesh.replica_view = mesh.model_view
        mesh.batch_view = mesh.shard_view
    elif profile == "zero3":
        mesh.batch_view = mesh.shard_view
    return mesh


def make_two_level_swarm_mesh(n_pods: int = 2, per_pod: int = 2, *,
                              group=None):
    """The two-level swarm mesh: ``(n_pods, per_pod)`` over ``("pod",
    "node")``, one node a rank. Rank ``p·per_pod + j`` is node ``j`` of pod
    ``p`` (row-major, the reference's device order). Every rank of the
    default group must call it: it creates each pod's node group and each
    node index's pod group (`torch.distributed.new_group`), all of them, in
    the same order on every rank. A world of another size than ``n_pods ·
    per_pod`` raises. Returns ``(mesh, ("pod", "node"))``."""
    import torch.distributed as dist

    n = n_pods * per_pod
    have = dist.get_world_size(group) if dist.is_initialized() else 0
    if have != n:
        raise RuntimeError(
            f"need {n} devices, have {have} — start a process group of "
            f"{n} ranks to hold the two-level mesh")
    axis = ("pod", "node")
    mesh = SwarmMesh(n, group=group, axis=axis,
                     shape={"pod": n_pods, "node": per_pod}, link="cross")

    def world(r):
        return r if group is None else dist.get_global_rank(group, r)

    p, j = divmod(mesh.rank, per_pod)
    node_groups = [dist.new_group([world(q * per_pod + i)
                                   for i in range(per_pod)])
                   for q in range(n_pods)]
    pod_groups = [dist.new_group([world(q * per_pod + i)
                                  for q in range(n_pods)])
                  for i in range(per_pod)]
    mesh.node_view = GroupView(mesh, node_groups[p], "node", "intra")
    mesh.pod_view = GroupView(mesh, pod_groups[j], "pod", "cross")
    return mesh, axis
