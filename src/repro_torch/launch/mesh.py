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
"""
from __future__ import annotations

from typing import Dict, Optional

# The reference's axis registry (`repro.launch.mesh.MESH_AXES`), copied: the
# swarm axis of a mesh is one of these names.
MESH_AXES = ("pod", "node", "data", "model")


class SwarmMesh:
    """A process group seen as a one-axis mesh of ``world_size`` shards.

    ``group`` the process group (None: the default group), ``rank`` and
    ``world_size`` this process's place in it, ``backend`` its transport
    (``"nccl"`` or ``"gloo"``), ``axis`` the swarm axis's name,
    ``n_nodes`` the swarm's N and ``per`` the nodes a rank holds
    (``rows``: their slice of the node axis). ``shape`` maps the axis to
    the world size, as a reference mesh's ``shape`` does.

    ``counts`` holds the bytes handed to each collective since the last
    :meth:`reset_counts` (`repro_torch.core.gossip` adds to it)."""

    def __init__(self, n_nodes: int, *, group=None, axis: str = "node",
                 shape: Optional[Dict[str, int]] = None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("no process group: call "
                               "torch.distributed.init_process_group first")
        if axis not in MESH_AXES:
            raise ValueError(f"axis {axis!r} is not one of {MESH_AXES}")
        self.group = group
        self.world_size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        self.axis = axis
        self.shape = dict(shape or {axis: self.world_size})
        if n_nodes % self.world_size:
            raise ValueError(f"n_nodes={n_nodes} must divide over the "
                             f"{self.world_size} ranks of the swarm mesh")
        self.n_nodes = n_nodes
        self.per = n_nodes // self.world_size
        self.counts: Dict[str, int] = {}

    @property
    def rows(self) -> slice:
        """This rank's nodes on the node axis."""
        return slice(self.rank * self.per, (self.rank + 1) * self.per)

    def reset_counts(self) -> None:
        self.counts = {}

    def __repr__(self) -> str:
        return (f"SwarmMesh({self.axis}={self.world_size}, rank={self.rank}, "
                f"per={self.per}, backend={self.backend!r})")


def make_production_mesh(*, multi_pod: bool = False, group=None):
    """The reference's production mesh, ``(16, 16)`` over ``("data",
    "model")`` (``(2, 16, 16)`` over ``("pod", "data", "model")`` with
    ``multi_pod``), as a descriptor over a world of that many ranks. The
    port shards no model within a node, so nothing runs on it yet; a world
    too small raises the reference's error."""
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


def make_swarm_mesh(n_nodes: int = 4, *, group=None):
    """The swarm mesh over an initialized process group: the ``node`` axis
    spans its ranks, each holding ``n_nodes / world_size`` nodes. Raises,
    as the reference does, when the nodes do not divide over the shards.
    Returns ``(mesh, "node")``."""
    mesh = SwarmMesh(n_nodes, group=group, axis="node")
    return mesh, mesh.axis
