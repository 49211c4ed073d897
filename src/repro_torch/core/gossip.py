"""Gossip: the paper's P2P exchange as collectives over a process group.

Port of ``repro.core.gossip``. The reference runs one program over a mesh
whose swarm axis shards the stacked node axis, and moves the shards with
``psum`` / ``ppermute`` / ``all_gather`` / ``all_to_all`` inside
``shard_map``. The port runs one process per rank (`repro_torch.launch.
mesh.SwarmMesh`): every function here takes and returns the rank's rows
``[per, A]`` of the flat payload (the nodes ``mesh.rows``), every rank calls
it with the same replicated arguments (weights, mixing rows), and the
collectives are explicit:

    reference            port
    psum                 all_reduce
    ppermute (ring)      batch_isend_irecv to and from both ring neighbours
    all_gather           all_gather
    all_to_all (q8 psum) all_to_all_single
    axis_index           mesh.rank

Schedules (their names are the reference's):

  * ``fedavg_gossip`` / ``fisher_gossip``  — weighted global merge by
    all_reduce (f32);
  * ``ring_gossip`` / ``ring_rows_gossip`` / ``ring_topo_fisher_gossip`` —
    the ring: each rank sends its payload to both neighbours (one node a
    rank, N ≥ 3);
  * ``matrix_gossip`` / ``topo_fisher_gossip`` — one all_gather and a local
    contraction with the rank's mixing rows;
  * the int8 **mesh error-feedback wire**: ``ring_rows_gossip_q8``,
    ``ring_topo_fisher_gossip_q8`` (per-node references plus neighbour
    replicas ``left`` / ``right``), ``matrix_gossip_q8`` /
    ``topo_fisher_gossip_q8`` (the replicated reconstruction ``table``),
    ``fedavg_psum_q8`` / ``fisher_psum_q8`` (the compression-aware psum: an
    int8 all_to_all reduce-scatter, the owner's dequant-and-sum and a
    second-stage residual ``cres``, then an int8 all_gather into the
    replicated consensus ``cons``). ``*_q8`` functions return ``(merged,
    new_wire)``;
  * the two-level ``("pod", "node")`` schedules ``hier_fedavg_ring_q8`` /
    ``hier_fisher_ring_q8`` (`repro_torch.launch.mesh.
    make_two_level_swarm_mesh`): an intra-pod f32 all_reduce on the
    rank's node group, the rank's delegate chunk over the pod ring as an
    int8 EF delta on its pod group, an intra-pod all_gather of the mixed
    chunks.

**Inner (model) sharding.** On a swarm mesh with ``data`` / ``model``
axes (`repro_torch.launch.mesh.make_swarm_mesh`) a rank holds one block
of each of its nodes (`repro_torch.core.flat.ShardLayout`) and ``mesh`` is
its node group: every flat schedule runs unchanged on the rank's shard
rows ``[per, A_local]``, as the reference's ``_mapped`` runs each leaf's
local block inside ``shard_map(in_specs=P(axis, *inner))``. The int8
forms take the shard's layout (``ShardLayout.local``), so each leaf's
local block is flattened in the reference's order and padded to whole
wire blocks, as the reference pads a local shard: the scales and the EF
references are those of its sharded run, not of an unsharded one. The
psum-q8 forms refuse inner specs, as the reference's do (their chunks
slice the globally-flattened payload), and so do the hierarchical forms.

bf16 is a stateless cast of what crosses the wire (:func:`_wire_cast`).
All int8 quantization goes through the port's one quant core
(`core.comms.quant_encode` / `quant_decode`) on the reference's per-leaf
block grid (:class:`PaddedGrid`): each leaf of the payload's
:class:`~repro_torch.core.flat.FlatLayout` is flattened in the reference's
element order (HWIO for a conv) and zero-padded to whole blocks, so the
scales and the EF references equal the reference's bit for bit.

**Transport.** The caller picks the process group's backend. gloo takes
CUDA tensors only in ``broadcast`` and ``all_reduce``, so its other
collectives stage CUDA tensors through host copies, here in
:func:`_staged` and nowhere else; NCCL moves them on the card. The compute
(the EF arithmetic, the contractions) stays on the rank's device.

**Bytes.** Each collective adds the bytes of the tensors this rank hands
to it (what it sends; never the staging copies) to ``mesh.counts`` under
its name (``all_reduce``, ``ring``, ``all_gather``, ``all_to_all``), or
under ``control`` for the engine's gate bookkeeping, and to
``mesh.link_counts`` under the group's link class: ``intra`` on a flat
mesh and a two-level mesh's node group, ``cross`` on its joint world (a
flat schedule there spans the pods, as the cost model prices it) and its
pod group. :func:`sync_bytes` sums them.

On an inner-sharded mesh the caller names the kind: ``shard_gather`` (a
node's shards gathered whole), ``layer_gather`` (a split step's layer,
`repro_torch.core.flat.LayerCut`), ``gate_gather`` (the same gathers of
the split gate), ``step_control`` (a split step's norms and means) and
the gradient's three kinds over the data group
(`repro_torch.models.gather`): ``grad_reduce`` for an :func:`all_reduce`
(the whole tensor, as always), ``grad_reduce_scatter`` for a
:func:`reduce_scatter` and ``grad_reduce_owner`` for a :func:`reduce`.
These two count only what leaves the rank: a reduce_scatter the
``world − 1`` segments of the other ranks (its own stays), a reduce the
tensor on every rank but the owner, and nothing on the owner (it
receives the sum). Under tensor parallelism (a split step on a model
group) ``layer_gather`` / ``gate_gather`` count the compute blocks' pieces
a rank sends over the shard group (:func:`all_to_all_v`, what leaves the
rank), ``grad_to_shard`` the f32 pieces of its cotangents it sends back
to the ranks that store them, and the model group's activations
(`repro_torch.sharding.tensor`) count as ``tp_gather``,
``tp_reduce_scatter``, ``tp_all_reduce`` and ``tp_all_to_all``, and a
served decode cache cut on its sequence combines its partial softmax over
the data group as ``tp_seq_max`` and ``tp_seq_sum``
(`repro_torch.sharding.tensor.seq_softmax`). Under the dry run's ``dp``
profile the blocks a data group reduced are summed once more over the
model group that repeats them (``grad_replica``, an :func:`all_reduce`),
and under ``zero3`` a served decode step gathers its cut cache over the
model group (``cache_gather``, `repro_torch.sharding.stored`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.core import comms
from repro_torch.core.flat import FlatLayout

# ---------------------------------------------------------------------------
# transport: the collectives, their byte counts and gloo's host staging
# ---------------------------------------------------------------------------


def _count(mesh, kind, *tensors) -> None:
    """Add the bytes of ``tensors`` under ``kind`` and the mesh's link
    class; ``kind`` None counts nothing (a checkpoint's gather)."""
    _count_bytes(mesh, kind, sum(t.numel() * t.element_size()
                                 for t in tensors))


def _count_bytes(mesh, kind, nbytes: int) -> None:
    if kind is None:
        return
    mesh.counts[kind] = mesh.counts.get(kind, 0) + nbytes
    link = mesh.link_counts.setdefault(mesh.link, {})
    link[kind] = link.get(kind, 0) + nbytes


def _staged(mesh, t: torch.Tensor) -> torch.Tensor:
    """What a collective other than all_reduce is handed: gloo moves only
    host memory there, so a CUDA tensor goes through a host copy; NCCL
    takes the card's tensor."""
    if mesh.backend == "gloo" and t.is_cuda:
        return t.cpu()
    return t.contiguous()


def _peer(mesh, rank: int) -> int:
    if mesh.group is None:
        return rank
    return dist.get_global_rank(mesh.group, rank)


def all_reduce(mesh, t: torch.Tensor, op: str = "sum",
               kind: str = "all_reduce") -> torch.Tensor:
    """Σ (or min) of ``t`` over the ranks, a new tensor on ``t``'s device
    (gloo and NCCL both take CUDA tensors here)."""
    out = t.contiguous().clone()
    _count(mesh, kind, out)
    dist.all_reduce(out, op=dist.ReduceOp.MIN if op == "min"
                    else dist.ReduceOp.SUM, group=mesh.group)
    return out


def all_gather(mesh, t: torch.Tensor, kind: str = "all_gather",
               staged: bool = False) -> torch.Tensor:
    """Every rank's ``t`` [rows, ...] concatenated in rank order
    [world·rows, ...], on ``t``'s device; with ``staged`` where the
    collective wrote it (gloo: host memory), for a caller that copies
    only the blocks it keeps to the device."""
    src = _staged(mesh, t)
    _count(mesh, kind, src)
    w = mesh.world_size
    out = src.new_empty((w * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather(list(out.chunk(w)), src, group=mesh.group)
    return out if staged else out.to(t.device)


def reduce_scatter(mesh, t: torch.Tensor, kind: str = "reduce_scatter"
                   ) -> torch.Tensor:
    """Row ``r`` of ``t`` [world, n] summed over the ranks, on rank ``r``:
    a new tensor [n] on ``t``'s device. Counts the rows of the other ranks
    (what leaves this one)."""
    src = _staged(mesh, t)
    _count(mesh, kind, *(row for r, row in enumerate(src)
                         if r != mesh.rank))
    out = src.new_empty(src.shape[1:])
    dist.reduce_scatter(out, list(src.unbind(0)), group=mesh.group)
    return out.to(t.device)


def reduce(mesh, t: torch.Tensor, owner: int, kind: str = "reduce"):
    """Σ of ``t`` over the ranks, on the rank ``owner`` (its index in the
    group): a new tensor on ``t``'s device there, None on every other
    rank. Counts ``t`` on every rank but the owner."""
    src = _staged(mesh, t)
    if src is t:
        src = t.clone()     # the collective writes its buffer on every rank
    if mesh.rank != owner:
        _count(mesh, kind, src)
    dist.reduce(src, _peer(mesh, owner), op=dist.ReduceOp.SUM,
                group=mesh.group)
    return src.to(t.device) if mesh.rank == owner else None


def all_to_all_v(mesh, t: torch.Tensor, send: list, recv: list,
                 kind: str) -> torch.Tensor:
    """The uneven all_to_all: the first ``send[0]`` rows of ``t`` go to
    rank 0, the next ``send[1]`` to rank 1, ...; returns the ``recv[r]``
    rows each rank ``r`` sent here, in rank order, where the collective
    wrote them (gloo: host memory). Counts what leaves the rank (every
    segment but its own)."""
    src = _staged(mesh, t)
    row = src[:1].numel() * src.element_size() if src.shape[0] else 0
    _count_bytes(mesh, kind, (sum(send) - send[mesh.rank]) * row)
    out = src.new_empty((sum(recv),) + tuple(src.shape[1:]))
    dist.all_to_all_single(out, src, list(recv), list(send),
                           group=mesh.group)
    return out


def all_to_all(mesh, t: torch.Tensor) -> torch.Tensor:
    """Row block c of ``t`` [world·k, ...] goes to rank c; returns the
    blocks every rank sent here, in rank order."""
    src = _staged(mesh, t)
    _count(mesh, "all_to_all", src)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group)
    return out.to(t.device)


def ring_exchange(mesh, tensors, two_sided: bool = True):
    """Each tensor to both ring neighbours, in one ``batch_isend_irecv``:
    returns ``(from_left, from_right)``, the lists rank − 1 and rank + 1
    sent (the reference's two ``ppermute`` shifts). ``two_sided`` False
    sends rightward only (the reference's forward shift alone, as a pair
    ring that folds both edges onto one peer) and returns ``from_right``
    None."""
    n, r = mesh.world_size, mesh.rank
    left, right = _peer(mesh, (r - 1) % n), _peer(mesh, (r + 1) % n)
    srcs = [_staged(mesh, t) for t in tensors]
    _count(mesh, "ring", *srcs, *(srcs if two_sided else ()))
    from_left = [torch.empty_like(s) for s in srcs]
    from_right = [torch.empty_like(s) for s in srcs] if two_sided else None
    ops = []
    for k, s in enumerate(srcs):
        # tag 2k+1 travels rightward, 2k leftward: the two edges of a pair
        # ring reach one peer under distinct tags
        ops += [dist.P2POp(dist.isend, s, right, mesh.group, 2 * k + 1),
                dist.P2POp(dist.irecv, from_left[k], left, mesh.group,
                           2 * k + 1)]
        if two_sided:
            ops += [dist.P2POp(dist.isend, s, left, mesh.group, 2 * k),
                    dist.P2POp(dist.irecv, from_right[k], right, mesh.group,
                               2 * k)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    dev = tensors[0].device
    return ([t.to(dev) for t in from_left],
            None if from_right is None else [t.to(dev) for t in from_right])


PAYLOAD_KINDS = ("all_reduce", "ring", "all_gather", "all_to_all")


def sync_bytes(mesh) -> dict:
    """The payload bytes a mesh counted (``mesh.counts``, ``mesh.
    link_counts``) by collective, by link class, and by collective within
    each link class (``by_link_collective``), and the gate bookkeeping's
    ``control`` bytes apart; on an inner-sharded mesh also the gate's
    gathers: a node's shards (``shard_gather``), or a split gate's layers
    (``gate_gather``) and, tensor-parallel, its model group's activations
    (``tp_*``)."""
    def payload(kinds):
        return {k: kinds[k] for k in PAYLOAD_KINDS if k in kinds}

    per_link = {link: payload(kinds)
                for link, kinds in mesh.link_counts.items()}
    by_link = {"intra": 0, "cross": 0}
    for link, kinds in per_link.items():
        by_link[link] += sum(kinds.values())
    out = {"by_collective": payload(mesh.counts), "by_link_class": by_link,
           "by_link_collective": per_link,
           "control": mesh.counts.get("control", 0)}
    for kind, nbytes in mesh.counts.items():
        if kind in ("shard_gather", "gate_gather") or kind.startswith("tp_"):
            out[kind] = nbytes
    return out


# ---------------------------------------------------------------------------
# the reference's per-leaf int8 block grid over the flat payload
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PaddedGrid:
    """Where every stored value of a flat payload ``[rows, A]`` sits in the
    reference's padded int8 payload ``[rows, padded]``: each leaf flattened
    in the reference's order, zero-padded to a multiple of ``chunks ·
    wire_block`` values and cut into ``chunks`` equal chunks; the padded
    vector holds chunk 0 of every leaf, then chunk 1, ... (chunk-major, the
    psum-q8 reduce-scatter layout; with ``chunks`` 1 simply the padded
    leaves one after another). A chunk of a leaf is whole blocks, so each
    block is one of the reference's.

    ``src`` [padded] int64: the stored index of each slot (0 at a pad),
    ``valid`` [padded] bool: False at a pad, ``back`` [A] int64: the slot of
    each stored value; ``leaf_chunks``: per leaf (path, start in a chunk
    row, chunk length), in storage order."""

    size: int
    padded: int
    wire_block: int
    chunks: int
    src: torch.Tensor
    valid: torch.Tensor
    back: torch.Tensor
    leaf_chunks: Tuple[Tuple[str, int, int], ...]


def _padded_chunk(size: int, n: int, wire_block: int) -> int:
    """Per-shard chunk length of a leaf of ``size`` values padded to the
    n·wire_block grid (the psum-q8 reduce-scatter layout)."""
    grid = n * wire_block
    return (-(-size // grid) * grid) // n


def padded_grid(layout, wire_block: int, chunks: int = 1,
                device=None) -> PaddedGrid:
    """The :class:`PaddedGrid` of a payload layout (a :class:`FlatLayout`,
    or an integer: one leaf of that size) on ``device``; a grid passes
    through."""
    if isinstance(layout, PaddedGrid):
        return layout
    wb = comms.validate_wire_block(wire_block)
    paths = ([lf.path for lf in layout.leaves]
             if isinstance(layout, FlatLayout) else ["payload"])
    specs, c_total = [], 0
    for path, (off, _, local) in zip(paths, comms._leaves(layout)):
        chunk = _padded_chunk(local.numel(), chunks, wb)
        specs.append((path, off, local, chunk, c_total))
        c_total += chunk
    size = sum(local.numel() for _, _, local, _, _ in specs)
    padded = c_total * chunks
    src = torch.zeros(padded, dtype=torch.int64)
    valid = torch.zeros(padded, dtype=torch.bool)
    back = torch.empty(size, dtype=torch.int64)
    for _, off, local, chunk, base in specs:
        slot = (local // chunk) * c_total + base + local % chunk
        stored = torch.arange(off, off + local.numel())
        src[slot], valid[slot], back[stored] = stored, True, slot
    return PaddedGrid(size, padded, wb, chunks, src.to(device),
                      valid.to(device), back.to(device),
                      tuple((p, b, c) for p, _, _, c, b in specs))


def _ef_encode(z, ref, grid: PaddedGrid):
    """``(z, ref)`` [rows, A] → ``(q int8 [rows, padded], scales f32
    [rows, padded / wire_block], ref' [rows, A])`` with ref' = ref +
    deq(q·s): the reference's ``_ef_encode`` (pads quantize to 0)."""
    d = z.to(torch.float32) - ref
    zp = torch.where(grid.valid, d[:, grid.src], 0.0)
    q, s = comms.quant_encode(zp, grid.wire_block)
    return q, s, ref + _decode(q, s, grid)


def _decode(q, s, grid: PaddedGrid):
    """A received int8 payload back on the stored values [rows, A]."""
    return comms.quant_decode(q, s, grid.wire_block)[:, grid.back]


def _grid_of(x, layout, wire_block, chunks=1) -> PaddedGrid:
    return padded_grid(x.shape[-1] if layout is None else layout,
                       wire_block, chunks, x.device)


# ---------------------------------------------------------------------------
# f32 / bf16 schedules
# ---------------------------------------------------------------------------

def _wire_cast(z, wire_dtype):
    """STATELESS cast of a payload for the wire: bf16 halves the bytes and
    the arithmetic stays f32 after the decode. int8 is refused: a stateless
    int8 wire would drop mass; it rides the ``*_q8`` forms, which carry the
    error-feedback state."""
    if wire_dtype in (None, "f32"):
        return z
    if wire_dtype == "bf16":
        return z.to(torch.bfloat16)
    raise ValueError(f"wire_dtype {wire_dtype!r} has no stateless mesh cast "
                     "(int8 needs error-feedback state — the *_q8 schedule "
                     "forms carry it)")


def _f32(v, like):
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def fedavg_gossip(x, weights, mesh):
    """Weighted global merge: θ_i ← Σ_j w_j θ_j for every node (one
    all_reduce of the rank's weighted row sum)."""
    wl = _f32(weights, x)[mesh.rows]
    contrib = (x.to(torch.float32) * wl[:, None]).sum(0)
    merged = all_reduce(mesh, contrib)
    return merged.expand(x.shape).to(x.dtype).contiguous()


def ring_gossip(x, mesh, self_weight: float = 0.5):
    """Sparse P2P with a fixed self weight: θ_i ← s·θ_i + (1−s)/2·(θ_{i−1}
    + θ_{i+1}), the neighbours being the ring's neighbouring ranks."""
    (left,), (right,) = ring_exchange(mesh, [x])
    side = (1.0 - self_weight) / 2.0
    return (self_weight * x.to(torch.float32)
            + side * (left.to(torch.float32) + right.to(torch.float32))
            ).to(x.dtype)


def fisher_gossip(x, fishers, mesh, eps: float = 1e-8):
    """Diagonal-Fisher-weighted merge θ* = Σ F_i⊙θ_i / Σ F_i, broadcast to
    every node: the numerator and the mass in one all_reduce."""
    xf = x.to(torch.float32)
    ff = fishers.to(torch.float32) + eps
    both = all_reduce(mesh, torch.stack([(ff * xf).sum(0), ff.sum(0)]))
    return (both[0] / both[1]).expand(x.shape).to(x.dtype).contiguous()


def topo_fisher_gossip(x, fishers, rows, mesh, eps: float = 1e-8,
                       wire_dtype=None):
    """Topology-restricted importance-weighted merge, the general-rows form:

        θ*_i = Σ_j rows[i,j]·(F_j+eps)⊙θ_j / Σ_j rows[i,j]·(F_j+eps)

    The numerator and the mass ride as ONE ``(num ⊕ mass)`` all_gather
    (2·N·A values at the wire dtype), contracted with the rank's rows."""
    n, per = mesh.world_size, x.shape[0]
    xf = x.to(torch.float32)
    ff = fishers.to(torch.float32) + eps
    z = torch.cat([ff * xf, ff], 0)                      # [2·per, A]
    allz = all_gather(mesh, _wire_cast(z, wire_dtype)).to(torch.float32)
    pair = allz.reshape(n, 2, per, -1)                   # rank-major
    num_all = pair[:, 0].reshape(n * per, -1)
    den_all = pair[:, 1].reshape(n * per, -1)
    r = _f32(rows, x)[mesh.rows]                         # [per, N]
    out = (r @ num_all) / torch.clamp(r @ den_all, min=1e-30)
    return out.to(x.dtype)


def _check_one_node_per_shard(x, mesh, what: str):
    n = mesh.world_size
    lead = x.shape[0] * n
    if x.shape[0] != 1:
        raise ValueError(
            f"{what} needs one node per mesh shard (leading axis {lead} vs "
            f"mesh axis {mesh.axis}={n}); use the gathered fallback for "
            "per>1")
    if n < 3:
        raise ValueError(f"{what} needs N >= 3 (an N=2 ring folds both "
                         f"neighbour edges onto one peer); got N={n}")


def _ring_weights(R, mesh):
    i, n = mesh.rank, mesh.world_size
    return R[i, i], R[i, (i - 1) % n], R[i, (i + 1) % n]


def ring_rows_gossip(x, W, mesh, wire_dtype=None):
    """Ring-native mixing-row gossip (mean/fedavg on a ring):

        θ*_i = W[i,i]·θ_i + W[i,i−1]·θ_{i−1} + W[i,i+1]·θ_{i+1}

    2·A point-to-point values a rank, honouring a membership-masked ring
    matrix; only the neighbours' payloads are wire-cast, the self term
    stays exact."""
    _check_one_node_per_shard(x, mesh, "ring_rows_gossip")
    (left,), (right,) = ring_exchange(mesh, [_wire_cast(x, wire_dtype)])
    w_self, w_left, w_right = _ring_weights(_f32(W, x), mesh)
    out = (w_self * x.to(torch.float32) + w_left * left.to(torch.float32)
           + w_right * right.to(torch.float32))
    return out.to(x.dtype)


def ring_topo_fisher_gossip(x, fishers, rows, mesh, eps: float = 1e-8,
                            wire_dtype=None):
    """Ring-native :func:`topo_fisher_gossip`: the fused ``(F⊙θ ⊕ F)`` side
    channel goes to both ring neighbours (4·A values a rank); the self
    terms never touch the wire."""
    _check_one_node_per_shard(x, mesh, "ring_topo_fisher_gossip")
    xf = x.to(torch.float32)
    ff = fishers.to(torch.float32) + eps
    y = ff * xf
    z = _wire_cast(torch.cat([y, ff], 0), wire_dtype)    # [2, A]
    (left,), (right,) = ring_exchange(mesh, [z])
    left, right = left.to(torch.float32), right.to(torch.float32)
    r_self, r_left, r_right = _ring_weights(_f32(rows, x), mesh)
    num = r_self * y + r_left * left[0:1] + r_right * right[0:1]
    den = r_self * ff + r_left * left[1:2] + r_right * right[1:2]
    return (num / torch.clamp(den, min=1e-30)).to(x.dtype)


def matrix_gossip(x, W, mesh, wire_dtype=None):
    """General mixing matrix (dynamic membership): all_gather + the rank's
    rows of W."""
    allx = all_gather(mesh, _wire_cast(x.to(torch.float32), wire_dtype)
                      ).to(torch.float32)                # [N, A]
    return (_f32(W, x)[mesh.rows] @ allx).to(x.dtype)


# ---------------------------------------------------------------------------
# the int8 mesh error-feedback wire: the *_q8 schedule forms
# ---------------------------------------------------------------------------

def init_mesh_wire(schedule: str, payload, *, n_shards: int,
                   wire_block: int = 512, layout=None, mesh_shape=None):
    """Zero EF wire state of a ``*_q8`` schedule for this rank's payload
    rows ``[per, A]`` (``layout``: the payload's leaves, a shard's local
    layout on an inner-sharded mesh; None, one leaf):

      ring:      {"ref", "left", "right"} [per, A] — own and neighbour-
                 replica references (weighted forms: {"num", "mass"} each)
      gathered:  {"table"} [N, A] — the full reconstruction, replicated
      psum q8:   {"ref"} [1, A] the rank's contribution reference,
                 {"cons"} [1, A] the replicated consensus, {"cres"} [1, C]
                 the second-stage residual of the chunk this rank owns
      hier q8:   {"ref", "left"[, "right"]} [1, C] — the references of the
                 rank's delegate chunk of its own pod and of the
                 neighbour pods (fisher: {"num", "mass"} each); needs
                 ``mesh_shape=(n_pods, per_pod)``, and "right" exists only
                 for n_pods > 2 (a two-pod ring folds onto one peer)
    """
    per, a = payload.shape
    dev = payload.device

    def z(rows, width=a):
        return torch.zeros((rows, width), dtype=torch.float32, device=dev)

    def pair(f):
        return {"num": f(), "mass": f()}

    if schedule == "ring_ppermute":
        return {k: z(per) for k in ("ref", "left", "right")}
    if schedule == "ring_topo_ppermute":
        return {k: pair(lambda: z(per)) for k in ("ref", "left", "right")}
    if schedule == "gathered_rows":
        return {"table": z(per * n_shards)}
    if schedule == "gathered_topo_stack":
        return {"table": pair(lambda: z(per * n_shards))}
    if schedule in ("fedavg_psum_q8", "fisher_psum_q8"):
        chunk = padded_grid(a if layout is None else layout, wire_block,
                            n_shards).padded // n_shards
        parts = {"ref": lambda: z(1), "cons": lambda: z(1),
                 "cres": lambda: z(1, chunk)}
        if schedule == "fedavg_psum_q8":
            return {k: f() for k, f in parts.items()}
        return {k: pair(f) for k, f in parts.items()}
    if schedule in ("hier_fedavg_ring_q8", "hier_fisher_ring_q8"):
        if mesh_shape is None:
            raise ValueError(f"{schedule} needs mesh_shape=(n_pods, per_pod)")
        k_pods, per_pod = mesh_shape
        chunk = padded_grid(a if layout is None else layout, wire_block,
                            per_pod).padded // per_pod
        keys = ("ref", "left", "right") if k_pods > 2 else ("ref", "left")
        if schedule == "hier_fedavg_ring_q8":
            return {k: z(1, chunk) for k in keys}
        return {k: pair(lambda: z(1, chunk)) for k in keys}
    raise ValueError(f"no mesh wire state for schedule {schedule!r}")


def reset_mesh_wire(wire):
    """Quarantine the WHOLE mesh EF wire (crash → rejoin): the neighbour
    replicas must track their senders' references bit for bit, so one
    node's reference is never zeroed alone; every rank zeroes all of its
    state and the next sync retransmits full payloads everywhere."""
    if isinstance(wire, dict):
        return {k: reset_mesh_wire(v) for k, v in wire.items()}
    return None if wire is None else torch.zeros_like(wire)


def ring_rows_gossip_q8(x, W, wire, mesh, *, layout=None,
                        wire_block: int = 512):
    """int8-EF form of :func:`ring_rows_gossip`: the ring moves int8 deltas
    and per-block scales; each rank advances its own reference and its two
    neighbour replicas from the same stream, so reconstructions match the
    senders bit for bit; the self term stays exact. Returns ``(merged,
    new_wire)``."""
    _check_one_node_per_shard(x, mesh, "ring_rows_gossip_q8")
    grid = _grid_of(x, layout, wire_block)
    q, s, ref2 = _ef_encode(x, wire["ref"], grid)
    (ql, sl), (qr, sr) = ring_exchange(mesh, [q, s])
    lft2 = wire["left"] + _decode(ql, sl, grid)
    rgt2 = wire["right"] + _decode(qr, sr, grid)
    w_self, w_left, w_right = _ring_weights(_f32(W, x), mesh)
    out = w_self * x.to(torch.float32) + w_left * lft2 + w_right * rgt2
    return out.to(x.dtype), {"ref": ref2, "left": lft2, "right": rgt2}


def _pairs(t):
    return {"num": t[0:1], "mass": t[1:2]}


def _cat(p):
    return torch.cat([p["num"], p["mass"]], 0)


def ring_topo_fisher_gossip_q8(x, fishers, rows, wire, mesh, *, layout=None,
                               eps: float = 1e-8, wire_block: int = 512):
    """int8-EF form of :func:`ring_topo_fisher_gossip`: the stacked
    ``(F⊙θ ⊕ F)`` side channel rides the ring as one two-row delta stream
    against per-node references with neighbour replicas. Returns
    ``(merged, new_wire)``."""
    _check_one_node_per_shard(x, mesh, "ring_topo_fisher_gossip_q8")
    grid = _grid_of(x, layout, wire_block)
    xf = x.to(torch.float32)
    ff = fishers.to(torch.float32) + eps
    y = ff * xf
    q, s, ref2 = _ef_encode(torch.cat([y, ff], 0), _cat(wire["ref"]), grid)
    (ql, sl), (qr, sr) = ring_exchange(mesh, [q, s])
    lft2 = _cat(wire["left"]) + _decode(ql, sl, grid)
    rgt2 = _cat(wire["right"]) + _decode(qr, sr, grid)
    r_self, r_left, r_right = _ring_weights(_f32(rows, x), mesh)
    num = r_self * y + r_left * lft2[0:1] + r_right * rgt2[0:1]
    den = r_self * ff + r_left * lft2[1:2] + r_right * rgt2[1:2]
    return ((num / torch.clamp(den, min=1e-30)).to(x.dtype),
            {"ref": _pairs(ref2), "left": _pairs(lft2),
             "right": _pairs(rgt2)})


def matrix_gossip_q8(x, W, wire, mesh, *, layout=None,
                     wire_block: int = 512):
    """int8-EF form of :func:`matrix_gossip` (``gathered_rows``): ONE int8
    all_gather of every node's delta and one of the scales; every rank
    advances the full replicated table (all see the same deltas) and
    contracts its rows against it. Returns ``(merged, new_wire)``."""
    grid = _grid_of(x, layout, wire_block)
    table = wire["table"]
    q, s, _ = _ef_encode(x, table[mesh.rows], grid)
    table2 = table + _decode(all_gather(mesh, q), all_gather(mesh, s), grid)
    out = _f32(W, x)[mesh.rows] @ table2
    return out.to(x.dtype), {"table": table2}


def topo_fisher_gossip_q8(x, fishers, rows, wire, mesh, *, layout=None,
                          eps: float = 1e-8, wire_block: int = 512):
    """int8-EF form of :func:`topo_fisher_gossip` (``gathered_topo_stack``):
    the numerator and mass streams, delta-encoded against the replicated
    table, move in ONE stacked int8 all_gather plus one of the scales, then
    contract with the rank's rows. Returns ``(merged, new_wire)``."""
    grid = _grid_of(x, layout, wire_block)
    n, per = mesh.world_size, x.shape[0]
    tn, tm = wire["table"]["num"], wire["table"]["mass"]
    xf = x.to(torch.float32)
    ff = fishers.to(torch.float32) + eps
    y = ff * xf
    refs = torch.cat([tn[mesh.rows], tm[mesh.rows]], 0)
    q, s, _ = _ef_encode(torch.cat([y, ff], 0), refs, grid)
    gq = all_gather(mesh, q).reshape(n, 2, per, -1)      # rank-major
    gs = all_gather(mesh, s).reshape(n, 2, per, -1)
    tn2 = tn + _decode(gq[:, 0].reshape(n * per, -1),
                       gs[:, 0].reshape(n * per, -1), grid)
    tm2 = tm + _decode(gq[:, 1].reshape(n * per, -1),
                       gs[:, 1].reshape(n * per, -1), grid)
    r = _f32(rows, x)[mesh.rows]
    out = (r @ tn2) / torch.clamp(r @ tm2, min=1e-30)
    return out.to(x.dtype), {"table": {"num": tn2, "mass": tm2}}


def _psum_q8_stream(z, ref, cons, cres, mesh, grid: PaddedGrid):
    """One delta-consensus EF stream of the compression-aware psum:

      1. delta-encode the rank's contribution z [1, A] against its
         reference (int8 + scales; the reference advances locally),
      2. reduce-scatter: all_to_all of the int8 chunks, dequant and sum at
         each chunk's owner (f32),
      3. second-stage EF: the owner re-quantizes its reduced chunk with its
         residual ``cres`` [1, C], and the int8 chunks are all_gathered
         into the replicated consensus ``cons`` [1, A].

    Returns ``(consensus row', ref', cons', cres')``."""
    n, wb = mesh.world_size, grid.wire_block
    q, s, ref2 = _ef_encode(z, ref, grid)
    chunk = grid.padded // n
    qx = all_to_all(mesh, q.reshape(n, chunk))
    sx = all_to_all(mesh, s.reshape(n, chunk // wb))
    u = comms.quant_decode(qx, sx, wb).sum(0, keepdim=True) + cres
    q2, s2 = comms.quant_encode(u, wb)
    cres2 = u - comms.quant_decode(q2, s2, wb)
    dhat = comms.quant_decode(all_gather(mesh, q2), all_gather(mesh, s2), wb)
    cons2 = cons + dhat.reshape(1, -1)[:, grid.back]
    return cons2, ref2, cons2, cres2


def fedavg_psum_q8(x, weights, wire, mesh, *, layout=None,
                   inner_specs=None, wire_block: int = 512):
    """Compression-aware weighted global merge (``fedavg_psum_q8``): every
    node ends with the replicated consensus reconstruction of Σ_j w_j θ_j,
    from int8 traffic only (:func:`_psum_q8_stream`). An inner spec that
    names an axis raises, in the reference's words. Returns ``(merged,
    new_wire)``."""
    _refuse_inner(inner_specs, _PSUM_INNER.format("fedavg_psum_q8"))
    grid = _grid_of(x, layout, wire_block, mesh.world_size)
    wl = _f32(weights, x)[mesh.rows]
    z = (x.to(torch.float32) * wl[:, None]).sum(0, keepdim=True)
    row, ref2, cons2, cres2 = _psum_q8_stream(
        z, wire["ref"], wire["cons"], wire["cres"], mesh, grid)
    return (row.expand(x.shape).to(x.dtype).contiguous(),
            {"ref": ref2, "cons": cons2, "cres": cres2})


def fisher_psum_q8(x, fishers, wire, mesh, *, layout=None,
                   inner_specs=None, eps: float = 1e-8,
                   wire_block: int = 512):
    """Compression-aware importance-weighted global merge
    (``fisher_psum_q8``): Σ (F+eps)⊙θ and Σ (F+eps) each ride one
    delta-consensus EF stream; the merge is their ratio. Any weight folding
    (gradmatch) is in the mass already. An inner spec that names an axis
    raises, in the reference's words. Returns ``(merged, new_wire)``."""
    _refuse_inner(inner_specs, _PSUM_INNER.format("fisher_psum_q8"))
    grid = _grid_of(x, layout, wire_block, mesh.world_size)
    xf = x.to(torch.float32)
    ff = fishers.to(torch.float32) + eps
    ref, cons, cres = wire["ref"], wire["cons"], wire["cres"]
    num, rn, cn, qn = _psum_q8_stream((ff * xf).sum(0, keepdim=True),
                                      ref["num"], cons["num"], cres["num"],
                                      mesh, grid)
    den, rm, cm, qm = _psum_q8_stream(ff.sum(0, keepdim=True), ref["mass"],
                                      cons["mass"], cres["mass"], mesh, grid)
    merged = num / torch.clamp(den, min=1e-30)
    return (merged.expand(x.shape).to(x.dtype).contiguous(),
            {"ref": {"num": rn, "mass": rm}, "cons": {"num": cn, "mass": cm},
             "cres": {"num": qn, "mass": qm}})


# ---------------------------------------------------------------------------
# the two-level schedules: intra-pod reduce → pod-delegate int8 EF ring →
# intra-pod all_gather
# ---------------------------------------------------------------------------

def _hier_shapes(x, mesh):
    """Validate a hierarchical call; returns (K pods, nodes a pod)."""
    axis = mesh.axis
    if not (isinstance(axis, tuple) and len(axis) == 2):
        raise ValueError("hierarchical schedules need a two-level swarm axis "
                         f"(pod, node); got {axis!r}")
    k_pods, per_pod = mesh.shape[axis[0]], mesh.shape[axis[1]]
    if x.shape[0] != 1:
        raise ValueError(
            f"hierarchical schedules need one node per device (leading axis "
            f"{x.shape[0] * mesh.world_size} vs mesh {axis[0]}×{axis[1]}="
            f"{k_pods}×{per_pod})")
    if k_pods < 2 or per_pod < 2:
        raise ValueError(f"hierarchical schedules need ≥2 pods and ≥2 nodes "
                         f"per pod; got {k_pods}×{per_pod}")
    return k_pods, per_pod


def inner_axes(specs):
    """The axis names an inner (within-node) param spec tree names."""
    if specs is None:
        return []
    if isinstance(specs, str):
        return [specs]
    if isinstance(specs, dict):
        specs = list(specs.values())
    if isinstance(specs, (tuple, list)):
        return [a for sp in specs for a in inner_axes(sp)]
    return []


#: the reference's refusals of inner specs, word for word
_PSUM_INNER = ("{} does not support model-sharded payloads (inner_specs); "
               "use a ring/gathered schedule or wire_dtype='bf16'")
_HIER_INNER = ("{} does not support model-sharded payloads (inner_specs): "
               "delegate chunks slice the globally-flattened payload")


def _refuse_inner(inner_specs, message: str) -> None:
    """Raise ``message`` when any leaf has a spec (an empty one too), as
    the reference refuses any PartitionSpec leaf."""
    specs = (inner_specs.values() if isinstance(inner_specs, dict)
             else (inner_specs,))
    if inner_specs is not None and any(s is not None for s in specs):
        raise ValueError(message)


def _delegate_ring(chunk, wire, mesh, k_pods: int, wb: int, pod_rows):
    """Leg 2 of a hierarchical schedule on the rank's delegate chunk
    ``chunk`` [rows, C] (rows: the streams): the int8 EF delta against
    ``wire["ref"]`` over the pod ring (forward only at two pods), the
    neighbour pods' replicas advanced from what arrives, and the pod-row
    mix ``Σ_q pod_rows[p, q] · chunk_q``. Returns ``(mixed [rows, C],
    ref', left', right' or None)``."""
    pod = mesh.pod_view
    p = pod.rank
    two_sided = k_pods > 2
    q, s = comms.quant_encode(chunk - wire["ref"], wb)
    ref2 = wire["ref"] + comms.quant_decode(q, s, wb)
    (ql, sl), from_right = ring_exchange(pod, [q, s], two_sided)
    lft2 = wire["left"] + comms.quant_decode(ql, sl, wb)
    Wp = _f32(pod_rows, chunk)
    mixed = Wp[p, p] * chunk + Wp[p, (p - 1) % k_pods] * lft2
    rgt2 = None
    if two_sided:
        qr, sr = from_right
        rgt2 = wire["right"] + comms.quant_decode(qr, sr, wb)
        mixed = mixed + Wp[p, (p + 1) % k_pods] * rgt2
    return mixed, ref2, lft2, rgt2


def _hier_wire(ref2, lft2, rgt2, split):
    out = {"ref": split(ref2), "left": split(lft2)}
    if rgt2 is not None:
        out["right"] = split(rgt2)
    return out


def _pod_gather(mixed, mesh, grid: PaddedGrid, like):
    """Leg 3: the node group's all_gather of the mixed chunks [1, C], back
    on the stored values [1, A] in ``like``'s dtype."""
    full = all_gather(mesh.node_view, mixed).reshape(1, -1)
    return full[:, grid.back].to(like.dtype)


def hier_fedavg_ring_q8(x, weights, pod_rows, wire, mesh, *, layout=None,
                        inner_specs=None, wire_block: int = 512):
    """Hierarchical weighted merge on a two-level ``("pod", "node")`` mesh
    (the ``hier_fedavg_ring_q8`` schedule), on the rank's one row ``x``
    [1, A]:

      1. **intra-pod reduce** — one f32 all_reduce over the node group of
         Σ w·θ, laid out on the padded chunk-major grid, with the pod mass
         Σ w beside it, gives every rank its pod's average ā_q;
      2. **pod-delegate int8 EF ring** — the rank owns chunk j (its node
         index) of every leaf of ā_q and sends it over the pod ring as an
         int8 delta + per-block scales against its EF reference; the
         neighbour pods' replicas advance from the same stream. Only this
         leg crosses pods: k·P/per_pod int8 values a rank, k = 1 at two
         pods (the pair ring folds both edges onto one peer and "right"
         drops out of the wire), else 2;
      3. **intra-pod all_gather** of the pod-row-mixed chunks.

    The self-pod term mixes at exact f32; on settling inputs every node
    converges to the pod-ring mix Σ_q pod_rows[pod(i), q] · ā_q. Every pod
    needs an active node (a weight > 0): a fully-absent pod raises.
    Returns ``(merged, new_wire)``."""
    k_pods, per_pod = _hier_shapes(x, mesh)
    _refuse_inner(inner_specs, _HIER_INNER.format("hier_fedavg_ring_q8"))
    w = _f32(weights, x)
    if not bool((w.reshape(k_pods, per_pod) > 0).any(1).all()):
        raise ValueError("hier_fedavg_ring_q8: a fully-absent pod (every "
                         "weight of its nodes 0) has no pod average; the "
                         "hierarchical schedules need an active node in "
                         "every pod")
    grid = _grid_of(x, layout, wire_block, per_pod)
    wl = w[mesh.rows]                                    # [1]
    z = x.to(torch.float32) * wl[:, None]
    zp = torch.where(grid.valid, z[:, grid.src], 0.0)    # [1, padded]
    both = all_reduce(mesh.node_view, torch.cat([zp, wl[:, None]], 1))
    mass = both[:, -1:]
    avg = both[:, :-1] / torch.clamp(mass, min=1e-30)
    clen = grid.padded // per_pod
    j = mesh.node_view.rank
    chunk = avg[:, j * clen:(j + 1) * clen]
    mixed, ref2, lft2, rgt2 = _delegate_ring(chunk, wire, mesh, k_pods,
                                             grid.wire_block, pod_rows)
    return (_pod_gather(mixed, mesh, grid, x),
            _hier_wire(ref2, lft2, rgt2, lambda t: t))


def hier_fisher_ring_q8(x, fishers, pod_rows, wire, mesh, *, layout=None,
                        inner_specs=None, eps: float = 1e-8,
                        wire_block: int = 512):
    """Hierarchical importance-weighted merge on a two-level mesh (the
    ``hier_fisher_ring_q8`` schedule): :func:`hier_fedavg_ring_q8` with the
    fused ``(F⊙θ ⊕ F)`` side channel. The intra-pod all_reduce sums the pod
    numerator Σ (F+eps)⊙θ and mass Σ (F+eps); both ride the pod ring as ONE
    stacked two-stream EF payload (2·k·P/per_pod int8 values a rank), and
    the merge is the ratio of the pod-row-mixed streams. Any weight folding
    (gradmatch) is in the mass already. Returns ``(merged, new_wire)``."""
    k_pods, per_pod = _hier_shapes(x, mesh)
    _refuse_inner(inner_specs, _HIER_INNER.format("hier_fisher_ring_q8"))
    grid = _grid_of(x, layout, wire_block, per_pod)
    ff = fishers.to(torch.float32) + eps
    z = torch.cat([ff * x.to(torch.float32), ff], 0)     # [2, A]
    zp = torch.where(grid.valid, z[:, grid.src], 0.0)    # [2, padded]
    red = all_reduce(mesh.node_view, zp)
    clen = grid.padded // per_pod
    j = mesh.node_view.rank
    chunk = red[:, j * clen:(j + 1) * clen]              # [2, C]
    mixed, ref2, lft2, rgt2 = _delegate_ring(
        chunk, {k: _cat(v) for k, v in wire.items()}, mesh, k_pods,
        grid.wire_block, pod_rows)
    ratio = mixed[0:1] / torch.clamp(mixed[1:2], min=1e-30)
    return (_pod_gather(ratio, mesh, grid, x),
            _hier_wire(ref2, lft2, rgt2, _pairs))
