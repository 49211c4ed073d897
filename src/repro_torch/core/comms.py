"""Wire-efficient sync layer: cost model, schedule picker, quantized wire.

Port of ``repro.core.comms`` for the engine backend. Peers exchange
int8/bf16-quantized parameter *deltas* against a shared reference copy θ̂
(what the wire has already delivered), with per-block scales, and the
residual θ − θ̂ carried across rounds in ``SwarmState.wire``:

    θ̂' = θ̂ + dequant(quant(θ − θ̂))          (error feedback)

:func:`wire_effective` is the plain ground truth, and the fused CUDA commit
(`repro_torch.kernels.fused_merge.fused_quant_merge_all`) re-derives the
same θ̂' bit for bit in one launch.

**The block grid.** The reference quantizes leaf by leaf: it flattens each
stacked leaf per node, in its own element order, and cuts it into
``wire_block`` blocks from the leaf's first element (the tail block is
zero-padded, which never raises a max-abs). The port's state is one
unpadded ``[N, P]`` buffer whose conv leaves are stored OIHW, while the
reference's are HWIO. A :class:`WireGrid` maps every stored element to the
reference's block it belongs to (``seg_id``), lists each block's elements
(``perm`` + ``segments``), and groups whole blocks into tiles of contiguous
runs for the commit kernel. A grid taken over the whole buffer, or over the
OIHW order, would group other elements into a block and give other
scales.

The schedule table and the per-link-class cost model are the reference's,
line for line (pure Python); see its module docstring for the derivation.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import torch

from repro_torch.core.flat import FlatLayout
from repro_torch.core.lora import is_adapter_path

WIRE_BYTES = {"f32": 4, "bf16": 2, "int8": 1}

#: nominal payload used to rank schedules when the real count isn't known yet
_NOMINAL_P = 1 << 20


def validate_wire_dtype(wire_dtype: str) -> str:
    wd = wire_dtype or "f32"
    if wd not in WIRE_BYTES:
        raise ValueError(f"unknown wire_dtype {wire_dtype!r} "
                         f"(choose from {sorted(WIRE_BYTES)})")
    return wd


def validate_wire_block(wire_block: int) -> int:
    if wire_block <= 0 or wire_block % 128:
        raise ValueError(f"wire_block must be a positive multiple of 128 "
                         f"(lane width), got {wire_block}")
    return wire_block


PAYLOAD_MODES = ("full", "lora")


def payload_mode(cfg) -> str:
    """``cfg.payload`` with validation — what the stacked state covers
    (``"full"``: every node's params; ``"lora"``: the adapter payload)."""
    mode = getattr(cfg, "payload", "full") or "full"
    if mode not in PAYLOAD_MODES:
        raise ValueError(f"unknown payload mode {mode!r} "
                         f"(choose from {PAYLOAD_MODES})")
    return mode


def split_payload_at_sync(cfg) -> bool:
    """True when sync must carve the adapter subtree out of a full state."""
    if not getattr(cfg, "lora_only", False):
        return False
    return payload_mode(cfg) != "lora"


# ---------------------------------------------------------------------------
# cost model + schedule picker
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SyncSchedule:
    """One collective schedule with its analytic wire cost.

    ``payload_factor`` is the number of values moved per device per sync in
    units of P (the per-node payload param count). On the engine backend
    the schedule is ``simulated``: the SPMD-equivalent cost, for logs.
    """

    name: str
    collective: str          # "psum" | "ppermute" | "all_gather" | ...
    payload_factor: float
    wire_dtype: str = "f32"
    wire_block: int = 512
    simulated: bool = False
    # two-level (pod, node) split of payload_factor; cross_factor is None on
    # a flat mesh (one bandwidth domain — everything counts as intra)
    cross_factor: Optional[float] = None
    intra_factor: float = 0.0
    intra_dtype: str = "f32"
    payload: str = "full"    # payload class: "full" or "lora"

    def _leg_bytes(self, vals: float, dtype: str) -> float:
        out = vals * WIRE_BYTES[dtype]
        if dtype == "int8":  # one f32 scale per wire block
            out += vals / self.wire_block * 4.0
        return out

    def bytes_by_link_class(self, payload_params: int) -> dict:
        """Predicted per-device wire bytes per link class for one sync."""
        p = float(payload_params)
        if self.cross_factor is None:
            return {"intra": self._leg_bytes(self.payload_factor * p,
                                             self.wire_dtype),
                    "cross": 0.0}
        return {"intra": self._leg_bytes(self.intra_factor * p,
                                         self.intra_dtype),
                "cross": self._leg_bytes(self.cross_factor * p,
                                         self.wire_dtype)}

    def bytes_per_sync(self, payload_params: int) -> float:
        """Predicted per-device wire bytes for one sync of P payload values."""
        b = self.bytes_by_link_class(payload_params)
        return b["intra"] + b["cross"]

    def cost_per_sync(self, payload_params: int, intra_cost: float = 1.0,
                      cross_cost: float = 1.0) -> float:
        """Σ bytes(class) · cost(class): what :func:`pick_schedule` argmins."""
        b = self.bytes_by_link_class(payload_params)
        return b["intra"] * intra_cost + b["cross"] * cross_cost

    def describe(self, payload_params: Optional[int] = None) -> str:
        p = _NOMINAL_P if payload_params is None else payload_params
        tag = " (simulated)" if self.simulated else ""
        if self.payload != "full":
            tag = f"/{self.payload}{tag}"
        out = (f"{self.name}[{self.collective}/{self.wire_dtype}]{tag}: "
               f"{self.payload_factor:g}·P values, "
               f"{self.bytes_per_sync(p) / 1e6:.3f} MB/sync at P={p}")
        if self.cross_factor is not None:
            b = self.bytes_by_link_class(p)
            out += (f" [intra {b['intra'] / 1e6:.3f} MB + "
                    f"cross {b['cross'] / 1e6:.3f} MB]")
        return out


def candidate_schedules(cfg, *, per: int = 1, model_sharded: bool = False,
                        mesh_shape=None) -> List[SyncSchedule]:
    """Every schedule that is CORRECT for this config's sync semantics.

    ``per`` = stacked nodes per mesh shard; ``model_sharded`` drops the q8
    psum reductions; ``mesh_shape`` = (n_pods, per_pod) on a two-level mesh
    prices the flat candidates 100 % cross-pod and adds the hierarchical
    pod-delegate forms.
    """
    n = cfg.n_nodes
    wd = validate_wire_dtype(getattr(cfg, "wire_dtype", "f32"))
    wb = validate_wire_block(getattr(cfg, "wire_block", 512))
    weighted = cfg.merge in ("fisher", "gradmatch")
    ring_ok = cfg.topology == "ring" and per == 1 and n >= 3
    psum_q8_ok = wd == "int8" and not model_sharded
    two_level = mesh_shape is not None
    flat_kw = lambda factor: (
        {"cross_factor": factor, "intra_factor": 0.0} if two_level else {})
    pcls = ("lora" if (payload_mode(cfg) == "lora"
                       or getattr(cfg, "lora_only", False)) else "full")
    mk = lambda name, coll, factor, wdt: SyncSchedule(
        name, coll, factor, wire_dtype=wdt, wire_block=wb,
        payload=pcls, **flat_kw(factor))

    out: List[SyncSchedule] = []
    if weighted:
        if cfg.topology == "full":
            # psums reduce in f32: compression doesn't commute with the sum
            out.append(mk("fisher_psum", "psum", 4.0 * (n - 1) / n, "f32"))
            if psum_q8_ok:
                out.append(mk("fisher_psum_q8", "reduce_scatter", 4.0, wd))
        out.append(mk("gathered_topo_stack", "all_gather", 2.0 * n, wd))
        if ring_ok:
            out.append(mk("ring_topo_ppermute", "ppermute", 4.0, wd))
    else:
        if cfg.topology == "full":
            out.append(mk("fedavg_psum", "psum", 2.0 * (n - 1) / n, "f32"))
            if psum_q8_ok:
                out.append(mk("fedavg_psum_q8", "reduce_scatter", 2.0, wd))
        out.append(mk("gathered_rows", "all_gather", 1.0 * n, wd))
        if ring_ok:
            out.append(mk("ring_ppermute", "ppermute", 2.0, wd))

    if two_level:
        k_pods, per_pod = mesh_shape
        hier_ok = (k_pods >= 2 and per_pod >= 2 and per == 1
                   and n == k_pods * per_pod and wd == "int8"
                   and not model_sharded and cfg.topology == "ring")
        if hier_ok:
            k_hops = 1.0 if k_pods == 2 else 2.0
            cross = k_hops / per_pod
            intra = 2.0 * (per_pod - 1) / per_pod + 1.0
            if weighted:
                out.append(SyncSchedule(
                    "hier_fisher_ring_q8", "hier_ring",
                    2.0 * (cross + intra), wire_dtype=wd, wire_block=wb,
                    cross_factor=2.0 * cross, intra_factor=2.0 * intra,
                    payload=pcls))
            else:
                out.append(SyncSchedule(
                    "hier_fedavg_ring_q8", "hier_ring", cross + intra,
                    wire_dtype=wd, wire_block=wb,
                    cross_factor=cross, intra_factor=intra, payload=pcls))
    return out


def has_inner_sharding(param_specs) -> bool:
    """True when param specs (``{path: spec}``, a spec a tuple of axis
    names, tuples of names or None) name any inner (model) axis: the
    layout the q8 psum reductions cannot chunk. An axis of size 1 counts,
    as in the reference."""
    if param_specs is None:
        return False
    if isinstance(param_specs, str):
        return True
    if isinstance(param_specs, dict):
        param_specs = list(param_specs.values())
    if isinstance(param_specs, (tuple, list)):
        return any(has_inner_sharding(s) for s in param_specs)
    return False


def pick_schedule(cfg, *, per: int = 1, payload_params: Optional[int] = None,
                  simulated: bool = False, model_sharded: bool = False,
                  mesh_shape=None) -> SyncSchedule:
    """Cheapest correct schedule under the cost model: the argmin of
    Σ bytes(link class) · per-byte cost (``cfg.intra_pod_cost`` /
    ``cfg.cross_pod_cost``); on a flat mesh, the bytes argmin."""
    p = _NOMINAL_P if payload_params is None else payload_params
    cands = candidate_schedules(cfg, per=per, model_sharded=model_sharded,
                                mesh_shape=mesh_shape)
    intra_cost = float(getattr(cfg, "intra_pod_cost", 1.0))
    cross_cost = float(getattr(cfg, "cross_pod_cost", 1.0))
    best = min(cands, key=lambda s: s.cost_per_sync(p, intra_cost, cross_cost))
    if simulated:
        best = dataclasses.replace(best, simulated=True)
    return best


def payload_param_count(stacked: torch.Tensor, lora_only: bool,
                        n_nodes: int, layout: Optional[FlatLayout] = None
                        ) -> int:
    """Per-node payload values P of a stacked ``[N, P]`` state: all of
    them (a wide leaf's f32 value counted once, not as its two slots), or
    with ``lora_only`` (adapters carved out of a full state at sync) those
    of the adapter leaves of its ``layout`` (``lora_`` paths; 0 without a
    layout, as the reference counts a tree without adapters)."""
    if not lora_only:
        if layout is not None:
            return layout.n_values
        return int(stacked.numel() // max(n_nodes, 1))
    # without a layout the state is one unnamed leaf: no adapters
    leaves = layout.leaves if layout is not None else ()
    return sum(leaf.size for leaf in leaves if is_adapter_path(leaf.path))


# ---------------------------------------------------------------------------
# shared quantization core: THE int8 round-trip arithmetic of the port
# ---------------------------------------------------------------------------
# Every path of the port that quantizes — the block form below, the per-leaf
# grid of the wire functions, and the plain version of the fused commit
# kernel (`kernels.ref`) — goes through `_quantize`, so the EF contract
# (scale = max|block|/127, round-half-even, clip ±127) has one home in the
# port, as it has one in the reference's `core/comms.py`.

def _quantize(v, maxabs):  # noqa: SWL004 — the port's one copy of the int8 core; the port may not import the reference's, and tests/test_torch_wire.py holds it bit for bit against repro.core.comms
    """v f32 and its block's max |v| (broadcastable) → (q f32 int-valued,
    scale f32). scale = max|v|/127 (zero blocks keep scale 0 and quantize
    to 0); q = clip(round(v / scale), ±127), round-half-even. The divisor
    127 is a tensor on the data's device: PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, which can miss the
    correctly rounded quotient by one ulp."""
    scale = maxabs / torch.full((), 127.0, device=maxabs.device)
    q = torch.clamp(torch.round(v / torch.where(scale > 0, scale, 1.0)),
                    -127.0, 127.0)
    return q, scale


def _blocks(v, wire_block: int):
    vf = torch.as_tensor(v).to(torch.float32)
    shape = tuple(vf.shape)
    return vf.reshape(shape[:-1] + (shape[-1] // wire_block, wire_block)), shape


def quant_dequant_block(v, wire_dtype: str, wire_block: int):
    """The int8/bf16 round-trip over a ``[..., B]`` array (B a multiple of
    ``wire_block``; f32 out); equal bit for bit to
    ``quant_decode(*quant_encode(v))``."""
    vf = torch.as_tensor(v).to(torch.float32)
    if wire_dtype == "f32":
        return vf
    if wire_dtype == "bf16":
        return vf.to(torch.bfloat16).to(torch.float32)
    blocks, shape = _blocks(vf, wire_block)
    q, scale = _quantize(blocks, blocks.abs().amax(-1, keepdim=True))
    return (q * scale).reshape(shape)


def quant_encode(v, wire_block: int):
    """``[..., B]`` f32 → the int8 wire payload ``(q int8 [..., B],
    scales f32 [..., B // wire_block])``."""
    blocks, shape = _blocks(v, wire_block)
    q, scale = _quantize(blocks, blocks.abs().amax(-1, keepdim=True))
    return q.to(torch.int8).reshape(shape), scale[..., 0]


def quant_decode(q, scales, wire_block: int):
    """Inverse of :func:`quant_encode` (== the sender's round-trip)."""
    blocks, shape = _blocks(torch.as_tensor(q).to(torch.float32), wire_block)
    return (blocks * scales[..., None]).reshape(shape)


# ---------------------------------------------------------------------------
# the per-leaf block grid over the flat [N, P] state
# ---------------------------------------------------------------------------

def _ref_sort_key(path: str):
    """The reference's leaf order (``jax.tree.leaves``): dict keys sorted,
    list entries by index (zero-padded, so they sort as numbers)."""
    return tuple(p.zfill(20) if p.isdigit() else p for p in path.split("."))


def _leaves(layout: "FlatLayout | int"):
    """Per leaf, in storage order: (offset, ref_index, local order), where
    ``local order[s]`` is the position of stored element s in the
    reference's flattening of the leaf (HWIO for a conv stored OIHW) and
    ``ref_index`` the leaf's position among the reference's leaves. An
    integer layout is one leaf of that size."""
    if not isinstance(layout, FlatLayout):
        return [(0, 0, torch.arange(layout))]
    rank = {leaf.path: i for i, leaf in enumerate(
        sorted(layout.leaves, key=lambda lf: _ref_sort_key(lf.path)))}
    out = []
    for leaf in layout.leaves:
        axes = leaf.ref_axes
        back = sorted(range(len(axes)), key=axes.__getitem__)
        # a conv's stored (o, i, h, w) sits at ((h·W + w)·I + i)·O + o
        local = torch.arange(leaf.size).reshape(
            [leaf.shape[a] for a in axes]).permute(back).reshape(-1)
        out.append((leaf.offset, rank[leaf.path], local))
    return out


def _size(layout) -> int:
    if isinstance(layout, RefIndex):
        return layout.pos.numel()
    return layout.size if isinstance(layout, FlatLayout) else layout


@dataclass(frozen=True)
class RefIndex:
    """Where every stored element of ``[N, P]`` sits in the reference's
    stacked payload tree, as int64 tensors [P] on one device: ``leaf`` the
    index of its leaf among the reference's leaves, ``pos`` its position in
    the leaf's flattening (HWIO for a conv stored OIHW), ``size`` the leaf's
    size; ``n_leaves`` the number of leaves. What the checksum salts with
    and what the fault plane's flip pattern is keyed on; built once per
    layout and device (:func:`ref_index`) and passed in place of the
    layout."""

    leaf: torch.Tensor
    pos: torch.Tensor
    size: torch.Tensor
    n_leaves: int


def ref_index(layout: "FlatLayout | int | RefIndex", device=None) -> RefIndex:
    """The :class:`RefIndex` of a layout (an integer is one leaf of that
    size) on ``device``; a :class:`RefIndex` passes through."""
    if isinstance(layout, RefIndex):
        return layout
    leaves = _leaves(layout)
    p = _size(layout)
    leaf, pos, size = (torch.empty(p, dtype=torch.int64) for _ in range(3))
    for off, i, local in leaves:
        sl = slice(off, off + local.numel())
        leaf[sl], pos[sl], size[sl] = i, local, local.numel()
    return RefIndex(leaf.to(device), pos.to(device), size.to(device),
                    len(leaves))


@dataclass(frozen=True)
class WireGrid:
    """Where every stored element of ``[N, P]`` falls on the wire's block
    grid, for one wire dtype, and the tile table the commit kernel walks.

    ``seg_id`` [P] int64: the block (segment) of each stored element — what
    the plain wire functions reduce over. ``segments`` [S, 2] int64
    ``(start, length ≤ wire_block)`` into ``perm``, and ``perm`` [P] int64
    the stored indices grouped by segment (ascending within one), or None
    when every segment is a contiguous range ``[start, start + length)`` of
    the buffer. For bf16/f32 wires (no scales) the grid is plain
    ``wire_block`` chunks of the buffer and ``seg_id`` is None.

    The int8 tile table (:func:`_tile_table`), what the commit kernel's
    maxima pass walks: a tile is a set of at most ``TILE_SEGS`` whole
    segments whose stored positions form contiguous runs of the buffer.
    ``chunks`` [C + 1, 2] int64 ``(buffer start, tile-order offset)``: the
    runs, tile by tile, cut into chunks of at most ``TILE_CHUNK`` values
    (chunk k holds ``chunks[k + 1, 1] − chunks[k, 1]`` values; the last row
    is a sentinel); ``pieces`` [Q, 4] int64 ``(first chunk, end chunk,
    first entry in tile_segs, segments)``: each tile's chunks cut into
    pieces of at most ``PIECE_CHUNKS``, one thread block each, in the order
    of their first stored position; ``tile_segs`` [S] int32: the segments of each tile, ascending;
    ``lseg`` [P] uint8: each stored element's segment as an index into its
    tile's list; ``seg32`` [P] int32: ``seg_id`` for the commit pass;
    ``max_segs`` the most segments in a tile. All None (0) for bf16/f32.
    """

    size: int
    wire_dtype: str
    wire_block: int
    segments: torch.Tensor
    perm: Optional[torch.Tensor]
    seg_id: Optional[torch.Tensor]
    chunks: Optional[torch.Tensor] = None
    pieces: Optional[torch.Tensor] = None
    tile_segs: Optional[torch.Tensor] = None
    lseg: Optional[torch.Tensor] = None
    seg32: Optional[torch.Tensor] = None
    max_segs: int = 0


#: tile table sizes: a chunk (what one warp walks at a time), the segments
#: of a tile (its maxima sit in one block's shared memory; uint8 local
#: ids), and the chunks of a piece (one thread block's work)
TILE_CHUNK = 128
TILE_SEGS = 128
PIECE_CHUNKS = 16


def _runs_of(pos: torch.Tensor) -> torch.Tensor:
    """Sorted stored positions → [k, 2] ``(start, length)`` maximal runs."""
    brk = torch.nonzero(pos[1:] != pos[:-1] + 1).flatten() + 1
    starts = torch.cat([torch.zeros(1, dtype=torch.int64), brk])
    ends = torch.cat([brk, torch.tensor([pos.numel()])])
    return torch.stack([pos[starts], ends - starts], 1)


def _leaf_atoms(off, shape, seg, wire_block):
    """The smallest sets of whole segments of one leaf whose stored
    positions form runs, in storage order: [(runs [k, 2], segments,
    values)]. ``seg`` is the leaf's slice of ``seg_id``.

    A conv leaf (O, I, H, W) is stored OIHW and blocked in HWIO order, so a
    segment spans some input channels at one or more (h, w), for every
    output channel. The leaf is cut between input channels c − 1 and c
    wherever no segment holds channels on both sides; an i-slab between two
    cuts holds whole segments and is, for each output channel, one run of
    (channels × H × W) values. Consecutive slabs are merged while their
    runs are shorter than 32 values and the segment cap allows. A
    leaf with no cut is one slab, one run. A slab of more than
    ``TILE_SEGS`` segments is split into its segments, whose runs may be
    short. Any other leaf is contiguous: each segment is one run."""
    size = 1
    for d in shape:
        size *= d
    if len(shape) != 4:
        return [(torch.tensor([[off + b, min(wire_block, size - b)]]), 1,
                 min(wire_block, size - b))
                for b in range(0, size, wire_block)]
    o, i, h, w = shape
    hw = h * w
    rel = seg - seg.min()
    count = torch.bincount(rel)                    # values per segment
    nseg = len(count)
    ch = torch.arange(i).view(1, i, 1).expand(o, i, hw).reshape(-1)
    lo = torch.full((nseg,), i, dtype=torch.int64).scatter_reduce(
        0, rel, ch, "amin")
    hi = torch.zeros(nseg, dtype=torch.int64).scatter_reduce(
        0, rel, ch, "amax")
    # a cut at c is blocked by every segment with lo < c <= hi
    cover = torch.zeros(i + 2, dtype=torch.int64)
    cover.index_add_(0, lo + 1, torch.ones(nseg, dtype=torch.int64))
    cover.index_add_(0, hi + 1, -torch.ones(nseg, dtype=torch.int64))
    free = torch.cumsum(cover, 0) == 0
    lo, free, count = lo.tolist(), free.tolist(), count.tolist()  # noqa: SWL002 — CPU tensors, read once per layout when the grid is built
    cuts = [0] + [c for c in range(1, i) if free[c]] + [i]
    starting = [0] * i                             # segments by first channel
    for c in lo:
        starting[c] += 1
    slabs = []                                 # [first channel, end, segs]
    for a, b in zip(cuts[:-1], cuts[1:]):
        segs = sum(starting[a:b])
        if slabs:
            pa, _, psegs = slabs[-1]
            if psegs + segs <= TILE_SEGS and (a - pa) * hw < 32:
                slabs[-1] = [pa, b, psegs + segs]
                continue
        slabs.append([a, b, segs])
    atoms = []
    for a, b, segs in slabs:
        if segs <= TILE_SEGS:
            starts = off + (torch.arange(o) * i + a) * hw
            atoms.append((torch.stack(
                [starts, torch.full((o,), (b - a) * hw)], 1), segs,
                o * (b - a) * hw))
            continue
        order = torch.argsort(rel, stable=True)
        for k, pos in enumerate(torch.split(order, count)):
            if a <= lo[k] < b:
                atoms.append((_runs_of(off + pos), 1, len(pos)))
    return atoms


def _tile_table(layout, seg_id, wire_block, size):
    """Group the leaves' atoms, in storage order, into tiles of at most
    ``TILE_SEGS`` segments, merge the runs of a tile that touch, cut them
    into chunks and the chunks into pieces. Returns the WireGrid's tile
    fields."""
    if isinstance(layout, FlatLayout):
        specs = [(lf.offset, lf.shape, lf.size)
                 for lf in sorted(layout.leaves, key=lambda lf: lf.offset)]
    else:
        specs = [(0, (size,), size)]
    tiles, cur, cur_segs = [], [], 0
    for off, shape, n in specs:
        for runs, segs, values in _leaf_atoms(off, shape, seg_id[off:off + n],
                                              wire_block):
            # a leaf's tail of fewer than 8 values joins the tile before it
            tail = values < 8 and cur_segs + segs <= TILE_SEGS
            if cur and not tail and cur_segs + segs > TILE_SEGS:
                tiles.append((cur, cur_segs))
                cur, cur_segs = [], 0
            cur.append(runs)
            cur_segs += segs
    tiles.append((cur, cur_segs))
    starts, cum, pieces, tile_chunks, seg_base = [], [0], [], [], 0
    for runs, segs in tiles:
        runs = torch.cat(runs)
        runs = runs[torch.argsort(runs[:, 0])].tolist()  # noqa: SWL002 — CPU tensors, read once per layout when the grid is built
        merged = [runs[0]]
        for st, ln in runs[1:]:
            if merged[-1][0] + merged[-1][1] == st:
                merged[-1][1] += ln
            else:
                merged.append([st, ln])
        first = len(starts)
        for st, ln in merged:
            for c in range(0, ln, TILE_CHUNK):
                starts.append(st + c)
                cum.append(cum[-1] + min(TILE_CHUNK, ln - c))
        nc = len(starts) - first
        tile_chunks.append(nc)
        k = -(-nc // PIECE_CHUNKS)
        bounds = [first + nc * q // k for q in range(k + 1)]
        pieces += [(a, b, seg_base, segs) for a, b in
                   zip(bounds[:-1], bounds[1:])]
        seg_base += segs
    chunks = torch.tensor([starts + [0], cum], dtype=torch.int64).T
    # pieces in the order of their first stored position: blocks that run
    # together read neighbouring stretches of each row (the i-slabs of one
    # conv interleave in storage)
    pieces.sort(key=lambda pc: starts[pc[0]])
    lens = chunks[1:, 1] - chunks[:-1, 1]
    pos = (torch.repeat_interleave(chunks[:-1, 0] - chunks[:-1, 1], lens)
           + torch.arange(size))
    # the tile of every stored element, then each tile's segments ascending
    tile_of_chunk = torch.repeat_interleave(torch.arange(len(tiles)),
                                            torch.tensor(tile_chunks))
    nseg = len(torch.bincount(seg_id))
    seg_tile = torch.empty(nseg, dtype=torch.int64)
    seg_tile[seg_id[pos]] = torch.repeat_interleave(tile_of_chunk, lens)
    order = torch.argsort(seg_tile * nseg + torch.arange(nseg))
    grouped = seg_tile[order]
    local = torch.empty(nseg, dtype=torch.int64)
    local[order] = torch.arange(nseg) - torch.searchsorted(grouped, grouped)
    return dict(chunks=chunks.contiguous(),
                pieces=torch.tensor(pieces, dtype=torch.int64),
                tile_segs=order.to(torch.int32),
                lseg=local[seg_id].to(torch.uint8),
                seg32=seg_id.to(torch.int32),
                max_segs=max(segs for _, segs in tiles))


def wire_grid(layout: "FlatLayout | int", wire_dtype: str, wire_block: int,
              device="cpu") -> WireGrid:
    """Build the :class:`WireGrid` of a layout (or of one leaf of P
    elements) once; its tensors live on ``device``."""
    wire_dtype = validate_wire_dtype(wire_dtype)
    wire_block = validate_wire_block(wire_block)
    p = _size(layout)
    if wire_dtype != "int8":
        starts = torch.arange(0, p, wire_block)
        segs = torch.stack([starts, (p - starts).clamp(max=wire_block)], 1)
        return WireGrid(p, wire_dtype, wire_block, segs.to(device), None,
                        None)
    seg_id = torch.empty(p, dtype=torch.int64)
    base = 0
    for off, _, local in _leaves(layout):
        seg_id[off:off + local.numel()] = base + local // wire_block
        base += -(-local.numel() // wire_block)
    counts = torch.bincount(seg_id, minlength=base)
    segs = torch.stack([torch.cumsum(counts, 0) - counts, counts], 1)
    perm = (None if (seg_id[1:] >= seg_id[:-1]).all()
            else torch.argsort(seg_id, stable=True))
    table = _tile_table(layout, seg_id, wire_block, p)
    max_segs = table.pop("max_segs")
    return WireGrid(p, wire_dtype, wire_block, segs.to(device),
                    None if perm is None else perm.to(device),
                    seg_id.to(device), max_segs=max_segs,
                    **{k: v.to(device) for k, v in table.items()})


# ---------------------------------------------------------------------------
# quantized wire: stateless round-trip + error-feedback advance over [N, P]
# ---------------------------------------------------------------------------

#: columns per chunk of the wire's round trip over ``[N, P]``: a
#: full-width LM's temporaries (the residual, its magnitudes, the gathered
#: scales, the quotient) live one chunk at a time
CHUNK = 1 << 24


def _round_trip(x: torch.Tensor, wire: Optional[torch.Tensor],
                grid: WireGrid) -> torch.Tensor:
    """``wire + deq(q(x − wire))`` over a stacked ``[N, P]`` tensor (``wire``
    None: ``deq(q(x))``), f32 out, ``CHUNK`` columns at a time: one pass
    gathers every block's max |x − wire| (a max is exact in any order),
    a second quantizes with it. The same operations, element by element,
    as on the whole tensor at once, so the bits do not depend on
    ``CHUNK``."""
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    wire = None if wire is None else wire.reshape(-1, shape[-1])
    n, p = x.shape
    spans = [(a, min(a + CHUNK, p)) for a in range(0, p, CHUNK)]

    def residual(a, b):
        v = x[:, a:b].to(torch.float32)
        return v if wire is None else v - wire[:, a:b]

    maxabs = None
    if grid.wire_dtype == "int8":
        maxabs = torch.zeros((n, grid.segments.shape[0]), dtype=torch.float32,
                             device=x.device)
        for a, b in spans:
            maxabs.scatter_reduce_(1, grid.seg_id[a:b].expand(n, -1),
                                   residual(a, b).abs(), "amax")
    out = torch.empty((n, p), dtype=torch.float32, device=x.device)
    for a, b in spans:
        v = residual(a, b)
        if maxabs is None:
            deq = quant_dequant_block(v, grid.wire_dtype, grid.wire_block)
        else:
            q, scale = _quantize(v, maxabs.gather(
                1, grid.seg_id[a:b].expand(n, -1)))
            deq = q * scale
        out[:, a:b] = deq if wire is None else wire[:, a:b] + deq
    return out.reshape(shape)


def quant_dequant(v: torch.Tensor, grid: WireGrid) -> torch.Tensor:
    """Stateless wire round-trip of a stacked ``[N, P]`` tensor on the
    per-leaf grid (f32 out): the reference's ``quant_dequant_tree``."""
    return _round_trip(v, None, grid)


def init_wire(payload: torch.Tensor) -> torch.Tensor:
    """Zero wire reference θ̂ shaped like the stacked payload (f32)."""
    return torch.zeros(payload.shape, dtype=torch.float32,
                       device=payload.device)


def wire_effective(payload: torch.Tensor, wire: torch.Tensor,
                   grid: WireGrid) -> torch.Tensor:
    """Error-feedback wire advance: θ̂' = θ̂ + dequant(quant(θ − θ̂)).

    Returns the new reference θ̂' — the effective params every peer
    reconstructs this round and the state carried into the next one. The
    subtraction, the round-trip and the addition are separate roundings
    (no fused multiply-add), the same operations the commit kernel does,
    so the gate sees exactly the bits the kernel commits."""
    return _round_trip(payload, wire, grid)


def wire_residual(payload: torch.Tensor, wire: torch.Tensor) -> torch.Tensor:
    """θ − θ̂: the untransmitted (error-feedback) mass."""
    return payload.to(torch.float32) - wire


# ---------------------------------------------------------------------------
# payload checksum (murmur3 fmix32 over position-salted bits, mod 2³²)
# ---------------------------------------------------------------------------
# uint32 arithmetic in int64 tensors masked to 32 bits. A 32×32-bit product
# would overflow int64, so every multiply goes through `_mul32`, which splits
# the constant into 16-bit halves: each partial product stays below 2⁴⁸.

_M32 = 0xFFFFFFFF


def _mul32(v: torch.Tensor, c: int) -> torch.Tensor:
    """(v · c) mod 2³² for 0 ≤ v < 2³² (int64) and a uint32 constant c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (v * lo + (((v * hi) & 0xFFFF) << 16)) & _M32


def _mix32(v: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on uint32 values held in int64."""
    v = v ^ (v >> 16)
    v = _mul32(v, 0x85EBCA6B)
    v = v ^ (v >> 13)
    v = _mul32(v, 0xC2B2AE35)
    v = v ^ (v >> 16)
    return v


def payload_checksum(payload: torch.Tensor,
                     layout: "FlatLayout | int | RefIndex | None" = None
                     ) -> torch.Tensor:
    """Per-node uint32 checksum of a stacked ``[N, P]`` payload, as ``[N]``
    int64 values in [0, 2³²) — equal to the reference's on the same tree.

    Every element's f32 bits are XORed with a Weyl salt keyed on the
    element's index within its leaf and the leaf's index (both in the
    reference's order: HWIO convs, sorted leaves), avalanche-mixed, and
    summed per node mod 2³². The sum is order-free, so the stored order of
    the buffer does not matter. ``layout`` may be the layout's
    :class:`RefIndex` on the payload's device (built once by the caller)."""
    pf = payload.to(torch.float32).contiguous()
    n, p = pf.shape
    layout = p if layout is None else layout
    if _size(layout) != p:
        raise ValueError(f"layout covers {_size(layout)} values, payload "
                         f"has {p}")
    idx = ref_index(layout, pf.device)
    salt = _mul32(idx.pos + idx.leaf, 0x9E3779B9)
    u = pf.view(torch.int32).to(torch.int64) & _M32
    return _mix32(u ^ salt[None, :]).sum(1) & _M32
