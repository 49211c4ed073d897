"""Flat parameter layout: one contiguous f32 buffer per node axis.

The reference keeps params, AdamW moments and importance statistics as
stacked pytrees (71 leaves for the paper CNN), and its commit launches one
kernel per leaf. The port holds each of them as a single ``[N, P]`` tensor
instead; a :class:`FlatLayout` (leaf path → offset, shape) hands out per-leaf
views into it, so a commit is one kernel launch over ``[N, P]``.

Leaf paths are dotted (``"blocks.0.layers.1.bn.scale"``), the same names
``nn.Module.named_parameters`` gives, and map one to one onto the reference's
tree paths (``["blocks"][0]["layers"][1]["bn"]["scale"]``). A flat payload
dict's ``/``-joined paths (``"head/proj/lora_A"``) are single keys.

**Wide leaves** (a bf16 LM's ``A_log``, ``D``, ``dt_bias`` and adapter
``lora_scale``, which the reference keeps in f32) sit first in a 16-bit
buffer, as f32 values over two slots each: the buffer's **slots** are its
storage, its **values** the numbers the leaves hold, ``n_wide`` f32 values
and ``n_rest`` 16-bit ones. :meth:`FlatLayout.parts` splits a slot buffer
into its f32 prefix (a view) and its 16-bit rest, :meth:`FlatLayout.join`
puts them back, so a loss over :meth:`FlatLayout.unflatten_parts` of the two
parts gives each part its gradient, and the optimizer updates the prefix
as f32 numbers. Whatever treats the params as numbers (moments, importance
statistics, the wire, merges, checksums) works on the ``[..., n_values]``
f32 **value** vector (:meth:`FlatLayout.values`, whose leaves sit in the
order of :attr:`FlatLayout.value_layout`); :meth:`FlatLayout.from_values`
writes values back into slots, each leaf in its own dtype. Without wide
leaves slots and values coincide.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class Leaf:
    path: str
    shape: Tuple[int, ...]
    offset: int
    wide: bool = False   # f32 values in two slots of a 16-bit buffer
    conv: bool = False   # a conv weight, stored OIHW (HWIO in the reference)

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def slots(self) -> int:
        return 2 * self.size if self.wide else self.size

    @property
    def ref_axes(self) -> Tuple[int, ...]:
        """The stored leaf's axes in the reference's order: the stored
        leaf transposed by them is the reference's (OIHW → HWIO for a
        conv, no change otherwise)."""
        return (2, 3, 1, 0) if self.conv else tuple(range(len(self.shape)))


class _DtypeView(torch.autograd.Function):
    """``x.view(dtype)`` (a dtype of another width reinterprets the last
    dim) with a ``torch.func.vmap`` rule: not every PyTorch release has a
    batching rule for ``aten::view.dtype``, and the engine vmaps the train
    step and the gate over the node axis. It carries no gradient."""

    @staticmethod
    def forward(x, dtype):
        return x.view(dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, grad):
        return None, None

    @staticmethod
    def vmap(info, in_dims, x, dtype):
        return _DtypeView.apply(x.movedim(in_dims[0], 0), dtype), 0


def view_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.view(dtype) if x.dtype == dtype else _DtypeView.apply(x, dtype)


class FlatLayout:
    """Fixed leaf order over a flat parameter vector of length ``size``
    (slots; ``wide`` names the leaves held as f32 in a 16-bit buffer,
    ``convs`` the conv weights, stored OIHW where the reference keeps
    HWIO; any other leaf is stored as the reference keeps it)."""

    def __init__(self, leaves: Sequence[Tuple[str, Sequence[int]]],
                 wide: Iterable[str] = (), convs: Iterable[str] = ()):
        wide, convs = frozenset(wide), frozenset(convs)
        leaves = [Leaf(path, tuple(int(s) for s in shape), 0, path in wide,
                       path in convs)
                  for path, shape in leaves]
        if wide - {leaf.path for leaf in leaves}:
            raise ValueError(f"wide leaves {sorted(wide)} not in the layout")
        if convs - {leaf.path for leaf in leaves if len(leaf.shape) == 4}:
            raise ValueError(f"conv leaves {sorted(convs)} are not 4-D "
                             f"leaves of the layout")
        self.convs = convs
        # buffer order: the wide leaves first (even offsets), then the rest
        self._order = sorted(range(len(leaves)), key=lambda i: not
                             leaves[i].wide)
        off = 0
        for i in self._order:
            leaves[i] = dataclasses.replace(leaves[i], offset=off)
            off += leaves[i].slots
        self.leaves: Tuple[Leaf, ...] = tuple(leaves)
        self.wide = wide
        self._sizes = [leaves[i].slots for i in self._order]
        self.n_wide = sum(leaf.size for leaf in leaves if leaf.wide)
        self.n_rest = sum(leaf.size for leaf in leaves if not leaf.wide)
        self.n_values = self.n_wide + self.n_rest
        self.pad = 0
        if wide and off % 2:
            self._sizes.append(1)
            self.pad = 1
            off += 1
        self.size = off
        self._value_layout = None

    @property
    def value_layout(self) -> "FlatLayout":
        """The layout of the value vector: the same leaves in storage order,
        one f32 value each (this layout itself when no leaf is wide)."""
        if not self.wide:
            return self
        if self._value_layout is None:
            self._value_layout = FlatLayout(
                [(self.leaves[i].path, self.leaves[i].shape)
                 for i in self._order], convs=self.convs)
        return self._value_layout

    def parts(self, flat: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """A slot buffer ``[..., P]`` → ``(flat,)``, or with wide leaves
        ``(prefix [..., n_wide] f32, rest [..., n_rest])`` (views; the pad
        slot left out)."""
        if not self.wide:
            return (flat,)
        w = 2 * self.n_wide
        return (view_dtype(flat[..., :w], torch.float32),
                flat[..., w:w + self.n_rest])

    def join(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Inverse of :meth:`parts`: a new slot buffer in the rest's
        dtype."""
        if not self.wide:
            return parts[0]
        wide, rest = parts
        pieces = [view_dtype(wide.to(torch.float32).contiguous(), rest.dtype),
                  rest]
        if self.pad:
            pieces.append(rest.new_zeros(rest.shape[:-1] + (1,)))
        return torch.cat(pieces, dim=-1)

    def values(self, flat: torch.Tensor) -> torch.Tensor:
        """A slot buffer → its f32 value vector ``[..., n_values]`` (the
        buffer itself when it is f32 without wide leaves). Each part is
        cast straight into the one new tensor."""
        if not self.wide:
            return flat.to(torch.float32)
        out = flat.new_empty(flat.shape[:-1] + (self.n_values,),
                             dtype=torch.float32)
        wide, rest = self.parts(flat)
        out[..., :self.n_wide].copy_(wide)
        out[..., self.n_wide:].copy_(rest)
        return out

    def from_values(self, values: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
        """Inverse of :meth:`values`: wide leaves as f32 bits, the others
        cast to ``dtype``, straight into the one new slot buffer."""
        if not self.wide:
            return values.to(dtype)
        out = values.new_empty(values.shape[:-1] + (self.size,), dtype=dtype)
        w = 2 * self.n_wide
        out[..., :w].view(torch.float32).copy_(values[..., :self.n_wide])
        out[..., w:w + self.n_rest].copy_(values[..., self.n_wide:])
        if self.pad:
            out[..., -1] = 0
        return out

    @classmethod
    def of_module(cls, module: torch.nn.Module) -> "FlatLayout":
        """The layout of a module's params; its 4-D params are conv
        weights (OIHW, PyTorch's layout)."""
        named = list(module.named_parameters())
        return cls([(name, p.shape) for name, p in named],
                   convs=[name for name, p in named if p.dim() == 4])

    @classmethod
    def of_payload(cls, payload: Dict[str, torch.Tensor]) -> "FlatLayout":
        """The layout of a flat payload dict (``{"head/out/b": ...}``, the
        heterogeneous swarm's wire payload): its paths sorted, the
        reference's leaf order."""
        return cls([(k, tuple(payload[k].shape)) for k in sorted(payload)])

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``[..., P]`` → {path: ``[..., *shape]`` view}. One ``split``, so the
        gradient of a loss over the views comes back as one flat ``[..., P]``
        tensor (the split's backward is a single concatenation). With wide
        leaves a 16-bit buffer is read as slots (the f32 views carry no
        gradient: differentiate :meth:`unflatten_parts` instead) and an f32
        ``[..., n_values]`` buffer as values."""
        if not self.wide:
            parts = flat.split(self._sizes, dim=-1)
            return {self.leaves[i].path: part.reshape(
                flat.shape[:-1] + self.leaves[i].shape)
                for i, part in zip(self._order, parts)}
        if flat.element_size() == 4 and flat.shape[-1] == self.n_values:
            return self.value_layout.unflatten(flat)
        if flat.element_size() != 2:
            raise ValueError(f"a layout with wide leaves reads a 16-bit "
                             f"slot buffer or an f32 value vector, got "
                             f"{flat.dtype} [..., {flat.shape[-1]}]")
        return self.unflatten_parts(self.parts(flat))

    def unflatten_parts(self, parts: Sequence[torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """:meth:`parts` (``(wide, rest)``, or ``(flat,)``) → {path:
        view}; a loss over the views gives each part its gradient."""
        if not self.wide:
            return self.unflatten(parts[0])
        wide, rest = parts
        lead = rest.shape[:-1]
        views = {}
        for kind, part in ((True, wide), (False, rest)):
            order = [i for i in self._order if self.leaves[i].wide == kind]
            pieces = part.split([self.leaves[i].size for i in order], dim=-1)
            for i, piece in zip(order, pieces):
                leaf = self.leaves[i]
                views[leaf.path] = piece.reshape(lead + leaf.shape)
        return {leaf.path: views[leaf.path] for leaf in self.leaves}

    def flatten(self, params: Dict[str, torch.Tensor],
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """{path: tensor ``[*lead, *shape]``} → contiguous ``[*lead, P]``,
        in ``dtype`` when given (wide leaves as f32 bits)."""
        if self.wide and (dtype is None or dtype.itemsize != 2):
            raise ValueError("a layout with wide leaves flattens into a "
                             "16-bit dtype")
        parts = []
        for i in self._order:
            leaf = self.leaves[i]
            t = params[leaf.path]
            t = t.reshape(t.shape[:t.dim() - len(leaf.shape)] + (-1,))
            if leaf.wide:
                t = t.to(torch.float32).contiguous().view(dtype)
            elif dtype is not None:
                t = t.to(dtype)
            parts.append(t)
        if len(self._sizes) > len(parts):      # the pad slot
            parts.append(parts[-1].new_zeros(parts[-1].shape[:-1] + (1,)))
        return torch.cat(parts, dim=-1)


# ---------------------------------------------------------------------------
# a rank's shard of a node: inner (model) sharding on the gossip backend
# ---------------------------------------------------------------------------

def _storage_views(layout: FlatLayout, t: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """{path: writable view ``[..., *shape]``} of a slot buffer or of the
    f32 value vector of ``layout`` (plain views: a wide leaf of a 16-bit
    buffer is its f32 region, viewed, not a copy)."""
    lead = t.shape[:-1]
    if layout.wide and t.element_size() == 2 and t.shape[-1] == layout.size:
        w = 2 * layout.n_wide
        wide = t[..., :w].view(torch.float32)
        rest = t[..., w:w + layout.n_rest]
        out = {}
        for leaf in layout.leaves:
            region, off = ((wide, leaf.offset // 2) if leaf.wide
                           else (rest, leaf.offset - w))
            out[leaf.path] = region[..., off:off + leaf.size].view(
                lead + leaf.shape)
        return out
    values = layout.value_layout
    if t.shape[-1] != values.size:
        raise ValueError(f"a tensor [..., {t.shape[-1]}] is neither the "
                         f"slots ({layout.size}) nor the values "
                         f"({values.size}) of the layout")
    return {leaf.path: t[..., leaf.offset:leaf.offset + leaf.size].view(
        lead + leaf.shape) for leaf in values.leaves}


class ShardLayout:
    """What one rank holds of a node whose leaves are sharded over the
    ``data`` and ``model`` axes of the swarm mesh (the gossip backend's
    inner sharding; `repro_torch.sharding.rules.param_specs` makes the
    specs).

    ``specs`` maps a leaf path to a spec, one entry per dimension of the
    reference's leaf (None, an axis name, or a tuple of names, major
    first); ``sizes`` the inner axes' sizes and ``coords`` this rank's
    index on each. A dimension is cut into equal blocks along the
    reference's axis order (through ``Leaf.ref_axes``: a conv is HWIO
    there), and the rank keeps its block. A leaf without a spec, an axis of
    size 1 or a dimension its axes do not divide is replicated.

    :attr:`local` is the :class:`FlatLayout` of the rank's buffer: every
    leaf's block, contiguous, in the full layout's order, with its wide and
    conv marks, so a slot buffer, its value vector and the int8 wire's
    per-leaf block grid (`repro_torch.core.gossip.padded_grid`) of the
    shard are those of an ordinary layout. :meth:`shard` takes a tensor's
    shard, :meth:`gather` puts a node's shards back together: every
    per-node tensor (params, moments, statistics, wire references) goes
    through this one mapping, its width telling slots from values."""

    def __init__(self, layout: FlatLayout, specs: Dict[str, Sequence],
                 sizes: Dict[str, int], coords: Dict[str, int]):
        self.full = layout
        self.specs = dict(specs)
        self.sizes = dict(sizes)
        self.coords = dict(coords)
        self.group_size = 1
        for s in self.sizes.values():
            self.group_size *= s
        self.cuts = {leaf.path: self._cuts(leaf, self.coords)
                     for leaf in layout.leaves}
        self._cut_axes = {leaf.path: self._axes(leaf)
                          for leaf in layout.leaves}
        shapes = []
        for leaf in layout.leaves:
            shape = list(leaf.shape)
            for dim, _, length in self.cuts[leaf.path]:
                shape[dim] = length
            shapes.append((leaf.path, tuple(shape)))
        self.local = FlatLayout(shapes, wide=layout.wide, convs=layout.convs)
        self.sharded = any(self.cuts.values())

    def _cuts(self, leaf: Leaf, coords: Dict[str, int]):
        """``((stored dim, start, length), ...)`` of the block of ``leaf``
        a rank at ``coords`` holds."""
        spec = tuple(self.specs.get(leaf.path) or ())
        out = []
        for k, ax in enumerate(spec[:len(leaf.shape)]):
            if ax is None:
                continue
            n, idx = 1, 0
            for a in (ax if isinstance(ax, (tuple, list)) else (ax,)):
                size = self.sizes.get(a, 1)
                n, idx = n * size, idx * size + coords.get(a, 0)
            dim = leaf.ref_axes[k]
            length = leaf.shape[dim] // n
            if n > 1 and leaf.shape[dim] % n == 0:
                out.append((dim, idx * length, length))
        return tuple(out)

    def _axes(self, leaf: Leaf):
        """The inner axes that cut ``leaf`` (the axes of its cut
        dimensions)."""
        spec = tuple(self.specs.get(leaf.path) or ())
        out = set()
        for k, ax in enumerate(spec[:len(leaf.shape)]):
            names = () if ax is None else (
                ax if isinstance(ax, (tuple, list)) else (ax,))
            n = 1
            for a in names:
                n *= self.sizes.get(a, 1)
            if n > 1 and leaf.shape[leaf.ref_axes[k]] % n == 0:
                out.update(a for a in names if self.sizes.get(a, 1) > 1)
        return out

    def owns(self, path: str) -> bool:
        """Whether this rank counts its block of ``path`` in a sum over
        the shard group: the ranks that hold one block differ only on the
        axes that do not cut the leaf, and the one at 0 on each of them
        counts it."""
        return all(self.coords.get(a, 0) == 0 for a in self.sizes
                   if a not in self._cut_axes[path])

    def coords_of(self, g: int) -> Dict[str, int]:
        """The coordinates of rank ``g`` of a node's shard group (row-major
        over the inner axes in ``sizes`` order)."""
        out = {}
        for a in reversed(list(self.sizes)):
            g, out[a] = divmod(g, self.sizes[a])
        return out

    def _layouts(self, t: torch.Tensor, local: bool):
        """``(full, local)`` layouts of ``t`` read at its local (or full)
        width: the slot layouts, or the value layouts."""
        lay = self.local if local else self.full
        slots = t.shape[-1] == lay.size and (not lay.wide
                                              or t.element_size() == 2)
        if slots:
            return self.full, self.local
        return self.full.value_layout, self.local.value_layout

    @staticmethod
    def _block(view: torch.Tensor, cuts, lead: int) -> torch.Tensor:
        for dim, start, length in cuts:
            view = view.narrow(lead + dim, start, length)
        return view

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """A node tensor ``[..., P]`` (slots, or values ``[...,
        n_values]``) → this rank's shard, a new contiguous tensor."""
        full, local = self._layouts(t, local=False)
        out = t.new_empty(t.shape[:-1] + (local.size,))
        if local.pad:
            out[..., -1] = 0
        lead = t.dim() - 1
        src = _storage_views(full, t)
        for path, dst in _storage_views(local, out).items():
            dst.copy_(self._block(src[path], self.cuts[path], lead))
        return out

    def gather(self, t: torch.Tensor, view, kind="shard_gather"
               ) -> torch.Tensor:
        """This rank's shard ``[R, W]`` → the node tensor ``[R, P]``: one
        all_gather of the shards over the node's shard group ``view``
        (`repro_torch.launch.mesh.SwarmMesh.shard_view`; ``kind`` the byte
        count's name, None for none), each rank's block written where its
        coordinates put it (a replicated block once)."""
        from repro_torch.core import gossip
        return self.assemble(gossip.all_gather(view, t, kind=kind).view(
            (self.group_size,) + tuple(t.shape)))

    def assemble(self, parts: torch.Tensor) -> torch.Tensor:
        """The shards of every rank of a node's shard group, ``[G, ...,
        W]`` in group order (:meth:`coords_of`), → the node tensor
        ``[..., P]``."""
        full, local = self._layouts(parts[0], local=True)
        out = parts.new_empty(parts.shape[1:-1] + (full.size,))
        if full.pad:
            out[..., -1] = 0
        dst = _storage_views(full, out)
        seen = {path: set() for path in dst}
        for g in range(self.group_size):
            coords = self.coords_of(g)
            src = _storage_views(local, parts[g])
            for leaf in self.full.leaves:
                cuts = self._cuts(leaf, coords)
                if cuts in seen[leaf.path]:
                    continue
                seen[leaf.path].add(cuts)
                self._block(dst[leaf.path], cuts, parts.dim() - 2).copy_(
                    src[leaf.path])
        return out

    def share(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's share of the sum of a node tensor's values from its
        shard ``[..., W]``: each leaf's sum weighted by its blocks over the
        shard group's size, so the shard group's shares add up to the
        node's sum with every block counted once (f32 scalar)."""
        _, local = self._layouts(t, local=True)
        views = _storage_views(local, t)
        total = t.new_zeros((), dtype=torch.float32)
        for leaf in self.full.leaves:
            blocks = 1
            for dim, _, length in self.cuts[leaf.path]:
                blocks *= leaf.shape[dim] // length
            total = total + views[leaf.path].to(torch.float32).sum() * (
                blocks / self.group_size)
        return total

    def sub(self, layout: FlatLayout) -> "ShardLayout":
        """The same specs over another layout of the same leaves (a
        payload's: the adapters carved out of the values)."""
        return ShardLayout(layout, self.specs, self.sizes, self.coords)

    def __repr__(self) -> str:
        return (f"ShardLayout({self.local.size} of {self.full.size} slots, "
                f"coords={self.coords}, sizes={self.sizes})")


class LayerCut:
    """Layer ``i`` of scan-stacked leaves (``stacked``: each leaf's stored
    dim 0 is the layer axis), or a set of leaves whole, as the ranks of a
    node's shard group hold it under a :class:`ShardLayout`: what a split
    step (`repro_torch.models.gather`) gathers just before it runs the
    layer, and where the layer's gradient goes.

    The rules may cut a stacked leaf's layer axis (they cut scan-stacked
    leaves one dimension early: Mamba2's ``layers.ssm.in_proj.w`` ``[L, d,
    f]`` is ``("data", "model", None)``), so a rank holds a **span** of the
    layers of such a leaf, and of its other dimensions a block. A rank's
    **contribution** to layer ``i`` is its block of each cut leaf's layer
    (zeros of that size where its span does not hold ``i``), each leaf's
    bytes padded to 8, in one buffer: one all_gather over the shard group
    moves every cut leaf's layer (:attr:`gathered` lists them; a leaf no
    axis cuts is whole on every rank and moves nothing). :meth:`gather`
    assembles the whole layer from every rank's contribution, each block
    once, from a rank whose span holds ``i``; :meth:`shard_of` takes a
    whole-layer tensor to this rank's block. A leaf's bytes travel as
    they are, so a gathered layer is the node's, bit for bit.

    The way back (:meth:`reduce`): the ranks of one model index and every
    data index (the node's **data group**) computed their shares of the
    same layer's cotangents, and each keeps only its blocks of their sum.
    :meth:`routes` sorts a layer's leaves by how the ``data`` axis cuts
    them within that group: a dimension of the layer (each data rank a
    block of its own: one reduce_scatter), only the layer axis (one data
    rank holds the layer: a reduce to it), or nothing (every data rank the
    same block: an all_reduce of that block).

    With ``compute`` (tensor parallelism: ``compute(path, shape, m)`` the
    intervals of a per-layer leaf that model rank ``m`` computes with,
    `repro_torch.sharding.rules.compute_cut`) a rank receives only its
    **compute block** of each leaf (:attr:`cshapes`), never the whole
    layer: :meth:`gather_compute` moves, over the shard group, each piece
    of a rank's compute block that it does not store from one rank that
    stores it (one all_to_all), and :meth:`reduce_compute` takes the way
    back: every rank sends each piece of its compute block's cotangent to
    every rank that stores it, and each sums what it receives, in the
    order of the senders' group indices (so a block's replicas agree bit
    for bit). The model ranks' cotangents are their shares of the leaf's
    gradient (`repro_torch.sharding.tensor`): a piece that several model
    ranks compute with (a replicated leaf) sums over them, a piece of a
    cut leaf over the data ranks alone.

    ``reduce_axes`` (``("data",)`` by default) names the axes of the
    shard group whose ranks took rows of their own, the group
    :meth:`reduce` sums over: ``("data", "model")`` under the dry run's
    ``zero3`` profile (the whole shard group)."""

    def __init__(self, shard: ShardLayout, paths: Sequence[str],
                 stacked: bool, dtypes: Dict[str, torch.dtype],
                 compute=None, reduce_axes: Sequence[str] = ("data",)):
        leaves = {lf.path: lf for lf in shard.full.leaves}
        self.paths = tuple(paths)
        self.stacked = stacked
        self.dtypes = tuple(dtypes[p] for p in self.paths)
        self.shapes = []
        for p in self.paths:
            lf = leaves[p]
            if stacked and lf.ref_axes[0] != 0:
                raise ValueError(f"{p}: a stacked leaf's stored dim 0 is "
                                 "its layer axis")
            self.shapes.append(lf.shape[1:] if stacked else lf.shape)
        self.group_size = shard.group_size
        self._plans = [self._plan(shard, leaves, shard.coords_of(g))
                       for g in range(shard.group_size)]
        # the shard-group indices of this rank's data group (the ranks of
        # its other coordinates), by their index over ``reduce_axes``
        own = {a: c for a, c in shard.coords.items()
               if a not in reduce_axes}
        self._data_group = sorted(
            (g for g in range(shard.group_size)
             if all(shard.coords_of(g).get(a, 0) == c
                    for a, c in own.items())),
            key=lambda g: tuple(shard.coords_of(g).get(a, 0)
                                for a in reduce_axes))
        self._routes = {}
        self.plan = self._plan(shard, leaves, shard.coords)
        #: the leaves a cut moves (the others are whole on every rank)
        self.gathered = tuple(k for k, (span, cuts, _) in enumerate(self.plan)
                              if span is not None or cuts)
        self.offsets, off = {}, 0
        for k in self.gathered:
            self.offsets[k] = off
            off += -(-self._numel(k) * self.dtypes[k].itemsize // 8) * 8
        self.nbytes = off
        self.compute = compute
        if compute is not None:
            self._init_compute(shard)

    def _numel(self, k: int) -> int:
        n = 1
        for b in self.plan[k][2]:
            n *= b
        return n

    def _plan(self, shard, leaves, coords):
        """For each leaf, ``(span, cuts, block)`` of a rank at
        ``coords``: the ``(start, length)`` of the layers it holds (None:
        all, or not stacked), the cuts of a layer's dims and the block's
        shape."""
        out = []
        for p, shape in zip(self.paths, self.shapes):
            span, cuts = None, []
            for dim, start, length in shard._cuts(leaves[p], coords):
                if self.stacked and dim == 0:
                    span = (start, length)
                else:
                    cuts.append((dim - 1 if self.stacked else dim, start,
                                 length))
            block = list(shape)
            for dim, _, length in cuts:
                block[dim] = length
            out.append((span, tuple(cuts), tuple(block)))
        return out

    @staticmethod
    def _holds(span, i) -> bool:
        return span is None or span[0] <= i < span[0] + span[1]

    def holds(self, k: int, i: int) -> bool:
        """Whether this rank holds leaf ``k``'s layer ``i``."""
        return self._holds(self.plan[k][0], i)

    def local_index(self, k: int, i: int) -> int:
        """Layer ``i``'s index in this rank's span of leaf ``k``."""
        span = self.plan[k][0]
        return i if span is None else i - span[0]

    def contribution(self, local, i: int, device) -> torch.Tensor:
        """This rank's bytes of layer ``i`` (``local[k]``: its block of
        leaf ``k``'s layer, None where it does not hold it)."""
        buf = torch.zeros(self.nbytes, dtype=torch.uint8, device=device)
        for k, off in self.offsets.items():
            t = local[k]
            if t is not None:
                b = t.detach().contiguous().reshape(-1).view(torch.uint8)
                buf[off:off + b.numel()] = b
        return buf

    def assemble(self, parts: torch.Tensor, i: int, local, device=None):
        """Every rank's contribution ``[G, nbytes]`` (group order, on any
        device) → the whole layer ``i`` on ``device`` (None: ``parts``'),
        one tensor a leaf (a leaf no axis cuts is this rank's ``local``
        tensor, detached); each block is copied once."""
        device = parts.device if device is None else device
        out = [local[k].detach() if k not in self.offsets
               else torch.empty(shape, dtype=dtype, device=device)
               for k, (shape, dtype) in enumerate(zip(self.shapes,
                                                      self.dtypes))]
        seen = {k: set() for k in self.gathered}
        for g, plan in enumerate(self._plans):
            for k in self.gathered:
                span, cuts, block = plan[k]
                if not self._holds(span, i) or cuts in seen[k]:
                    continue
                seen[k].add(cuts)
                off = self.offsets[k]
                src = parts[g, off:off + self._numel(k)
                            * self.dtypes[k].itemsize]
                ShardLayout._block(out[k], cuts, 0).copy_(
                    src.view(self.dtypes[k]).view(block))
        return out

    def gather(self, local, i: int, view, device, kind="layer_gather"):
        """The whole layer ``i`` from this rank's blocks ``local`` (see
        :meth:`contribution`): one all_gather over the shard group
        ``view`` (``kind`` the byte count's name), none when no leaf is
        cut. On gloo the gathered contributions stay in host memory and
        only the blocks the layer keeps go to ``device``."""
        from repro_torch.core import gossip
        parts = None
        if self.nbytes:
            parts = gossip.all_gather(view, self.contribution(
                local, i, device), kind=kind, staged=True).view(
                    self.group_size, self.nbytes)
        else:
            parts = torch.empty((self.group_size, 0), dtype=torch.uint8,
                                device=device)
        return self.assemble(parts, i, local, device)

    def shard_of(self, k: int, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole-layer tensor of leaf ``k`` (a
        view)."""
        return ShardLayout._block(whole, self.plan[k][1], 0)

    def routes(self, i: int):
        """How layer ``i``'s cotangents reach the blocks this rank's data
        group keeps: ``(scatter, owners, whole)``. ``scatter`` the leaves
        of which every data rank holds a block of its own, ``owners`` ``{d:
        leaves}`` those of which only data rank ``d`` holds layer ``i``,
        ``whole`` those of which every data rank holds the same block; a
        leaf none of them holds is in none (its cotangent is dropped)."""
        if i in self._routes:
            return self._routes[i]
        scatter, owners, whole = [], {}, []
        for k in range(len(self.paths)):
            held = [(d, self._plans[g][k][1])
                    for d, g in enumerate(self._data_group)
                    if self._holds(self._plans[g][k][0], i)]
            if not held:
                continue
            cuts = {c for _, c in held}
            if len(held) == 1:
                owners.setdefault(held[0][0], []).append(k)
            elif len(held) == len(self._data_group) and len(cuts) == 1:
                whole.append(k)
            elif len(held) == len(self._data_group) == len(cuts):
                scatter.append(k)
            else:
                raise ValueError(f"{self.paths[k]}: {len(held)} of "
                                 f"{len(self._data_group)} data ranks hold "
                                 f"layer {i} in {len(cuts)} blocks")
        self._routes[i] = (scatter, owners, whole)
        return self._routes[i]

    def reduce(self, cots, i: int, view, device, replica=None,
               whole_view=None) -> Dict[int, torch.Tensor]:
        """The sums over the data group ``view`` of the whole-layer
        cotangents ``cots`` (one a leaf, every data rank's), cut to this
        rank's blocks: ``{k: f32 block}`` for each leaf whose layer ``i``
        it holds. Each rank hands over only blocks the group keeps (see
        :meth:`routes`): the leaves of ``scatter`` as rank-ordered
        segments of one f32 buffer, one reduce_scatter
        (``grad_reduce_scatter``); each owner's leaves in one buffer, one
        reduce to it (``grad_reduce_owner``); the ``whole`` leaves' blocks
        in one all_reduce (``grad_reduce``) over ``whole_view`` (None:
        ``view``).

        With ``replica`` (the ranks outside ``view`` that hold the same
        blocks and computed rows of their own: the dry run's ``dp``
        profile, whose blocks every model rank repeats) the blocks of
        ``scatter`` and the owner's are then summed over it in one
        all_reduce (``grad_replica``); the ``whole`` leaves, which every
        rank of the node holds, reach their sum over ``whole_view`` (the
        node's every rank) at once."""
        from repro_torch.core import gossip
        scatter, owners, whole = self.routes(i)
        me = view.rank
        out = {}

        def blocks(ks, g):
            return [ShardLayout._block(cots[k], self._plans[g][k][1], 0)
                    for k in ks]

        def flat(parts):
            return torch.cat([t.reshape(-1).to(torch.float32)
                              for t in parts])

        def keep(ks, summed):
            off = 0
            for k in ks:
                shape = self.plan[k][2]
                n = self._numel(k)
                out[k] = summed[off:off + n].view(shape)
                off += n

        if scatter:
            segs = [flat(blocks(scatter, g)) for g in self._data_group]
            width = max(t.numel() for t in segs)
            buf = torch.zeros((len(segs), width), dtype=torch.float32,
                              device=device)
            for row, t in zip(buf, segs):
                row[:t.numel()] = t
            del segs
            keep(scatter, gossip.reduce_scatter(view, buf,
                                                kind="grad_reduce_scatter"))
        for d in sorted(owners):
            ks = owners[d]
            summed = gossip.reduce(view, flat(blocks(
                ks, self._data_group[d])), d, kind="grad_reduce_owner")
            if d == me:
                keep(ks, summed)
        if replica is not None:
            ks = scatter + owners.get(me, [])
            if ks:
                keep(ks, gossip.all_reduce(replica, flat(
                    [out[k] for k in ks]), kind="grad_replica"))
        if whole:
            keep(whole, gossip.all_reduce(
                view if whole_view is None else whole_view,
                flat(blocks(whole, self._data_group[me])),
                kind="grad_reduce"))
        return out

    # -- tensor parallelism: compute blocks ---------------------------------

    def _init_compute(self, shard: ShardLayout) -> None:
        g_all = range(self.group_size)
        self._coords = [shard.coords_of(g) for g in g_all]
        self._me = self._coords.index(
            {a: shard.coords.get(a, 0) for a in shard.sizes})
        self._cblocks = [[self.compute(p, shape, c.get("model", 0))
                          for p, shape in zip(self.paths, self.shapes)]
                         for c in self._coords]
        #: this rank's compute block's shape, a leaf each
        self.cshapes = [tuple(sum(n for _, n in ivs) for ivs in blk)
                        for blk in self._cblocks[self._me]]
        self._cplans = {}

    def _box(self, g: int, k: int):
        """Rank ``g``'s stored block of leaf ``k``'s layer: ``(start,
        length)`` a dim."""
        box = [(0, n) for n in self.shapes[k]]
        for dim, start, length in self._plans[g][k][1]:
            box[dim] = (start, length)
        return box

    def _pieces(self, box, blk):
        """The pieces of compute block ``blk`` (intervals a dim) that the
        stored ``box`` holds: ``(slices in the stored block, slices in the
        compute block, shape)``, in order."""
        dims = []
        for (a, la), ivs in zip(box, blk):
            cuts, off = [], 0
            for c, lc in ivs:
                lo, hi = max(a, c), min(a + la, c + lc)
                if lo < hi:
                    cuts.append((lo - a, off + lo - c, hi - lo))
                off += lc
            if not cuts:
                return []
            dims.append(cuts)
        out = [((), (), ())]
        for cuts in dims:
            out = [(s + (slice(a, a + n),), d + (slice(b, b + n),),
                    sh + (n,)) for s, d, sh in out for a, b, n in cuts]
        return out

    def _cplan(self, i: int, split=None):
        """Layer ``i``'s routes from this rank's side. The gather (``split``
        None): ``send[r]`` ``(k, stored slices)`` to rank ``r``,
        ``recv[r]`` ``(k, compute slices, shape)`` from it, ``local``
        ``(k, stored slices, compute slices)``. The way back (``split``:
        whether the data ranks computed rows of their own; if not, a
        stored block sums the ranks of its own data index only):
        ``send[h]`` ``(k, compute slices)``, ``recv[r]`` ``(k, stored
        slices, shape)``, ``local`` ``(k, compute slices, stored
        slices)``."""
        key = (i, split)
        if key in self._cplans:
            return self._cplans[key]
        me, n = self._me, self.group_size
        send = [[] for _ in range(n)]
        recv = [[] for _ in range(n)]
        local = []
        data = [c.get("data", 0) for c in self._coords]
        # each leaf's distinct stored blocks of layer i, and their holders
        blocks = []
        for k in range(len(self.paths)):
            held = {}
            for g in range(n):
                if self._holds(self._plans[g][k][0], i):
                    held.setdefault(self._plans[g][k][1], []).append(g)
            blocks.append([held[c] for c in sorted(held)])
        # toward another rank only a block this rank holds moves: the rest
        # of its routes are between other ranks
        mine = [[hs for hs in bl if me in hs] for bl in blocks]
        for r in range(n):
            for k in range(len(self.paths)):
                for hs in blocks[k] if r == me else mine[k]:
                    pieces = self._pieces(self._box(hs[0], k),
                                          self._cblocks[r][k])
                    if not pieces:
                        continue
                    if split is None:
                        src = r if r in hs else hs[r % len(hs)]
                        for sl, cl, shape in pieces:
                            if src == r == me:
                                local.append((k, sl, cl))
                            elif src == me:
                                send[r].append((k, sl))
                            elif r == me:
                                recv[src].append((k, cl, shape))
                        continue
                    for h in hs:
                        if not split and data[h] != data[r]:
                            continue
                        for sl, cl, shape in pieces:
                            if h == r == me:
                                local.append((k, cl, sl))
                            elif r == me:
                                send[h].append((k, cl))
                            elif h == me:
                                recv[r].append((k, sl, shape))
        self._cplans[key] = (send, recv, local)
        return self._cplans[key]

    def gather_compute(self, local, i: int, view, device,
                       kind="layer_gather"):
        """This rank's compute block of layer ``i`` (one tensor a leaf)
        from its stored blocks ``local`` (None where it does not hold the
        leaf's layer): one all_to_all over the shard group ``view``, which
        counts the bytes this rank sends (``kind``)."""
        from repro_torch.core import gossip
        send, recv, own = self._cplan(i)
        out = [torch.empty(shape, dtype=dtype, device=device)
               for shape, dtype in zip(self.cshapes, self.dtypes)]
        for k, sl, cl in own:
            out[k][cl].copy_(local[k].detach()[sl])
        segs, sizes = [], []
        for pieces in send:
            parts = [local[k].detach()[sl].contiguous().view(-1).view(
                torch.uint8) for k, sl in pieces]
            segs += parts
            sizes.append(sum(t.numel() for t in parts))
        want = [sum(_prod(shape) * self.dtypes[k].itemsize
                    for k, _, shape in pieces) for pieces in recv]
        buf = torch.cat(segs) if segs else torch.empty(
            0, dtype=torch.uint8, device=device)
        del segs
        got = gossip.all_to_all_v(view, buf, sizes, want, kind=kind)
        del buf
        off = 0
        for pieces in recv:
            for k, cl, shape in pieces:
                dtype = self.dtypes[k]
                nb = _prod(shape) * dtype.itemsize
                seg = got[off:off + nb]
                if off % dtype.itemsize:
                    seg = seg.clone()
                out[k][cl].copy_(seg.view(dtype).view(shape))
                off += nb
        return out

    def reduce_compute(self, cots, i: int, view, device, split: bool,
                       kind="grad_to_shard") -> Dict[int, torch.Tensor]:
        """The gradient of this rank's stored blocks of layer ``i`` from
        every rank's compute-block cotangents (``cots``, this rank's, one
        a leaf): ``{k: f32 stored block}`` summed in the senders' order,
        over the shard group, or with ``split`` False over the ranks of
        this rank's data index. One all_to_all of f32 pieces; ``kind``
        counts what this rank sends."""
        from repro_torch.core import gossip
        send, recv, own = self._cplan(i, bool(split))
        f32 = torch.float32
        segs, sizes, flat = [], [], {}

        def piece(k, cl):      # a piece goes to every holder: cast it once
            key = (k, tuple((x.start, x.stop) for x in cl))
            if key not in flat:
                flat[key] = cots[k][cl].to(f32).reshape(-1)
            return flat[key]

        for pieces in send:
            parts = [piece(k, cl) for k, cl in pieces]
            segs += parts
            sizes.append(sum(t.numel() for t in parts))
        want = [sum(_prod(shape) for _, _, shape in pieces)
                for pieces in recv]
        buf = torch.cat(segs) if segs else torch.empty(0, dtype=f32,
                                                       device=device)
        del segs, flat
        got = gossip.all_to_all_v(view, buf, sizes, want, kind=kind)
        del buf
        acc = {k: torch.zeros(self.plan[k][2], dtype=f32, device=device)
               for k in range(len(self.paths)) if self.holds(k, i)}
        # each stored region's view once; every piece one add_ into it, in
        # the senders' order (a sender's segment moved to the device once)
        dst = {}

        def into(k, sl):
            key = (k, tuple((x.start, x.stop) for x in sl))
            if key not in dst:
                dst[key] = acc[k][sl]
            return dst[key]

        segs = got.split(want) if len(want) else []
        for r in range(self.group_size):
            if r == self._me:
                for k, cl, sl in own:
                    into(k, sl).add_(cots[k][cl].to(f32))
                continue
            if not recv[r]:
                continue
            parts = segs[r].to(device).split(
                [_prod(shape) for _, _, shape in recv[r]])
            for (k, sl, shape), part in zip(recv[r], parts):
                into(k, sl).add_(part.view(shape))
        return acc


def _prod(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
