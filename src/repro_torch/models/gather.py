"""A node's forward on a rank's shard: each layer gathered just in time.

On an inner-sharded gossip mesh (`repro_torch.launch.mesh.
make_swarm_mesh(n, data=D, model=M)`) a rank holds only its shard of its
node (`repro_torch.core.flat.ShardLayout`). A split step
(`repro_torch.launch.train.TrainStep.split`) runs the node's forward and
backward there without ever holding the node whole, as GSPMD runs the
reference's step under its ``param_specs`` (the ``zero3`` placement of
its dry-run: batch over ``data``, params and optimizer fully sharded):

* the unscanned leaves (embeddings, final norm, head, a vlm's projector,
  an enc-dec's front end) are gathered once, as one unit, when the step
  starts;
* each scan-stacked layer (``layers``, ``enc_layers``, ``dec_layers``) is
  gathered over the node's shard group just before its block runs
  (:class:`LayerShards`), by a :class:`~repro_torch.core.flat.LayerCut`;
* the gather is an autograd Function (:class:`_Gather`): its backward
  takes the whole layer's cotangent to the rank's blocks, summed over the
  node's **data group** only (without tensor parallelism the model ranks
  of one data index compute the same cotangent), in f32, divided by ``D``
  (the node's loss is the mean of its data ranks',
  `repro_torch.sharding.batch`) and rounded once to each leaf's dtype.
  Each rank hands over only the blocks its data
  group keeps (`repro_torch.core.flat.LayerCut.reduce`: a reduce_scatter
  of the blocks the data axis cuts, a reduce to the one data rank that
  holds a layer the data axis cuts on the layer axis, an all_reduce of a
  block every data rank holds), never a whole layer. With ``D = 2``
  every reduced element is ``a + b`` whichever collective carries it,
  as when the whole cotangent was all_reduced and then cut. With one data
  rank (``D = 1``, or a batch that does not split, which every data rank
  then computes whole) it only cuts the block out: the gradient is the
  whole node's, bit for bit.

**Tensor parallelism.** With a model group (``tensor``, a
`repro_torch.sharding.tensor.TensorPlan`: a mesh with ``model`` above 1
and a decoder-only family) every unit is a compute cut
(`repro_torch.core.flat.LayerCut.gather_compute`): a rank receives its
**compute block** of each leaf (the slices its model index computes
with, `repro_torch.sharding.rules.compute_cut`), never the whole layer,
and the forward divides the layer's work over the model group
(`repro_torch.sharding.tensor`). The backward sends each rank's share of
a compute block's cotangent to the ranks that store it
(:meth:`~repro_torch.core.flat.LayerCut.reduce_compute`, ``grad_to_shard``
bytes): a piece of a cut leaf sums over the data group alone (one model
rank computes with it), a piece of a leaf every model rank computes with
(norm scales, biases added after a reduce, the router, an SSM's B/C
columns, a leaf M does not divide) over the data and the model group, in
f32, divided by ``D`` where the data ranks took rows of their own. Each
piece is summed once. An enc-dec node's two stacks (``enc_layers``,
``dec_layers``) each have a cut of their own, so a layer index only ever
names a layer of the stack its forward loop walks.

Without autograd (the split gate, `repro_torch.launch.train.SwarmEval.
split`, under ``torch.no_grad``) :meth:`LayerShards.gather` assembles the
unit plainly, so a rank that holds no block of a layer still joins its
all_gather; the gathers then count as ``gate_gather``.

With ``remat=True`` the block's checkpoint (`repro_torch.models.remat`)
takes the :class:`LayerShards` and gathers the layer inside: the whole
layer (the compute blocks, under tensor parallelism) is dropped when the
block returns and gathered again for the recompute, so a rank holds at
most two whole layers (two layers' compute blocks) at once (ZeRO-3's
peak). With ``remat=False`` the autograd graph keeps every gathered layer
until the backward: the params are then a whole node's for the step, while
its gradients and moments stay the shard's.

The collectives run outside any ``torch.func`` transform: a split step is
plain autograd, node by node (a rank of such a mesh holds one node
position), and a checkpoint's recompute differentiates the block with the
gathered layer as an input, so no collective runs on a transform's
wrapped tensors.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.core.flat import LayerCut
from repro_torch.sharding.rules import STACKED


def _nest(flat: Dict[str, torch.Tensor]) -> dict:
    root: dict = {}
    for path, t in flat.items():
        node = root
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    return root


def _flat(tree, prefix: str, out: dict) -> dict:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}.{k}", out)
    else:
        out[prefix] = tree
    return out


class LayerShards:
    """This rank's blocks of one unit of a node's params (layer ``i`` of a
    stacked subtree, or the unscanned leaves): ``local`` one tensor a leaf
    of ``cut.paths``, None where the rank does not hold the leaf's layer.
    :meth:`gather` gives the whole unit as a nested dict, differentiable
    into ``local``; :meth:`assemble` and :meth:`reduce` are the same two
    directions without autograd, for a checkpoint that gathers inside."""

    def __init__(self, split: "NodeSplit", cut, i: int, local, prefix: str):
        self.split, self.cut, self.i = split, cut, i
        self.local = list(local)
        self.prefix = prefix

    def held(self):
        """The tensors of :attr:`local` (the differentiable inputs)."""
        return [t for t in self.local if t is not None]

    def tree(self, whole: Sequence[torch.Tensor]) -> dict:
        """The unit's nested dict of its whole tensors (keys relative to
        the prefix)."""
        n = len(self.prefix) + 1 if self.prefix else 0
        return _nest({p[n:]: t for p, t in zip(self.cut.paths, whole)})

    def assemble(self):
        """The whole unit (one tensor a leaf), no autograd."""
        return self.split.gather(self.cut, self.local, self.i)

    def reduce(self, cots):
        """Whole-unit cotangents (None: zero) → the held blocks'
        gradients, no autograd (see :class:`_Gather`)."""
        return self.split.reduce(self.cut, cots, self.i, self.local)

    def gather(self) -> dict:
        """The whole unit as a nested dict, through :class:`_Gather`
        (with grad mode off, :meth:`assemble` plainly)."""
        if not torch.is_grad_enabled():
            return self.tree(self.assemble())
        held = self.held()
        if not held:
            # its backward is collective: every rank must reach it
            raise ValueError(f"this rank holds no block of {self.prefix!r}"
                             f" layer {self.i}")
        return self.tree(_Gather.apply(self, *held))


class _Gather(torch.autograd.Function):
    """Forward: the whole unit from the rank's blocks (an all_gather over
    the shard group). Backward: each whole tensor's cotangent summed over
    the data group in f32, divided by ``D``, rounded once to the leaf's
    dtype, and cut to the rank's block."""

    @staticmethod
    def forward(shards, *held):
        return tuple(shards.assemble())

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.shards = inputs[0]

    @staticmethod
    def backward(ctx, *cots):
        return (None,) + tuple(ctx.shards.reduce(list(cots)))


class NodeSplit:
    """How a rank's shard of a node runs the node's step: the shard layout
    ``shard`` (its :class:`~repro_torch.core.flat.ShardLayout`), the
    node's shard group ``shard_view`` (the gathers, counted as ``kind``),
    the rank's data group ``data_view`` (the gradients' sum; None: the
    rank's rows are the node's whole batch), the dtype of the params'
    16-bit (or f32) rest and, for tensor parallelism, ``tensor`` (a
    `repro_torch.sharding.tensor.TensorPlan`: every unit a compute cut).

    A model's ``loss_fn(views, batch, split=...)`` calls :meth:`tree` on
    the rank's local leaf views, and its forward loops call
    :meth:`layers` on each stacked subtree; a served model's ``prefill``,
    ``decode`` and ``encode`` take it the same way, under ``no_grad``.

    Under the dry run's ``dp`` and ``zero3`` profiles (`repro_torch.
    launch.mesh.use_profile`) the rows divide over a batch group apart
    from the group the layers are gathered from: ``data_view`` is then
    the batch group (the node's every rank: the gradient's divisor, the
    loss's `repro_torch.sharding.batch` group), ``reduce_view`` the
    group within ``shard_view`` whose blocks differ (``dp``: the data
    group, which is ``shard_view``; ``zero3``: ``shard_view``, over
    ``reduce_axes`` ``("data", "model")``) and ``replica_view`` (``dp``:
    the model group, which holds the same blocks) where the reduced
    blocks are summed once more (`repro_torch.core.flat.LayerCut.
    reduce`)."""

    def __init__(self, shard, shard_view, data_view=None, *,
                 dtype: torch.dtype = torch.float32, device="cpu",
                 kind: str = "layer_gather", tensor=None, reduce_view=None,
                 replica_view=None, reduce_axes=("data",)):
        self.shard = shard
        self.device = torch.device(device)
        self.shard_view = shard_view
        self.data_view = data_view
        self.reduce_view = data_view if reduce_view is None else reduce_view
        self.replica_view = replica_view
        self.kind = kind
        self.tensor = tensor
        full = shard.full
        dtypes = {lf.path: torch.float32 if lf.wide else dtype
                  for lf in full.leaves}
        compute = None
        if tensor is not None:
            from repro_torch.sharding.rules import compute_cut

            def compute(path, shape, m):
                return compute_cut(tensor.cfg, tensor.place, path, shape, m)
        tops = {lf.path.split(".")[0] for lf in full.leaves}
        self.cuts = {top: LayerCut(
            shard, [lf.path for lf in full.leaves
                    if lf.path.split(".")[0] == top], True, dtypes, compute,
            reduce_axes) for top in STACKED if top in tops}
        self.unit = LayerCut(
            shard, [lf.path for lf in full.leaves
                    if lf.path.split(".")[0] not in self.cuts], False, dtypes,
            compute, reduce_axes)

    # -- the two directions, no autograd -----------------------------------

    def gather(self, cut, local, i: int):
        """The whole unit ``i`` of ``cut`` (its compute blocks under tensor
        parallelism) from the rank's blocks."""
        if cut.compute is not None:
            return cut.gather_compute(local, i, self.shard_view, self.device,
                                      kind=self.kind)
        return cut.gather(local, i, self.shard_view, self.device,
                          kind=self.kind)

    def reduce(self, cut, cots, i: int, local):
        """The held blocks' gradients from the whole unit's (or the compute
        blocks') cotangents."""
        shapes = cut.shapes if cut.compute is None else cut.cshapes
        cots = [torch.zeros(shape, dtype=dtype, device=self.device)
                if c is None else c
                for c, shape, dtype in zip(cots, shapes, cut.dtypes)]
        if cut.compute is not None:
            split = self.data_view is not None
            summed = cut.reduce_compute(cots, i, self.shard_view,
                                        self.device, split)
            d = self.data_view.world_size if split else 1
            return [summed[k].div_(d).to(cut.dtypes[k]).contiguous()
                    for k, t in enumerate(local) if t is not None]
        if self.data_view is None:
            return [cut.shard_of(k, c).to(cut.dtypes[k]).contiguous()
                    for k, (c, t) in enumerate(zip(cots, local))
                    if t is not None]
        summed = cut.reduce(cots, i, self.reduce_view, self.device,
                            self.replica_view, self.data_view)
        d = self.data_view.world_size
        return [summed[k].div_(d).to(cut.dtypes[k]).contiguous()
                for k, t in enumerate(local) if t is not None]

    # -- what the models call ----------------------------------------------

    def tree(self, views: Dict[str, torch.Tensor]) -> dict:
        """The nested param tree of a forward on the rank's local leaf
        views: the unscanned leaves whole (one gather), each stacked
        subtree as the rank holds it (:meth:`layers` gathers its layers)."""
        unit = LayerShards(self, self.unit, 0,
                           [views[p] for p in self.unit.paths], "")
        out = unit.gather()
        for top, cut in self.cuts.items():
            out[top] = _nest({p[len(top) + 1:]: views[p]
                              for p in cut.paths})
        return out

    def layers(self, top: str, stacked: dict, lazy: bool):
        """``i -> layer i`` of the stacked subtree ``top`` (the rank's
        ``stacked`` leaves, unbound once): the whole layer as a nested
        dict, gathered now, or with ``lazy`` the :class:`LayerShards` a
        checkpoint gathers inside."""
        cut = self.cuts[top]
        flat = _flat(stacked, top, {})
        unbound = [flat[p].unbind(0) for p in cut.paths]

        def layer(i: int):
            local = [ts[cut.local_index(k, i)] if cut.holds(k, i) else None
                     for k, ts in enumerate(unbound)]
            shards = LayerShards(self, cut, i, local, top)
            return shards if lazy else shards.gather()

        return layer

    # -- the clipping norm --------------------------------------------------

    def grad_norm(self, grads) -> torch.Tensor:
        """The whole node's global gradient norm from the rank's gradient
        parts (the shard layout's ``parts``): each leaf's squares summed in
        f64 where the rank :meth:`~repro_torch.core.flat.ShardLayout.owns`
        its block, the sums added over the shard group, the root rounded
        to f32. With f64 sums the order of the blocks moves the norm far
        below its f32 rounding (:func:`node_norm` is the whole node's)."""
        from repro_torch.core import gossip
        local = self.shard.local
        views = local.unflatten_parts(tuple(grads))
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for lf in local.leaves:
            if self.shard.owns(lf.path):
                total = total + _sumsq(views[lf.path])
        total = gossip.all_reduce(self.shard_view, total.reshape(1),
                                  kind="step_control")
        return torch.sqrt(total[0]).to(torch.float32)


#: values a chunk of the norm's f64 squares
_CHUNK = 1 << 22


def _sumsq(t: torch.Tensor) -> torch.Tensor:
    """Σ t² in f64 (each f32 square exact), a chunk at a time."""
    flat = t.reshape(-1)
    total = None
    for a in range(0, flat.shape[-1], _CHUNK):
        g = flat[a:a + _CHUNK].to(torch.float64)
        part = torch.sum(g * g)
        total = part if total is None else total + part
    return total if total is not None else flat.new_zeros(
        (), dtype=torch.float64)


def node_norm(grads) -> torch.Tensor:
    """The global norm of a whole node's gradient parts, its squares
    summed in f64 (:meth:`NodeSplit.grad_norm` is a shard's), rounded to
    f32."""
    parts = tuple(grads) if isinstance(grads, (tuple, list)) else (grads,)
    total = _sumsq(parts[0])
    for p in parts[1:]:
        total = total + _sumsq(p)
    return torch.sqrt(total).to(torch.float32)
