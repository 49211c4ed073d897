"""Tensor parallelism over a node's model group: the Megatron collectives.

The reference divides a layer's work over its mesh's ``model`` axis
through GSPMD (``logical_shard`` on the activations, ``constrain_block_
params`` on the per-layer params; `repro_torch.sharding.rules.placement`
states what they decide). The port runs one process a rank, so a split
step on a mesh with ``model`` above 1 (`repro_torch.launch.train.
TrainStep.split`) hands its rank's **model group** (`repro_torch.launch.
mesh.SwarmMesh.model_view`, the ranks ``(i, d, ·)``) and its placement to
the model as a :class:`TensorPlan` on its split
(`repro_torch.models.gather.NodeSplit`, ``tensor``). The model's loss
enters it here for its forward (:func:`model_group`; remat's recompute
again in the backward), and the forward (`repro_torch.models.
transformer`, ``encdec``, ``attention``, ``moe``, ``ssm``) reads
:func:`current` and moves its activations with the collectives below:

* the residual stream is cut on the sequence between blocks (the
  reference's ``res_seq``, Megatron-SP): a block enters its attention, MLP,
  MoE or SSM with :func:`gather` (an all_gather of the sequence, whose
  backward is a reduce_scatter) and leaves a cut one with
  :func:`scatter_sum` (a reduce_scatter onto the sequence cut, whose
  backward is an all_gather); a block it computes whole on the gathered
  sequence leaves with :func:`local` (its own rows, whose backward pads
  with zeros);
* the input-only embedding, whose table is cut on d_model, leaves its
  lookup with :func:`all_to_all` (d cut → sequence cut); a tied table cut
  on the vocab with a masked lookup and :func:`scatter_sum`;
* the SSM's gated norm averages over all of ``d_inner``: the sum of
  squares of a rank's heads goes through :func:`all_reduce` (f32, both
  ways);
* the logits are cut on the vocab where M divides it and the loss is
  :func:`vocab_xent`: the max, the sum of exps and the target's logit
  each all_reduced in f32, the gradient the rank's own slice of
  ``softmax − onehot`` (else the logits whole on the gathered sequence);
* a value every model rank computes alike from the same inputs (the MoE
  router's aux loss) goes through :func:`replicated`: its gradient counts
  once over the group.

Each rank's backward then yields its share of every gradient, and the
shares of a leaf sum over the model group to the whole node's
(`repro_torch.core.flat.LayerCut.reduce_compute`). The sums of the
activations run in f32 and round once. The collectives' bytes count as
``tp_gather``, ``tp_reduce_scatter``, ``tp_all_reduce`` and
``tp_all_to_all`` (what the rank hands over). They are
``torch.autograd.Function`` s of plain autograd: a split step runs outside
any ``torch.func`` transform, as `repro_torch.models.gather`'s gathers.

**The whole residual.** A forward whose sequence M does not divide (a
decode step's one token, a prompt or a training sequence of odd length at
M = 2, an enc-dec's frames or tokens, each picking its form on its own)
runs in the plan's whole-residual form (:meth:`TensorPlan.for_sequence`),
where the reference's ``logical_shard`` leaves ``res_seq`` UNCONSTRAINED:
every rank holds the whole rows, a block enters with no gather
(:func:`enter`), a cut block leaves with :func:`all_reduce` (f32, rounded
once) in place of :func:`scatter_sum` (:func:`leave`), and a block
computed whole keeps all of it (:func:`own`). Its bytes count under the
same ``tp_*`` kinds (``leave``'s all_reduce moves again in the backward).

**The gradient in the two forms.** In the cut form a rank's cotangent of
an activation is the true one on its own rows. In the whole form every
rank holds every row, and a rank's cotangent of a replicated activation is
a **partial**: the partials sum over the model group to the true one.
:func:`enter` is the identity both ways; :func:`leave` is an all_reduce
both ways, which turns the partials into the true cotangent for the
block's cut weights, whose input cotangent is again the rank's partial; a
block computed whole keeps its partial (its backward is linear in it, so
every leaf's shares still sum to the whole node's). The vocab-cut loss
(:func:`vocab_xent`) gives each rank only its slice's gradient, already a
partial of the whole rows. Where the logits are whole (M does not divide
the padded vocab) every rank would backprop the whole gradient and the
shares would sum to M times the truth, so the whole logits' loss goes
through :func:`replicated` (its gradient divided by M), in either form.
Remat's recompute (`repro_torch.models.remat`) runs in the plan its
forward ran in.

The group is a module global, not a thread-local: the autograd engine may
run a backward on a thread of its own.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

_PLAN = None


class TensorPlan:
    """A rank's place in its node's model group: ``view`` the group
    (``size`` ranks, this one ``rank``), ``place`` the model's
    `repro_torch.sharding.rules.Placement`, ``cfg`` its config; ``whole``
    the whole-residual form (every rank holds every row). Served,
    ``seq_view`` is the group a decode cache's sequence is cut over (the
    data group where it does not divide the batch, `repro_torch.launch.
    serve.StepBuffers`), or None: the rank attends over its own positions
    and :func:`seq_softmax` combines the partial softmax over it."""

    def __init__(self, view, place, cfg, whole: bool = False,
                 seq_view=None):
        self.view = view
        self.size = view.world_size
        self.rank = view.rank
        self.place = place
        self.cfg = cfg
        self.whole = whole
        self.seq_view = seq_view

    def with_seq(self, seq_view) -> "TensorPlan":
        """The plan with the decode cache's sequence cut over
        ``seq_view``."""
        return TensorPlan(self.view, self.place, self.cfg, self.whole,
                          seq_view)

    def for_sequence(self, s: int) -> "TensorPlan":
        """The form a forward of ``s`` positions runs in: the residual cut
        on the sequence where the group divides ``s``, else the
        whole-residual form, with or without a gradient recorded."""
        if self.whole or not s % self.size:
            return self
        return TensorPlan(self.view, self.place, self.cfg, whole=True,
                          seq_view=self.seq_view)

    def seq_cut(self, s: int):
        """``(start, length)`` of this rank's rows of a sequence of ``s``,
        the cut form's check: raises where the group does not divide it
        (:meth:`for_sequence` takes the whole form there)."""
        if s % self.size:
            raise ValueError(f"a sequence of {s} does not divide over the "
                             f"{self.size} ranks of the model group")
        n = s // self.size
        return self.rank * n, n


@contextmanager
def model_group(plan):
    """Within the block, ``plan`` (a :class:`TensorPlan`, or None) is the
    model group the forward divides its work over."""
    global _PLAN
    prev, _PLAN = _PLAN, plan
    try:
        yield plan
    finally:
        _PLAN = prev


def current():
    """The :class:`TensorPlan` of the running split step, or None."""
    return _PLAN


# ---------------------------------------------------------------------------
# the collectives on plain tensors
# ---------------------------------------------------------------------------

def _wire(t: torch.Tensor) -> torch.Tensor:
    """A 16-bit tensor as its bytes (gloo moves neither bf16 nor int16).
    A contiguous tensor whose last dim has size 1 may carry any stride
    there (a batch-1 row of logits moved to the front), which the byte
    view refuses: such a tensor is copied to standard strides first."""
    if t.element_size() != 2:
        return t
    if t.dim() and t.stride(-1) != 1:
        t = t.clone(memory_format=torch.contiguous_format)
    return t.view(torch.uint8)


def _all_gather(view, x, dim: int, kind: str = "tp_gather"):
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    xt = x.movedim(dim, 0).contiguous()
    from repro_torch.core import gossip
    out = gossip.all_gather(view, _wire(xt), kind=kind)
    return out.view(x.dtype).movedim(0, dim)


def _reduce_scatter(view, x, dim: int):
    """Σ of ``x`` over the ranks (in f32, rounded once), this rank's
    chunk along ``dim``."""
    from repro_torch.core import gossip
    xt = x.movedim(dim, 0)
    n = xt.shape[0] // view.world_size
    rows = xt.to(torch.float32).reshape(view.world_size, -1)
    out = gossip.reduce_scatter(view, rows, kind="tp_reduce_scatter")
    return out.view((n,) + tuple(xt.shape[1:])).to(x.dtype).movedim(0, dim)


def _all_to_all(view, x, split_dim: int, cat_dim: int):
    """Chunk r of ``x`` along ``split_dim`` to rank r; the chunks every
    rank sent here concatenated along ``cat_dim`` in rank order."""
    from repro_torch.core import gossip
    w = view.world_size
    chunks = torch.stack(x.chunk(w, split_dim)).contiguous()
    got = gossip.all_to_all_v(view, _wire(chunks).reshape(w, -1), [1] * w,
                              [1] * w, kind="tp_all_to_all").to(x.device)
    got = got.view(chunks.dtype).view(chunks.shape)
    return torch.cat(list(got.unbind(0)), dim=cat_dim)


def _all_reduce(view, x):
    """Σ of ``x`` over the ranks in f32, rounded once."""
    from repro_torch.core import gossip
    return gossip.all_reduce(view, x.to(torch.float32),
                             kind="tp_all_reduce").to(x.dtype)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, view):
        ctx.dim, ctx.view = dim, view
        return _all_gather(view, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(ctx.view, g, ctx.dim), None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, view):
        ctx.dim, ctx.view = dim, view
        return _reduce_scatter(view, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(ctx.view, g, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, cat_dim, view):
        ctx.dims, ctx.view = (split_dim, cat_dim), view
        return _all_to_all(view, x, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return _all_to_all(ctx.view, g, cat_dim, split_dim), None, None, None


class _Local(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, view):
        n = x.shape[dim] // view.world_size
        ctx.dim, ctx.n, ctx.rank, ctx.shape = dim, n, view.rank, x.shape
        return x.narrow(dim, view.rank * n, n).clone()

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.shape)
        out.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).copy_(g)
        return out, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, view):
        ctx.view = view
        return _all_reduce(view, x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.view, g), None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, size):
        ctx.size = size
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None


def gather(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The model group's cuts of ``x`` along ``dim`` (the sequence)
    gathered whole; the backward sums the group's cotangents and keeps
    this rank's cut."""
    return _Gather.apply(x, dim, _PLAN.view)


def scatter_sum(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The sum of the group's partial ``x`` (each rank's share of a
    row-parallel output), this rank's cut along ``dim``."""
    return _ScatterSum.apply(x, dim, _PLAN.view)


def all_to_all(x: torch.Tensor, split_dim: int, cat_dim: int
               ) -> torch.Tensor:
    """``x`` cut along ``split_dim`` over the group and joined along
    ``cat_dim`` (the d_model-cut embedding → the sequence cut)."""
    return _AllToAll.apply(x, split_dim, cat_dim, _PLAN.view)


def local(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's cut of ``x`` along ``dim``, from a whole ``x`` that
    every rank computes alike; the backward pads the cotangent with zeros,
    so the whole computation's gradient is this rank's share."""
    return _Local.apply(x, dim, _PLAN.view)


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """Σ of ``x`` over the group (f32), each rank using the sum for its
    own share: the backward sums the cotangents too."""
    return _AllReduce.apply(x, _PLAN.view)


def enter(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """A block's input whole: :func:`gather` of the rank's cut, or ``x``
    itself in the whole-residual form."""
    return x if _PLAN.whole else gather(x, dim)


def leave(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """A row-parallel share summed over the group: onto the rank's cut
    (:func:`scatter_sum`), or whole (:func:`all_reduce`) in the
    whole-residual form."""
    return all_reduce(x) if _PLAN.whole else scatter_sum(x, dim)


def own(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """A block's output that every rank computed whole: its rows
    (:func:`local`), or all of it in the whole-residual form."""
    return x if _PLAN.whole else local(x, dim)


def replicated(x: torch.Tensor) -> torch.Tensor:
    """``x``, a value every rank computes alike from the same inputs; its
    gradient is divided over the group, so it counts once in the sum of
    the ranks' shares."""
    return _Replicated.apply(x, _PLAN.size)


class _VocabXent(torch.autograd.Function):
    """Token NLL from this rank's vocab cut of the logits ``[..., V/M]``
    (columns ``v0 .. v0 + V/M``): ``logsumexp − logit[label]`` of the whole
    vocab, in f32, alike on every rank. The backward gives the rank's cut
    of ``(softmax − onehot) · g``."""

    @staticmethod
    def forward(ctx, logits, labels, v0, view):
        from repro_torch.core import gossip
        lf = logits.to(torch.float32)
        vl = lf.shape[-1]
        mx = -gossip.all_reduce(view, -lf.amax(-1), op="min",
                                kind="tp_all_reduce")
        mine = (labels >= v0) & (labels < v0 + vl)
        idx = torch.where(mine, labels - v0, 0).long()
        gold = torch.where(mine, torch.gather(lf, -1, idx[..., None])[..., 0],
                           0.0)
        se = torch.exp(lf - mx[..., None]).sum(-1)
        both = gossip.all_reduce(view, torch.stack([se, gold]),
                                 kind="tp_all_reduce")
        logz = torch.log(both[0]) + mx
        ctx.save_for_backward(logits, logz, idx, mine)
        return logz - both[1]

    @staticmethod
    def backward(ctx, g):
        logits, logz, idx, mine = ctx.saved_tensors
        p = torch.exp(logits.to(torch.float32) - logz[..., None])
        p.scatter_add_(-1, idx[..., None], -mine[..., None].to(p.dtype))
        return (p * g[..., None]).to(logits.dtype), None, None, None


def vocab_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The token NLL [...] (f32) of this rank's vocab cut of the logits,
    the cut ``rank · V/M`` onward."""
    v0 = _PLAN.rank * logits.shape[-1]
    return _VocabXent.apply(logits, labels, v0, _PLAN.view)


def seq_softmax(scores: torch.Tensor, mask: torch.Tensor, v: torch.Tensor,
                dtype, view) -> torch.Tensor:
    """Attention over a decode cache whose sequence is cut over ``view``:
    this rank's masked scores ``[B, nkv, g, S, T_local]`` against its
    positions' ``v`` ``[B, T_local, nkv, hd]`` → the output over every
    rank's positions ``[B, S, nkv·g, hd]`` in ``dtype``. The partial
    softmax combines as flash's online softmax does: the row max
    all_reduced (``tp_seq_max``), each rank's exps rescaled to it, then
    their sums and weighted values all_reduced in one f32 buffer
    (``tp_seq_sum``). A rank none of whose positions the mask keeps adds
    zeros. No gradient (a served forward)."""
    from repro_torch.core import gossip
    f32 = torch.float32
    s = torch.where(mask, scores.to(f32), -1e30)
    m = -gossip.all_reduce(view, -s.amax(-1, keepdim=True), op="min",
                           kind="tp_seq_max")
    p = torch.exp(s - m)
    b, nkv, g, sq, _ = p.shape
    den = p.sum(-1).permute(0, 3, 1, 2)                  # [B, S, nkv, g]
    num = torch.einsum("bkgst,btkh->bskgh", p, v.to(f32))
    buf = gossip.all_reduce(view, torch.cat([den.reshape(-1),
                                             num.reshape(-1)]),
                            kind="tp_seq_sum")
    den = buf[:den.numel()].view(den.shape)
    num = buf[den.numel():].view(num.shape)
    return (num / den[..., None]).reshape(b, sq, nkv * g, -1).to(dtype)
