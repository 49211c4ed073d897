"""Activation checkpointing (the reference's ``jax.checkpoint``) that holds
under ``torch.func``: port of the ``remat`` option of
``repro.models.transformer.forward_lm`` and ``repro.models.encdec``.

The engine differentiates a node's loss with ``torch.func.vjp`` under
``torch.func.vmap`` over the node axis. ``torch.utils.checkpoint`` cannot
run there: its non-reentrant form rests on saved-tensor hooks, which the
``torch.func`` transforms refuse, and its reentrant form calls
``torch.autograd.backward`` inside. :func:`checkpoint` is a
``torch.autograd.Function`` instead, in ``setup_context`` style with a
generated vmap rule:

* forward: the block runs without recording a graph, and the Function
  saves only its tensor inputs (the block's input activation and its
  parameter views), as ``jax.checkpoint`` keeps only the body's inputs;
* backward: the block is recomputed under ``torch.func.grad`` of the
  cotangents' dot product with its outputs, which gives the same
  cotangents as a ``torch.func.vjp`` of the block. (A ``torch.func.vjp``
  called in a backward that a vjp function runs outside its own level
  trips a functorch internal assert on PyTorch 2.13 for some ops, matmul
  among them; ``grad`` runs its backward inside its level.)

The recompute runs the block's kernels again: on a CUDA tensor a
checkpointed layer launches its flash or SSD kernel twice a step, once in
the forward and once in the recompute (the kernels' own backwards are
plain PyTorch). A block that routes (the MoE's top-k, a stable sort)
routes the same tokens in the recompute as in the forward.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.sharding import tensor


class _Checkpoint(torch.autograd.Function):
    """``fn(*tree_unflatten(leaves, spec))`` → a tuple of tensors, saving
    only ``leaves``; the backward recomputes ``fn``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, spec, *leaves):
        return fn(*pytree.tree_unflatten(list(leaves), spec))

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, spec, *leaves = inputs
        ctx.fn, ctx.spec = fn, spec
        ctx.save_for_backward(*leaves)

    @staticmethod
    def backward(ctx, *cotangents):
        leaves = list(ctx.saved_tensors)
        diff = [i for i, t in enumerate(leaves) if t.is_floating_point()]

        def dot(*ts):
            ls = list(leaves)
            for i, t in zip(diff, ts):
                ls[i] = t
            outs = ctx.fn(*pytree.tree_unflatten(ls, ctx.spec))
            return sum(torch.sum(o * c) for o, c in zip(outs, cotangents))

        grads = torch.func.grad(dot, argnums=tuple(range(len(diff))))(
            *(leaves[i] for i in diff))
        out = [None] * len(leaves)
        for i, g in zip(diff, grads):
            out[i] = g
        return (None, None) + tuple(out)


class _GatheredCheckpoint(torch.autograd.Function):
    """:class:`_Checkpoint` of a block whose last argument is a rank's
    `repro_torch.models.gather.LayerShards`: the forward gathers the whole
    layer, runs the block without a graph and drops the layer; the
    backward gathers it again, recomputes the block under
    ``torch.func.grad`` with the whole layer as an input, and takes the
    layer's cotangent to the rank's blocks (`LayerShards.reduce`). Its
    collectives so run on plain tensors. No vmap rule: a split step runs
    node by node."""

    @staticmethod
    def forward(fn, spec, shards, *leaves):
        n = len(leaves) - len(shards.held())
        args = pytree.tree_unflatten(list(leaves[:n]), spec)
        return fn(*args, shards.tree(shards.assemble()))

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, spec, shards, *leaves = inputs
        ctx.fn, ctx.spec, ctx.shards = fn, spec, shards
        ctx.n = len(leaves) - len(shards.held())
        ctx.save_for_backward(*leaves[:ctx.n])

    @staticmethod
    def backward(ctx, *cotangents):
        shards = ctx.shards
        leaves = list(ctx.saved_tensors)
        whole = shards.assemble()
        diff = [i for i, t in enumerate(leaves) if t.is_floating_point()]
        k = len(diff)

        def dot(*ts):
            ls = list(leaves)
            for i, t in zip(diff, ts[:k]):
                ls[i] = t
            outs = ctx.fn(*pytree.tree_unflatten(ls, ctx.spec),
                          shards.tree(ts[k:]))
            return sum(torch.sum(o * c) for o, c in zip(outs, cotangents))

        grads = torch.func.grad(dot, argnums=tuple(range(k + len(whole))))(
            *(leaves[i] for i in diff), *whole)
        del whole
        out = [None] * len(leaves)
        for i, g in zip(diff, grads[:k]):
            out[i] = g
        return (None, None, None) + tuple(out) + tuple(
            shards.reduce(list(grads[k:])))


class _TensorCheckpoint(_GatheredCheckpoint):
    """:class:`_GatheredCheckpoint` under tensor parallelism: the layer is
    the rank's compute blocks and the block runs the model group's
    collectives (`repro_torch.sharding.tensor`), which run on plain
    tensors only, so the backward recomputes the block under plain
    autograd (``torch.autograd.grad`` of its outputs against the
    cotangents), not under ``torch.func.grad``, in the model group and
    the form its forward ran in (the cut or the whole residual; the
    backward runs after the loss has left it)."""

    @staticmethod
    def setup_context(ctx, inputs, output):
        _GatheredCheckpoint.setup_context(ctx, inputs, output)
        ctx.plan = tensor.current()

    @staticmethod
    def backward(ctx, *cotangents):
        shards = ctx.shards
        leaves = list(ctx.saved_tensors)
        with torch.enable_grad(), tensor.model_group(ctx.plan):
            ins = [t.detach().requires_grad_() if t.is_floating_point()
                   else t for t in leaves]
            whole = [t.requires_grad_() for t in shards.assemble()]
            outs = ctx.fn(*pytree.tree_unflatten(ins, ctx.spec),
                          shards.tree(whole))
            diff = [t for t in ins if t.is_floating_point()]
            grads = torch.autograd.grad(outs, diff + whole, cotangents,
                                        allow_unused=True)
        del whole, outs
        it = iter(grads[:len(diff)])
        out = [next(it) if t.is_floating_point() else None for t in leaves]
        return (None, None, None) + tuple(out) + tuple(
            shards.reduce(list(grads[len(diff):])))


def checkpoint(fn: Callable[..., Tuple[torch.Tensor, ...]], *args
               ) -> Tuple[torch.Tensor, ...]:
    """``fn(*args)`` with its activations recomputed in the backward.

    ``args`` is a tree (dicts, lists, tuples) of every tensor the block
    reads: its input activation, any other activation (the enc-dec
    decoder's encoder output), the positions and its per-layer parameter
    views, passed as they are so that each gradient flows back through the
    view into its stacked leaf. Gradients flow to the floating tensors;
    integer ones (the positions) get none. A tensor made inside a
    ``torch.func`` transform must come in as an argument, not through
    ``fn``'s closure; ``fn`` captures only Python values (the window, the
    config). ``fn`` returns a tuple of tensors.

    On a split step (`repro_torch.models.gather`) the last argument is the
    rank's `LayerShards` of the layer instead of its views: the layer is
    gathered inside the checkpoint, for the forward and again for the
    recompute, and ``fn`` receives it whole (its compute blocks under
    tensor parallelism)."""
    from repro_torch.models.gather import LayerShards
    if args and isinstance(args[-1], LayerShards):
        shards = args[-1]
        leaves, spec = pytree.tree_flatten(args[:-1])
        cls = (_TensorCheckpoint if shards.cut.compute is not None
               else _GatheredCheckpoint)
        return cls.apply(fn, spec, shards, *leaves, *shards.held())
    leaves, spec = pytree.tree_flatten(args)
    return _Checkpoint.apply(fn, spec, *leaves)
