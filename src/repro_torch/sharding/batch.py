"""The batch group: which ranks share a node's batch rows in a split step.

The reference places the batch on the mesh's ``data`` axis
(``DEFAULT_LOGICAL["batch"] = "data"``), and GSPMD then reduces every
batch-coupled term of the loss over that axis. The port runs one process
a rank, so a rank that takes ``B / D`` of its node's rows
(`repro_torch.launch.train.TrainStep.split`) names its node's **data
group** (`repro_torch.launch.mesh.SwarmMesh.data_view`, the ranks ``(i, ·,
m)``) here, and the model's batch-coupled terms read it:

* ``models.layers.softmax_xent``'s masked mean divides by the group's
  token count;
* the MoE router's load-balancing loss averages its two batch means over
  the group before their product (``models.moe.route``).

A rank's loss is then its share of the node's: the node's loss is the
mean of its data ranks' (their gradients are summed over the group and
divided by ``D``, `repro_torch.models.gather`). Outside
:func:`batch_group` (every path but a split step with ``D > 1``) nothing
changes.

The group is a module global, not a thread-local: the autograd engine may
run a backward (a checkpointed block's recompute reads it) on a thread of
its own.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

_GROUP = None


@contextmanager
def batch_group(view):
    """Within the block, ``view`` (a `repro_torch.launch.mesh.GroupView`,
    or None for none) is the group that shares the batch."""
    global _GROUP
    prev, _GROUP = _GROUP, view
    try:
        yield view
    finally:
        _GROUP = prev


def current():
    """The group that shares the batch, or None."""
    return _GROUP


def group_sum(t: torch.Tensor) -> torch.Tensor:
    """Σ of ``t`` over the batch group (``t`` itself without one); carries
    no gradient. Counted under ``step_control``."""
    if _GROUP is None:
        return t
    from repro_torch.core import gossip
    return gossip.all_reduce(_GROUP, t.detach(), kind="step_control")


class _GroupMean(torch.autograd.Function):
    """The mean of ``x`` over the batch group. Every rank's loss reads the
    same mean, and the node's loss is the mean of the ranks' losses: so the
    cotangent a rank's ``x`` takes is the one its mean took (the ranks'
    cotangents are equal), and the backward is the identity."""

    @staticmethod
    def forward(x, view):
        from repro_torch.core import gossip
        return gossip.all_reduce(view, x, kind="step_control") \
            / view.world_size

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def group_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the batch group, differentiable (``x`` itself
    without one)."""
    if _GROUP is None:
        return x
    return _GroupMean.apply(x, _GROUP)
