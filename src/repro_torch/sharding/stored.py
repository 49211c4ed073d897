"""Serving from a rank's stored shard: the decode cache's cuts apart from
its compute.

Under the reference dry run's ``dp`` and ``zero3`` profiles nothing is
tensor-parallel: a served rank holds its shard of the node's params
(`repro_torch.launch.specs.shard_layout`), gathers each layer whole just
before its block (`repro_torch.models.gather.NodeSplit`) and computes
every head of its rows (`repro_torch.launch.serve.StepBuffers`'s stored
form). Its decode cache is placed as the reference's ``cache_specs``
places it for the profile (`repro_torch.sharding.rules.CacheCut`):

* under ``zero3`` the K/V keep their cut over the model group (on the KV
  heads, else the head dim), and the SSM state and conv tail theirs (on
  the heads, on the channels), although the compute is whole: a decode
  step gathers each layer's cut cache over the group as it reads it
  (:func:`gather`, ``cache_gather`` bytes) and writes back only the
  rank's cut (:func:`take`) of what the step wrote. The reference's
  decode alignment constraint (``repro.models.attention``) applies only
  where ``kv_heads`` maps to a mesh axis, which ``zero3`` does not, and
  its comment says what GSPMD then does: it "re-gathers the whole
  multi-GB cache every step". A prefill writes its cut and attends over
  its own fresh K/V, gathering nothing;
* where the rows do not divide over the batch axes and the cache's
  sequence does (long-context decode at batch 1), the K/V's sequence is
  cut over the batch axes' group (``seq_view``): a rank writes only the
  positions it holds and the partial softmax combines over the group
  (`repro_torch.sharding.tensor.seq_softmax`), as under tensor
  parallelism.

The model's attention (`repro_torch.models.attention.attention`) and
blocks (`repro_torch.models.transformer.block_apply`) read :func:`current`
where no tensor plan is active. Outside :func:`cache_group` nothing
changes. The plan is a module global, as `repro_torch.sharding.tensor`'s.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

_PLAN = None


class CachePlan:
    """A served rank's cache placement: ``cut`` its `repro_torch.sharding.
    rules.CacheCut`, ``view`` the model group the cut parts are gathered
    over (None where nothing is cut), ``seq_view`` the group the K/V's
    sequence is cut over (None: whole)."""

    def __init__(self, cut, view=None, seq_view=None):
        self.cut = cut
        self.view = view if cut.cut else None
        self.seq_view = seq_view
        self.rank = 0 if self.view is None else self.view.rank

    def __repr__(self) -> str:
        return (f"CachePlan({self.cut}, view={self.view}, "
                f"seq_view={self.seq_view})")


@contextmanager
def cache_group(plan):
    """Within the block, ``plan`` (a :class:`CachePlan`, or None) places
    the decode cache the forward reads and writes."""
    global _PLAN
    prev, _PLAN = _PLAN, plan
    try:
        yield plan
    finally:
        _PLAN = prev


def current():
    """The running forward's :class:`CachePlan`, or None."""
    return _PLAN


def gather(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's cuts of a cache tensor along ``dim``, whole (an
    all_gather, ``cache_gather`` bytes); ``t`` itself where the plan cuts
    nothing."""
    if _PLAN is None or _PLAN.view is None:
        return t
    from repro_torch.sharding.tensor import _all_gather
    return _all_gather(_PLAN.view, t, dim, kind="cache_gather")


def whole_kv(cache: dict):
    """A decode step's K/V ``[B, T, nkv, hd]`` of a layer's cache: the
    rank's cut gathered over the model group where the plan cuts them (on
    the KV heads, or the head dim), else the cache's own."""
    kv = _PLAN.cut.kv
    if _PLAN.view is None or kv not in ("kv_heads", "head_dim"):
        return cache["k"], cache["v"]
    dim = 2 if kv == "kv_heads" else 3
    return gather(cache["k"], dim), gather(cache["v"], dim)


def take(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """This rank's cut of a whole tensor along ``dim``, ``n`` wide (a
    view)."""
    return t.narrow(dim, _PLAN.rank * n, n)
