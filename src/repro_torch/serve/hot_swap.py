"""Zero-downtime hot-swap: an atomic double-buffered ensemble param slot.
Port of ``repro.serve.hot_swap``.

The ensemble is the swarm state's form: one stacked ``[N, P]`` tensor (and
the :class:`~repro_torch.core.flat.FlatLayout` of a node's params).

1. ``ingest(path)`` reads ONLY the stacked per-node params out of a full
   ``SwarmSession.save`` checkpoint — of either package — through
   `repro_torch.core.session.load_checkpoint_params`, and checks the node
   count against the live ensemble.
2. ``publish`` stages the new buffer under a fresh version number FIRST and
   flips the live version pointer LAST, so a reader always sees one
   complete buffer.
3. In-flight requests are pinned to the version they were admitted under;
   the engine dispatches one decode per live version during the transition
   window.
4. Superseded buffers stay resident until ``retire`` observes that no live
   slot pins them; the engine calls it every tick.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch

from repro_torch.core.flat import FlatLayout
from repro_torch.core.session import load_checkpoint_params


def _spec(params: torch.Tensor) -> Tuple:
    return tuple(params.shape), params.dtype, params.device


class HotSwapSlot:
    """Double-buffered stacked-ensemble params ``[N, P]`` with version
    pinning."""

    def __init__(self, params: torch.Tensor,
                 layout: Optional[FlatLayout] = None):
        if params.dim() != 2:
            raise ValueError(f"stacked params must be [N, P], got "
                             f"{tuple(params.shape)}")
        if layout is not None and layout.size != params.shape[1]:
            raise ValueError(f"layout covers {layout.size} values, the "
                             f"params have {params.shape[1]}")
        self.layout = layout
        self._buffers: Dict[int, torch.Tensor] = {0: params}
        self._version = 0

    @property
    def version(self) -> int:
        return self._version

    @property
    def versions(self) -> Tuple[int, ...]:
        return tuple(sorted(self._buffers))

    @property
    def live(self) -> torch.Tensor:
        return self._buffers[self._version]

    def buffer(self, version: int) -> torch.Tensor:
        return self._buffers[version]

    def publish(self, params: torch.Tensor) -> int:
        """Atomically make ``params`` the live ensemble; returns its version."""
        if not isinstance(params, torch.Tensor) or \
                _spec(params) != _spec(self.live):
            raise ValueError(
                "published params do not match the live ensemble's shape / "
                "dtype / device")
        staged = self._version + 1
        self._buffers[staged] = params   # stage the complete buffer first ...
        self._version = staged           # ... flip the pointer last
        return staged

    def ingest(self, path: str, *, expect_nodes: Optional[int] = None) -> int:
        """Load the stacked params from a ``SwarmSession.save`` checkpoint
        and publish them as the new live version."""
        return self.publish(load_checkpoint_params(
            path, self.live, layout=self.layout, expect_nodes=expect_nodes))

    def retire(self, pinned: Iterable[int]) -> None:
        """Drop buffers no in-flight request pins (live always survives)."""
        keep = {int(v) for v in pinned} | {self._version}
        for version in [v for v in self._buffers if v not in keep]:
            del self._buffers[version]
