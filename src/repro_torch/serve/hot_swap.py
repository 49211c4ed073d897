"""Zero-downtime hot-swap: an atomic double-buffered ensemble param slot.
Port of ``repro.serve.hot_swap``.

The ensemble is the swarm state's form: one stacked ``[N, P]`` tensor (and
the :class:`~repro_torch.core.flat.FlatLayout` of a node's params).

1. The slot owns a pool of physical ``[N, P]`` buffers whose addresses
   never change, two from the start; a captured serving program reads one
   of them, so a version's params must stay where the program was
   captured. Buffer 0 adopts the constructor's tensor without a copy.
2. ``ingest(path)`` reads ONLY the stacked per-node params out of a full
   ``SwarmSession.save`` checkpoint — of either package — through
   `repro_torch.core.session.load_checkpoint_params`, and checks the node
   count against the live ensemble.
3. ``publish`` copies the new params into a buffer that no version still
   holds, under a fresh version number, FIRST and flips the live version
   pointer LAST, so a reader always sees one complete buffer. Only when
   every buffer is held (a swap during a swap) does the pool grow by one.
4. In-flight requests are pinned to the version they were admitted under;
   the engine dispatches one decode per live version during the transition
   window.
5. Superseded versions are dropped by ``retire`` once no live slot pins
   them (the engine calls it every tick); their buffer returns to the
   pool.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.core.flat import FlatLayout
from repro_torch.core.session import load_checkpoint_params


def _spec(params: torch.Tensor) -> Tuple:
    return tuple(params.shape), params.dtype, params.device


class HotSwapSlot:
    """Double-buffered stacked-ensemble params ``[N, P]`` with version
    pinning, over a pool of buffers with stable addresses."""

    def __init__(self, params: torch.Tensor,
                 layout: Optional[FlatLayout] = None):
        if params.dim() != 2:
            raise ValueError(f"stacked params must be [N, P], got "
                             f"{tuple(params.shape)}")
        if layout is not None and layout.size != params.shape[1]:
            raise ValueError(f"layout covers {layout.size} values, the "
                             f"params have {params.shape[1]}")
        self.layout = layout
        self._pool: List[torch.Tensor] = [params, torch.zeros_like(params)]
        self._held: Dict[int, int] = {0: 0}     # version -> pool index
        self._version = 0

    @property
    def version(self) -> int:
        return self._version

    @property
    def versions(self) -> Tuple[int, ...]:
        return tuple(sorted(self._held))

    @property
    def pool(self) -> Tuple[torch.Tensor, ...]:
        """The physical buffers, in pool order (it only grows)."""
        return tuple(self._pool)

    @property
    def live(self) -> torch.Tensor:
        return self.buffer(self._version)

    def index(self, version: int) -> int:
        """The pool index of ``version``'s buffer."""
        return self._held[version]

    def buffer(self, version: int) -> torch.Tensor:
        return self._pool[self._held[version]]

    def publish(self, params: torch.Tensor) -> int:
        """Atomically make ``params`` the live ensemble (copied into a free
        pool buffer); returns its version."""
        if not isinstance(params, torch.Tensor) or \
                _spec(params) != _spec(self.live):
            raise ValueError(
                "published params do not match the live ensemble's shape / "
                "dtype / device")
        held = set(self._held.values())
        free = [i for i in range(len(self._pool)) if i not in held]
        if free:
            index = free[0]
        else:
            self._pool.append(torch.empty_like(self.live))
            index = len(self._pool) - 1
        self._pool[index].copy_(params)  # stage the complete buffer first ...
        staged = self._version + 1
        self._held[staged] = index
        self._version = staged           # ... flip the pointer last
        return staged

    def ingest(self, path: str, *, expect_nodes: Optional[int] = None) -> int:
        """Load the stacked params from a ``SwarmSession.save`` checkpoint
        and publish them as the new live version."""
        return self.publish(load_checkpoint_params(
            path, self.live, layout=self.layout, expect_nodes=expect_nodes))

    def retire(self, pinned: Iterable[int]) -> None:
        """Drop versions no in-flight request pins (live always survives);
        their buffers return to the pool."""
        keep = {int(v) for v in pinned} | {self._version}
        for version in [v for v in self._held if v not in keep]:
            del self._held[version]
