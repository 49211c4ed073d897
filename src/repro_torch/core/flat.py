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

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def slots(self) -> int:
        return 2 * self.size if self.wide else self.size


class FlatLayout:
    """Fixed leaf order over a flat parameter vector of length ``size``
    (slots; ``wide`` names the leaves held as f32 in a 16-bit buffer)."""

    def __init__(self, leaves: Sequence[Tuple[str, Sequence[int]]],
                 wide: Iterable[str] = ()):
        wide = frozenset(wide)
        leaves = [Leaf(path, tuple(int(s) for s in shape), 0, path in wide)
                  for path, shape in leaves]
        if wide - {leaf.path for leaf in leaves}:
            raise ValueError(f"wide leaves {sorted(wide)} not in the layout")
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
        if wide and off % 2:
            self._sizes.append(1)
            off += 1
        self.size = off

    @classmethod
    def of_module(cls, module: torch.nn.Module) -> "FlatLayout":
        return cls([(name, p.shape) for name, p in module.named_parameters()])

    @classmethod
    def of_payload(cls, payload: Dict[str, torch.Tensor]) -> "FlatLayout":
        """The layout of a flat payload dict (``{"head/out/b": ...}``, the
        heterogeneous swarm's wire payload): its paths sorted, the
        reference's leaf order."""
        return cls([(k, tuple(payload[k].shape)) for k in sorted(payload)])

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``[..., P]`` → {path: ``[..., *shape]`` view}. One ``split``, so the
        gradient of a loss over the views comes back as one flat ``[..., P]``
        tensor (the split's backward is a single concatenation); a wide
        leaf's f32 view carries no gradient."""
        lead = flat.shape[:-1]
        if self.wide and flat.element_size() != 2:
            raise ValueError(f"a layout with wide leaves needs a 16-bit "
                             f"buffer, got {flat.dtype}")
        parts = flat.split(self._sizes, dim=-1)
        views = {}
        for i, part in zip(self._order, parts):
            leaf = self.leaves[i]
            if leaf.wide:
                part = part.view(torch.float32)
            views[leaf.path] = part.reshape(lead + leaf.shape)
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
