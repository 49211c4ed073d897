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

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch


@dataclass(frozen=True)
class Leaf:
    path: str
    shape: Tuple[int, ...]
    offset: int

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


class FlatLayout:
    """Fixed leaf order over a flat parameter vector of length ``size``."""

    def __init__(self, leaves: Sequence[Tuple[str, Sequence[int]]]):
        out: List[Leaf] = []
        off = 0
        for path, shape in leaves:
            leaf = Leaf(path, tuple(int(s) for s in shape), off)
            out.append(leaf)
            off += leaf.size
        self.leaves: Tuple[Leaf, ...] = tuple(out)
        self.size = off
        self._sizes = [leaf.size for leaf in self.leaves]

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
        tensor (the split's backward is a single concatenation)."""
        lead = flat.shape[:-1]
        parts = flat.split(self._sizes, dim=-1)
        return {leaf.path: part.reshape(lead + leaf.shape)
                for leaf, part in zip(self.leaves, parts)}

    def flatten(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """{path: tensor of the leaf's shape} → contiguous ``[P]``."""
        return torch.cat([params[leaf.path].reshape(-1)
                          for leaf in self.leaves])
