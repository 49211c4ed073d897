"""Carry state between the reference's param trees and the port's flat
buffers.

The reference keeps params as nested dicts/lists of arrays (``stem`` /
``blocks`` / ``head``; convs HWIO); the port keeps one flat f32 vector per
node in a :class:`~repro_torch.core.flat.FlatLayout` (convs OIHW, the same
leaf paths dotted). These functions take and give numpy trees, so both
packages can be fed the same weights and AdamW state.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.flat import FlatLayout


def _get(tree, path: str):
    for part in path.split("."):
        tree = tree[int(part)] if part.isdigit() else tree[part]
    return tree


def _listify(node):
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


def _conv_axes(lead: int, to_torch: bool):
    """Permutation of the last four axes: HWIO → OIHW or back."""
    tail = (3, 2, 0, 1) if to_torch else (2, 3, 1, 0)
    return tuple(range(lead)) + tuple(lead + a for a in tail)


def from_reference(layout: FlatLayout, tree, lead: int = 0) -> torch.Tensor:
    """Reference param tree (leaves ``[*lead, *shape]``) → flat
    ``[*lead, P]`` f32 CPU tensor."""
    parts = []
    for leaf in layout.leaves:
        a = np.asarray(_get(tree, leaf.path), np.float32)
        if len(leaf.shape) == 4:
            a = np.transpose(a, _conv_axes(lead, to_torch=True))
        parts.append(a.reshape(a.shape[:lead] + (leaf.size,)))
    return torch.from_numpy(np.ascontiguousarray(np.concatenate(parts, -1)))


def to_reference_tree(layout: FlatLayout, flat: torch.Tensor) -> Any:
    """Flat ``[*lead, P]`` → reference param tree of numpy arrays."""
    flat = flat.detach().to("cpu", torch.float32)
    lead = flat.dim() - 1
    root: Dict = {}
    for leaf, part in zip(layout.leaves,
                          flat.split([lf.size for lf in layout.leaves], -1)):
        a = part.reshape(tuple(flat.shape[:-1]) + leaf.shape).numpy()
        if len(leaf.shape) == 4:
            a = np.ascontiguousarray(
                np.transpose(a, _conv_axes(lead, to_torch=False)))
        node = root
        keys = [int(p) if p.isdigit() else p for p in leaf.path.split(".")]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = a
    return _listify(root)


def adamw_from_reference(layout: FlatLayout, opt_state, lead: int = 0):
    """Reference AdamW state ``{"mu", "nu", "count"}`` → the port's."""
    return {"mu": from_reference(layout, opt_state["mu"], lead),
            "nu": from_reference(layout, opt_state["nu"], lead),
            "count": torch.as_tensor(np.array(opt_state["count"]),
                                     dtype=torch.int32)}
