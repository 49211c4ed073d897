"""Carry state between the reference's param trees and the port's flat
buffers.

The reference keeps params as nested dicts/lists of arrays (``stem`` /
``blocks`` / ``head``; convs HWIO); the port keeps one flat f32 vector per
node in a :class:`~repro_torch.core.flat.FlatLayout` (convs OIHW, the same
leaf paths dotted). These functions take and give numpy trees, so both
packages can be fed the same weights and AdamW state. A flat payload dict's
``/``-joined keys (``"head/out/b"``) contain no dot, so they pass through
as single keys. :func:`zoo_node_from_reference` carries a node of the
reference's model zoo across: its backbone (CNN convs HWIO → OIHW) and the
whole head, its frozen ``proj/w`` included.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.flat import FlatLayout
from repro_torch.models import zoo


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


def tree_from_reference(tree):
    """Reference numpy tree (nested dicts/lists) → the same tree of f32 CPU
    tensors, layouts unchanged."""
    if isinstance(tree, dict):
        return {k: tree_from_reference(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_reference(v) for v in tree)
    return torch.from_numpy(np.array(tree, np.float32))


def zoo_node_from_reference(family: str, template, *,
                            feat_dim: int) -> zoo.ZooNode:
    """A reference ``ZooNode``'s ``family`` and numpy ``template``
    (``{"backbone", "head"}``) → the port's :class:`~repro_torch.models.zoo.
    ZooNode`: a DenseNet backbone becomes the ``{dotted path: tensor}`` dict
    of its :class:`HistoCNN` (convs OIHW); MLP and head weights keep their
    ``[in, out]`` layout."""
    bb = template["backbone"]
    if family in zoo.CNN_FAMILIES:
        layout = FlatLayout.of_module(zoo.cnn_model(family, feat_dim))
        backbone = layout.unflatten(from_reference(layout, bb))
        backbone = {k: v.clone() for k, v in backbone.items()}
    else:
        backbone = tree_from_reference(bb)
    return zoo.ZooNode(family=family,
                       template={"backbone": backbone,
                                 "head": tree_from_reference(
                                     template["head"])},
                       features=zoo.backbone_features(family,
                                                      feat_dim=feat_dim))
