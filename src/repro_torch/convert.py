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

:func:`lm_params_from_reference` and :func:`lm_params_to_reference` carry
an LM's params (`repro_torch.models.build_model`): the reference's tree,
its layer leaves stacked ``[L, ...]``, and the port's flat vector over the
same paths (the vlm and enc-dec trees too: the projectors, the stacked
encoder and decoder layers). Layer i's params are views ``leaf[i]`` of the
stacked leaves
at run time (`repro_torch.models.transformer.layer_params`); keeping the
stacked leaves in the flat vector keeps the checkpoint keys the
reference's, so a reference ``SwarmSession.save`` of an LM ensemble loads
through `repro_torch.core.session.load_checkpoint_params` unchanged. The
way in keeps the arrays' dtype: f32, or bf16 (a JAX bf16 array arrives as
an ``ml_dtypes.bfloat16`` numpy array and is reinterpreted bit for bit),
and the leaves the reference keeps in f32 inside a bf16 model stay f32
(the layout's wide leaves).
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


def _ref_axes(leaf, lead: int, to_torch: bool):
    """Permutation of a ``[*lead, *shape]`` leaf: the stored layout to the
    reference's (a conv OIHW → HWIO) or back."""
    tail = leaf.ref_axes
    if to_torch:
        tail = tuple(sorted(range(len(tail)), key=tail.__getitem__))
    return tuple(range(lead)) + tuple(lead + a for a in tail)


def from_reference(layout: FlatLayout, tree, lead: int = 0,
                   dtype=None) -> torch.Tensor:
    """Reference param tree (leaves ``[*lead, *shape]``) → flat
    ``[*lead, P]`` CPU tensor, f32 (or ``dtype``)."""
    parts = {}
    for leaf in layout.leaves:
        a = np.array(_get(tree, leaf.path), np.float32)
        a = np.transpose(a, _ref_axes(leaf, lead, to_torch=True))
        parts[leaf.path] = torch.from_numpy(np.ascontiguousarray(a))
    return layout.flatten(parts, dtype)


def _nest(arrays: Dict[str, np.ndarray]) -> Any:
    """``{dotted path: array}`` → the reference's nested dicts/lists."""
    root: Dict = {}
    for path, a in arrays.items():
        node = root
        keys = [int(p) if p.isdigit() else p for p in path.split(".")]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = a
    return _listify(root)


def to_reference_tree(layout: FlatLayout, flat: torch.Tensor) -> Any:
    """Flat ``[*lead, P]`` → reference param tree of f32 numpy arrays (a
    conv OIHW → HWIO)."""
    flat = flat.detach().cpu()
    lead = flat.dim() - 1
    leaves = {leaf.path: leaf for leaf in layout.leaves}
    arrays = {}
    for path, part in layout.unflatten(flat).items():
        a = part.to(torch.float32).numpy()
        axes = _ref_axes(leaves[path], lead, to_torch=False)
        if axes != tuple(range(a.ndim)):
            a = np.ascontiguousarray(np.transpose(a, axes))
        arrays[path] = a
    return _nest(arrays)


def chunks_to_reference_tree(leaf_chunks, rows: torch.Tensor) -> Any:
    """Rows ``[R, C]`` of per-leaf chunks (`repro_torch.core.gossip.
    PaddedGrid.leaf_chunks`: each leaf's path, start and length in a
    chunk row) → the reference's tree of ``[R, length]`` f32 arrays, as
    its chunked mesh wire (a psum residual, a delegate chunk) keeps each
    leaf."""
    rows = rows.detach().cpu().to(torch.float32)
    return _nest({path: rows[:, b:b + c].numpy().copy()
                  for path, b, c in leaf_chunks})


def chunks_from_reference(leaf_chunks, tree) -> torch.Tensor:
    """Inverse of :func:`chunks_to_reference_tree`: ``[R, C]`` f32."""
    parts = sorted(leaf_chunks, key=lambda lc: lc[1])
    return torch.cat([torch.from_numpy(np.array(_get(tree, path),
                                                np.float32))
                      for path, _, _ in parts], 1)


def adamw_from_reference(layout: FlatLayout, opt_state, lead: int = 0):
    """Reference AdamW state ``{"mu", "nu", "count"}`` → the port's (the
    moments over the layout's values: a wide leaf's f32 value once)."""
    values = layout.value_layout
    return {"mu": from_reference(values, opt_state["mu"], lead),
            "nu": from_reference(values, opt_state["nu"], lead),
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


def _tensor(a) -> torch.Tensor:
    """numpy array (f32, or ``ml_dtypes.bfloat16`` by its bits) → tensor."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def lm_params_from_reference(layout: FlatLayout, tree, lead: int = 0,
                             dtype=None) -> torch.Tensor:
    """Reference LM param tree (leaves ``[*lead, *shape]``, layer leaves
    stacked ``[L, ...]``) → flat ``[*lead, P]`` CPU tensor in ``dtype``
    (default: the dtype of the leaves the layout does not hold wide; its
    wide leaves keep their f32 values)."""
    parts = {leaf.path: _tensor(_get(tree, leaf.path))
             for leaf in layout.leaves}
    if dtype is None:
        dtype = next(parts[leaf.path].dtype for leaf in layout.leaves
                     if not leaf.wide)
    return layout.flatten(parts, dtype)


def lm_params_to_reference(layout: FlatLayout, flat: torch.Tensor):
    """Flat ``[*lead, P]`` LM params → the reference's tree of f32 numpy
    arrays (exact for bf16 values; cast to bf16 on the reference's side)."""
    if layout.convs:
        raise ValueError("an LM layout has no conv leaves")
    return to_reference_tree(layout, flat)
