"""LoRA adapters as the swarm exchange payload.

Port of ``repro.core.lora`` over trees of torch tensors (nested dicts and
lists, as the reference's pytrees). Any 2-D (or stacked 3-D) projection
matrix named ``w`` under a matching module gains ``lora_A`` / ``lora_B`` /
``lora_scale`` siblings (:func:`inject_lora`); the heterogeneous swarm's wire
payload is the flat, path-keyed dict :func:`flatten_payload` takes out of a
full-params tree, with the reference's own path strings
(``"head/proj/lora_A"``, sorted), so payload rows stack, quantize and
checkpoint as the reference's do.

The tree walk visits dict keys in sorted order and list entries by index,
which is ``jax.tree_util``'s flatten order; ``None`` is an empty subtree.
"""
from __future__ import annotations

import math
import re
from typing import Callable, Iterator, Optional, Tuple

import torch

DEFAULT_TARGETS = r"(attn|cross|mlp|experts|in_proj|out_proj|lm_head|head)"


def inject_lora(params, generator: torch.Generator, rank: int = 16,
                alpha: float = 32.0, targets: str = DEFAULT_TARGETS):
    """A new tree with LoRA leaves added to every matching linear: ``A``
    drawn N(0, 1/rank) from ``generator`` (in the tree's dict order), ``B``
    zero, ``scale = alpha / rank`` (f32; one per layer for a stacked
    ``[L, in, out]`` weight)."""
    def rec(node, path):
        if isinstance(node, list):
            return [rec(v, f"{path}/{i}") for i, v in enumerate(node)]
        if not isinstance(node, dict):
            return node
        out = {k: rec(v, f"{path}/{k}") for k, v in node.items()}
        w = node.get("w")
        if (isinstance(w, torch.Tensor) and w.dim() in (2, 3)
                and re.search(targets, path) and "lora_A" not in node):
            if w.dim() == 2:
                i, o = w.shape
                a_shape, b_shape = (i, rank), (rank, o)
                scale = torch.tensor(alpha / rank, dtype=torch.float32)
            else:  # stacked over layers: [L, in, out]
                n_layers, i, o = w.shape
                a_shape, b_shape = (n_layers, i, rank), (n_layers, rank, o)
                scale = torch.full((n_layers,), alpha / rank,
                                   dtype=torch.float32)
            out["lora_A"] = (torch.randn(a_shape, generator=generator)
                             / math.sqrt(rank)).to(w.dtype)
            out["lora_B"] = torch.zeros(b_shape, dtype=w.dtype)
            out["lora_scale"] = scale
        return out

    return rec(params, "")


def lora_shapes(shapes, rank: int, targets: str = DEFAULT_TARGETS):
    """:func:`inject_lora` on a tree of shapes (tuples as leaves): the
    adapter leaves' shapes the injected tree has, ``lora_scale`` ``()`` or
    ``(L,)`` for a stacked ``[L, in, out]`` weight."""
    def rec(node, path):
        if not isinstance(node, dict):
            return node
        out = {k: rec(v, f"{path}/{k}") for k, v in node.items()}
        w = node.get("w")
        if (isinstance(w, tuple) and len(w) in (2, 3)
                and re.search(targets, path) and "lora_A" not in node):
            *lead, i, o = w
            out["lora_A"] = (*lead, i, rank)
            out["lora_B"] = (*lead, rank, o)
            out["lora_scale"] = tuple(lead)
        return out

    return rec(shapes, "")


def is_adapter_path(path: str) -> bool:
    return "lora_" in path


def payload_path_str(path: Tuple) -> str:
    """Canonical ``/``-joined path string of a key tuple (dict keys and
    list indices)."""
    return "/".join(str(k) for k in path)


def _walk(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, object]]:
    """(key tuple, leaf) pairs in flatten order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _map_with_path(fn: Callable, tree, path: Tuple = ()):
    """``tree`` with every leaf replaced by ``fn(key tuple, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def flatten_payload(params, select: Optional[Callable[[str], bool]] = None):
    """The wire-payload leaves of ``params`` as ONE flat ``{path: leaf}``
    dict, sorted by path. ``select(path) -> bool`` picks the leaves that
    cross the wire (default :func:`is_adapter_path`). Raises when nothing
    matches. :func:`unflatten_payload` is the inverse against a template."""
    select = select or is_adapter_path
    out = {}
    for p, x in _walk(params):
        s = payload_path_str(p)
        if select(s):
            out[s] = x
    if not out:
        raise ValueError("flatten_payload: no leaf matched the payload "
                         "selector (nothing would cross the wire)")
    return dict(sorted(out.items()))


def unflatten_payload(flat, template):
    """Write the flat payload leaves back into a full-params ``template``;
    leaves whose path is not in ``flat`` pass through untouched, so
    gradients flow through the payload leaves only. Raises when a payload
    path has no place in the template."""
    used = set()

    def sub(p, x):
        s = payload_path_str(p)
        if s in flat:
            used.add(s)
            return flat[s]
        return x

    out = _map_with_path(sub, template)
    missing = set(flat) - used
    if missing:
        raise ValueError("unflatten_payload: payload paths not present in "
                         f"the template: {sorted(missing)[:4]}")
    return out


def split_adapters(params):
    """(adapters, base): the same tree twice, the other kind's leaves
    replaced by None."""
    def select(pred):
        return _map_with_path(
            lambda p, x: x if pred(payload_path_str(p)) else None, params)

    return (select(is_adapter_path),
            select(lambda s: not is_adapter_path(s)))


def combine(adapters, base):
    """Inverse of :func:`split_adapters`."""
    if base is None:
        return adapters
    if isinstance(base, dict):
        return {k: combine(None if adapters is None else adapters.get(k), v)
                for k, v in base.items()}
    if isinstance(base, (list, tuple)):
        return type(base)(combine(None if adapters is None else adapters[i],
                                  v) for i, v in enumerate(base))
    return base


def adapter_only(params):
    """The tree with ONLY its adapter leaves (others None)."""
    return split_adapters(params)[0]


def merge_lora_into_base(params):
    """Fold ``scale · A @ B`` into ``w`` and drop the adapters (deployment
    export), in f32, cast back to ``w``'s dtype."""
    def rec(node):
        if isinstance(node, list):
            return [rec(v) for v in node]
        if not isinstance(node, dict):
            return node
        out = {k: rec(v) for k, v in node.items()
               if not k.startswith("lora_")}
        if "lora_A" in node:
            a, b = node["lora_A"], node["lora_B"]
            scale = node["lora_scale"].to(torch.float32)
            delta = torch.einsum("...ir,...ro->...io", a.to(torch.float32),
                                 b.to(torch.float32))
            if scale.dim() == 1:  # stacked-over-layers scale [L]
                scale = scale[:, None, None]
            out["w"] = (node["w"].to(torch.float32)
                        + scale * delta).to(node["w"].dtype)
        return out

    return rec(params)


def payload_bytes(params, lora_only: bool) -> int:
    """Sync payload size in bytes: the adapter leaves, or every leaf."""
    tree = adapter_only(params) if lora_only else params
    return int(sum(x.numel() * x.element_size() for _, x in _walk(tree)))
