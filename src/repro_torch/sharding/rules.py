"""Param partition specs from leaf paths: port of ``repro.sharding.rules``.

The reference derives each param leaf's ``PartitionSpec`` from its tree
path with a regex table (:data:`_PARAM_RULES`) over a logical-to-mesh axis
table (:data:`DEFAULT_LOGICAL`), and drops a mesh axis from a dimension it
does not divide. The port keeps copies of both tables and of
:func:`spec_for_path` and :func:`param_specs`; a spec here is a tuple with
one entry per dimension of the reference's leaf (a conv is HWIO there):
``None`` (replicated), an axis name, or a tuple of axis names (major
first). ``param_specs`` returns ``{dotted leaf path: spec}``, the form the
gossip backend takes as ``param_specs`` / ``inner_specs``
(`repro_torch.core.flat.ShardLayout` cuts each rank's shard by it).

The rules read the reference's ``/``-joined paths; a port path is dotted
(``layers.ssm.in_proj.w``), and its dots are read as ``/``, which gives
the reference's match on every leaf. The table's comments are the
reference's intent, not always its effect: on a scan-stacked leaf
``[L, ...]`` a two-entry rule lands one dimension early (``ssm.*in_proj``
puts ``fsdp`` on the layer axis and ``ff`` on d_model), and the port
reproduces that placement as it is.

The reference's activation constraints (``sharding_rules``,
``logical_shard``, ``constrain_block_params``) and ``shardings_for`` have no
counterpart: they are GSPMD sharding constraints on one program's arrays,
and no-ops outside a mesh. The port runs one process a rank, and what a
rank holds is decided by the specs alone.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple, Union

# Logical axis -> mesh axis (the reference's table, copied). "data" may be a
# tuple ("pod", "data") on the multi-pod mesh.
DEFAULT_LOGICAL = {
    "batch": "data",
    "seq": None,
    "heads": "model",
    "kv_heads": "model",
    "attn_seq": "model",
    "head_dim": "model",
    "res_seq": "model",
    "ff": "model",
    "embed": None,
    "vocab": "model",
    "experts": "model",
    "moe_slots": ("pod", "data", "model"),
    "state": None,
}

# Each rule: (path regex, spec builder taking the resolved table). Weight
# matrices are [in, out]: the "wide" axis over `model`, the other (FSDP)
# over `data` (the reference's table, copied).
_PARAM_RULES = [
    (r"embed_tied.*table$", lambda t: (t["vocab"], None)),
    (r"embed.*table$", lambda t: (None, t["heads"])),
    (r"(unembed|lm_head).*w$", lambda t: (None, t["vocab"])),
    (r"attn.*\b(q|k|v)\b.*w$", lambda t: (t["fsdp"], t["heads"])),
    (r"attn.*\bo\b.*w$", lambda t: (t["heads"], t["fsdp"])),
    (r"cross.*\b(q|k|v)\b.*w$", lambda t: (t["fsdp"], t["heads"])),
    (r"cross.*\bo\b.*w$", lambda t: (t["heads"], t["fsdp"])),
    (r"mlp.*(gate|up).*w$", lambda t: (t["fsdp"], t["ff"])),
    (r"mlp.*down.*w$", lambda t: (t["ff"], t["fsdp"])),
    (r"experts.*(gate|up).*w$", lambda t: (t["experts"], t["fsdp"], None)),
    (r"experts.*down.*w$", lambda t: (t["experts"], None, t["fsdp"])),
    (r"router.*w$", lambda t: (None, None)),
    (r"ssm.*in_proj.*w$", lambda t: (t["fsdp"], t["ff"])),
    (r"ssm.*out_proj.*w$", lambda t: (t["ff"], t["fsdp"])),
    (r"ssm.*conv.*", lambda t: (None, t["ff"])),
    (r"lora.*", lambda t: (None,)),
    (r"projector.*w$", lambda t: (None, None)),
]

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]


def spec_for_path(path: str, table: dict) -> Spec:
    """The first rule matching ``path`` (dotted or ``/``-joined), built
    from the resolved ``table``; ``()`` (replicated) when none does."""
    ref_path = path.replace(".", "/")
    for pat, builder in _PARAM_RULES:
        if re.search(pat, ref_path):
            return builder(table)
    return ()


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a mesh: a dict, a `repro_torch.launch.mesh.
    SwarmMesh` (its ``shape``), or any object with ``axis_names`` and
    ``devices.shape`` (what the reference's ``param_specs`` reads of a
    mesh)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    if hasattr(mesh, "axis_names"):
        return dict(zip(mesh.axis_names, mesh.devices.shape))
    return dict(mesh.shape)


def _reference_shapes(layout_or_shapes) -> Dict[str, Tuple[int, ...]]:
    """``{path: the reference's leaf shape}`` of a `FlatLayout` (a conv
    transposed to HWIO through ``Leaf.ref_axes``) or of a ``{path:
    shape}`` dict (taken as the reference's shapes)."""
    leaves = getattr(layout_or_shapes, "leaves", None)
    if leaves is None:
        return {p: tuple(int(s) for s in shape)
                for p, shape in layout_or_shapes.items()}
    return {lf.path: tuple(lf.shape[a] for a in lf.ref_axes)
            for lf in leaves}


def param_specs(layout_or_shapes, mesh, *, fsdp: Union[bool, str,
                                                        Sequence[str]] = True,
                logical: Optional[dict] = None) -> Dict[str, Spec]:
    """``{path: spec}`` for every leaf of ``layout_or_shapes``, one entry
    per dimension of the reference's leaf.

    ``fsdp=True`` also shards the non-model weight axis over ``data`` where
    it divides (the reference's ZeRO-3 option); a name or names shard it
    over those axes, ``False`` not at all. A mesh axis the mesh lacks maps
    to None, and a dimension a spec's axes do not divide is replicated, as
    in the reference."""
    table = dict(DEFAULT_LOGICAL if logical is None else logical)
    sizes = mesh_axis_sizes(mesh)
    axis_names = set(sizes)

    def ok(v):
        if isinstance(v, tuple):
            kept = tuple(a for a in v if a in axis_names)
            return kept or None
        return v if v in axis_names else None

    table = {k: ok(v) for k, v in table.items()}
    if fsdp is True:
        table["fsdp"] = "data" if "data" in axis_names else None
    elif fsdp:
        table["fsdp"] = ok(tuple(fsdp) if not isinstance(fsdp, str)
                           else fsdp)
    else:
        table["fsdp"] = None

    def one(path, shape):
        spec = spec_for_path(path, table)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        fixed = []
        for dim, ax in zip(shape, entries):
            if ax is None:
                fixed.append(None)
                continue
            n = 1
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                n *= sizes.get(a, 1)
            fixed.append(ax if n and dim % n == 0 else None)
        return tuple(fixed)

    return {path: one(path, shape)
            for path, shape in _reference_shapes(layout_or_shapes).items()}
