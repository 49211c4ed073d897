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

The reference's activation constraints decide how a layer's *work* is
divided over ``model`` (tensor parallelism): ``constrain_block_params``
pins each per-layer leaf to its rule's spec (:func:`block_spec`), and
``logical_shard`` cuts each activation where the mesh axis divides it and
leaves it to the compiler otherwise. The port runs one process a rank and
makes those decisions explicit: :func:`axis_size` is the reference's, and
:func:`placement` says per module what ``logical_shard`` decides on a
config's shapes at a model size M (attention head-parallel when the KV
heads divide M, else sequence-parallel on the query side; ``ff``,
experts, SSM heads, the embedding's d_model and the vocab cut where M
divides them, whole otherwise; the residual stream cut on the sequence
between blocks). :func:`compute_cut` turns a placement into each leaf's
**compute block**: the slices of a per-layer leaf a model rank computes
with (`repro_torch.core.flat.LayerCut` delivers them over the shard
group, `repro_torch.sharding.tensor` runs the blocks). Where M does not
divide an axis, the leaf stays whole on every model rank and the block
computes it on the rank's own rows of the sequence (or on the whole
sequence, then keeps its rows): the work is never the whole layer's
gathered instead. :func:`compute_blocks` gives a node's every leaf's
block for a rank that serves from its blocks alone, and
:func:`cache_cut` / :func:`cache_shapes` the reference's decode-cache
placement (K/V on ``kv_heads``, else ``head_dim``, and on the sequence
over ``data`` where the batch does not divide over it; the SSM state on
its heads; an enc-dec's encoder output whole). ``shardings_for`` has no
counterpart.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
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

#: the reference dry run's sharding profiles (``repro.launch.dryrun.
#: PROFILES``, copied): ``dp`` and ``zero3`` map every logical axis to
#: None, so nothing is tensor-parallel, and divide the batch over
#: ``("data", "model")``
PROFILES = {
    "default": DEFAULT_LOGICAL,
    "dp": {**{k: None for k in DEFAULT_LOGICAL}, "batch": ("data", "model")},
    "zero3": {**{k: None for k in DEFAULT_LOGICAL},
              "batch": ("data", "model")},
}
#: each profile's ``fsdp`` (the reference's ``_PROFILE_FSDP``, copied):
#: ``dp`` cuts params over ``data`` alone (a block replicated over the
#: model ranks), ``zero3`` over the whole grid
PROFILE_FSDP = {"default": True, "dp": True, "zero3": ("data", "model")}

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


# ---------------------------------------------------------------------------
# tensor parallelism: the per-layer specs and the placements of the work
# ---------------------------------------------------------------------------

def axis_size(logical: str, sizes: Dict[str, int],
              logical_table: Optional[dict] = None) -> int:
    """The product of the mesh-axis sizes ``logical`` maps to (1 when it
    maps to none): the reference's ``axis_size`` under its rules on a
    mesh of ``sizes``."""
    ax = (DEFAULT_LOGICAL if logical_table is None
          else logical_table).get(logical)
    n = 1
    for a in (() if ax is None else ax if isinstance(ax, tuple) else (ax,)):
        n *= sizes.get(a, 1)
    return n


def block_spec(path: str, shape: Sequence[int],
               sizes: Dict[str, int]) -> Spec:
    """The spec ``constrain_block_params`` pins a *per-layer* leaf to (its
    rule over the table with ``fsdp`` = ``batch`` = ``data``), an axis dropped
    where it does not divide the dimension: for a stacked ``[L, ...]``
    leaf, its spec without the layer axis, where :func:`param_specs` gives
    the stored leaf's spec one dimension early."""
    return param_specs({path: tuple(shape)}, sizes)[path]


@dataclass(frozen=True)
class Placement:
    """How a layer's work divides over a node's model group of ``model``
    ranks (what the reference's ``logical_shard`` calls decide on the
    config's shapes). ``attention``: ``"heads"`` (q, k, v and the output
    cut on heads: KV heads divide M), ``"sequence"`` (a rank's rows of the
    query over the whole K/V, weights whole) or ``"none"`` (no attention);
    ``ff`` the MLP's hidden axis cut; ``experts`` the MoE's experts cut
    (else whole, each rank running every expert on its rows); ``ssm_heads``
    the SSM's heads cut (its B/C columns whole, or the groups its heads
    read; whole where a rank's heads would read their groups unevenly, as
    ``ff`` and the experts are taken whole); ``embed`` the embedding table's cut (``"vocab"`` for a tied
    table, ``"d_model"`` for an input-only one, or ``"whole"``); ``vocab``
    the logits cut (the tied table or ``lm_head``; with ``vocab`` False the
    logits and ``lm_head`` stay whole and a tied table ``"whole"``)."""
    model: int
    attention: str
    ff: bool
    experts: bool
    ssm_heads: bool
    embed: str
    vocab: bool


def placement(cfg, model: int) -> Placement:
    """The :class:`Placement` of ``cfg`` (a `repro_torch.configs.base.
    ModelConfig` of a decoder-only family or the enc-dec audio family,
    whose encoder self-attention and decoder cross-attention take the
    decoder self-attention's ``attention`` and whose ``lm_head`` is
    ``vocab``) over ``model`` ranks."""
    sizes = {"model": int(model)}

    def cut(logical, n):
        m = axis_size(logical, sizes)
        return m > 1 and n > 0 and n % m == 0

    attention = "none" if cfg.family == "ssm" else (
        "heads" if cut("kv_heads", cfg.n_kv_heads) else "sequence")
    ssm = cfg.family in ("ssm", "hybrid") and cut("ff", cfg.n_ssm_heads) \
        and cut("ff", cfg.d_inner) and all(
            _groups_even(cfg, sizes["model"], r) for r in range(model))
    vocab = cut("vocab", cfg.padded_vocab)
    if cfg.tie_embeddings:
        embed = "vocab" if vocab else "whole"
    else:
        embed = "d_model" if cut("heads", cfg.d_model) else "whole"
    return Placement(model=sizes["model"], attention=attention,
                     ff=cfg.family != "moe" and cut("ff", cfg.d_ff),
                     experts=cfg.family == "moe" and cut("experts",
                                                         cfg.n_experts),
                     ssm_heads=ssm, embed=embed, vocab=vocab)


Intervals = Tuple[Tuple[int, int], ...]


def _chunk(n: int, m: int, i: int) -> Intervals:
    return ((i * (n // m), n // m),)


def _groups_read(cfg, model: int, rank: int) -> Tuple[int, int]:
    """``(first group, groups)`` of the SSM's B/C groups model rank
    ``rank``'s heads read under a heads cut."""
    h, g = cfg.n_ssm_heads, cfg.ssm_groups
    hl, per = h // model, h // g
    h0 = rank * hl
    return h0 // per, (h0 + hl - 1) // per - h0 // per + 1


def _groups_even(cfg, model: int, rank: int) -> bool:
    """Whether model rank ``rank``'s heads read their groups evenly: one
    group, or whole groups from a group's first head (the scan maps local
    head j to local group j // (heads / groups))."""
    hl, per = cfg.n_ssm_heads // model, cfg.n_ssm_heads // cfg.ssm_groups
    return _groups_read(cfg, model, rank)[1] == 1 or (
        hl % per == 0 and rank * hl % per == 0)


def ssm_groups_of(cfg, model: int, rank: int) -> Tuple[int, int]:
    """``(first group, groups)`` of the SSM's B/C groups that model rank
    ``rank``'s heads read under a heads cut; raises where its heads read
    their groups unevenly (:func:`placement` keeps the heads whole
    there)."""
    if not _groups_even(cfg, model, rank):
        raise ValueError(f"{cfg.name}: {cfg.n_ssm_heads // model} SSM "
                         f"heads a rank read {cfg.ssm_groups} groups "
                         "unevenly")
    return _groups_read(cfg, model, rank)


def compute_cut(cfg, place: Placement, path: str, shape: Sequence[int],
                rank: int) -> Tuple[Intervals, ...]:
    """Model rank ``rank``'s compute block of the per-layer leaf ``path``
    (dotted; a stacked leaf's shape without its layer axis): per
    dimension, the ``(start, length)`` intervals of the leaf it takes, in
    order (several on a packed dimension: the SSM's ``in_proj`` and
    ``conv`` columns, cut by part). An enc-dec's cross-attention
    (``dec_layers.cross.*``) is cut as self-attention is, and its encoder
    layers (``enc_layers.*``) as a decoder-only layer; its
    ``frontend_proj`` and every norm stay whole."""
    m = place.model
    whole = tuple(((0, n),) for n in shape)
    keys = path.split(".")
    name, last = keys[-2] if len(keys) > 1 else "", keys[-1]

    def on(dim, ivs):
        out = list(whole)
        out[dim] = ivs
        return tuple(out)

    if place.attention == "heads" and (".attn." in f".{path}"
                                       or ".cross." in f".{path}"):
        if name in ("q", "k", "v"):        # column-parallel
            if last in ("w", "lora_B"):
                return on(1, _chunk(shape[1], m, rank))
            if last == "b":
                return on(0, _chunk(shape[0], m, rank))
        if name == "o" and last in ("w", "lora_A"):   # row-parallel
            return on(0, _chunk(shape[0], m, rank))
        return whole
    if ".mlp." in f".{path}" and place.ff:
        if name in ("gate", "up"):
            if last in ("w", "lora_B"):
                return on(1, _chunk(shape[1], m, rank))
            if last == "b":
                return on(0, _chunk(shape[0], m, rank))
        if name == "down" and last in ("w", "lora_A"):
            return on(0, _chunk(shape[0], m, rank))
        return whole
    if ".experts." in f".{path}" and place.experts:
        return on(0, _chunk(shape[0], m, rank))
    if ".ssm." in f".{path}" and place.ssm_heads:
        di, h = cfg.d_inner, cfg.n_ssm_heads
        gn = cfg.ssm_groups * cfg.ssm_state
        n = cfg.ssm_state
        g0, ng = ssm_groups_of(cfg, m, rank)
        dil, hl = di // m, h // m
        heads = ((rank * dil, dil),)
        bc = lambda base: ((base + g0 * n, ng * n), (base + gn + g0 * n,
                                                     ng * n))
        if name == "in_proj" and last in ("w", "b", "lora_B"):
            cols = ((rank * dil, dil), (di + rank * dil, dil)) + bc(2 * di) \
                + ((2 * di + 2 * gn + rank * hl, hl),)
            return on(len(shape) - 1, cols)
        if name == "conv":
            return on(len(shape) - 1, heads + bc(di))
        if last in ("A_log", "D", "dt_bias"):
            return on(0, _chunk(shape[0], m, rank))
        if last == "norm_scale":
            return on(0, heads)
        if name == "out_proj" and last in ("w", "lora_A"):
            return on(0, heads)
        return whole
    if path.startswith("embed_tied.") and place.embed == "vocab":
        return on(0, _chunk(shape[0], m, rank))
    if path.startswith("embed.") and place.embed == "d_model":
        return on(1, _chunk(shape[1], m, rank))
    if path.startswith("lm_head.") and place.vocab and last == "w":
        return on(1, _chunk(shape[1], m, rank))
    return whole


#: the scan-stacked subtrees of the LM families' param trees
STACKED = ("layers", "enc_layers", "dec_layers")


def compute_blocks(layout, cfg, place: Placement, rank: int
                   ) -> Dict[str, Tuple[Intervals, ...]]:
    """``{path: intervals a dimension}`` of model rank ``rank``'s compute
    block of every leaf of a node's ``layout`` (a `repro_torch.core.flat.
    FlatLayout`): :func:`compute_cut` of each per-layer leaf, a stacked
    leaf's layer axis whole (every layer's block is alike)."""
    out = {}
    for lf in layout.leaves:
        if lf.path.split(".")[0] in STACKED:
            out[lf.path] = (((0, lf.shape[0]),),) + compute_cut(
                cfg, place, lf.path, lf.shape[1:], rank)
        else:
            out[lf.path] = compute_cut(cfg, place, lf.path, lf.shape, rank)
    return out


def cache_cut(cfg, place: Placement) -> str:
    """Where a model rank's decode cache of K/V is cut, the reference's
    decode rule (``repro.models.attention``'s cache alignment, ``repro.
    launch.specs.cache_specs``): ``"kv_heads"`` where the KV heads divide M
    (the attention head-parallel), else ``"head_dim"`` where M divides the
    head dim (q cut with it), else ``"whole"``; ``"none"`` without
    attention."""
    if place.attention == "none":
        return "none"
    if place.attention == "heads":
        return "kv_heads"
    m = place.model
    return "head_dim" if m > 1 and cfg.head_dim % m == 0 else "whole"


def cache_shapes(cfg, place: Placement, batch: int, max_len: int,
                 seq: int = 1) -> Dict[str, Tuple[int, ...]]:
    """A model rank's per-layer decode state: K/V ``[B, T, nkv/M, hd]``
    (:func:`cache_cut` ``"kv_heads"``), ``[B, T, nkv, hd/M]``
    (``"head_dim"``) or whole; under an SSM heads cut the SSD state
    ``[B, H/M, P, N]`` (f32) and the conv tail ``[B, W-1, C]`` on the
    channels of the rank's conv compute block (its heads' x columns and
    the B/C groups they read), else both whole. An enc-dec's self K/V
    are its decoder layers' (cut as above) and ``enc_out`` ``[B,
    enc_seq_len, D]`` is its one encoder output, whole on every rank (the
    reference's ``cache_specs``). ``seq`` above 1 cuts the K/V's
    sequence into that many parts (the reference's long-context decode,
    its batch over ``data`` undivided: ``T / seq`` positions a data
    rank); the SSM state has no sequence axis."""
    out = {}
    m = place.model
    if max_len % seq:
        raise ValueError(f"a cache of {max_len} does not cut into {seq}")
    if cfg.family != "ssm":
        nkv, hd = cfg.n_kv_heads, cfg.head_dim
        cut = cache_cut(cfg, place)
        if cut == "kv_heads":
            nkv //= m
        elif cut == "head_dim":
            hd //= m
        out["k"] = out["v"] = (batch, max_len // seq, nkv, hd)
    if cfg.family in ("ssm", "hybrid"):
        di, h, n = cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_state
        groups = cfg.ssm_groups
        if place.ssm_heads:
            di, h, groups = di // m, h // m, ssm_groups_of(cfg, m, 0)[1]
        out["ssd"] = (batch, h, cfg.d_inner // cfg.n_ssm_heads, n)
        out["conv"] = (batch, cfg.conv_width - 1, di + 2 * groups * n)
    if cfg.is_encdec:
        out["enc_out"] = (batch, cfg.enc_seq_len, cfg.d_model)
    return out


# ---------------------------------------------------------------------------
# the dry run's other profiles: no tensor parallelism
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CacheCut:
    """How a served rank's decode cache is cut over its node's model group
    of ``model`` ranks while every layer's work is whole on the rank (the
    reference's ``cache_specs`` under ``zero3``, whose model cuts stay
    where the compute has none): ``kv`` ``"kv_heads"`` where the KV heads
    divide M, else ``"head_dim"`` where the head dim does, else
    ``"whole"`` (``"none"`` without attention); ``ssd`` the SSM state cut
    on its heads, ``conv`` the conv tail on its channels (each where M
    divides them). ``model`` 1 is a whole cache (``dp``, ``default``'s
    form is :func:`cache_cut`)."""
    model: int
    kv: str
    ssd: bool
    conv: bool

    @property
    def cut(self) -> bool:
        """Whether any part of the cache is cut."""
        return self.model > 1 and (self.kv in ("kv_heads", "head_dim")
                                   or self.ssd or self.conv)


def profile_cache_cut(cfg, profile: str, model: int) -> CacheCut:
    """The :class:`CacheCut` of ``cfg``'s decode cache under ``profile``
    (``"dp"`` or ``"zero3"``) on a mesh with ``model`` = M: ``zero3``
    cuts K/V on the KV heads, else the head dim, and the SSM state and
    conv tail on their heads and channels, where M divides them; ``dp``
    cuts nothing."""
    m = int(model) if profile == "zero3" else 1
    div = lambda n: m > 1 and n > 0 and n % m == 0
    kv = "none" if cfg.family == "ssm" else (
        "kv_heads" if div(cfg.n_kv_heads) else
        "head_dim" if div(cfg.head_dim) else "whole")
    ssm = cfg.family in ("ssm", "hybrid")
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return CacheCut(model=m, kv=kv, ssd=ssm and div(cfg.n_ssm_heads),
                    conv=ssm and div(conv_dim))


def stored_cache_shapes(cfg, cut: CacheCut, batch: int, max_len: int,
                        seq: int = 1) -> Dict[str, Tuple[int, ...]]:
    """A rank's per-layer decode state under a :class:`CacheCut`: the
    whole state of :func:`cache_shapes` (``seq`` parts of the K/V's
    sequence) with K/V ``[B, T/seq, nkv/M, hd]`` or ``[B, T/seq, nkv,
    hd/M]``, the SSD state ``[B, H/M, P, N]`` and the conv tail ``[B,
    W-1, C/M]`` where ``cut`` cuts them; ``enc_out`` whole."""
    out = dict(cache_shapes(cfg, placement(cfg, 1), batch, max_len, seq))
    m = cut.model
    if "k" in out:
        b, t, nkv, hd = out["k"]
        if cut.kv == "kv_heads":
            nkv //= m
        elif cut.kv == "head_dim":
            hd //= m
        out["k"] = out["v"] = (b, t, nkv, hd)
    if "ssd" in out and cut.ssd:
        b, h, p, n = out["ssd"]
        out["ssd"] = (b, h // m, p, n)
    if "conv" in out and cut.conv:
        b, w, c = out["conv"]
        out["conv"] = (b, w, c // m)
    return out


def layer_cache_shapes(cfg, place, batch: int, max_len: int,
                       seq: int = 1) -> Dict[str, Tuple[int, ...]]:
    """A rank's per-layer decode state under ``place``: a
    :class:`Placement` (:func:`cache_shapes`) or a :class:`CacheCut`
    (:func:`stored_cache_shapes`)."""
    if isinstance(place, CacheCut):
        return stored_cache_shapes(cfg, place, batch, max_len, seq)
    return cache_shapes(cfg, place, batch, max_len, seq)
