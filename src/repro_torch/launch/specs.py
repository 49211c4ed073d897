"""What one rank of the production mesh holds for an (architecture ×
input-shape) pair: port of ``repro.launch.specs``.

The reference describes every input of a pair as a ``ShapeDtypeStruct``
with a ``NamedSharding`` and lets GSPMD cut it. The port runs one process
a rank (`repro_torch.launch.mesh.make_swarm_mesh(n, data=D, model=M)`),
so this module says, from config arithmetic alone, what **this rank**
holds: its batch rows (``batch → data``, the pod axis folded into data),
its decode tokens, its caches (`repro_torch.sharding.rules.cache_shapes`:
K/V on ``kv_heads``, else ``head_dim``, over ``model``; on the sequence
over the batch axes where they do not divide the batch), its stored param
shard (`repro_torch.core.flat.ShardLayout` under
`repro_torch.sharding.rules.param_specs`, with AdamW's f32 moments on the
shard) and its compute blocks (`repro_torch.sharding.rules.
compute_blocks`). Everything is a shape, or a ``meta`` tensor for the dry
run (`repro_torch.launch.dryrun`); the params' shapes need no abstract
evaluation: they are the layout's leaves (``model.layout.leaves``).

``sizes`` is a mesh's ``{axis: size}``: ``{"data": 16, "model": 16}`` for
the reference's ``(16, 16)`` production mesh, ``{"pod": 2, "data": 16,
"model": 16}`` with pods. Shapes here are a rank's shard shapes, the
reference's ``sharding.shard_shape`` of each global shape.

``profile`` is the reference dry run's sharding profile
(`repro_torch.sharding.rules.PROFILES`): ``"default"`` above; ``"dp"``
and ``"zero3"`` place no tensor parallelism. Under both the inputs' rows
divide over ``("data", "model")`` for ``dp`` and over ``("data",)`` for
``zero3`` (the pod axis first with pods, as the reference's
``batch_axes``), the params over ``data`` (``dp``) or the whole grid
(``zero3``), and only ``zero3``'s cache keeps its cuts over ``model``
(`repro_torch.sharding.rules.profile_cache_cut`). A rank computes the
rows the profile's logical ``batch`` (``("data", "model")``) gives it
where that divides the batch, else the rows its input holds
(`repro_torch.launch.train.TrainStep.split`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig

#: the two production meshes, ``{axis: size}``
PRODUCTION = {"single": {"data": 16, "model": 16},
              "multi": {"pod": 2, "data": 16, "model": 16}}


#: the dry run's sharding profiles
PROFILES = ("default", "dp", "zero3")


def batch_axes(sizes: Dict[str, int],
               profile: str = "default") -> Tuple[str, ...]:
    """The mesh axes a batch divides over (the pod axis folds into data;
    ``dp`` adds ``model``)."""
    base = ("pod", "data") if "pod" in sizes else ("data",)
    return base + ("model",) if profile == "dp" else base


def _n(sizes: Dict[str, int], axes) -> int:
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def _div(dim: int, sizes: Dict[str, int], axes) -> bool:
    return dim > 0 and dim % _n(sizes, axes) == 0


def batch_cut(shape: ShapeConfig, sizes: Dict[str, int],
              profile: str = "default"):
    """The axes the batch's rows divide over: all the batch axes where they
    divide the batch, else the last (``data``; ``model`` under ``dp``)
    where it does, else None (every rank holds every row). ``shape`` may
    be a batch size."""
    ba = batch_axes(sizes, profile)
    b = getattr(shape, "global_batch", shape)
    if _div(b, sizes, ba):
        return ba
    if _div(b, sizes, ba[-1:]):
        return ba[-1:]
    return None


def batch_rows(shape: ShapeConfig, sizes: Dict[str, int],
               profile: str = "default") -> int:
    """The batch rows one rank holds."""
    cut = batch_cut(shape, sizes, profile)
    return shape.global_batch // (1 if cut is None else _n(sizes, cut))


def batch_shapes(cfg: ModelConfig, shape: ShapeConfig,
                 sizes: Dict[str, int], profile: str = "default"
                 ) -> Dict[str, Tuple[int, ...]]:
    """A rank's training / prefill batch: ``tokens`` and ``labels`` ``[rows,
    S]``, a vlm's ``patch_embeds`` ``[rows, n_patches, frontend_dim]``, an
    enc-dec's ``frames`` ``[rows, enc_seq_len, frontend_dim]``."""
    r, s = batch_rows(shape, sizes, profile), shape.seq_len
    out = {"tokens": (r, s), "labels": (r, s)}
    if cfg.family == "vlm":
        out["patch_embeds"] = (r, cfg.n_patches, cfg.frontend_dim)
    if cfg.is_encdec:
        out["frames"] = (r, cfg.enc_seq_len, cfg.frontend_dim)
    return out


def decode_token_shape(cfg: ModelConfig, shape: ShapeConfig,
                       sizes: Dict[str, int], profile: str = "default"
                       ) -> Tuple[int, int]:
    """A decode step's tokens on one rank, ``[rows, 1]``."""
    return (batch_rows(shape, sizes, profile), 1)


def cache_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """The cache's depth: the shape's sequence (a vlm's prefill writes its
    patches' K/V too)."""
    return shape.seq_len + (cfg.n_patches if cfg.family == "vlm" else 0)


def seq_parts(cfg: ModelConfig, shape: ShapeConfig,
              sizes: Dict[str, int], profile: str = "default") -> int:
    """How many parts the K/V cache's sequence is cut into: the batch axes'
    size where they do not divide the batch and do divide the cache
    (long-context decode at batch 1), else 1."""
    ba = batch_axes(sizes, profile)
    if batch_cut(shape, sizes, profile) is None and _div(
            cache_len(cfg, shape), sizes, ba):
        return _n(sizes, ba)
    return 1


def placement_of(cfg: ModelConfig, sizes: Dict[str, int]):
    from repro_torch.sharding.rules import placement
    return placement(cfg, sizes.get("model", 1))


def cache_shapes(cfg: ModelConfig, shape: ShapeConfig,
                 sizes: Dict[str, int], profile: str = "default") -> dict:
    """A rank's decode state, every layer stacked on a leading axis as the
    reference's ``cache_specs``: ``k``/``v`` ``[L, rows, T/parts, nkv', hd']``
    (not for the ssm family), ``ssd`` ``[L, rows, H', P, N]`` and ``conv``
    ``[L, rows, W-1, C']`` (ssm, hybrid); an enc-dec's ``{"self": ...,
    "enc_out": [rows, enc_seq_len, D]}``. The per-layer shapes are the
    ones `repro_torch.launch.serve.StepBuffers` allocates
    (`repro_torch.sharding.rules.cache_shapes`; under ``dp`` and ``zero3``
    `repro_torch.sharding.rules.stored_cache_shapes`)."""
    from repro_torch.sharding import rules
    args = (batch_rows(shape, sizes, profile), cache_len(cfg, shape),
            seq_parts(cfg, shape, sizes, profile))
    if profile == "default":
        one = rules.cache_shapes(cfg, placement_of(cfg, sizes), *args)
    else:
        one = rules.stored_cache_shapes(cfg, rules.profile_cache_cut(
            cfg, profile, sizes.get("model", 1)), *args)
    enc = one.pop("enc_out", None)
    out = {k: (cfg.n_layers,) + tuple(v) for k, v in one.items()}
    if cfg.is_encdec:
        return {"self": out, "enc_out": tuple(enc)}
    return out


def world_rank(coords: Dict[str, int], sizes: Dict[str, int]) -> int:
    """The world rank of ``{"node", "data", "model"}`` coordinates on the
    port's mesh (`make_swarm_mesh(pods, data=D, model=M)`: rank ``(i·D +
    d)·M + m``, the pod index the node position)."""
    d, m = sizes.get("data", 1), sizes.get("model", 1)
    return (coords.get("node", 0) * d + coords.get("data", 0)) * m \
        + coords.get("model", 0)


def shard_layout(model, sizes: Dict[str, int], coords: Dict[str, int],
                 profile: str = "default"):
    """The rank's :class:`~repro_torch.core.flat.ShardLayout` of a node
    under the reference's ``param_specs`` for ``profile`` (``default``:
    FSDP over ``data``, the wide axes over ``model``; ``dp``: FSDP over
    ``data`` alone, so the layout's group is the rank's data group and a
    block is the same on every model rank; ``zero3``: FSDP over
    ``("data", "model")``). Pods hold replicas, as the reference's
    ``fsdp`` names no pod."""
    from repro_torch.core.flat import ShardLayout
    from repro_torch.sharding.rules import PROFILE_FSDP, PROFILES, param_specs
    inner = {"data": sizes.get("data", 1), "model": sizes.get("model", 1)}
    specs = param_specs(model.layout, inner, logical=PROFILES[profile],
                        fsdp=PROFILE_FSDP[profile])
    if profile == "dp":
        inner = {"data": inner["data"]}
    return ShardLayout(model.layout, specs, inner,
                       {a: coords.get(a, 0) for a in inner})


def stored_bytes(shard, dtype_bytes: int = 2) -> Dict[str, int]:
    """A training rank's stored state: its param shard's slots
    (``dtype_bytes`` each; the f32 leaves two), AdamW's two f32 moments
    over its values."""
    values = shard.local.value_layout.size
    return {"params": shard.local.size * dtype_bytes,
            "opt": 2 * 4 * values}


def compute_block_shapes(model, sizes: Dict[str, int], coords: Dict[str, int],
                         profile: str = "default"
                         ) -> Optional[Dict[str, Tuple[int, ...]]]:
    """``{path: shape}`` of a serving rank's compute blocks (None with one
    model rank, or under ``dp`` / ``zero3``: the node whole)."""
    from repro_torch.sharding.rules import compute_blocks
    if sizes.get("model", 1) <= 1 or profile != "default":
        return None
    place = placement_of(model.cfg, sizes)
    blocks = compute_blocks(model.layout, model.cfg, place,
                            coords.get("model", 0))
    return {p: tuple(sum(n for _, n in iv) for iv in ivs)
            for p, ivs in blocks.items()}
