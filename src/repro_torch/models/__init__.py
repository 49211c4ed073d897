"""Unified LM model API: port of ``repro.models.build_model`` for all six
families (dense, moe, ssm, hybrid, vlm, audio enc-dec).

``build_model(cfg)`` returns a :class:`Model` bundle of plain functions with
the reference's conventions, plus the :class:`~repro_torch.core.flat.
FlatLayout` of one node's params. A node's params are a flat vector
``[P]`` in the config's param dtype (the swarm state's form); a call takes
the layout's views of it (``{dotted path: tensor}``) and runs them through
``torch.func.functional_call`` over a :class:`ParamTree`, a meta-device
``nn.Module`` that fixes the reference's param tree and names. The leaf
paths are the reference's tree paths with layer leaves stacked ``[L, ...]``,
so the port's checkpoints use the reference's keys and either package's
``SwarmSession.save`` loads in the other.

  train:  loss_fn(params, {tokens, labels[, mask][, patch_embeds | frames]},
          remat=True) -> (loss, metrics)  (the reference's signature and
          default; remat=True checkpoints every decoder block under
          torch.func, `repro_torch.models.remat`; split= runs it on a
          rank's shard, each layer gathered, `repro_torch.models.gather`)
  decode: decode(params, tokens [B,S], caches, cache_pos[, commit])
          -> (logits [B,S,V], caches)      (caches updated in place)
  prefill(params, {tokens[, patch_embeds]}, caches) -> (last logits
          [B,1,V], caches); the enc-dec model has none (``prefill=None``),
          as in the reference: its prompt is fed token by token
  encode(params, frames [B, S_enc, frontend_dim]) -> enc_out [B, S_enc,
          D]: the enc-dec model's encoder (None for the others), whose
          output a served enc-dec reads from its cache's ``enc_out``
  served over a model group (plan=, a TensorPlan: tensor parallelism,
          `repro_torch.launch.serve` with a mesh), prefill, decode and
          encode take a rank's compute blocks and cut caches
          (``init_cache(..., place=)``) and give its vocab cut of the
          logits (the whole logits where M does not divide the vocab)
  served from a stored shard (split=, a NodeSplit: the dry run's dp and
          zero3 profiles, `repro_torch.launch.serve`'s stored form),
          prefill, decode and encode take a rank's local leaf views of
          its shard, gather each layer whole just before its block and
          give the whole logits; the caches are placed by the stored
          plan the caller enters (`repro_torch.sharding.stored`)

The vlm model runs the LM backbone on the projected patch embeddings
followed by the text tokens (its loss reads the text positions); decode is
text only. The enc-dec model's loss is the teacher-forced
``forward_encdec``; its decode reads the encoder output from the cache's
``enc_out``.

The reference keeps an SSM's ``A_log``, ``D`` and ``dt_bias``, a moe
router's weight (and an adapter's ``lora_scale``) in f32 inside a bf16
model; so does the port: in a 16-bit buffer they are the layout's wide
leaves (`repro_torch.core.flat`), f32 values viewed over two slots each. A
training step differentiates the layout's two parts
(``layout.unflatten_parts``), so those leaves train as f32.

``build_model(cfg, lora_rank=r)`` is the model over the tree
``repro.core.lora.inject_lora`` gives (``lora_A``/``lora_B``/``lora_scale``
beside every targeted linear, alpha 32): its layout holds the
adapters, and ``init`` draws them as the reference does (A ~ N(0, 1/r), B
zero, scale alpha/r).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.flat import FlatLayout
from repro_torch.core.lora import is_adapter_path, lora_shapes
from repro_torch.models.encdec import (decode_step, encdec_shapes, encode,
                                       forward_encdec, init_encdec_,
                                       make_encdec_cache)
from repro_torch.models.layers import dtype_of, embed, softmax_xent
from repro_torch.models.transformer import (embed_tp, forward_lm, init_lm_,
                                            lm_shapes, make_lm_cache,
                                            project_frontend)
from repro_torch.sharding import tensor


@dataclass(frozen=True, eq=False)
class Model:
    cfg: Optional[ModelConfig]
    init: Optional[Callable[..., Any]]    # (generator, device) -> [P]
    loss_fn: Optional[Callable[..., Any]]  # (params, batch) -> (loss, metrics)
    decode: Callable[..., Any]            # (params, tokens, caches, cache_pos)
    init_cache: Callable[..., Any]        # (batch, max_len, device) -> caches
    prefill: Optional[Callable[..., Any]] = None
    layout: Optional[FlatLayout] = None
    encode: Optional[Callable[..., Any]] = None   # (params, frames) -> enc


def _leaves(shapes: dict, prefix: str = ""):
    """(dotted path, shape) in the reference's flatten order (keys sorted)."""
    for key in sorted(shapes):
        path = f"{prefix}{key}"
        sub = shapes[key]
        if isinstance(sub, dict):
            yield from _leaves(sub, path + ".")
        else:
            yield path, tuple(sub)


F32_LEAVES = ("A_log", "D", "dt_bias")   # f32 whatever the param dtype
LORA_ALPHA = 32.0                        # inject_lora's default alpha


def _f32_paths(cfg: ModelConfig, shapes: dict):
    """The leaves the reference keeps in f32, when the param dtype is not:
    the SSM's ``A_log``, ``D``, ``dt_bias``, a moe router's weight
    (``layers.moe.router.w``) and every ``lora_scale``."""
    if dtype_of(cfg.param_dtype).itemsize == 4:
        return frozenset()
    return frozenset(path for path, _ in _leaves(shapes)
                     if (path.split(".")[-1] in F32_LEAVES
                         and ".ssm." in f".{path}")
                     or path.endswith(".moe.router.w")
                     or path.split(".")[-1] == "lora_scale")


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """{dotted path: tensor} → the nested param tree."""
    root: dict = {}
    for path, t in flat.items():
        node = root
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    return root


class ParamTree(nn.Module):
    """A model's param structure: meta parameters named by the reference's
    tree paths (layer leaves stacked ``[L, ...]``). Called through
    ``torch.func.functional_call`` with a node's params and a function of
    the nested tree: ``forward(fn, *args)`` is ``fn(tree, *args)``."""

    def __init__(self, cfg: ModelConfig, shapes: dict):
        super().__init__()
        self.paths = []
        wide = _f32_paths(cfg, shapes)
        for path, shape in _leaves(shapes):
            dtype = (torch.float32 if path in wide
                     else dtype_of(cfg.param_dtype))
            *mods, name = path.split(".")
            owner = self
            for m in mods:
                if not hasattr(owner, m):
                    owner.add_module(m, nn.Module())
                owner = getattr(owner, m)
            owner.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device="meta"),
                requires_grad=False))
            self.paths.append(path)

    def tree(self) -> dict:
        out = {}
        for path in self.paths:
            t = self
            for part in path.split("."):
                t = getattr(t, part)
            out[path] = t
        return nest(out)

    def forward(self, fn, *args, **kw):
        return fn(self.tree(), *args, **kw)


def _node(cfg: ModelConfig, shapes: dict, init_tree: Callable,
          lora_rank: int):
    """``(layout, init, call)`` of a node's params over ``shapes``
    (adapters injected with ``lora_rank``): ``init_tree(tree, cfg,
    generator)`` fills a tree in place; ``call(params, fn, *args)`` runs
    ``fn(tree, *args)`` on a node's params."""
    if lora_rank:
        shapes = lora_shapes(shapes, lora_rank)
    module = ParamTree(cfg, shapes)
    layout = FlatLayout(list(_leaves(shapes)), _f32_paths(cfg, shapes))

    def call(params, fn, *args, **kw):
        return torch.func.functional_call(module, params, (fn,) + args, kw)

    def init(generator: torch.Generator, device="cuda",
             out: Optional[torch.Tensor] = None,
             adapter_generator: Optional[torch.Generator] = None
             ) -> torch.Tensor:
        """One node's params ``[P]`` drawn from ``generator`` (on
        ``device``), written into ``out`` (e.g. a row of an ensemble
        buffer) when given; the adapters' A from ``adapter_generator``
        when given (the reference injects each node's adapters from its
        own key into a shared base)."""
        if out is None:
            out = torch.empty(layout.size, dtype=dtype_of(cfg.param_dtype),
                              device=resolve_device(device))
        views = layout.unflatten(out)
        init_tree(nest(views), cfg, generator)
        for path, t in views.items():
            if not is_adapter_path(path):
                continue
            if path.endswith("lora_A"):
                t.copy_(torch.randn(t.shape, generator=adapter_generator
                                    or generator, device=t.device)
                        / lora_rank ** 0.5)
            elif path.endswith("lora_B"):
                t.zero_()
            else:
                t.fill_(LORA_ALPHA / lora_rank)
        if layout.pad:
            out[-1:].zero_()
        return out

    return layout, init, call


def _lm_model(cfg: ModelConfig, lora_rank: int) -> Model:
    """The LM backbone; a vlm's runs on the projected patch embeddings
    followed by the text tokens', and its loss reads the text positions."""
    layout, init, call = _node(cfg, lm_shapes(cfg), init_lm_, lora_rank)
    text_from = cfg.n_patches if cfg.family == "vlm" else 0

    def forward(tree, batch, **kw):
        if cfg.family != "vlm":
            return forward_lm(tree, cfg, batch["tokens"], **kw)
        if tensor.current() is None:
            tok = embed(tree["embed"], batch["tokens"],
                        dtype_of(cfg.compute_dtype))
        else:   # every text position, alike on every model rank
            tok = embed_tp(tree["embed"], batch["tokens"], cfg, whole=True)
        patches = project_frontend(tree, cfg,
                                   batch["patch_embeds"].to(tok.dtype))
        return forward_lm(tree, cfg, embeds=torch.cat([patches, tok], dim=1),
                          **kw)

    def loss_fn(params, batch, remat=True, split=None):
        """(loss, {"xent", "aux"}); ``remat`` checkpoints every block
        (`repro_torch.models.remat`), the reference's default. ``split``
        (`repro_torch.models.gather.NodeSplit`): ``params`` are a rank's
        local leaf views of its shard, gathered layer by layer (each
        layer's compute blocks under tensor parallelism, its model group
        ``split.tensor`` the forward's for the call: the logits are then
        the rank's vocab cut, and the loss the vocab-parallel cross
        entropy's, alike on every model rank)."""
        with tensor.model_group(None if split is None else split.tensor):
            if split is None:
                logits, aux, _ = call(params, forward, batch, remat=remat)
            else:
                logits, aux, _ = forward(split.tree(params), batch,
                                         remat=remat, split=split)
            xent = softmax_xent(logits[:, text_from:], batch["labels"],
                                batch.get("mask"))
        return xent + aux, {"xent": xent, "aux": aux}

    def prefill(params, batch, caches, plan=None, split=None):
        """(last logits [B,1,V], caches); with ``plan`` (a `repro_torch.
        sharding.tensor.TensorPlan`: serving over a model group) ``params``
        are the rank's compute blocks, ``caches`` its cut, the logits its
        vocab cut, and the forward records no gradient; with ``split`` (a
        `repro_torch.models.gather.NodeSplit`) ``params`` are the rank's
        local views of its shard, each layer gathered whole."""
        if split is not None:
            with torch.no_grad():
                logits, _, caches = forward(split.tree(params), batch,
                                            caches=caches, cache_pos=0,
                                            split=split)
        elif plan is not None:
            with torch.no_grad(), tensor.model_group(plan):
                logits, _, caches = forward(nest(params), batch,
                                            caches=caches, cache_pos=0)
        else:
            logits, _, caches = call(params, forward, batch, caches=caches,
                                     cache_pos=0)
        return logits[:, -1:], caches

    def decode(params, tokens, caches, cache_pos, commit=None, plan=None,
               split=None):
        """(logits [B,S,V], caches); ``plan`` and ``split`` as
        :func:`prefill`'s."""
        if split is not None:
            with torch.no_grad():
                logits, _, caches = forward_lm(
                    split.tree(params), cfg, tokens, caches=caches,
                    cache_pos=cache_pos, commit=commit, split=split)
        elif plan is not None:
            with torch.no_grad(), tensor.model_group(plan):
                logits, _, caches = forward_lm(
                    nest(params), cfg, tokens, caches=caches,
                    cache_pos=cache_pos, commit=commit)
        else:
            logits, _, caches = call(params, forward_lm, cfg, tokens,
                                     caches=caches, cache_pos=cache_pos,
                                     commit=commit)
        return logits, caches

    return Model(cfg, init, loss_fn, decode,
                 lambda b, m, device, place=None, seq=1: make_lm_cache(
                     cfg, b, m, device, place, seq),
                 prefill, layout)


def _encdec_model(cfg: ModelConfig, lora_rank: int) -> Model:
    """The teacher-forced enc-dec; no prefill, as in the reference (a
    prompt is fed token by token), and its ``encode``."""
    layout, init, call = _node(cfg, encdec_shapes(cfg), init_encdec_,
                               lora_rank)

    def loss_fn(params, batch, remat=True, split=None):
        """(loss, {"xent", "aux"}); ``remat`` checkpoints every decoder
        block, the reference's default; ``split`` as the LM's (its model
        group entered here: the encoder, the decoder and the loss
        tensor-parallel)."""
        with tensor.model_group(None if split is None else split.tensor):
            if split is None:
                logits, aux = call(params, forward_encdec, cfg,
                                   batch["frames"], batch["tokens"],
                                   remat=remat)
            else:
                logits, aux = forward_encdec(split.tree(params), cfg,
                                             batch["frames"], batch["tokens"],
                                             remat=remat, split=split)
            xent = softmax_xent(logits, batch["labels"], batch.get("mask"))
        return xent + aux, {"xent": xent, "aux": aux}

    def decode(params, tokens, caches, cache_pos, commit=None, plan=None,
               split=None):
        """(logits [B,S,V], caches); with ``plan`` (serving over a model
        group) ``params`` are the rank's compute blocks, ``caches`` its cut
        (``enc_out`` whole), the logits its vocab cut, and the forward
        records no gradient; with ``split`` (serving from a stored shard)
        ``params`` are the rank's local views, each layer gathered
        whole."""
        if split is not None:
            with torch.no_grad():
                logits, _, caches = decode_step(
                    split.tree(params), cfg, tokens, caches, cache_pos,
                    commit=commit, split=split)
        elif plan is not None:
            with torch.no_grad(), tensor.model_group(plan):
                logits, _, caches = decode_step(
                    nest(params), cfg, tokens, caches, cache_pos,
                    commit=commit)
        else:
            logits, _, caches = call(params, decode_step, cfg, tokens,
                                     caches, cache_pos, commit=commit)
        return logits, caches

    def encode_frames(params, frames, plan=None, split=None):
        """The encoder output [B, S_enc, D] of ``frames``; with ``plan``
        encoded over the model group (the frames' residual cut where M
        divides them, the output gathered whole on every rank); with
        ``split`` from the rank's stored shard, each layer gathered
        whole."""
        if split is not None:
            with torch.no_grad():
                return encode(split.tree(params), cfg, frames, split=split)
        if plan is not None:
            with torch.no_grad(), tensor.model_group(plan):
                return encode(nest(params), cfg, frames)
        return call(params, encode, cfg, frames)

    return Model(cfg, init, loss_fn, decode,
                 lambda b, m, device, place=None, seq=1: make_encdec_cache(
                     cfg, b, m, device, place, seq),
                 None, layout, encode_frames)


def build_model(cfg: ModelConfig, lora_rank: int = 0) -> Model:
    """The model of ``cfg``; with ``lora_rank`` > 0, over the tree with LoRA
    adapters of that rank injected (the reference's ``inject_lora``, its
    default alpha)."""
    if cfg.is_encdec:
        return _encdec_model(cfg, lora_rank)
    return _lm_model(cfg, lora_rank)
