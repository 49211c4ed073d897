"""Decoder-only LM for the dense, moe, ssm, hybrid and vlm families: port
of ``repro.models.transformer``.

Params are the reference's tree: ``embed``/``embed_tied``, ``layers`` (every
leaf stacked ``[L, ...]`` over the layers, as the reference's
scan-over-layers keeps them), ``final_norm``, ``lm_head`` and, for a vlm,
the ``projector`` (``fc1``, ``fc2``, both biased). The forward loops over
the layers in Python, slicing layer i's params as views (``leaf[i]``), so
each layer's attention window is a Python int, as the flash kernel takes
it. The reference's ``logical_shard`` / ``constrain_block_params`` are
no-ops on one device and are dropped. The kernels of this path are the
flash attention and SSD scan of every prefill; a moe block's expert FFN
(`repro_torch.models.moe`) is plain torch, as the reference's is jnp.

Caches are a list with one dict per layer (``k``/``v`` ``[B, T, nkv, hd]``
in the compute dtype; ``ssd`` ``[B, H, P, N]`` f32 and ``conv``
``[B, W-1, C]``), updated in place by the forward.

The forward never reads a value back from the card: windows and shapes
are host ints, decode positions and the commit mask device tensors, and
no host tensor is copied in. So a serving step that calls it can be
captured into a CUDA graph (`repro_torch.launch.capture`, whose warm-up
runs under ``torch.cuda.set_sync_debug_mode("error")``).

**Tensor parallelism** (a split step or a served model on a model group,
`repro_torch.sharding.tensor`): the residual stream is the rank's cut of
the sequence between blocks (the reference's ``res_seq``); each block
enters its mixers with one all_gather of the normed sequence (shared by a
hybrid's attention and SSM halves, each with its own placement) and
leaves them on the cut (:func:`block_apply`); the embedding's lookup ends
on the cut (:func:`embed_tp`), the final norm runs on it, and the logits
are the rank's vocab cut of the gathered sequence, their padding columns
masked by their global index (the whole logits where M does not divide
the padded vocab). Where M does not divide the sequence (a decode step's
one token, a prompt or a training sequence of odd length) the forward runs
in the whole-residual form, with or without a gradient: every rank holds
every row, as the reference's UNCONSTRAINED ``res_seq`` leaves it, and its
backward carries the partial cotangents `repro_torch.sharding.tensor`
describes; a served model's caches are the rank's cut
(:func:`make_lm_cache` with a placement).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (attention, attention_shapes,
                                          attention_tp, make_cache)
from repro_torch.models.layers import (dtype_of, embed, gelu, init_linear_,
                                       linear, mlp, normal_, rmsnorm,
                                       unembed)
from repro_torch.models.moe import init_moe_, moe, moe_shapes, moe_tp
from repro_torch.models.remat import checkpoint
from repro_torch.models.ssm import (init_ssm_, make_ssm_state, ssm_block,
                                    ssm_shapes, ssm_tp)
from repro_torch.sharding import stored, tensor

# ---------------------------------------------------------------------------
# param shapes and init
# ---------------------------------------------------------------------------

def mlp_shapes(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    lin = (lambda i, o: {"w": (i, o), "b": (o,)} if cfg.use_bias
           else {"w": (i, o)})
    if cfg.activation == "swiglu":
        return {"gate": lin(d, f), "up": lin(d, f), "down": lin(f, d)}
    return {"up": lin(d, f), "down": lin(f, d)}


def block_shapes(cfg: ModelConfig) -> dict:
    """One layer's param shapes (a nested dict of tuples)."""
    d = cfg.d_model
    fam = cfg.family
    if fam == "ssm":
        return {"ssm_norm": {"scale": (d,)}, "ssm": ssm_shapes(cfg)}
    p = {"attn_norm": {"scale": (d,)}, "attn": attention_shapes(cfg),
         "mlp_norm": {"scale": (d,)}}
    if fam == "moe":
        p["moe"] = moe_shapes(cfg)
    else:
        p["mlp"] = mlp_shapes(cfg)
    if fam == "hybrid":
        p["ssm"] = ssm_shapes(cfg)
        p["beta_attn"] = (d,)
        p["beta_ssm"] = (d,)
    return p


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def lm_shapes(cfg: ModelConfig) -> dict:
    """The whole model's param shapes, layer leaves stacked ``[L, ...]``."""
    emb = "embed_tied" if cfg.tie_embeddings else "embed"
    shapes = {emb: {"table": (cfg.padded_vocab, cfg.d_model)},
              "layers": _map(block_shapes(cfg),
                             lambda s: (cfg.n_layers,) + tuple(s)),
              "final_norm": {"scale": (cfg.d_model,)}}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = {"w": (cfg.d_model, cfg.padded_vocab)}
    if cfg.frontend_dim:  # vlm projector (the frontend itself is a stub)
        d = cfg.d_model
        shapes["projector"] = {"fc1": {"w": (cfg.frontend_dim, d), "b": (d,)},
                               "fc2": {"w": (d, d), "b": (d,)}}
    return shapes


def layer_params(layers: dict, i: int) -> dict:
    """Layer i's params: views ``leaf[i]`` of the stacked leaves."""
    return _map(layers, lambda t: t[i])


def init_lm_(params: dict, cfg: ModelConfig,
             generator: torch.Generator) -> None:
    """Fill a param tree (e.g. views of a flat buffer) in place with the
    reference's init scales, drawn from ``generator`` (its numbers differ
    from the reference's ``jax.random`` draws by design)."""
    emb = "embed_tied" if cfg.tie_embeddings else "embed"
    normal_(params[emb]["table"], generator, 0.02)
    params["final_norm"]["scale"].fill_(1.0)
    if "lm_head" in params:
        init_linear_(params["lm_head"], generator)
    for layer in params.get("projector", {}).values():
        init_linear_(layer, generator)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        if cfg.family == "ssm":
            lp["ssm_norm"]["scale"].fill_(1.0)
            init_ssm_(lp["ssm"], cfg, generator)
            continue
        lp["attn_norm"]["scale"].fill_(1.0)
        lp["mlp_norm"]["scale"].fill_(1.0)
        for name in ("q", "k", "v", "o"):
            init_linear_(lp["attn"][name], generator)
        if cfg.family == "moe":
            init_moe_(lp["moe"], cfg, generator)
        else:
            for layer in lp["mlp"].values():
                init_linear_(layer, generator)
        if cfg.family == "hybrid":
            init_ssm_(lp["ssm"], cfg, generator)
            lp["beta_attn"].fill_(1.0)
            lp["beta_ssm"].fill_(1.0)


# ---------------------------------------------------------------------------
# per-layer block
# ---------------------------------------------------------------------------

def _write_state(cache: dict, state: dict, commit) -> None:
    """Copy an SSM state into the cache in place (only rows ``commit``
    marks, when given); a cache a stored plan cuts (`repro_torch.sharding.
    stored`) takes the rank's cut of it."""
    for key, new in state.items():
        old = cache[key]
        for dim, (a, b) in enumerate(zip(old.shape, new.shape)):
            if a != b:
                new = stored.take(new, dim, a)
        if commit is not None:
            keep = commit.reshape((-1,) + (1,) * (new.dim() - 1))
            new = torch.where(keep, new.to(old.dtype), old)
        old.copy_(new)


def _ssm_state(cache: Optional[dict], s: int):
    """The SSM state a block of ``s`` positions reads: the layer's cache,
    or under a stored plan that cuts it (`repro_torch.sharding.stored`) a
    decode step's state and conv tail gathered whole over the model
    group."""
    plan = stored.current()
    if cache is None or s != 1 or plan is None or plan.view is None:
        return cache
    return {"ssd": stored.gather(cache["ssd"], 1) if plan.cut.ssd
            else cache["ssd"],
            "conv": stored.gather(cache["conv"], 2) if plan.cut.conv
            else cache["conv"]}


def block_apply(p, x, cfg: ModelConfig, *, positions, window: int,
                cache: Optional[dict], cache_pos, commit=None):
    """One residual block → (x, aux: the moe router's loss, or None);
    ``cache`` (the layer's dict, or None) is updated in place."""
    if tensor.current() is not None:
        return _block_tp(p, x, cfg, positions=positions, window=window,
                         cache=cache, cache_pos=cache_pos, commit=commit)
    fam = cfg.family
    if fam == "ssm":
        h = rmsnorm(p["ssm_norm"], x, cfg.norm_eps)
        y, st = ssm_block(p["ssm"], h, cfg,
                          state=_ssm_state(cache, x.shape[1]))
        if cache is not None:
            _write_state(cache, st, commit)
        return x + y, None

    h = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    a = attention(p["attn"], h, cfg, positions=positions, window=window,
                  cache=cache, cache_pos=cache_pos, commit=commit)
    if fam == "hybrid":
        s, st = ssm_block(p["ssm"], h, cfg,
                          state=_ssm_state(cache, x.shape[1]))
        x = x + 0.5 * (a * p["beta_attn"].to(a.dtype)
                       + s * p["beta_ssm"].to(a.dtype))
        if cache is not None:
            _write_state(cache, st, commit)
    else:
        x = x + a
    h = rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
    if fam == "moe":
        y, aux = moe(p["moe"], h, cfg)
        return x + y, aux
    return x + mlp(p["mlp"], h, cfg), None


def _block_tp(p, x, cfg: ModelConfig, *, positions, window: int,
              cache: Optional[dict] = None, cache_pos=None, commit=None):
    """:func:`block_apply` under tensor parallelism: ``x`` the rank's cut
    of the sequence [B, S/M, D] (every row in the whole-residual form),
    ``p`` the layer's compute blocks, ``cache`` the rank's cut of the
    layer's decode state (`repro_torch.sharding.rules.cache_shapes`)."""
    fam = cfg.family
    if fam == "ssm":
        h = rmsnorm(p["ssm_norm"], x, cfg.norm_eps)
        y, st = ssm_tp(p["ssm"], h, cfg, state=cache)
        if cache is not None:
            _write_state(cache, st, commit)
        return x + y, None
    h = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    h_full = tensor.enter(h)
    a = attention_tp(p["attn"], h, cfg, positions=positions, window=window,
                     h_full=h_full, cache=cache, cache_pos=cache_pos,
                     commit=commit)
    if fam == "hybrid":
        s, st = ssm_tp(p["ssm"], h, cfg, h_full=h_full, state=cache)
        x = x + 0.5 * (a * p["beta_attn"].to(a.dtype)
                       + s * p["beta_ssm"].to(a.dtype))
        if cache is not None:
            _write_state(cache, st, commit)
    else:
        x = x + a
    h = rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
    if fam == "moe":
        y, aux = moe_tp(p["moe"], h, cfg)
        return x + y, aux
    return x + mlp(p["mlp"], h, cfg), None


def embed_tp(p, tokens, cfg: ModelConfig, whole: bool = False):
    """The embedding under tensor parallelism, from the table's compute
    block: the rank's cut of the sequence [B, S/M, D] (``whole``: every
    position, alike on every rank, for a vlm that prepends its patches).
    A table cut on d_model looks every token up in its columns, then an
    all_to_all (``whole``: an all_gather of the columns); a tied table cut
    on the vocab looks up the tokens in its rows (zeros elsewhere), then a
    reduce_scatter onto the cut (``whole``: an all_reduce); a whole table
    looks up the rank's own tokens."""
    tp = tensor.current()
    dtype = dtype_of(cfg.compute_dtype)
    if tp.place.embed == "d_model":
        x = embed(p, tokens, dtype)
        return (tensor.gather(x, dim=2) if whole
                else tensor.all_to_all(x, split_dim=1, cat_dim=2))
    if tp.place.embed == "vocab":
        v = p["table"].shape[0]
        ids = tokens - tp.rank * v
        mine = (ids >= 0) & (ids < v)
        x = embed(p, torch.where(mine, ids, 0), dtype) * mine[..., None].to(
            dtype)
        return tensor.all_reduce(x) if whole else tensor.scatter_sum(x)
    if whole:
        return embed(p, tokens, dtype)
    s0, n = tp.seq_cut(tokens.shape[1])
    return embed(p, tokens[:, s0:s0 + n], dtype)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer attention window (0 = full attention)."""
    w = np.full((cfg.n_layers,), cfg.sliding_window, np.int32)
    if cfg.sliding_window and cfg.attn_every:
        w[:: cfg.attn_every] = 0  # periodic global-attention layers
    return w


def make_lm_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device, place=None, seq: int = 1) -> List[dict]:
    """Per-layer decode state: a list of ``n_layers`` dicts; with
    ``place`` (a `repro_torch.sharding.rules.Placement`, or a stored
    rank's `repro_torch.sharding.rules.CacheCut`) a rank's cut of it
    (`repro_torch.sharding.rules.layer_cache_shapes`, the K/V's sequence
    cut into ``seq`` parts)."""
    dtype = dtype_of(cfg.compute_dtype)
    if place is not None:
        from repro_torch.sharding.rules import layer_cache_shapes
        shapes = layer_cache_shapes(cfg, place, batch, max_len, seq)
        return [{key: torch.zeros(shape, dtype=torch.float32 if key == "ssd"
                                  else dtype, device=device)
                 for key, shape in shapes.items()}
                for _ in range(cfg.n_layers)]
    caches = []
    for _ in range(cfg.n_layers):
        c = {}
        if cfg.family != "ssm":
            c.update(make_cache(cfg, batch, max_len, dtype, device))
        if cfg.family in ("ssm", "hybrid"):
            c.update(make_ssm_state(cfg, batch, dtype, device))
        caches.append(c)
    return caches


def project_frontend(params, cfg: ModelConfig, feats):
    """VLM stub embeddings → d_model through the 2-layer projector (gelu,
    tanh-approximated as ``jax.nn.gelu``'s default)."""
    h = gelu(linear(params["projector"]["fc1"], feats))
    return linear(params["projector"]["fc2"], h)


def _remat_block(cfg: ModelConfig, window: int):
    """A training block for :func:`~repro_torch.models.remat.checkpoint`:
    ``(x, positions, p) -> (x,)`` or, with a router, ``(x, aux)``."""
    def fn(x, positions, p):
        y, aux = block_apply(p, x, cfg, positions=positions, window=window,
                             cache=None, cache_pos=None)
        return (y,) if aux is None else (y, aux)

    return fn


def _layer_source(stacked: dict, split, top: str, lazy: bool):
    """``i -> layer i``'s params of a stacked subtree: views of the stacked
    leaves, each unbound once (a gradient then comes back as one stack per
    leaf, where indexing layer by layer would write a zero-padded full-size
    gradient per layer, quadratic in the depth); on a split step the layer
    gathered from the rank's blocks, or with ``lazy`` the blocks a
    checkpoint gathers (`repro_torch.models.gather.NodeSplit.layers`)."""
    if split is not None:
        return split.layers(top, stacked, lazy)
    layers = _map(stacked, lambda t: t.unbind(0))
    return lambda i: _map(layers, lambda ts: ts[i])


def forward_lm(params, cfg: ModelConfig, tokens=None, *, embeds=None,
               caches=None, cache_pos=None, commit=None, remat=False,
               split=None):
    """tokens [B,S] (or ``embeds`` [B,S,D], the vlm prefix path) →
    (logits [B,S,V_padded], aux: the layers' router losses summed in f32,
    caches). ``cache_pos`` is an int or an int tensor ``[B]`` (per-row
    decode positions); caches are written in place (``commit`` [B] bool
    limits the rows). ``remat`` checkpoints every block of a forward
    without caches (`repro_torch.models.remat`), as the reference's
    ``jax.checkpoint`` of its layer body. ``split`` (a training forward on
    a rank's shard, `repro_torch.models.gather.NodeSplit`): ``layers``
    holds the rank's blocks, and each layer is gathered just before its
    block (inside the checkpoint with ``remat``)."""
    compute_dtype = dtype_of(cfg.compute_dtype)
    emb_p = params["embed_tied"] if cfg.tie_embeddings else params["embed"]
    tp = tensor.current()
    if tp is not None:
        b, s = (tokens if embeds is None else embeds).shape[:2]
        if tp.for_sequence(s) is not tp:
            # M does not divide the sequence: the whole-residual form
            with tensor.model_group(tp.for_sequence(s)):
                return forward_lm(params, cfg, tokens, embeds=embeds,
                                  caches=caches, cache_pos=cache_pos,
                                  commit=commit, remat=remat, split=split)
        # the rank's cut of the sequence (its whole length: s), or every
        # row in the whole-residual form
        x = (embed_tp(emb_p, tokens, cfg, whole=tp.whole) if embeds is None
             else tensor.own(embeds.to(compute_dtype)))
    elif embeds is None:
        x = embed(emb_p, tokens, compute_dtype)
        b, s = x.shape[:2]
    else:
        x = embeds.to(compute_dtype)
        b, s = x.shape[:2]
    ar = torch.arange(s, device=x.device)
    if cache_pos is None:
        positions = ar[None].expand(b, s)
    elif isinstance(cache_pos, int):
        positions = (cache_pos + ar)[None].expand(b, s)
    else:
        positions = cache_pos.to(x.device).reshape(-1, 1) + ar[None]
        positions = positions.expand(b, s)
    windows = layer_windows(cfg)
    layer = _layer_source(params["layers"], split, "layers",
                          remat and caches is None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        lp = layer(i)
        if remat and caches is None:
            # the reference's jax.checkpoint of the layer body: only the
            # block's input and its parameter views are kept
            x, *aux_i = checkpoint(_remat_block(cfg, int(windows[i])), x,
                                   positions, lp)
            aux_i = aux_i[0] if aux_i else None
        else:
            x, aux_i = block_apply(lp, x, cfg, positions=positions,
                                   window=int(windows[i]),
                                   cache=None if caches is None
                                   else caches[i],
                                   cache_pos=cache_pos, commit=commit)
        if aux_i is not None:
            aux = aux + aux_i
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if tp is not None:
        x = tensor.enter(x)
    if cfg.tie_embeddings:
        logits = unembed(params["embed_tied"], x)
    else:
        logits = x @ params["lm_head"]["w"].to(x.dtype)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    if cfg.padded_vocab != cfg.vocab_size:  # mask the padding columns
        v = logits.shape[-1]
        v0 = tp.rank * v if tp is not None and v < cfg.padded_vocab else 0
        pad = torch.arange(v0, v0 + v, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits, aux, caches
