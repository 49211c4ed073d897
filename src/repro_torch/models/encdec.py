"""Encoder-decoder transformer (the SeamlessM4T-style audio family): port of
``repro.models.encdec``.

The modality frontend (mel spectrogram and conv feature extractor) is a
stub, as in the reference: the model consumes precomputed frame embeddings
``[B, S_enc, frontend_dim]``, projected by ``frontend_proj`` (biased). The
encoder is bidirectional: its self-attention (RoPE, no mask) takes the
flash kernel with ``causal=False`` at S = T = the frame count. The decoder
has cached causal self-attention and cross-attention to the encoder
output, whose K/V ``decode_step`` recomputes from ``enc_out`` at every
step, as the reference does.

Params are the reference's tree: ``frontend_proj``, ``enc_layers`` and
``dec_layers`` (leaves stacked ``[L, ...]``), ``enc_norm``, ``embed``,
``final_norm`` and ``lm_head``. Caches are ``{"self": [per-layer {"k",
"v"}], "enc_out": [B, enc_seq_len, D]}`` in the compute dtype, updated in
place; the serving steps copy an encoder output into ``enc_out`` before
their replays.

**Tensor parallelism** (a split step or a served model on a model group,
`repro_torch.sharding.tensor`): as the reference's ``logical_shard`` calls
place it, each residual stream is cut on the sequence where M divides it
and whole where it does not (:meth:`~repro_torch.sharding.tensor.
TensorPlan.for_sequence`: the frames and the tokens pick their forms on
their own). The frames are projected whole (``frontend_proj`` stays
whole) and each rank keeps its rows (or all of them); each encoder block
enters its attention (unmasked) and its MLP with a gather and leaves them
on the cut, as a decoder-only block does; ``enc_norm`` runs on the cut,
and the encoder output is gathered **once** a forward for every decoder
layer's cross-attention (the gather's backward sums all their cotangents
in one reduce_scatter; in the whole form no gather at all). The decoder
embeds through the d_model-cut table's all_to_all; each of its blocks runs
self-attention, cross-attention over the whole encoder output and the MLP
on the cut; the logits are the rank's vocab cut, their padding columns
masked by global index. Served (:func:`decode_step` with caches and a
plan), the self-attention writes the rank's cut cache (K/V on its KV
heads or its slice of the head dim) and the cross-attention reads the
whole ``enc_out`` on the rank's heads; :func:`encode` over the group
writes that encoder output (`repro_torch.launch.serve.encode_step_for`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (attention, attention_shapes,
                                          attention_tp, make_cache)
from repro_torch.models.layers import (dtype_of, embed, init_linear_, linear,
                                       mlp, normal_, rmsnorm)
from repro_torch.models.remat import checkpoint
from repro_torch.models.transformer import (_layer_source, _map, embed_tp,
                                            mlp_shapes)
from repro_torch.sharding import tensor


def _enc_block_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"attn_norm": {"scale": (d,)}, "attn": attention_shapes(cfg),
            "mlp_norm": {"scale": (d,)}, "mlp": mlp_shapes(cfg)}


def _dec_block_shapes(cfg: ModelConfig) -> dict:
    return dict(_enc_block_shapes(cfg), cross_norm={"scale": (cfg.d_model,)},
                cross=attention_shapes(cfg))


def encdec_shapes(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.padded_vocab

    def stack(n, tree):
        return _map(tree, lambda shape: (n,) + tuple(shape))

    return {"frontend_proj": {"w": (cfg.frontend_dim, d), "b": (d,)},
            "enc_layers": stack(cfg.n_enc_layers, _enc_block_shapes(cfg)),
            "enc_norm": {"scale": (d,)},
            "embed": {"table": (v, d)},
            "dec_layers": stack(cfg.n_layers, _dec_block_shapes(cfg)),
            "final_norm": {"scale": (d,)},
            "lm_head": {"w": (d, v)}}


def init_encdec_(params: dict, cfg: ModelConfig,
                 generator: torch.Generator) -> None:
    """Fill a param tree in place with the reference's init scales, drawn
    from ``generator``: linears N(0, 1/in) with zero biases, the embedding
    N(0, 0.02²), norms one."""
    init_linear_(params["frontend_proj"], generator)
    normal_(params["embed"]["table"], generator, 0.02)
    init_linear_(params["lm_head"], generator)
    for name in ("enc_layers", "dec_layers"):
        layers = params[name]
        n = cfg.n_enc_layers if name == "enc_layers" else cfg.n_layers
        for i in range(n):
            lp = _map(layers, lambda t: t[i])
            for key, sub in lp.items():
                if key.endswith("norm"):
                    sub["scale"].fill_(1.0)
                else:  # attn, cross, mlp: dicts of linears
                    for layer in sub.values():
                        init_linear_(layer, generator)
    for name in ("enc_norm", "final_norm"):
        params[name]["scale"].fill_(1.0)


def _enc_block(lp, x, cfg: ModelConfig, positions):
    """One encoder block: unmasked self-attention, the MLP (on the rank's
    cut of the frames under tensor parallelism)."""
    a = rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
    if tensor.current() is None:
        x = x + attention(lp["attn"], a, cfg, positions=positions,
                          causal=False)
    else:
        x = x + attention_tp(lp["attn"], a, cfg, positions=positions,
                             causal=False)
    m = rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
    return x + mlp(lp["mlp"], m, cfg)


def encode(params, cfg: ModelConfig, frames, split=None):
    """frames [B, S_enc, frontend_dim] → enc_out [B, S_enc, D]; ``split``
    gathers each layer from a rank's blocks (`forward_lm`). Under tensor
    parallelism the blocks run on the rank's cut of the frames and the
    output is gathered whole once, or where the model group does not
    divide the frames on all of them (the whole-residual form)."""
    tp = tensor.current()
    if tp is not None and tp.for_sequence(frames.shape[1]) is not tp:
        with tensor.model_group(tp.for_sequence(frames.shape[1])):
            return encode(params, cfg, frames, split)
    x = linear(params["frontend_proj"],
               frames.to(dtype_of(cfg.compute_dtype)))
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    if tp is not None:
        x = tensor.own(x)
    layer = _layer_source(params["enc_layers"], split, "enc_layers", False)
    for i in range(cfg.n_enc_layers):
        x = _enc_block(layer(i), x, cfg, positions)
    x = rmsnorm(params["enc_norm"], x, cfg.norm_eps)
    return x if tp is None else tensor.enter(x)


def make_encdec_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device, place=None, seq: int = 1) -> dict:
    """``{"self": per-layer {"k", "v"}, "enc_out": [B, enc_seq_len, D]}``
    in the compute dtype; with ``place`` (a `repro_torch.sharding.rules.
    Placement`, or a stored rank's ``CacheCut``) a rank's: the self K/V
    its cut (the sequence in ``seq`` parts), ``enc_out`` whole
    (`repro_torch.sharding.rules.cache_shapes`)."""
    dtype = dtype_of(cfg.compute_dtype)
    if place is not None:
        from repro_torch.sharding.rules import layer_cache_shapes
        shapes = layer_cache_shapes(cfg, place, batch, max_len, seq)
        return {"self": [{key: torch.zeros(shapes[key], dtype=dtype,
                                           device=device)
                          for key in ("k", "v")}
                         for _ in range(cfg.n_layers)],
                "enc_out": torch.zeros(shapes["enc_out"], dtype=dtype,
                                       device=device)}
    return {"self": [make_cache(cfg, batch, max_len, dtype, device)
                     for _ in range(cfg.n_layers)],
            "enc_out": torch.zeros((batch, cfg.enc_seq_len, cfg.d_model),
                                   dtype=dtype, device=device)}


def _remat_dec_block(cfg: ModelConfig):
    """A teacher-forced decoder block for
    :func:`~repro_torch.models.remat.checkpoint`: ``(x, enc_out,
    positions, p) -> (x,)``; the encoder output's gradient flows back."""
    def fn(x, enc_out, positions, lp):
        return (_dec_block(lp, x, cfg, positions, enc_out, None, None,
                           None),)

    return fn


def _dec_block(lp, x, cfg: ModelConfig, positions, enc_out, cache,
               cache_pos, commit):
    """One decoder block: self-attention (``cache`` written in place when
    given), cross-attention over ``enc_out``, the MLP; under tensor
    parallelism on the rank's cut of the tokens (or all of them),
    ``enc_out`` whole, ``cache`` the rank's cut."""
    split = tensor.current() is not None
    a = rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
    if split:
        x = x + attention_tp(lp["attn"], a, cfg, positions=positions,
                             cache=cache, cache_pos=cache_pos, commit=commit)
    else:
        x = x + attention(lp["attn"], a, cfg, positions=positions,
                          cache=cache, cache_pos=cache_pos, commit=commit)
    c = rmsnorm(lp["cross_norm"], x, cfg.norm_eps)
    if split:
        x = x + attention_tp(lp["cross"], c, cfg, positions=positions,
                             kv=enc_out)
    else:
        x = x + attention(lp["cross"], c, cfg, positions=positions,
                          causal=False, kv_x=enc_out)
    m = rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
    return x + mlp(lp["mlp"], m, cfg)


def decode_step(params, cfg: ModelConfig, tokens, caches: Optional[dict],
                cache_pos, *, enc_out=None, commit=None, remat=False,
                split=None):
    """Decoder forward: tokens [B,S] → (logits [B,S,V_padded], aux 0,
    caches). With caches (from :func:`make_encdec_cache`) the
    self-attention writes them in place at ``cache_pos`` (an int or a
    ``[B]`` tensor; ``commit`` limits the rows) and the cross-attention
    reads ``caches["enc_out"]``; without (teacher-forced training) it reads
    ``enc_out`` and the positions are 0..S-1; there ``remat`` checkpoints
    every decoder block, as the reference's ``jax.checkpoint`` of its
    decoder body (the encoder is not checkpointed), and ``split`` gathers
    each layer from a rank's blocks (`forward_lm`). Under tensor
    parallelism the blocks run on the rank's cut of the tokens, or where
    the model group does not divide them on all of them (the
    whole-residual form: a served step's one token), the caches the
    rank's cut; the logits are its vocab cut (whole where M does not
    divide the padded vocab)."""
    compute_dtype = dtype_of(cfg.compute_dtype)
    tp = tensor.current()
    b, s = tokens.shape[:2]
    if tp is not None and tp.for_sequence(s) is not tp:
        with tensor.model_group(tp.for_sequence(s)):
            return decode_step(params, cfg, tokens, caches, cache_pos,
                               enc_out=enc_out, commit=commit, remat=remat,
                               split=split)
    if tp is None:
        x = embed(params["embed"], tokens, compute_dtype)
    else:
        x = embed_tp(params["embed"], tokens, cfg, whole=tp.whole)
    if enc_out is None:
        enc_out = caches["enc_out"].to(compute_dtype)
    ar = torch.arange(s, device=x.device)
    if cache_pos is None:
        positions = ar[None].expand(b, s)
    elif isinstance(cache_pos, int):
        positions = (cache_pos + ar)[None].expand(b, s)
    else:
        positions = (cache_pos.to(x.device).reshape(-1, 1)
                     + ar[None]).expand(b, s)
    layer = _layer_source(params["dec_layers"], split, "dec_layers",
                          remat and caches is None)
    for i in range(cfg.n_layers):
        lp = layer(i)
        if remat and caches is None:
            (x,) = checkpoint(_remat_dec_block(cfg), x, enc_out, positions,
                              lp)
        else:
            x = _dec_block(lp, x, cfg, positions, enc_out,
                           None if caches is None else caches["self"][i],
                           cache_pos, commit)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if tp is not None:
        x = tensor.enter(x)
    logits = x @ params["lm_head"]["w"].to(x.dtype)
    if cfg.padded_vocab != cfg.vocab_size:  # mask the padding columns
        v = logits.shape[-1]
        v0 = tp.rank * v if tp is not None and v < cfg.padded_vocab else 0
        pad = torch.arange(v0, v0 + v, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, aux, caches


def forward_encdec(params, cfg: ModelConfig, frames, tokens, *,
                   remat=False, split=None):
    """Teacher-forced training forward: (logits, aux)."""
    enc_out = encode(params, cfg, frames, split=split)
    logits, aux, _ = decode_step(params, cfg, tokens, None, None,
                                 enc_out=enc_out, remat=remat, split=split)
    return logits, aux
