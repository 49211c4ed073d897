"""Grouped-query attention with RoPE, sliding-window masking, a KV cache
and cross-attention: port of ``repro.models.attention``.

Two forms, chosen explicitly by the call's shape, never by catching a
failure:

* **the kernel's** — S > 1 and either a causal self-attention prefill
  (query positions 0..S-1: no cache, or a cache written at ``cache_pos =
  0``) or a call with no mask and no cache (the enc-dec encoder's
  bidirectional self-attention, ``causal=False``, and the teacher-forced
  cross-attention to the encoder output). It runs through
  `repro_torch.kernels.ops.attention_op`: the hand-written flash kernel on
  a CUDA tensor (counted in ``kernels.LAUNCHES["flash_attention"]``), its
  plain version on a CPU tensor. With a cache, K/V are the cache's whole
  depth T, as the reference attends over it; keys past the prompt are
  masked by causality (and skipped by the kernel's tile skip). The kernel
  keeps scores and probabilities in f32 throughout, where the reference's
  jnp module forms scores in the compute dtype and casts the probabilities
  to it before ``P·V``; at f32 the two agree within the reference's 2e-4.
* **everything else** (decode, ``S = 1``) — plain torch, as the reference
  computes it in jnp outside any Pallas kernel.

Cross-attention (``kv_x``, the encoder output ``[B, T, D]``) takes K/V
from ``kv_x`` and applies neither RoPE nor a mask, as the reference does;
the reference's ``kv_positions`` feeds only RoPE and the causal mask, so a
cross call has no use for it and the port does not take it.

``cache_pos`` is a Python int (one position for every row) or an int
tensor ``[B]`` (one per row: the serving engine's slots sit at different
depths). The cache is updated in place by index writes, never copied;
``commit`` (bool ``[B]``, optional) limits the write to the rows it marks,
as the reference engine's masked commit keeps the other lanes' caches.

Under tensor parallelism (a split step or a served model on a model
group, `repro_torch.sharding.tensor`) :func:`attention_tp` takes the
rank's cut of the sequence (every row in the whole-residual form) and the
params' compute blocks, and places the work as the reference's
``logical_shard`` calls do: **head-parallel** where the KV
heads divide the group (q, k, v on the rank's ``n_heads / M`` and
``n_kv_heads / M`` heads over the gathered sequence, the output
row-parallel), else **sequence-parallel** (the rank's ``S / M`` query rows
over the whole K/V, through the flash kernel's query offset, the weights
whole). The enc-dec encoder's unmasked self-attention and the decoder's
cross-attention (K/V from the whole encoder output, gathered once a
forward) take the same two placements, ``causal=False`` and with no query
offset: no mask needs one. In the whole-residual form (a sequence M does
not divide, a training step's too) a head-parallel rank runs its heads
over every row, a sequence-parallel one every head. Served, a rank's
decode cache is the reference's placement (`repro_torch.sharding.rules.
cache_cut`): K/V on its KV heads, else on its slice of the head dim, else
whole; a decode step's cross-attention takes q on the rank's heads (or
all of them) and K/V from the whole encoder output on the same heads.

Served from a rank's stored shard (the dry run's ``dp`` and ``zero3``
profiles, `repro_torch.sharding.stored`: no tensor plan) :func:`attention`
computes every head and places its cache by the :class:`~repro_torch.
sharding.stored.CachePlan`: it writes the rank's cut (its KV heads or its
slice of the head dim) and the positions it holds, a prefill attends over
its own fresh K/V, and a decode step over the cache gathered whole over
the model group, its partial softmax combined over the group that cuts
the sequence.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, linear, row_parallel
from repro_torch.sharding import stored, tensor

NEG_INF = -1e30


def attention_shapes(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    dims = {"q": (d, nh * hd), "k": (d, nkv * hd), "v": (d, nkv * hd),
            "o": (nh * hd, d)}
    out = {}
    for name, (i, o) in dims.items():
        out[name] = {"w": (i, o)}
        if cfg.use_bias:
            out[name]["b"] = (o,)
    return out


def make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _gqa_scores(q, k):
    """q [B,S,nh,hd], k [B,T,nkv,hd] -> scores [B,nkv,g,S,T]."""
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, s, nkv, nh // nkv, hd)
    # √hd rounded to q's dtype, as the reference divides (a host scalar:
    # no copy to the device)
    scale = float(torch.tensor(math.sqrt(hd), dtype=q.dtype))
    return torch.einsum("bskgh,btkh->bkgst", qg, k) / scale


def _gqa_out(probs, v):
    """probs [B,nkv,g,S,T], v [B,T,nkv,hd] -> [B,S,nh,hd]."""
    b, nkv, g, s, t = probs.shape
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(b, s, nkv * g, -1)


def write_rows(buf, new, positions, commit=None):
    """``buf[b, positions[b, i]] = new[b, i]`` in place (buf [B, T, ...],
    new [B, S, ...], positions [B, S] int); with ``commit`` [B] only the
    rows it marks change."""
    b, s = positions.shape
    rows = torch.arange(b, device=buf.device)[:, None].expand(b, s)
    if commit is not None:
        keep = commit.reshape((b, 1) + (1,) * (new.dim() - 2))
        new = torch.where(keep, new, buf[rows, positions])
    buf[rows, positions] = new.to(buf.dtype)


def uses_kernel(s: int, cache, cache_pos, masked: bool) -> bool:
    """Whether a call takes the flash kernel's form: S > 1 and either a
    causal prefill (``masked``: query positions 0..S-1, no cache or a
    cache written at position 0) or an unmasked call with no cache."""
    if s <= 1:
        return False
    if masked:
        return cache is None or (isinstance(cache_pos, int)
                                 and cache_pos == 0)
    return cache is None


def attention(p, x, cfg: ModelConfig, *, positions, causal: bool = True,
              window: int = 0, cache: Optional[dict] = None, cache_pos=None,
              commit=None, kv_x=None):
    """x [B,S,D], positions [B,S] → output [B,S,D]; a cache's ``k``/``v``
    ([B,T,nkv,hd]) are written in place at the positions. Without a cache
    the query positions are 0..S-1, as every caller of the reference's
    self-attention gives them. ``kv_x`` [B,T,D] makes it cross-attention
    (no RoPE, no mask, no cache)."""
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, s, _ = x.shape
    is_cross = kv_x is not None
    if is_cross and cache is not None:
        raise ValueError("cross-attention takes no cache")
    src = kv_x if is_cross else x
    t = src.shape[1]
    q = linear(p["q"], x).reshape(b, s, nh, hd)
    k = linear(p["k"], src).reshape(b, t, nkv, hd)
    v = linear(p["v"], src).reshape(b, t, nkv, hd)
    if not is_cross:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    masked = causal and not is_cross
    window = int(window) if masked else 0
    kernel = uses_kernel(s, cache, cache_pos, masked)
    plan = stored.current()
    if cache is not None:
        _write_cache(cache, k, v, positions, cache_pos, commit)
        if plan is None:
            k, v = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
        elif not kernel:        # the cache whole over the model group
            k, v = (t.to(x.dtype) for t in stored.whole_kv(cache))

    if kernel:
        out = ops.attention_op(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=masked,
                               window=window)
        out = out.transpose(1, 2)                           # [B,S,nh,hd]
    else:
        scores = _gqa_scores(q, k)                          # [B,nkv,g,S,T]
        lo = 0 if cache is None else _seq_start(cache)
        mask = _mask(positions, cache, s, k.shape[1], masked, window,
                     x.device, k_off=lo)
        seq = None if cache is None or plan is None else plan.seq_view
        out = (_softmax_out(scores, mask, v, x.dtype) if seq is None else
               tensor.seq_softmax(scores, mask, v, x.dtype, seq))
    return linear(p["o"], out.reshape(b, s, nh * hd))


def _seq_view():
    """The group the decode cache's sequence is cut over: the tensor
    plan's, else the stored plan's, else None."""
    tp, sp = tensor.current(), stored.current()
    if tp is not None:
        return tp.seq_view
    return None if sp is None else sp.seq_view


def _cut_rank() -> int:
    """This rank's index in the group that cuts its cache's heads or head
    dim (the tensor plan's model group, else the stored plan's)."""
    tp = tensor.current()
    return tp.rank if tp is not None else stored.current().rank


def _seq_start(cache) -> int:
    """The first position of a decode cache's own slice: a data rank's
    ``rank · T_local`` where the plan cuts the cache's sequence over its
    data group (`repro_torch.sharding.tensor.TensorPlan.seq_view`), else
    0."""
    seq = _seq_view()
    return 0 if seq is None else seq.rank * cache["k"].shape[1]


def _write_cache(cache, k, v, positions, cache_pos, commit) -> None:
    """K/V [B,S,nkv,hd] into the cache in place at ``positions`` (a slice
    at an int ``cache_pos`` with no ``commit``); a cache cut on its head
    dim (a model rank's, ``head_dim`` narrower than K's) takes the rank's
    slice of it. A cache cut on its sequence holds positions ``lo .. lo +
    T_local - 1`` (:func:`_seq_start`): only the positions it holds are
    written, so a decode step's new K/V lands on the one data rank that
    owns ``pos``."""
    width, heads = cache["k"].shape[-1], cache["k"].shape[-2]
    if width != k.shape[-1]:
        c0 = _cut_rank() * width
        k, v = k[..., c0:c0 + width], v[..., c0:c0 + width]
    if heads != k.shape[-2]:            # a stored plan's KV-heads cut
        h0 = _cut_rank() * heads
        k, v = k[:, :, h0:h0 + heads], v[:, :, h0:h0 + heads]
    s, t = k.shape[1], cache["k"].shape[1]
    seq = _seq_view() is not None
    lo = _seq_start(cache)
    if isinstance(cache_pos, int) and commit is None:
        a, b = cache_pos, cache_pos + s
        if seq:                         # the positions this slice holds
            a, b = max(a, lo), min(b, lo + t)
        if a < b:
            ka, kb = a - cache_pos, b - cache_pos
            cache["k"][:, a - lo:b - lo] = k[:, ka:kb].to(cache["k"].dtype)
            cache["v"][:, a - lo:b - lo] = v[:, ka:kb].to(cache["v"].dtype)
        return
    if seq:
        own = ((positions >= lo) & (positions < lo + t)).all(dim=1)
        commit = own if commit is None else commit & own
        positions = (positions - lo).clamp(0, t - 1)
    write_rows(cache["k"], k, positions, commit)
    write_rows(cache["v"], v, positions, commit)


def _mask(positions, cache, s: int, t: int, masked: bool, window: int,
          device, k_off: int = 0):
    """The plain form's mask of scores [B,nkv,g,S,T]: causal (and
    windowed) over the cache's depth (its positions from ``k_off``: a
    sequence-cut cache's own slice), or the call's own positions without
    a cache; all keys when unmasked."""
    if not masked:
        return torch.ones((s, t), dtype=torch.bool, device=device)
    key_positions = (positions if cache is None else
                     k_off + torch.arange(t, device=device)[None])
    qpos = positions[:, None, None, :, None]
    kpos = key_positions[:, None, None, None, :]
    w_eff = window if window > 0 else 2 ** 30
    return (kpos <= qpos) & (kpos > qpos - w_eff)


def _softmax_out(scores, mask, v, dtype):
    """Masked f32 softmax of ``scores`` [B,nkv,g,S,T], the probabilities
    in ``dtype``, times ``v`` [B,T,nkv,hd] → [B,S,nh,hd]."""
    scores = torch.where(mask, scores.to(torch.float32), NEG_INF)
    return _gqa_out(torch.softmax(scores, dim=-1).to(dtype), v)


def attention_tp(p, h, cfg: ModelConfig, *, positions, window: int = 0,
                 h_full=None, causal: bool = True, kv=None, cache=None,
                 cache_pos=None, commit=None):
    """Attention under tensor parallelism: ``h`` [B, S/M, D] the rank's
    cut of the sequence, or every row in the whole-residual form
    (``h_full`` [B, S, D] the whole sequence, when the block already has
    it), ``positions`` [B, S] the whole sequence's, ``p`` the compute
    blocks → the rank's cut of the output (whole in the whole-residual
    form). Causal self-attention by default; ``causal=False`` the unmasked
    form (the enc-dec encoder); ``kv`` [B, T, D] (the whole encoder output)
    makes it cross-attention: K/V from ``kv``, no RoPE, no mask.
    Head-parallel: q on the rank's heads over the whole sequence, K/V on
    its KV heads; sequence-parallel: q on the rank's rows (for
    cross-attention no gather at all), K/V whole, the query offset only
    where the mask needs it.

    ``cache`` (the rank's cut, `repro_torch.sharding.rules.cache_shapes`)
    is written in place at the positions: head-parallel the rank's KV
    heads, sequence-parallel the K/V whole or the rank's head-dim slice.
    A prefill (S > 1 at ``cache_pos`` 0) attends through the flash kernel
    over its own K/V. A decode step (the whole-residual form) attends over
    the cache: head-parallel the rank's heads; under a head-dim cut q, K
    and V whole (RoPE before the cut: it rotates the pairs (i, i + hd/2)),
    the partial scores over the rank's slice all_reduced in f32 before the
    mask and softmax, then ``o`` on the slice's rows, all_reduced. Where
    the plan cuts the cache's sequence over its data group (``seq_view``,
    the reference's long-context placement) a rank scores q against its
    own positions only (those at or below ``pos`` and inside the window)
    and the partial softmax combines over the group
    (`repro_torch.sharding.tensor.seq_softmax`), after the head-dim cut's
    all_reduce over the model group; only the rank that owns ``pos``
    writes the new K/V."""
    tp = tensor.current()
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, sl, _ = h.shape
    is_cross = kv is not None
    causal = causal and not is_cross
    window = int(window) if causal else 0
    heads = tp.place.attention == "heads"
    if h_full is None and (heads or not is_cross):
        h_full = tensor.enter(h)
    s = sl if tp.whole else sl * tp.size
    src = kv if is_cross else h_full
    t = src.shape[1]
    kernel = uses_kernel(s, cache, cache_pos, causal)
    m = tp.size if heads else 1
    x = h_full if heads else h
    q = linear(p["q"], x).reshape(b, x.shape[1], nh // m, hd)
    k = linear(p["k"], src).reshape(b, t, nkv // m, hd)
    v = linear(p["v"], src).reshape(b, t, nkv // m, hd)
    s0 = 0 if heads or tp.whole else tp.seq_cut(s)[0]
    if not is_cross:
        q = apply_rope(q, positions[:, s0:s0 + q.shape[1]], cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if cache is not None:
        _write_cache(cache, k, v, positions, cache_pos, commit)
    if kernel:
        out = ops.attention_op(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window,
                               q_off=s0 if causal else 0).transpose(1, 2)
        out = out.reshape(b, q.shape[1], -1)
        return (row_parallel(p["o"], out) if heads
                else linear(p["o"], out))
    seq = tp.seq_view if cache is not None else None
    lo = 0
    if cache is not None:
        lo = _seq_start(cache)
        k, v = cache["k"].to(h.dtype), cache["v"].to(h.dtype)
    mask = _mask(positions, cache, s, k.shape[1], causal, window, h.device,
                 k_off=lo)

    def combine(scores, v):
        if seq is None:
            return _softmax_out(scores, mask, v, h.dtype)
        return tensor.seq_softmax(scores, mask, v, h.dtype, seq)

    if heads or k.shape[-1] == hd:     # the rank's heads, or all of them
        out = combine(_gqa_scores(q, k), v)
        out = out.reshape(b, s, -1)
        return row_parallel(p["o"], out) if heads else linear(p["o"], out)
    # the head-dim cut: the rank's slice of q against its slice of K/V
    width = k.shape[-1]
    c0 = tp.rank * width
    qg = q[..., c0:c0 + width].reshape(b, s, nkv, nh // nkv, width)
    part = torch.einsum("bskgh,btkh->bkgst", qg.to(torch.float32),
                        k.to(torch.float32))
    scale = float(torch.tensor(math.sqrt(hd), dtype=q.dtype))
    scores = tensor.all_reduce(part).to(q.dtype) / scale
    out = combine(scores, v).reshape(b, s, nh * width)
    rows = lambda w: w.reshape(nh, hd, -1)[:, c0:c0 + width].reshape(
        nh * width, -1)
    o = {key: rows(w) if key in ("w", "lora_A") else w
         for key, w in p["o"].items()}
    return row_parallel(o, out)
