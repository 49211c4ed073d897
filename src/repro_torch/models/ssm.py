"""Mamba-2 (SSD — state-space duality) mixer: port of ``repro.models.ssm``.

Two forms, chosen by the call's shape:

* **prefill** (no state, or S > 1): the chunked SSD scan over the sequence
  padded to a chunk multiple, through `repro_torch.kernels.ops.ssd_op` —
  the hand-written ``ssd_scan`` kernel on a CUDA tensor (counted in
  ``kernels.LAUNCHES["ssd_scan"]``), its plain version on a CPU tensor.
  B/C go in per group; the kernel reads head h's group by index. The kernel
  forms ``x·dt`` in f32, where the reference's jnp ``ssd_chunked`` forms it
  in the compute dtype; at f32 they agree within the reference's 1e-4.
* **decode** (a state and S = 1): the O(1) recurrent update, plain torch,
  as in the reference.

:func:`ssd_chunked` is a twin of the reference's pure-jnp chunked scan,
kept for the tests (the model path does not call it).

Under tensor parallelism (:func:`ssm_tp`, a split step on a model group,
`repro_torch.sharding.tensor`) the heads are cut over the group where it
divides them (the reference's ``ff`` on the heads axis): a rank runs the
SSD scan on its ``h / M`` heads over the gathered sequence, the conv on
its channels, B and C whole (or the groups its heads read), and the
gated norm's mean over all of ``d_inner`` sums the rank's squares over the
group (f32); ``out_proj`` is row-parallel. Otherwise (M does not divide
the heads, or a rank's heads would read their groups unevenly) every rank
runs the whole mixer on the gathered sequence and keeps its rows. In the
whole-residual form (a sequence M does not divide, with or without a
gradient) the gathered sequence is every rank's own. Serving keeps a
rank's state on its heads: a prefill's final SSD state of its heads and
the conv tail of its channels, a decode step's O(1) update on them, the
gated norm's sum of squares and ``out_proj`` all_reduced (the
whole-residual form); with the heads whole, the state is whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (init_linear_, linear, normal_,
                                       row_parallel)
from repro_torch.sharding import tensor


def _dims(cfg: ModelConfig):
    di = cfg.d_inner
    h = cfg.n_ssm_heads
    return di, h, di // h, cfg.ssm_state, cfg.ssm_groups


def ssm_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di, h, pdim, n, g = _dims(cfg)
    conv_dim = di + 2 * g * n
    lin = (lambda i, o: {"w": (i, o), "b": (o,)} if cfg.use_bias
           else {"w": (i, o)})
    return {"in_proj": lin(d, 2 * di + 2 * g * n + h),
            "conv": {"w": (cfg.conv_width, conv_dim), "b": (conv_dim,)},
            "A_log": (h,), "D": (h,), "dt_bias": (h,),
            "norm_scale": (di,), "out_proj": lin(di, d)}


def init_ssm_(p: dict, cfg: ModelConfig, generator: torch.Generator) -> None:
    """Fill a layer's SSM params in place (the reference's scales)."""
    _, h, _, _, _ = _dims(cfg)
    init_linear_(p["in_proj"], generator)
    normal_(p["conv"]["w"], generator, 0.1)
    p["conv"]["b"].zero_()
    p["A_log"].copy_(torch.log(torch.linspace(1.0, 16.0, h)))
    p["D"].fill_(1.0)
    p["dt_bias"].zero_()
    p["norm_scale"].fill_(1.0)
    init_linear_(p["out_proj"], generator)


def make_ssm_state(cfg: ModelConfig, batch: int, dtype, device):
    di, h, pdim, n, g = _dims(cfg)
    conv_dim = di + 2 * g * n
    return {"ssd": torch.zeros((batch, h, pdim, n), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                                dtype=dtype, device=device)}



def _causal_conv(conv_p, u, prefix=None):
    """Depthwise causal conv. u [B,S,C]; prefix [B,W-1,C] for decode."""
    w = conv_p["w"].to(u.dtype)          # [W, C]
    width = w.shape[0]
    if prefix is None:
        pad = torch.zeros((u.shape[0], width - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = prefix.to(u.dtype)
    full = torch.cat([pad, u], dim=1)    # [B, S+W-1, C]
    out = sum(full[:, i:i + u.shape[1]] * w[i] for i in range(width))
    out = out + conv_p["b"].to(u.dtype)
    return F.silu(out), full[:, -(width - 1):]


def _gated_norm(scale, y, z, eps, width: int = 0):
    """The gated RMSNorm; with ``width`` (a heads cut: ``y`` holds the
    rank's channels of ``width``) the mean of squares sums over the model
    group."""
    y = y * F.silu(z.to(torch.float32)).to(y.dtype)
    yf = y.to(torch.float32)
    if width:
        var = tensor.all_reduce(torch.sum(yf * yf, dim=-1,
                                          keepdim=True)) / width
    else:
        var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(y.dtype)


def _to_heads(t, h: int):
    """[B, G, N] per group → [B, H, N] per head (head i reads group
    i // (H/G)), as a broadcast view where G = 1."""
    b, g, n = t.shape
    return t[:, :, None].expand(b, g, h // g, n).reshape(b, h, n)


def ssd_chunked(x, dt, a_log, bmat, cmat, chunk: int):
    """Chunked SSD scan: twin of the reference's pure-jnp ``ssd_chunked``.
    x [B,S,H,P]; dt [B,S,H]; a_log [H]; bmat/cmat [B,S,G,N]. Returns y
    [B,S,H,P] in x's dtype and the final state [B,H,P,N] f32."""
    b, s, h, pdim = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    rep = h // g
    nc = s // chunk
    dtype = x.dtype
    f32 = torch.float32
    dA = dt * (-torch.exp(a_log.to(f32)))                  # [B,S,H]
    xdt = x * dt[..., None].to(dtype)

    def ch(t):
        return t.reshape((b, nc, chunk) + tuple(t.shape[2:]))

    xc, dAc = ch(xdt), ch(dA)
    bc = torch.repeat_interleave(ch(bmat), rep, dim=3)      # [B,nc,L,H,N]
    cc = torch.repeat_interleave(ch(cmat), rep, dim=3)
    cum = torch.cumsum(dAc, dim=2)                          # [B,nc,L,H]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [B,nc,L,L,H]
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    lmat = torch.exp(torch.where(causal, diff, -1e30))
    scores = torch.einsum("bclhn,bcmhn->bclmh", cc.to(f32), bc.to(f32))
    y_diag = torch.einsum("bclmh,bclmh,bcmhp->bclhp", scores, lmat,
                          xc.to(f32))
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)       # [B,nc,L,H]
    states = torch.einsum("bclhn,bclh,bclhp->bchpn", bc.to(f32),
                          decay_to_end, xc.to(f32))
    chunk_decay = torch.exp(cum[:, :, -1, :])               # [B,nc,H]
    carry = torch.zeros((b, h, pdim, n), dtype=f32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                  # [B,nc,H,P,N]
    y_off = torch.einsum("bclhn,bclh,bchpn->bclhp", cc.to(f32),
                         torch.exp(cum), prev_states)
    y = (y_diag + y_off).reshape(b, s, h, pdim).to(dtype)
    return y, carry


def ssm_block(p, x, cfg: ModelConfig, *, state=None):
    """Full mamba2 mixer. x [B,S,D] -> (y [B,S,D], new_state or None); the
    caller writes a new state into its cache. The widths are the params':
    a model rank's compute blocks under a heads cut (:func:`ssm_tp`) give
    its heads' channels (``y`` the rank's share, reduce_scattered onto
    its cut of the sequence)."""
    b, s, d = x.shape
    _, _, pdim, n, _ = _dims(cfg)
    di, h = p["norm_scale"].shape[0], p["A_log"].shape[0]
    g = (p["conv"]["w"].shape[-1] - di) // (2 * n)
    zxbcdt = linear(p["in_proj"], x)
    z, xin, bmat, cmat, dt = torch.split(zxbcdt, [di, di, g * n, g * n, h],
                                         dim=-1)

    conv_in = torch.cat([xin, bmat, cmat], dim=-1)
    decode = state is not None and s == 1
    conv_prefix = state["conv"] if decode else None
    conv_out, new_conv = _causal_conv(p["conv"], conv_in, conv_prefix)
    xin, bmat, cmat = torch.split(conv_out, [di, g * n, g * n], dim=-1)

    xh = xin.reshape(b, s, h, pdim)
    bm = bmat.reshape(b, s, g, n)
    cm = cmat.reshape(b, s, g, n)
    f32 = torch.float32
    dtv = F.softplus(dt.to(f32) + p["dt_bias"].to(f32))    # [B,S,H]
    a_log = p["A_log"].to(f32)

    if decode:
        dA = torch.exp(dtv[:, 0] * (-torch.exp(a_log)))     # [B,H]
        bm1 = _to_heads(bm[:, 0], h)                        # [B,H,N]
        cm1 = _to_heads(cm[:, 0], h)
        xdt = (xh[:, 0] * dtv[:, 0, :, None]).to(f32)       # [B,H,P]
        new_ssd = state["ssd"] * dA[:, :, None, None] + torch.einsum(
            "bhp,bhn->bhpn", xdt, bm1.to(f32))
        y = torch.einsum("bhpn,bhn->bhp", new_ssd, cm1.to(f32))
        y = y[:, None].to(x.dtype)                          # [B,1,H,P]
        new_state = {"ssd": new_ssd, "conv": new_conv}
    else:
        chunk = min(cfg.ssm_chunk, s)
        pad = (-s) % chunk
        xs, bs, cs, dts = xh, bm, cm, dtv
        if pad:
            xs, bs, cs = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xh, bm, cm))
            dts = F.pad(dtv, (0, 0, 0, pad))
        y, final = ops.ssd_op(xs, dts, a_log, bs, cs, chunk=chunk)
        y = y[:, :s]
        new_state = ({"ssd": final, "conv": new_conv} if state is not None
                     else None)

    y = y + xh * p["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(b, s, di)
    if di == cfg.d_inner:
        y = _gated_norm(p["norm_scale"], y, z, cfg.norm_eps)
        return linear(p["out_proj"], y.to(x.dtype)), new_state
    y = _gated_norm(p["norm_scale"], y, z, cfg.norm_eps, width=cfg.d_inner)
    return row_parallel(p["out_proj"], y.to(x.dtype)), new_state



def ssm_tp(p, h, cfg: ModelConfig, h_full=None, state=None):
    """The mixer under tensor parallelism: ``h`` [B, S/M, D] the rank's
    cut of the sequence, or every row in the whole-residual form
    (``h_full`` the whole sequence, when the block has it), ``p`` the
    compute blocks → (the rank's cut of y [B, S/M, D], the new state or
    None): its heads over the whole sequence (:func:`ssm_block` reads the
    widths of the blocks), or with the heads whole the whole mixer and its
    rows. ``state`` (the rank's cut: its heads' SSD state and the conv
    tail of its channels, `repro_torch.sharding.rules.cache_shapes`) makes
    a prefill return its final state, and a one-token step the O(1)
    update of the rank's heads."""
    tp = tensor.current()
    if h_full is None:
        h_full = tensor.enter(h)
    y, st = ssm_block(p, h_full, cfg, state=state)
    return (y if tp.place.ssm_heads else tensor.own(y)), st
