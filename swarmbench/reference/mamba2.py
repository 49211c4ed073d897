"""Plain reference of a Mamba-2 language model (arXiv:2405.21060).

Tied embedding → ``n_layers`` residual blocks (RMSNorm → Mamba-2 mixer) →
RMSNorm → logits against the embedding table, the padding rows of the
table masked out. The mixer: ``in_proj`` to (z, x, B, C, dt); a depthwise
causal conv of width ``conv_width`` with bias over (x, B, C), then SiLU;
``dt ← softplus(dt + dt_bias)``, ``A = −exp(A_log)``; the SSD scan
``h_t = exp(dt_t A) h_{t−1} + dt_t x_t B_tᵀ``, ``y_t = h_t C_t`` (each head
reads its group's B and C), computed by chunks of ``ssm_chunk`` steps;
``y + D x``; the gated RMSNorm ``rms(y · silu(z)) · norm_scale``;
``out_proj``. The loss is the token-mean cross entropy.

Everything is computed in float32 (matrix products through
`swarmbench.reference.precision`, so a control can round their operands).
Parameters are a dict ``{path: tensor}`` with every layer's leaves stacked
``[L, ...]``; :func:`shapes` lists them, :data:`WIDE` names the leaves the
configuration stores in float32 inside its bfloat16 model.

As every LM family's reference (named by a configuration's
``reference``), it gives ``init``, ``loss``, ``gate_metric``, ``WIDE``,
and for the benchmark's metrics :func:`forward_flops` and
:func:`kernel_calls`.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from swarmbench.reference import precision

WIDE = ("layers.ssm.A_log", "layers.ssm.D", "layers.ssm.dt_bias")


def dims(m: dict) -> dict:
    d = m["d_model"]
    di = m["ssm_expand"] * d
    h = di // m["ssm_head_dim"]
    g, n = m["ssm_groups"], m["ssm_state"]
    pad = m["vocab_pad_to"]
    return {"d": d, "di": di, "h": h, "p": m["ssm_head_dim"], "g": g, "n": n,
            "conv": di + 2 * g * n, "w": m["conv_width"],
            "vp": -(-m["vocab_size"] // pad) * pad, "v": m["vocab_size"],
            "L": m["n_layers"], "chunk": m["ssm_chunk"],
            "eps": m["norm_eps"]}


def shapes(m: dict) -> Dict[str, tuple]:
    k = dims(m)
    L, d, di = k["L"], k["d"], k["di"]
    return {"embed_tied.table": (k["vp"], d),
            "final_norm.scale": (d,),
            "layers.ssm.A_log": (L, k["h"]),
            "layers.ssm.D": (L, k["h"]),
            "layers.ssm.conv.b": (L, k["conv"]),
            "layers.ssm.conv.w": (L, k["w"], k["conv"]),
            "layers.ssm.dt_bias": (L, k["h"]),
            "layers.ssm.in_proj.w": (L, d, 2 * di + 2 * k["g"] * k["n"] + k["h"]),
            "layers.ssm.norm_scale": (L, di),
            "layers.ssm.out_proj.w": (L, di, d),
            "layers.ssm_norm.scale": (L, d)}


def init(m: dict, generator: torch.Generator, device,
         dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The published init scales: embedding N(0, 0.02²), projections
    N(0, 1/in), conv weights N(0, 0.1²), conv bias and dt_bias 0, D 1,
    A_log = log(1..16) over the heads, norm scales 1. One normal draw on
    ``device`` for every random leaf; the leaves in ``dtype``, the
    :data:`WIDE` ones in float32."""
    shp = shapes(m)
    k = dims(m)
    scales = {"embed_tied.table": 0.02, "layers.ssm.conv.w": 0.1,
              "layers.ssm.in_proj.w": 1.0 / math.sqrt(k["d"]),
              "layers.ssm.out_proj.w": 1.0 / math.sqrt(k["di"])}
    sizes = [math.prod(shp[p]) for p in scales]
    draw = torch.randn(sum(sizes), generator=generator, device=device)
    out = {}
    for (p, s), piece in zip(scales.items(), draw.split(sizes)):
        out[p] = (piece.reshape(shp[p]) * s).to(dtype)
    del draw
    a_log = torch.log(torch.linspace(1.0, 16.0, k["h"], device=device))
    out["layers.ssm.A_log"] = a_log.expand(k["L"], k["h"]).contiguous()
    for p, s in shp.items():
        if p in out:
            continue
        fill = 1.0 if p.endswith("scale") or p.endswith(".D") else 0.0
        out[p] = torch.full(s, fill, device=device,
                            dtype=torch.float32 if p in WIDE else dtype)
    return {p: out[p] for p in shp}


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def ssd(x, dt, a_log, bm, cm, chunk):
    """The SSD scan by chunks. x [B,S,H,P], dt [B,S,H], a_log [H],
    bm/cm [B,S,G,N] → y [B,S,H,P] (float32)."""
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    bh = bm.repeat_interleave(h // g, dim=2)              # [B,S,H,N]
    ch = cm.repeat_interleave(h // g, dim=2)
    a = -torch.exp(a_log)                                  # [H]
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=x.device))
    state = x.new_zeros(b, h, p, n)
    ys = []
    for t0 in range(0, s, chunk):
        sl = slice(t0, t0 + chunk)
        da = dt[:, sl] * a                                 # [B,L,H]
        cum = torch.cumsum(da, dim=1)
        u = x[:, sl] * dt[:, sl, :, None]                  # [B,L,H,P]
        seg = cum[:, :, None, :] - cum[:, None, :, :]      # [B,Lt,Ls,H]
        decay = torch.exp(torch.where(tri[None, :, :, None], seg,
                                      torch.full_like(seg, -math.inf)))
        cb = torch.einsum("bthn,bshn->btsh", ch[:, sl], bh[:, sl])
        y = torch.einsum("btsh,bshp->bthp", cb * decay, u)
        y = y + torch.einsum("bthn,bhpn->bthp",
                             ch[:, sl] * torch.exp(cum)[..., None], state)
        tail = torch.exp(cum[:, -1:, :] - cum)             # [B,L,H]
        state = (state * torch.exp(cum[:, -1])[:, :, None, None]
                 + torch.einsum("bshp,bshn->bhpn", u * tail[..., None],
                                bh[:, sl]))
        ys.append(y)
    return torch.cat(ys, dim=1)


def _mixer(p, i, h, k, policy):
    b, s, _ = h.shape
    di, g, n, nh = k["di"], k["g"], k["n"], k["h"]
    zxbcdt = precision.matmul(h, p["layers.ssm.in_proj.w"][i], policy)
    z, xin, bm, cm, dt = torch.split(zxbcdt, [di, di, g * n, g * n, nh], -1)
    u = torch.cat([xin, bm, cm], dim=-1)                   # [B,S,C]
    w = p["layers.ssm.conv.w"][i]                          # [W,C]
    full = F.pad(u, (0, 0, k["w"] - 1, 0))
    conv = sum(full[:, j:j + s] * w[j] for j in range(k["w"]))
    conv = F.silu(conv + p["layers.ssm.conv.b"][i])
    xin, bm, cm = torch.split(conv, [di, g * n, g * n], -1)
    xh = xin.reshape(b, s, nh, k["p"])
    dtv = F.softplus(dt + p["layers.ssm.dt_bias"][i])
    chunk = min(k["chunk"], s)
    pad = (-s) % chunk
    xs, bs, cs, ds = xh, bm.reshape(b, s, g, n), cm.reshape(b, s, g, n), dtv
    if pad:
        xs, bs, cs = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xs, bs, cs))
        ds = F.pad(ds, (0, 0, 0, pad))
    y = ssd(xs, ds, p["layers.ssm.A_log"][i], bs, cs, chunk)[:, :s]
    y = y + xh * p["layers.ssm.D"][i][None, None, :, None]
    y = y.reshape(b, s, di) * F.silu(z)
    y = _rms(y, p["layers.ssm.norm_scale"][i], k["eps"])
    return precision.matmul(y, p["layers.ssm.out_proj.w"][i], policy)


def _block(p, i, x, k, policy):
    h = _rms(x, p["layers.ssm_norm.scale"][i], k["eps"])
    return x + _mixer(p, i, h, k, policy)


def logits(p: Dict[str, torch.Tensor], tokens: torch.Tensor, m: dict,
           policy: str = "f32") -> torch.Tensor:
    """tokens [B, S] → logits [B, S, padded vocab] (float32)."""
    k = dims(m)
    table = p["embed_tied.table"]
    x = table[tokens]
    for i in range(k["L"]):
        if torch.is_grad_enabled():
            # recomputed in the backward: a layer's scan intermediates
            # are held one layer at a time
            x = checkpoint(_block, p, i, x, k, policy, use_reentrant=False)
        else:
            x = _block(p, i, x, k, policy)
    x = _rms(x, p["final_norm.scale"], k["eps"])
    z = precision.matmul(x, table.t(), policy)
    pad = torch.arange(k["vp"], device=z.device) >= k["v"]
    return z.masked_fill(pad, -1e30)


def loss(p, batch, m: dict, policy: str = "f32") -> torch.Tensor:
    """Token-mean cross entropy of ``batch = {"tokens", "labels"}``."""
    z = logits(p, batch["tokens"], m, policy)
    nll = torch.logsumexp(z, -1) - torch.gather(
        z, -1, batch["labels"][..., None].long())[..., 0]
    return nll.mean()


@torch.no_grad()
def gate_metric(p, val, m: dict, policy: str = "f32") -> float:
    """``1 / (1 + loss)`` of one node's params on its validation rows."""
    return float(1.0 / (1.0 + loss(p, val, m, policy)))


def forward_flops(m: dict, seq: int) -> int:
    """Forward operations of one sequence of ``seq`` tokens through a
    Mamba-2 LM: in_proj, the depthwise conv, the SSD scan by chunks (the
    operations of `swarmbench.work.ssd_bound`), out_proj in every layer,
    and the logits over the published vocabulary (the yardstick's formula,
    frozen)."""
    d = m["d_model"]
    di = m["ssm_expand"] * d
    h = di // m["ssm_head_dim"]
    g, n, p = m["ssm_groups"], m["ssm_state"], m["ssm_head_dim"]
    chunk = min(m["ssm_chunk"], seq)
    padded = -(-seq // chunk) * chunk
    conv = di + 2 * g * n
    per_token = (2 * d * (2 * di + 2 * g * n + h) + 2 * di * d
                 + 2 * m["conv_width"] * conv)
    pairs, chunks = chunk * (chunk + 1) // 2, padded // chunk
    ssd = (h * chunks * (pairs * 2 * p + 4 * chunk * n * p)
           + g * chunks * pairs * 2 * n)
    layers = m["n_layers"] * (per_token * seq + ssd)
    return layers + 2 * d * m["vocab_size"] * seq


def kernel_calls(m: dict, rows: int, seq: int) -> dict:
    """The program's hand-written kernels that one forward over ``rows``
    sequences of ``seq`` tokens calls: ``{"ssd": (the SSD scan's shape
    (b, s, h, p, n, chunk, g), calls)}``, one call a layer."""
    k = dims(m)
    chunk = min(k["chunk"], seq)
    padded = -(-seq // chunk) * chunk
    return {"ssd": ((rows, padded, k["h"], k["p"], k["n"], chunk, k["g"]),
                    k["L"])}
