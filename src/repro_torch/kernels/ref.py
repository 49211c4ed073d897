"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

``fused_merge_ref`` is the one-node oracle of ``repro.kernels.ref`` and
the plain form of the one-node commit
(`repro_torch.kernels.fused_merge.fused_merge`), summed in the CUDA
kernel's order; ``fused_merge_all_plain`` is the plain form of the all-nodes commit
(`repro_torch.kernels.fused_merge`), in the CUDA kernel's order: for each
output row, accumulate over j = 0..N-1 in f32, then select against the
input row. ``fused_quant_merge_all_plain`` is the plain form of the
quantized-wire commit: the error-feedback advance of `core.comms` (the
port's one quantization core), then the same merge. The CPU path of each
commit wrapper runs them; on the card they only serve as the yardstick the
kernels are held against.

``lora_matmul_ref`` is the torch twin of the reference's oracle
``repro.kernels.ref.lora_matmul_ref`` (f32 throughout, one cast at the
end); ``lora_matmul_plain`` is the plain form of the fused LoRA matmul
(`repro_torch.kernels.lora_matmul`), which also rounds ``x @ A`` to x's
dtype before the low-rank product, as the TPU kernel and the CUDA kernel
do. The two agree for f32 inputs.

``attention_ref`` and ``ssd_scan_ref`` are the torch twins of the
reference's oracles. ``flash_attention_plain`` is the plain form of the
flash kernel's function: ``attention_ref``, refusing ``causal=False`` with
a window (the TPU kernel and its oracle disagree there).
``ssd_scan_plain`` is the plain form of the chunked SSD kernel: the TPU
kernel's per-chunk schedule (decay-masked quadratic within a chunk, the
``[N, P]`` state carried across chunks) in f32, B/C read per group.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import comms


def fused_merge_ref(stacked, weights, self_idx, gate):
    """stacked [N, D]; weights [N]; gate scalar bool.
    out [D] = gate ? Σ_j w_j θ_j : θ_self   (fp32 accumulation).

    The twin of ``repro.kernels.ref``'s oracle, and the plain form of the
    one-node commit: the sum runs over j = 0..N-1 in order, one rounding
    per multiply and per add, as the CUDA kernel adds, so the two agree
    bit for bit; a rejected gate returns row ``self_idx`` itself."""
    w = torch.as_tensor(weights, device=stacked.device).to(torch.float32)
    acc = torch.zeros(stacked.shape[1], dtype=torch.float32,
                      device=stacked.device)
    for j in range(stacked.shape[0]):
        acc = acc + w[j] * stacked[j].to(torch.float32)
    g = torch.as_tensor(gate, device=stacked.device).to(torch.bool)
    return torch.where(g, acc.to(stacked.dtype), stacked[self_idx])


def fused_merge_all_plain(stacked, W, gates, imp=None):
    """stacked [N, D] → committed [N, D].

    ``out[i] = gate[i] ? Σ_j W[i,j]·θ_j : θ_i``; with ``imp [N, D]``
    ``out[i] = gate[i] ? Σ_j (W[i,j]·f_j)·θ_j / max(Σ_j W[i,j]·f_j, 1e-30)
    : θ_i``. Rejected rows are the input row, bit for bit.
    """
    n = stacked.shape[0]
    x = stacked.to(torch.float32)
    Wf = W.to(device=stacked.device, dtype=torch.float32)
    num = torch.zeros_like(x)
    den = None if imp is None else torch.zeros_like(x)
    for j in range(n):
        if imp is None:
            num = num + Wf[:, j, None] * x[j][None, :]
        else:
            wf = Wf[:, j, None] * imp[j].to(torch.float32)[None, :]
            num = num + wf * x[j][None, :]
            den = den + wf
    merged = num if imp is None else num / torch.clamp(den, min=1e-30)
    g = gates.to(device=stacked.device, dtype=torch.bool)[:, None]
    return torch.where(g, merged.to(stacked.dtype), stacked)


def fused_quant_merge_all_plain(x, r, W, gates, imp=None, *, grid):
    """x, r [N, D] f32 → (committed [N, D], new reference [N, D]).

    ``r' = comms.wire_effective(x, r, grid)`` (per-block int8 scales or a
    bf16 cast round-trip on ``grid``; ``r + (x − r)`` for f32), then
    ``committed[i] = gate[i] ? merge_i(r') : x[i]`` with the merge of
    :func:`fused_merge_all_plain` (W rows, or the importance ratio).
    Rejected rows are ``x``, bit for bit; the reference always advances.
    """
    rp = comms.wire_effective(x, r, grid)
    n = x.shape[0]
    merged = fused_merge_all_plain(
        rp, W, torch.ones(n, dtype=torch.bool, device=x.device), imp)
    g = gates.to(device=x.device, dtype=torch.bool)[:, None]
    return torch.where(g, merged, x), rp


def lora_matmul_ref(x, w, a, b, scale):
    """y = x @ W + scale · (x @ A) @ B, f32 accumulation, cast to x's dtype."""
    xf = x.to(torch.float32)
    y = xf @ w.to(torch.float32)
    y = y + torch.as_tensor(scale, dtype=torch.float32, device=x.device) * (
        (xf @ a.to(torch.float32)) @ b.to(torch.float32))
    return y.to(x.dtype)


def lora_matmul_plain(x, w, a, b, scale):
    """x [M, K], W [K, N], A [K, r], B [r, N] → y [M, N] in x's dtype:
    ``acc = x@W`` and ``xa = x@A`` in f32, xa rounded to x's dtype, then
    ``acc + scale · (xa @ B)`` in f32 and one cast."""
    xf = x.to(torch.float32)
    acc = xf @ w.to(torch.float32)
    xa = (xf @ a.to(torch.float32)).to(x.dtype).to(torch.float32)
    low = xa @ b.to(torch.float32)
    s = torch.as_tensor(scale, device=x.device).to(torch.float32)
    return (acc + s * low).to(x.dtype)


def attention_ref(q, k, v, *, causal=True, window=0, q_off=0):
    """q [B,H,S,D], k/v [B,Hkv,T,D] (GQA: H multiple of Hkv). Softmax in
    f32; masked scores are −1e30. Twin of ``repro.kernels.ref``'s, whose
    query positions are 0..S-1; ``q_off`` puts them at q_off..q_off+S-1
    (a sequence-parallel rank's rows of a longer sequence)."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, hkv, g, s, d)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(d)
    qpos = q_off + torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask = kpos <= qpos
        if window > 0:
            mask = mask & (kpos > qpos - window)
    scores = torch.where(mask, scores, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.to(torch.float32))
    return out.reshape(b, h, s, d).to(q.dtype)


def flash_attention_plain(q, k, v, *, causal=True, window=0, q_off=0):
    """The flash kernel's function: ``attention_ref``. ``causal=False``
    with ``window > 0`` raises: the TPU kernel skips tiles by window there
    while its oracle ignores the window, so the case has no single
    meaning. ``q_off`` (query positions q_off..q_off+S-1) needs the
    causal mask and ``q_off + S <= T``."""
    if not causal and window > 0:
        raise ValueError("flash_attention: a sliding window needs "
                         "causal=True")
    check_q_off(q_off, q.shape[2], k.shape[2], causal)
    return attention_ref(q, k, v, causal=causal, window=window, q_off=q_off)


def check_q_off(q_off: int, s: int, t: int, causal: bool) -> None:
    """Raise unless ``q_off`` (query positions q_off..q_off+S-1 against
    keys 0..T-1) is 0 or a causal call's offset with every row's own key
    present (``q_off + S <= T``)."""
    if q_off < 0 or (q_off and not causal) or (causal and q_off
                                                and q_off + s > t):
        raise ValueError(f"flash_attention: q_off={q_off} needs causal=True"
                         f" and q_off + S <= T (S={s}, T={t})")


def ssd_scan_ref(x, dt, a_log, bmat, cmat):
    """Exact sequential SSD recurrence (the slow oracle). x [B,S,H,P]; dt
    [B,S,H] (softplus'd); a_log [H]; bmat/cmat [B,S,H,N]. Returns y
    [B,S,H,P] in x's dtype and the final state [B,H,P,N] f32. Twin of
    ``repro.kernels.ref``'s."""
    bsz, s, h, p = x.shape
    n = bmat.shape[-1]
    f32 = torch.float32
    decay = torch.exp(dt * (-torch.exp(a_log.to(f32))))      # [B,S,H]
    xdt = x.to(f32) * dt[..., None]
    state = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
    ys = []
    for t in range(s):
        state = state * decay[:, t, :, None, None] + torch.einsum(
            "bhp,bhn->bhpn", xdt[:, t], bmat[:, t].to(f32))
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cmat[:, t].to(f32)))
    return torch.stack(ys, dim=1).to(x.dtype), state


def ssd_scan_plain(x, dt, a_log, bmat, cmat, *, chunk,
                   acc: torch.dtype = torch.float32):
    """The chunked SSD kernel's function. x [B,S,H,P]; dt [B,S,H] f32
    (softplus'd); a_log [H] or [B,H] (one per batch row); bmat/cmat
    [B,S,G,N] with H % G == 0 (G = H is the reference's pre-broadcast
    form); S a multiple of ``chunk``. Per
    chunk, in f32: ``cum = cumsum(dt·a)``, ``y = (C·Bᵀ ⊙ L)(x·dt) +
    (C ⊙ e^cum)·state``, ``state ← e^{cum_L}·state + (B ⊙
    e^{cum_L − cum})ᵀ(x·dt)``. Returns y in x's dtype and the final state
    [B,H,P,N] f32 (``acc`` = float64: the same function evaluated in f64,
    a yardstick for the f32 forms' rounding)."""
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    f32 = acc
    bm = bmat.to(f32).repeat_interleave(h // g, dim=2)
    cm = cmat.to(f32).repeat_interleave(h // g, dim=2)
    a = -torch.exp(a_log.to(f32)).reshape(-1, 1, h)         # [B or 1,1,H]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    state = torch.zeros((b, h, n, p), dtype=f32, device=x.device)
    ys = []
    for t0 in range(0, s, chunk):
        sl = slice(t0, t0 + chunk)
        dtc = dt[:, sl].to(f32)                                 # [B,L,H]
        cum = torch.cumsum(dtc * a, dim=1)                      # [B,L,H]
        xdt = x[:, sl].to(f32) * dtc[..., None]                 # [B,L,H,P]
        diff = cum[:, :, None, :] - cum[:, None, :, :]          # [B,L,L,H]
        lmat = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)),
                           0.0)
        scores = torch.einsum("bihn,bjhn->bijh", cm[:, sl], bm[:, sl]) * lmat
        y = torch.einsum("bijh,bjhp->bihp", scores, xdt)
        y = y + torch.einsum("bihn,bhnp->bihp",
                             cm[:, sl] * torch.exp(cum)[..., None], state)
        decay_to_end = torch.exp(cum[:, -1:] - cum)             # [B,L,H]
        state = (torch.exp(cum[:, -1])[..., None, None] * state
                 + torch.einsum("bjhn,bjhp->bhnp",
                                bm[:, sl] * decay_to_end[..., None], xdt))
        ys.append(y)
    y = torch.cat(ys, dim=1).to(x.dtype)
    return y, state.transpose(-1, -2).contiguous()
