"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

``fused_merge_ref`` is the one-node oracle of ``repro.kernels.ref``;
``fused_merge_all_plain`` is the plain form of the all-nodes commit
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
"""
from __future__ import annotations

import torch

from repro_torch.core import comms


def fused_merge_ref(stacked, weights, self_idx, gate):
    """stacked [N, D]; weights [N]; gate scalar bool.
    out [D] = gate ? Σ_j w_j θ_j : θ_self   (fp32 accumulation)."""
    merged = torch.einsum("n,nd->d", weights.to(torch.float32),
                          stacked.to(torch.float32))
    keep = stacked[self_idx].to(torch.float32)
    return torch.where(torch.as_tensor(gate, device=stacked.device),
                       merged, keep).to(stacked.dtype)


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
