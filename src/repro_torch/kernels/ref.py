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
