"""Flash attention with GQA, a causal mask and a sliding window, in one
CUDA launch.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py`` ::
``flash_attention`` (body ``_flash_kernel``), which on the LM path computes
every prefill's attention (`repro_torch.models.attention`, the self-
attention form with query positions 0..S-1). A **query offset**
``q_off`` puts the query rows at positions q_off..q_off+S-1 over keys
0..T-1: a sequence-parallel rank's rows of a longer sequence under
tensor parallelism (`repro_torch.models.attention.attention_tp`); the
causal mask, the window and the skip of masked tiles read the offset
positions (the TPU kernel, whose queries start at 0, has no such
argument). The CUDA kernel
(``csrc/flash_attention.cu``) keeps the online softmax state in f32 and
skips every key tile the TPU kernel skips (wholly in the future of the q
tile, or wholly older than the window). Bound: the operations, about
4·H·D·S²/2 for a causal prefill (13.4 GFLOP at Hymba's S = 2048: 13.6 µs
at an H100 SXM's bf16 tensor-core rate of 989 TFLOP/s, 700 W), against
about 16 MB moved.

The bf16 form, the serving path's, runs Q·Kᵀ and P·V on the tensor cores
(``wgmma``, f32 accumulators): 192 query rows of one head per block in
three consumer warpgroups (128 in two at D = 128), 64-key K/V tiles in a
swizzled layout, streamed by a producer warp with ``cp.async`` into a
two-stage ring signalled on mbarriers. P is split into two bf16 terms
(P = P_hi + P_lo) so that P·V holds P to about 2⁻¹⁷, as the TPU kernel's
f32 P·V does; Q·Kᵀ is exact in f32 as it is. The f32 form runs on the
CUDA cores (f32 register micro-tiles), for the f32 sweeps and the f32
models. Both take the head dims of :data:`HEAD_DIMS`; on a CUDA tensor any
other raises. See the source for the design and the precision reckoning.

:func:`flash_attention` takes q ``[B, H, S, D]`` and k/v ``[B, Hkv, T, D]``
as views with any (batch, head, seq) strides and a contiguous D (for bf16,
16-byte-aligned rows and strides), so the module's ``[B, S, H, D]``
projections and a ``[B, T, Hkv, D]`` KV cache pass without a copy; its
output is a ``[B, H, S, D]`` view of a ``[B, S, H, D]`` buffer, so the
module's reshape back to ``[B, S, H·D]`` is free. On a CPU tensor it
computes the plain version (`repro_torch.kernels.ref.
flash_attention_plain`, the twin of the reference's ``attention_ref``); on
a CUDA tensor it launches the kernel or raises; on a ``meta`` tensor (a
dry run, `repro_torch.kernels.work`) it checks what the launch checks and
returns the output's shape, never the plain version's ``[B, H, S, T]``
scores, and counts the kernel's work. ``causal=False`` with
``window > 0`` raises on both: the TPU kernel and its oracle disagree there.

:func:`flash_apply` is the differentiable entry point the model calls
(through `repro_torch.kernels.ops.attention_op`): :class:`FlashAttention`,
a ``torch.autograd.Function`` whose forward is :func:`flash_attention` and
whose backward is plain PyTorch (the reference has no backward kernel): it
recomputes the f32 probabilities from the saved q, k and v under the plain
version's mask and forms dQ, dK and dV, dK and dV summed over each GQA
group. Its ``vmap`` rule folds the vmapped axis (the engine's node axis)
into the kernel's batch axis, so a vmapped train step runs one kernel call
per layer for all N nodes.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import LAUNCHES, build, work
from repro_torch.kernels.ref import check_q_off, flash_attention_plain

# every head dim of the reference's configs, smoke variants and test models
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    fn = build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_off: int = 0) -> torch.Tensor:
    """q [B, H, S, D], k/v [B, Hkv, T, D] (H % Hkv == 0) → [B, H, S, D] in
    q's dtype: softmax(q kᵀ/√D, masked) v with query positions
    q_off..q_off+S-1 and key positions 0..T-1. A nonzero ``q_off`` (a
    sequence-parallel rank's rows over the whole K/V) needs ``causal`` and
    ``q_off + S <= T``."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q [B,H,S,D] and k/v [B,Hkv,T,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "compose (batch, head dim, H % Hkv)")
    window = int(window)
    if not causal and window > 0:
        raise ValueError("flash_attention: a sliding window needs "
                         "causal=True")
    q_off = int(q_off)
    check_q_off(q_off, s, t, causal)
    if work.active():
        work.add("flash_attention", *work.flash_work(
            b, h, hkv, s, t, d, q.element_size(), causal, window, q_off))
    if q.device.type == "cpu":
        with work.plain():
            return flash_attention_plain(q, k, v, causal=causal,
                                         window=window, q_off=q_off)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype} not supported (float32 or "
                        "bfloat16)")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if torch._C._functorch.is_functorch_wrapped_tensor(x):
            raise TypeError(f"{name} is a torch.func-wrapped tensor; call "
                            "flash_apply, whose autograd.Function unwraps "
                            "it")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{name} must be a {q.dtype} tensor on "
                             f"{q.device}, got {x.dtype} on {x.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if q.dtype == torch.bfloat16:
        # the bf16 kernel copies 16-byte chunks (cp.async)
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.data_ptr() % 16 or any(x.stride(i) * 2 % 16
                                        for i in range(3)):
                raise ValueError(f"{name} must have 16-byte-aligned rows "
                                 "and strides in bfloat16")
    if b > 65535 or h > 65535 or max(s, t) >= 2 ** 31:
        raise ValueError(f"shape {tuple(q.shape)} / {tuple(k.shape)} outside "
                         "the kernel's range")
    buf = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    out = buf.transpose(1, 2)
    if q.device.type == "meta":      # a dry run: the shapes, no launch
        return out
    strides = [x.stride(i) for x in (q, k, v, out) for i in range(3)]
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, hkv, s, t, d, (ctypes.c_longlong * 12)(*strides),
                 int(bool(causal)), window, q_off, 1.0 / d ** 0.5,
                 _DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return out


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with a gradient and a ``vmap`` rule.

    Backward (plain PyTorch, f32), with P the recomputed probabilities
    and dO the output's cotangent, per (query, key) pair the mask keeps:

        dV = Pᵀ dO      dP = dO Vᵀ      dS = P ⊙ (dP − rowsum(dP ⊙ P))
        dQ = dS K / √D  dK = dSᵀ Q / √D

    dK and dV summed over the query heads of each KV head; each cast to
    its input's dtype. Vmap: the vmapped axis is folded into the batch
    axis and the kernel runs once over all of it."""

    @staticmethod
    def forward(q, k, v, causal, window, q_off):
        return flash_attention(q, k, v, causal=causal, window=window,
                               q_off=q_off)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, q_off = inputs
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window, ctx.q_off = bool(causal), int(window), q_off

    @staticmethod
    def backward(ctx, go):
        q, k, v = ctx.saved_tensors
        f32 = torch.float32
        b, h, s, d = q.shape
        hkv, t = k.shape[1], k.shape[2]
        qf = q.to(f32).reshape(b, hkv, h // hkv, s, d)
        kf, vf = k.to(f32), v.to(f32)
        scores = torch.einsum("bkgsd,bktd->bkgst", qf, kf) / math.sqrt(d)
        qpos = ctx.q_off + torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(t, device=q.device)[None, :]
        mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
        if ctx.causal:
            mask = kpos <= qpos
            if ctx.window > 0:
                mask = mask & (kpos > qpos - ctx.window)
        p = torch.softmax(torch.where(mask, scores, -1e30), dim=-1)
        gof = go.to(f32).reshape(b, hkv, h // hkv, s, d)
        dv = torch.einsum("bkgst,bkgsd->bktd", p, gof)
        dp = torch.einsum("bkgsd,bktd->bkgst", gof, vf)
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        dq = torch.einsum("bkgst,bktd->bkgsd", ds, kf) / math.sqrt(d)
        dk = torch.einsum("bkgst,bkgsd->bktd", ds, qf) / math.sqrt(d)
        return (dq.reshape(b, h, s, d).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None, None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, q_off):
        n = info.batch_size

        def fold(t, dim):
            t = (t.movedim(dim, 0) if dim is not None
                 else t.expand((n,) + tuple(t.shape)))
            return t.reshape((n * t.shape[1],) + tuple(t.shape[2:]))

        out = FlashAttention.apply(fold(q, in_dims[0]), fold(k, in_dims[1]),
                                   fold(v, in_dims[2]), causal, window, q_off)
        return out.reshape((n, -1) + tuple(out.shape[1:])), 0


def flash_apply(q, k, v, *, causal: bool = True, window: int = 0,
                q_off: int = 0):
    """Flash attention with a gradient (plain backward) and a vmap rule:
    the kernel for CUDA tensors, its plain version for CPU tensors. Same
    arguments and result as :func:`flash_attention`."""
    return FlashAttention.apply(q, k, v, causal, window, int(q_off))
