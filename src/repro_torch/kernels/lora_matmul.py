"""Fused base + LoRA matmul: ``y = x @ W + scale · (x @ A) @ B`` in one launch.

Replaces the Pallas TPU kernel ``repro/kernels/lora_matmul.py`` ::
``lora_matmul`` (body ``_lora_kernel``), which runs every forward of the
heterogeneous model zoo's shared head (`repro_torch.models.zoo`). The CUDA
kernel (``csrc/lora_matmul.cu``) keeps ``x @ A`` on chip, accumulates both
products in f32 and writes the output tile once in x's dtype; like the TPU
kernel it rounds ``x @ A`` to x's dtype before the low-rank product. Bound:
the f32 operations at large shapes (the reference's sweep shape
(M, K, N, r) = (128, 1024, 256, 64): 88.1 MFLOP against 2.03 MB); at the
zoo head's shapes the launch latency is the whole time. See the source for
the design.

:func:`lora_matmul` is the forward: on a CPU tensor it computes the plain
version (`repro_torch.kernels.ref.lora_matmul_plain`), on a CUDA tensor it
launches the kernel or raises. :func:`lora_apply` is the differentiable
entry point: a :class:`torch.autograd.Function` whose forward is
:func:`lora_matmul` and whose backward is plain PyTorch, the products JAX
differentiates in the reference's unfused form (the reference has no
backward kernel). The Function has the ``forward`` + ``setup_context``
form, so ``torch.func.grad_and_value`` takes gradients through it; it has
no ``vmap`` rule (the zoo loops over its nodes).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.ref import lora_matmul_plain

MAX_RANK = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1


def _lib():
    fn = build.load("lora_matmul").lora_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _shapes(x, w, a, b):
    if not all(t.dim() == 2 for t in (x, w, a, b)):
        raise ValueError("x, W, A and B must be 2-D, got "
                         f"{[tuple(t.shape) for t in (x, w, a, b)]}")
    m, k = x.shape
    n = w.shape[1]
    r = a.shape[1]
    if w.shape[0] != k or a.shape[0] != k or tuple(b.shape) != (r, n):
        raise ValueError(f"shapes x {tuple(x.shape)}, W {tuple(w.shape)}, "
                         f"A {tuple(a.shape)}, B {tuple(b.shape)} do not "
                         "compose as x[M,K] W[K,N] A[K,r] B[r,N]")
    return m, k, n, r


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, scale) -> torch.Tensor:
    """x [M, K], W [K, N], A [K, r], B [r, N] (one dtype: f32 or bf16),
    ``scale`` a 0-d tensor (or a number) → y [M, N] in x's dtype.

    A CUDA call reads ``scale`` on the device through a pointer (it is a
    trained payload leaf; a host read would synchronize every step)."""
    m, k, n, r = _shapes(x, w, a, b)
    if x.device.type == "cpu":
        return lora_matmul_plain(x, w, a, b, scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    dev = x.device
    if x.dtype not in _DTYPES:
        raise TypeError(f"dtype {x.dtype} not supported (float32 or "
                        "bfloat16)")
    for name, t in (("x", x), ("W", w), ("A", a), ("B", b)):
        if t.device != dev or t.dtype != x.dtype:
            raise ValueError(f"{name} must be a {x.dtype} tensor on {dev}, "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if torch._C._functorch.is_functorch_wrapped_tensor(t):
            raise TypeError(f"{name} is a torch.func-wrapped tensor; call "
                            "lora_apply, whose autograd.Function unwraps it")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank r={r} outside 1..{MAX_RANK}")
    if min(m, k, n) < 1 or max(m, k, n) > _INT_MAX or -(-m // 32) > 65535:
        raise ValueError(f"shape M={m}, K={k}, N={n} outside the kernel's "
                         "range")
    s = torch.as_tensor(scale, device=dev).to(torch.float32).reshape(())
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    err = _lib()(x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
                 s.data_ptr(), y.data_ptr(), m, k, n, r, _DTYPES[x.dtype],
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lora_matmul launch failed: CUDA error {err}")
    LAUNCHES["lora_matmul"] += 1
    return y


class LoraMatmul(torch.autograd.Function):
    """``lora_matmul`` with a gradient. Backward (plain PyTorch, f32):

        dX = dY Wᵀ + s·(dY Bᵀ) Aᵀ      dW = Xᵀ dY
        dA = s·Xᵀ (dY Bᵀ)              dB = s·(X A)ᵀ dY
        ds = Σ dY ⊙ (X A) B

    each cast to its input's dtype and computed only when asked for."""

    @staticmethod
    def forward(x, w, a, b, scale):
        return lora_matmul(x, w, a, b, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, gy):
        x, w, a, b, scale = ctx.saved_tensors
        need = ctx.needs_input_grad
        f32 = torch.float32
        g = gy.to(f32)
        xf, wf, af, bf = (t.to(f32) for t in (x, w, a, b))
        s = scale.to(f32)
        gb = g @ bf.T                                  # dY Bᵀ [M, r]
        xa = xf @ af if (need[3] or need[4]) else None
        dx = dw = da = db = ds = None
        if need[0]:
            dx = (g @ wf.T + s * (gb @ af.T)).to(x.dtype)
        if need[1]:
            dw = (xf.T @ g).to(w.dtype)
        if need[2]:
            da = (s * (xf.T @ gb)).to(a.dtype)
        if need[3]:
            db = (s * (xa.T @ g)).to(b.dtype)
        if need[4]:
            ds = (g * (xa @ bf)).sum().reshape(scale.shape).to(scale.dtype)
        return dx, dw, da, db, ds


def lora_apply(x, w, a, b, scale) -> torch.Tensor:
    """LoRA'd linear ``x @ W + scale·(x @ A) @ B`` with a gradient: the
    fused CUDA kernel for CUDA tensors, its plain version for CPU tensors.
    ``scale`` may be a number or a tensor (a trained leaf)."""
    if not isinstance(scale, torch.Tensor):
        scale = torch.tensor(float(scale), dtype=torch.float32,
                             device=x.device)
    return LoraMatmul.apply(x, w, a, b, scale)
