"""Mamba-2 chunked SSD scan in three CUDA launches.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py`` :: ``ssd_scan``
(body ``_ssd_kernel``), which on the LM path runs every prefill of the ssm
and hybrid families (`repro_torch.models.ssm`, the chunked form). The CUDA
kernels (``csrc/ssd_scan.cu``) are parallel over chunks, heads and strips
of 32 query rows: each chunk's own end state from zero, then a walk over
the chunks in order that turns those into the state each chunk starts
from (the plain recurrence's order), then every strip's y (the incoming
state's part and the causal tiles up to the diagonal). C·Bᵀ runs on the
tensor cores in the bf16 form (``mma.sync`` with f32 accumulators: exact
products); every product with an f32 operand stays on the f32 CUDA cores.
Bound: the operations. For one Hymba layer at S = 2048, 2.10 GFLOP with
an f32 operand (the causal pairs' weighted x and the carried state), 31 µs
at an H100 SXM's f32 rate of 67 TFLOP/s, 700 W, plus C·Bᵀ once per group
(8.4 MFLOP of bf16 operands, under 0.01 µs at the tensor-core rate),
against about 27 MB moved. See the source for the design and the
precision reckoning.

:func:`ssd_scan` takes x ``[B, S, H, P]``, dt ``[B, S, H]`` f32 (softplus'd),
a_log ``[H]`` (every batch row) or ``[B, H]`` (one per row: a swarm's N
nodes folded into the batch, each with its own ``A_log``; the kernel reads
row b's heads at ``b · stride``, stride 0 for ``[H]``) and B/C
``[B, S, G, N]`` with ``H % G == 0`` (G = H is the reference's pre-broadcast
form; the kernel reads head h's group h / (H/G), so no broadcast copy is
made). x, B and C may be views with any (batch, seq) strides and contiguous
(head, feature) dims — the module's split of the conv output passes without
a copy. Returns y ``[B, S, H, P]`` in x's dtype and the final state
``[B, H, P, N]`` f32. S must be a multiple of ``chunk`` (the caller pads, as
the reference's model does). On a CPU tensor it computes the plain version
(`repro_torch.kernels.ref.ssd_scan_plain`); on a CUDA tensor it launches
the kernels or raises; on a ``meta`` tensor (a dry run,
`repro_torch.kernels.work`) it checks what the launch checks, allocates
the outputs and the scratch, and counts the kernels' work. The chunk
states live in an f32 scratch of
``B·H·(S/chunk)·N·P`` values that the wrapper allocates per call (1.6 MB at
Hymba's 2048-token prefill); under a captured CUDA graph it is the graph
pool's memory, which no host reference holds across replays.

:func:`ssd_apply` is the differentiable entry point the model calls
(through `repro_torch.kernels.ops.ssd_op`): :class:`SsdScan`, a
``torch.autograd.Function`` whose forward is :func:`ssd_scan` and whose
backward is plain PyTorch — the vector-Jacobian product of
``ssd_scan_plain``'s chunked form on recomputation (the reference has no
backward kernel), for y and the final state both. Its ``vmap`` rule folds
the vmapped axis (the engine's node axis) into the batch axis, with
``a_log`` per batch row, so a vmapped train step runs one kernel call per
layer for all N nodes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, build, work
from repro_torch.kernels.ref import ssd_scan_plain

MAX_HEAD_DIM, MAX_STATE, MAX_CHUNK = 128, 256, 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    fn = build.load("ssd_scan").ssd_scan_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, *, chunk: int = 256):
    """x [B,S,H,P]; dt [B,S,H] f32; a_log [H] or [B,H]; bmat/cmat
    [B,S,G,N] → (y [B,S,H,P] in x's dtype, final state [B,H,P,N] f32)."""
    if x.dim() != 4 or dt.dim() != 3 or bmat.dim() != 4 \
            or cmat.shape != bmat.shape:
        raise ValueError(f"need x [B,S,H,P], dt [B,S,H], B/C [B,S,G,N]; got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(bmat.shape)}, {tuple(cmat.shape)}")
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if (tuple(dt.shape) != (b, s, h) or tuple(bmat.shape[:2]) != (b, s)
            or tuple(a_log.shape) not in ((h,), (b, h)) or h % g):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, a_log "
                         f"{tuple(a_log.shape)} and B/C {tuple(bmat.shape)} "
                         "do not compose (H % G == 0)")
    chunk = min(int(chunk), s)
    if s % chunk:
        raise ValueError(f"seq {s} must divide chunk {chunk}")
    if work.active():
        work.add("ssd_scan", *work.ssd_work(b, s, h, p, g, n, chunk,
                                            x.element_size(),
                                            a_log.numel()))
    if x.device.type == "cpu":
        with work.plain():
            return ssd_scan_plain(x, dt, a_log, bmat, cmat, chunk=chunk)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {x.device}")
    dev = x.device
    if x.dtype not in _DTYPES:
        raise TypeError(f"dtype {x.dtype} not supported (float32 or "
                        "bfloat16)")
    for name, t in (("x", x), ("dt", dt), ("a_log", a_log), ("B", bmat),
                    ("C", cmat)):
        if torch._C._functorch.is_functorch_wrapped_tensor(t):
            raise TypeError(f"{name} is a torch.func-wrapped tensor; call "
                            "ssd_apply, whose autograd.Function unwraps it")
    for name, t in (("B", bmat), ("C", cmat)):
        if t.device != dev or t.dtype != x.dtype:
            raise ValueError(f"{name} must be a {x.dtype} tensor on {dev}")
    for name, t in (("dt", dt), ("a_log", a_log)):
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 tensor "
                             f"on {dev}")
    for name, t, inner in (("x", x, p), ("B", bmat, n), ("C", cmat, n)):
        if t.stride(3) != 1 or t.stride(2) != inner:
            raise ValueError(f"{name}'s last two dims must be contiguous")
    if p > MAX_HEAD_DIM or n > MAX_STATE or chunk > MAX_CHUNK \
            or b * h > 65535:
        raise ValueError(f"P={p}, N={n}, chunk={chunk}, B·H={b * h} outside "
                         f"the kernel's range (P <= {MAX_HEAD_DIM}, "
                         f"N <= {MAX_STATE}, chunk <= {MAX_CHUNK}, "
                         "B·H <= 65535)")
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    chunk_state = torch.empty((b, h, s // chunk, n, p), dtype=torch.float32,
                              device=dev)
    chunk_decay = torch.empty((b, h, s // chunk), dtype=torch.float32,
                              device=dev)
    if dev.type == "meta":   # a dry run: the outputs and scratch, no launch
        return y, state
    strides = [x.stride(0), x.stride(1), bmat.stride(0), bmat.stride(1),
               cmat.stride(0), cmat.stride(1)]
    err = _lib()(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
                 bmat.data_ptr(), cmat.data_ptr(), y.data_ptr(),
                 state.data_ptr(), chunk_state.data_ptr(),
                 chunk_decay.data_ptr(), b, s, h, p, g, n, chunk,
                 (ctypes.c_longlong * 6)(*strides),
                 h if a_log.dim() == 2 else 0, _DTYPES[x.dtype],
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    LAUNCHES["ssd_scan"] += 1
    return y, state


class SsdScan(torch.autograd.Function):
    """:func:`ssd_scan` with a gradient and a ``vmap`` rule.

    Backward: the vector-Jacobian product of ``ssd_scan_plain`` (the chunked
    form, f32) recomputed from the saved inputs, for the cotangents of y
    and of the final state. Vmap: the vmapped axis is folded into the batch
    axis (``a_log`` becomes one row per folded batch row) and the kernel
    runs once over all of it."""

    @staticmethod
    def forward(x, dt, a_log, bmat, cmat, chunk):
        return ssd_scan(x, dt, a_log, bmat, cmat, chunk=chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dt, a_log, bmat, cmat, chunk = inputs
        ctx.save_for_backward(x, dt, a_log, bmat, cmat)
        ctx.chunk = min(int(chunk), x.shape[1])

    @staticmethod
    def backward(ctx, gy, gstate):
        plain = functools.partial(ssd_scan_plain, chunk=ctx.chunk)
        _, vjp = torch.func.vjp(plain, *ctx.saved_tensors)
        return vjp((gy, gstate)) + (None,)

    @staticmethod
    def vmap(info, in_dims, x, dt, a_log, bmat, cmat, chunk):
        n = info.batch_size

        def lead(t, dim):
            return (t.movedim(dim, 0) if dim is not None
                    else t.expand((n,) + tuple(t.shape)))

        x, dt, a_log, bmat, cmat = (lead(t, d) for t, d in zip(
            (x, dt, a_log, bmat, cmat), in_dims[:5]))
        b = x.shape[1]
        if a_log.dim() == 2:                    # [n, H]: one per node
            a_log = a_log[:, None].expand(n, b, a_log.shape[-1])

        def fold(t):
            return t.reshape((n * b,) + tuple(t.shape[2:]))

        y, state = SsdScan.apply(fold(x), fold(dt).contiguous(),
                                 fold(a_log).contiguous(), fold(bmat),
                                 fold(cmat), chunk)
        return ((y.reshape((n, b) + tuple(y.shape[1:])),
                 state.reshape((n, b) + tuple(state.shape[1:]))), (0, 0))


def ssd_apply(x, dt, a_log, bmat, cmat, *, chunk: int = 256):
    """The SSD scan with a gradient (plain backward) and a vmap rule: the
    kernel for CUDA tensors, its plain version for CPU tensors. Same
    arguments and results as :func:`ssd_scan`."""
    return SsdScan.apply(x, dt, a_log, bmat, cmat, chunk)
