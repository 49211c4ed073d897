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
a_log ``[H]`` and B/C ``[B, S, G, N]`` with ``H % G == 0`` (G = H is the
reference's pre-broadcast form; the kernel reads head h's group
h / (H/G), so no broadcast copy is made). x, B and C may be views with any
(batch, seq) strides and contiguous (head, feature) dims — the module's
split of the conv output passes without a copy. Returns y ``[B, S, H, P]``
in x's dtype and the final state ``[B, H, P, N]`` f32. S must be a
multiple of ``chunk`` (the caller pads, as the reference's model does). On
a CPU tensor it computes the plain version (`repro_torch.kernels.ref.
ssd_scan_plain`); on a CUDA tensor it launches the kernels or raises. The
chunk states live in an f32 scratch of ``B·H·(S/chunk)·N·P`` values that
the wrapper allocates per call (1.6 MB at Hymba's 2048-token prefill);
under a captured CUDA graph it is the graph pool's memory, which no host
reference holds across replays.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.ref import ssd_scan_plain

MAX_HEAD_DIM, MAX_STATE, MAX_CHUNK = 128, 256, 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    fn = build.load("ssd_scan").ssd_scan_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, *, chunk: int = 256):
    """x [B,S,H,P]; dt [B,S,H] f32; a_log [H]; bmat/cmat [B,S,G,N] →
    (y [B,S,H,P] in x's dtype, final state [B,H,P,N] f32)."""
    if x.dim() != 4 or dt.dim() != 3 or bmat.dim() != 4 \
            or cmat.shape != bmat.shape:
        raise ValueError(f"need x [B,S,H,P], dt [B,S,H], B/C [B,S,G,N]; got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(bmat.shape)}, {tuple(cmat.shape)}")
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if (tuple(dt.shape) != (b, s, h) or tuple(bmat.shape[:2]) != (b, s)
            or tuple(a_log.shape) != (h,) or h % g):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, a_log "
                         f"{tuple(a_log.shape)} and B/C {tuple(bmat.shape)} "
                         "do not compose (H % G == 0)")
    chunk = min(int(chunk), s)
    if s % chunk:
        raise ValueError(f"seq {s} must divide chunk {chunk}")
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a_log, bmat, cmat, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    dev = x.device
    if x.dtype not in _DTYPES:
        raise TypeError(f"dtype {x.dtype} not supported (float32 or "
                        "bfloat16)")
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
    strides = [x.stride(0), x.stride(1), bmat.stride(0), bmat.stride(1),
               cmat.stride(0), cmat.stride(1)]
    err = _lib()(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
                 bmat.data_ptr(), cmat.data_ptr(), y.data_ptr(),
                 state.data_ptr(), chunk_state.data_ptr(),
                 chunk_decay.data_ptr(), b, s, h, p, g, n, chunk,
                 (ctypes.c_longlong * 6)(*strides), _DTYPES[x.dtype],
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    LAUNCHES["ssd_scan"] += 1
    return y, state
