"""Fused gated swarm commits: ``[N, P]`` → ``[N, P]`` in one CUDA launch.

Replaces the Pallas TPU kernel ``repro/kernels/fused_merge.py`` ::
``fused_merge_all`` (bodies ``_merge_all_kernel`` and
``_merge_all_imp_kernel``), which the reference's engine maps leaf by leaf
over the stacked pytree (71 launches for the paper CNN). The port's state is
one flat ``[N, P]`` buffer, so the whole commit is one launch:

    out[i] = gate[i] ? Σ_j W[i,j]·θ_j : θ_i                       (imp=None)
    out[i] = gate[i] ? Σ_j (W[i,j]·f_j)·θ_j / max(Σ_j W[i,j]·f_j, 1e-30) : θ_i

Bound: memory — 2·N·P·4 bytes (3·N·P·4 with ``imp``) for f32, against at most
2·N·N flops per column. The kernel (``csrc/fused_merge.cu``) reads each
column's N inputs once into registers, produces all N output rows from them,
and stages W and the gates in shared memory; see the source for the design.

Its quantized-wire sibling :func:`fused_quant_merge_all` replaces
``fused_quant_merge_all`` (bodies ``_quant_merge_kernel`` and
``_quant_merge_imp_kernel``): the error-feedback wire advance
``r' = r + deq(q(x − r))`` on the per-leaf block grid of
:class:`repro_torch.core.comms.WireGrid`, then the same gated merge of r',
in one launch of ``csrc/fused_quant_merge.cu``. Bound: memory — x and r
(and imp) read once, committed and r' written once: 4·N·P·4 bytes
(5·N·P·4 with ``imp``).

:func:`fused_merge` is the one-node commit (the reference's
``fused_merge``, body ``_merge_kernel``, reached through
`repro_torch.kernels.ops.merge_op`): ``out = gate ? Σ_j w_j·θ_j : θ_self``,
``[N, D] → [D]``, a third form in ``csrc/fused_merge.cu``. Bound: memory,
(N + 1)·D·4 bytes for f32.

On a CPU tensor each wrapper computes its plain version
(`repro_torch.kernels.ref`); on a CUDA tensor it launches the kernel or
raises. ``LAUNCHES`` (shared by every kernel of the port) counts
kernel launches per form.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, build, reset_launches  # noqa: F401
from repro_torch.kernels.ref import (fused_merge_all_plain,
                                     fused_merge_ref,
                                     fused_quant_merge_all_plain)

MAX_NODES = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_WIRES = {"f32": 0, "bf16": 1, "int8": 2}


def _lib():
    lib = build.load("fused_merge")
    fn = lib.fused_merge_all_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _one_lib():
    fn = build.load("fused_merge").fused_merge_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int,
                                               ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _quant_lib():
    lib = build.load("fused_quant_merge")
    fn = lib.fused_quant_merge_all_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_merge_all(stacked: torch.Tensor, W, gates, imp=None) -> torch.Tensor:
    """stacked [N, D] (f32 or bf16) → committed [N, D] in the same dtype.

    ``W`` [N, N] mixing rows (taken as f32), ``gates`` [N] acceptance bits,
    ``imp`` optional [N, D] f32 importance (fisher / gradmatch / topology-
    restricted commits). Rejected rows are the input rows, bit for bit.
    """
    if stacked.dim() != 2:
        raise ValueError(f"stacked must be [N, D], got {tuple(stacked.shape)}")
    n, d = stacked.shape
    if stacked.device.type == "cpu":
        return fused_merge_all_plain(stacked, torch.as_tensor(W), gates, imp)
    if stacked.device.type != "cuda":
        raise ValueError(f"unsupported device {stacked.device}")
    if stacked.dtype not in _DTYPES:
        raise TypeError(f"stacked dtype {stacked.dtype} not supported "
                        "(float32 or bfloat16)")
    if not stacked.is_contiguous():
        raise ValueError("stacked must be contiguous")
    if not 1 <= n <= MAX_NODES or d < 1:
        raise ValueError(f"need 1 <= N <= {MAX_NODES} and D >= 1, got "
                         f"N={n}, D={d}")
    dev = stacked.device
    Wd = torch.as_tensor(W, dtype=torch.float32, device=dev).contiguous()
    gd = torch.as_tensor(gates, device=dev).to(torch.int32).contiguous()
    if Wd.shape != (n, n) or gd.shape != (n,):
        raise ValueError(f"W must be [{n}, {n}] and gates [{n}], got "
                         f"{tuple(Wd.shape)} and {tuple(gd.shape)}")
    if imp is not None:
        if (imp.device != dev or imp.dtype != torch.float32
                or imp.shape != stacked.shape or not imp.is_contiguous()):
            raise ValueError("imp must be a contiguous float32 tensor shaped "
                             "like stacked, on the same device")
    out = torch.empty_like(stacked)
    err = _lib()(stacked.data_ptr(),
                 None if imp is None else imp.data_ptr(),
                 Wd.data_ptr(), gd.data_ptr(), out.data_ptr(), n, d,
                 _DTYPES[stacked.dtype],
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_merge_all launch failed: CUDA error {err}")
    LAUNCHES["fused_merge_all" if imp is None else "fused_merge_all_imp"] += 1
    return out


def fused_merge(stacked: torch.Tensor, weights, self_idx, gate
                ) -> torch.Tensor:
    """One node's commit: stacked [N, D] (f32 or bf16) → [D] in the same
    dtype, ``gate ? Σ_j weights[j]·θ_j : θ_self``. ``weights`` [N] (taken
    as f32); ``self_idx`` and ``gate`` are ints/bools or 0-d tensors, read
    on the device by the kernel. A rejected gate returns row ``self_idx``
    bit for bit."""
    if stacked.dim() != 2:
        raise ValueError(f"stacked must be [N, D], got {tuple(stacked.shape)}")
    n, d = stacked.shape
    if stacked.device.type == "cpu":
        return fused_merge_ref(stacked, weights, self_idx, gate)
    if stacked.device.type != "cuda":
        raise ValueError(f"unsupported device {stacked.device}")
    if stacked.dtype not in _DTYPES:
        raise TypeError(f"stacked dtype {stacked.dtype} not supported "
                        "(float32 or bfloat16)")
    if not stacked.is_contiguous():
        raise ValueError("stacked must be contiguous")
    if not 1 <= n <= MAX_NODES or d < 1:
        raise ValueError(f"need 1 <= N <= {MAX_NODES} and D >= 1, got "
                         f"N={n}, D={d}")
    dev = stacked.device
    wd = torch.as_tensor(weights, dtype=torch.float32, device=dev).contiguous()
    if wd.shape != (n,):
        raise ValueError(f"weights must be [{n}], got {tuple(wd.shape)}")
    if isinstance(self_idx, int) and not 0 <= self_idx < n:
        raise ValueError(f"self_idx {self_idx} outside 0..{n - 1}")
    gs = torch.stack([torch.as_tensor(gate, device=dev).reshape(()).to(
                          torch.int32),
                      torch.as_tensor(self_idx, device=dev).reshape(()).to(
                          torch.int32)])
    out = torch.empty(d, dtype=stacked.dtype, device=dev)
    err = _one_lib()(stacked.data_ptr(), wd.data_ptr(), gs.data_ptr(),
                     out.data_ptr(), n, d, _DTYPES[stacked.dtype],
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_merge launch failed: CUDA error {err}")
    LAUNCHES["fused_merge"] += 1
    return out


def _check_f32(name, t, shape, dev):
    if (t.device != dev or t.dtype != torch.float32 or t.shape != shape
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 tensor of "
                         f"shape {tuple(shape)} on {dev}")


def fused_quant_merge_all(x: torch.Tensor, r: torch.Tensor, W, gates,
                          imp=None, *, grid):
    """Quantized-wire commit: x [N, D] local params and r [N, D] wire
    reference θ̂ (both f32) → ``(committed [N, D], new reference [N, D])``.

    ``grid`` is the :class:`~repro_torch.core.comms.WireGrid` of the
    payload (its wire dtype, block size and segment table, on x's device).
    ``W`` [N, N] mixing rows, ``gates`` [N] acceptance bits, ``imp``
    optional [N, D] f32 importance. Rejected rows are x, bit for bit; the
    reference advances for every row.
    """
    if x.dim() != 2:
        raise ValueError(f"x must be [N, D], got {tuple(x.shape)}")
    n, d = x.shape
    if grid.size != d:
        raise ValueError(f"grid covers {grid.size} values, x has {d}")
    if x.device.type == "cpu":
        return fused_quant_merge_all_plain(x, r, torch.as_tensor(W), gates,
                                           imp, grid=grid)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    dev = x.device
    if not 1 <= n <= MAX_NODES or d < 1:
        raise ValueError(f"need 1 <= N <= {MAX_NODES} and D >= 1, got "
                         f"N={n}, D={d}")
    _check_f32("x", x, x.shape, dev)
    _check_f32("r", r, x.shape, dev)
    if imp is not None:
        _check_f32("imp", imp, x.shape, dev)
    Wd = torch.as_tensor(W, dtype=torch.float32, device=dev).contiguous()
    gd = torch.as_tensor(gates, device=dev).to(torch.int32).contiguous()
    if Wd.shape != (n, n) or gd.shape != (n,):
        raise ValueError(f"W must be [{n}, {n}] and gates [{n}], got "
                         f"{tuple(Wd.shape)} and {tuple(gd.shape)}")
    segs, perm = grid.segments, grid.perm
    for name, t in (("grid.segments", segs), ("grid.perm", perm)):
        if t is not None and (t.device != dev or t.dtype != torch.int64
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int64 tensor "
                             f"on {dev}")
    if segs.dim() != 2 or segs.shape[1] != 2 or (perm is not None
                                                 and perm.shape != (d,)):
        raise ValueError("grid.segments must be [S, 2] and grid.perm [D]")
    out = torch.empty_like(x)
    new_ref = torch.empty_like(x)
    err = _quant_lib()(
        x.data_ptr(), r.data_ptr(), None if imp is None else imp.data_ptr(),
        Wd.data_ptr(), gd.data_ptr(), segs.data_ptr(),
        None if perm is None else perm.data_ptr(), out.data_ptr(),
        new_ref.data_ptr(), segs.shape[0], n, d, _WIRES[grid.wire_dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_quant_merge_all launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["fused_quant_merge_all" if imp is None
             else "fused_quant_merge_all_imp"] += 1
    return out, new_ref
