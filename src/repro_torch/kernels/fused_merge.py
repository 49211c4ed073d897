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
in ``csrc/fused_quant_merge.cu``: on the int8 wire a maxima pass over the
grid's tile table and a commit pass in storage order (one block per
segment for both when every segment is contiguous), on bf16/f32 the
commit pass alone. Bound: memory — x and r (and imp) read once, committed
and r' written once: 4·N·P·4 bytes (5·N·P·4 with ``imp``).

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
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _quant_lib():
    lib = build.load("fused_quant_merge")
    fn = lib.fused_quant_merge_all_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 14 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong] + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def quant_launch_shape(grid, n: int) -> dict:
    """How ``fused_quant_merge_all`` launches on ``grid`` for N = ``n``: the
    tiles, and the thread blocks and dynamic shared memory (bytes) of the
    int8 maxima pass (one block per piece of a tile) and of the commit pass
    (a block per 256 columns; on an int8 grid of contiguous segments, one
    block per segment for both passes)."""
    base = (n * n + n) * 4
    if grid.wire_dtype != "int8":
        return dict(max_blocks=0, commit_blocks=-(-grid.size // 256),
                    max_smem_bytes=0, commit_smem_bytes=0)
    if grid.perm is None:
        return dict(max_blocks=0, commit_blocks=int(grid.segments.shape[0]),
                    max_smem_bytes=0, commit_smem_bytes=base + 9 * n * 4)
    return dict(tiles=len(torch.unique(grid.pieces[:, 2])),
                max_blocks=int(grid.pieces.shape[0]),
                commit_blocks=-(-grid.size // 256),
                max_smem_bytes=grid.max_segs * n * 4, commit_smem_bytes=0)


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
    as f32); ``self_idx`` and ``gate`` are ints/bools, passed to the kernel
    by value, or 0-d tensors, read on the device by the kernel (no host
    synchronization). A rejected gate returns row ``self_idx`` bit for
    bit."""
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
    on_host = not (isinstance(gate, torch.Tensor)
                   or isinstance(self_idx, torch.Tensor))
    if on_host:
        # Python values go to the kernel by value: no copy to the card
        gate_v, self_v, gs = int(bool(gate)), int(self_idx), None
        if not 0 <= self_v < n:
            raise ValueError(f"self_idx {self_v} outside 0..{n - 1}")
    else:
        gate_v = self_v = 0
        gs = torch.stack([torch.as_tensor(gate, device=dev).reshape(()).to(
                              torch.int32),
                          torch.as_tensor(self_idx, device=dev).reshape(()).to(
                              torch.int32)])
    out = torch.empty(d, dtype=stacked.dtype, device=dev)
    err = _one_lib()(stacked.data_ptr(), wd.data_ptr(),
                     None if gs is None else gs.data_ptr(), gate_v, self_v,
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
    payload (its wire dtype, block size, segment and tile tables, on x's
    device).
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
    int8 = grid.wire_dtype == "int8"
    tables = (("segments", torch.int64), ("pieces", torch.int64),
              ("chunks", torch.int64), ("tile_segs", torch.int32),
              ("lseg", torch.uint8), ("seg32", torch.int32))
    for name, want in tables[:None if int8 else 1]:
        t = getattr(grid, name)
        if t is None or t.device != dev or t.dtype != want \
                or not t.is_contiguous():
            raise ValueError(f"grid.{name} must be a contiguous {want} "
                             f"tensor on {dev}")
    nseg = int(grid.segments.shape[0])
    if int8 and (grid.pieces.dim() != 2 or grid.pieces.shape[1] != 4
                 or grid.chunks.dim() != 2 or grid.chunks.shape[1] != 2
                 or grid.tile_segs.shape != (nseg,)
                 or grid.lseg.shape != (d,) or grid.seg32.shape != (d,)):
        raise ValueError("grid.pieces must be [Q, 4], grid.chunks [C + 1, 2], "
                         "grid.tile_segs [S] and grid.lseg, grid.seg32 [D]")
    gmax = (torch.empty(nseg * n, dtype=torch.int32, device=dev)
            if int8 and grid.perm is not None else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    out = torch.empty_like(x)
    new_ref = torch.empty_like(x)
    contiguous = int8 and grid.perm is None
    err = _quant_lib()(
        x.data_ptr(), r.data_ptr(), ptr(imp), Wd.data_ptr(), gd.data_ptr(),
        grid.segments.data_ptr() if int8 else None, ptr(grid.pieces),
        ptr(grid.chunks), ptr(grid.tile_segs), ptr(grid.lseg),
        ptr(grid.seg32), ptr(gmax), out.data_ptr(), new_ref.data_ptr(),
        grid.pieces.shape[0] if int8 else 0, n, d, _WIRES[grid.wire_dtype],
        nseg, grid.max_segs, int(contiguous),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_quant_merge_all launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["fused_quant_merge_all" if imp is None
             else "fused_quant_merge_all_imp"] += 1
    return out, new_ref
