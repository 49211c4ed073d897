"""The kernels' own work, counted for a dry run.

A dry run (`repro_torch.launch.dryrun`) counts a rank's FLOPs and bytes
op by op as PyTorch dispatches them. The flash and SSD kernels are not
PyTorch ops: their wrappers add what the kernel itself does, by formula,
to every :func:`counting` block open (:func:`add`), on every device:

* ``meta`` (the dry run): the wrapper returns empty outputs of the
  kernel's shapes and dtypes and counts; it never runs the plain version,
  whose ``[B, H, S, T]`` scores the kernel never allocates;
* ``cuda``: the launch counts, so a rank run on the card reaches the count
  its ``meta`` run predicted;
* ``cpu``: the plain version runs under :func:`plain`, which the dry run's
  op counter skips, and the formula counts in its place.

``tensor`` FLOPs run at the tensor-core rate of their 16-bit operands,
``f32`` FLOPs at the f32 rate; ``bytes`` are each input read once and
each output written once.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List

_OPEN: List["KernelWork"] = []
_PLAIN = [0]


class KernelWork:
    """What the kernels did inside one :func:`counting` block: ``flops``
    by rate class (``tensor``, ``f32``), ``bytes``, and ``calls`` by
    kernel."""

    def __init__(self):
        self.flops: Dict[str, float] = {"tensor": 0.0, "f32": 0.0}
        self.bytes = 0.0
        self.calls: Dict[str, int] = {}


@contextmanager
def counting():
    """Within the block, every kernel call adds its work to the yielded
    :class:`KernelWork`."""
    w = KernelWork()
    _OPEN.append(w)
    try:
        yield w
    finally:
        _OPEN.remove(w)


def active() -> bool:
    return bool(_OPEN)


def add(name: str, tensor_flops: float, f32_flops: float,
        nbytes: float) -> None:
    for w in _OPEN:
        w.flops["tensor"] += tensor_flops
        w.flops["f32"] += f32_flops
        w.bytes += nbytes
        w.calls[name] = w.calls.get(name, 0) + 1


@contextmanager
def plain():
    """A kernel's plain version runs inside: the dry run's op counter
    skips its ops (the kernel's formula counts them)."""
    _PLAIN[0] += 1
    try:
        yield
    finally:
        _PLAIN[0] -= 1


def in_plain() -> bool:
    return _PLAIN[0] > 0


def causal_pairs(s: int, t: int, causal: bool, window: int,
                 q_off: int) -> int:
    """(query, key) pairs a flash call's mask keeps: query rows at
    positions ``q_off .. q_off + s - 1`` over keys ``0 .. t - 1``."""
    if not causal:
        return s * t
    lo, hi = q_off + 1, q_off + s      # keys each row keeps, unwindowed
    w = window if window > 0 else hi
    if w >= hi:
        return (lo + hi) * (hi - lo + 1) // 2
    if w < lo:
        return w * (hi - lo + 1)
    return (lo + w) * (w - lo + 1) // 2 + w * (hi - w)


def flash_work(b, h, hkv, s, t, d, itemsize, causal, window, q_off):
    """``(tensor, f32, bytes)`` of one flash call: 4·D FLOPs a kept
    (query, key) pair a head (Q·Kᵀ and P·V), q, k, v read and the output
    written once."""
    flops = 4.0 * d * b * h * causal_pairs(s, t, causal, window, q_off)
    nbytes = float((2 * b * h * s * d + 2 * b * hkv * t * d) * itemsize)
    return (flops, 0.0, nbytes) if itemsize == 2 else (0.0, flops, nbytes)


def ssd_work(b, s, h, p, g, n, chunk, itemsize, a_numel):
    """``(tensor, f32, bytes)`` of one SSD call: per chunk C·Bᵀ over the
    causal pairs (2N each) once a group, on 16-bit operands at the
    tensor-core rate, and per head the pairs' weighted x (2P each) and the
    carried state's 2·L·N·P twice at the f32 rate; x, dt, a_log, B, C read
    and y, the f32 state written once."""
    pairs, chunks = chunk * (chunk + 1) // 2, s // chunk
    f32 = float(b * h * chunks * (pairs * 2 * p + 4 * chunk * n * p))
    cb = float(b * g * chunks * pairs * 2 * n)
    nbytes = float((2 * b * s * h * p + 2 * b * s * g * n) * itemsize
                   + b * s * h * 4 + a_numel * 4 + b * h * p * n * 4)
    return (cb, f32, nbytes) if itemsize == 2 else (0.0, f32 + cb, nbytes)
