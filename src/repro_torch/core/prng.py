"""JAX's threefry PRNG, bit for bit, as vectorised torch code.

``SwarmState.rng`` is a ``uint32[2]`` threefry key, ``PRNGKey(cfg.seed)``
folded once per round; the session carries it so that a checkpoint holds
the key the reference expects. The fault plane's bit-flip injector
(`repro_torch.faults.signals`) draws the reference's
``jax.random.bernoulli`` pattern from the same functions, on the payload's
device. A copy of JAX's ``threefry_seed``, ``threefry_2x32`` and
``fold_in`` (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3",
SC 2011).

uint32 values are held in int64 tensors and masked to 32 bits after every
addition and rotation (the same convention as ``core.comms``'s checksum):
torch has no unsigned 32-bit arithmetic on every device.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pairs ``(x0, x1)`` under the
    keys ``(k0, k1)``: int64 tensors of uint32 values, broadcast together.
    Returns the two output words ``(y0, y1)``."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def fold_in(key, data: torch.Tensor):
    """``jax.random.fold_in(key, d)`` of a legacy ``uint32[2]`` key (two
    uint32 values: Python integers or int64 tensors) for every value of
    ``data`` (int64, uint32 values): the threefry hash of the counter pair
    (0, d). Returns the two words of the folded keys, each shaped like
    ``data``."""
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` (legacy uint32[2] key)."""
    seed = int(seed)
    return np.array([(seed >> 32) & _M32, seed & _M32], np.uint32)


def fold_in_key(key, data: int) -> np.ndarray:
    """:func:`fold_in` of one value, numpy key in and out (the session's
    per-round fold)."""
    k = torch.as_tensor(np.asarray(key, np.uint32).astype(np.int64))
    y0, y1 = fold_in(k, torch.tensor(int(data) & _M32))
    return np.array([int(y0), int(y1)], np.uint32)
