"""The session's legacy JAX PRNG key, kept bit for bit.

``SwarmState.rng`` is a ``uint32[2]`` threefry key, ``PRNGKey(cfg.seed)``
folded once per round. Nothing in the port draws from it; the session
carries it so that a checkpoint holds the key the reference expects. This
is a numpy copy of JAX's ``threefry_seed`` and ``threefry_2x32`` (Salmon et
al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011).
"""
from __future__ import annotations

import numpy as np

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(key, x0: int, x1: int):
    """Threefry-2x32 (20 rounds) of one counter pair under ``key``."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` (legacy uint32[2] key)."""
    seed = int(seed)
    return np.array([(seed >> 32) & _M32, seed & _M32], np.uint32)


def fold_in_key(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for a legacy key: the threefry
    hash of the counter pair (0, data) under ``key``."""
    return np.array(threefry2x32(key, 0, int(data) & _M32), np.uint32)
