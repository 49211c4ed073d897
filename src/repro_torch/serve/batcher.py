"""Padded-bucket shape policy: the engine dispatches only a small fixed set
of (batch, seq) shapes. Own copy of ``repro.serve.batcher`` (numpy only; a
test holds the two equal).

Prompts are right-padded up to the next seq bucket before the prefill
dispatch. For position-indexed caches (the attention families) this is
exact, not approximate: pad positions sit AFTER the real tokens, the causal
mask assigns them zero attention weight from every real query position, and
later decode steps overwrite them in place. Recurrent-state families (ssm,
hybrid) consume pads into their state, so they need seq buckets matching
their prompt lengths exactly.

The decode batch dimension is the live-slot table, which grows and shrinks
only across ``batch_buckets``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class BucketPolicy:
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    seq_buckets: Tuple[int, ...] = (8, 16, 32, 64)

    def __post_init__(self):
        for name in ("batch_buckets", "seq_buckets"):
            b = tuple(getattr(self, name))
            if not b or list(b) != sorted(set(b)) or b[0] < 1:
                raise ValueError(
                    f"{name} must be a sorted tuple of unique positive ints, "
                    f"got {b!r}")

    def batch_bucket(self, n: int) -> int:
        """Smallest batch bucket holding ``n`` live slots."""
        for b in self.batch_buckets:
            if n <= b:
                return b
        raise ValueError(f"{n} slots exceed the largest batch bucket "
                         f"{self.batch_buckets[-1]}")

    def seq_bucket(self, n: int) -> int:
        """Smallest seq bucket holding an ``n``-token prompt."""
        for b in self.seq_buckets:
            if n <= b:
                return b
        raise ValueError(f"a {n}-token prompt exceeds the largest seq bucket "
                         f"{self.seq_buckets[-1]}")

    def pad_prompt(self, prompt: np.ndarray) -> Tuple[np.ndarray, int]:
        """Right-pad to the prompt's seq bucket; returns (padded, real_len)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        out = np.zeros(self.seq_bucket(prompt.size), np.int32)
        out[:prompt.size] = prompt
        return out, int(prompt.size)
