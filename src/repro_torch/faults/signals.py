"""Fault signals for the round, and the deterministic wire corruptor.

Counterpart of ``repro.faults.signals``. :class:`FaultSignals` is what
`SwarmEngine.sync` consumes to inject wire corruption into a round: which
nodes' payloads arrive damaged, and the key that fixes the damage. The
runner threads a (possibly all-False) signal through every round of the
wire path, so a faulted round and a fault-free one run the same steps.

:func:`flip_payload_bits` is the corruptor: for every node flagged in
``corrupt`` it XORs bit ``bit`` (a mid-mantissa f32 bit — a ~2⁻³ relative
perturbation that stays finite, never NaN/Inf) into a seeded pseudo-random
~``rate`` subset of the node's payload elements, plus always the first
element of every leaf so at least one bit flips regardless of payload
size. The per-payload checksum (`repro_torch.core.comms.payload_checksum`)
must detect the flip and the sync must quarantine the sender
(reject-and-keep-local).

The flip pattern is the reference's bit for bit. For leaf ``i`` of the
stacked payload tree (in the reference's leaf order, HWIO convs), the
reference draws ``jax.random.bernoulli(fold_in(key, i), rate, (N, m_i))``.
That is JAX's float32 ``uniform`` below ``rate``: the uniform value of a
32-bit word ``w`` is ``(w >> 9)·2⁻²³``, exactly, so the draw is true iff
``w >> 9`` is below ``ceil(rate·2²³)`` (``w < 2²⁸`` at 1/16). The words
come from threefry-2x32 in the counter layout of JAX's partitionable
threefry (``jax_threefry_partitionable``, the default since JAX 0.5): the
word of element ``[r, j]`` of a leaf of ``m`` values per node is
``y0 ^ y1`` of the counter pair ``(0, r·m + j)``. Only the flagged rows'
counters are hashed, so an idle round draws nothing.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core import comms
from repro_torch.core.prng import fold_in, threefry2x32

_M32 = 0xFFFFFFFF


@dataclass
class FaultSignals:
    """Per-round corruption directive, as host data.

    ``corrupt``: [N] bool — nodes whose *outgoing* wire payload arrives
    bit-flipped this round. ``key``: a legacy ``uint32[2]`` PRNG key (an
    int64 tensor of uint32 values) fixing the flip pattern; derive it per
    round with :func:`plan_key` so a seeded plan replays bit-identically.
    """

    corrupt: Any
    key: Any


def plan_key(seed: int, round_index: int) -> torch.Tensor:
    """Deterministic per-round key: (plan seed, round) as raw key data."""
    return torch.tensor([seed & _M32, round_index & _M32], dtype=torch.int64)


def idle_signals(n_nodes: int) -> FaultSignals:
    """The no-fault signal: nobody flagged, so nothing is drawn or
    flipped, but the sync still checksums the wire."""
    return FaultSignals(corrupt=torch.zeros((n_nodes,), dtype=torch.bool),
                        key=torch.zeros((2,), dtype=torch.int64))


def signals_for_round(plan, lowered, round_index: int) -> FaultSignals:
    """The round's :class:`FaultSignals` from a lowered plan."""
    return FaultSignals(
        corrupt=torch.from_numpy(lowered.corrupt[round_index].copy()),
        key=plan_key(plan.seed, round_index))


def flip_payload_bits(payload: torch.Tensor, corrupt, key,
                      layout: "comms.FlatLayout | int | comms.RefIndex",
                      *, bit: int = 20, rate: float = 1.0 / 16
                      ) -> torch.Tensor:
    """Deterministically bit-flip the payload rows of ``corrupt`` nodes.

    ``payload``: the stacked f32 payload ``[N, P]`` under ``layout`` (its
    :class:`~repro_torch.core.flat.FlatLayout`, an integer for one leaf, or
    the layout's :class:`~repro_torch.core.comms.RefIndex` on the payload's
    device). ``corrupt`` [N] bool is read on the host; rows of nodes with
    ``corrupt[i] == False`` are returned bit-identical, and with no node
    flagged the payload itself is returned. The flip pattern depends only
    on ``(key, leaf index, leaf shape)``, as the reference's does."""
    rows = torch.nonzero(torch.as_tensor(corrupt).cpu().to(torch.bool))
    if rows.numel() == 0:
        return payload
    dev = payload.device
    idx = comms.ref_index(layout, dev)
    if idx.pos.numel() != payload.shape[1]:
        raise ValueError(f"layout covers {idx.pos.numel()} values, payload "
                         f"has {payload.shape[1]}")
    # the key and the rows stay Python integers: nothing is copied to the
    # device, so an armed flip never waits on the stream
    key = [int(v) & _M32 for v in torch.as_tensor(key).reshape(-1).tolist()]
    k0, k1 = fold_in(key, torch.arange(idx.n_leaves, device=dev))
    k0, k1 = k0[idx.leaf], k1[idx.leaf]
    # bernoulli(rate) on float32 uniforms: (w >> 9)·2⁻²³ < rate
    threshold = math.ceil(float(np.float32(rate)) * 2 ** 23)
    mask = int(np.uint32(1 << bit).view(np.int32))
    out = payload.to(torch.float32).clone()
    for r in rows.reshape(-1).tolist():
        counter = r * idx.size + idx.pos
        y0, y1 = threefry2x32(k0, k1, torch.zeros_like(counter), counter)
        flips = (((y0 ^ y1) >> 9) < threshold) | (idx.pos == 0)
        bits = out[r].view(torch.int32)
        out[r] = torch.where(flips, bits ^ mask, bits).view(torch.float32)
    return out
