"""Shared layer primitives of the LM families: port of ``repro.models.layers``.

Plain functions over nested dicts of tensors, the reference's param trees
(linear weights ``[in, out]``, ``y = x @ w``). ``linear`` reads LoRA adapters
(``lora_A``, ``lora_B``, ``lora_scale``) when a layer carries them, in plain
torch, as the reference does. ``apply_rope`` uses the reference's
split-halves convention (the two halves of the head dim rotate together),
not the interleaved one. ``mlp`` mirrors the reference's activations:
``jax.nn.gelu`` is the tanh approximation by default, so ``gelu`` here is
too.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import batch, tensor


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# initializers (the reference's shapes and scales; draws from a Generator)
# ---------------------------------------------------------------------------

def normal_(t: torch.Tensor, generator: torch.Generator, scale: float):
    """Fill ``t`` in place with N(0, scale²) drawn in f32 on its device.
    The draw is scaled in place, so one f32 temporary of ``t``'s size is
    live (6.3 GB for nemotron-4-15b's embedding), not two; the values are
    those of ``randn(...) * scale``."""
    t.copy_(torch.randn(t.shape, generator=generator, device=t.device)
            .mul_(scale))
    return t


def init_linear_(p: dict, generator: torch.Generator) -> None:
    """``w`` [in, out] ~ N(0, 1/in); ``b`` zeros."""
    normal_(p["w"], generator, 1.0 / math.sqrt(p["w"].shape[-2]))
    if "b" in p:
        p["b"].zero_()


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def linear(p, x, bias: bool = True):
    """``x @ w`` (+ the LoRA term) (+ ``b``; ``bias=False`` leaves it to
    the caller: a row-parallel layer adds it once, after its reduce)."""
    y = x @ p["w"].to(x.dtype)
    if "lora_A" in p:  # LoRA adapter
        scale = p["lora_scale"].to(x.dtype)
        y = y + ((x @ p["lora_A"].to(x.dtype))
                 @ p["lora_B"].to(x.dtype)) * scale
    if bias and "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def row_parallel(p, x):
    """A row-parallel layer under tensor parallelism: the rank's share
    ``x_cut @ w_cut`` summed over the model group onto the rank's cut of
    the sequence, or whole in the whole-residual form
    (`repro_torch.sharding.tensor.leave`), the bias added once, after."""
    y = tensor.leave(linear(p, x, bias=False))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def rmsnorm(p, x, eps: float = 1e-5):
    orig = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * p["scale"].to(torch.float32)).to(orig)


def embed(p, ids, compute_dtype):
    return p["table"][ids].to(compute_dtype)


def unembed(p, x):
    return x @ p["table"].to(x.dtype).T


def rope_freqs(head_dim: int, theta: float, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # [head_dim//2]


def apply_rope(x, positions, theta: float):
    """x: [..., seq, heads, head_dim]; positions: [..., seq] (int)."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., :, None, :]  # [..., seq, 1, hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _mlp_hidden(p, x, cfg: ModelConfig):
    if cfg.activation == "swiglu":
        return F.silu(linear(p["gate"], x)) * linear(p["up"], x)
    if cfg.activation == "sq_relu":  # nemotron-4: squared ReLU
        return torch.square(F.relu(linear(p["up"], x)))
    return gelu(linear(p["up"], x))


def mlp(p, x, cfg: ModelConfig):
    """The MLP; under tensor parallelism (x the rank's cut of the
    sequence, or every row in the whole-residual form) with ``ff`` cut its
    hidden axis column-parallel over the whole sequence and ``down``
    row-parallel, else whole on the rank's rows (position-wise: no
    collective)."""
    tp = tensor.current()
    if tp is not None and tp.place.ff:
        return row_parallel(p["down"], _mlp_hidden(p, tensor.enter(x), cfg))
    return linear(p["down"], _mlp_hidden(p, x, cfg))


def softmax_xent(logits, labels, mask: Optional[torch.Tensor] = None):
    """Token-mean cross entropy. logits [..., V]; labels int [...].

    Under a batch group (`repro_torch.sharding.batch`: a split step's
    ``D`` data ranks, each with ``B / D`` of the node's rows) the masked
    mean is ``D`` times the rank's masked sum over the group's token count,
    so that the node's loss is the mean of its ranks' (the unmasked mean of
    equal row counts already is). Under tensor parallelism ``logits`` is
    the rank's vocab cut (`repro_torch.sharding.tensor.vocab_xent`), or
    where the placement keeps the vocab whole the whole logits, alike on
    every rank: their cross entropy goes through `repro_torch.sharding.
    tensor.replicated`, so its gradient counts once over the group."""
    tp = tensor.current()
    if tp is not None and tp.place.vocab:
        nll = tensor.vocab_xent(logits, labels)
    else:
        lf = logits.to(torch.float32)
        logz = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
        nll = logz - gold
        if tp is not None:
            nll = tensor.replicated(nll)
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    group = batch.current()
    if group is None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    count = batch.group_sum(torch.sum(mask).reshape(1))[0]
    return (group.world_size * torch.sum(nll * mask)
            / torch.clamp(count, min=1.0))
