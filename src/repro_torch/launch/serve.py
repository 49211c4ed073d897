"""Serving primitives: batched greedy decode against the KV cache / SSM
state. Port of ``repro.launch.serve``.

The port runs eagerly, so there is no jitted step to cache per model (the
reference's ``serve_step_for`` / ``prefill_step_for``): the step functions
are built per call and cost nothing to build.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.models import Model


def make_logits_step(model: Model) -> Callable:
    """(params, tokens [B,S], caches, cache_pos[, commit]) -> (logits
    [B,S,V], caches).

    The raw decode primitive: one forward against the cache, no sampling.
    With S > 1 and cache_pos = 0 it doubles as prefill (attention writes
    tokens 0..S-1 in place and the causal mask hides everything past the
    query position), which is how the serve engine runs both phases
    through one function. ``cache_pos`` may be an int tensor ``[B]`` (a
    position per row) and ``commit`` a bool ``[B]`` (the rows whose caches
    change).
    """

    def logits_step(params, tokens, caches, cache_pos, commit=None):
        return model.decode(params, tokens, caches, cache_pos, commit=commit)

    return logits_step


def make_serve_step(model: Model) -> Callable:
    """(params, tokens [B,1], caches, cache_pos) -> (next_tokens [B,1],
    caches)."""
    logits_step = make_logits_step(model)

    def serve_step(params, tokens, caches, cache_pos):
        logits, caches = logits_step(params, tokens, caches, cache_pos)
        return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32), caches

    return serve_step


def make_prefill_step(model: Model) -> Callable:
    def prefill_step(params, batch, caches):
        logits, caches = model.prefill(params, batch, caches)
        return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32), caches

    return prefill_step


def generate(model: Model, params, prompt_tokens, max_new: int,
             max_len: int, device="cuda"):
    """Host-loop greedy generation on ``device`` (CUDA unless the caller
    asks for the CPU). ``params`` is one node's flat vector ``[P]`` (moved
    to the device); ``prompt_tokens`` [B, S] int. Returns [B, max_new]
    int32."""
    device = resolve_device(device)
    params = model.layout.unflatten(params.to(device))
    prompt_tokens = torch.as_tensor(prompt_tokens, device=device).to(
        torch.long)
    b, s = prompt_tokens.shape
    caches = model.init_cache(b, max_len, device)
    serve_step = make_serve_step(model)
    if model.prefill is not None:
        tok, caches = make_prefill_step(model)(
            params, {"tokens": prompt_tokens}, caches)
    else:  # feed the prompt token by token
        tok = prompt_tokens[:, :1]
        for i in range(s):
            tok, caches = serve_step(params, prompt_tokens[:, i:i + 1],
                                     caches, i)
    out = [tok]
    for i in range(max_new - 1):
        tok, caches = serve_step(params, tok, caches, s + i)
        out.append(tok)
    return torch.cat(out, dim=1)
