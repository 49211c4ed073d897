"""Serving primitives: batched greedy decode against the KV cache / SSM
state. Port of ``repro.launch.serve``.

``make_logits_step`` is the raw-logits form the continuous-batching
engine (`repro_torch.serve`) runs over nodes and slots.

``serve_step_for`` / ``prefill_step_for`` are the counterparts of the
reference's cached jitted steps: captured programs
(`repro_torch.launch.capture`), cached per (model, batch, max_len[, seq],
device), over one :class:`StepBuffers` per (model, batch, max_len,
device) — one node's params (the caller's copied in, unless the caller
passes this buffer itself), the caches, the token fed ``[B, 1]`` and the
per-row position ``[B]``, both int64 on the device. The decode step feeds
its own token and advances the position on the card, so ``generate``
replays it back to back with no host work between tokens.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List

import torch

from repro_torch import resolve_device
from repro_torch.launch.capture import Program, ProgramPool
from repro_torch.models import Model
from repro_torch.models.layers import dtype_of


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


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every tensor of a cache tree (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a cache tree, in ``tree_map``'s order."""
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


class StepBuffers:
    """The static buffers of one (model, batch, max_len, device) set of step
    programs: one node's params ``[P]``, the caches, the token fed
    ``tok [B, 1]`` and the position ``pos [B]`` (int64), and a padded
    prompt ``[B, S]`` per prefill length."""

    def __init__(self, model: Model, batch: int, max_len: int,
                 device: torch.device):
        self.params = torch.zeros(model.layout.size,
                                  dtype=dtype_of(model.cfg.param_dtype),
                                  device=device)
        self.views = model.layout.unflatten(self.params)
        self.caches = model.init_cache(batch, max_len, device)
        self.tok = torch.zeros((batch, 1), dtype=torch.long, device=device)
        self.pos = torch.zeros(batch, dtype=torch.long, device=device)
        self.prompts: Dict[int, torch.Tensor] = {}
        self.graphs = ProgramPool(device)


@functools.lru_cache(maxsize=None)
def step_buffers(model: Model, batch: int, max_len: int,
                 device: torch.device) -> StepBuffers:
    return StepBuffers(model, batch, max_len, device)


@functools.lru_cache(maxsize=None)
def serve_step_for(model: Model, batch: int, max_len: int,
                   device: torch.device) -> Program:
    """The decode step: ``tok`` at ``pos`` → the greedy next token in
    ``tok``, ``pos`` + 1, the caches written at ``pos``."""
    st = step_buffers(model, batch, max_len, device)

    def body():
        logits, _ = model.decode(st.views, st.tok, st.caches, st.pos)
        st.tok.copy_(torch.argmax(logits[:, -1], dim=-1, keepdim=True))
        st.pos.add_(1)

    return st.graphs.capture(body)


@functools.lru_cache(maxsize=None)
def prefill_step_for(model: Model, batch: int, seq: int, max_len: int,
                     device: torch.device) -> Program:
    """The prefill of ``prompts[seq]`` into fresh caches → the greedy first
    token in ``tok``, ``pos`` = seq."""
    st = step_buffers(model, batch, max_len, device)
    prompt = st.prompts[seq] = torch.zeros((batch, seq), dtype=torch.long,
                                           device=device)

    def body():
        logits, _ = model.prefill(st.views, {"tokens": prompt}, st.caches)
        st.tok.copy_(torch.argmax(logits[:, -1], dim=-1, keepdim=True))
        st.pos.fill_(seq)

    return st.graphs.capture(body)


def generate(model: Model, params, prompt_tokens, max_new: int,
             max_len: int, device="cuda"):
    """Host-loop greedy generation on ``device`` (CUDA unless the caller
    asks for the CPU). ``params`` is one node's flat vector ``[P]``, copied
    into the step buffers, unless it is the very tensor object those
    buffers hold (``step_buffers(model, B, max_len, device).params``
    itself, tested by identity; a view or an equal copy is copied): then
    nothing is copied, so a model whose weights fit the card only once
    (deepseek-coder-33b's 62.1 GiB in bf16) is initialised there and
    served from it. ``prompt_tokens`` [B, S] int. Returns [B, max_new]
    int32."""
    device = resolve_device(device)
    prompt_tokens = torch.as_tensor(prompt_tokens).to(device=device,
                                                      dtype=torch.long)
    b, s = prompt_tokens.shape
    if s + max_new - 1 > max_len:
        raise ValueError(f"prompt ({s}) + max_new ({max_new}) - 1 exceeds "
                         f"the cache depth max_len={max_len}")
    st = step_buffers(model, b, max_len, device)
    # built before the buffers are set: a build's warm-up runs the body
    decode = serve_step_for(model, b, max_len, device)
    prefill = (prefill_step_for(model, b, s, max_len, device)
               if model.prefill is not None else None)
    if params is not st.params:
        st.params.copy_(params)
    for t in tree_leaves(st.caches):
        t.zero_()
    if prefill is not None:
        st.prompts[s].copy_(prompt_tokens)
        prefill.run()
    else:  # feed the prompt token by token
        for i in range(s):
            st.tok.copy_(prompt_tokens[:, i:i + 1])
            st.pos.fill_(i)
            decode.run()
    out = [st.tok.clone()]
    for _ in range(max_new - 1):
        decode.run()
        out.append(st.tok.clone())
    return torch.cat(out, dim=1).to(torch.int32)
