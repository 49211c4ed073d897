"""Top-k Mixture-of-Experts with capacity-based dispatch: port of
``repro.models.moe``.

The reference's semantics, step for step:

* **Routing** in f32 (``x.float() @ router.w``, the router's weight is f32
  in every model), softmax, top-k, the gate values renormalised by
  ``max(sum, 1e-9)``. Top-k is a stable descending sort cut to k, so ties
  go to the lower expert index and the ids come in descending order, as
  ``jax.lax.top_k`` gives them (``torch.topk`` promises neither on CUDA).
* **Aux loss**, Switch-style: ``e · Σ(me · ce) · router_aux_coef`` with
  ``me`` the mean router probability and ``ce`` the share of tokens whose
  top-1 is each expert; under a batch group (a split step's data ranks,
  `repro_torch.sharding.batch`) both means are the group's, ``me``
  differentiably, as GSPMD reduces them over the reference's ``data``.
* **Capacity per batch row**: ``cap_g = max(1, round(s·k/e·cf))`` (Python's
  round: halves to even). A row's s·k assignments, token-major, take slots
  in the order of a cumsum; those at or past ``cap_g`` are dropped.
* **Dispatch** into ``[E, B·cap_g, D]`` by an index copy into
  ``[E, B·cap_g + 1, D]`` whose spare row takes every dropped entry and is
  cut off: each kept (expert, slot) pair is written exactly once, so the
  result is deterministic (no atomics, no bf16 accumulation).
* **Expert FFN** ``silu(buf@gate) * (buf@up) @ down``, batched over E by
  ``torch.bmm`` (the reference computes it in jnp, outside any Pallas
  kernel).
* **Combine**: gather (a dropped entry reads slot ``cap - 1`` and its
  ``keep`` zeroes it), times ``keep · gate`` cast to x's dtype, the k terms
  summed in f32 and rounded once, as XLA reduces bf16.

The body reads nothing back from the card (no ``nonzero``, no boolean-mask
indexing, no ``.item()``; one-hots compare with ``arange(e)``), so a
serving step that runs it can be captured into a CUDA graph, and every op
has a ``torch.func.vmap`` rule, so the trainer's vmap over nodes runs it.

Under tensor parallelism (:func:`moe_tp`, a split step on a model group,
`repro_torch.sharding.tensor`) every model rank routes the gathered
sequence alike (the router whole; top-k, capacity and slots the same on
each rank). Where M divides the experts, a rank builds and runs only its
``E / M`` experts' rows of the ``[E, cap, D]`` buffer, and its f32 share
of the combine leaves by a reduce_scatter onto its cut of the sequence,
rounded once; otherwise (the reference's fallback: experts whole) it runs
every expert and keeps its own rows. The aux loss counts once: its
gradient is divided over the group. In the whole-residual form (a decode
step, a prompt or a training sequence M does not divide) every rank
routes every row alike, and the cut experts' shares leave by an
all_reduce (its backward an all_reduce of the rows' partial cotangents;
with the experts whole each rank keeps its partial).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import init_linear_
from repro_torch.sharding import batch, tensor


def moe_shapes(cfg: ModelConfig) -> dict:
    d, e = cfg.d_model, cfg.n_experts
    fe = cfg.d_ff_expert or cfg.d_ff
    return {"router": {"w": (d, e)},
            "experts": {"gate": {"w": (e, d, fe)}, "up": {"w": (e, d, fe)},
                        "down": {"w": (e, fe, d)}}}


def init_moe_(p: dict, cfg: ModelConfig, generator: torch.Generator) -> None:
    """The reference's scales: every weight ~ N(0, 1/in)."""
    init_linear_(p["router"], generator)
    for name in ("gate", "up", "down"):
        init_linear_(p["experts"][name], generator)


def route(p, x, cfg: ModelConfig):
    """x [B,S,D] → (gate values [B,S,k] f32, expert ids [B,S,k], aux)."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = x.to(torch.float32) @ p["router"]["w"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                        # [B,S,E]
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_ids = gate_vals[..., :k], expert_ids[..., :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    experts = torch.arange(e, device=x.device)
    me = probs.reshape(b * s, e).mean(0)
    ce = (expert_ids[..., 0].reshape(b * s, 1) == experts).to(
        torch.float32).mean(0)
    if batch.current() is not None:
        # a split step's rank holds B / D of the node's rows: both batch
        # means are the node's before their product (`sharding.batch`)
        me = batch.group_mean(me)
        ce = batch.group_sum(ce) / batch.current().world_size
    aux = e * torch.sum(me * ce) * cfg.router_aux_coef
    return gate_vals, expert_ids, aux


def dispatch(expert_ids, cfg: ModelConfig):
    """Expert ids [B,S,k] → (slot [B·S·k], keep [B·S·k] bool, cap_g): each
    assignment's slot in its expert's ``[B·cap_g]`` rows (row g owns slots
    ``g·cap_g`` .. ``(g+1)·cap_g - 1``) and whether it fits."""
    b, s, k = expert_ids.shape
    e = cfg.n_experts
    cap_g = int(max(1, round(s * k / e * cfg.capacity_factor)))
    flat_ids = expert_ids.reshape(b, s * k)                      # token-major
    # the one-hot expert-major [B, E, S·k], so the running count is a scan
    # along the last dim (PyTorch's scan over a middle dim took 3 ms a
    # call at 16,384 assignments on an H100)
    experts = torch.arange(e, device=flat_ids.device)[:, None]
    onehot = (flat_ids[:, None, :] == experts).to(torch.int32)
    pos = torch.cumsum(onehot, dim=-1, dtype=torch.int32) - 1   # per row
    pos = torch.gather(pos, 1, flat_ids[:, None, :])[:, 0]
    keep = pos < cap_g
    pos = torch.where(keep, pos, cap_g)
    grp = torch.arange(b, device=flat_ids.device)[:, None]
    slot = grp * cap_g + pos
    return slot.reshape(-1), keep.reshape(-1), cap_g


def moe(p, x, cfg: ModelConfig):
    """x [B,S,D] → (y [B,S,D], aux scalar f32)."""
    gate_vals, expert_ids, aux = route(p, x, cfg)
    return experts(p, x, cfg, gate_vals, expert_ids).to(x.dtype), aux


def experts(p, x, cfg: ModelConfig, gate_vals, expert_ids, e0: int = 0):
    """The experts ``e0 .. e0 + E_l`` (``p``'s stacked experts, ``E_l``
    of them) on the routed ``x`` [B,S,D]: their gate-weighted outputs, the
    k terms summed in f32 [B,S,D] (the other experts' assignments
    weigh 0)."""
    b, s, d = x.shape
    k = cfg.top_k
    w = p["experts"]
    e = w["gate"]["w"].shape[0]
    t = b * s
    slot, keep, cap_g = dispatch(expert_ids, cfg)
    cap = b * cap_g
    flat_ids = expert_ids.reshape(t * k) - e0
    if e0 or e != cfg.n_experts:
        mine = (flat_ids >= 0) & (flat_ids < e)
        flat_ids = torch.where(mine, flat_ids, 0)
        keep = keep & mine

    # dispatch: [E_l, cap + 1, D], the spare row cut off
    src = x.reshape(t, 1, d).expand(t, k, d).reshape(t * k, d)
    rows = flat_ids * (cap + 1) + torch.where(keep, slot, cap)
    buf = x.new_zeros((e * (cap + 1), d)).index_copy(0, rows, src)
    buf = buf.reshape(e, cap + 1, d)[:, :cap]

    g = F.silu(torch.bmm(buf, w["gate"]["w"].to(x.dtype)))
    u = torch.bmm(buf, w["up"]["w"].to(x.dtype))
    out = torch.bmm(g * u, w["down"]["w"].to(x.dtype))           # [E,cap,D]

    # combine: gather back, weight by the gates
    rows = flat_ids * cap + torch.where(keep, slot, cap - 1)
    got = out.reshape(e * cap, d).index_select(0, rows)          # [T*k, D]
    got = got * (keep[:, None] * gate_vals.reshape(t * k, 1)).to(x.dtype)
    return got.reshape(t, k, d).to(torch.float32).sum(1).reshape(b, s, d)


def moe_tp(p, h, cfg: ModelConfig):
    """The MoE block under tensor parallelism: ``h`` [B, S/M, D] the
    rank's cut of the sequence (every row in the whole-residual form: no
    gather, and an all_reduce in place of the reduce_scatter), ``p`` the
    compute blocks (the router whole, the experts the rank's ``E / M`` or
    all of them) → (the rank's cut of y [B, S/M, D], aux)."""
    tp = tensor.current()
    x = tensor.enter(h)
    gate_vals, expert_ids, aux = route(p, x, cfg)
    aux = tensor.replicated(aux)
    if tp.place.experts:
        e0 = tp.rank * (cfg.n_experts // tp.size)
        y = experts(p, x, cfg, gate_vals, expert_ids, e0)
        return tensor.leave(y).to(h.dtype), aux
    y = experts(p, x, cfg, gate_vals, expert_ids).to(h.dtype)
    return tensor.own(y), aux
