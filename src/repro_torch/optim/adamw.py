"""AdamW with decoupled weight decay + global-norm clipping (paper §4.1).

Port of ``repro.optim.adamw`` on the flat layout: ``params``, ``grads`` and
the moments are one ``[P]`` vector per node (the engine vmaps the update over
the node axis), so the clipping norm is the global norm over that node's
leaves and weight decay applies to every leaf, as in the reference.

A bf16 LM's params and grads come as the layout's two parts
(`repro_torch.core.flat.FlatLayout.parts`: the f32 prefix of its wide
leaves and its 16-bit rest); the moments are f32 vectors over their values
(``n_wide + n_rest``, not slots), so the wide leaves update in f32 and the
rest in f32 and then cast back, as the reference updates leaf by leaf.

:func:`adamw_update` is the reference's functional form (fresh buffers);
:func:`adamw_update_` writes the moments and params back into their own
buffers, which is what the port's step builders use: the reference donates
its state to the compiled step, so it never holds two sets of moments.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import TrainConfig


#: values per chunk of the update: a full-width LM's temporaries (f32
#: gradient, moments' products, the step) live one chunk at a time
CHUNK = 1 << 24


def _parts(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _chunks(parts):
    """(part index, start, stop, offset in the value vector) over the parts,
    at most ``CHUNK`` values each."""
    off = 0
    for i, p in enumerate(parts):
        n = p.shape[-1]
        for a in range(0, n, CHUNK):
            yield i, a, min(a + CHUNK, n), off + a
        off += n


def adamw_init(params):
    """Zero moments over the values of ``params`` (a tensor, or the
    layout's parts)."""
    parts = _parts(params)
    n = sum(p.shape[-1] for p in parts)
    lead = parts[0].shape[:-1]
    return {"mu": torch.zeros(lead + (n,), dtype=torch.float32,
                              device=parts[0].device),
            "nu": torch.zeros(lead + (n,), dtype=torch.float32,
                              device=parts[0].device),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=parts[0].device)}


def global_norm(grads) -> torch.Tensor:
    parts = _parts(grads)
    total = None
    for i, a, b, _ in _chunks(parts):
        g = parts[i][..., a:b].to(torch.float32)
        part = torch.sum(g * g)
        total = part if total is None else total + part
    return torch.sqrt(total)


def _clip_scale(grads, max_norm: float):
    norm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def clip_by_global_norm(grads, max_norm: float):
    """Scale every part by ``min(1, max_norm / ‖grads‖)`` in f32 and cast it
    back to its dtype; returns (grads in the form given, norm)."""
    scale, norm = _clip_scale(grads, max_norm)
    out = tuple((g.to(torch.float32) * scale).to(g.dtype)
                for g in _parts(grads))
    return (out if isinstance(grads, (tuple, list)) else out[0]), norm


def _update(ps, gs, state, cfg: TrainConfig, lr, mu, nu, new, norm=None):
    """The update's chunk loop, writing the moments into ``mu``/``nu`` and
    the params into the parts ``new``: each chunk reads its slice of the
    old moments, the grads and the params before it writes that slice, so
    the outputs may be the inputs themselves. ``norm``: the clipping norm,
    when the caller computed it (else :func:`global_norm` of ``gs``).
    Returns the new count."""
    scale = None
    if cfg.grad_clip > 0:
        scale = (_clip_scale(gs, cfg.grad_clip)[0] if norm is None else
                 torch.clamp(cfg.grad_clip / torch.clamp(norm, min=1e-9),
                             max=1.0))
    count = state["count"] + 1
    b1, b2 = cfg.b1, cfg.b2
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, c)
    bc2 = 1.0 - torch.pow(b2, c)
    for i, a, b, off in _chunks(ps):
        g = gs[i][..., a:b]
        if scale is not None:
            g = (g.to(torch.float32) * scale).to(g.dtype)
        g32 = g.to(torch.float32)
        sl = slice(off, off + b - a)
        m = b1 * state["mu"][..., sl] + (1 - b1) * g32
        v = b2 * state["nu"][..., sl] + (1 - b2) * (g32 * g32)
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        p32 = ps[i][..., a:b].to(torch.float32)
        new[i][..., a:b] = (p32 - lr * (step + cfg.weight_decay * p32)
                            ).to(ps[i].dtype)
        mu[..., sl], nu[..., sl] = m, v
    return count


def adamw_update(params, grads, state, cfg: TrainConfig, lr):
    """Returns (new_params, new_state). ``lr`` may be a tensor.
    ``params``/``grads`` are tensors, or tuples of parts (the new params
    then come back as a tuple of parts, each in its dtype). The update runs
    over chunks of at most ``CHUNK`` values, each with the reference's
    arithmetic (clipping included), so its f32 temporaries stay a chunk
    long; the new moments and params are written into fresh buffers (the
    reference's functional form; :func:`adamw_update_` writes in place)."""
    ps, gs = _parts(params), _parts(grads)
    mu, nu = torch.empty_like(state["mu"]), torch.empty_like(state["nu"])
    new = [torch.empty_like(p) for p in ps]
    count = _update(ps, gs, state, cfg, lr, mu, nu, new)
    new = tuple(new) if isinstance(params, (tuple, list)) else new[0]
    return new, {"mu": mu, "nu": nu, "count": count}


def adamw_update_(params, grads, state, cfg: TrainConfig, lr, norm=None):
    """:func:`adamw_update` in place: the moments go back into
    ``state["mu"]``/``state["nu"]`` and the params into ``params`` (a
    tensor, or the layout's parts: views of one slot buffer, so the buffer
    itself is updated and a 16-bit rest is cast back into it), chunk by
    chunk with the same arithmetic, so the two forms are bit-identical.
    Where the reference donates the params and the optimizer state to its
    compiled step, this is the port's form: no second set of moments or
    params is ever allocated. Returns ``(params, state)`` (the same tensors;
    the count is a new scalar). Under ``torch.func.vmap`` the params and
    moments must be batched along the vmapped axis, as the engine's stacked
    state always is. ``norm``: the clipping norm when the caller computed
    it (a shard's step takes the whole node's, `repro_torch.launch.
    train`)."""
    ps, gs = _parts(params), _parts(grads)
    count = _update(ps, gs, state, cfg, lr, state["mu"], state["nu"], ps,
                    norm)
    return params, {"mu": state["mu"], "nu": state["nu"], "count": count}
