"""Traffic kind ``histo_images``: the synthetic histopathology of the
repository's data module (a frozen copy of its recipe, drawn on the
device in bulk).

Class ``y`` is drawn from ``class_probs``; the image is ``mix·sin(f·x +
φ₀)·cos(f·y + φ₁) + (1 − mix)·blobs`` (f = 2, 5, 9 and mix = 0.7, 0.5, 0.3
by class; blobs a normal field on an 8 px grid) times the stain vector
(0.65, 0.70, 0.29) with the class's channel raised by 30 %, plus
``noise``·N(0, 1) per pixel and channel, then each image's channels
standardised and scaled by the stain vector (the Macenko approximation).
Node i's pool holds ``round(fraction_i · pool)`` training images and
``val_per_node`` validation images; its FedAvg weight is its pool size.
"""
from __future__ import annotations

import math

import torch

STAIN = (0.65, 0.70, 0.29)


def images(count, size, noise, class_probs, gen, device, chunk=128):
    """``count`` images ``[count, size, size, 3]`` and their labels."""
    probs = torch.tensor(class_probs, dtype=torch.float32, device=device)
    labels = torch.multinomial(probs / probs.sum(), count, replacement=True,
                               generator=gen)
    grid = torch.linspace(0, 2 * math.pi, size, device=device)
    xx, yy = grid[None, None, :], grid[None, :, None]
    freq = torch.tensor([2.0, 5.0, 9.0], device=device)
    mixes = torch.tensor([0.7, 0.5, 0.3], device=device)
    stain = torch.tensor(STAIN, device=device)
    out = torch.empty((count, size, size, 3), device=device)
    cells = -(-size // 8)
    for a in range(0, count, chunk):
        y = labels[a:a + chunk]
        m = y.shape[0]
        f, mix = freq[y][:, None, None], mixes[y][:, None, None]
        phase = torch.rand((m, 2), generator=gen, device=device) * 2 * math.pi
        base = (torch.sin(f * xx + phase[:, 0, None, None])
                * torch.cos(f * yy + phase[:, 1, None, None]))
        blobs = torch.randn((m, cells, cells), generator=gen, device=device)
        blobs = blobs.repeat_interleave(8, 1).repeat_interleave(8, 2)
        tex = mix * base + (1 - mix) * blobs[:, :size, :size]
        chan = stain * (1.0 + 0.3 * torch.eye(3, device=device)[y])
        img = tex[..., None] * chan[:, None, None, :]
        img = img + noise * torch.randn((m, size, size, 3), generator=gen,
                                        device=device)
        mu = img.mean(dim=(1, 2), keepdim=True)
        sd = img.std(dim=(1, 2), keepdim=True, correction=0) + 1e-6
        out[a:a + m] = (img - mu) / sd * stain
    return out, labels


def make(spec: dict, model: dict, n_nodes: int, gen, device):
    v = spec["val_per_node"]
    sizes = [round(f * spec["pool"]) for f in spec["fractions"]]
    pools, vx, vy = [], [], []
    for s in sizes:
        x, y = images(s + v, model["image_size"], spec["noise"],
                      spec["class_probs"], gen, device)
        pools.append((x[v:], y[v:]))
        vx.append(x[:v])
        vy.append(y[:v])
    val = (torch.stack(vx), torch.stack(vy),
           torch.ones((n_nodes, v), dtype=torch.bool, device=device))
    return pools, val, sizes


def batch(rows):
    return rows


def val_of(val, node: int):
    x, y, _ = val
    return x[node], y[node]
