"""Plain reference of the paper's DenseNet-lite (§3.3) and its loss and gate.

Four dense blocks of ``layers_per_block`` 3×3 convolutions (each BN →
ReLU → conv, its output concatenated onto the block's input), transitions
of BN → ReLU → 1×1 conv and 2×2 average pooling (none below 2 px), a 7×7/2
stem conv → BN → ReLU → 3×3/2 max pool, a global average pool to
``feat_dim`` features and a head FC(→hidden)+BN+ReLU, FC(→classes)+BN.
BatchNorm uses the batch's statistics (biased variance, eps 1e-5).
Convolutions pad as XLA's ``"SAME"`` does (the odd element on the high
side). Inputs are NHWC images; conv weights OIHW, FC weights [in, out].

The loss is the mean binary cross entropy of the sigmoid outputs against
one-hot labels; the gate metric is the one-vs-rest macro AUC of the
sigmoid outputs, ties averaged, over the classes present.

Parameters are a dict ``{path: tensor}``; :func:`shapes` lists the paths.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from swarmbench.reference import precision


def shapes(m: dict) -> Dict[str, tuple]:
    """{path: shape} of the model ``m`` (the configuration's ``model``)."""
    out = {}

    def bn(prefix, c):
        out[f"{prefix}.bias"] = (c,)
        out[f"{prefix}.scale"] = (c,)

    stem = m["stem"]
    bn("stem.bn", stem)
    out["stem.w"] = (stem, 3, 7, 7)
    c = stem
    for b in range(m["n_blocks"]):
        for i in range(m["layers_per_block"]):
            bn(f"blocks.{b}.layers.{i}.bn", c)
            out[f"blocks.{b}.layers.{i}.w"] = (m["growth"], c, 3, 3)
            c += m["growth"]
        t = c // 2 if b < m["n_blocks"] - 1 else m["feat_dim"]
        bn(f"blocks.{b}.trans.bn", c)
        out[f"blocks.{b}.trans.w"] = (t, c, 1, 1)
        c = t
    for name, cin, cout in (("fc1", m["feat_dim"], m["hidden"]),
                            ("fc2", m["hidden"], m["n_classes"])):
        out[f"head.{name}.b"] = (cout,)
        bn(f"head.{name}.bn", cout)
        out[f"head.{name}.w"] = (cin, cout)
    return out


def init(m: dict, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """He-normal weights, zero biases, unit BN scales: one normal draw on
    ``device`` for every weight, cut into the leaves."""
    shp = shapes(m)
    weights = [p for p in shp if p.endswith(".w")]
    sizes = [math.prod(shp[p]) for p in weights]
    draw = torch.randn(sum(sizes), generator=generator, device=device)
    out = {}
    for p, piece in zip(weights, draw.split(sizes)):
        s = shp[p]
        fan_in = s[1] * s[2] * s[3] if len(s) == 4 else s[0]
        out[p] = piece.reshape(s) * math.sqrt(2.0 / fan_in)
    for p, s in shp.items():
        if p in out:
            continue
        fill = 1.0 if p.endswith(".scale") else 0.0
        out[p] = torch.full(s, fill, device=device)
    return {p: out[p] for p in shp}


def _same(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride, policy):
    ph = _same(x.shape[-2], w.shape[-2], stride)
    pw = _same(x.shape[-1], w.shape[-1], stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(precision.round_to(x, policy), precision.round_to(w, policy),
                 stride=stride)
    return precision.round_out(y, policy)


def _bn(x, p, prefix):
    dims = (0,) + tuple(range(2, x.dim()))
    mu = x.mean(dim=dims, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=dims, keepdim=True)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return ((x - mu) / torch.sqrt(var + 1e-5) * p[f"{prefix}.scale"].reshape(shape)
            + p[f"{prefix}.bias"].reshape(shape))


def logits(p: Dict[str, torch.Tensor], images: torch.Tensor, m: dict,
           policy: str = "f32") -> torch.Tensor:
    """images [B, H, W, 3] → logits [B, classes]."""
    x = images.permute(0, 3, 1, 2)
    x = F.relu(_bn(_conv(x, p["stem.w"], 2, policy), p, "stem.bn"))
    ph = _same(x.shape[-2], 3, 2)
    pw = _same(x.shape[-1], 3, 2)
    x = F.max_pool2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=-math.inf),
                     3, 2)
    for b in range(m["n_blocks"]):
        for i in range(m["layers_per_block"]):
            pre = f"blocks.{b}.layers.{i}"
            h = _conv(F.relu(_bn(x, p, f"{pre}.bn")), p[f"{pre}.w"], 1, policy)
            x = torch.cat([x, h], dim=1)
        pre = f"blocks.{b}.trans"
        x = _conv(F.relu(_bn(x, p, f"{pre}.bn")), p[f"{pre}.w"], 1, policy)
        if min(x.shape[-2], x.shape[-1]) >= 2:
            x = F.avg_pool2d(x, 2, 2)
    feats = x.mean(dim=(-2, -1))
    for name, act in (("fc1", True), ("fc2", False)):
        pre = f"head.{name}"
        feats = _bn(precision.matmul(feats, p[f"{pre}.w"], policy)
                    + p[f"{pre}.b"], p, f"{pre}.bn")
        if act:
            feats = F.relu(feats)
    return feats


def loss(p, batch, m: dict, policy: str = "f32") -> torch.Tensor:
    """Mean BCE of the sigmoid outputs against one-hot labels."""
    x, y = batch
    z = logits(p, x, m, policy)
    onehot = F.one_hot(y.long(), m["n_classes"]).to(z.dtype)
    return -torch.mean(onehot * F.logsigmoid(z) + (1 - onehot) * F.logsigmoid(-z))


def macro_auc(probs: np.ndarray, labels: np.ndarray) -> float:
    """One-vs-rest macro AUC (Mann-Whitney U, ties averaged) over the
    classes present; a class with no negatives scores 0.5."""
    probs = np.asarray(probs, np.float64)
    labels = np.asarray(labels)
    aucs = []
    for c in range(probs.shape[1]):
        pos = labels == c
        if not pos.any():
            continue
        n_pos, n_neg = int(pos.sum()), int((~pos).sum())
        if n_neg == 0:
            aucs.append(0.5)
            continue
        s = probs[:, c]
        order = np.sort(s)
        lo = np.searchsorted(order, s, side="left")
        hi = np.searchsorted(order, s, side="right")
        rank = 0.5 * (lo + hi + 1)
        u = rank[pos].sum() - n_pos * (n_pos + 1) / 2.0
        aucs.append(u / (n_pos * n_neg))
    return float(np.mean(aucs)) if aucs else 0.5


@torch.no_grad()
def gate_metric(p, val, m: dict, policy: str = "f32") -> float:
    """Macro AUC of one node's params on its validation rows ``(x, y)``."""
    x, y = val
    probs = torch.sigmoid(logits(p, x, m, policy)).to(torch.float32)
    return macro_auc(probs.cpu().numpy(), y.cpu().numpy())
