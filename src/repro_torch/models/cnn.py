"""The paper's diagnostic model: DenseNet-style encoder + classifier head.

Port of ``repro.models.cnn`` (§3.3): four dense blocks of four 3×3 conv
layers, transitions of 1×1 convs with 2×2 average pooling, a global average
pool to ``feat_dim`` features, then FC(→hidden)+BN+ReLU and FC(→3)+BN, with a
sigmoid applied at the loss. BatchNorm runs on batch statistics (biased
variance, no running averages), as in the reference.

:class:`HistoCNN` is an ``nn.Module`` that only fixes the structure and the
parameter names; it is built on the ``meta`` device and called functionally
(:func:`forward_cnn` → ``torch.func.functional_call``) with parameters taken
from the flat swarm state. Inputs are NHWC at the API, as in the reference.

Padding: JAX's ``"SAME"`` puts the odd element of a stride-2 window's padding
on the high side — the 7×7/2 stem conv pads (2, 3) at 224 px and the 3×3/2
max pool (0, 1) at 112 px — while torch pads symmetrically. Both are padded
explicitly here (:func:`same_pads`).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's ``"SAME"`` for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x, w, stride: int = 1):
    """NCHW conv with OIHW weights and ``"SAME"`` padding."""
    kh, kw = w.shape[-2], w.shape[-1]
    ph = same_pads(x.shape[-2], kh, stride)
    pw = same_pads(x.shape[-1], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)


def max_pool_same(x, k: int = 3, stride: int = 2):
    """``reduce_window(max, -inf)`` with ``"SAME"`` padding."""
    ph = same_pads(x.shape[-2], k, stride)
    pw = same_pads(x.shape[-1], k, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=-math.inf)
    return F.max_pool2d(x, k, stride)


def batchnorm(x, scale, bias, eps: float = 1e-5):
    """Batch-statistics BN over every dim but the channel dim 1 (biased
    variance, as ``jnp.var``)."""
    dims = (0,) + tuple(range(2, x.dim()))
    mu = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, correction=0, keepdim=True)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    xn = (x - mu) * torch.rsqrt(var + eps)
    return xn * scale.reshape(shape) + bias.reshape(shape)


class _BN(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.bias = nn.Parameter(torch.empty(c, device="meta"))
        self.scale = nn.Parameter(torch.empty(c, device="meta"))

    def forward(self, x):
        return batchnorm(x, self.scale, self.bias)


class _ConvBN(nn.Module):
    """A BN (pre-activation) and a conv weight ``w`` [O, I, kh, kw]; the stem
    applies them conv-first, dense layers and transitions BN-first."""

    def __init__(self, c_bn, cin, cout, k):
        super().__init__()
        self.bn = _BN(c_bn)
        self.w = nn.Parameter(torch.empty(cout, cin, k, k, device="meta"))


class _Block(nn.Module):
    def __init__(self, layers, trans):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.trans = trans


class _FC(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.b = nn.Parameter(torch.empty(cout, device="meta"))
        self.bn = _BN(cout)
        self.w = nn.Parameter(torch.empty(cin, cout, device="meta"))

    def forward(self, x):
        return self.bn(x @ self.w + self.b)


class _Head(nn.Module):
    def __init__(self, feat_dim, hidden, n_classes):
        super().__init__()
        self.fc1 = _FC(feat_dim, hidden)
        self.fc2 = _FC(hidden, n_classes)


class HistoCNN(nn.Module):
    """DenseNet-lite: ``n_blocks`` dense blocks × ``layers_per_block`` convs.

    Parameter names mirror the reference tree (``stem.w``,
    ``blocks.0.layers.1.bn.scale``, ``head.fc1.w``); conv weights are OIHW,
    FC weights [in, out] as in the reference.
    """

    def __init__(self, *, growth=32, stem=64, n_blocks=4, layers_per_block=4,
                 feat_dim=1152, hidden=512, n_classes=3):
        super().__init__()
        self.stem = _ConvBN(stem, 3, stem, 7)
        c = stem
        blocks = []
        for b in range(n_blocks):
            layers = []
            for _ in range(layers_per_block):
                layers.append(_ConvBN(c, c, growth, 3))
                c += growth
            trans_out = c // 2 if b < n_blocks - 1 else feat_dim
            blocks.append(_Block(layers, _ConvBN(c, c, trans_out, 1)))
            c = trans_out
        self.blocks = nn.ModuleList(blocks)
        self.head = _Head(feat_dim, hidden, n_classes)

    def forward(self, images, return_features: bool = False):
        """images [B,H,W,3] -> logits [B,3] (sigmoid applied at the loss)."""
        x = images.permute(0, 3, 1, 2)
        x = conv2d(x, self.stem.w, stride=2)
        x = F.relu(self.stem.bn(x))
        x = max_pool_same(x, 3, 2)
        for block in self.blocks:
            for layer in block.layers:
                h = conv2d(F.relu(layer.bn(x)), layer.w)
                x = torch.cat([x, h], dim=1)  # dense connectivity
            x = conv2d(F.relu(block.trans.bn(x)), block.trans.w)
            if min(x.shape[-2], x.shape[-1]) >= 2:  # keep ≥1×1 for small images
                x = F.avg_pool2d(x, 2, 2)
        feats = x.mean(dim=(-2, -1))  # global average pool -> [B, feat_dim]
        z = F.relu(self.head.fc1(feats))
        logits = self.head.fc2(z)
        if return_features:
            return logits, z
        return logits


def init_cnn(generator: torch.Generator, model: HistoCNN
             ) -> Dict[str, torch.Tensor]:
    """He-normal conv/FC weights, zero biases, unit BN scales (the
    reference's ``init_cnn`` scheme; the numbers differ, since the draws come
    from a ``torch.Generator``). Returns {path: CPU tensor}."""
    out = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "w":
            fan_in = (p.shape[1] * p.shape[2] * p.shape[3] if p.dim() == 4
                      else p.shape[0])
            out[name] = (torch.randn(tuple(p.shape), generator=generator)
                         * math.sqrt(2.0 / fan_in))
        elif leaf == "scale":
            out[name] = torch.ones(tuple(p.shape))
        else:
            out[name] = torch.zeros(tuple(p.shape))
    return out


def forward_cnn(model: HistoCNN, params: Dict[str, torch.Tensor], images, *,
                return_features: bool = False):
    """Functional forward: ``model``'s structure with ``params`` substituted."""
    return torch.func.functional_call(model, params, (images,),
                                      {"return_features": return_features})


def bce_loss(logits, labels_onehot):
    """Paper head uses sigmoid -> multi-label BCE over the 3 classes."""
    logp = F.logsigmoid(logits)
    lognp = F.logsigmoid(-logits)
    return -torch.mean(labels_onehot * logp + (1 - labels_onehot) * lognp)


def one_hot(labels, n_classes: int = 3):
    """Float one-hot by comparison (``F.one_hot`` inspects the data, which
    ``torch.func.vmap`` cannot batch)."""
    classes = torch.arange(n_classes, device=labels.device)
    return (labels[..., None] == classes).to(torch.float32)
