"""Model zoo: heterogeneous frozen backbones + ONE shared LoRA'd head.

Port of ``repro.models.zoo``. Each hospital site keeps its own frozen
feature extractor; the swarm shares a small head, a LoRA-adapted projection
over a ``feat_dim`` feature interface plus the decoder layer. The shared
payload is the whole swarm state in ``cfg.payload = "lora"`` mode:

  node i state row = flatten_payload({"backbone": bb_i, "head": head},
                                     payload_select)
                   = {"head/out/b", "head/out/w",
                      "head/proj/lora_A", "head/proj/lora_B",
                      "head/proj/lora_scale"}

Backbone families: DenseNet-lite encoders at two scales (the port's
:class:`~repro_torch.models.cnn.HistoCNN`, whose feature is the ReLU'd,
batch-normalised ``fc1`` output, built ``feat_dim`` wide) and MLP stacks.
Layouts are the reference's at the API: images NHWC, head and MLP weights
``[in, out]`` (``x @ W``), and the MLP flattens an image in (H, W, C) order,
so a carried first-layer weight means the same thing. A CNN backbone's
params are the ``{dotted path: tensor}`` dict :class:`HistoCNN` takes
(convs OIHW); `repro_torch.convert.zoo_node_from_reference` carries a
reference zoo node across. The head projection runs through
`repro_torch.kernels.lora_matmul.lora_apply`: the fused CUDA kernel on the
card, its plain version on the CPU.

The port's init draws from ``torch.Generator`` s, so its numbers differ from
the reference's ``jax.random`` draws by design; the parity tests carry the
reference's weights across instead.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.lora import (flatten_payload, inject_lora,
                                   is_adapter_path, unflatten_payload)
from repro_torch.kernels.lora_matmul import lora_apply
from repro_torch.models.cnn import HistoCNN, forward_cnn, init_cnn

DEFAULT_FAMILIES = ("densenet_s", "densenet_w", "mlp_deep", "mlp_wide")
# family → HistoCNN widths (its fc1, the feature, is built feat_dim wide)
CNN_FAMILIES = {
    "densenet_s": dict(growth=4, stem=8, n_blocks=2, layers_per_block=2,
                       feat_dim=24),
    "densenet_w": dict(growth=8, stem=16, n_blocks=2, layers_per_block=3,
                       feat_dim=40),
}
MLP_FAMILIES = {"mlp_deep": (64, 64), "mlp_wide": (128,)}


# ---------------------------------------------------------------------------
# backbone families (frozen, local, architecture-specific)
# ---------------------------------------------------------------------------

def cnn_model(family: str, feat_dim: int) -> HistoCNN:
    """The :class:`HistoCNN` structure of a DenseNet family."""
    return HistoCNN(hidden=feat_dim, **CNN_FAMILIES[family])


def _cnn_features(model: HistoCNN) -> Callable:
    def features(params, images):
        """DenseNet-lite features: the penultimate activation."""
        return forward_cnn(model, params, images, return_features=True)[1]

    return features


def _init_mlp(generator, *, image_size: int, feat_dim: int, widths):
    d = image_size * image_size * 3
    layers = []
    for w_out in tuple(widths) + (feat_dim,):
        layers.append({"w": torch.randn((d, w_out), generator=generator)
                       * math.sqrt(2.0 / d),
                       "b": torch.zeros((w_out,))})
        d = w_out
    return {"layers": layers}


def _mlp_features(params, images):
    x = images.reshape(images.shape[0], -1)      # NHWC: (H, W, C) order
    for layer in params["layers"]:
        x = F.relu(x @ layer["w"] + layer["b"])
    return x


def backbone_features(family: str, *, feat_dim: int) -> Callable:
    """``features_fn(params, images [B,H,W,3]) -> [B, feat_dim]`` of a
    family: the one interface every family honours."""
    if family in CNN_FAMILIES:
        return _cnn_features(cnn_model(family, feat_dim))
    if family in MLP_FAMILIES:
        return _mlp_features
    raise ValueError(f"unknown zoo family {family!r} "
                     f"(choose from {DEFAULT_FAMILIES})")


def build_backbone(family: str, generator: torch.Generator, *,
                   image_size: int, feat_dim: int):
    """``(frozen_params, features_fn)`` for one zoo family."""
    features = backbone_features(family, feat_dim=feat_dim)
    if family in CNN_FAMILIES:
        return init_cnn(generator, cnn_model(family, feat_dim)), features
    return (_init_mlp(generator, image_size=image_size, feat_dim=feat_dim,
                      widths=MLP_FAMILIES[family]), features)


# ---------------------------------------------------------------------------
# the shared head (what crosses the wire)
# ---------------------------------------------------------------------------

def init_head(generator: torch.Generator, *, feat_dim: int, hidden: int = 32,
              n_classes: int = 3, rank: int = 4, alpha: float = 8.0):
    """Shared head: LoRA'd projection (frozen base ``w``) + raw decoder
    layer, drawn from ONE generator shared by the swarm, so every node's
    payload row starts identical."""
    head = {
        "proj": {"w": torch.randn((feat_dim, hidden), generator=generator)
                 * math.sqrt(2.0 / feat_dim)},
        "out": {"w": torch.randn((hidden, n_classes), generator=generator)
                * math.sqrt(2.0 / hidden),
                "b": torch.zeros((n_classes,))},
    }
    return inject_lora(head, generator, rank=rank, alpha=alpha,
                       targets="proj")


def payload_select(path: str) -> bool:
    """The wire membership rule: LoRA adapters + the decoder ``out`` layer.
    The frozen ``proj`` base weight and every backbone leaf stay local."""
    return is_adapter_path(path) or path.startswith("head/out/")


def head_forward(head, feats):
    """``feats [B, feat_dim] -> logits [B, n_classes]`` through the fused
    base+LoRA matmul."""
    p = head["proj"]
    z = lora_apply(feats, p["w"], p["lora_A"], p["lora_B"], p["lora_scale"])
    z = F.relu(z)
    return z @ head["out"]["w"] + head["out"]["b"]


# ---------------------------------------------------------------------------
# zoo assembly
# ---------------------------------------------------------------------------

@dataclass
class ZooNode:
    """One heterogeneous site: frozen full-params template + features fn.

    ``template`` holds the node's backbone and the head (its frozen base
    included); the payload leaves are written into it at apply time.
    """

    family: str
    template: Any
    features: Callable

    def payload(self):
        """This node's wire payload (flat path-keyed dict, sorted)."""
        return flatten_payload(self.template, payload_select)

    def apply(self, payload, images):
        """Logits for ``images`` under ``payload`` (gradients flow through
        the payload leaves only: the frozen-backbone contract)."""
        full = unflatten_payload(payload, self.template)
        feats = self.features(full["backbone"], images)
        return head_forward(full["head"], feats)

    def to(self, device) -> "ZooNode":
        """The node with its template on ``device``."""
        def move(t):
            if isinstance(t, dict):
                return {k: move(v) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return type(t)(move(v) for v in t)
            return t.to(device)

        return ZooNode(self.family, move(self.template), self.features)


def build_zoo(generator: torch.Generator, n_nodes: int, *,
              families: Optional[Sequence[str]] = None, image_size: int = 16,
              feat_dim: int = 32, hidden: int = 32, n_classes: int = 3,
              rank: int = 4, alpha: float = 8.0) -> List[ZooNode]:
    """N heterogeneous nodes around one shared head (CPU tensors).

    ``families`` cycles over :data:`DEFAULT_FAMILIES` by default, so a
    4-node swarm gets four distinct backbone architectures. The backbones
    draw from ``generator`` in node order, then the head."""
    fams = tuple(families) if families else DEFAULT_FAMILIES
    backbones = [build_backbone(fams[i % len(fams)], generator,
                                image_size=image_size, feat_dim=feat_dim)
                 for i in range(n_nodes)]
    head = init_head(generator, feat_dim=feat_dim, hidden=hidden,
                     n_classes=n_classes, rank=rank, alpha=alpha)
    return [ZooNode(family=fams[i % len(fams)],
                    template={"backbone": bb, "head": head}, features=feats)
            for i, (bb, feats) in enumerate(backbones)]
