"""PyTorch/CUDA port of the P2P swarm-learning system.

The JAX package ``repro`` stays the reference; this package mirrors its module
names (``repro_torch.core.session`` ↔ ``repro.core.session`` and so on) and
imports nothing of it. The swarm state lives in contiguous ``[N, P]`` f32
buffers (:mod:`repro_torch.core.flat`), the gated commit runs in a
hand-written Hopper kernel (:mod:`repro_torch.kernels.fused_merge`), and the
model zoo's shared LoRA head in another (:mod:`repro_torch.kernels.
lora_matmul`).

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the
    CPU. Asking for CUDA on a machine without a card raises; there is no
    silent fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
