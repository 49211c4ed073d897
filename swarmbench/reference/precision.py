"""Precision policies of the plain reference.

The reference computes in float32 with TF32 off (:func:`exact`). A control
is the same reference computed one step below the precision its
configuration states: every matrix product and convolution takes its
inputs rounded to that precision and gives its output rounded to bfloat16,
as a mixed-precision kernel would, while the rest stays float32.

* ``f32``: nothing rounded (the reference itself).
* ``bf16``: inputs and outputs rounded to bfloat16 (the control of a
  configuration that states float32 with TF32 convolutions).
* ``fp8``: inputs scaled per tensor to the e4m3 range and rounded to
  float8_e4m3fn, outputs rounded to bfloat16 (the control of a bfloat16
  configuration).
"""
from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact():
    """TF32 off for matrix products and cuDNN convolutions, restored after."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def round_to(t: torch.Tensor, policy: str) -> torch.Tensor:
    """``t`` (float32) rounded as ``policy`` rounds an operand, kept float32.
    Rounding passes the gradient straight through."""
    if policy == "f32":
        return t
    if policy == "bf16":
        q = t.to(torch.bfloat16).to(torch.float32)
    elif policy == "fp8":
        q = _fp8(t)
    else:
        raise ValueError(f"unknown precision policy {policy!r}")
    return t + (q - t).detach()


def round_out(t: torch.Tensor, policy: str) -> torch.Tensor:
    """A product's output as the policy's kernel would store it."""
    if policy == "f32":
        return t
    q = t.to(torch.bfloat16).to(torch.float32)
    return t + (q - t).detach()


def matmul(x: torch.Tensor, w: torch.Tensor, policy: str) -> torch.Tensor:
    return round_out(round_to(x, policy) @ round_to(w, policy), policy)
