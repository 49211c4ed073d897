"""The dispatch layer over the port's kernels: the counterpart of the
reference's ``repro.kernels.ops`` (``attention_op``, ``merge_op``,
``lora_op``, ``ssd_op``), without its ``interpret`` argument: each wrapper
launches its CUDA kernel for a CUDA tensor and computes its plain version
for a CPU tensor. ``attention_op`` and ``ssd_op`` go through the kernels'
``torch.autograd.Function`` classes (`flash_apply`, `ssd_apply`), so the model's
prefill form has a gradient and runs under ``torch.func.vmap``: the LM
trainer differentiates through them."""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_apply
from repro_torch.kernels.fused_merge import fused_merge
from repro_torch.kernels.lora_matmul import lora_matmul
from repro_torch.kernels.ssd_scan import ssd_apply


def attention_op(q, k, v, *, causal=True, window=0, q_off=0):
    return flash_apply(q, k, v, causal=causal, window=window, q_off=q_off)


def merge_op(stacked, weights, self_idx, gate):
    return fused_merge(stacked, weights, self_idx, gate)


def lora_op(x, w, a, b, scale):
    return lora_matmul(x, w, a, b, scale)


def ssd_op(x, dt, a_log, bmat, cmat, *, chunk=256):
    return ssd_apply(x, dt, a_log, bmat, cmat, chunk=chunk)
