"""The port's hand-written CUDA kernels (``repro_torch/csrc/*.cu``).

``LAUNCHES`` counts each kernel's launches (per form) that ran on the card,
so a run can show that its path went through the kernels. The wrapper adds
one where it launches its kernel, and nowhere else; a call on a CPU tensor
takes the plain version and counts nothing.

Under a captured CUDA graph (`repro_torch.launch.capture`) a wrapper is
called once, at capture, and the capture runs nothing on the card. So a
captured program records the ``LAUNCHES`` delta of its capture, takes it
out again when the capture ends, and adds it back at every replay: the
counts still mean launches that ran on the card (warm-up passes, eager
calls and replays), never recorded ones.
"""

#: kernel launches per kernel and form that ran on the card
LAUNCHES = {"fused_merge_all": 0, "fused_merge_all_imp": 0,
            "fused_quant_merge_all": 0, "fused_quant_merge_all_imp": 0,
            "lora_matmul": 0, "fused_merge": 0, "flash_attention": 0,
            "ssd_scan": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
