"""The port's hand-written CUDA kernels (``repro_torch/csrc/*.cu``).

``LAUNCHES`` counts each kernel's launches (per form), one count added by
the wrapper where it launches the kernel and nowhere else, so a run can show
that its path went through the kernels; a call on a CPU tensor takes the
plain version and counts nothing.
"""

#: kernel launches per kernel and form, counted where each is launched
LAUNCHES = {"fused_merge_all": 0, "fused_merge_all_imp": 0,
            "fused_quant_merge_all": 0, "fused_quant_merge_all_imp": 0,
            "lora_matmul": 0, "fused_merge": 0, "flash_attention": 0,
            "ssd_scan": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
