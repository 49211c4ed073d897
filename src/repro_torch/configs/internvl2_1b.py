"""InternVL2-1B: InternViT-300M frontend (STUB per carve-out) + InternLM2-1.8B-
style language backbone [arXiv:2404.16821]. Copy of
``repro.configs.internvl2_1b``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm", source="arXiv:2404.16821",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab_size=151_655, head_dim=64, activation="swiglu", rope_theta=1e6,
    n_patches=256, frontend_dim=1024,  # InternViT hidden size
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
