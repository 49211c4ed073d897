"""Mamba2-370M: attention-free SSD (state-space duality) [arXiv:2405.21060].
Copy of ``repro.configs.mamba2_370m``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm", source="arXiv:2405.21060",
    n_layers=48, d_model=1024, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab_size=50_280, head_dim=64, tie_embeddings=True,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256, ssm_groups=1,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
