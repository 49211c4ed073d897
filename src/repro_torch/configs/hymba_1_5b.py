"""Hymba-1.5B: hybrid heads — attention ∥ mamba(SSD) in every block, SWA with
periodic global-attention layers [arXiv:2411.13676]. Copy of
``repro.configs.hymba_1_5b``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", source="arXiv:2411.13676",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab_size=32_001, head_dim=64, activation="swiglu",
    sliding_window=1024, attn_every=8,  # global attention every 8th layer
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
