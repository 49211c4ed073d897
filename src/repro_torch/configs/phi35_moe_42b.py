"""Phi-3.5-MoE 42B (6.6B active): 16 experts, top-2 routing
[hf:microsoft/Phi-3.5-MoE-instruct]. Copy of
``repro.configs.phi35_moe_42b``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
    vocab_size=32_064, head_dim=128, activation="swiglu",
    n_experts=16, top_k=2, d_ff_expert=6400, capacity_factor=1.25,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
