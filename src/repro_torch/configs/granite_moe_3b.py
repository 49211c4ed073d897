"""Granite-MoE 3B (800M active): fine-grained experts, top-8 of 40
[hf:ibm-granite/granite-3.0-1b-a400m-base].

NOTE: the assignment line reads "MoE 40e top-8 — 32 experts top-8"; the config
field (40 experts) wins, discrepancy recorded in DESIGN.md §Arch-applicability.
Copy of ``repro.configs.granite_moe_3b``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab_size=49_155, head_dim=64, activation="swiglu",
    n_experts=40, top_k=8, d_ff_expert=512, capacity_factor=1.25,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
