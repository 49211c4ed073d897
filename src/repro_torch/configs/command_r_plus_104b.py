"""Command R+ 104B: GQA, no-bias dense transformer
[hf:CohereForAI/c4ai-command-r-v01]. Copy of
``repro.configs.command_r_plus_104b``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    source="hf:CohereForAI/c4ai-command-r-v01",
    n_layers=64, d_model=12_288, n_heads=96, n_kv_heads=8, d_ff=33_792,
    vocab_size=256_000, head_dim=128, activation="swiglu", use_bias=False,
    rope_theta=75e6, param_dtype="bfloat16", compute_dtype="bfloat16",
)
