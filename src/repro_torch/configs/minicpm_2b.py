"""MiniCPM-2B: llama-like arch; signature WSD LR schedule [arXiv:2404.06395].
Copy of ``repro.configs.minicpm_2b``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense", source="arXiv:2404.06395",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab_size=122_753, head_dim=64, activation="swiglu", tie_embeddings=True,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
