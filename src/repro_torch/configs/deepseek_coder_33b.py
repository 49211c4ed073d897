"""DeepSeek-Coder-33B: llama-arch dense, GQA kv=8 [arXiv:2401.14196]. Copy of
``repro.configs.deepseek_coder_33b``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense", source="arXiv:2401.14196",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=19_200,
    vocab_size=32_256, head_dim=128, activation="swiglu",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
