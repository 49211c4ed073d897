"""Nemotron-4 15B: GQA + squared-ReLU MLP [arXiv:2402.16819]. Copy of
``repro.configs.nemotron_4_15b``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense", source="arXiv:2402.16819",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=24_576,
    vocab_size=256_000, head_dim=128, activation="sq_relu",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
