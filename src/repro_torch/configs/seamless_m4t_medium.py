"""SeamlessM4T-medium: speech encoder-decoder; mel+conv frontend is a STUB per
the carve-out (the model consumes precomputed frame embeddings)
[arXiv:2308.11596]. Copy of
``repro.configs.seamless_m4t_medium``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio", source="arXiv:2308.11596",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256_206, head_dim=64, activation="gelu",
    enc_seq_len=1024, frontend_dim=512,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
