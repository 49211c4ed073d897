"""Architecture config registry of the port: own copies of the reference's
ten configs (``repro.configs``), one module each, in the reference's
registry order. ``get_config``, ``smoke_variant`` and ``adapt_for_shape``
are copies of the reference's."""
from __future__ import annotations

from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES, SHAPES_BY_NAME, ModelConfig, ShapeConfig, SwarmConfig,
    TrainConfig,
)
from repro_torch.configs.command_r_plus_104b import CONFIG as _commandr
from repro_torch.configs.deepseek_coder_33b import CONFIG as _deepseek
from repro_torch.configs.granite_moe_3b import CONFIG as _granite
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba
from repro_torch.configs.internvl2_1b import CONFIG as _internvl2
from repro_torch.configs.mamba2_370m import CONFIG as _mamba2
from repro_torch.configs.minicpm_2b import CONFIG as _minicpm
from repro_torch.configs.nemotron_4_15b import CONFIG as _nemotron
from repro_torch.configs.phi35_moe_42b import CONFIG as _phi35
from repro_torch.configs.seamless_m4t_medium import CONFIG as _seamless

ARCHS = {c.name: c for c in [
    _internvl2, _commandr, _hymba, _mamba2, _nemotron,
    _phi35, _minicpm, _seamless, _deepseek, _granite,
]}
ARCH_IDS = tuple(ARCHS)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: ≤2 layers, d_model ≤ 512, ≤4 experts —
    runs a real forward on the CPU."""
    nh = max(2, min(4, cfg.n_heads))
    ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    nkv = max(1, nh // ratio)
    upd = dict(
        n_layers=2, d_model=256, n_heads=nh, n_kv_heads=nkv, head_dim=64,
        d_ff=0 if cfg.family == "ssm" else 512, vocab_size=512,
        max_seq_len=4096, param_dtype="float32", compute_dtype="float32",
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
        attn_every=min(cfg.attn_every, 2) if cfg.attn_every else 0,
    )
    if cfg.family == "moe":
        upd.update(n_experts=4, top_k=min(cfg.top_k, 2), d_ff_expert=128)
    if cfg.family in ("ssm", "hybrid"):
        upd.update(ssm_state=min(cfg.ssm_state, 16), ssm_chunk=16,
                   ssm_head_dim=64, ssm_expand=2)
    if cfg.is_encdec:
        upd.update(n_enc_layers=2, enc_seq_len=16, frontend_dim=32)
    if cfg.family == "vlm":
        upd.update(n_patches=8, frontend_dim=32)
    return cfg.replace(name=cfg.name + "-smoke", **upd)


def adapt_for_shape(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Per-shape architecture adaptation: ``long_500k`` on a full-attention
    arch switches on the sliding-window variant (window 4096, periodic
    global layers off) so the attention is sub-quadratic; ssm and hybrid
    archs run natively."""
    if shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm",
                                                    "audio"):
        if cfg.sliding_window == 0:
            return cfg.replace(sliding_window=4096, attn_every=0)
    return cfg
