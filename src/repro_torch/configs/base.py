"""Model, swarm and training configs: own copies of ``repro.configs.base``'s
:class:`ModelConfig`, :class:`SwarmConfig` and :class:`TrainConfig` (same
field names, defaults and properties; the tests hold each against its
original), and of its input shapes (:class:`ShapeConfig`,
:data:`INPUT_SHAPES`, :data:`SHAPES_BY_NAME`), which the dry run
(`repro_torch.launch.dryrun`) places on the production mesh."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description for the LM families (dense, moe, ssm,
    hybrid, vlm, audio). Frozen, so it hashes."""

    name: str = "unnamed"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio (enc-dec)
    source: str = ""       # citation for the config numbers

    # transformer backbone
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1000
    head_dim: int = 0          # 0 -> d_model // n_heads
    activation: str = "swiglu"  # swiglu | sq_relu | gelu
    use_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_seq_len: int = 524_288
    logit_softcap: float = 0.0
    # attention variant
    sliding_window: int = 0     # 0 = full attention; >0 = window size
    attn_every: int = 0         # hybrid/SWA: full-attn every k-th layer (0=never)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_heads: int = 0          # 0 -> derived: d_inner // ssm_head_dim
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    ssm_groups: int = 1

    # enc-dec (audio family)
    n_enc_layers: int = 0       # >0 enables encoder-decoder
    enc_seq_len: int = 0        # encoder (frame) length for dry-run specs

    # multimodal frontends (stubs)
    n_patches: int = 0          # vlm: number of image patch embeddings
    frontend_dim: int = 0       # raw embedding dim out of the stub frontend

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # dry-run: unroll scan-over-layers so cost_analysis counts every layer
    unroll_layers: bool = False
    # Megatron-style vocab padding so embedding/logits shard evenly
    vocab_pad_to: int = 256

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p if p else self.vocab_size

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or (self.d_inner // self.ssm_head_dim)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd, nh, nkv = self.head_dim, self.n_heads, self.n_kv_heads
        attn = d * hd * (nh + 2 * nkv) + nh * hd * d
        if self.activation == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.family in ("moe",):
            fe = self.d_ff_expert or f
            mlp = self.n_experts * (3 * d * fe) + d * self.n_experts
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            di, ns, nh_s = self.d_inner, self.ssm_state, self.n_ssm_heads
            g = self.ssm_groups
            zx = d * (2 * di + 2 * g * ns + nh_s)
            ssm = zx + self.conv_width * (di + 2 * g * ns) + nh_s * 2 + di * d + di
            if self.family == "ssm":
                attn, mlp = 0, 0
        block = attn + mlp + ssm + 2 * d
        n_blocks = self.n_layers + self.n_enc_layers
        cross = 0
        if self.is_encdec:
            cross = self.n_layers * (d * hd * (nh + 2 * nkv) + nh * hd * d + d)
        emb = v * d * (1 if self.tie_embeddings else 2)
        front = 0
        if self.frontend_dim:
            front = self.frontend_dim * d + d  # projector
        return emb + n_blocks * block + cross + front

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d, fe = self.d_model, (self.d_ff_expert or self.d_ff)
        total = self.param_count()
        all_experts = self.n_layers * self.n_experts * 3 * d * fe
        active = self.n_layers * self.top_k * 3 * d * fe
        return total - all_experts + active

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class SwarmConfig:
    """P2P-SL: the paper's technique as a first-class feature.

    ``payload="lora"`` (the heterogeneous model zoo: the state is the
    shared adapter payload) and ``lora_only`` with ``payload="full"`` (the
    sync carves the adapter leaves out of a full state, e.g. the LoRA'd LM
    of ``repro_torch.launch.train --lora``) are both ported.
    """

    n_nodes: int = 4
    sync_every: int = 10          # steps between peer exchanges (paper: 3 epochs)
    topology: str = "ring"        # ring | full | dynamic
    merge: str = "fedavg"         # mean | fedavg | fisher | gradmatch
    lora_only: bool = True        # paper: exchange LoRA-adapter weights only
    payload: str = "full"         # full | lora (heterogeneous swarm)
    lora_rank: int = 16
    lora_alpha: float = 32.0
    val_threshold: float = 0.8    # paper: validation-based acceptance at 80%
    gate_metric: str = "auc"      # gate: auc | accuracy | f1 | sensitivity
    self_weight: float = 0.5      # gossip self-mixing weight (ring)
    fisher_decay: float = 0.95    # EMA decay of the importance stats
    overlap_sync: bool = False    # stale-by-one double-buffered round overlap
    wire_dtype: str = "f32"       # f32 | bf16 | int8 sync wire
    wire_block: int = 512         # elements per int8 scale block (mult. of 128)
    intra_pod_cost: float = 1.0
    cross_pod_cost: float = 1.0
    # minimum number of active nodes for a sync to commit (0 disables)
    quorum: int = 0
    # minimum gate metric every active site's merged candidate must clear
    # for the round to commit (0.0 disables)
    fairness_floor: float = 0.0
    seed: int = 0


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32          # global
    seq_len: int = 128
    lr: float = 1e-4
    weight_decay: float = 1e-4    # paper: AdamW wd 1e-4
    schedule: str = "cosine"      # cosine | wsd | const
    warmup_steps: int = 100
    max_steps: int = 1000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    early_stop_patience: int = 5  # paper: patience of five
    remat: bool = True
    accum_steps: int = 1          # microbatch gradient accumulation
    seed: int = 0


@dataclass(frozen=True)
class ShapeConfig:
    """One of the 4 assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in INPUT_SHAPES}
