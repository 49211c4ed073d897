"""Swarm and training configs: own copies of ``repro.configs.base``'s
:class:`SwarmConfig` and :class:`TrainConfig` (same field names and defaults;
the tests hold the two against each other). The model configs of the LM
families are not part of this slice."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SwarmConfig:
    """P2P-SL: the paper's technique as a first-class feature.

    ``payload="lora"`` (the heterogeneous model zoo: the state is the
    shared adapter payload) is ported. ``lora_only`` with ``payload="full"``
    (carving adapters out of a full state) waits for the LM/trainer slice
    and raises ``NotImplementedError`` when the sync that needs it runs.
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
