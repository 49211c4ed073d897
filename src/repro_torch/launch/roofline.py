"""Roofline terms of one rank's step on an NVIDIA H100: the counterpart of
``repro.launch.hlo_stats``.

The reference parses post-partitioning HLO text for its collectives and
prices them at a TPU's rates. The port has no HLO: a dry run
(`repro_torch.launch.dryrun`) counts a rank's FLOPs and bytes op by op,
and its collectives count their own bytes by kind (`repro_torch.core.
gossip`), each under the link class of its group: ``node`` where every
rank of the group sits in one 8-GPU node (NVLink), ``network`` where the
group spans nodes (InfiniBand; the slowest hop bounds the collective, so
all of its bytes price at that rate). A kind is priced by its group, not
by its name: the ``dp`` profile's ``grad_replica`` (over the model group)
and ``zero3``'s ``cache_gather`` alike.

    compute term    = tensor-core FLOPs / bf16 rate + f32 FLOPs / f32 rate
    memory term     = bytes / HBM rate
    collective term = node bytes / NVLink rate + network bytes / IB rate

All three are one rank's seconds: the counts are the rank's own. The rates
are the published figures of the **NVIDIA H100 SXM5 80GB at 700 W**: dense
bf16 989 TFLOP/s on the tensor cores, f32 67 TFLOP/s on the CUDA cores,
HBM3 3.35 TB/s, NVLink 4 450 GB/s a direction between two GPUs of one
node, and 50 GB/s a GPU across nodes (one 400 Gb/s NDR InfiniBand link a
GPU). No TPU constant carries over.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable

#: the card the rates are for
CARD = "NVIDIA H100 SXM5 80GB, 700 W"
BF16_FLOPS = 989e12      # dense bf16 tensor-core FLOP/s
F32_FLOPS = 67e12        # f32 FLOP/s on the CUDA cores (TF32 off)
HBM_BW = 3.35e12         # HBM3 bytes/s
NVLINK_BW = 450e9        # bytes/s a direction, GPU to GPU within a node
NETWORK_BW = 50e9        # bytes/s a GPU across nodes (400 Gb/s NDR IB)
HBM_BYTES = 80e9         # the card's memory, as published (80 GB)
NODE_GPUS = 8            # GPUs a node (one NVLink domain)


def link_of(ranks: Iterable[int]) -> str:
    """``"node"`` where every global rank of a group sits in one node of
    :data:`NODE_GPUS`, else ``"network"``."""
    return "node" if len({r // NODE_GPUS for r in ranks}) <= 1 else \
        "network"


@dataclass
class Roofline:
    """One rank's roofline: ``hlo_flops`` its FLOPs (``f32_flops`` of them
    at the f32 rate, the rest on the tensor cores), ``hlo_bytes`` the bytes
    its ops and kernels move, ``coll_bytes`` what it hands to collectives
    (``coll_network`` of them over groups that span nodes),
    ``model_flops`` its share of the model's analytic FLOPs. The field
    names are the reference's."""

    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    model_flops: float = 0.0
    f32_flops: float = 0.0
    coll_network: float = 0.0
    coll_detail: Dict = field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        return ((self.hlo_flops - self.f32_flops) / BF16_FLOPS
                + self.f32_flops / F32_FLOPS)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        node = self.coll_bytes - self.coll_network
        return node / NVLINK_BW + self.coll_network / NETWORK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """The rank's device-time floor: the larger of the compute and
        memory terms (the collectives may overlap them)."""
        return max(self.compute_s, self.memory_s)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "card": CARD,
            "hlo_flops": self.hlo_flops, "f32_flops": self.f32_flops,
            "hlo_bytes": self.hlo_bytes, "coll_bytes": self.coll_bytes,
            "coll_network": self.coll_network,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "bound_s": self.bound_s,
            "model_flops": self.model_flops, "useful_ratio": self.useful_ratio,
            "coll_detail": self.coll_detail,
        }
