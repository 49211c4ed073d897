"""The paper's own model config: DenseNet-lite encoder (TorchXRayVision-style)
+ 3-class histopathology head (§3.3). Copy of ``repro.configs.paper_histo``."""
from dataclasses import dataclass


@dataclass(frozen=True)
class HistoCNNConfig:
    image_size: int = 32          # paper: 224; reduced for CPU experiments
    n_classes: int = 3
    growth: int = 8
    stem: int = 16
    feat_dim: int = 96            # paper: 1152 (scales with image size)
    hidden: int = 32              # paper: 512
    n_blocks: int = 4             # paper: four encoder modules
    layers_per_block: int = 4     # paper: four layers each


CONFIG = HistoCNNConfig()
PAPER_FULL = HistoCNNConfig(image_size=224, feat_dim=1152, hidden=512,
                            growth=32, stem=64)
