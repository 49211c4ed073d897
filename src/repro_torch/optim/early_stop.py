"""Early stopping with patience (paper: patience of five epochs)."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class EarlyStopper:
    patience: int = 5
    mode: str = "max"  # max: metric is accuracy/AUC; min: loss
    best: float = field(default=None)  # type: ignore
    bad_rounds: int = 0
    stopped: bool = False

    def update(self, metric: float) -> bool:
        """Returns True if training should stop."""
        better = (self.best is None
                  or (metric > self.best if self.mode == "max" else metric < self.best))
        if better:
            self.best, self.bad_rounds = float(metric), 0
        else:
            self.bad_rounds += 1
            if self.bad_rounds >= self.patience:
                self.stopped = True
        return self.stopped
