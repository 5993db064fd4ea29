"""Early stopping on validation mIoU (own copy of the JAX package's
utils/early_stop.py).

Behavioral parity with reference utils/early_stop.py: stop after
``patience`` consecutive evaluations that fail to beat the best score by
at least ``min_improvement`` (the best only advances on a qualifying
improvement, and the stall counter resets when it does).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class EarlyStopChecker:
    patience: int
    min_improvement: float
    best_score: float = 0.0
    _stalled_evals: int = field(default=0, repr=False)

    def improved(self, score: float) -> bool:
        return score - self.best_score >= self.min_improvement

    def __call__(self, score: float) -> bool:
        """Record one evaluation; True means training should stop now."""
        if self.improved(score):
            self.best_score = score
            self._stalled_evals = 0
            return False
        self._stalled_evals += 1
        return self._stalled_evals >= self.patience
