"""WarmupMultiStepLR as a function of the optimizer step (counterpart of
`rcmvsnet_tpu/train/schedule.py` with the reference's warm-up): linear
warm-up from WARMUP_FACTOR over WARMUP_ITERS steps, then ×gamma at each
milestone step."""
from __future__ import annotations

from typing import Sequence

WARMUP_FACTOR = 1.0 / 3.0
WARMUP_ITERS = 500


def warmup_multistep_schedule(base_lr: float, milestones: Sequence[int],
                              gamma: float = 0.5):
    milestones = sorted(milestones)

    def schedule(step: int) -> float:
        alpha = min(max(step / WARMUP_ITERS, 0.0), 1.0)
        factor = WARMUP_FACTOR * (1 - alpha) + alpha
        warmup = factor if step < WARMUP_ITERS else 1.0
        decay = gamma ** sum(step >= m for m in milestones)
        return base_lr * warmup * decay

    return schedule
