"""Learning-rate schedules as functions of the step count
(``training/lr_schedule.py`` of the JAX package)."""
from __future__ import annotations


def linear_warmup(base_lr: float, warmup_iters: int):
    """lr = base * min(1, (count + 1) / warmup) (``lr_schedule.py:11-20``)."""

    def schedule(step):
        if warmup_iters <= 0:
            return base_lr
        return base_lr * min(1.0, (step + 1) / warmup_iters)

    return schedule
