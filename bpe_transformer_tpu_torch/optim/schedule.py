"""Learning-rate schedule (port of ``bpe_transformer_tpu/optim/schedule.py``):
linear warmup to ``max_lr`` at ``warmup_iters``, cosine decay to ``min_lr``
at ``cosine_cycle_iters``, constant after."""

from __future__ import annotations

import math


def cosine_schedule(
    it: int,
    max_learning_rate: float,
    min_learning_rate: float,
    warmup_iters: int,
    cosine_cycle_iters: int,
) -> float:
    """The schedule's value at iteration ``it`` (a Python float)."""
    if it < warmup_iters:
        return it / warmup_iters * max_learning_rate
    if it <= cosine_cycle_iters:
        progress = (it - warmup_iters) / (cosine_cycle_iters - warmup_iters)
        return min_learning_rate + 0.5 * (1.0 + math.cos(math.pi * progress)) * (
            max_learning_rate - min_learning_rate
        )
    return min_learning_rate
