"""Learning-rate schedules as step -> multiplier functions, for
``torch.optim.lr_scheduler.LambdaLR`` stepped once per training step
(counterpart of the JAX package's ``train/schedules.py``).
"""

from __future__ import annotations

import math
from typing import Callable


def cosine_warmup(num_warmup_steps: int, num_training_steps: int,
                  min_lr_ratio: float = 0.1) -> Callable[[int], float]:
    """Linear warmup from 0 (step 0 gives 0, as optax's schedule does),
    then cosine decay floored at ``min_lr_ratio``."""
    def multiplier(step: int) -> float:
        if step < num_warmup_steps:
            return step / max(1.0, num_warmup_steps)
        progress = (step - num_warmup_steps) / max(
            1.0, num_training_steps - num_warmup_steps)
        return max(min_lr_ratio, 0.5 * (1.0 + math.cos(math.pi * progress)))
    return multiplier
