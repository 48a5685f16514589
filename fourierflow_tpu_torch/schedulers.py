"""Learning-rate schedules (counterpart of ``fourierflow_tpu/schedulers.py``).

A schedule maps the optimizer's update count to a learning rate. The first
update uses ``schedule(0)``, as optax counts; ``routines.base.make_optimizer``
drives it through ``torch.optim.lr_scheduler.LambdaLR``, whose first step
uses the same value. Only ``cosine_with_warmup`` (the flagship's schedule)
is ported so far.
"""

import math

__all__ = ["cosine_with_warmup"]


def cosine_with_warmup(lr: float, num_warmup_steps: int, num_training_steps: int,
                       num_cycles: float = 0.5):
    """Linear warm-up from 0 to ``lr``, then cosine decay to 0."""

    def schedule(step: int) -> float:
        step = float(step)
        if step < num_warmup_steps:
            return lr * step / max(1.0, num_warmup_steps)
        progress = (step - num_warmup_steps) / max(1.0, num_training_steps - num_warmup_steps)
        return lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress)))

    return schedule
