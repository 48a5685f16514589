"""Learning-rate schedules (counterpart of ``fourierflow_tpu/schedulers.py``).

A schedule maps the optimizer's update count to a learning rate. The first
update uses ``schedule(0)``, as optax counts; ``routines.base.make_optimizer``
drives it through ``torch.optim.lr_scheduler.LambdaLR``, whose first step
uses the same value. A config node with ``interval: epoch`` gets
``steps_per_epoch`` from ``commands/train.py`` (``step_lr``).
"""

import math

__all__ = ["cosine_with_warmup", "linear_with_warmup", "exponential_with_warmup", "step_lr",
           "swa_lr"]


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


def linear_with_warmup(lr: float, num_warmup_steps: int, num_training_steps: int):
    """Linear warm-up from 0 to ``lr``, then linear decay to 0."""

    def schedule(step: int) -> float:
        step = float(step)
        if step < num_warmup_steps:
            return lr * step / max(1.0, num_warmup_steps)
        return lr * max(0.0, (num_training_steps - step)
                        / max(1.0, num_training_steps - num_warmup_steps))

    return schedule


def exponential_with_warmup(lr: float, num_warmup_steps: int, decay_rate: float = 0.5,
                            decay_steps: int = 10000):
    """Linear warm-up, then ``lr * decay_rate ** ((step - warmup) / decay_steps)``."""

    def schedule(step: int) -> float:
        step = float(step)
        if step < num_warmup_steps:
            return lr * step / max(1.0, num_warmup_steps)
        return lr * decay_rate ** ((step - num_warmup_steps) / decay_steps)

    return schedule


def step_lr(lr: float, step_size: int, gamma: float = 0.5, steps_per_epoch: int = 1):
    """torch's StepLR: ``lr`` times ``gamma`` every ``step_size`` epochs of
    ``steps_per_epoch`` updates."""

    def schedule(step: int) -> float:
        epoch = float(step) / max(1, steps_per_epoch)
        return lr * gamma ** math.floor(epoch / step_size)

    return schedule


def swa_lr(lr: float, swa_lr: float, swa_step_start: int, anneal_steps: int = 1000):
    """SWALR-style: ``lr`` until ``swa_step_start``, then a cosine anneal to
    the constant ``swa_lr`` over ``anneal_steps``."""

    def schedule(step: int) -> float:
        if step < swa_step_start:
            return lr
        t = min(max((step - swa_step_start) / max(anneal_steps, 1), 0.0), 1.0)
        return swa_lr + (lr - swa_lr) * 0.5 * (1 + math.cos(math.pi * t))

    return schedule
