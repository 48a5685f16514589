"""Routine construction from an experiment config (the part of
``fourierflow_tpu/commands/train.py`` that inference needs)."""

from ..config import instantiate

__all__ = ["build_routine"]

# Training-only keys of a routine node. They are read here and built with
# the optimizer, its schedule and the Trainer in the training slice.
_TRAINING_KEYS = ("optimizer", "scheduler", "clip_val", "accumulate_grad_batches")


def build_routine(routine_cfg: dict):
    """Instantiate the routine (and its model) from a config node."""
    cfg = {k: v for k, v in routine_cfg.items() if k not in _TRAINING_KEYS}
    return instantiate(cfg)
