"""Routine base: the state and the routine contract (counterpart of
``fourierflow_tpu/routines/base.py``).

A routine owns a model (an ``nn.Module``) and implements the steps:

- ``init(seed, sample_batch, device) -> State``
- ``accumulate_step(state, batch) -> State``   (normalizer warm-up)
- ``valid_step(state, batch) -> metrics``

Training (``train_step``, the optimizer and its schedule) comes with the
training slice of the port.
"""

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn

from ..layers import NormalizerState

__all__ = ["State", "Routine"]


@dataclass
class State:
    """The model (its parameters live in it, on the run's device) and the
    normalizer statistics."""

    model: nn.Module
    normalizer: Optional[NormalizerState]

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


class Routine:
    def init(self, seed: int, sample_batch, device) -> State:
        raise NotImplementedError

    def accumulate_step(self, state: State, batch) -> State:
        """Normalizer statistics warm-up (epoch 0). Default: no-op."""
        return state

    def valid_step(self, state: State, batch):
        raise NotImplementedError
