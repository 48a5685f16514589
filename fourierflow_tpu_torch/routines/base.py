"""Routine base: the train state, the optimizer and the routine contract
(counterpart of ``fourierflow_tpu/routines/base.py``).

A routine owns a model (an ``nn.Module``) and implements the steps:

- ``init(seed, sample_batch, device) -> State``
- ``train_step(state, batch, rng) -> (State, metrics)``
- ``accumulate_step(state, batch) -> State``   (normalizer warm-up)
- ``valid_step(state, batch) -> metrics``

Unlike the JAX package's pure steps, ``apply_grads`` updates the model's
parameters and the optimizer's moments in place (torch's optimizers work
so, and it keeps one copy of each); the returned ``State`` carries the
same objects with the step count advanced.
"""

from dataclasses import dataclass, replace
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn

from ..layers import NormalizerState

__all__ = ["State", "Routine", "OptimizerSpec", "make_optimizer"]


@dataclass
class State:
    """The model (its parameters live in it, on the run's device), the
    normalizer statistics, the optimizer with its schedule, and the number
    of train steps taken."""

    model: nn.Module
    normalizer: Optional[NormalizerState]
    optimizer: Optional[torch.optim.Optimizer] = None
    scheduler: Optional[torch.optim.lr_scheduler.LambdaLR] = None
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


@dataclass(frozen=True)
class OptimizerSpec:
    """What ``make_optimizer`` chose; ``build`` makes the optimizer and its
    scheduler for a set of parameters."""

    lr: float = 1e-3
    weight_decay: float = 1e-4
    schedule: Optional[Callable[[int], float]] = None
    clip_val: Optional[float] = None
    accumulate_grad_batches: int = 1

    def build(self, params):
        optimizer = torch.optim.AdamW(params, lr=self.lr, weight_decay=self.weight_decay)
        scheduler = None
        if self.schedule is not None:
            if self.lr <= 0:
                raise ValueError("a schedule needs a positive base learning rate")
            schedule, lr = self.schedule, self.lr
            scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda s: schedule(s) / lr)
        return optimizer, scheduler


def make_optimizer(lr: float = 1e-3, weight_decay: float = 1e-4,
                   schedule: Optional[Callable[[int], float]] = None,
                   clip_val: Optional[float] = None,
                   accumulate_grad_batches: int = 1) -> OptimizerSpec:
    """AdamW with an optional per-step LR schedule (absolute rates, step 0
    first), gradient clipping by value before the update, and gradient
    accumulation: the mean of ``accumulate_grad_batches`` steps' gradients
    makes one update (optax's ``MultiSteps``; the steps between change
    nothing)."""
    return OptimizerSpec(lr, weight_decay, schedule, clip_val, int(accumulate_grad_batches))


def _params(model: nn.Module):
    return list(model.parameters())  # shared parameters appear once


class Routine:
    def __init__(self, optimizer: Optional[OptimizerSpec] = None, track_grad_norm: bool = False):
        self.optimizer = optimizer if optimizer is not None else make_optimizer()
        # When on, train steps add the global gradient L2 norm to their metrics.
        self.track_grad_norm = track_grad_norm

    @staticmethod
    def grad_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """Global L2 norm over a list of gradients."""
        return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))

    def with_grad_norm(self, metrics: dict, grads) -> dict:
        """Attach the global gradient norm when ``track_grad_norm`` is on."""
        if self.track_grad_norm:
            metrics = dict(metrics, grad_norm=self.grad_norm(grads))
        return metrics

    # --- contract -------------------------------------------------------
    def init(self, seed: int, sample_batch, device) -> State:
        raise NotImplementedError

    def train_step(self, state: State, batch, rng: Optional[torch.Generator] = None):
        raise NotImplementedError

    def accumulate_step(self, state: State, batch) -> State:
        """Normalizer statistics warm-up (epoch 0). Default: no-op."""
        return state

    def valid_step(self, state: State, batch):
        raise NotImplementedError

    # --- helpers --------------------------------------------------------
    def n_params(self, state: State) -> int:
        return sum(p.numel() for p in _params(state.model))

    def make_train_state(self, model: nn.Module, normalizer=None) -> State:
        optimizer, scheduler = self.optimizer.build(_params(model))
        return State(model, normalizer, optimizer, scheduler, 0)

    def apply_grads(self, state: State, grads: Sequence[torch.Tensor]) -> State:
        """Feed one step's gradients (in ``model.parameters()`` order) to the
        optimizer. They are summed into ``p.grad`` over an accumulation
        window; its last step averages, clips, updates and advances the
        schedule. ``p.grad`` keeps what the update used until the next
        window starts."""
        spec = self.optimizer
        k = spec.accumulate_grad_batches
        first, last = state.step % k == 0, state.step % k == k - 1
        params = _params(state.model)
        with torch.no_grad():
            for p, g in zip(params, grads, strict=True):
                if first:
                    # A buffer with p's strides, as the optimizer's multi-tensor
                    # path needs them; the caller's gradients stay untouched.
                    if p.grad is None:
                        p.grad = torch.empty_like(p)
                    p.grad.copy_(g)
                else:
                    p.grad.add_(g)
            if last:
                if k > 1:
                    for p in params:
                        p.grad.div_(k)
                if spec.clip_val is not None:
                    torch.nn.utils.clip_grad_value_(params, spec.clip_val)
                state.optimizer.step()
                if state.scheduler is not None:
                    state.scheduler.step()
        return replace(state, step=state.step + 1)
