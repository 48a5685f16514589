"""The training loop (counterpart of the per-batch loop of
``fourierflow_tpu/trainers/trainer.py``).

``fit`` runs ``max_epochs`` epochs over the builder's shuffled train
batches. When the routine normalizes, epoch 0 only gathers normalizer
statistics; every later batch is one ``train_step``. After each epoch the
merged train metrics are checked for NaN, validation runs every
``check_val_every_n_epoch`` epochs, and the callbacks' ``on_epoch_end``
hooks run. The noise of each step comes from a generator on the state's
device seeded from the trainer's seed and the global step. Loss values
stay on the device until the epoch ends, so the loop does not wait for
the card between steps (the first step's value is fetched for the log).
The JAX package's meshes, remat guard and scanned-epoch fast path are not
ported.
"""

import logging
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..routines.base import Routine, State

logger = logging.getLogger(__name__)

__all__ = ["Trainer"]


def _batch_count(batch) -> int:
    return len(next(iter(batch.values())))


def _weighted_merge(metric_list):
    """Mean of each metric over the batches, weighted by batch size."""
    if not metric_list:
        return {}
    total = sum(w for _, w in metric_list)
    return {key: sum(np.asarray(m[key]) * w for m, w in metric_list) / total
            for key in metric_list[0][0]}


def _numpy(metrics) -> dict:
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in metrics.items()}


class Trainer:
    def __init__(self, max_epochs: int = 1, limit_train_batches: Optional[int] = None,
                 limit_val_batches: Optional[int] = None, callbacks: Sequence = (), seed: int = 0,
                 log_every_n_steps: int = 100, check_val_every_n_epoch: int = 1, device=None):
        self.max_epochs = max_epochs
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.callbacks = list(callbacks)
        self.seed = seed
        self.log_every_n_steps = log_every_n_steps
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.device = resolve_device(device)
        self.logs = {}
        self.current_epoch = 0
        self.global_step = 0

    def _hook(self, name, routine, state, allow_replace=False):
        for cb in self.callbacks:
            ret = getattr(cb, name)(self, routine, state)
            if allow_replace and ret is not None:
                state = ret
        return state

    def step_generator(self, device) -> torch.Generator:
        """The noise generator of the current global step."""
        seed = np.random.SeedSequence([self.seed, self.global_step]).generate_state(1)[0]
        return torch.Generator(device=device).manual_seed(int(seed))

    def fit(self, routine: Routine, builder, state: Optional[State] = None) -> State:
        rng = np.random.default_rng(self.seed)
        if state is None:
            state = routine.init(self.seed, builder.sample_batch(), self.device)
        self.logs["n_params"] = routine.n_params(state)
        logger.info("n_params = %d", self.logs["n_params"])
        self._hook("on_fit_start", routine, state)
        normalizes = getattr(routine, "should_normalize", False)

        for epoch in range(self.max_epochs):
            self.current_epoch = epoch
            t0 = time.time()
            train_metrics = []
            for i, batch in enumerate(builder.train_batches(rng)):
                if self.limit_train_batches and i >= self.limit_train_batches:
                    break
                if epoch == 0 and normalizes:
                    state = routine.accumulate_step(state, batch)
                    continue
                state, metrics = routine.train_step(state, batch,
                                                    self.step_generator(state.device))
                self.global_step += 1
                train_metrics.append((metrics, _batch_count(batch)))
                if self.global_step == 1 or (i + 1) % self.log_every_n_steps == 0:
                    logger.info("epoch %d step %d (global %d): loss %.4f", epoch, i + 1,
                                self.global_step, float(metrics["train_loss"]))

            if train_metrics:
                merged = _weighted_merge([(_numpy(m), w) for m, w in train_metrics])
                scalars = {k: float(v) for k, v in merged.items()}
                for k, v in scalars.items():
                    if v != v:
                        raise FloatingPointError(
                            f"{k} is NaN at epoch {epoch} (step {self.global_step})")
                self.logs.update(scalars)

            if (epoch + 1) % self.check_val_every_n_epoch == 0:
                self.logs.update(self.evaluate(routine, builder, state, split="valid"))
                self.logs["valid_epoch"] = epoch

            self.logs["epoch"] = epoch
            self.logs["epoch_time"] = time.time() - t0
            state = self._hook("on_epoch_end", routine, state, allow_replace=True)

        return self._hook("on_fit_end", routine, state, allow_replace=True)

    def evaluate(self, routine: Routine, builder, state: State, split: str = "valid") -> dict:
        """``valid_step`` over the split's batches, merged by batch size, as
        ``{f"{split}_{metric}": value}``."""
        batches = builder.val_batches() if split == "valid" else builder.test_batches()
        metric_list = []
        for i, batch in enumerate(batches):
            if self.limit_val_batches and i >= self.limit_val_batches:
                break
            metric_list.append((_numpy(routine.valid_step(state, batch)), _batch_count(batch)))
        return {f"{split}_{k}": float(v) if np.ndim(v) == 0 else v
                for k, v in _weighted_merge(metric_list).items()}

    def test(self, routine: Routine, builder, state: State) -> dict:
        logs = self.evaluate(routine, builder, state, split="test")
        self.logs.update(logs)
        self._hook("on_test_end", routine, state)
        return logs
