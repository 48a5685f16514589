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

With ``auto_remat`` (the default) ``fit`` first estimates the train step's
saved activations from the model's layers and width and the sample batch's
shape, and turns the model's per-layer remat on when they would take more
than 60% of the device's memory (``_maybe_enable_remat``). The JAX
package's meshes and scanned-epoch fast path are not ported.
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

# Saved activations of an unremat train step, in layer-input-sized tensors a
# layer (``n_layers * batch * cells * width``, the cells those of the batch's
# ``x``), by model: the step's peak ``torch.cuda.max_memory_allocated()`` above
# the memory held before it, measured by ``chip_smoke.py`` phase ``trainer`` on
# an NVIDIA H100 80GB HBM3 at 700.00 W. FNOFactorized2DBlock: the least-squares
# fit through the origin (2.226-2.228) of 2.35-2.44 at torus_li/markov/24_layers
# batch 19 and 2.35 and 2.22 at torus_kochkov/ffno/grid_sizes/256 batch 2 and 8.
# FNOFactorizedMesh3D: 5.73 at plasticity/ffno/24_layers batch 2 (the padded
# grid has 1.90x the batch's cells). FNOZongyi2DBlock: 45.45-45.51 at
# torus_li/zongyi/4_layers batch 20, whose step unrolls the model 10 times, so
# it overstates a one-step routine's. The guard leaves a model not listed here
# alone.
SAVED_INPUTS_PER_LAYER = {"FNOFactorized2DBlock": 2.23, "FNOFactorizedMesh3D": 5.73,
                          "FNOZongyi2DBlock": 45.5}
# The share of the device's memory the estimate may take before remat turns on.
REMAT_BUDGET = 0.6


def batch_count(batch) -> int:
    """The number of samples of a batch: a dict of arrays, an ``(inputs,
    outputs)`` tuple (the learned-interpolation model's) or an array."""
    if isinstance(batch, dict):
        return batch_count(next(iter(batch.values())))
    if isinstance(batch, (tuple, list)):
        return batch_count(batch[0])
    return len(batch)


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


def _estimate_activation_bytes(model, sample_batch) -> Optional[int]:
    """The saved activations of an unremat train step of a model with
    per-layer remat: ``n_layers * batch * cells * width * itemsize`` (2
    bytes with a compute dtype, else 4) times the model's
    ``SAVED_INPUTS_PER_LAYER``. None for a model not listed there or
    without ``n_layers`` and ``width``, or a batch without an ``x`` of at
    least three dims."""
    coefficient = SAVED_INPUTS_PER_LAYER.get(type(model).__name__)
    n_layers = getattr(model, "n_layers", None)
    width = getattr(model, "width", None)
    if not (coefficient and n_layers and width):
        return None
    x = sample_batch.get("x") if hasattr(sample_batch, "get") else None
    if x is None or getattr(x, "ndim", 0) < 3:
        return None
    batch = int(x.shape[0])
    cells = int(np.prod(x.shape[1:-1]))
    itemsize = 2 if getattr(model, "dtype", None) is not None else 4
    return int(int(n_layers) * batch * cells * int(width) * coefficient * itemsize)


def _device_hbm_bytes(device) -> float:
    """The memory of a CUDA device; unbounded on the CPU, where the guard
    never fires."""
    device = torch.device(device)
    if device.type == "cuda":
        return float(torch.cuda.get_device_properties(device).total_memory)
    return float("inf")


class Trainer:
    def __init__(self, max_epochs: int = 1, limit_train_batches: Optional[int] = None,
                 limit_val_batches: Optional[int] = None, callbacks: Sequence = (), seed: int = 0,
                 log_every_n_steps: int = 100, check_val_every_n_epoch: int = 1, device=None,
                 auto_remat: bool = True):
        self.max_epochs = max_epochs
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.callbacks = list(callbacks)
        self.seed = seed
        self.log_every_n_steps = log_every_n_steps
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.device = resolve_device(device)
        self.auto_remat = auto_remat
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

    def _maybe_enable_remat(self, routine: Routine, builder) -> None:
        """Turn the model's per-layer remat on (the same parameters) when the
        estimated saved activations exceed ``REMAT_BUDGET`` of the device's
        memory. A model whose ``remat`` is already on, or that has none, is
        left alone."""
        model = getattr(routine, "model", None)
        if model is None or getattr(model, "remat", None) is not False:
            return
        est = _estimate_activation_bytes(model, builder.sample_batch())
        if est is None:
            return
        budget = REMAT_BUDGET * _device_hbm_bytes(self.device)
        if est > budget:
            logger.warning(
                "estimated saved activations ~%.1f GB exceed ~%.1f GB of the device's memory "
                "budget: turning per-layer rematerialization on (the same parameters; set "
                "Trainer(auto_remat=False) or the model's remat explicitly to override)",
                est / 2**30, budget / 2**30)
            model.remat = True

    def fit(self, routine: Routine, builder, state: Optional[State] = None) -> State:
        """``max_epochs`` epochs from epoch 0 and global step 0, from
        ``state`` where given (a resumed run too, as in the reference: a
        normalizing routine's epoch 0 then adds statistics to the restored
        ones)."""
        rng = np.random.default_rng(self.seed)
        if self.auto_remat:
            self._maybe_enable_remat(routine, builder)
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
                train_metrics.append((metrics, batch_count(batch)))
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
            metric_list.append((_numpy(routine.valid_step(state, batch)), batch_count(batch)))
        return {f"{split}_{k}": float(v) if np.ndim(v) == 0 else v
                for k, v in _weighted_merge(metric_list).items()}

    def test(self, routine: Routine, builder, state: State) -> dict:
        logs = self.evaluate(routine, builder, state, split="test")
        self.logs.update(logs)
        self._hook("on_test_end", routine, state)
        return logs
