"""Trainer callbacks: checkpointing, metric logging and weight averaging
(counterpart of ``fourierflow_tpu/trainers/callbacks.py``). Checkpoints hold
the whole train state (``utils/checkpoint.py``); metrics go to a JSONL file,
and to Weights & Biases where ``wandb`` is installed. In a parallel fit the
Trainer runs the callbacks that write files (``writes_files``) on rank 0
only, with the state gathered whole, so a checkpoint is the file of an
unsplit fit."""

import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from ..utils.checkpoint import save_state

logger = logging.getLogger(__name__)

__all__ = ["Callback", "ModelCheckpoint", "JSONLogger", "StochasticWeightAveraging",
           "WandbLogger"]


class Callback:
    """Hooks the Trainer calls; ``on_epoch_end`` and ``on_fit_end`` may
    return a replacement state. A callback whose ``writes_files`` is set
    runs on rank 0 alone in a parallel fit (and replaces no state)."""

    writes_files = False

    def on_fit_start(self, trainer, routine, state):
        pass

    def on_epoch_end(self, trainer, routine, state):
        pass

    def on_fit_end(self, trainer, routine, state):
        pass

    def on_test_end(self, trainer, routine, state):
        pass


class ModelCheckpoint(Callback):
    """Keep the best checkpoint by a monitored metric, and ``last.ckpt``.
    With ``monitor=None`` the checkpoint is written at every scheduled
    epoch (the flagship config monitors nothing and keeps the last).
    ``every_n_epochs`` spaces the scheduled epochs; the final epoch always
    saves. Unknown keyword arguments of the reference's Lightning configs
    are accepted and ignored."""

    writes_files = True

    def __init__(self, dirpath: Optional[str] = None, monitor: Optional[str] = None,
                 mode: str = "min", filename: str = "best.ckpt", save_last: bool = True,
                 every_n_epochs: int = 1, **_ignored_lightning_kwargs):
        if "{" in filename:  # Lightning filename templates
            filename = "best.ckpt"
        self.dirpath = dirpath
        self.monitor = monitor
        self.mode = mode
        self.filename = filename
        self.save_last = save_last
        self.every_n_epochs = max(int(every_n_epochs), 1)
        self.best = np.inf if mode == "min" else -np.inf
        self.best_path = None

    def on_epoch_end(self, trainer, routine, state):
        if self.dirpath is None:
            return
        epoch = trainer.current_epoch
        scheduled = epoch >= trainer.max_epochs - 1 or (epoch + 1) % self.every_n_epochs == 0
        if self.save_last and scheduled:
            save_state(os.path.join(self.dirpath, "last.ckpt"), state)
        if self.monitor is None:
            if scheduled:
                self.best_path = os.path.join(self.dirpath, self.filename)
                save_state(self.best_path, state)
            return
        value = trainer.logs.get(self.monitor)
        if value is None:
            return
        if value < self.best if self.mode == "min" else value > self.best:
            self.best = value
            self.best_path = os.path.join(self.dirpath, self.filename)
            save_state(self.best_path, state)
            logger.info("saved best %s=%.6f -> %s", self.monitor, value, self.best_path)


class JSONLogger(Callback):
    """Append the Trainer's scalar logs (and arrays of at most 64 values)
    as one JSON line per epoch and after the test pass."""

    writes_files = True

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def _write(self, trainer):
        row = {"time": time.time()}
        for k, v in trainer.logs.items():
            if isinstance(v, (int, float, str)):
                row[k] = v
            elif np.ndim(v) == 0:
                row[k] = float(v)
            elif np.size(v) <= 64:
                row[k] = np.asarray(v).tolist()
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def on_epoch_end(self, trainer, routine, state):
        self._write(trainer)

    def on_test_end(self, trainer, routine, state):
        self._write(trainer)


class StochasticWeightAveraging(Callback):
    """Step-based stochastic weight averaging: from ``swa_step_start`` (a
    float up to 1 is a fraction of the total steps, ``total_steps`` or else
    estimated from the steps per epoch so far; otherwise an absolute step)
    on, a running mean of the parameters at each epoch's end, kept on the
    state's device; at the end of the fit the mean replaces the trained
    parameters. Anneal the learning rate with ``schedulers.swa_lr``."""

    def __init__(self, swa_step_start=0.7, total_steps=None):
        self.swa_step_start = swa_step_start
        self.total_steps = total_steps
        self.avg_params = None
        self.n_averaged = 0

    def _start_step(self, trainer) -> float:
        if isinstance(self.swa_step_start, float) and self.swa_step_start <= 1.0:
            total = self.total_steps
            if total is None:
                per_epoch = max(trainer.global_step, 1) / max(trainer.current_epoch + 1, 1)
                total = per_epoch * trainer.max_epochs
            return self.swa_step_start * total
        return float(self.swa_step_start)

    def on_epoch_end(self, trainer, routine, state):
        if trainer.global_step < self._start_step(trainer):
            return None
        n = self.n_averaged
        with torch.no_grad():
            params = dict(state.model.named_parameters())
            if self.avg_params is None:
                self.avg_params = {k: p.detach().clone() for k, p in params.items()}
            else:
                self.avg_params = {k: (a * n + params[k]) / (n + 1)
                                   for k, a in self.avg_params.items()}
        self.n_averaged = n + 1
        return None

    def on_fit_end(self, trainer, routine, state):
        if self.avg_params is None:
            return None
        with torch.no_grad():
            for k, p in state.model.named_parameters():
                p.copy_(self.avg_params[k])
        return state


class WandbLogger(Callback):
    """The Trainer's scalar logs to Weights & Biases at each epoch's end and
    after the test pass. Where ``wandb`` cannot be imported or its run not
    started, it warns once and logs nothing; ``JSONLogger`` stays the run's
    log."""

    writes_files = True

    def __init__(self, project=None, group=None, name=None, config=None):
        try:
            import wandb

            self._run = wandb.init(project=project, group=group, name=name, config=config)
            self._wandb = wandb
        except Exception as err:  # ImportError, or a run that cannot start offline
            logger.warning("wandb unavailable: %s", err)
            self._run = None
            self._wandb = None

    def _log(self, trainer):
        if self._run is None:
            return
        scalars = {k: float(v) for k, v in trainer.logs.items() if isinstance(v, (int, float))}
        self._wandb.log(scalars, step=trainer.global_step)

    def on_epoch_end(self, trainer, routine, state):
        self._log(trainer)

    def on_test_end(self, trainer, routine, state):
        self._log(trainer)
