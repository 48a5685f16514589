"""Trainer callbacks: checkpointing and metric logging (counterpart of
``fourierflow_tpu/trainers/callbacks.py``). Checkpoints hold the whole
train state (``utils/checkpoint.py``); metrics go to a JSONL file."""

import json
import logging
import os
import time
from typing import Optional

import numpy as np

from ..utils.checkpoint import save_state

logger = logging.getLogger(__name__)

__all__ = ["Callback", "ModelCheckpoint", "JSONLogger"]


class Callback:
    """Hooks the Trainer calls; ``on_epoch_end`` and ``on_fit_end`` may
    return a replacement state."""

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
