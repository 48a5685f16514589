"""``test`` command: evaluate a saved checkpoint on the test split
(counterpart of ``fourierflow_tpu/commands/test.py``).

Restores the state from the port's checkpoint (by default the newest one
of the trial, ``best.ckpt`` before ``last.ckpt``) or from a reference
Lightning ``.ckpt`` (``torch_checkpoint``), runs ``Trainer.test`` and
returns its logs.
"""

import glob
import logging
import os
from typing import List, Optional

import numpy as np

from ..config import instantiate, load_config
from ..device import resolve_device
from .train import build_routine, build_trainer, experiment_dir, restore_state

logger = logging.getLogger(__name__)

__all__ = ["find_checkpoint", "main"]


def find_checkpoint(config_path: str, trial: int, config_dir: Optional[str] = None) -> str:
    """The newest run's ``best.ckpt`` of this trial, else its ``last.ckpt``,
    under ``<config_dir>/checkpoints/trial-<trial>-*/`` (``config_dir``
    defaults to ``experiment_dir(config_path)``, as in ``train``)."""
    config_dir = config_dir or experiment_dir(config_path)
    for name in ("best.ckpt", "last.ckpt"):
        paths = sorted(glob.glob(os.path.join(config_dir, "checkpoints", f"trial-{trial}-*",
                                              name)))
        if paths:
            return paths[-1]
    raise FileNotFoundError(f"no checkpoint found under {config_dir}/checkpoints/trial-{trial}-*")


def main(config_path: str, checkpoint_path: Optional[str] = None,
         overrides: Optional[List[str]] = None, trial: int = 0,
         torch_checkpoint: Optional[str] = None, config_dir: Optional[str] = None,
         device: Optional[str] = None) -> dict:
    dev = resolve_device(device)
    cfg = load_config(config_path, overrides)
    if checkpoint_path is None and torch_checkpoint is None:
        checkpoint_path = find_checkpoint(config_path, trial, config_dir)
        logger.info("using checkpoint %s", checkpoint_path)
    builder = instantiate(cfg["builder"])
    routine = build_routine(cfg["routine"], builder)
    state = restore_state(routine, builder, dev, trial, checkpoint_path, torch_checkpoint)
    trainer = build_trainer(cfg.get("trainer"), device=dev)
    logs = trainer.test(routine, builder, state)
    logger.info("test logs: %s", {k: v for k, v in logs.items() if np.ndim(v) == 0})
    return logs
