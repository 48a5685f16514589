"""``sample`` command: roll out one test batch and pickle it with its
predictions, the raw material of the paper's figures (counterpart of
``fourierflow_tpu/commands/sample.py``)."""

import logging
import os
import pickle
from typing import List, Optional

import numpy as np
import torch

from ..config import instantiate, load_config
from ..device import resolve_device
from .train import build_routine, experiment_dir, restore_state

logger = logging.getLogger(__name__)

__all__ = ["main"]


def _numpy(value):
    if isinstance(value, dict):
        return {k: _numpy(v) for k, v in value.items()}
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def main(config_path: str, checkpoint_path: Optional[str] = None,
         overrides: Optional[List[str]] = None, trial: int = 0, out_path: Optional[str] = None,
         device: Optional[str] = None) -> str:
    """Writes ``[batch, preds]`` (numpy arrays) to ``out_path``, by default
    ``sample.pkl`` in ``experiment_dir(config_path)``. Returns the path."""
    dev = resolve_device(device)
    cfg = load_config(config_path, overrides)
    builder = instantiate(cfg["builder"])
    routine = build_routine(cfg["routine"], builder)
    state = restore_state(routine, builder, dev, trial, checkpoint_path)

    batch = next(builder.test_batches())
    if hasattr(routine, "rollout") and "data" in batch:
        preds = routine.rollout(state, batch)[0]
    else:
        logs = routine.valid_step(state, batch)
        preds = logs.get("preds", logs)

    if out_path is None:
        os.makedirs(experiment_dir(config_path), exist_ok=True)
        out_path = os.path.join(experiment_dir(config_path), "sample.pkl")
    with open(out_path, "wb") as f:
        pickle.dump([_numpy(batch), _numpy(preds)], f)
    logger.info("wrote %s", out_path)
    return out_path
