"""``train`` command: config-driven experiment runner (counterpart of
``fourierflow_tpu/commands/train.py``).

Loads an experiment YAML (builder / routine / trainer / callbacks), seeds
with 7231 + trial, trains with the per-batch Trainer on the chosen device
(CUDA unless the CPU is asked for), writes ``last.ckpt`` and
``metrics.jsonl`` under ``<config_dir>/checkpoints/trial-<n>-<time>/``, and
tests with the best monitored checkpoint (or the final state). Resuming,
``pretrained_path``, profiling and the JAX package's parallel trainer keys
are not ported yet.
"""

import glob
import logging
import os
import time
from functools import partial
from typing import List, Optional

import numpy as np
import torch

from ..config import instantiate, load_config
from ..device import resolve_device
from ..routines.base import make_optimizer
from ..schedulers import cosine_with_warmup
from ..trainers import JSONLogger, ModelCheckpoint, Trainer
from ..utils.checkpoint import load_state

logger = logging.getLogger(__name__)

__all__ = ["ExistingExperimentFound", "build_routine", "build_trainer", "main"]

# The schedules ported so far, by the callable a scheduler node names.
_SCHEDULES = (cosine_with_warmup,)


def build_routine(routine_cfg: dict):
    """Construct a routine from a config node, with its optimizer: the
    config's ``functools.partial(torch.optim.AdamW, lr=..., weight_decay=...)``
    gives the learning rate and weight decay (1e-4 when an AdamW node omits
    it, 0 for another optimizer, as the JAX package reads them), the
    scheduler node a per-step schedule of that rate, ``clip_val`` and
    ``accumulate_grad_batches`` the rest of ``make_optimizer``'s chain."""
    cfg = dict(routine_cfg)
    opt = instantiate(cfg.pop("optimizer", None))
    kw = dict(opt.keywords) if isinstance(opt, partial) else {}
    lr = kw.get("lr", 1e-3)
    is_adamw = isinstance(opt, partial) and opt.func is torch.optim.AdamW
    weight_decay = kw.get("weight_decay", 1e-4 if is_adamw else 0.0)

    schedule = None
    sch_cfg = cfg.pop("scheduler", None)
    if sch_cfg is not None:
        node = sch_cfg.get("scheduler", sch_cfg) if isinstance(sch_cfg, dict) else sch_cfg
        sch = instantiate(node)
        fn = sch.func if isinstance(sch, partial) else sch
        if fn not in _SCHEDULES:
            raise NotImplementedError(f"scheduler {fn!r} is not ported yet")
        schedule = sch(lr=lr)

    optimizer = make_optimizer(lr=lr, weight_decay=weight_decay, schedule=schedule,
                               clip_val=cfg.pop("clip_val", None),
                               accumulate_grad_batches=cfg.pop("accumulate_grad_batches", 1))
    return instantiate(cfg, optimizer=optimizer)


def build_trainer(trainer_cfg: Optional[dict], callbacks=(), device=None) -> Trainer:
    cfg = dict(trainer_cfg or {})
    limit = cfg.get("limit_train_batches")
    if isinstance(limit, float):
        limit = None if limit >= 1.0 else max(1, int(limit))
    if cfg.get("fast_dev_run"):
        # One train batch and one validation batch after the normalizer epoch.
        return Trainer(max_epochs=2, limit_train_batches=1, limit_val_batches=1, device=device)
    return Trainer(
        max_epochs=cfg.get("max_epochs", 1),
        limit_train_batches=limit,
        limit_val_batches=cfg.get("limit_val_batches"),
        log_every_n_steps=cfg.get("log_every_n_steps", 100),
        check_val_every_n_epoch=cfg.get("check_val_every_n_epoch", 1),
        callbacks=list(callbacks),
        device=device,
    )


def resolve_test_state(callbacks, state):
    """The state for the test pass: the best monitored checkpoint when one
    was saved, else the final state."""
    for cb in callbacks:
        if (isinstance(cb, ModelCheckpoint) and cb.monitor is not None and cb.best_path
                and os.path.exists(cb.best_path)):
            logger.info("testing with best checkpoint %s (%s=%.6g)", cb.best_path, cb.monitor,
                        cb.best)
            return load_state(cb.best_path, state)
    return state


class ExistingExperimentFound(RuntimeError):
    """Results for this trial exist and ``force`` was not given."""


def main(config_path: str, overrides: Optional[List[str]] = None, trial: int = 0,
         no_test: bool = False, force: bool = False, config_dir: Optional[str] = None,
         device: Optional[str] = None):
    """Train (and test) one trial. ``config_dir`` replaces the config's
    directory as the place of ``checkpoints/``. Returns ``(trainer, state)``."""
    dev = resolve_device(device)
    cfg = load_config(config_path, overrides)
    seed = 7231 + trial

    builder = instantiate(cfg["builder"])
    routine = build_routine(cfg["routine"])
    if (cfg.get("trainer") or {}).get("track_grad_norm") not in (None, -1, False):
        routine.track_grad_norm = True

    config_dir = config_dir or os.path.dirname(os.path.abspath(config_path))
    checkpoints = os.path.join(config_dir, "checkpoints")
    if glob.glob(os.path.join(checkpoints, f"trial-{trial}-*")) and not force:
        raise ExistingExperimentFound(
            f"results for trial {trial} already exist under {checkpoints}; pass --force to "
            "train again")
    run_dir = os.path.join(checkpoints, f"trial-{trial}-{int(time.time())}")

    callbacks = instantiate(cfg.get("callbacks", [])) or []
    if not any(isinstance(cb, ModelCheckpoint) for cb in callbacks):
        callbacks.append(ModelCheckpoint())
    for cb in callbacks:
        if isinstance(cb, ModelCheckpoint):
            cb.dirpath = run_dir
    callbacks.append(JSONLogger(os.path.join(run_dir, "metrics.jsonl")))

    trainer = build_trainer(cfg.get("trainer"), callbacks, dev)
    trainer.seed = seed
    state = trainer.fit(routine, builder)
    if not no_test:
        logs = trainer.test(routine, builder, resolve_test_state(callbacks, state))
        logger.info("test logs: %s", {k: v for k, v in logs.items() if np.ndim(v) == 0})
    return trainer, state
