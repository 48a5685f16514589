"""``train`` command: config-driven experiment runner (counterpart of
``fourierflow_tpu/commands/train.py``).

Loads an experiment, a YAML file or a registry name (builder / routine /
trainer / callbacks), seeds with 7231 + trial, trains with the Trainer on
the chosen device (CUDA unless the CPU is asked for), writes
``last.ckpt`` and ``metrics.jsonl`` under
``<config_dir>/checkpoints/trial-<n>-<time>/`` (``config_dir`` defaults to
``experiment_dir``), and tests with the best monitored checkpoint (or the
final state).

The fit may start from a checkpoint: ``checkpoint_path`` restores the whole
state (weights, normalizer, optimizer moments, schedule, step), ``resume``
takes the newest ``trial-<n>-*/last.ckpt``, and a config's
``pretrained_path`` loads weights and normalizer only (the port's own
checkpoint or a reference Lightning ``.ckpt``), with a fresh optimizer and
schedule. As in the reference, a resumed fit is not the rest of an uncut
one: it runs ``max_epochs`` epochs from epoch 0 with the trainer's
``global_step`` from 0, and a normalizing routine's epoch 0 adds statistics
to the restored ones. ``profile_dir`` writes a ``torch.profiler`` trace of
the fit.

Under ``torchrun --nproc-per-node N -m fourierflow_tpu_torch.commands train
...`` each process joins the process group (``parallel.init_distributed``)
and drives ``cuda:LOCAL_RANK``; the trainer node's ``data_parallel``,
``tensor_parallel`` and ``spatial_parallel`` choose the mesh, as in the JAX
package. The ranks share rank 0's run directory, and the test pass takes
rank 0's best checkpoint (none under tensor parallelism, as in JAX).
"""

import glob
import logging
import os
import time
from dataclasses import replace
from functools import partial
from typing import List, Optional

import numpy as np
import torch

import torch.distributed as dist

from ..config import instantiate, load_config
from ..device import resolve_device
from ..parallel import init_distributed, is_rank0, world_size
from ..routines.base import make_optimizer
from ..schedulers import (cosine_with_warmup, exponential_with_warmup, linear_with_warmup,
                          step_lr, swa_lr)
from ..trainers import JSONLogger, ModelCheckpoint, Trainer
from ..utils.checkpoint import checkpoint_kind, load_inference_state, load_state, read_checkpoint
from ..utils.profiling import trace
from ..utils.torch_import import import_reference_checkpoint

logger = logging.getLogger(__name__)

__all__ = ["ExistingExperimentFound", "build_routine", "build_trainer", "experiment_dir",
           "restore_state", "main"]

# The schedules ported, by the callable a scheduler node names.
_SCHEDULES = (cosine_with_warmup, linear_with_warmup, exponential_with_warmup, step_lr, swa_lr)


def build_routine(routine_cfg: dict, builder=None):
    """Construct a routine from a config node, with its optimizer: the
    config's ``functools.partial(torch.optim.AdamW, lr=..., weight_decay=...)``
    gives the learning rate and weight decay (1e-4 when an AdamW node omits
    it, 0 for another optimizer, as the JAX package reads them), the
    scheduler node a per-step schedule of that rate (a node with ``interval:
    epoch`` is given the ``builder``'s batches per epoch as
    ``steps_per_epoch``), ``clip_val`` and ``accumulate_grad_batches`` the
    rest of ``make_optimizer``'s chain."""
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
        kwargs = {}
        if isinstance(sch_cfg, dict) and sch_cfg.get("interval") == "epoch" and builder is not None:
            kwargs["steps_per_epoch"] = builder.batches_per_epoch
        schedule = sch(lr=lr, **kwargs)

    optimizer = make_optimizer(lr=lr, weight_decay=weight_decay, schedule=schedule,
                               clip_val=cfg.pop("clip_val", None),
                               accumulate_grad_batches=cfg.pop("accumulate_grad_batches", 1))
    return instantiate(cfg, optimizer=optimizer)


def build_trainer(trainer_cfg: Optional[dict], callbacks=(), device=None) -> Trainer:
    """The Trainer a config's ``trainer`` node describes, with its
    ``data_parallel``, ``tensor_parallel`` and ``spatial_parallel`` (the
    mesh is built over the process group: a ``tensor_parallel`` or
    ``spatial_parallel`` above its ranks raises, as JAX's mesh does above
    the devices).

    The Trainer keeps ``fast_loop`` on, as the JAX package's does, so
    ``train`` runs the device-resident epoch (the whole train set on the
    device, ``n // batch_size`` full batches an epoch) for every builder with
    ``train_data`` or ``device_train_data``; ``limit_train_batches`` (the
    learned interpolation's configs set 4,000), ``fast_dev_run`` and the
    multi-resolution Kolmogorov dataset take the per-batch loop."""
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
        tensor_parallel=cfg.get("tensor_parallel", 1),
        spatial_parallel=cfg.get("spatial_parallel", 1),
        data_parallel=cfg.get("data_parallel", True),
    )


def restore_state(routine, builder, device, trial: int = 0, checkpoint_path: Optional[str] = None,
                  torch_checkpoint: Optional[str] = None):
    """The routine's state initialised with seed 7231 + trial on ``device``,
    then restored from the port's own checkpoint (``load_state``) and from
    a reference Lightning checkpoint (``import_reference_checkpoint``),
    where given."""
    state = routine.init(7231 + trial, builder.sample_batch(), device)
    if checkpoint_path:
        state = load_state(checkpoint_path, state)
    if torch_checkpoint:
        state = import_reference_checkpoint(torch_checkpoint, state)
    return state


def resolve_test_state(callbacks, state, trainer=None):
    """The state for the test pass: the best monitored checkpoint when one
    was saved, else the final state. In a parallel fit rank 0's choice
    holds for every rank (only rank 0 ran the checkpoint callback); under
    tensor parallelism the final state is tested, as in the JAX package."""
    mesh = getattr(trainer, "mesh", None)
    if mesh is not None and "model" in mesh.mesh_dim_names:
        return state
    best = None
    for cb in callbacks:
        if (isinstance(cb, ModelCheckpoint) and cb.monitor is not None and cb.best_path
                and os.path.exists(cb.best_path)):
            best = (cb.best_path, cb.monitor, cb.best)
            break
    if world_size() > 1:
        shared = [best]
        dist.broadcast_object_list(shared, src=0)
        best = shared[0]
    if best is None:
        return state
    logger.info("testing with best checkpoint %s (%s=%.6g)", *best)
    return load_state(best[0], state)


def experiment_dir(config_path: str) -> str:
    """Where an experiment's runs go: the directory of a YAML file, or, for
    a registry name, the name itself as a directory (in the reference every
    experiment is a directory ``name/config.yaml``), so that
    ``torus_li/markov/4_layers`` and ``torus_li/markov/24_layers`` keep
    their own ``checkpoints/``."""
    p = os.path.abspath(config_path)
    return os.path.dirname(p) if os.path.isfile(p) else p


class ExistingExperimentFound(RuntimeError):
    """Results for this trial exist and ``force`` was not given."""


def _existing_trial_dirs(config_dir: str, trial: int) -> List[str]:
    return sorted(glob.glob(os.path.join(config_dir, "checkpoints", f"trial-{trial}-*")))


def _run_dir(config_dir: str, trial: int) -> str:
    """``checkpoints/trial-<n>-<time>``, a second later where a run of the
    same second has that directory (a resumed run keeps its own)."""
    stamp = int(time.time())
    while os.path.exists(os.path.join(config_dir, "checkpoints", f"trial-{trial}-{stamp}")):
        stamp += 1
    return os.path.join(config_dir, "checkpoints", f"trial-{trial}-{stamp}")


def load_pretrained(path: str, state):
    """Weights and normalizer from ``path`` (environment variables
    expanded): the port's own checkpoint or a reference Lightning ``.ckpt``.
    The optimizer and schedule stay fresh, and the step is the template's."""
    path = os.path.expandvars(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"pretrained_path: {path}")
    blob = read_checkpoint(path)
    if checkpoint_kind(blob, path) == "lightning":
        loaded = import_reference_checkpoint(path, state, blob)
    else:
        loaded = load_inference_state(path, state, blob)
    logger.info("loaded pretrained weights from %s", path)
    return replace(loaded, step=state.step)


def main(config_path: str, overrides: Optional[List[str]] = None, trial: int = 0,
         checkpoint_path: Optional[str] = None, no_test: bool = False, force: bool = False,
         resume: bool = False, profile_dir: Optional[str] = None,
         config_dir: Optional[str] = None, device: Optional[str] = None):
    """Train (and test) one trial. ``config_dir`` replaces
    ``experiment_dir(config_path)`` as the place of ``checkpoints/``.
    Existing results of the trial raise ``ExistingExperimentFound`` unless
    ``force``, ``resume`` or ``checkpoint_path`` is given. Returns
    ``(trainer, state)``."""
    dev = resolve_device(device)
    if int(os.environ.get("WORLD_SIZE", 1)) > 1:  # started by torchrun
        init_distributed(dev)
    cfg = load_config(config_path, overrides)
    seed = 7231 + trial

    builder = instantiate(cfg["builder"])
    routine = build_routine(cfg["routine"], builder)
    if (cfg.get("trainer") or {}).get("track_grad_norm") not in (None, -1, False):
        routine.track_grad_norm = True

    config_dir = config_dir or experiment_dir(config_path)
    existing, run_dir = _existing_trial_dirs(config_dir, trial), _run_dir(config_dir, trial)
    if world_size() > 1:
        # Rank 0's listing and run directory for every rank: a broadcast's root may return
        # before the others list, and rank 0 then makes its directory, which another rank
        # would find as an earlier run's.
        shared = [existing, run_dir]
        dist.broadcast_object_list(shared, src=0)
        existing, run_dir = shared
    if existing and not (force or resume or checkpoint_path):
        raise ExistingExperimentFound(
            f"results for trial {trial} already exist under "
            f"{os.path.join(config_dir, 'checkpoints')}; pass --force to train again or "
            "--resume to continue from the last checkpoint")
    if resume and not checkpoint_path:
        # The newest trial directory that holds a last.ckpt (epoch granularity,
        # as the reference resumes).
        found = [os.path.join(d, "last.ckpt") for d in existing
                 if os.path.exists(os.path.join(d, "last.ckpt"))]
        if found:
            checkpoint_path = found[-1]
            logger.info("resuming from %s", checkpoint_path)

    callbacks = instantiate(cfg.get("callbacks", [])) or []
    if not any(isinstance(cb, ModelCheckpoint) for cb in callbacks):
        callbacks.append(ModelCheckpoint())
    for cb in callbacks:
        if isinstance(cb, ModelCheckpoint):
            cb.dirpath = run_dir
    callbacks.append(JSONLogger(os.path.join(run_dir, "metrics.jsonl")))

    trainer = build_trainer(cfg.get("trainer"), callbacks, dev)
    trainer.seed = seed

    state = None
    if checkpoint_path:
        state = load_state(checkpoint_path, routine.init(seed, builder.sample_batch(), dev))
    elif cfg.get("pretrained_path"):
        state = load_pretrained(cfg["pretrained_path"],
                                routine.init(seed, builder.sample_batch(), dev))
    with trace(profile_dir, enabled=bool(profile_dir), device=dev):
        state = trainer.fit(routine, builder, state=state)
    if not no_test:
        logs = trainer.test(routine, builder, resolve_test_state(callbacks, state, trainer))
        if is_rank0():
            logger.info("test logs: %s", {k: v for k, v in logs.items() if np.ndim(v) == 0})
    return trainer, state
