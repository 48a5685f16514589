"""``infer`` command: timed autoregressive rollout (counterpart of
``fourierflow_tpu/commands/infer.py``).

Loads the config, builds the routine, restores a checkpoint (the port's
own, or a reference Lightning ``.ckpt`` with ``torch_checkpoint``), takes
the first test batch (its trajectories, and its force and viscosity where
the builder gives them), runs one
warm-up rollout and then one timed rollout that ends with
``torch.cuda.synchronize()`` and a real value fetch. Prints
``{"shape", "elapsed", "inference_time"}``: the timed rollout's seconds and
seconds per sample per simulated second (the reference's speed metric).
"""

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from ..config import instantiate, load_config
from ..device import resolve_device
from ..ops import launch_counts
from ..routines.base import State
from .train import build_routine, restore_state

logger = logging.getLogger(__name__)

__all__ = ["InferRun", "main"]


@dataclass
class InferRun:
    """What ``main`` ran: its printed result, plus the routine, state and
    batch, so a caller can evaluate the same batch."""

    result: Dict
    routine: object
    state: State
    batch: Dict[str, torch.Tensor]


def main(config_path: str, checkpoint_path: Optional[str] = None,
         overrides: Optional[List[str]] = None, n_steps: int = 100, trial: int = 0,
         device: Optional[str] = None, torch_checkpoint: Optional[str] = None) -> InferRun:
    dev = resolve_device(device)
    cfg = load_config(config_path, overrides)
    builder = instantiate(cfg["builder"])
    routine = build_routine(cfg["routine"], builder)

    batch = next(builder.test_batches())
    state = restore_state(routine, builder, dev, trial, checkpoint_path, torch_checkpoint)

    # Evaluation trajectories [b, X, Y, T]; when shorter than the rollout,
    # the first frame is repeated in front as dummy targets (timing only),
    # and so is a time-varying force's.
    data = torch.as_tensor(batch.get("data", batch.get("x")), device=dev)
    routine.n_steps = n_steps
    sim_batch = {k: torch.as_tensor(batch[k], device=dev) for k in ("f", "mu") if k in batch}
    if data.shape[-1] < n_steps + 1:
        pad = lambda a: torch.cat(
            [a[..., :1].expand(*a.shape[:-1], n_steps + 1 - a.shape[-1]), a], dim=-1)
        data = pad(data)
        if "f" in sim_batch and sim_batch["f"].dim() == 4:
            sim_batch["f"] = pad(sim_batch["f"])
    sim_batch["data"] = data

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    trajs = routine.rollout(state, sim_batch)[0]  # warm-up: builds the kernels
    float(trajs.sum())
    sync()

    before = launch_counts()
    start = time.perf_counter()
    trajs = routine.rollout(state, sim_batch)[0]
    sync()
    float(trajs.sum())
    elapsed = time.perf_counter() - start
    after = launch_counts()

    sim_time = cfg["routine"].get("step_size", 1.0) * n_steps
    per_sample_per_sim_second = elapsed / sim_time / data.shape[0]
    logger.info("rollout %s on %s: %.4f s, %.6f s/sample/sim-second", tuple(trajs.shape), dev,
                elapsed, per_sample_per_sim_second)
    result = {
        "shape": tuple(int(s) for s in trajs.shape),
        "elapsed": elapsed,
        "inference_time": per_sample_per_sim_second,
    }
    print(result)
    result["kernel_launches"] = {k: after[k] - before[k] for k in after}
    result["preds"] = trajs
    return InferRun(result, routine, state, sim_batch)
