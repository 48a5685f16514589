"""``predict`` command: inference time (counterpart of
``fourierflow_tpu/commands/predict.py``), in seconds per sample per
simulated second.

With a config it rolls the model out over ``builder.inference_data()``
(a routine without a rollout, such as the structured-mesh one, predicts
each sample once, and one prediction counts as one simulated second);
without one it times the port's Crank-Nicolson solver on the same kind of
fields, the numerical baseline the reference's inference speed-up is
measured against. Each timed run follows a warm-up and ends with
``torch.cuda.synchronize()`` and a value fetch.
"""

import logging
import time
from typing import List, Optional

import torch

from ..config import instantiate, load_config
from ..device import resolve_device
from ..trainers.trainer import batch_count
from .train import build_routine, restore_state

logger = logging.getLogger(__name__)

__all__ = ["time_dns_baseline", "main"]


def _finish(x: torch.Tensor) -> float:
    """Wait for the device, then fetch a value that needs all of ``x``."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return float(x.sum())


def time_dns_baseline(n_samples: int = 32, s: int = 64, steps: int = 10, delta_t: float = 1e-4,
                      inner: int = 100, device: Optional[str] = None) -> float:
    """Seconds per sample per simulated second of the solver (li force, mu
    1e-5) on ``n_samples`` Gaussian random fields of ``s x s``, over
    ``steps`` records of ``inner`` steps of ``delta_t``.

    The warm-up is the timed solve itself, at the same shape: it makes the
    FFT plans and fills the memory pool. On CUDA the solver captures its
    graph anew in every call, so the timed solve still includes one capture
    and the eager steps before it."""
    from ..builders.synthetic import gaussian_random_field, solve_navier_stokes_2d

    dev = resolve_device(device)
    w0 = gaussian_random_field(n_samples, s, generator=torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    solve = lambda: solve_navier_stokes_2d(w0, 1e-5, t_end=delta_t * inner * steps,
                                           delta_t=delta_t, record_steps=steps, force="li")[0]
    _finish(solve())
    t0 = time.perf_counter()
    sol = solve()
    _finish(sol)
    elapsed = time.perf_counter() - t0
    per = elapsed / n_samples / (delta_t * inner * steps)
    logger.info("DNS baseline on %s: %.4f s total, %.6g s/sample/sim-second", dev, elapsed, per)
    print({"elapsed": elapsed, "inference_time": per, "mode": "dns_baseline"})
    return per


def main(config_path: Optional[str] = None, checkpoint_path: Optional[str] = None,
         overrides: Optional[List[str]] = None, trial: int = 0,
         device: Optional[str] = None) -> float:
    if config_path is None:
        return time_dns_baseline(device=device)
    dev = resolve_device(device)
    cfg = load_config(config_path, overrides)
    builder = instantiate(cfg["builder"])
    routine = build_routine(cfg["routine"], builder)
    state = restore_state(routine, builder, dev, trial, checkpoint_path)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in builder.inference_data().items()}

    if hasattr(routine, "rollout"):
        run = lambda: routine.rollout(state, batch)[0]
    else:
        run = lambda: routine.predict(state, batch)
    _finish(run())  # warm-up: builds the kernels
    t0 = time.perf_counter()
    preds = run()
    _finish(preds)
    elapsed = time.perf_counter() - t0

    n_samples = batch_count(batch)
    steps = preds.shape[-1] if hasattr(routine, "rollout") else 1
    sim_seconds = steps * getattr(routine, "step_size", 1.0)
    inference_time = elapsed / n_samples / sim_seconds
    logger.info("inference on %s: %.4g s total, %d samples, %.3g sim-s -> %.4g s/sample/sim-s",
                dev, elapsed, n_samples, sim_seconds, inference_time)
    return inference_time
