"""``generate`` commands: datasets made by the port's own solvers
(counterpart of ``fourierflow_tpu/commands/generate.py``).

``navier_stokes`` writes the torus_li / torus_vis h5 layout: for each split
``{split}/a`` (initial vorticity ``[n, s, s]``), ``{split}/u`` (the
trajectories ``[n, s, s, steps]``), ``{split}/f`` (the force, written for
``force="random"`` only) and ``{split}/mu`` (the viscosity of each
trajectory), all float32, in a new file written by ``utils.hdf5`` (which needs no
``h5py``). Trajectories are made ``batch_size`` at a time on the device. The initial fields and the random forces are drawn from one
``torch.Generator`` seeded with ``seed``, so the dataset is a different
draw from the same distribution as the JAX package's (which draws from
``jax.random``); the viscosities come from the same
``np.random.RandomState(seed + 1234)``. ``kolmogorov`` is not ported yet.
"""

import logging
import os
import time

import numpy as np
import torch

from ..builders.synthetic import gaussian_random_field, solve_navier_stokes_2d
from ..device import resolve_device
from ..utils.hdf5 import H5Writer

logger = logging.getLogger(__name__)

__all__ = ["navier_stokes"]


def navier_stokes(
    path: str,
    n_train: int = 1000,
    n_valid: int = 200,
    n_test: int = 200,
    s: int = 256,
    t: float = 20.0,
    steps: int = 20,
    mu: float = 1e-5,
    mu_min: float = 1e-5,
    mu_max: float = 1e-5,
    seed: int = 23893,
    delta: float = 1e-4,
    batch_size: int = 50,
    force: str = "li",
    cycles: int = 2,
    scaling: float = 0.1,
    t_scaling: float = 0.2,
    varying_force: bool = False,
    device=None,
):
    """Write the dataset to ``path``, a new h5 file, running the solver on
    ``device`` (CUDA unless the CPU is asked for)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.RandomState(seed + 1234)
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)

    splits = [(split, n) for split, n in [("train", n_train), ("valid", n_valid),
                                          ("test", n_test)] if n > 0]
    layout = {}
    for split, n in splits:
        layout[f"{split}/a"] = ((n, s, s), np.float32)
        layout[f"{split}/f"] = ((n, s, s, steps) if varying_force else (n, s, s), np.float32)
        layout[f"{split}/u"] = ((n, s, s, steps), np.float32)
        layout[f"{split}/mu"] = ((n,), np.float32)
    start = time.perf_counter()
    with H5Writer(path, layout) as data_f:
        for split, n in splits:
            logger.info("generating split %s (%d samples)", split, n)
            b = min(n, batch_size)
            c = 0
            for j in range(n // b):
                t0 = time.perf_counter()
                w0 = gaussian_random_field(b, s, n_dims=2, alpha=2.5, tau=7.0, generator=gen,
                                           device=dev)
                mu_j = mu
                if mu_min != mu_max:
                    mu_j = rng.rand(b).astype(np.float32) * (mu_max - mu_min) + mu_min

                sol, f = solve_navier_stokes_2d(w0, mu_j, t, delta, steps, cycles, scaling,
                                                t_scaling, force, varying_force, generator=gen)
                data_f.write(f"{split}/a", c, w0.cpu().numpy())
                data_f.write(f"{split}/u", c, sol.cpu().numpy())
                if force == "random":
                    data_f.write(f"{split}/f", c, f.cpu().numpy())
                data_f.write(f"{split}/mu", c,
                             mu_j if np.ndim(mu_j) else np.full(b, mu_j, np.float32))
                c += b
                logger.info("  batch %d/%d done in %.2f s", j + 1, n // b,
                            time.perf_counter() - t0)
    logger.info("wrote %d trajectories to %s in %.2f s", sum(n for _, n in splits), path,
                time.perf_counter() - start)
