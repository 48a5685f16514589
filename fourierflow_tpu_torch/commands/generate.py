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
``np.random.RandomState(seed + 1234)``.

``kolmogorov`` runs a Kolmogorov data config (a YAML file or a registry name
such as ``data/kolmogorov/re_1000/trajectories/train``) with the config's
method (pseudo-spectral in 2D, projection in 2D or 3D),
``generation_batch`` trajectories at a time on the device, and writes the
JAX package's files beside the config (or in ``out_dir``):
``{stem}_{size}_{k}.h5`` trajectories ``[S, T, X, Y(, Z)]`` of ``vx``,
``vy`` (``vz`` in 3D; ``vorticity`` in 2D unless ``out_vorticity`` is
false) with ``time`` and ``elapsed``, or ``{stem}_{size}.h5`` warmed initial
conditions ``[S, X, Y(, Z)]``, each with the attributes ``dt`` and
``inner_steps``. A file is written under ``.tmp`` and renamed when the run
is complete. An ``init_path`` (``.nc`` read as ``.h5``) gives the initial
vorticities (pseudo-spectral) or velocities (projection). The
trajectories' random fields come from a ``torch.Generator`` seeded with the
config's ``seed``.
"""

import contextlib
import logging
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..builders.synthetic import gaussian_random_field, solve_navier_stokes_2d
from ..device import resolve_device
from ..utils.hdf5 import H5Writer

logger = logging.getLogger(__name__)

__all__ = ["navier_stokes", "kolmogorov"]


def kolmogorov(config_path: str, overrides: Optional[List[str]] = None, device=None,
               out_dir: Optional[str] = None) -> List[str]:
    """Generate the dataset of a Kolmogorov data config on ``device`` (CUDA
    unless the CPU is asked for). Returns the paths written."""
    from ..builders.base import load_array
    from ..builders.kolmogorov import (VELOCITY_NAMES, _resolve_data_path, check_method,
                                       generate_kolmogorov)
    from ..config import instantiate, load_config

    dev = resolve_device(device)
    cfg = load_config(config_path, overrides)
    out_dir = out_dir or os.path.dirname(os.path.abspath(config_path))
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(config_path))[0]

    sim_grid = instantiate(cfg["sim_grid"])
    out_vorticity = cfg.get("out_vorticity", True)
    dt = cfg["time_step"]
    if not isinstance(dt, float):
        dt = instantiate(dt)
    n_traj, inner_steps = cfg["n_trajectories"], cfg["inner_steps"]
    outer_steps, warmup_steps = cfg["outer_steps"], cfg.get("warmup_steps", 0)
    method = cfg.get("method", "pseudo_spectral")
    check_method(method, sim_grid)
    downsample_fn = instantiate(cfg["downsample_fn"])
    init_path = cfg.get("init_path")
    if init_path:
        init_path = _resolve_data_path(os.path.splitext(init_path)[0] + ".h5")
    ndim = sim_grid.ndim
    fields = list(VELOCITY_NAMES[:ndim]) + (["vorticity"] if out_vorticity and ndim == 2 else [])
    initial_names = ["vorticity"] if method == "pseudo_spectral" else list(VELOCITY_NAMES[:ndim])

    layouts = {}
    for o in cfg["out_sizes"]:
        size, k = o["size"], o["k"]
        layout = {"elapsed": ((n_traj,), np.float32)}
        if outer_steps > 0:
            path = os.path.join(out_dir, f"{stem}_{size}_{k}.h5")
            t_len = outer_steps // k
            layout.update({f: ((n_traj, t_len) + (size,) * ndim, np.float32) for f in fields})
            layout["time"] = ((t_len,), np.float32)
            times = (dt * inner_steps * k * np.arange(1, t_len + 1)).astype(np.float32)
        else:
            path = os.path.join(out_dir, f"{stem}_{size}.h5")
            layout.update({f: ((n_traj,) + (size,) * ndim, np.float32) for f in fields})
            times = None
        layouts[(size, k)] = (path, layout, times)

    gen = torch.Generator(device=dev).manual_seed(cfg["seed"])
    gen_batch = max(1, int(cfg.get("generation_batch", 1)))
    step_fn = instantiate(cfg["step_fn"])
    with contextlib.ExitStack() as stack:
        files = {}
        for key, (path, layout, times) in layouts.items():
            files[key] = stack.enter_context(H5Writer(
                path, layout, attrs={"dt": float(dt), "inner_steps": int(inner_steps)},
                atomic=True))
            if times is not None:
                files[key].write("time", 0, times)
        for start in range(0, n_traj, gen_batch):
            bsz = min(gen_batch, n_traj - start)
            rows = np.s_[start:start + bsz]
            initial = None if not init_path else {
                name: load_array(init_path, name, rows) for name in initial_names}
            outs, elapsed = generate_kolmogorov(
                sim_grid=sim_grid, out_sizes=cfg["out_sizes"], method=method, step_fn=step_fn,
                downsample_fn=downsample_fn, batch=bsz, generator=gen, initial_field=initial,
                peak_wavenumber=cfg.get("peak_wavenumber", 4.0),
                max_velocity=cfg.get("max_velocity", 7.0), inner_steps=inner_steps,
                outer_steps=outer_steps, warmup_steps=warmup_steps, out_vorticity=out_vorticity,
                device=dev)
            for key, f in files.items():
                for name in fields:
                    f.write(name, start, outs[key][name])
                f.write("elapsed", start, np.full(bsz, elapsed / bsz, np.float32))
            logger.info("trajectories %d-%d/%d done in %.2f s", start + 1, start + bsz, n_traj,
                        elapsed)
    return [path for path, _, _ in layouts.values()]


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
