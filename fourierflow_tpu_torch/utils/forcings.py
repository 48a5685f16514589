"""Forcing functions of the Kolmogorov flows (counterpart of
``fourierflow_tpu/utils/forcings.py``): a factory takes a grid and returns
``forcing(vx, vy) -> (fx, fy)``, real force fields on the velocity's
device.

The constant part is computed on the host in float64 and rounded once to
float32 (so it is the same bits on every device; within one float32 ulp of
the JAX package's, whose cosine rounds otherwise). A forcing that does not
depend on the velocity carries its fields as ``forcing.static`` (numpy,
``(fx, fy)``), so that the solver can transform them once.
"""

import numpy as np
import torch

from .grids import Grid

__all__ = ["kolmogorov_forcing_fn", "simple_turbulence_forcing"]


def _const(magnitude: float, wavenumber: int, grid: Grid) -> np.ndarray:
    """``magnitude * cos(wavenumber * y)`` on the offset-(0, 0) mesh, float32."""
    if grid.ndim != 2:
        raise NotImplementedError(
            f"a {grid.ndim}-D forcing serves the projection method (utils/finite_volume.py), "
            "which is not ported yet (ROADMAP A item 8)")
    _, ys = grid.mesh(offset=(0, 0))
    return (magnitude * np.cos(wavenumber * ys.astype(np.float64))).astype(np.float32)


def _on(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(like.device)


def kolmogorov_forcing_fn(grid: Grid, scale: float = 1.0, k: int = 4):
    """The constant x-direction forcing ``scale * cos(k y)``."""
    fx = _const(scale, k, grid)
    fy = np.zeros_like(fx)

    def forcing(vx, vy):
        return _on(fx, vx), _on(fy, vx)

    forcing.static = (fx, fy)
    return forcing


def simple_turbulence_forcing(grid: Grid, constant_magnitude: float = 1.0,
                              constant_wavenumber: int = 4, linear_coefficient: float = 0.0):
    """Kolmogorov forcing plus a linear (drag-like) velocity forcing,
    ``(c cos(k y) + a vx, a vy)``, the ``jax_cfd`` config target of the
    Kolmogorov data configs. 2D only: the N-D branch belongs to the
    projection method."""
    f_const = _const(constant_magnitude, constant_wavenumber, grid)

    def forcing(vx, vy):
        return linear_coefficient * vx + _on(f_const, vx), linear_coefficient * vy

    if linear_coefficient == 0:
        forcing.static = (f_const, np.zeros_like(f_const))
    return forcing
